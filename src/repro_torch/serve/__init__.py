"""The serving lane: ``engine.py`` (LLM prefill + step-wise decode over
a KV/SSM cache) and ``server.py`` (the continuous-batching request
server over an elastic ``HeteroCluster``).  Attribute access is lazy so
importing the package costs nothing until a name is used."""
from repro_torch.lazy import lazy_exports

_EXPORTS = {
    "ServeEngine": ".engine",
    "ClusterServer": ".server",
    "AutoScaler": ".server",
    "RequestQueue": ".server",
    "ServeFuture": ".server",
    "ServeResponse": ".server",
}

__all__ = sorted(_EXPORTS)

__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
