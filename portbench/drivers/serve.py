"""Serving cells: one-image requests through ``ClusterServer.submit`` ->
``ServeChain`` -> each device's backend (conv1, the port's
``relu_pool``, conv2, ``relu_pool``, an fc head), in an open loop.

Requests are due at ``traffic.open_loop_schedule``'s times over the
window; each is timed from its due time to its response (the
generator's lateness at submit plus ``ServeResponse.latency_s``, both on
``time.monotonic``).  After the close every request gets until
``DRAIN_S`` past it to answer; one that has not, or that answers
``error``, is unanswered.  A request not answered ok counts in the
latencies as answered at the drain's end.  ``check`` compares every answered request's
output with the plain reference's.
"""
from __future__ import annotations

import gc
import time

import numpy as np

from portbench import traffic
from portbench.drivers import _common
from portbench.reference import cifar_cnn as reference

DRAIN_S = 60.0


def init_weights(cfg: dict, seed: int, device):
    """The serving chain's weights drawn on ``device`` from the seed in
    three calls, with ``serve_inputs``' scales (0.1, 0.1, 0.01), handed
    to the program as numpy: the two conv kernels (HWIO) and the fc."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed % 2 ** 63)
    k, c0 = cfg["kernel_size"], cfg["image_channels"]
    c1, c2 = cfg["c1_kernels"], cfg["c2_kernels"]
    feat = (cfg["image_size"] // cfg["pool_stride"] ** 2) ** 2 * c2
    w1 = torch.randn((k, k, c0, c1), generator=g, device=device) * 0.1
    w2 = torch.randn((k, k, c1, c2), generator=g, device=device) * 0.1
    fc = torch.randn((feat, cfg["num_classes"]), generator=g, device=device) * 0.01
    return [w1.cpu().numpy(), w2.cpu().numpy()], fc.cpu().numpy()


class Driver:
    def __init__(self, cell, cfg, seed, seconds, device="cuda", backend_map=None):
        import torch
        from repro_torch.core.cluster.scheduler import ServeChain
        from repro_torch.launch.hetero import relu_pool
        from repro_torch.serve.server import ClusterServer

        self.cell, self.cfg, self.seconds = cell, cfg, seconds
        self.device = torch.device(device)
        mb = cell["max_batch"]
        self.due = traffic.open_loop_schedule(cell["rate_per_s"], seconds, seed)
        images = traffic.serve_images(len(self.due) + mb, cfg["image_size"],
                                      cfg["image_channels"], seed)
        warm, self.images = images[:mb], images[mb:]
        self.weights, self.fc = init_weights(cfg, seed, self.device)
        fc = self.fc

        def head(z):
            return z.reshape(z.shape[0], -1) @ fc

        self.cluster = _common.make_cluster(cell, cfg, backend_map or {}, mb)
        try:
            # every slab size the server can form, through both layers
            chain = ServeChain(self.cluster, self.weights, [relu_pool, relu_pool])
            for b in range(1, mb + 1):
                chain.push(warm[:b])
                chain.flush()
            self.server = ClusterServer(
                self.cluster, self.weights, between=[relu_pool, relu_pool],
                head=head, max_batch=mb)
            self.server.start()
            for f in [self.server.submit(x) for x in warm]:
                if f.result(timeout=DRAIN_S).status != "ok":
                    raise RuntimeError("a warm-up request failed")
            self.eq1 = _common.eq1_record(self.cluster, cfg)
        except BaseException:
            self.cluster.shutdown()
            raise

    def window(self, span) -> dict:
        before = _common.timing_now(self.cluster)
        n = len(self.due)
        futs, late = [], np.empty(n)
        t0 = time.monotonic()
        for i, d in enumerate(self.due):
            wait = t0 + d - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            ts = time.monotonic()
            futs.append(self.server.submit(self.images[i]))
            late[i] = ts - (t0 + d)
        close = t0 + self.seconds
        self.responses = []
        for f in futs:
            try:
                self.responses.append(f.result(timeout=max(0.0, close + DRAIN_S
                                                           - time.monotonic())))
            except TimeoutError:
                self.responses.append(None)
        ok = [i for i, r in enumerate(self.responses) if r is not None and r.status == "ok"]
        # a request not answered ok misses every limit: it counts as
        # answered at the drain's end, DRAIN_S past the close or more
        latency = close + DRAIN_S - (t0 + self.due)
        for i in ok:
            latency[i] = late[i] + self.responses[i].latency_s
        done = [t0 + self.due[i] + latency[i] for i in ok]
        elapsed = (max(done) if done else time.monotonic()) - t0
        return {
            "requests": n, "answered_ok": len(ok), "seconds": elapsed,
            "attempted": n, "failed": n - len(ok),
            "latency_s": latency, "lateness_s": late,
            "queued_s": np.array([self.responses[i].queued_s for i in ok]),
            "statuses": sorted({r.status if r else "none" for r in self.responses}),
            "timing": _common.timing_delta(before, self.cluster),
            "cpu_kernel_share": _common.cpu_kernel_share(self.cluster, self.cell, self.cfg),
            "eq1_after": _common.eq1_record(self.cluster, self.cfg),
        }

    def close(self) -> None:
        import torch

        self.server.stop()
        self.cluster.shutdown()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ------------------------------------------------
    def _answered(self):
        idx = [i for i, r in enumerate(self.responses) if r is not None and r.status == "ok"]
        got = (np.stack([np.asarray(self.responses[i].output, np.float32) for i in idx])
               if idx else np.zeros((0, self.cfg["num_classes"]), np.float32))
        return idx, got

    def _reference(self, idx, **fault):
        return reference.serve_outputs(self.weights, self.fc, self.images[idx],
                                       self.device, **fault)

    @staticmethod
    def _gap(got, want) -> float:
        if not len(want):
            return float("inf")
        scale = np.maximum(np.abs(want).max(axis=1), 1e-30)
        return float((np.abs(got - want).max(axis=1) / scale).max())

    def _unanswered(self) -> int:
        return sum(r is None or r.status == "error" for r in self.responses)

    def check(self) -> dict:
        """Every answered request's output against the reference's, each
        row's widest gap over its largest reference output; and the
        requests that never answered (or answered ``error``)."""
        idx, got = self._answered()
        return {"out_gap": self._gap(got, self._reference(idx)),
                "unanswered": self._unanswered()}

    def control(self, kind: str) -> dict:
        """The same numbers with the reference in the program's place:
        ``tf32`` (the control), ``no_exchange`` (the non-master devices'
        channels never gathered) or ``swapped`` (each answer given to
        the next request)."""
        idx, _ = self._answered()
        want = self._reference(idx)
        if kind == "tf32":
            got = self._reference(idx, tf32=True)
        elif kind == "no_exchange":
            got = self._reference(idx, drop_channels=[
                np.arange(c[0], sum(c)) for c in
                (self.eq1["c1_kernels_per_device"], self.eq1["c2_kernels_per_device"])])
        elif kind == "swapped":
            got = np.roll(want, 1, axis=0)
        else:
            raise ValueError(f"unknown control {kind!r}")
        return {"out_gap": self._gap(got, want), "unanswered": self._unanswered()}
