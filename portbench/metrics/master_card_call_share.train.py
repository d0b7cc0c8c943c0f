"""master_card_call_share.train: the share of ``CudaBackend``'s conv and
VJP calls in the traced window whose operands were on the card (the
program's spans ``cuda.compute``, label ``operands``: ``card`` or
``host``), in %.  Where no ``CudaBackend`` call ran (a run whose cuda
devices are plain PyTorch ones), the share of the master's own shards
computed on its device (``cluster.master_shard``, the same label).  None
for a program whose spans carry no such label."""
NAMES = ("cuda.compute", "cluster.master_shard")


def read(run):
    try:
        import repro_torch.core.spans as spans
    except ImportError:
        return None
    kept = spans.spans()
    for name in NAMES:
        labels = [s.attrs["operands"] for s in kept
                  if s.name == name and "operands" in s.attrs]
        if labels:
            return 100.0 * labels.count("card") / len(labels)
    return None
