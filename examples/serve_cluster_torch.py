"""Continuous-batching serving demo on the PyTorch port: a
``ClusterServer`` routing conv forward passes through a 2-slave
in-process ``HeteroCluster`` whose master and first slave run the port's
conv on ``--device`` (the hand-written CUDA kernel on the card, or the
plain PyTorch conv on the CPU) and whose second slave is a ``numpy``
CPU device.

A burst of single-image requests is submitted while the server packs
them into slots (dynamic batching), pipelines each slab's scatter
against the previous slab's gather (``ServeChain``), and resolves one
future per request under a default deadline; then the same burst is
replayed one request at a time to show what the batching bought.

    PYTHONPATH=src python examples/serve_cluster_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core.master_slave import HeteroCluster
from repro_torch.launch.hetero import DEVICE_BACKENDS
from repro_torch.serve.server import ClusterServer

C1, C2 = 8, 16
SIZE = 16  # request images are (SIZE, SIZE, 3)


def relu_pool(y):
    """Master-only stage after each conv: ReLU + 2x2 max-pool."""
    y = np.maximum(y, 0.0)
    b, h, w, c = y.shape
    return y.reshape(b, h // 2, 2, w // 2, 2, c).max(axis=(2, 4))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=sorted(DEVICE_BACKENDS),
                    help="where the master and the first slave run their conv "
                         "(cuda, the default, needs a CUDA card)")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    weights = [
        rng.standard_normal((5, 5, 3, C1)).astype(np.float32) * 0.1,
        rng.standard_normal((5, 5, C1, C2)).astype(np.float32) * 0.1,
    ]
    fc = rng.standard_normal(((SIZE // 4) ** 2 * C2, 10)).astype(np.float32) * 0.01

    def head(z):
        return z.reshape(z.shape[0], -1) @ fc

    # master + 2 slaves, the numpy one 1.5x slower: Eq. 1 still balances
    # the per-layer split, the serving lane rides the same plans
    accel = DEVICE_BACKENDS[args.device]
    cluster = HeteroCluster([1.0, 1.0, 1.5], [accel, accel, "numpy"],
                            pipeline=True, microbatches=2)
    try:
        cluster.probe(image_size=SIZE, in_channels=3, kernel_size=5,
                      num_kernels=C1, batch=4)
        images = [rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32)
                  for _ in range(16)]

        def burst(max_batch, sequential):
            server = ClusterServer(
                cluster, weights, between=[relu_pool, relu_pool], head=head,
                max_batch=max_batch, default_deadline_s=30.0,
            )
            t0 = time.perf_counter()
            with server:
                if sequential:
                    resps = [server.submit(x).result(timeout=60.0)
                             for x in images]
                else:
                    futs = [server.submit(x) for x in images]
                    resps = [f.result(timeout=60.0) for f in futs]
            wall = time.perf_counter() - t0
            bad = [r.status for r in resps if r.status != "ok"]
            if bad:
                raise RuntimeError(f"requests did not complete: {bad}")
            return wall, resps, server.stats()

        wall_b, resps, stats = burst(max_batch=4, sequential=False)
        print(f"dynamic batching (max_batch=4) on {args.device}: {len(images)} "
              f"requests in {wall_b:.3f}s -> {len(images) / wall_b:.0f} req/s  "
              f"p50={stats['p50_ms']:.1f}ms p99={stats['p99_ms']:.1f}ms")
        print(f"  first logits: {np.round(resps[0].output, 3).tolist()}")

        wall_s, _, _ = burst(max_batch=1, sequential=True)
        print(f"one-at-a-time baseline: {wall_s:.3f}s "
              f"({wall_s / wall_b:.1f}x slower)")
    finally:
        cluster.shutdown()


if __name__ == "__main__":
    main()
