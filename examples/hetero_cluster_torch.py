"""Heterogeneous-cluster wall-clock study on the PyTorch port — the
paper's §4.1.1 experiment: distributed convolution over emulated devices
of different speeds, comparing

  1. single device (the baseline),
  2. naive equal kernel split (what the paper argues against),
  3. the Eq. 1 balanced split.

Real threads, real convolutions, real wall-clock.  The Eq. 1 split must
beat the equal split whenever the cluster is heterogeneous, because the
equal split waits for the slowest device (the paper's Device-1/Device-2
example).  Every device of these three sections runs ``--device``'s
backend: ``cuda`` (the default: the hand-written conv kernel, all
devices sharing one card) or ``torch:cpu`` (the plain PyTorch conv).
Then the barrier and pipelined protocols over 50 Mbps links on ``sim``
devices, and a mixed cluster: a ``numpy`` master and two ``--device``
slaves.

    PYTHONPATH=src python examples/hetero_cluster_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.master_slave import HeteroCluster
from repro_torch.core.partitioner import workload_shares
from repro_torch.launch.hetero import DEVICE_BACKENDS


def time_forward(cluster, x, w, reps=4):
    cluster.conv_forward(x, w)  # warm the caches for these shard shapes
    t0 = time.perf_counter()
    for _ in range(reps):
        cluster.conv_forward(x, w)
    return (time.perf_counter() - t0) / reps


def main(argv=None):
    """The four sections; returns their times (s), the Eq. 1 shares
    and each split's kernels per device."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=sorted(DEVICE_BACKENDS),
                    help="every device's backend in the first three sections and "
                         "the mixed cluster's slaves: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: --device cuda (the default) needs a CUDA "
                         "card; pass --device cpu to run on the CPU")
    dev = DEVICE_BACKENDS[args.device]
    out = {"device": args.device, "backend": dev}

    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 32, 32, 3)).astype(np.float32)
    w = rng.normal(size=(5, 5, 3, 240)).astype(np.float32)

    print("== single device baseline ==")
    single = HeteroCluster([1.0], [dev])
    single.probe_times = [1.0]
    t_single = time_forward(single, x, w)
    single.shutdown()
    print(f"single-device conv: {t_single*1e3:.1f} ms")

    print("\n== heterogeneous cluster: master + slave(1x) + slave(3x slower) ==")
    cluster = HeteroCluster([1.0, 1.0, 3.0], [dev] * 3)
    try:
        probe = cluster.probe(
            image_size=32, in_channels=3, kernel_size=5, num_kernels=80, batch=32
        )
        shares = workload_shares(probe)
        kernels = cluster.shares_for(w.shape[-1])
        print(f"probe times: {np.round(probe, 4).tolist()}")
        print(f"Eq.1 shares: {np.round(shares, 3).tolist()} "
              f"-> kernels {kernels.tolist()}")

        t_balanced = time_forward(cluster, x, w)
        print(f"Eq.1-balanced distributed conv: {t_balanced*1e3:.1f} ms "
              f"(speedup {t_single/t_balanced:.2f}x vs single)")

        cluster.probe_times = [1.0, 1.0, 1.0]  # force the naive equal split
        equal_kernels = cluster.shares_for(w.shape[-1])
        t_equal = time_forward(cluster, x, w)
        print(f"equal-split distributed conv:   {t_equal*1e3:.1f} ms "
              f"(speedup {t_single/t_equal:.2f}x vs single)")

        gain = t_equal / t_balanced
        print(f"\nEq.1 vs equal split: {gain:.2f}x faster "
              "(the paper's §4.1.1 motivation)")
        print("note: on a single-core host (or one card) the absolute speedup "
              "vs one device is <1 (threads share the core + protocol "
              "overhead); the Eq.1-vs-equal ratio is the hardware-independent "
              "result.")
    finally:
        cluster.shutdown()
    out.update(single_ms=t_single * 1e3, balanced_ms=t_balanced * 1e3,
               equal_ms=t_equal * 1e3, gain=gain, probe_times=list(probe),
               shares=shares.tolist(), kernels=kernels.tolist(),
               equal_kernels=equal_kernels.tolist())

    print("\n== async pipeline vs barrier over a finite (50 Mbps) link ==")
    print("   (sim backend: deterministic virtual devices, zeros out)")
    xs = rng.normal(size=(16, 16, 16, 8)).astype(np.float32)
    ws = rng.normal(size=(5, 5, 8, 64)).astype(np.float32)
    times = {}
    for proto, pipelined in (("barrier", False), ("pipelined", True)):
        cluster = HeteroCluster(
            [1.0, 1.5, 3.0], ["sim", "sim", "sim"],
            pipeline=pipelined, microbatches=4, bandwidth_mbps=50.0,
        )
        try:
            cluster.probe_times = [1.0, 1.5, 3.0]  # exact Eq.1 for sim
            times[proto] = time_forward(cluster, xs, ws, reps=2)
            t = cluster.timing
            print(f"{proto:9s}: {times[proto]*1e3:.1f} ms  "
                  f"(overlap {t.overlap_s:.2f}s, blocked {t.gather_wait_s:.2f}s)")
        finally:
            cluster.shutdown()
    print(f"pipeline hides comm behind compute: "
          f"{times['barrier']/times['pipelined']:.2f}x faster")
    out.update(barrier_ms=times["barrier"] * 1e3, pipelined_ms=times["pipelined"] * 1e3,
               pipeline_gain=times["barrier"] / times["pipelined"])

    print(f"\n== mixed-backend cluster: numpy master + {dev} slaves ==")
    mixed = HeteroCluster([1.0, 1.0, 2.0], ["numpy", dev, dev])
    try:
        probe = mixed.probe(
            image_size=32, in_channels=3, kernel_size=5, num_kernels=80, batch=32
        )
        mixed_kernels = mixed.shares_for(w.shape[-1])
        print(f"probe times per backend: {np.round(probe, 4).tolist()}")
        print(f"Eq.1 shares follow each device's OWN backend speed: "
              f"{mixed_kernels.tolist()}")
        t_mixed = time_forward(mixed, x, w)
        print(f"mixed-backend distributed conv: {t_mixed*1e3:.1f} ms")
    finally:
        mixed.shutdown()
    out.update(mixed_ms=t_mixed * 1e3, mixed_backends=["numpy", dev, dev],
               mixed_probe_times=list(probe), mixed_kernels=mixed_kernels.tolist())
    return out


if __name__ == "__main__":
    main()
