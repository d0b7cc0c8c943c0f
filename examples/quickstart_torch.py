"""Quickstart on the PyTorch port: train the paper's CIFAR-10 CNN, first
locally, then with the convolutional layers distributed over an
emulated heterogeneous cluster (Algorithms 1 & 2) — verifying identical
losses, i.e. the paper's claim that distribution does not affect
classification performance.

On ``--device cuda`` (the default) the local run's convs are the
hand-written kernels through ``Conv2dFunction`` (K1 forward, K2 and K3
backward) and the cluster's three devices run the ``cuda`` backend (the
same kernels on each device's shard); on ``--device cpu`` both are the
plain PyTorch conv.

    PYTHONPATH=src python examples/quickstart_torch.py [--steps 30] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.master_slave import HeteroCluster, make_distributed_conv
from repro_torch.core.partitioner import workload_shares
from repro_torch.data.pipeline import synthetic_cifar_batches
from repro_torch.launch.hetero import DEVICE_BACKENDS, sgd_step
from repro_torch.models.cnn import (
    cnn_loss,
    conv_fn_for_backend,
    init_cnn,
    make_cnn_config,
)

# the local run's conv on each --device: the kernels on the card, the
# plain conv on the CPU
LOCAL_CONV = {"cuda": "cuda", "cpu": "torch"}


def train(cfg, conv_fn, steps, lr=0.05, seed=0, device="cuda", params=None):
    """``steps`` SGD steps on ``synthetic_cifar_batches(64, seed)`` from
    ``params`` (default: ``init_cnn`` from a generator seeded ``seed``),
    the convs through ``conv_fn``.  Returns (losses, accuracies)."""
    if params is None:
        params = init_cnn(torch.Generator().manual_seed(seed), cfg, device)
    it = synthetic_cifar_batches(64, seed=seed)
    losses, accs = [], []
    for i in range(steps):
        b = next(it)
        images = torch.from_numpy(b["images"]).to(device)
        labels = torch.from_numpy(b["labels"]).to(device)
        params, loss, acc = sgd_step(
            params, lambda p: cnn_loss(p, images, labels, cfg=cfg, conv_fn=conv_fn), lr)
        losses.append(loss)
        accs.append(acc)
        if i % 5 == 0:
            print(f"  step {i:3d} loss={losses[-1]:.3f} acc={accs[-1]:.2f}")
    return np.array(losses), np.array(accs)


def main(argv=None):
    """Run both trainings and hold them to each other; returns the
    run's numbers (seconds, accuracies, drift, probe, shares, comm)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--c1", type=int, default=16)
    ap.add_argument("--c2", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=sorted(DEVICE_BACKENDS),
                    help="cuda (the hand-written kernels; the default) or cpu "
                         "(the plain PyTorch conv)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: --device cuda (the default) needs a CUDA "
                         "card; pass --device cpu to run on the CPU")

    cfg = make_cnn_config(args.c1, args.c2)
    print(f"== local training ({cfg.arch_id}) ==")
    t0 = time.time()
    loss_local, acc_local = train(cfg, conv_fn_for_backend(LOCAL_CONV[args.device]),
                                  args.steps, device=args.device)
    local_s = time.time() - t0
    print(f"local: {local_s:.1f}s, final acc {acc_local[-5:].mean():.2f}")

    print("\n== distributed training (master + 2 slaves, one 2x slower) ==")
    cluster = HeteroCluster([1.0, 1.0, 2.0], [DEVICE_BACKENDS[args.device]] * 3)
    try:
        times = cluster.probe(
            image_size=32, in_channels=3, kernel_size=5,
            num_kernels=args.c1, batch=64,
        )
        shares = workload_shares(times)
        print(f"probe times: {np.round(times, 4).tolist()}")
        print(f"Eq.1 shares: {np.round(shares, 3).tolist()}")
        t0 = time.time()
        loss_dist, acc_dist = train(cfg, make_distributed_conv(cluster), args.steps,
                                    device=args.device)
        dist_s = time.time() - t0
        print(f"distributed: {dist_s:.1f}s, final acc {acc_dist[-5:].mean():.2f}")
        comm_mib = cluster.comm_bytes / 2**20
        print(f"comm volume: {comm_mib:.1f} MiB")
    finally:
        cluster.shutdown()

    drift = float(np.max(np.abs(loss_local - loss_dist)))
    print(f"\nmax |loss_local - loss_distributed| over training = {drift:.2e}")
    assert drift < 1e-2, "distribution changed the training trajectory!"
    assert loss_local[-5:].mean() < loss_local[:5].mean() - 0.1, \
        "CNN loss did not decrease"
    print("OK: loss decreases AND distribution does not affect the "
          "training trajectory (the paper's §5.3 classification claim).")
    return {"device": args.device, "steps": args.steps, "net": cfg.arch_id,
            "local_s": local_s, "distributed_s": dist_s,
            "final_acc_local": float(acc_local[-5:].mean()),
            "final_acc_distributed": float(acc_dist[-5:].mean()),
            "losses_local": loss_local.tolist(), "losses_distributed": loss_dist.tolist(),
            "drift": drift, "comm_mib": comm_mib, "probe_times": list(times),
            "shares": shares.tolist()}


if __name__ == "__main__":
    main()
