"""Quickest proof that the PyTorch/CUDA port builds, is right and serves
on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``):

1. device — the card's name, and ``nvidia-smi``'s name and power limit;
2. build  — ``nvcc`` builds every kernel of the port from
   ``src/repro_torch/kernels/csrc/`` (seconds, cache hit, ptxas report);
3. kernel — the hand-written conv2d kernel against its plain PyTorch
   version (``conv2d_ref``) on the card, on the shapes of
   tests/test_kernels.py, the paper's C1 and C2 layers, a ragged and an
   empty Cout and a 7-row strip, in fp32 and bf16; with median times of
   the kernel, the plain version, ``F.conv2d`` (cuDNN, TF32 off: a
   yardstick the port never calls), the backend's numpy round-trip
   copies, and the kernel's bound;
4. serve  — the port's ``run_serve`` on the paper's headline network
   ``cifar_cnn_500_1500`` over ``cuda,cuda,numpy``: 16 requests, every
   one ``ok``, 4 of them held against a single-device float64 chain on
   the card; the kernel's launch count is reset just before and read
   just after, and must be non-zero.  A ``torch.profiler`` trace of the
   card's activity over the run gives the kernel's own time in it and
   the card's busy share;
5. main-path shapes — the kernel against its plain version at every
   shard shape the serve run gave it, timed in isolation.  The kernels
   line's ``ms`` is the traced kernel time of the serve run; its
   ``plain_ms`` and ``library_ms`` are these isolated medians summed
   over the run's launches, as ``isolated_ms`` is for the kernel.

Then, on lines of their own: the ``nvidia-smi`` line, the kernels line
(``{"kernels": [...]}``) and, last, ``{"ok": true, "device": ...}``.
Any mismatch or failure raises and exits non-zero; without a card, or
without the rest of the repository beside this file, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W): fp32 on
# the CUDA cores, bf16 on the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES_S = 3.35e12
# tests/test_kernels.py's tolerances: fp32 atol 2e-4, bf16 atol 5e-2,
# both with rtol 0.05 (different summation orders over up to 12,500 terms)
TOL = {torch.float32: (2e-4, 0.05), torch.bfloat16: (5e-2, 0.05)}
SERVE_ATOL = 1e-3
SEED = 0


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def events_ms(fn, reps: int, rounds: int = 3) -> float:
    """Median over ``rounds`` of (CUDA-event time of ``reps`` back-to-back
    calls) / reps, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return statistics.median(per)


def conv_work(b, h, w, cin, cout, k, dtype):
    """(operations, bytes) of one SAME conv: each input read once, the
    output written once."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    flops = 2.0 * b * h * w * k * k * cin * cout
    nbytes = itemsize * (b * h * w * cin + k * k * cin * cout + b * h * w * cout)
    return flops, nbytes


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / PEAK_BYTES_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def device_trace(prof, window_s: float, kernel: str) -> dict:
    """The card's activity in a profiler trace: the named kernel's
    launches and summed time, and the share of ``window_s`` in which
    any kernel or copy ran (overlaps counted once)."""
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = [e for e in dev if kernel in e.name]
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    return {"device_events": len(dev), "kernel_launches": len(ours),
            "kernel_ms": sum(e.time_range.elapsed_us() for e in ours) / 1e3,
            "busy_ms": busy_us / 1e3, "window_ms": window_s * 1e3,
            "busy_share": busy_us / 1e6 / window_s}


def check_shape(conv2d, conv2d_ref, dev, b, h, w, cin, cout, k, dtype, *, label):
    """Run the kernel and its plain version on one shape; fail on a
    mismatch.  Returns the JSON record of the shape."""
    import torch.nn.functional as F

    rng = np.random.default_rng([SEED, b, h, w, cin, cout, k])
    xn = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wn = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    x = torch.from_numpy(xn).to(dev).to(dtype)
    wt = torch.from_numpy(wn).to(dev).to(dtype)
    before = conv2d.launches
    got = conv2d(x, wt)
    torch.cuda.synchronize()
    want = conv2d_ref(x.float(), wt.float())
    if tuple(got.shape) != (b, h, w, cout) or got.dtype != dtype:
        fail(f"{label}: shape/dtype {tuple(got.shape)} {got.dtype}")
    if cout == 0:
        if conv2d.launches != before:
            fail(f"{label}: an empty output launched the kernel")
        err = 0.0
    else:
        if not torch.isfinite(got.float()).all():
            fail(f"{label}: non-finite output")
        err = (got.float() - want).abs().max().item()
        atol, rtol = TOL[dtype]
        if not torch.allclose(got.float(), want, atol=atol, rtol=rtol):
            fail(f"{label}: kernel vs conv2d_ref max abs err {err} "
                 f"beyond atol {atol} rtol {rtol}")
    flops, nbytes = conv_work(b, h, w, cin, cout, k, dtype)
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    rec = {
        "phase": "kernel", "case": label, "dtype": str(dtype).split(".")[-1],
        "shape": {"x": [b, h, w, cin], "w": [k, k, cin, cout]},
        "max_abs_err": err, "atol": TOL[dtype][0], "rtol": TOL[dtype][1],
        "ms": None, "plain_ms": None, "library_ms": None, "copy_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "flops": flops, "bytes": nbytes,
    }
    if cout == 0:
        return rec
    reps = 20 if flops > 5e9 else 50
    rec["ms"] = events_ms(lambda: conv2d(x, wt), reps)
    rec["plain_ms"] = events_ms(lambda: conv2d_ref(x, wt), reps)
    xc = x.permute(0, 3, 1, 2).contiguous()
    wc = wt.permute(3, 2, 0, 1).contiguous()
    rec["library_ms"] = events_ms(lambda: F.conv2d(xc, wc, padding=k // 2), reps)
    if dtype == torch.float32:
        # the cuda backend's numpy contract: x and the weight shard go to
        # the card, y comes back, on every conv call
        def roundtrip():
            torch.from_numpy(xn).to(dev)
            torch.from_numpy(wn).to(dev)
            got.cpu()
        rec["copy_ms"] = events_ms(roundtrip, max(5, reps // 4))
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this check "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch
    from torch.profiler import ProfilerActivity, profile

    if not Path(repro_torch.__file__).resolve().is_relative_to(SRC):
        fail(f"repro_torch imported from {repro_torch.__file__}, not {SRC}")
    from repro_torch.core.backends import get_backend
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv2d import conv2d
    from repro_torch.kernels.ref import conv2d_ref
    from repro_torch.launch.hetero import relu_pool, run_serve, serve_inputs

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # -- 2. build ----------------------------------------------------------
    built = _build.build("conv2d_fwd")
    emit({"phase": "build", "kernel": "conv2d_fwd", "build_s": built.build_s,
          "cache_hit": built.cache_hit, "library": str(built.path.relative_to(ROOT)),
          "ptxas": [ln.strip() for ln in built.ptxas.splitlines()
                    if "registers" in ln or "spill" in ln]})

    # -- 3. kernel against its plain version ----------------------------------
    cases = [
        ("sweep", (1, 8, 8, 3, 16, 3)),
        ("sweep", (2, 16, 16, 8, 24, 5)),
        ("sweep", (2, 32, 32, 3, 50, 5)),
        ("sweep", (1, 16, 16, 50, 40, 5)),
        ("C1", (4, 32, 32, 3, 500, 5)),
        ("C2", (4, 16, 16, 500, 1500, 5)),
        ("ragged Cout 437", (4, 16, 16, 500, 437, 5)),
        ("Cout 0", (4, 16, 16, 500, 0, 5)),
        ("7-row strip", (4, 7, 16, 500, 1500, 5)),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for label, shape in cases:
            emit(check_shape(conv2d, conv2d_ref, dev, *shape, dtype, label=label))

    # -- 4. serve the headline network through the port ----------------------
    c1, c2, image, requests, max_batch = 500, 1500, 32, 16, 4
    backends = ["cuda", "cuda", "numpy"]
    # every conv the cuda devices run, by shape: observed at the backend
    # (the kernel's only caller on this path), not at the kernel
    shard_shapes = collections.Counter()
    cuda_backend = get_backend("cuda")
    backend_conv = cuda_backend.conv

    def observed_conv(xs, ws):
        shard_shapes[tuple(xs.shape) + (ws.shape[-1], ws.shape[0])] += 1
        return backend_conv(xs, ws)

    cuda_backend.conv = observed_conv
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            conv2d.launches = 0
            t_run = time.perf_counter()
            rec, outputs = run_serve(
                [1.0, 1.0, 1.0], backends, device="cuda", c1=c1, c2=c2,
                image_size=image, requests=requests, max_batch=max_batch,
                partition="kernel", deadline_s=600.0, seed=SEED,
            )
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t_run
            launches = conv2d.launches
    finally:
        del cuda_backend.conv
    if not rec["all_ok"]:
        fail(f"serve: statuses {rec['statuses']}")
    if launches == 0:
        fail("serve: the conv2d_fwd kernel was never launched on the main path")
    if launches != sum(shard_shapes.values()):
        fail(f"serve: {launches} launches for {sum(shard_shapes.values())} "
             f"convs on the cuda devices")
    trace = device_trace(prof, run_s, "conv2d_fwd_kernel")
    if trace["kernel_launches"] != launches:
        fail(f"serve: the trace holds {trace['kernel_launches']} kernel "
             f"launches, the wrapper counted {launches}")
    weights, fc, images = serve_inputs(SEED, c1, c2, image, requests)
    n_check = 4
    x = torch.from_numpy(np.stack(images[:n_check])).to(dev, torch.float64)
    for wk in weights:
        y = conv2d_ref(x, torch.from_numpy(wk).to(dev, torch.float64))
        x = torch.from_numpy(relu_pool(y.cpu().numpy())).to(dev)
    want = (x.reshape(n_check, -1) @ torch.from_numpy(fc).to(dev, torch.float64)).cpu().numpy()
    got = np.stack(outputs[:n_check])
    if got.shape != (n_check, 10) or not np.isfinite(got).all():
        fail(f"serve: outputs of shape {got.shape} or non-finite")
    serve_err = float(np.abs(got - want).max())
    if serve_err > SERVE_ATOL:
        fail(f"serve: max abs err {serve_err} vs the float64 chain > {SERVE_ATOL}")
    emit({"phase": "serve", "net": f"cifar_cnn_{c1}_{c2}", "backends": backends,
          "slowdowns": [1.0, 1.0, 1.0], "partition": "kernel",
          "requests": requests, "max_batch": max_batch,
          "probe_s": rec["probe_s"], "shares": rec["shares"],
          "kernels_per_device_after": rec["kernels_per_device"],
          "statuses": rec["statuses"], "throughput_rps": rec["throughput_rps"],
          "p50_ms": rec["p50_ms"], "p99_ms": rec["p99_ms"], "wall_s": rec["wall_s"],
          "timing_s": rec["timing"],
          "launches": launches, "run_s": run_s, "trace": trace,
          "launches_by_shape": [list(k) + [n] for k, n in sorted(shard_shapes.items())],
          "checked_outputs": n_check, "max_abs_err_vs_f64_chain": serve_err,
          "atol": SERVE_ATOL})

    # -- 5. the kernel at every shape the main path gave it ------------------
    path_recs = []
    for shape, n in sorted(shard_shapes.items()):
        r = check_shape(conv2d, conv2d_ref, dev, *shape, torch.float32,
                        label=f"main path x{n}")
        r.update(phase="main_path_shape", launches=n)
        emit(r)
        path_recs.append(r)

    def total(key):
        return sum(r["launches"] * r[key] for r in path_recs)

    path_bound_ms, path_bound_by = bound(total("flops"), total("bytes"), torch.float32)
    kernels = [{
        "name": "conv2d_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/conv2d_fwd.cu",
        "replaces": "src/repro/kernels/conv2d.py:78",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in path_recs),
        "ms": trace["kernel_ms"],
        "plain_ms": total("plain_ms"),
        "bound_ms": path_bound_ms,
        "bound_by": path_bound_by,
        "library_ms": total("library_ms"),
        "isolated_ms": total("ms"),
        "per": "all of the serve run's launches; ms: the profiler trace "
               "of the serve run; plain_ms, library_ms, isolated_ms: each "
               "shape's isolated median times its launch count, summed",
    }]
    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.")
                                  for m in sys.modules):
        fail("the JAX package or jax was imported")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
