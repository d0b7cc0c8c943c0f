"""Quickest proof that the PyTorch/CUDA port builds, is right, serves and
trains on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines (``{"phase": ...}``):

1. device — the card's name, and ``nvidia-smi``'s name and power limit;
2. build  — ``nvcc`` builds every kernel library of the port from
   ``src/repro_torch/kernels/csrc/``, all sources at once (seconds, cache
   hit, and ptxas's registers, spills and shared memory for each kernel
   by name); a spill in K1's, K2's or K3's kernels fails the run;
3. kernel — the forward conv K1 against its plain PyTorch version
   (``conv2d_ref``) on the card, on the shapes of tests/test_kernels.py,
   the paper's C1 and C2 layers, a ragged and an empty Cout, a Cout that
   is not a multiple of 4 (4-byte copies of w) and a 7-row strip, in
   fp32 and bf16, each record with ``fwd_plan``'s plan; with median times
   of the kernel, the plain version, ``F.conv2d`` (cuDNN, TF32 off: a
   yardstick the port never calls), the backend's numpy round-trip
   copies, and the kernel's bound;
4. kernel_bwd — dX (K2) and dW (K3) against ``conv2d_dx_ref`` and
   ``conv2d_dw_ref`` the same way, at the test sweep's shapes, C1 and C2
   at batch 32, a ragged and an empty Cout, a Cout that is not a
   multiple of 4, no pixels and a 7-row strip, each record with
   ``dx_plan``'s or ``dw_plan``'s plan; the yardsticks are
   ``torch.nn.grad.conv2d_input``/``conv2d_weight``.  K2 also at Cin 1,
   3, 4, 5, 16, 17, 64 and 65 (both sides of its small-Cin variant) and
   on a small-M, large-K shape whose taps split.  K2 runs twice on C1
   and C2 and on the train run's microbatch shards, K3 twice on C1 at
   batch 32 and on a C2 shard, and each must give the same bits;
5. serve  — the port's ``run_serve`` on the paper's headline network
   ``cifar_cnn_500_1500`` over ``cuda,cuda,numpy``: 16 requests, every
   one ``ok``, 4 of them held against a single-device float64 chain on
   the card, inside a ``torch.profiler`` trace of the card;
6. main-path shapes (serve) — K1 against its plain version at every
   shard shape the serve run gave it, run twice (the same bits), timed
   in isolation;
7. train — the port's ``run_hetero(train_pipeline=True)`` on the same
   network at full width over ``cuda,cuda,numpy``: batch 32, 4
   microbatches, 3 steps, inside a profiler trace.  Every loss finite;
   the first step's loss and updated params equal one step taken from
   the same params and batch on one device in float64 (``cnn_loss`` with
   ``conv2d_ref``, autograd, SGD) to 1e-5 and 1e-4 (the later steps'
   differences are printed); K1, K2 and K3 each launched, and each
   wrapper's count equal to the trace's count of its kernel;
8. train_autograd — one step of ``cnn_loss`` through
   ``conv_fn_for_backend("cuda")`` (``Conv2dFunction``: K1, K2 and K3 on
   one device), held against the first float64 step;
9. main-path shapes (train) — K1, K2 and K3 at every shape the train run
   gave them, against their plain versions (K1 and K3 run twice: the
   same bits), timed in isolation;
10. kernel_attn — flash attention K4 against ``flash_attention_ref`` in
   float64 on the card: tests/test_kernels.py's sweep (fp32/bf16, causal
   on/off, window None/16), a GQA case, hymba-1.5b's prefill shape
   (B 4, H 25 over KV 5, S = T = 2048, D 64, window 1024), a ragged
   S = 2047, one query against T = 1024, and in bf16 D 20 and hymba's
   shape through a row stride that is not 16-byte aligned (the tensor-core
   kernel's scalar-load path); the model zoo's shapes: head_dim 128
   over GQA 32/8 under a 4096 window (llava), non-causal S = T = 1500
   (whisper's encoder), non-causal S < T (its cross-attention) and S > T
   (a prompt longer than the frames), in fp32 and bf16; with median
   times of the kernel, the plain version and
   ``F.scaled_dot_product_attention`` on the same boolean mask (a
   yardstick the port never calls);
11. kernel_ssd — the SSD scan K5 (three kernels: ``ssd_fwd_kernel``,
   each 64-step tile's local state; ``ssd_prefix_kernel``, the state
   entering each tile; ``ssd_out_kernel``, y) against
   ``ssd_chunked_ref`` in float64, y and the final state: the test
   sweep, hymba's shape (B 4, S 2048, H 50, P 64, N 16, chunk 256) in
   fp32 and bf16, a ragged S = 2000, S shorter than one chunk, G = H and
   P = 20; x, B and C read through the row stride of the model's
   in-projection, 16-byte aligned and not; hymba's shape rerun 20 times,
   the same bits, and its tile passes' launch grids from a profiler
   trace, each more blocks than B * H (no single PyTorch call computes
   SSD: no yardstick);
12. lm_serve (``serve_lm``) — the port's ``launch/serve.py`` path (``load`` +
   ``ServeEngine.generate``) on ``hymba-1.5b --full`` in its own bf16:
   batch 4, prompt 2048, 16 new tokens, greedy, inside a profiler trace.
   K4 and K5 each launched once per layer (32) and each wrapper's count
   equal to the trace's; then the same run again untraced, whose prefill
   seconds, decode ms per token and tokens/s are the headline (the trace
   gives the busy share); then generate's halves called one by one: the
   prefill (32 launches each, and the shape of every call) and 4 decode
   steps in a trace of their own (no launch; device events per step);
13. lm_check — the same model at full width in fp32, prefill and 16
   decode steps teacher-forced on the kernel path's tokens, the kernel
   path against the plain path (the kernels' plain versions passed as
   the model's ``attention_fn`` and ``ssd_fn``): logits within
   ``LM_RTOL`` of the largest logit, and the prefill's cache;
14. main-path shapes (lm_serve) — K4 and K5 at every shape the lm_serve
   run gave them, timed in isolation;
15. kernel_grad — ``FlashAttentionFunction`` (forward K4, backward
   ``flash_attention_vjp``) and ``SsdFunction`` (forward K5, backward
   ``ssd_vjp``) at hymba's training shapes (K4: B 2, H 25 over KV 5, S =
   T = 4,096, D 64, window 1,024; K5: B 2, S 4,096, H 50, P 64, N 16,
   chunk 256), fp32 and bf16: every input gradient against float64
   autograd through the plain versions, at the kernel bounds above; the
   forward launches its kernel once, the backward none; with the
   forward's and the vjp's isolated times (the vjps are plain torch: no
   TPU kernel computes a gradient);
16. lm_train — the port's ``launch/train.py`` (``train``) on
   ``hymba-1.5b`` at full width in bf16 (1.64 B params; nothing cut):
   batch 4 x 4,096 tokens in 2 microbatches, adam at lr 1e-3, cosine,
   remat full, 4 steps untraced (losses, s/step over steps 2-4,
   tokens/s, peak memory), then 1 step from the same seed in a profiler
   trace with CPU activity (K4's and K5's traced ms, the vjps' device ms
   from their ``record_function`` ranges, the busy share).  Every loss,
   aux and grad_norm finite; K4 and K5 128 launches a step each (2
   microbatches x 32 layers x the forward and the remat recompute), the
   trace's equal to the wrappers'; then ``lm_train_check``: step 1 in
   fp32 at full width (batch 1, SGD, remat full), the kernel path (K4,
   K5 and their vjps) against the plain path (autograd through the plain
   versions): loss within 1e-5, grad_norm within 1e-4, every clipped
   gradient leaf within 1e-3 of its largest value; then K4 and K5 at the
   train path's shapes, timed in isolation;
17. hierarchy — phase 7's training run (its network, batch,
   microbatches, steps and lr, held against its float64 steps) over
   the two-tier hierarchy: ``run_hetero(groups="2x2",
   group_partition="kernel")`` with a ``cuda`` root and two sub-master
   groups of one ``cuda`` and one ``numpy`` device each.  (a) in process,
   inside a profiler trace: every loss finite, step 1 within 1e-5 / 1e-4
   of the float64 step, each sub-master's hello meta a group of 2, K1, K2
   and K3 each launched and each wrapper's count equal to the trace's;
   (b) over tcp, each sub-master an OS process with its own CUDA context:
   the same loss and param checks, and per process the seconds from
   spawn to welcome, the device memory it holds before shutdown
   (``nvidia-smi``) and whether it is gone after; one left behind, or a
   kernel library rebuilt by a sub-master, fails the run.  One line per
   run, then K1-K3 at every shape the in-process run gave them.  Last:
   on the card (PyTorch 2.11) a short trace that follows a large one
   (this run's, or lm_serve's) can lose every kernel record, which
   failed phase 11's 3-call grid trace when this phase ran after phase
   9; the phase records how many of 3 K1 launches a short trace sees
   just before and just after it;
18. lm_zoo — phases 12-14 for each configuration of ``ZOO`` at full
   width in its own bf16, every earlier phase's tensors and the
   allocator's cache freed first: moonshot-v1-16b-a3b (48 layers, 64
   experts top-6, 56.1 GB of weights; K4 48 times a prefill),
   whisper-medium (24 + 24 layers, 1,500 frames; 72: encoder, decoder
   self- and cross-attention) and llava-next-mistral-7b (32 layers,
   2,880 patch positions in a 4,608-token prompt, window 4096; 32):
   the traced and untraced runs, the prefill's K4 launches and shapes,
   no launch in decode; ``lm_check`` in fp32 (whisper at full depth,
   moonshot cut to 2 layers and llava to 4 to fit fp32 on the card);
   K4 at every shape the runs gave it;
19. mesh_train — lm_train's run (``launch/train.py::train``, its config,
   seed and batches) for 2 steps under the card's (1, 1) mesh
   (``launch/mesh.py::make_host_mesh``, an NCCL group of one) with
   ``tp_mode="megatron"``: the state and batches DTensors, K4 and K5 on
   the ranks' shards through ``local_map``, in a profiler trace of the
   card.  K4 and K5 128 launches a step, the trace's equal to the
   wrappers'; the losses against lm_train's (step 1 within 1e-6, step 2
   within lm_train's own rerun bound, 1e-3); s/step and peak memory
   beside lm_train's;
20. mesh_serve — lm_serve's run through ``ServeEngine(mesh=...)`` on
   the same mesh: its 4 x 16 tokens must equal lm_serve's;
21. mesh_moe — moonshot-v1-16b-a3b at full width cut to 2 layers: the
   forward's logits through the MoE's expert-parallel mesh path (its
   ``local_map`` body and all-reduce over ``model``) against the
   mesh-less path's, within ``LM_RTOL`` of the largest logit;
22. mesh_cnn — one step of ``launch/dryrun_cnn.py``'s train step
   (``core/conv_shard.py``'s kernel-sharded conv: K1, K2 and K3 through
   ``local_map``) on the mesh, cifar_cnn_500_1500, batch 32, gather
   rules, held against phase 7's float64 step; K1-K3 at its shapes;
   then the §4.1.1 probe (``core/profiling.py``) on the card;
23. dryrun — ``launch/dryrun.py`` and ``launch/dryrun_cnn.py`` in
   subprocesses started together (each owns its fake process group):
   mamba2-370m train_4k on (16, 16) and decode_32k on (2, 16, 16), both
   under 80 GB a device; hymba-1.5b train_4k in megatron and gather;
   the CNN at batch 1024; and on the card's (1, 1) mesh mesh_train's
   exact shape (one microbatch, 2 x 4,096), whose roofline bound and
   counted peak are printed beside mesh_train's half step and
   ``max_memory_allocated``, with their ratios.  The records are also
   written under the gitignored ``build/chip_smoke_dryrun/``.

Every wrapper's launch count is set to 0 just before a main-path run
(serve, train, lm_serve, each lm_train run, the in-process hierarchy,
each lm_zoo run, mesh_train, mesh_serve, mesh_moe, mesh_cnn) and read
just after.
Then, on lines of their own: the ``nvidia-smi`` line, the kernels line (``{"kernels": [...]}``) and,
last, ``{"ok": true, "device": ...}``.  Any mismatch or failure raises
and exits non-zero; without a card, or without the rest of the
repository beside this file, it exits non-zero before printing any
result.
"""
from __future__ import annotations

import collections
import gc
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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
# both with rtol 0.05 (different summation orders over up to 37,500 terms)
TOL = {torch.float32: (2e-4, 0.05), torch.bfloat16: (5e-2, 0.05)}
# K4 and K5 compute in fp32 and round a bf16 output once, so it is held
# against the float64 plain version rounded to bf16: the two sit at most
# one bf16 step (2^-7 of the value) apart, which rtol 1e-2 holds, and atol
# 1e-3 holds outputs near 0.  TOL's bf16 atol of 5e-2 would be as large as
# a typical attention output over 1024 keys (std ~ sqrt(e/1024) ~ 0.05).
BF16_OUT_TOL = (1e-3, 1e-2)
SERVE_ATOL = 1e-3
# tests/test_train_pipeline.py's tolerances for a train step against the
# single-device step: every updated param, and the loss
PARAM_ATOL, LOSS_ATOL = 1e-4, 1e-5
SEED = 0
# lm_check: the kernel path's logits against the plain path's, max |diff|
# over max |logit| (fp32 throughout; see PERF.md for the choice)
LM_RTOL = 1e-3
# lm_zoo: (arch, batch, prompt, new tokens, K4 launches per prefill, the
# layers lm_check keeps in fp32 (None: all)).  whisper's prompt is 224
# tokens against 1,500 frames: 24 encoder, 24 decoder self- and 24 cross-
# attentions; llava's 4,608 = 2,880 patch positions + 1,728 text tokens
ZOO = (
    ("moonshot-v1-16b-a3b", 4, 2048, 16, 48, 2),
    ("whisper-medium", 4, 224, 16, 72, None),
    ("llava-next-mistral-7b", 4, 4608, 16, 32, 4),
)
# K5 reruns at hymba's prefill shape, each held bit-identical to the first
SSD_RERUNS = 20
# the wrappers' kernels by trace symbol: the first counts launches (K2's
# two variants share it), all of them count time (K1 and K2 reduce their
# tap splits and K3 its pixel chunks in a second kernel; K5 folds its
# tiles' states and writes y in a second and third)
SYMBOLS = {
    "conv2d_fwd": ("conv2d_fwd_kernel", "conv2d_fwd_reduce_kernel"),
    "conv2d_dx": ("conv2d_dx_kernel", "conv2d_dx_reduce_kernel"),
    "conv2d_dw": ("conv2d_dw_kernel", "conv2d_dw_reduce_kernel"),
    "flash_attention": ("flash_attn_fwd_kernel",),
    "ssd": ("ssd_fwd_kernel", "ssd_prefix_kernel", "ssd_out_kernel"),
}
CONV_KINDS = ("conv2d_fwd", "conv2d_dx", "conv2d_dw")
# the profiler ranges around the backward of K4 and K5 (plain torch)
VJP_RANGES = ("flash_attention_vjp", "ssd_vjp")
# lm_train: hymba-1.5b at full width, bf16, adam at lr 1e-3, cosine,
# remat full; 4 steps of batch 4 x 4,096 tokens in 2 microbatches, so K4
# and K5 run 2 x 32 x 2 = 128 times a step (microbatches x layers x the
# forward and the backward's recompute); then 1 step in a trace
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = "hymba-1.5b", 4, 4096, 2, 4
TRAIN_TRACED_STEPS = 1
# lm_train's step-1 parity in fp32 (kernel path against plain path):
# the loss, the gradient norm, and each clipped-gradient leaf against
# its largest value (lm_check's rule)
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4, 1e-3
# mesh_train: lm_train's run on the card's (1, 1) mesh for 2 steps.  Its
# step-1 loss is expected bit-equal to lm_train's (the same local ops on
# the same tensors), bounded at 1e-6 relative in case a DTensor op
# reduces in another order; step 2 follows a backward whose atomic adds
# vary between runs, so it takes lm_train's own rerun bound, 1e-3
MESH_TRAIN_STEPS = 2
MESH_LOSS_RTOL = (1e-6, 1e-3)
# short traces (mesh_cnn's, traced_grids'): tiny kernels launched before
# the measured ones, in place of the first records a trace that follows
# a large one can lose (PyTorch 2.11)
TRACE_PAD_KERNELS = 2000
# mesh_moe: moonshot cut to 2 layers (lm_check's cut)
MESH_MOE_LAYERS = 2
# each dry-run subprocess (they run together, on the host's cores)
DRYRUN_TIMEOUT_S = 420
# kernels that must build without spills (ptxas's report)
NO_SPILL = ("conv2d_fwd_kernel", "conv2d_dx_kernel", "conv2d_dw_kernel")


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


def ptxas_kernels(report: str, nvcc: str) -> list:
    """Each kernel of an ``nvcc -Xptxas -v`` report: its name (demangled
    by the toolkit's ``cu++filt`` where there is one), registers, spill
    bytes and static shared memory."""
    recs = []
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            recs.append({"kernel": m.group(1)})
            continue
        if not recs:
            continue
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
            recs[-1]["spill_stores"], recs[-1]["spill_loads"] = map(int, m.groups())
        if m := re.search(r"Used (\d+) registers", ln):
            recs[-1]["registers"] = int(m.group(1))
        if m := re.search(r"(\d+) bytes smem", ln):
            recs[-1]["smem"] = int(m.group(1))
    filt = Path(nvcc).parent / "cu++filt"
    if recs and filt.exists():
        out = subprocess.run([str(filt)], input="\n".join(r["kernel"] for r in recs),
                             capture_output=True, text=True, timeout=60, check=True)
        for r, name in zip(recs, out.stdout.splitlines()):
            r["kernel"] = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", name)
    return recs


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


def reps_for(flops: float) -> int:
    return 5 if flops > 1e11 else 20 if flops > 5e9 else 50


def conv_work(kind, b, h, w, cin, cout, k, dtype):
    """(operations, bytes) of one SAME conv, or of its dX or dW: the
    same 2*B*H*W*k*k*Cin*Cout operations; each input read once, the
    output written once (dW in float32)."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    flops = 2.0 * b * h * w * k * k * cin * cout
    x, wt, y = b * h * w * cin, k * k * cin * cout, b * h * w * cout
    nbytes = {"conv2d_fwd": itemsize * (x + wt + y),
              "conv2d_dx": itemsize * (y + wt + x),
              "conv2d_dw": itemsize * (x + y) + 4 * wt}[kind]
    return flops, nbytes


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / PEAK_BYTES_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def device_trace(prof, window_s: float) -> dict:
    """The card's activity in a profiler trace: each wrapper's kernel
    launches and summed time (``SYMBOLS``), and the share of
    ``window_s`` in which any kernel or copy ran (overlaps counted once;
    the ranges ``VJP_RANGES`` mark on the card's timeline are no work)."""
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name not in VJP_RANGES]
    kernels = {}
    for name, syms in SYMBOLS.items():
        ours = [e for e in dev if any(s in e.name for s in syms)]
        kernels[name] = {
            "launches": sum(syms[0] in e.name for e in ours),
            "ms": sum(e.time_range.elapsed_us() for e in ours) / 1e3,
        }
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    return {"device_events": len(dev), "kernels": kernels,
            "busy_ms": busy_us / 1e3, "window_ms": window_s * 1e3,
            "busy_share": busy_us / 1e6 / window_s}


def traced_grids(fn, names, calls: int = 3) -> dict:
    """The launch grid of each kernel of ``names`` that ``fn`` runs on
    the card, from the profiler's trace (written under the gitignored
    build/) of ``calls`` calls: a trace that follows another in the same
    process can lose its first kernel records, so ``TRACE_PAD_KERNELS``
    small kernels go first.  Fails where a kernel is not in the trace or
    its grids differ."""
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_PAD_KERNELS):
            pad.add_(1)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    path = ROOT / "build" / "chip_smoke_grid_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "kernel"]
    path.unlink()
    grids = {}
    for name in names:
        found = {tuple(e["args"].get("grid") or ()) for e in events if name in e["name"]}
        if len(found) != 1 or not all(next(iter(found))):
            fail(f"traced_grids: {name}'s grids in the trace of {calls} calls: {found}")
        grids[name] = list(next(iter(found)))
    return grids


def nchw(t):
    return t.permute(0, 3, 1, 2).contiguous()


def library_call(kind, x, w, g):
    """A no-argument call of the one PyTorch function that computes what
    the kernel does, on NCHW/OIHW copies (cuDNN, TF32 off): a yardstick
    the port never calls."""
    import torch.nn.functional as F

    pad = w.shape[0] // 2
    xc, gc, wc = nchw(x), nchw(g), w.permute(3, 2, 0, 1).contiguous()
    if kind == "conv2d_fwd":
        return lambda: F.conv2d(xc, wc, padding=pad)
    if kind == "conv2d_dx":
        return lambda: torch.nn.grad.conv2d_input(xc.shape, wc, gc, padding=pad)
    return lambda: torch.nn.grad.conv2d_weight(xc, wc.shape, gc, padding=pad)


class Kernels:
    """The port's wrappers and their plain versions, by name, each
    called as ``f(x, w, g)``."""

    def __init__(self):
        from repro_torch.kernels.conv2d import (
            conv2d,
            conv2d_dw,
            conv2d_dx,
            dw_plan,
            dx_plan,
            fwd_plan,
        )
        from repro_torch.kernels.flash_attn import flash_attention
        from repro_torch.kernels.ref import conv2d_dw_ref, conv2d_dx_ref, conv2d_ref
        from repro_torch.kernels.ssd import ssd, ssd_plan

        self.wrapper = {"conv2d_fwd": conv2d, "conv2d_dx": conv2d_dx,
                        "conv2d_dw": conv2d_dw, "flash_attention": flash_attention,
                        "ssd": ssd}
        self.conv2d_ref = conv2d_ref
        self.plans = {"conv2d_fwd": fwd_plan, "conv2d_dx": dx_plan, "conv2d_dw": dw_plan,
                      "ssd": ssd_plan}
        self.calls = {  # (kernel, plain version)
            "conv2d_fwd": (lambda x, w, g: conv2d(x, w),
                           lambda x, w, g: conv2d_ref(x, w)),
            "conv2d_dx": (lambda x, w, g: conv2d_dx(g, w),
                          lambda x, w, g: conv2d_dx_ref(g, w)),
            "conv2d_dw": (lambda x, w, g: conv2d_dw(x, g, w.shape[0], w.shape[1]),
                          lambda x, w, g: conv2d_dw_ref(x, g, w.shape[0], w.shape[1])),
        }

    def plan(self, kind, b, h, w, cin, cout, k, size, sms) -> dict:
        """The conv kernel's plan (``fwd_plan``, ``dx_plan`` or
        ``dw_plan``) for one shape, inputs of ``size`` bytes, on ``sms`` SMs."""
        if kind == "conv2d_dx":
            plan = self.plans[kind]((b, h, w, cout), k, k, cin, size, sms)
        else:
            plan = self.plans[kind]((b, h, w, cin), k, k, cout, size, sms)
        return plan._asdict()


def check_shape(ks: Kernels, kind, dev, b, h, w, cin, cout, k, dtype, *, label,
                phase, copy=False, rerun=False):
    """Run one kernel and its plain version on one shape; fail on a
    mismatch (and, with ``rerun``, if a second run gives other bits).
    Returns the JSON record of the shape, with the kernel's plan and
    median times of the kernel, the plain version and the library
    yardstick."""
    rng = np.random.default_rng([SEED, b, h, w, cin, cout, k])
    xn = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wn = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    gn = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    x, wt, g = (torch.from_numpy(a).to(dev).to(dtype) for a in (xn, wn, gn))
    run, plain = ks.calls[kind]
    fn = ks.wrapper[kind]
    before = fn.launches
    got = run(x, wt, g)
    torch.cuda.synchronize()
    # the plain version in float64: the error measured is the kernel's
    want = plain(x.double(), wt.double(), g.double())
    out_shape = {"conv2d_fwd": (b, h, w, cout), "conv2d_dx": (b, h, w, cin),
                 "conv2d_dw": (k, k, cin, cout)}[kind]
    out_dtype = torch.float32 if kind == "conv2d_dw" else dtype
    if tuple(got.shape) != out_shape or got.dtype != out_dtype:
        fail(f"{kind} {label}: shape/dtype {tuple(got.shape)} {got.dtype}")
    empty = got.numel() == 0 or b * h * w * cin * cout == 0
    if empty:
        if fn.launches != before:
            fail(f"{kind} {label}: an empty case launched the kernel")
        if got.numel() and bool(got.any()):
            fail(f"{kind} {label}: an empty case gave non-zero values")
        err = 0.0
    else:
        if not torch.isfinite(got).all():
            fail(f"{kind} {label}: non-finite output")
        err = (got.double() - want).abs().max().item()
        atol, rtol = TOL[dtype]
        if not torch.allclose(got.double(), want, atol=atol, rtol=rtol):
            fail(f"{kind} {label}: kernel vs its plain version max abs err "
                 f"{err} beyond atol {atol} rtol {rtol}")
        if rerun and not torch.equal(got, run(x, wt, g)):
            fail(f"{kind} {label}: two runs gave different bits")
    flops, nbytes = conv_work(kind, b, h, w, cin, cout, k, dtype)
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    rec = {
        "phase": phase, "kernel": kind, "case": label,
        "dtype": str(dtype).split(".")[-1],
        "shape": {"x": [b, h, w, cin], "w": [k, k, cin, cout]},
        "max_abs_err": err, "atol": TOL[dtype][0], "rtol": TOL[dtype][1],
        "ms": None, "plain_ms": None, "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "flops": flops, "bytes": nbytes,
    }
    if empty:
        return rec
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rec["plan"] = ks.plan(kind, b, h, w, cin, cout, k, itemsize(dtype), sms)
    if rerun:
        rec["bit_identical"] = True
    reps = reps_for(flops)
    rec["ms"] = events_ms(lambda: run(x, wt, g), reps)
    rec["plain_ms"] = events_ms(lambda: plain(x, wt, g), reps)
    rec["library_ms"] = events_ms(library_call(kind, x, wt, g), reps)
    if copy:
        # the cuda backend's numpy contract: x and the weight shard go to
        # the card, y comes back, on every conv call
        def roundtrip():
            torch.from_numpy(xn).to(dev)
            torch.from_numpy(wn).to(dev)
            got.cpu()
        rec["copy_ms"] = events_ms(roundtrip, max(5, reps // 4))
    return rec


class ShapeLog:
    """Records every conv and conv_vjp the ``cuda`` backend (the
    kernels' only caller on the main path) is asked for, by shape
    ``(b, h, w, cin, cout, k)``."""

    def __init__(self, backend):
        self.backend = backend
        self.fwd = collections.Counter()
        self.bwd = collections.Counter()
        self.lock = threading.Lock()  # devices on threads share the backend

    def __enter__(self):
        conv, vjp = self.backend.conv, self.backend.conv_vjp

        def observed_conv(x, w):
            with self.lock:
                self.fwd[tuple(x.shape) + (w.shape[-1], w.shape[0])] += 1
            return conv(x, w)

        def observed_vjp(x, w, g):
            with self.lock:
                self.bwd[tuple(x.shape) + (w.shape[-1], w.shape[0])] += 1
            return vjp(x, w, g)

        self.backend.conv, self.backend.conv_vjp = observed_conv, observed_vjp
        return self

    def __exit__(self, *exc):
        del self.backend.conv, self.backend.conv_vjp


def smi_query(*args) -> list:
    """``nvidia-smi`` rows of a query, each a list of its fields (no
    units)."""
    out = subprocess.run(["nvidia-smi", *args, "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return [[f.strip() for f in ln.split(",")] for ln in out.stdout.splitlines()
            if ln.strip()]


def _number(field: str):
    """A numeric ``nvidia-smi`` field, or None where it reads ``[N/A]``."""
    try:
        return float(field)
    except ValueError:
        return None


def compute_apps() -> dict:
    """pid -> MiB of device memory, for every process that holds a
    context on the card, as ``nvidia-smi`` sees it."""
    return {int(pid): _number(mib) for pid, mib in
            smi_query("--query-compute-apps=pid,used_memory")}


def memory_used_mib():
    return _number(smi_query("--query-gpu=memory.used")[0][0])


class SubMasterLog:
    """Watches the hierarchy's root (``cls``, the port's
    ``HierarchicalCluster``) through one ``run_hetero`` call: the
    seconds from each sub-master process's spawn to its welcome, each
    sub-master's hello metadata, and just before ``shutdown`` the device
    memory each process holds (``nvidia-smi``); just after, whether each
    process is gone from the host and the card."""

    def __init__(self, cls):
        self.cls = cls
        self.spawned, self.welcomed, self.procs = {}, {}, {}
        self.hello_meta = {}
        self.apps_before, self.apps_after = {}, {}
        self.mem_mib = {}

    def _patch(self, name, make):
        self._saved[name] = self.cls.__dict__.get(name)
        setattr(self.cls, name, make(getattr(self.cls, name)))

    def __enter__(self):
        self._saved = {}
        self.mem_mib["before"] = memory_used_mib()

        def spawn(orig):
            def wrapped(cluster, dev, *a, **kw):
                self.spawned[dev] = time.perf_counter()
                self.procs[dev] = orig(cluster, dev, *a, **kw)
                return self.procs[dev]
            return wrapped

        def accept(orig):
            def wrapped(cluster, *a, **kw):
                chan, dev, meta = orig(cluster, *a, **kw)
                self.welcomed[dev] = time.perf_counter()
                return chan, dev, meta
            return wrapped

        def shutdown(orig):
            def wrapped(cluster):
                self.hello_meta = {d: cluster.hello_meta.get(d) for d in cluster.slave_ids}
                self.apps_before = compute_apps()
                self.mem_mib["before_shutdown"] = memory_used_mib()
                orig(cluster)
                self.apps_after = compute_apps()
                self.mem_mib["after_shutdown"] = memory_used_mib()
            return wrapped

        self._patch("_spawn_slave_proc", spawn)
        self._patch("_accept_slave", accept)
        self._patch("shutdown", shutdown)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            if fn is None:
                delattr(self.cls, name)
            else:
                setattr(self.cls, name, fn)

    def sub_masters(self) -> list:
        """One record per spawned sub-master process."""
        return [{"device": dev, "pid": p.pid,
                 "spawn_to_welcome_s": self.welcomed[dev] - self.spawned[dev],
                 "used_memory_mib": self.apps_before.get(p.pid),
                 "returncode": p.poll(),
                 "gone_after_shutdown": p.poll() is not None
                 and p.pid not in self.apps_after}
                for dev, p in sorted(self.procs.items())]


def k1_records_in_a_trace(ks, dev, calls: int = 3) -> int:
    """How many of ``calls`` K1 launches a fresh profiler trace records
    (a short trace can lose kernel records after a large one)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1, 8, 8, 3, device=dev)
    w = torch.ones(5, 5, 3, 16, device=dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ks.wrapper["conv2d_fwd"](x, w)
        torch.cuda.synchronize()
    return sum("conv2d_fwd_kernel" in e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def build_dir_state() -> dict:
    """The kernel build directory's files and their modification times."""
    from repro_torch.kernels import _build

    return {p.name: p.stat().st_mtime_ns for p in _build.BUILD_DIR.iterdir()
            if p.suffix != ".lock"}


def reset_counts(ks: Kernels) -> None:
    for fn in ks.wrapper.values():
        fn.launches = 0


def read_counts(ks: Kernels, names=None) -> dict:
    return {name: fn.launches for name, fn in ks.wrapper.items()
            if names is None or name in names}


def path_shapes(ks, kind, dev, shapes, phase, path):
    """The kernel against its plain version at every shape a main-path
    run gave it (K1 and K3 run twice: the same bits); each record carries
    its launch count."""
    recs = []
    for shape, n in sorted(shapes.items()):
        r = check_shape(ks, kind, dev, *shape, torch.float32,
                        label=f"{path} x{n}", phase=phase,
                        rerun=kind in ("conv2d_fwd", "conv2d_dw"))
        r.update(launches=n, path=path)
        emit(r)
        recs.append(r)
    return recs


def float64_steps(cfg, batch, steps, lr, dev):
    """``steps`` single-device SGD steps in float64 on the card from the
    train run's params and batch: ``cnn_loss`` with the plain conv,
    autograd.  Returns (losses, params after each step)."""
    from repro_torch.launch.hetero import sgd_step, train_inputs
    from repro_torch.models.cnn import cnn_loss

    params, images, labels = train_inputs(cfg, batch, dev)
    p = {l: {n: t.double() for n, t in d.items()} for l, d in params.items()}
    images = images.double()
    losses, history = [], []
    for _ in range(steps):
        p, loss, _ = sgd_step(p, lambda q: cnn_loss(q, images, labels, cfg=cfg), lr)
        losses.append(loss)
        history.append(p)
    return losses, history


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def params_err(got, want) -> float:
    return max((got[l][n].double() - want[l][n]).abs().max().item()
               for l in want for n in want[l])


def total(recs, key):
    """A per-shape quantity summed over a run's launches."""
    return sum(r["launches"] * r[key] for r in recs)


def library_total(recs):
    """The yardstick summed over a run's launches, or None where no one
    PyTorch call computes the kernel's function."""
    if any(r["library_ms"] is None for r in recs):
        return None
    return total(recs, "library_ms")


def entry(kind, source, replaces, runs, dtype=torch.float32):
    """One kernels-line entry over the main-path runs that launched
    it: ``runs`` maps a path to (its shape records, its trace); the
    bound takes the peak rate of the runs' input ``dtype``."""
    recs = [r for rs, _ in runs.values() for r in rs]
    bound_ms, bound_by = bound(total(recs, "flops"), total(recs, "bytes"), dtype)
    return {
        "name": kind, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(tr["kernels"][kind]["launches"] for _, tr in runs.values()),
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": sum(tr["kernels"][kind]["ms"] for _, tr in runs.values()),
        "plain_ms": total(recs, "plain_ms"),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_total(recs),
        "isolated_ms": total(recs, "ms"),
        "by_path": {path: {"launches": tr["kernels"][kind]["launches"],
                           "ms": tr["kernels"][kind]["ms"],
                           "plain_ms": total(rs, "plain_ms"),
                           "library_ms": library_total(rs),
                           "bound_ms": bound(total(rs, "flops"), total(rs, "bytes"),
                                             dtype)[0]}
                    for path, (rs, tr) in runs.items()},
        "per": "all launches of the main-path runs named in by_path; ms: "
               "the profiler trace of those runs; plain_ms, library_ms, "
               "isolated_ms: each shape's isolated median times its "
               "launch count, summed",
    }


# -- K4 and K5 ---------------------------------------------------------------


def itemsize(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def live_pairs(s, t, causal, window) -> int:
    """(query, key) pairs the masks leave live for one (batch, head):
    query i at position t - s + i sees keys max(0, pos - window + 1) ..
    pos (causal) or .. t - 1."""
    total = 0
    for i in range(s):
        pos = t - s + i
        hi = min(t - 1, pos) if causal else t - 1
        lo = max(0, pos - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def attn_work(b, h, kv, s, t, d, causal, window, dtype):
    """(operations, bytes) of one flash attention: 4*D per live pair
    (q.k and p.v), q, k, v read once and o written once."""
    flops = 4.0 * d * b * h * live_pairs(s, t, causal, window)
    nbytes = itemsize(dtype) * (2 * b * h * s * d + 2 * b * kv * t * d)
    return flops, nbytes


def ssd_work(b, s, h, g, p, n, chunk, dtype, tile=64):
    """(operations, bytes) of one SSD scan cut into chunks and, inside
    each, into tiles of ``tile`` steps (the kernel's 64; ``tile=chunk``
    gives the whole-chunk formulation earlier rows were bounded by): per
    tile of Lv steps, the causal triangle's Lv(Lv+1)/2 pairs each cost
    2(N + P) (scores and scores x dt*x), the state and the inter term
    2*Lv*P*N each; x, B, C in the input dtype, dt and a float32 read once,
    y and the fp32 state written once."""
    chunk = min(chunk, s)
    flops = 0.0
    for c0 in range(0, s, chunk):
        for t0 in range(c0, min(c0 + chunk, s), tile):
            lv = min(tile, c0 + chunk - t0, s - t0)
            flops += 2.0 * lv * (lv + 1) / 2 * (n + p) + 4.0 * lv * p * n
    flops *= b * h
    nbytes = (itemsize(dtype) * (2 * b * s * h * p + 2 * b * s * g * n)
              + 4 * (b * s * h + h + b * h * p * n))
    return flops, nbytes


def sdpa_call(q, k, v, causal, window):
    """``F.scaled_dot_product_attention`` on the same inputs and boolean
    mask, with the kv heads repeated outside the timed call: the
    yardstick of K4, never called by the port."""
    import torch.nn.functional as F

    from repro_torch.kernels.ref import attention_mask

    g = q.shape[1] // k.shape[1]
    kr, vr = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    mask = attention_mask(q.shape[2], k.shape[2], causal, window, q.device)
    return lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask)


def check_attn(ks, dev, b, h, kv, s, t, d, causal, window, dtype, *, label, phase,
               pad=0):
    """K4 against its plain version in float64 on one shape (rounded to
    bf16 for a bf16 output: ``BF16_OUT_TOL``), q, k, v given as
    transposed views of (B, S, heads, D) tensors as the model gives them
    (of (B, S, heads, D + pad) tensors cut to D: a row stride that is not
    a multiple of 16 bytes for an odd pad); fail on a mismatch.  Returns
    the shape's record."""
    from repro_torch.kernels.ref import flash_attention_ref

    gen = torch.Generator(device=dev).manual_seed(SEED + s + t + d + h)
    q, k, v = (torch.randn((b, n, heads, d + pad), generator=gen, device=dev).to(dtype)
               [..., :d].transpose(1, 2) for n, heads in ((s, h), (t, kv), (t, kv)))
    fn = ks.wrapper["flash_attention"]
    got = fn(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    # one batch row at a time: llava's (32, 4608, 4608) scores are 5.4 GB
    # in float64 for one row
    want = torch.cat([flash_attention_ref(q[i : i + 1].double(), k[i : i + 1].double(),
                                          v[i : i + 1].double(), causal=causal,
                                          window=window) for i in range(b)])
    if tuple(got.shape) != (b, h, s, d) or got.dtype != dtype:
        fail(f"flash_attention {label}: shape/dtype {tuple(got.shape)} {got.dtype}")
    if not torch.isfinite(got).all():
        fail(f"flash_attention {label}: non-finite output")
    atol, rtol = TOL[dtype]
    if dtype == torch.bfloat16:
        want, (atol, rtol) = want.to(dtype).double(), BF16_OUT_TOL
    err = (got.double() - want).abs().max().item()
    if not torch.allclose(got.double(), want, atol=atol, rtol=rtol):
        fail(f"flash_attention {label}: kernel vs its plain version max abs err "
             f"{err} beyond atol {atol} rtol {rtol}")
    del want
    flops, nbytes = attn_work(b, h, kv, s, t, d, causal, window, dtype)
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    reps = reps_for(flops)
    return {
        "phase": phase, "kernel": "flash_attention", "case": label,
        "dtype": str(dtype).split(".")[-1],
        "shape": {"B": b, "H": h, "KV": kv, "S": s, "T": t, "D": d,
                  "causal": causal, "window": window, "row_stride": q.stride(2)},
        "max_abs_err": err, "atol": atol, "rtol": rtol,
        "ms": events_ms(lambda: fn(q, k, v, causal=causal, window=window), reps),
        "plain_ms": events_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=window), reps),
        "library_ms": events_ms(sdpa_call(q, k, v, causal, window), reps),
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
    }


def check_ssd(ks, dev, b, s, h, g, p, n, chunk, dtype, *, label, phase, width=None):
    """K5 against its plain version in float64 on one shape, y and the
    fp32 final state at 10x the fp32 kernel sweep's atol
    (tests/test_kernels.py's SSD rule), a bf16 y against the reference
    rounded to bf16 at that atol and ``BF16_OUT_TOL``'s rtol; fail on a
    mismatch.  With ``width``, x, B and C are views of one (B, S, width)
    buffer, as the model slices them from its in-projection (x first,
    then B, then C).  Returns the shape's record."""
    from repro_torch.kernels.ref import ssd_chunked_ref

    gen = torch.Generator(device=dev).manual_seed(SEED + s + h + p + n)
    x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=dev))
    a = -torch.exp(torch.randn((h,), generator=gen, device=dev) * 0.5)
    bm, cm = (torch.randn((b, s, g, n), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    if width is not None:
        buf = torch.zeros((b, s, width), dtype=dtype, device=dev)
        col, views = 0, []
        for t in (x, bm, cm):
            sl = buf[:, :, col : col + t.shape[2] * t.shape[3]]
            sl.copy_(t.reshape(b, s, -1))
            views.append(sl.view(t.shape))
            col += t.shape[2] * t.shape[3]
        x, bm, cm = views
    fn = ks.wrapper["ssd"]
    y, state = fn(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    y_want, s_want = ssd_chunked_ref(x.double(), dt.double(), a.double(), bm.double(),
                                     cm.double(), min(chunk, s))
    if (tuple(y.shape) != (b, s, h, p) or y.dtype != dtype
            or tuple(state.shape) != (b, h, p, n) or state.dtype != torch.float32):
        fail(f"ssd {label}: shapes/dtypes {tuple(y.shape)} {y.dtype} "
             f"{tuple(state.shape)} {state.dtype}")
    if not (torch.isfinite(y).all() and torch.isfinite(state).all()):
        fail(f"ssd {label}: non-finite output")
    atol, rtol = 10 * TOL[torch.float32][0], TOL[torch.float32][1]
    y_rtol = rtol
    if dtype == torch.bfloat16:
        y_want, y_rtol = y_want.to(dtype).double(), BF16_OUT_TOL[1]
    err = (y.double() - y_want).abs().max().item()
    s_err = (state.double() - s_want).abs().max().item()
    y_max = y_want.abs().max().item()  # a bf16 step is 2**(floor(log2 |y|) - 7)
    if not (torch.allclose(y.double(), y_want, atol=atol, rtol=y_rtol)
            and torch.allclose(state.double(), s_want, atol=atol, rtol=rtol)):
        fail(f"ssd {label}: kernel vs its plain version max abs err y {err} state "
             f"{s_err} beyond atol {atol} rtol {y_rtol} (y) {rtol} (state)")
    flops, nbytes = ssd_work(b, s, h, g, p, n, chunk, dtype)
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    chunk_flops = ssd_work(b, s, h, g, p, n, chunk, dtype, tile=min(chunk, s))[0]
    reps = reps_for(flops)
    return {
        "phase": phase, "kernel": "ssd", "case": label,
        "plan": ks.plans["ssd"](b, s, h, p, n, chunk)._asdict(),
        "dtype": str(dtype).split(".")[-1],
        "shape": {"B": b, "S": s, "H": h, "G": g, "P": p, "N": n, "chunk": chunk},
        "row_stride": x.stride(1),
        "max_abs_err": max(err, s_err), "max_abs_err_y": err, "max_abs_err_state": s_err,
        "max_abs_y": y_max,
        "atol": atol, "rtol": rtol, "rtol_y": y_rtol,
        "ms": events_ms(lambda: fn(x, dt, a, bm, cm, chunk=chunk), reps),
        "plain_ms": events_ms(lambda: ssd_chunked_ref(x, dt, a, bm, cm, min(chunk, s)),
                              reps),
        "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        # the whole-chunk formulation's operations over the fp32 peak: the
        # bound that earlier records of this kernel give
        "chunk_flops": chunk_flops,
        "bound_ms_chunk_ops": chunk_flops / PEAK_FLOPS[torch.float32] * 1e3,
    }


def lm_check(dev, arch, batch, prompt, new, seed, layers=None):
    """The model at full width in fp32 (its first ``layers`` layers, or
    all), the kernel path (K4, and K5 where the model has an SSM) against
    the plain path (their plain versions passed as ``attention_fn`` and
    ``ssd_fn``) on the same weights and batch (``make_batch``: tokens,
    and patches or frames): the prefill's logits and every cache entry,
    then ``new`` decode steps teacher-forced on the kernel path's greedy
    tokens.  Returns the record; fails beyond ``LM_RTOL``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import flash_attention_ref, ssd_chunked_ref
    from repro_torch.launch.serve import make_batch
    from repro_torch.models.registry import build_model

    cfg = get_config(arch)
    cut = {} if layers is None else {"num_layers": layers}
    cfg = cfg.with_(dtype="float32", param_dtype="float32", **cut)
    api = build_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(seed), dev)
    inputs = make_batch(cfg, seed=seed, batch=batch, prompt_len=prompt, device=dev)
    plain = {"attention_fn": flash_attention_ref}
    if cfg.ssm is not None:
        plain["ssd_fn"] = ssd_chunked_ref

    def rel(got, want):
        return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()

    with torch.inference_mode():
        t0 = time.perf_counter()
        lk, ck = api.prefill(params, inputs, cache_len=prompt + new)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lp, cp = api.prefill(params, inputs, cache_len=prompt + new, **plain)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not torch.isfinite(lk).all():
            fail(f"lm_check {arch}: non-finite prefill logits on the kernel path")
        prefill_rel = rel(lk, lp)
        cache_rel = {key: rel(ck[key].float(), cp[key].float())
                     for key in sorted(ck) if key != "t"}
        step_rel = []
        nxt = lk.argmax(-1)
        for _ in range(new):
            lk, ck = api.decode_step(params, ck, nxt[:, None])
            lp, cp = api.decode_step(params, cp, nxt[:, None])
            step_rel.append(rel(lk, lp))
            nxt = lk.argmax(-1)
    rec = {"phase": "lm_check", "arch": arch, "dtype": "float32", "batch": batch,
           "prompt_len": prompt, "decode_steps": new,
           "layers": cfg.num_layers, "depth_cut": layers is not None,
           "prefill_rel_err": prefill_rel, "cache_rel_err": cache_rel,
           "decode_rel_err_by_step": step_rel, "rtol": LM_RTOL,
           "prefill_kernel_s": t1 - t0, "prefill_plain_s": t2 - t1,
           "max_logit": float(lp.abs().max())}
    worst = max([prefill_rel, *cache_rel.values(), *step_rel])
    if worst > LM_RTOL:
        fail(f"lm_check: kernel path vs plain path relative err {worst} > {LM_RTOL}: {rec}")
    del params, ck, cp
    return rec


def serve_lm(ks, dev, arch, lm_batch, prompt, new, per_prefill, phase):
    """The port's ``launch/serve.py`` path (``load`` +
    ``ServeEngine.generate``) on ``arch --full`` in its own dtype, greedy:
    a run inside a profiler trace, whose launches of K4 and K5 must equal
    ``per_prefill`` (one prefill) and the trace's counts; the same run
    untraced (the headline times); then generate's halves called one by
    one on the same inputs: the prefill with observers as its
    ``attention_fn`` (and ``ssd_fn``), which record each call's shape
    and launch ``per_prefill``, and 4 decode steps in a trace of their
    own, which launch neither kernel.  Returns (the record, K4's shapes,
    K5's shapes, the trace of the run)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import load

    lm_kinds = ("flash_attention", "ssd")
    engine, lm_inputs = load(arch, full=True, seed=SEED, batch=lm_batch,
                             prompt_len=prompt, device=dev)
    api, lm_cfg = engine.api, engine.api.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        reset_counts(ks)
        t_run = time.perf_counter()
        tokens = engine.generate(lm_inputs, max_new_tokens=new, timings=timings)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        lm_counts = read_counts(ks)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lm_trace = device_trace(prof, run_s)
    for kind in lm_kinds:
        if lm_counts[kind] != per_prefill[kind]:
            fail(f"{phase} {arch}: {kind} launched {lm_counts[kind]} times, want "
                 f"{per_prefill[kind]}")
        if lm_trace["kernels"][kind]["launches"] != lm_counts[kind]:
            fail(f"{phase} {arch}: the trace holds {lm_trace['kernels'][kind]['launches']} "
                 f"{kind} launches, the wrapper counted {lm_counts[kind]}")
    if per_prefill["flash_attention"] == 0:
        fail(f"{phase} {arch}: K4 was never launched on the main path")
    if any(lm_counts[k] for k in CONV_KINDS):
        fail(f"{phase} {arch}: a conv kernel ran on the language model's path: {lm_counts}")
    if (tuple(tokens.shape) != (lm_batch, new) or int(tokens.min()) < 0
            or int(tokens.max()) >= lm_cfg.vocab_size):
        fail(f"{phase} {arch}: tokens {tuple(tokens.shape)} or their range")
    # the same run again outside the profiler, whose per-launch cost
    # inflates decode's thousands of small launches: the headline times
    untraced = {}
    reset_counts(ks)
    t_run = time.perf_counter()
    again = engine.generate(lm_inputs, max_new_tokens=new, timings=untraced)
    torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t_run
    if read_counts(ks, lm_kinds) != per_prefill:
        fail(f"{phase} {arch}: the untraced run launched {read_counts(ks)}")
    attn_shapes, ssd_shapes = collections.Counter(), collections.Counter()

    def observed_attn(q, k, v, *, causal, window):
        attn_shapes[(q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                     q.shape[3], causal, window, q.dtype)] += 1
        return ks.wrapper["flash_attention"](q, k, v, causal=causal, window=window)

    def observed_ssd(x, dt, a, bm, cm, *, chunk):
        ssd_shapes[tuple(x.shape[:3]) + (bm.shape[2], x.shape[3], bm.shape[3], chunk,
                                         x.dtype)] += 1
        return ks.wrapper["ssd"](x, dt, a, bm, cm, chunk=chunk)

    fns = {"attention_fn": observed_attn}
    if lm_cfg.ssm is not None:
        fns["ssd_fn"] = observed_ssd
    traced_steps = 4
    with torch.inference_mode():
        reset_counts(ks)
        logits, cache = api.prefill(engine.params, lm_inputs, cache_len=prompt + new, **fns)
        prefill_counts = read_counts(ks, lm_kinds)
        if not torch.isfinite(logits).all():
            fail(f"{phase} {arch}: non-finite prefill logits")
        nxt = logits.argmax(-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as dprof:
            reset_counts(ks)
            t_run = time.perf_counter()
            for _ in range(traced_steps):
                logits, cache = api.decode_step(engine.params, cache, nxt[:, None])
                nxt = logits.argmax(-1)
            torch.cuda.synchronize()
            decode_traced_s = time.perf_counter() - t_run
            decode_counts = read_counts(ks, lm_kinds)
    del cache
    decode_trace = device_trace(dprof, decode_traced_s)
    if prefill_counts != per_prefill:
        fail(f"{phase} {arch}: the prefill launched {prefill_counts}, want {per_prefill}")
    if any(decode_counts.values()) or any(decode_trace["kernels"][k]["launches"]
                                          for k in lm_kinds):
        fail(f"{phase} {arch}: decode launched {decode_counts}")
    decode_ms = untraced["decode_s"] / untraced["decode_steps"] * 1e3
    events_per_step = decode_trace["device_events"] / traced_steps
    rec = {"phase": phase, "arch": arch, "full": True,
           "dtype": str(lm_cfg.compute_dtype).split(".")[-1],
           "params_b": sum(t.numel() for t in _leaves(engine.params)) / 1e9,
           "batch": lm_batch, "prompt_len": prompt, "new_tokens": new,
           "inputs": {k: list(t.shape) for k, t in lm_inputs.items()},
           "prefill_s": untraced["prefill_s"], "decode_ms_per_token": decode_ms,
           "decode_tokens_per_s": lm_batch * 1e3 / decode_ms,
           "tokens_per_s": lm_batch * new / untraced_s, "run_s": untraced_s,
           "traced": {"prefill_s": timings["prefill_s"],
                      "decode_ms_per_token":
                          timings["decode_s"] / timings["decode_steps"] * 1e3,
                      "run_s": run_s},
           "peak_memory_gb": peak_gb, "launches": lm_counts,
           "prefill_launches": prefill_counts, "decode_launches": decode_counts,
           "trace": lm_trace,
           "decode_trace": {"steps": traced_steps,
                            "device_events_per_step": events_per_step,
                            "traced_ms_per_step": decode_traced_s / traced_steps * 1e3,
                            "busy_ms_per_step": decode_trace["busy_ms"] / traced_steps,
                            "busy_share": decode_trace["busy_share"],
                            "untraced_us_per_device_event":
                                decode_ms * 1e3 / events_per_step},
           "tokens_head": tokens[:2, :8].tolist(), "tokens": tokens.tolist(),
           "untraced_tokens_equal": bool(torch.equal(tokens, again))}
    del engine, lm_inputs, tokens, again
    gc.collect()
    torch.cuda.empty_cache()
    return rec, attn_shapes, ssd_shapes, lm_trace


def attn_path_shapes(ks, dev, shapes, path):
    """K4 against its plain version at every shape a main-path run gave
    it, timed in isolation; each record carries its launch count."""
    recs = []
    for (b_, h_, kv_, s_, t_, d_, causal, window, dtype), n in sorted(shapes.items(),
                                                                     key=str):
        r = check_attn(ks, dev, b_, h_, kv_, s_, t_, d_, causal, window, dtype,
                       label=f"{path} x{n}", phase="main_path_shape")
        r.update(launches=n, path=path)
        emit(r)
        recs.append(r)
    return recs


def ssd_path_shapes(ks, dev, shapes, path):
    """K5 against its plain version at every shape a main-path run gave
    it, timed in isolation; each record carries its launch count."""
    recs = []
    for (b_, s_, h_, g_, p_, n_, chunk, dtype), n in sorted(shapes.items(), key=str):
        r = check_ssd(ks, dev, b_, s_, h_, g_, p_, n_, chunk, dtype,
                      label=f"{path} x{n}", phase="main_path_shape")
        r.update(launches=n, path=path)
        emit(r)
        recs.append(r)
    return recs


def grad_close(got, want, dtype, atol, rtol):
    """(max abs err, within bounds) of a gradient against its float64
    reference; a bf16 gradient (rounded once from fp32) against the
    reference rounded to bf16 at ``BF16_OUT_TOL``'s rtol."""
    if got.dtype == torch.bfloat16:
        want, rtol = want.to(torch.bfloat16).double(), BF16_OUT_TOL[1]
    err = (got.double() - want).abs().max().item()
    return err, bool(torch.allclose(got.double(), want, atol=atol, rtol=rtol))


def check_grad_attn(ks, dev, b, h, kv, s, t, d, causal, window, dtype):
    """``FlashAttentionFunction`` (forward K4, backward
    ``flash_attention_vjp``) at one shape: dq, dk, dv against float64
    autograd through the plain version, one batch row at a time, at
    ``TOL`` (``BF16_OUT_TOL`` for bf16); the forward launches K4 once and
    the backward no kernel.  Returns the record, with the forward's and
    the vjp's isolated times."""
    from repro_torch.kernels.flash_attn import FlashAttentionFunction, flash_attention_vjp
    from repro_torch.kernels.ref import flash_attention_ref

    gen = torch.Generator(device=dev).manual_seed(SEED + s + h)
    q, k, v = (torch.randn((b, n, heads, d), generator=gen, device=dev).to(dtype)
               .transpose(1, 2).requires_grad_(True)
               for n, heads in ((s, h), (t, kv), (t, kv)))
    dout = torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
    fn = ks.wrapper["flash_attention"]
    before = fn.launches
    out = FlashAttentionFunction.apply(q, k, v, causal, window)
    fwd_launches = fn.launches - before
    out.backward(dout)
    torch.cuda.synchronize()
    bwd_launches = fn.launches - before - fwd_launches
    if fwd_launches != 1 or bwd_launches != 0:
        fail(f"kernel_grad flash_attention: forward launched K4 {fwd_launches} times, "
             f"backward {bwd_launches}")
    atol, rtol = TOL[torch.float32]
    errs, ok = {}, True
    for i in range(b):
        leaves = [x[i : i + 1].detach().double().requires_grad_(True) for x in (q, k, v)]
        flash_attention_ref(*leaves, causal=causal, window=window).backward(
            dout[i : i + 1].double())
        for name, x, ref in zip(("dq", "dk", "dv"), (q, k, v), leaves):
            err, good = grad_close(x.grad[i : i + 1], ref.grad, dtype, atol, rtol)
            errs[name] = max(errs.get(name, 0.0), err)
            ok = ok and good
        del leaves
    if not ok:
        fail(f"kernel_grad flash_attention {dtype}: gradients vs float64 max abs err {errs}")
    qd, kd, vd, od = q.detach(), k.detach(), v.detach(), out.detach()
    rec = {"phase": "kernel_grad", "kernel": "flash_attention", "dtype": str(dtype)[6:],
           "shape": {"B": b, "H": h, "KV": kv, "S": s, "T": t, "D": d, "causal": causal,
                     "window": window},
           "max_abs_err": errs, "atol": atol,
           "rtol": rtol if dtype == torch.float32 else BF16_OUT_TOL[1],
           "forward_launches": fwd_launches, "backward_launches": bwd_launches,
           "forward_ms": events_ms(lambda: fn(qd, kd, vd, causal=causal, window=window), 5),
           "vjp_ms": events_ms(lambda: flash_attention_vjp(qd, kd, vd, od, dout, causal,
                                                           window), 3),
           "vjp": "plain torch, no TPU kernel"}
    del q, k, v, out, dout, qd, kd, vd, od
    torch.cuda.empty_cache()
    return rec


def check_grad_ssd(ks, dev, b, s, h, g, p, n, chunk, dtype):
    """``SsdFunction`` (forward K5, backward ``ssd_vjp``) at one shape,
    with cotangents on y and the final state: dx, ddt, da, dB, dC against
    float64 autograd through the plain version, at K5's bounds (10x the
    fp32 atol; ``BF16_OUT_TOL``'s rtol for bf16); the forward launches K5
    once and the backward no kernel.  Returns the record."""
    from repro_torch.kernels.ref import ssd_chunked_ref
    from repro_torch.kernels.ssd import SsdFunction, ssd_vjp

    gen = torch.Generator(device=dev).manual_seed(SEED + s + h + p)
    ins = [torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype),
           torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=dev)),
           -torch.exp(torch.randn((h,), generator=gen, device=dev) * 0.5),
           torch.randn((b, s, g, n), generator=gen, device=dev).to(dtype),
           torch.randn((b, s, g, n), generator=gen, device=dev).to(dtype)]
    ins = [x.requires_grad_(True) for x in ins]
    dy = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    dstate = torch.randn((b, h, p, n), generator=gen, device=dev)
    fn = ks.wrapper["ssd"]
    before = fn.launches
    y, state = SsdFunction.apply(*ins, chunk)
    fwd_launches = fn.launches - before
    torch.autograd.backward((y, state), (dy, dstate))
    torch.cuda.synchronize()
    bwd_launches = fn.launches - before - fwd_launches
    if fwd_launches != 1 or bwd_launches != 0:
        fail(f"kernel_grad ssd: forward launched K5 {fwd_launches} times, "
             f"backward {bwd_launches}")
    leaves = [x.detach().double().requires_grad_(True) for x in ins]
    y64, s64 = ssd_chunked_ref(*leaves, min(chunk, s))
    torch.autograd.backward((y64, s64), (dy.double(), dstate.double()))
    atol, rtol = 10 * TOL[torch.float32][0], TOL[torch.float32][1]
    errs, ok = {}, True
    for name, x, ref in zip(("dx", "ddt", "da", "dB", "dC"), ins, leaves):
        errs[name], good = grad_close(x.grad, ref.grad, dtype, atol, rtol)
        ok = ok and good
    if not ok:
        fail(f"kernel_grad ssd {dtype}: gradients vs float64 max abs err {errs}")
    det = [x.detach() for x in ins]
    rec = {"phase": "kernel_grad", "kernel": "ssd", "dtype": str(dtype)[6:],
           "shape": {"B": b, "S": s, "H": h, "G": g, "P": p, "N": n, "chunk": chunk},
           "max_abs_err": errs, "atol": atol,
           "rtol": rtol if dtype == torch.float32 else BF16_OUT_TOL[1],
           "forward_launches": fwd_launches, "backward_launches": bwd_launches,
           "forward_ms": events_ms(lambda: fn(*det, chunk=chunk), 5),
           "vjp_ms": events_ms(lambda: ssd_vjp(*det, chunk, dy, None), 3),
           "vjp": "plain torch, no TPU kernel"}
    del ins, leaves, y, state, y64, s64, det
    torch.cuda.empty_cache()
    return rec


def vjp_device_ms(prof) -> dict:
    """Device time of the kernels each ``VJP_RANGES`` range launched
    (profiled with CPU activity), and the ranges' count."""
    out = {name: {"calls": 0, "ms": 0.0} for name in VJP_RANGES}
    for e in prof.events():
        if e.name in VJP_RANGES and e.device_type == torch.autograd.DeviceType.CPU:
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            out[e.name]["calls"] += 1
            out[e.name]["ms"] += total / 1e3
    return out


def lm_train(ks, dev):
    """The port's ``launch/train.py`` (``train``) on hymba-1.5b at full
    width (``full=True``: the published config in bf16, remat full):
    ``TRAIN_STEPS`` steps of adam at lr 1e-3 (cosine) on batch
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` in ``TRAIN_ACCUM`` microbatches,
    untraced (losses, s/step, tokens/s, peak memory); then
    ``TRAIN_TRACED_STEPS`` steps from the same seed inside a profiler
    trace with CPU activity (K4's and K5's traced time, the vjps' device
    time, the busy share).  Every loss, aux and grad_norm finite; each
    run's K4 and K5 launches 128 a step, and the trace's equal to the
    wrappers'.  Returns (the record, K4's and K5's train shapes and the
    traced run's launch counts, the trace)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import train

    cfg = get_config(TRAIN_ARCH)
    per_step = TRAIN_ACCUM * cfg.num_layers * 2
    kinds = ("flash_attention", "ssd")
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=1e-3, optimizer="adam",
              grad_accum=TRAIN_ACCUM, full=True, seed=SEED, device=dev, log_every=1,
              log=lambda line: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ks)
    t0 = time.perf_counter()
    state, recs = train(TRAIN_ARCH, steps=TRAIN_STEPS, **kw)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts(ks)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    params_b = sum(t.numel() for t in _leaves(state.params)) / 1e9
    del state
    gc.collect()
    torch.cuda.empty_cache()
    for r in recs:
        if not all(np.isfinite(r[k]) for k in ("loss", "aux_loss", "grad_norm")):
            fail(f"lm_train: non-finite metrics {recs}")
    for kind in kinds:
        if counts[kind] != per_step * TRAIN_STEPS:
            fail(f"lm_train: {kind} launched {counts[kind]} times in {TRAIN_STEPS} "
                 f"steps, want {per_step} a step")
    if any(counts[k] for k in CONV_KINDS):
        fail(f"lm_train: a conv kernel ran on the language model's path: {counts}")
    s_per_step = (recs[-1]["elapsed_s"] - recs[0]["elapsed_s"]) / (TRAIN_STEPS - 1)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        reset_counts(ks)
        t0 = time.perf_counter()
        state, traced = train(TRAIN_ARCH, steps=TRAIN_TRACED_STEPS, **kw)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
        traced_counts = read_counts(ks)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the busy share over the steps, not the params' draw before them
    trace = device_trace(prof, traced[-1]["elapsed_s"])
    vjps = vjp_device_ms(prof)
    del prof
    trace_read_s = time.perf_counter() - t0
    for kind in kinds:
        if traced_counts[kind] != per_step * TRAIN_TRACED_STEPS:
            fail(f"lm_train traced: {kind} launched {traced_counts[kind]} times")
        if trace["kernels"][kind]["launches"] != traced_counts[kind]:
            fail(f"lm_train: the trace holds {trace['kernels'][kind]['launches']} {kind} "
                 f"launches, the wrapper counted {traced_counts[kind]}")
    # the same seed, the same steps: the same losses but for the order of
    # atomic adds in a backward (1e-3 relative)
    rerun_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                 for a, b in zip(traced, recs)]
    if max(rerun_rel) > 1e-3:
        fail(f"lm_train: the traced run's losses {traced} differ from the first run's")
    for name, v in vjps.items():
        if v["calls"] != per_step // 2 * TRAIN_TRACED_STEPS:
            fail(f"lm_train: {v['calls']} {name} ranges in the trace, want "
                 f"{per_step // 2} a step")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n = TRAIN_TRACED_STEPS
    rec = {"phase": "lm_train", "arch": TRAIN_ARCH, "full": True, "dtype": cfg.dtype,
           "params_b": params_b, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "grad_accum": TRAIN_ACCUM, "optimizer": "adam", "lr": 1e-3,
           "schedule": "cosine", "remat": "full", "steps": TRAIN_STEPS,
           "losses": [r["loss"] for r in recs], "aux": [r["aux_loss"] for r in recs],
           "grad_norms": [r["grad_norm"] for r in recs], "lrs": [r["lr"] for r in recs],
           "elapsed_s": [r["elapsed_s"] for r in recs],
           "s_per_step_2_to_4": s_per_step, "tokens_per_s": tokens / s_per_step,
           "first_step_s": recs[0]["elapsed_s"], "run_s": run_s,
           "peak_memory_gb": peak_gb, "launches": counts,
           "launches_per_step": {k: counts[k] // TRAIN_STEPS for k in kinds},
           "traced": {"steps": n, "run_s": traced_s, "launches": traced_counts,
                      "loss_rel_diff_to_first_run": rerun_rel,
                      "trace_read_s": trace_read_s,
                      "busy_share": trace["busy_share"],
                      "note": "traced with CPU activity, which slows the host: the "
                              "busy share is a lower bound",
                      "k4_ms_per_step": trace["kernels"]["flash_attention"]["ms"] / n,
                      "k5_ms_per_step": trace["kernels"]["ssd"]["ms"] / n,
                      "flash_attention_vjp_ms_per_step": vjps["flash_attention_vjp"]["ms"] / n,
                      "ssd_vjp_ms_per_step": vjps["ssd_vjp"]["ms"] / n,
                      "busy_ms_per_step": trace["busy_ms"] / n,
                      "device_events_per_step": trace["device_events"] / n,
                      "vjps": "plain torch, no TPU kernel"}}
    b = TRAIN_BATCH // TRAIN_ACCUM
    attn_shape = (b, cfg.num_heads, cfg.num_kv_heads, TRAIN_SEQ, TRAIN_SEQ,
                  cfg.resolved_head_dim, True, cfg.sliding_window, cfg.compute_dtype)
    ssm = cfg.ssm
    ssd_shape = (b, TRAIN_SEQ, ssm.n_heads(cfg.d_model), ssm.n_groups, ssm.head_dim,
                 ssm.d_state, ssm.chunk_size, torch.float32)
    shapes = ({attn_shape: traced_counts["flash_attention"]},
              {ssd_shape: traced_counts["ssd"]})
    return rec, shapes, trace


def lm_train_check(ks, dev):
    """Step 1 of the train step at full width and depth in fp32 (``dtype``
    and ``param_dtype`` float32; it fits the card without a cut), batch
    1 x ``TRAIN_SEQ``, SGD, remat full: the kernel path (K4, K5 and
    their vjps) against the plain path (the kernels' plain versions as
    ``attention_fn`` / ``ssd_fn``, autograd through them) from the same
    params and batch; the kernel path launches K4 and K5 twice a layer
    (forward and recompute), the plain path neither.  The loss within
    ``TRAIN_LOSS_RTOL``, the
    gradient norm within ``TRAIN_GNORM_RTOL``, and every leaf of the
    clipped gradient (SGD's first momentum) within ``TRAIN_GRAD_RTOL``
    of its largest value.  Returns the record."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data.pipeline import synthetic_token_batches
    from repro_torch.kernels.ref import flash_attention_ref, ssd_chunked_ref
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import tree_paths

    cfg = get_config(TRAIN_ARCH).with_(dtype="float32", param_dtype="float32")
    api = build_model(cfg)
    run = RunConfig(optimizer="sgd", learning_rate=1e-3, remat="full", warmup_steps=1,
                    total_steps=1)
    state = init_train_state(torch.Generator(device=dev).manual_seed(SEED), api, run, dev)
    torch.cuda.reset_peak_memory_stats()
    host = next(synthetic_token_batches(1, TRAIN_SEQ, cfg.vocab_size, seed=SEED))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    out, secs, launched = {}, {}, {}
    for path, fns in (("kernel", {}), ("plain", {"attention_fn": flash_attention_ref,
                                                  "ssd_fn": ssd_chunked_ref})):
        reset_counts(ks)
        t0 = time.perf_counter()
        new, metrics = make_train_step(api, run, **fns)(state, batch)
        torch.cuda.synchronize()
        secs[path] = time.perf_counter() - t0
        launched[path] = read_counts(ks, ("flash_attention", "ssd"))
        out[path] = ({k: float(v) for k, v in metrics.items()},
                     dict(tree_paths(new.opt_state["mu"])))
        del new
        gc.collect()
        torch.cuda.empty_cache()
    want = {"kernel": 2 * cfg.num_layers, "plain": 0}
    if any(n != want[path] for path, counts in launched.items() for n in counts.values()):
        fail(f"lm_train_check: launches {launched}, want K4 and K5 {want} times")
    (mk, gk), (mp, gp) = out["kernel"], out["plain"]
    loss_rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    gnorm_rel = abs(mk["grad_norm"] - mp["grad_norm"]) / abs(mp["grad_norm"])
    leaf_rel = {"/".join(map(str, p)): ((gk[p] - w).abs().max()
                                        / w.abs().max().clamp_min(1e-30)).item()
                for p, w in gp.items()}
    worst = max(leaf_rel, key=leaf_rel.get)
    rec = {"phase": "lm_train_check", "arch": TRAIN_ARCH, "dtype": "float32",
           "layers": cfg.num_layers, "batch": 1, "seq": TRAIN_SEQ, "optimizer": "sgd", "remat": "full",
           "loss": mk["loss"], "plain_loss": mp["loss"], "loss_rel_err": loss_rel,
           "grad_norm": mk["grad_norm"], "plain_grad_norm": mp["grad_norm"],
           "grad_norm_rel_err": gnorm_rel, "max_grad_leaf_rel_err": leaf_rel[worst],
           "worst_leaf": worst, "leaves": len(leaf_rel),
           "rtol": {"loss": TRAIN_LOSS_RTOL, "grad_norm": TRAIN_GNORM_RTOL,
                    "grad_leaf": TRAIN_GRAD_RTOL},
           "step_kernel_s": secs["kernel"], "step_plain_s": secs["plain"],
           "launches": launched, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if (loss_rel > TRAIN_LOSS_RTOL or gnorm_rel > TRAIN_GNORM_RTOL
            or leaf_rel[worst] > TRAIN_GRAD_RTOL):
        fail(f"lm_train_check: kernel path vs plain path beyond bounds: {rec}")
    del state, out, gk, gp
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# -- the mesh layer (phases 19-23) -------------------------------------------


def mesh_train(ks, dev, mesh, lm_rec, attn_recs, ssd_recs):
    """lm_train's run (``launch/train.py::train``: hymba-1.5b at full
    width in bf16, batch 4 x 4,096 in 2 microbatches, adam at lr 1e-3,
    cosine, remat full, its seed) under the card's (1, 1) mesh with
    ``tp_mode="megatron"``: the state and batches DTensors, K4 and K5 on
    the ranks' shards through ``local_map``, ``MESH_TRAIN_STEPS`` steps
    in a profiler trace of the card.  K4 and K5 128 launches a step and
    the trace's equal to the wrappers'; the losses against lm_train's
    (``MESH_LOSS_RTOL``).  Returns (the record, the K4 and K5 shape
    records of this path, the trace)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import train

    cfg = get_config(TRAIN_ARCH)
    per_step = TRAIN_ACCUM * cfg.num_layers * 2
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=1e-3, optimizer="adam",
              grad_accum=TRAIN_ACCUM, full=True, seed=SEED, device=dev, log_every=1,
              log=lambda line: None, tp_mode="megatron", mesh=mesh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        reset_counts(ks)
        t0 = time.perf_counter()
        state, recs = train(TRAIN_ARCH, steps=MESH_TRAIN_STEPS, **kw)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts(ks)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    placements = sorted({str(tuple(type(p).__name__ for p in t.placements))
                         for t in _leaves(state.params)})
    del state
    gc.collect()
    torch.cuda.empty_cache()
    trace = device_trace(prof, recs[-1]["elapsed_s"])
    del prof
    for kind in ("flash_attention", "ssd"):
        if counts[kind] != per_step * MESH_TRAIN_STEPS:
            fail(f"mesh_train: {kind} launched {counts[kind]} times in "
                 f"{MESH_TRAIN_STEPS} steps, want {per_step} a step")
        if trace["kernels"][kind]["launches"] != counts[kind]:
            fail(f"mesh_train: the trace holds {trace['kernels'][kind]['launches']} "
                 f"{kind} launches, the wrapper counted {counts[kind]}")
    if any(counts[k] for k in CONV_KINDS):
        fail(f"mesh_train: a conv kernel ran on the language model's path: {counts}")
    want = lm_rec["losses"][:MESH_TRAIN_STEPS]
    got = [r["loss"] for r in recs]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    if not all(np.isfinite(got)) or any(r > t for r, t in zip(rel, MESH_LOSS_RTOL)):
        fail(f"mesh_train: losses {got} against lm_train's {want} (rel {rel}, "
             f"bounds {MESH_LOSS_RTOL})")
    s_per_step = recs[-1]["elapsed_s"] - recs[-2]["elapsed_s"]
    rec = {"phase": "mesh_train", "arch": TRAIN_ARCH, "mesh": "1x1",
           "tp_mode": "megatron", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "grad_accum": TRAIN_ACCUM, "steps": MESH_TRAIN_STEPS,
           "losses": got, "lm_train_losses": want, "loss_rel_diff": rel,
           "bit_equal": [a == b for a, b in zip(got, want)],
           "loss_rtol": list(MESH_LOSS_RTOL),
           "elapsed_s": [r["elapsed_s"] for r in recs],
           "s_per_step": s_per_step, "lm_train_s_per_step": lm_rec["s_per_step_2_to_4"],
           "mesh_overhead": s_per_step / lm_rec["s_per_step_2_to_4"],
           "peak_memory_gb": peak_gb, "lm_train_peak_memory_gb": lm_rec["peak_memory_gb"],
           "run_s": run_s, "launches": counts, "param_placements": placements,
           "busy_share": trace["busy_share"],
           "k4_ms": trace["kernels"]["flash_attention"]["ms"],
           "k5_ms": trace["kernels"]["ssd"]["ms"],
           "note": "the (1, 1) mesh: every placement Replicate, K4 and K5 on the "
                   "local shards (here the whole tensors) through local_map"}
    per_shape = counts["flash_attention"] // max(1, len(attn_recs))
    path_attn = [dict(r, launches=per_shape, path="mesh_train") for r in attn_recs]
    path_ssd = [dict(r, launches=counts["ssd"] // max(1, len(ssd_recs)), path="mesh_train")
                for r in ssd_recs]
    return rec, (path_attn, path_ssd), trace


def mesh_serve(ks, dev, mesh, lm_rec, arch, lm_batch, prompt, new):
    """lm_serve's run (hymba-1.5b --full, its batch, prompt and 16 greedy
    tokens) through ``ServeEngine(mesh=...)`` on the card's (1, 1) mesh
    (``launch/serve.py::load`` with the mesh, megatron rules): its tokens
    must equal lm_serve's, K4 and K5 once a layer in the prefill, none in
    decode."""
    from repro_torch.launch.serve import load

    engine, inputs = load(arch, full=True, seed=SEED, batch=lm_batch, prompt_len=prompt,
                          device=dev, mesh=mesh, tp_mode="megatron")
    timings = {}
    reset_counts(ks)
    t0 = time.perf_counter()
    tokens = engine.generate(inputs, max_new_tokens=new, timings=timings)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts(ks)
    del engine, inputs
    gc.collect()
    torch.cuda.empty_cache()
    layers = 32
    if counts["flash_attention"] != layers or counts["ssd"] != layers:
        fail(f"mesh_serve: launches {counts}, want K4 and K5 {layers} each (the prefill)")
    if tokens.tolist() != lm_rec["tokens"]:
        fail(f"mesh_serve: tokens {tokens.tolist()} differ from lm_serve's "
             f"{lm_rec['tokens']}")
    steps = timings["decode_steps"]
    return {"phase": "mesh_serve", "arch": arch, "mesh": "1x1", "tp_mode": "megatron",
            "batch": lm_batch, "prompt_len": prompt, "new_tokens": new,
            "tokens_equal_lm_serve": True, "tokens_head": tokens[:2, :8].tolist(),
            "prefill_s": timings["prefill_s"],
            "decode_ms_per_token": timings["decode_s"] / steps * 1e3,
            "lm_serve_prefill_s": lm_rec["prefill_s"],
            "lm_serve_decode_ms_per_token": lm_rec["decode_ms_per_token"],
            "run_s": run_s, "launches": counts}


def mesh_moe(ks, dev, mesh):
    """moonshot-v1-16b-a3b at full width cut to ``MESH_MOE_LAYERS`` layers
    (the MoE's mesh path is per layer; the whole model's 56 GB already
    serves in lm_zoo), lm_zoo's batch and prompt, in bf16: the forward's
    logits through the expert-parallel mesh path (``layers/moe.py``'s
    ``local_map`` body and its all-reduce over ``model``, on the card's
    (1, 1) mesh) against the mesh-less path's, within ``LM_RTOL`` of the
    largest logit."""
    import repro_torch.layers.moe as moe_lib
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.serve import make_batch
    from repro_torch.models.registry import build_model, rules_for_mode
    from repro_torch.sharding.partitioning import (
        distribute_tree,
        mesh_context,
        param_sharding_for_tree,
    )

    arch, zb, zprompt = "moonshot-v1-16b-a3b", 4, 2048
    cfg = get_config(arch).with_(num_layers=MESH_MOE_LAYERS)
    api = build_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    inputs = make_batch(cfg, seed=SEED, batch=zb, prompt_len=zprompt, device=dev)
    mesh_calls = [0]
    orig = moe_lib._apply_moe_mesh

    def counted(*a, **k):
        mesh_calls[0] += 1
        return orig(*a, **k)

    with torch.no_grad():
        reset_counts(ks)
        want = api.forward(params, inputs)[0]
        plain_counts = read_counts(ks)
        rules = rules_for_mode("megatron")
        dparams = distribute_tree(params, mesh, param_sharding_for_tree(
            mesh, api.param_axes(), rules, params))
        batch = make_global_batch({k: v.cpu().numpy() for k, v in inputs.items()}, mesh,
                                  device=dev)
        moe_lib._apply_moe_mesh = counted
        try:
            reset_counts(ks)
            t0 = time.perf_counter()
            with mesh_context(mesh):
                got = api.forward(dparams, batch, rules=rules, mesh=mesh)[0].to_local()
            torch.cuda.synchronize()
            mesh_s = time.perf_counter() - t0
            mesh_counts = read_counts(ks)
        finally:
            moe_lib._apply_moe_mesh = orig
        scale = max(want[i].float().abs().max().item() for i in range(zb))
        err = max((got[i].float() - want[i].float()).abs().max().item() for i in range(zb))
    del params, dparams, want, got, batch, inputs
    gc.collect()
    torch.cuda.empty_cache()
    if mesh_calls[0] != MESH_MOE_LAYERS:
        fail(f"mesh_moe: the MoE mesh path ran {mesh_calls[0]} times, want "
             f"{MESH_MOE_LAYERS}")
    if mesh_counts["flash_attention"] != MESH_MOE_LAYERS:
        fail(f"mesh_moe: K4 launched {mesh_counts} on the mesh path")
    if not err <= LM_RTOL * scale:
        fail(f"mesh_moe: logits max |diff| {err} > {LM_RTOL} x {scale}")
    return {"phase": "mesh_moe", "arch": arch, "layers": MESH_MOE_LAYERS,
            "experts": cfg.moe.num_experts, "top_k": cfg.moe.experts_per_token,
            "dispatch": cfg.moe.dispatch, "mesh": "1x1", "tp_mode": "megatron",
            "batch": zb, "prompt_len": zprompt, "dtype": str(cfg.compute_dtype),
            "max_abs_diff": err, "max_abs_logit": scale, "rtol": LM_RTOL,
            "rel_err": err / scale, "mesh_path_calls": mesh_calls[0],
            "mesh_forward_s": mesh_s, "launches_mesh": mesh_counts,
            "launches_plain": plain_counts}


def mesh_cnn(ks, dev, mesh, ref_losses, ref_params):
    """One step of ``launch/dryrun_cnn.py``'s train step
    (``make_cnn_train_step``: ``cnn_loss`` with ``core/conv_shard.py``'s
    kernel-sharded conv, SGD at lr 0.05) on the card's (1, 1) mesh:
    cifar_cnn_500_1500, batch 32, gather rules, from phase 7's params and
    batch, in a profiler trace.  K1, K2 and K3 each launched through the
    conv's ``local_map`` and the trace's counts equal to the wrappers';
    the loss and params against phase 7's float64 step (1e-5, 1e-4).
    Then the §4.1.1 probe (``core/profiling.py``) on the card.  Returns
    (the record, the shape records of this path, the trace)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.profiling import probe_devices
    from repro_torch.launch.dryrun_cnn import make_cnn_train_step, place_cnn_inputs
    from repro_torch.launch.hetero import train_inputs
    from repro_torch.models.cnn import make_cnn_config
    from repro_torch.models.registry import rules_for_mode

    cfg = make_cnn_config(500, 1500)
    batch, lr = 32, 0.05
    rules = rules_for_mode("gather")
    params, images, labels = train_inputs(cfg, batch, dev)
    dp, di, dl = place_cnn_inputs(params, images, labels, mesh, rules)
    step = make_cnn_train_step(cfg, rules, mesh, lr=lr)
    pad = torch.zeros(1, device=dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a trace that follows a large one can lose its first kernel
        # records (PyTorch 2.11): small kernels first take their place
        for _ in range(TRACE_PAD_KERNELS):
            pad.add_(1)
        torch.cuda.synchronize()
        reset_counts(ks)
        t0 = time.perf_counter()
        new, loss, _ = step(dp, di, dl)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts(ks, CONV_KINDS)
    trace = device_trace(prof, run_s)
    del prof
    for kind, n in counts.items():
        if n == 0:
            fail(f"mesh_cnn: the {kind} kernel was never launched")
        if trace["kernels"][kind]["launches"] != n:
            fail(f"mesh_cnn: the trace holds {trace['kernels'][kind]['launches']} {kind} "
                 f"launches, the wrapper counted {n}")
    local = {l: {n: t.to_local() for n, t in d.items()} for l, d in new.items()}
    loss_err = abs(float(loss.to_local()) - ref_losses[0])
    param_err = params_err(local, ref_params[0])
    if loss_err > LOSS_ATOL or param_err > PARAM_ATOL:
        fail(f"mesh_cnn: vs the float64 step, loss err {loss_err} (atol {LOSS_ATOL}), "
             f"param err {param_err} (atol {PARAM_ATOL})")
    probe = probe_devices(2, slowdowns=[1.0, 2.0])
    shapes_fwd = {(batch, 32, 32, 3, 500, 5): 1, (batch, 16, 16, 500, 1500, 5): 1}
    shapes_dx = {(batch, 16, 16, 500, 1500, 5): 1}
    recs = {"conv2d_fwd": path_shapes(ks, "conv2d_fwd", dev, shapes_fwd,
                                      "main_path_shape", "mesh_cnn"),
            "conv2d_dx": path_shapes(ks, "conv2d_dx", dev, shapes_dx,
                                     "main_path_shape", "mesh_cnn"),
            "conv2d_dw": path_shapes(ks, "conv2d_dw", dev, shapes_fwd,
                                     "main_path_shape", "mesh_cnn")}
    for kind, rs in recs.items():
        if sum(r["launches"] for r in rs) != counts[kind]:
            fail(f"mesh_cnn: {counts[kind]} {kind} launches, the step's shapes say "
                 f"{sum(r['launches'] for r in rs)}")
    rec = {"phase": "mesh_cnn", "net": "cifar_cnn_500_1500", "mesh": "1x1",
           "tp_mode": "gather", "batch": batch, "lr": lr,
           "loss": float(loss.to_local()), "f64_loss": ref_losses[0], "loss_err": loss_err,
           "max_param_err": param_err, "loss_atol": LOSS_ATOL, "param_atol": PARAM_ATOL,
           "run_s": run_s, "launches": counts, "trace": trace,
           "probe_s": probe, "probe_slowdowns": [1.0, 2.0]}
    return rec, recs, trace


def dryrun_records(mesh_train_rec):
    """``launch/dryrun.py`` and ``launch/dryrun_cnn.py`` in subprocesses
    (each needs a process whose default group is its own), all started
    together: (a) tests/test_dryrun.py's pair (mamba2-370m train_4k on
    (16, 16), decode_32k on (2, 16, 16)), hymba-1.5b train_4k in megatron
    and gather, and the CNN at batch 1024 on (16, 16); (b) on the card's
    (1, 1) mesh, mesh_train's exact shape (one microbatch, 2 x 4,096),
    whose roofline bound and peak bytes are set beside mesh_train's
    measured half step and peak memory.  Every subprocess exits 0; the
    pair's per-device footprint under the card's 80 GB.  Returns the
    phase's records."""
    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(__import__("os").environ, PYTHONPATH=str(SRC))
    dry = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    runs = {
        "mamba2 train_4k 16x16": dry + ["--arch", "mamba2-370m", "--shape", "train_4k",
                                        "--mesh", "single"],
        "mamba2 decode_32k 2x16x16": dry + ["--arch", "mamba2-370m", "--shape",
                                            "decode_32k", "--mesh", "multi"],
        "hymba train_4k megatron": dry + ["--arch", TRAIN_ARCH, "--shape", "train_4k",
                                          "--tp-mode", "megatron"],
        "hymba train_4k gather": dry + ["--arch", TRAIN_ARCH, "--shape", "train_4k",
                                        "--tp-mode", "gather"],
        "cnn b1024": [sys.executable, "-m", "repro_torch.launch.dryrun_cnn"],
        "host mesh_train shape": dry + [
            "--arch", TRAIN_ARCH, "--shape", "train_4k", "--mesh", "host",
            "--global-batch", str(TRAIN_BATCH // TRAIN_ACCUM), "--seq-len", str(TRAIN_SEQ)],
    }
    procs = {}
    t0 = time.perf_counter()
    for name, cmd in runs.items():
        path = out_dir / (re.sub(r"\W+", "_", name) + ".jsonl")
        path.unlink(missing_ok=True)
        log = open(out_dir / (re.sub(r"\W+", "_", name) + ".log"), "w")
        procs[name] = (subprocess.Popen(cmd + ["--out", str(path)], env=env, cwd=ROOT,
                                        stdout=log, stderr=subprocess.STDOUT), path, log)
    recs = {}
    for name, (proc, path, log) in procs.items():
        try:
            rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p, _, _ in procs.values():
                p.kill()
            fail(f"dryrun: {name} ran past {DRYRUN_TIMEOUT_S} s")
        log.close()
        if rc != 0 or not path.exists():
            tail = (out_dir / (path.stem + ".log")).read_text()[-3000:]
            fail(f"dryrun: {name} exited {rc}: {tail}")
        recs[name] = [json.loads(line) for line in path.read_text().splitlines()]
    wall_s = time.perf_counter() - t0
    out = []
    for name in ("mamba2 train_4k 16x16", "mamba2 decode_32k 2x16x16"):
        (r,) = recs[name]
        if not (r["flops_per_device"] > 0 and r["hbm_bytes_per_device"] < 80e9):
            fail(f"dryrun: {name}: flops {r['flops_per_device']}, "
                 f"hbm {r['hbm_bytes_per_device']} (want > 0 and < 80 GB)")
    for name, rs in recs.items():
        for r in rs:
            out.append({"phase": "dryrun", "run": name, **{
                k: r.get(k) for k in ("arch_id", "shape", "mesh", "tp_mode", "chips",
                                      "flops_per_device", "bytes_per_device",
                                      "collective_bytes_per_device", "collective_breakdown",
                                      "compute_s", "memory_s", "collective_s", "dominant",
                                      "bound_s", "useful_flops_ratio", "mfu_upper_bound",
                                      "hbm_bytes_per_device", "compile_s", "count_s")}})
    (host,) = recs["host mesh_train shape"]
    half_step = mesh_train_rec["s_per_step"] / TRAIN_ACCUM
    peak = mesh_train_rec["peak_memory_gb"] * 1e9
    out.append({"phase": "dryrun", "run": "roofline vs card",
                "shape": host["shape"], "mesh": host["mesh"], "tp_mode": host["tp_mode"],
                "bound_s": host["bound_s"], "dominant": host["dominant"],
                "compute_s": host["compute_s"], "memory_s": host["memory_s"],
                "collective_s": host["collective_s"],
                "measured_half_step_s": half_step,
                "bound_over_measured": host["bound_s"] / half_step,
                "peak_bytes": host["hbm_bytes_per_device"],
                "max_memory_allocated": peak,
                "peak_over_measured": host["hbm_bytes_per_device"] / peak,
                "note": "half of mesh_train's s/step (2 microbatches a step) against "
                        "the counted step of one microbatch (its optimizer update "
                        "counted whole); peak: mesh_train's max_memory_allocated",
                "wall_s": wall_s})
    return out


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
    from repro_torch.launch.hetero import (
        relu_pool,
        run_hetero,
        run_serve,
        serve_inputs,
        sgd_step,
        train_inputs,
    )
    from repro_torch.models.cnn import cnn_loss, conv_fn_for_backend, make_cnn_config

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # -- 2. build: one nvcc per source, all started together ----------------
    libs = sorted(_build._SIGNATURES)
    with ThreadPoolExecutor(len(libs)) as pool:
        built = dict(zip(libs, pool.map(_build.build, libs)))
    for lib in libs:
        b = built[lib]
        kernels = ptxas_kernels(b.ptxas, _build._nvcc())
        emit({"phase": "build", "kernel": lib, "build_s": b.build_s,
              "cache_hit": b.cache_hit, "library": str(b.path.relative_to(ROOT)),
              "ptxas": kernels})
        for r in kernels:
            if (any(k in r["kernel"] for k in NO_SPILL)
                    and (r.get("spill_stores") or r.get("spill_loads"))):
                fail(f"build: {r['kernel']} spills: {r}")
    ks = Kernels()

    # -- 3. K1 against its plain version ------------------------------------
    sweep = [
        ("sweep", (1, 8, 8, 3, 16, 3)),
        ("sweep", (2, 16, 16, 8, 24, 5)),
        ("sweep", (2, 32, 32, 3, 50, 5)),
        ("sweep", (1, 16, 16, 50, 40, 5)),
        ("sweep", (2, 1, 8, 4, 8, 5)),
        ("sweep", (2, 8, 8, 6, 21, 5)),
    ]
    fwd_cases = sweep[:4] + [
        ("C1", (4, 32, 32, 3, 500, 5)),
        ("C2", (4, 16, 16, 500, 1500, 5)),
        ("ragged Cout 437", (4, 16, 16, 500, 437, 5)),
        ("Cout 363, 4-byte copies", (4, 16, 16, 500, 363, 5)),
        ("Cout 0", (4, 16, 16, 500, 0, 5)),
        ("7-row strip", (4, 7, 16, 500, 1500, 5)),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for label, shape in fwd_cases:
            emit(check_shape(ks, "conv2d_fwd", dev, *shape, dtype, label=label,
                             phase="kernel", copy=dtype == torch.float32))

    # -- 4. K2 and K3 against their plain versions --------------------------
    bwd_cases = sweep + [
        ("C1", (32, 32, 32, 3, 500, 5)),
        ("C2", (32, 16, 16, 500, 1500, 5)),
        ("ragged Cout 437", (8, 16, 16, 500, 437, 5)),
        ("Cout 363, 4-byte copies", (8, 16, 16, 500, 363, 5)),
        ("Cout 0", (8, 16, 16, 500, 0, 5)),
        ("no pixels", (0, 16, 16, 500, 64, 5)),
        ("7-row strip", (8, 7, 16, 500, 1500, 5)),
    ]
    for kind in ("conv2d_dx", "conv2d_dw"):
        for dtype in (torch.float32, torch.bfloat16):
            for label, shape in bwd_cases:
                emit(check_shape(ks, kind, dev, *shape, dtype, label=label,
                                 phase="kernel_bwd"))
    # K2's variants: Cin on both sides of the small-Cin boundary (16), and
    # a small-M, large-K shape whose taps split
    for dtype in (torch.float32, torch.bfloat16):
        for cin in (1, 3, 4, 5, 16, 17, 64, 65):
            emit(check_shape(ks, "conv2d_dx", dev, 8, 32, 32, cin, 167, 5, dtype,
                             label=f"Cin {cin}", phase="kernel_bwd"))
        emit(check_shape(ks, "conv2d_dx", dev, 1, 4, 4, 40, 1500, 5, dtype,
                         label="small M, large K", phase="kernel_bwd"))
    # K2 reruns give the same bits: C1 and C2 at batch 32 and the train
    # run's microbatch shards (split-K; C1's small-Cin variant)
    rng = np.random.default_rng(SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, (b_, h_, w_, cin, cout) in (("C1", (32, 32, 32, 3, 500)),
                                           ("C2", (32, 16, 16, 500, 1500)),
                                           ("C1 microbatch shard", (8, 32, 32, 3, 167)),
                                           ("C2 microbatch shard", (8, 16, 16, 500, 500))):
        gn = torch.from_numpy(rng.standard_normal((b_, h_, w_, cout)).astype(np.float32))
        wn = torch.from_numpy((rng.standard_normal((5, 5, cin, cout)) * 0.1)
                              .astype(np.float32))
        g_, w5 = gn.to(dev), wn.to(dev)
        if not torch.equal(ks.wrapper["conv2d_dx"](g_, w5), ks.wrapper["conv2d_dx"](g_, w5)):
            fail(f"kernel_bwd: two K2 runs on {label} gave different bits")
        emit({"phase": "kernel_bwd", "case": f"K2 rerun on {label}", "bit_identical": True,
              "plan": ks.plan("conv2d_dx", b_, h_, w_, cin, cout, 5, 4, sms)})
    del g_, w5
    # K3 reruns give the same bits: C1 at batch 32 and a training C2 shard
    # (both split the pixel axis)
    for label, (b_, h_, w_, cin, cout) in (("C1", (32, 32, 32, 3, 500)),
                                           ("C2 shard", (8, 16, 16, 500, 459))):
        x_ = torch.from_numpy(rng.standard_normal((b_, h_, w_, cin)).astype(np.float32)).to(dev)
        g_ = torch.from_numpy(rng.standard_normal((b_, h_, w_, cout)).astype(np.float32)).to(dev)
        if not torch.equal(ks.wrapper["conv2d_dw"](x_, g_, 5, 5),
                           ks.wrapper["conv2d_dw"](x_, g_, 5, 5)):
            fail(f"kernel_bwd: two K3 runs on {label} gave different bits")
        emit({"phase": "kernel_bwd", "case": f"K3 rerun on {label}", "bit_identical": True,
              "plan": ks.plan("conv2d_dw", b_, h_, w_, cin, cout, 5, 4, sms)})
    zero = ks.wrapper["conv2d_dw"](x_[:0], g_[:0], 5, 5)
    if tuple(zero.shape) != (5, 5, 500, 459) or bool(zero.any()):
        fail("kernel_bwd: K3 on no pixels is not zeros of the full shape")
    emit({"phase": "kernel_bwd", "case": "K3 on no pixels", "no_pixels_zeros": True})
    del x_, g_

    c1, c2 = 500, 1500
    backends = ["cuda", "cuda", "numpy"]
    cuda_backend = get_backend("cuda")

    # -- 5. serve the headline network through the port ----------------------
    image, requests, max_batch = 32, 16, 4
    with ShapeLog(cuda_backend) as serve_log, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        reset_counts(ks)
        t_run = time.perf_counter()
        rec, outputs = run_serve(
            [1.0, 1.0, 1.0], backends, device="cuda", c1=c1, c2=c2,
            image_size=image, requests=requests, max_batch=max_batch,
            partition="kernel", deadline_s=600.0, seed=SEED,
        )
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        serve_counts = read_counts(ks)
    if not rec["all_ok"]:
        fail(f"serve: statuses {rec['statuses']}")
    if serve_counts["conv2d_fwd"] == 0:
        fail("serve: the conv2d_fwd kernel was never launched on the main path")
    if serve_counts["conv2d_fwd"] != sum(serve_log.fwd.values()):
        fail(f"serve: {serve_counts['conv2d_fwd']} launches for "
             f"{sum(serve_log.fwd.values())} convs on the cuda devices")
    serve_trace = device_trace(prof, run_s)
    if serve_trace["kernels"]["conv2d_fwd"]["launches"] != serve_counts["conv2d_fwd"]:
        fail(f"serve: the trace holds {serve_trace['kernels']['conv2d_fwd']} "
             f"kernel launches, the wrapper counted {serve_counts['conv2d_fwd']}")
    weights, fc, images = serve_inputs(SEED, c1, c2, image, requests)
    n_check = 4
    x = torch.from_numpy(np.stack(images[:n_check])).to(dev, torch.float64)
    for wk in weights:
        y = ks.conv2d_ref(x, torch.from_numpy(wk).to(dev, torch.float64))
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
          "timing_s": rec["timing"], "launches": serve_counts, "run_s": run_s,
          "trace": serve_trace,
          "launches_by_shape": [list(k) + [n] for k, n in sorted(serve_log.fwd.items())],
          "checked_outputs": n_check, "max_abs_err_vs_f64_chain": serve_err,
          "atol": SERVE_ATOL})

    # -- 6. K1 at every shape the serve run gave it ---------------------------
    serve_recs = path_shapes(ks, "conv2d_fwd", dev, serve_log.fwd,
                             "main_path_shape", "serve")

    # -- 7. train the headline network through the port ----------------------
    cfg = make_cnn_config(c1, c2)
    batch, micro, steps, lr = 32, 4, 3, 0.05
    with ShapeLog(cuda_backend) as train_log, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        reset_counts(ks)
        t_run = time.perf_counter()
        trec, trained = run_hetero(
            [1.0, 1.0, 1.0], backends, device="cuda", train_pipeline=True,
            microbatches=micro, c1=c1, c2=c2, batch=batch, steps=steps, lr=lr,
            partition="kernel",
        )
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        train_counts = read_counts(ks)
    train_trace = device_trace(prof, run_s)
    for kind, n in read_counts(ks, CONV_KINDS).items():
        if n == 0:
            fail(f"train: the {kind} kernel was never launched on the main path")
        if train_trace["kernels"][kind]["launches"] != n:
            fail(f"train: the trace holds {train_trace['kernels'][kind]['launches']} "
                 f"{kind} launches, the wrapper counted {n}")
    if train_counts["conv2d_fwd"] != sum(train_log.fwd.values()):
        fail("train: K1 launches differ from the cuda devices' convs")
    for kind in ("conv2d_dx", "conv2d_dw"):
        if train_counts[kind] != sum(train_log.bwd.values()):
            fail(f"train: {kind} launches differ from the cuda devices' backward shards")
    if not np.isfinite(trec["losses"]).all():
        fail(f"train: non-finite losses {trec['losses']}")
    ref_losses, ref_params = float64_steps(cfg, batch, steps, lr, dev)
    loss_errs = [abs(a - b) for a, b in zip(trec["losses"], ref_losses)]
    param_errs = [params_err(a, b) for a, b in zip(trained, ref_params)]
    if loss_errs[0] > LOSS_ATOL or param_errs[0] > PARAM_ATOL:
        fail(f"train: step 1 vs the float64 step, loss err {loss_errs[0]} "
             f"(atol {LOSS_ATOL}), param err {param_errs[0]} (atol {PARAM_ATOL})")
    t = trec["timing"]
    emit({"phase": "train", "net": f"cifar_cnn_{c1}_{c2}", "backends": backends,
          "slowdowns": [1.0, 1.0, 1.0], "partition": "kernel", "batch": batch,
          "microbatches": micro, "steps": steps, "lr": lr,
          "losses": trec["losses"], "f64_losses": ref_losses,
          "loss_err_by_step": loss_errs, "param_err_by_step": param_errs,
          "loss_atol": LOSS_ATOL, "param_atol": PARAM_ATOL,
          "wall_s": trec["wall_s"], "s_per_step": trec["wall_s"] / steps,
          "probe_s": trec["probe_s"], "shares": trec["shares"],
          "kernels_per_device_after": trec["kernels_per_device"],
          "timing_s": {k: t[k] for k in ("conv_s", "gather_wait_s", "master_conv_s")},
          "timing_all_s": t, "comp_duty": trec["comp_duty"],
          "comm_mb": trec["comm_mb"], "launches": train_counts, "run_s": run_s,
          "trace": train_trace,
          "fwd_by_shape": [list(k) + [n] for k, n in sorted(train_log.fwd.items())],
          "bwd_by_shape": [list(k) + [n] for k, n in sorted(train_log.bwd.items())]})

    # -- 8. one autograd step through Conv2dFunction on one device -----------
    params, imgs, labels = train_inputs(cfg, batch, dev)
    before = read_counts(ks, CONV_KINDS)
    conv_fn = conv_fn_for_backend("cuda")
    new, loss, _ = sgd_step(
        params, lambda q: cnn_loss(q, imgs, labels, cfg=cfg, conv_fn=conv_fn), lr)
    torch.cuda.synchronize()
    used = {k: n - before[k] for k, n in read_counts(ks, CONV_KINDS).items()}
    if min(used.values()) == 0:
        fail(f"train_autograd: a kernel was not launched: {used}")
    a_loss_err = abs(loss - ref_losses[0])
    a_param_err = params_err(new, ref_params[0])
    if a_loss_err > LOSS_ATOL or a_param_err > PARAM_ATOL:
        fail(f"train_autograd: vs the float64 step, loss err {a_loss_err}, "
             f"param err {a_param_err}")
    emit({"phase": "train_autograd", "loss": loss, "f64_loss": ref_losses[0],
          "loss_err": a_loss_err, "max_param_err": a_param_err, "launches": used})

    # -- 9. K1, K2, K3 at every shape the train run gave them ----------------
    train_recs = {
        "conv2d_fwd": path_shapes(ks, "conv2d_fwd", dev, train_log.fwd,
                                  "main_path_shape", "train"),
        "conv2d_dx": path_shapes(ks, "conv2d_dx", dev, train_log.bwd,
                                 "main_path_shape", "train"),
        "conv2d_dw": path_shapes(ks, "conv2d_dw", dev, train_log.bwd,
                                 "main_path_shape", "train"),
    }

    # -- 10. K4 against its plain version ------------------------------------
    hymba_attn = (4, 25, 5, 2048, 2048, 64)
    for dtype in (torch.float32, torch.bfloat16):
        for s_, t_, d_ in ((32, 32, 16), (48, 80, 32), (17, 33, 8)):
            for causal in (True, False):
                for window in (None, 16):
                    emit(check_attn(ks, dev, 2, 2, 2, s_, t_, d_, causal, window, dtype,
                                    label="sweep", phase="kernel_attn"))
        emit(check_attn(ks, dev, 2, 6, 2, 40, 70, 64, True, 16, dtype,
                        label="GQA 6/2", phase="kernel_attn"))
        emit(check_attn(ks, dev, *hymba_attn, True, 1024, dtype,
                        label="hymba prefill", phase="kernel_attn"))
    emit(check_attn(ks, dev, 4, 25, 5, 2047, 2047, 64, True, 1024, torch.bfloat16,
                    label="ragged S 2047", phase="kernel_attn"))
    emit(check_attn(ks, dev, 4, 25, 5, 1, 1024, 64, True, 1024, torch.bfloat16,
                    label="S 1 against T 1024", phase="kernel_attn"))
    # the bf16 kernel's scalar-load path: D 20 (not a multiple of 8), and
    # hymba's prefill read through a row stride of 25 * 65 elements
    emit(check_attn(ks, dev, 4, 25, 5, 2048, 2048, 20, True, 1024, torch.bfloat16,
                    label="D 20", phase="kernel_attn"))
    emit(check_attn(ks, dev, *hymba_attn, True, 1024, torch.bfloat16,
                    label="unaligned row stride", phase="kernel_attn", pad=1))
    # the model zoo's shapes: head_dim 128 over GQA 32/8 under llava's
    # 4096 window, whisper's encoder (non-causal S = T = 1500) and its
    # cross-attention (non-causal S < T), and more queries than keys
    # without masks (a prompt longer than the encoder's frames)
    for dtype in (torch.float32, torch.bfloat16):
        for label, shape, causal, window in (
                ("D 128 GQA 32/8 window 4096", (1, 32, 8, 4608, 4608, 128), True, 4096),
                ("non-causal S = T = 1500", (4, 16, 16, 1500, 1500, 64), False, None),
                ("non-causal S < T", (4, 16, 16, 224, 1500, 64), False, None),
                ("non-causal S > T", (4, 16, 16, 1700, 1500, 64), False, None),
                ("non-causal S > T, D 128, ragged", (1, 4, 4, 130, 7, 128), False, None)):
            emit(check_attn(ks, dev, *shape, causal, window, dtype, label=label,
                            phase="kernel_attn"))

    # -- 11. K5 against its plain version ------------------------------------
    for dtype in (torch.float32, torch.bfloat16):
        for s_, h_, p_, n_, chunk in ((32, 2, 8, 4, 8), (48, 3, 16, 8, 16), (25, 1, 4, 4, 8)):
            emit(check_ssd(ks, dev, 2, s_, h_, h_, p_, n_, chunk, dtype,
                           label="sweep", phase="kernel_ssd"))
    for label, s_ in (("hymba prefill", 2048), ("ragged S 2000", 2000),
                      ("S 100, shorter than a chunk", 100)):
        emit(check_ssd(ks, dev, 4, s_, 50, 1, 64, 16, 256, torch.float32,
                       label=label, phase="kernel_ssd"))
    emit(check_ssd(ks, dev, 4, 2048, 50, 1, 64, 16, 256, torch.bfloat16,
                   label="hymba prefill", phase="kernel_ssd"))
    emit(check_ssd(ks, dev, 2, 700, 6, 6, 64, 16, 256, torch.float32,
                   label="G = H, ragged", phase="kernel_ssd"))
    emit(check_ssd(ks, dev, 2, 600, 4, 2, 20, 16, 256, torch.float32,
                   label="P 20", phase="kernel_ssd"))
    # the in-projection's row stride: 16-byte copies, then the 4-byte ones
    for label, width in (("projection rows", 3232), ("projection rows, odd stride", 3233)):
        emit(check_ssd(ks, dev, 4, 2048, 50, 1, 64, 16, 256, torch.float32,
                       label=label, phase="kernel_ssd", width=width))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ssd_args = (torch.randn((4, 2048, 50, 64), generator=gen, device=dev),
                torch.nn.functional.softplus(
                    torch.randn((4, 2048, 50), generator=gen, device=dev)),
                -torch.exp(torch.randn((50,), generator=gen, device=dev) * 0.5),
                torch.randn((4, 2048, 1, 16), generator=gen, device=dev),
                torch.randn((4, 2048, 1, 16), generator=gen, device=dev))
    y1, s1 = ks.wrapper["ssd"](*ssd_args, chunk=256)
    from repro_torch.kernels.ref import ssd_chunked_ref

    y_want, s_want = ssd_chunked_ref(*(t.double() for t in ssd_args), 256)
    atol, rtol = 10 * TOL[torch.float32][0], TOL[torch.float32][1]
    first_err = max((y1.double() - y_want).abs().max().item(),
                    (s1.double() - s_want).abs().max().item())
    if not (torch.allclose(y1.double(), y_want, atol=atol, rtol=rtol)
            and torch.allclose(s1.double(), s_want, atol=atol, rtol=rtol)):
        fail(f"kernel_ssd: K5 at hymba's prefill shape disagrees with its plain version "
             f"(max abs err {first_err})")
    del y_want, s_want
    grids = traced_grids(lambda: ks.wrapper["ssd"](*ssd_args, chunk=256),
                         ("ssd_fwd_kernel", "ssd_out_kernel"))
    for _ in range(SSD_RERUNS):
        y2, s2 = ks.wrapper["ssd"](*ssd_args, chunk=256)
        if not (torch.equal(y1, y2) and torch.equal(s1, s2)):
            fail("kernel_ssd: K5 reruns at hymba's prefill shape gave different bits")
    # chunk-parallel: the tile passes run more blocks at once than the one
    # block per (batch, head) of a scan that walks the chunks in order
    if not all(g[0] > 4 * 50 for g in grids.values()):
        fail(f"kernel_ssd: K5's tile passes launched {grids}, not more than B*H = 200 blocks")
    emit({"phase": "kernel_ssd", "case": "K5 rerun on hymba prefill", "bit_identical": True,
          "reruns": SSD_RERUNS, "max_abs_err": first_err, "grids": grids,
          "blocks_per_head_scan": 4 * 50})
    del ssd_args, y1, y2, s1, s2

    # -- 12. serve hymba-1.5b at full width through the port -----------------
    arch, lm_batch, prompt, new = "hymba-1.5b", 4, 2048, 16
    hymba_layers = 32
    lm_rec, attn_shapes, ssd_shapes, lm_trace = serve_lm(
        ks, dev, arch, lm_batch, prompt, new,
        {"flash_attention": hymba_layers, "ssd": hymba_layers}, "lm_serve")
    emit(lm_rec)

    # -- 13. the kernel path against the plain path, fp32 at full width ------
    emit(lm_check(dev, arch, lm_batch, prompt, new, SEED))
    torch.cuda.empty_cache()

    # -- 14. K4 and K5 at every shape the lm_serve run gave them -------------
    attn_recs = attn_path_shapes(ks, dev, attn_shapes, "lm_serve")
    ssd_recs = ssd_path_shapes(ks, dev, ssd_shapes, "lm_serve")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15. K4 and K5 with their gradients, at the training shapes ---------
    for dtype in (torch.float32, torch.bfloat16):
        emit(check_grad_attn(ks, dev, 2, 25, 5, TRAIN_SEQ, TRAIN_SEQ, 64, True, 1024, dtype))
        emit(check_grad_ssd(ks, dev, 2, TRAIN_SEQ, 50, 1, 64, 16, 256, dtype))

    # -- 16. train hymba-1.5b at full width through the port ----------------
    emit({"phase": "lm_train", "arch": TRAIN_ARCH, "event": "start",
          "allocated_gb_before": torch.cuda.memory_allocated() / 1e9})
    train_rec, (train_attn, train_ssd), train_lm_trace = lm_train(ks, dev)
    emit(train_rec)
    emit(lm_train_check(ks, dev))
    train_attn_recs = attn_path_shapes(ks, dev, train_attn, "lm_train")
    train_ssd_recs = ssd_path_shapes(ks, dev, train_ssd, "lm_train")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 17. train the headline network over two sub-master groups ----------
    from repro_torch.core.cluster.hierarchy import HierarchicalCluster

    hier_backends = ["cuda", "cuda", "numpy", "cuda", "numpy"]
    hier_kw = dict(device="cuda", train_pipeline=True, groups="2x2",
                   group_partition="kernel", microbatches=micro, c1=c1, c2=c2,
                   batch=batch, steps=steps, lr=lr)

    def hier_record(run, hrec, hist, hlog, wall_run_s):
        """The run's record, failing unless every loss is finite, step 1
        equals the float64 step and every sub-master said it masters a
        group of 2."""
        if not np.isfinite(hrec["losses"]).all():
            fail(f"hierarchy {run}: non-finite losses {hrec['losses']}")
        l_errs = [abs(a - b) for a, b in zip(hrec["losses"], ref_losses)]
        p_errs = [params_err(a, b) for a, b in zip(hist, ref_params)]
        if l_errs[0] > LOSS_ATOL or p_errs[0] > PARAM_ATOL:
            fail(f"hierarchy {run}: step 1 vs the float64 step, loss err "
                 f"{l_errs[0]} (atol {LOSS_ATOL}), param err {p_errs[0]} "
                 f"(atol {PARAM_ATOL})")
        metas = [m.get("group") if m else None for m in hlog.hello_meta.values()]
        if len(metas) != 2 or any(not m or m.get("size") != 2 for m in metas):
            fail(f"hierarchy {run}: sub-masters' hello meta {hlog.hello_meta}")
        t = hrec["timing"]
        return {"phase": "hierarchy", "run": run, "net": f"cifar_cnn_{c1}_{c2}",
                "topology": "2x2", "backends": hier_backends,
                "root_partition": hrec["partition"], "group_partition": "kernel",
                "transport": hrec["transport"], "batch": batch,
                "microbatches": micro, "steps": steps, "lr": lr,
                "s_per_step": hrec["wall_s"] / steps, "wall_s": hrec["wall_s"],
                "run_s": wall_run_s, "probe_s": hrec["probe_s"],
                "root_shares": hrec["shares"], "group_shares": hrec["group_shares"],
                "group_meta": metas,
                "timing_s": {k: t[k] for k in ("conv_s", "gather_wait_s",
                                               "master_conv_s")},
                "timing_all_s": t, "comp_duty": hrec["comp_duty"],
                "comm_mb": hrec["comm_mb"], "failures": hrec["failures"],
                "losses": hrec["losses"], "f64_losses": ref_losses,
                "loss_err_by_step": l_errs, "param_err_by_step": p_errs,
                "loss_atol": LOSS_ATOL, "param_atol": PARAM_ATOL,
                "flat_s_per_step": trec["wall_s"] / steps,
                "flat_devices": len(backends), "devices": len(hier_backends),
                "note": "flat_s_per_step is phase train's, context only: "
                        "3 devices there, 5 here"}

    # (a) in process: the sub-masters are threads, every kernel in this
    # process's counters and trace
    k1_records_before = k1_records_in_a_trace(ks, dev)
    with SubMasterLog(HierarchicalCluster) as hlog, ShapeLog(cuda_backend) as hier_log, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        reset_counts(ks)
        t_run = time.perf_counter()
        hrec, hier_trained = run_hetero([1.0] * 5, hier_backends, **hier_kw)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        hier_counts = read_counts(ks)
    hier_trace = device_trace(prof, run_s)
    for kind in CONV_KINDS:
        n = hier_counts[kind]
        if n == 0:
            fail(f"hierarchy inproc: the {kind} kernel was never launched")
        if hier_trace["kernels"][kind]["launches"] != n:
            fail(f"hierarchy inproc: the trace holds "
                 f"{hier_trace['kernels'][kind]['launches']} {kind} launches, "
                 f"the wrapper counted {n}")
    rec_a = hier_record("inproc", hrec, hier_trained, hlog, run_s)
    rec_a.update(k1_records_of_3_in_a_trace={
        "before": k1_records_before, "after": k1_records_in_a_trace(ks, dev)})
    rec_a.update(launches=hier_counts, trace=hier_trace,
                 fwd_by_shape=[list(k) + [n] for k, n in sorted(hier_log.fwd.items())],
                 bwd_by_shape=[list(k) + [n] for k, n in sorted(hier_log.bwd.items())])
    emit(rec_a)

    # (b) over tcp: each sub-master an OS process with its own CUDA
    # context, its group's devices threads in it; its kernels are outside
    # this process's counters and trace, so the run is held on its numbers
    builds_before = build_dir_state()
    with SubMasterLog(HierarchicalCluster) as tlog:
        t_run = time.perf_counter()
        trec_tcp, tcp_trained = run_hetero([1.0] * 5, hier_backends,
                                           transport="tcp", **hier_kw)
        run_s = time.perf_counter() - t_run
    rec_b = hier_record("tcp", trec_tcp, tcp_trained, tlog, run_s)
    subs = tlog.sub_masters()
    if len(subs) != 2:
        fail(f"hierarchy tcp: {len(subs)} sub-master processes, not 2")
    left = [r for r in subs if not r["gone_after_shutdown"]]
    if left:
        fail(f"hierarchy tcp: sub-masters left after shutdown: {left}")
    builds_after = build_dir_state()
    if builds_after != builds_before:
        fail(f"hierarchy tcp: a sub-master rebuilt a kernel library: "
             f"{sorted(set(builds_after.items()) ^ set(builds_before.items()))}")
    m = tlog.mem_mib
    freed = (m["before_shutdown"] - m["after_shutdown"]
             if None not in (m["before_shutdown"], m["after_shutdown"]) else None)
    rec_b.update(sub_masters=subs, device_memory_used_mib=tlog.mem_mib,
                 freed_at_shutdown_mib=freed,
                 freed_per_sub_master_mib=None if freed is None else freed / len(subs),
                 compute_apps_before_shutdown=tlog.apps_before,
                 compute_apps_after_shutdown=tlog.apps_after,
                 kernel_libraries_reloaded_not_rebuilt=True,
                 measured_bandwidth_mbps=trec_tcp["measured_bandwidth_mbps"])
    emit(rec_b)

    # the hierarchy run's shapes, as phase 9 does the flat run's
    hier_recs = {
        "conv2d_fwd": path_shapes(ks, "conv2d_fwd", dev, hier_log.fwd,
                                  "main_path_shape", "hierarchy"),
        "conv2d_dx": path_shapes(ks, "conv2d_dx", dev, hier_log.bwd,
                                 "main_path_shape", "hierarchy"),
        "conv2d_dw": path_shapes(ks, "conv2d_dw", dev, hier_log.bwd,
                                 "main_path_shape", "hierarchy"),
    }
    del hier_trained, tcp_trained, trained, params, imgs, labels
    gc.collect()
    torch.cuda.empty_cache()

    # -- 18. the rest of the model zoo at full width -------------------------
    zoo_runs = {}
    for arch, zb, zprompt, znew, k4, check_layers in ZOO:
        emit({"phase": "lm_zoo", "arch": arch, "event": "start",
              "allocated_gb_before": torch.cuda.memory_allocated() / 1e9})
        rec, z_attn, z_ssd, z_trace = serve_lm(
            ks, dev, arch, zb, zprompt, znew, {"flash_attention": k4, "ssd": 0}, "lm_zoo")
        emit(rec)
        emit(lm_check(dev, arch, zb, zprompt, znew, SEED, layers=check_layers))
        gc.collect()
        torch.cuda.empty_cache()
        zoo_runs[f"lm_zoo {arch}"] = (attn_path_shapes(ks, dev, z_attn, f"lm_zoo {arch}"),
                                      z_trace)
        torch.cuda.empty_cache()

    # -- 19-22. the mesh layer on the card's (1, 1) mesh ---------------------
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh("cuda")
    mt_rec, (mt_attn, mt_ssd), mt_trace = mesh_train(ks, dev, mesh, train_rec,
                                                     train_attn_recs, train_ssd_recs)
    emit(mt_rec)
    emit(mesh_serve(ks, dev, mesh, lm_rec, "hymba-1.5b", lm_batch, prompt, new))
    emit(mesh_moe(ks, dev, mesh))
    mc_rec, mc_recs, mc_trace = mesh_cnn(ks, dev, mesh, ref_losses, ref_params)
    emit(mc_rec)
    torch.distributed.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # -- 23. the dry run at 256 / 512 GPUs and on the card's mesh -----------
    for r in dryrun_records(mt_rec):
        emit(r)

    kernels = [
        entry("conv2d_fwd", "src/repro_torch/kernels/csrc/conv2d_fwd.cu",
              "src/repro/kernels/conv2d.py:78",
              {"serve": (serve_recs, serve_trace),
               "train": (train_recs["conv2d_fwd"], train_trace),
               "hierarchy": (hier_recs["conv2d_fwd"], hier_trace),
               "mesh_cnn": (mc_recs["conv2d_fwd"], mc_trace)}),
        entry("conv2d_dx", "src/repro_torch/kernels/csrc/conv2d_bwd.cu",
              "src/repro/kernels/conv2d.py:94",
              {"train": (train_recs["conv2d_dx"], train_trace),
               "hierarchy": (hier_recs["conv2d_dx"], hier_trace),
               "mesh_cnn": (mc_recs["conv2d_dx"], mc_trace)}),
        entry("conv2d_dw", "src/repro_torch/kernels/csrc/conv2d_bwd.cu",
              "src/repro/kernels/conv2d.py:138",
              {"train": (train_recs["conv2d_dw"], train_trace),
               "hierarchy": (hier_recs["conv2d_dw"], hier_trace),
               "mesh_cnn": (mc_recs["conv2d_dw"], mc_trace)}),
        entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attn_fwd.cu",
              "src/repro/kernels/flash_attn.py:97",
              {"lm_serve": (attn_recs, lm_trace), "lm_train": (train_attn_recs,
                                                               train_lm_trace),
               **zoo_runs, "mesh_train": (mt_attn, mt_trace)}, dtype=torch.bfloat16),
        entry("ssd", "src/repro_torch/kernels/csrc/ssd_fwd.cu",
              "src/repro/kernels/ssd.py:75",
              {"lm_serve": (ssd_recs, lm_trace),
               "lm_train": (train_ssd_recs, train_lm_trace),
               "mesh_train": (mt_ssd, mt_trace)}, dtype=torch.float32),
    ]
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
