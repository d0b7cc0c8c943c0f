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
   microbatches, 2 steps, inside a profiler trace.  Every loss finite;
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
   trace with CPU activity (K4's and K5's traced ms, the busy share).  Every loss,
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
18. wire — the flat cluster's slave processes: phase 7's network and
   backends with device 1 a ``cuda`` slave process (its own CUDA
   context, the kernel libraries loaded from the build directory) and
   device 2 a ``numpy`` one.  Phase 7's training (2 steps) over the shm
   rings, then phase 5's 16 requests over tcp, each through
   ``run_hetero`` / ``run_serve`` with the cluster built as
   ``WireLog``'s ``HeteroCluster`` subclass: its ``_slave_cmd`` runs the
   protocol module under ``SLAVE_WRAPPER``, which writes a ``cuda`` slave's own
   K1-K3 launch counts to a file when it leaves, and its overrides log
   every op scattered to each device.  Step 1 within 1e-5 / 1e-4 of the
   float64 step and the served outputs within ``SERVE_ATOL`` of the
   float64 chain; each ``cuda`` slave launched K1 once per conv shard it
   was sent (beyond its Eq. 1 probe's launches), and K2 and K3 once per
   backward shard; every training step ships each layer's new kernel
   shard to each link once, and ``WeightRef`` tokens after it (serving
   records each kernel shard it ships, with its Cout: a token
   stands only for the same Eq. 1 split); no slave pid and no ring
   segment left after ``shutdown``.  Recorded: s/step and req/s
   beside phases 7's and 5's, each slave's spawn-to-welcome seconds, the
   bytes, kernels and tokens of each step, the arrays each way and those
   above the ring's 64 MiB (sent inline on the control socket),
   ``/dev/shm``'s size, and ``nvidia-smi``'s compute apps as rows and
   MiB (every process shows as pid 1 in the container);
19. recover — the same network and backends over shm with heartbeats
   every 2 s (a 6 s deadline): 4 training steps in one ``run_hetero``.
   The ``cuda`` slave is SIGKILLed at the first gather of step 2, with
   ops in flight; the step finishes on the survivors, its loss and
   params within 1e-5 / 1e-4 of the float64 step 2, the loss detected
   within the heartbeat deadline.  Before step 3 a new ``cuda`` slave
   process is admitted (through the same seam, so its launches are
   counted too), before step 4 it is evicted; Eq. 1's plan (probe
   times, shares, kernels per device) is recorded after each change, and
   no pid or segment is left;
20. codec — the wire codec between the master and phase 18's ``cuda`` and
   ``numpy`` slave processes over shm.  (1) Phase 7's network, batch,
   microbatches and lr for 2 steps under each of ``CODEC_SPECS`` (int8,
   bf16, top-k 0.05 of the gradient slices with error feedback), through
   ``WireLog``, which also records each op's canonical bytes before its
   link encodes it, the encoded message, and each result after its link
   decodes it: the encoded over raw bytes of the same messages held
   under 1/3.5 for int8 (the reference's ratio), at most half the float
   bytes plus the rest for bf16, and for top-k each sparse slice at 8
   bytes a kept entry plus its shape token, the results in fp32; top-k's
   step-1 loss within 1e-5 of float64 (its forward is uncompressed);
   each leaf's update against one float64 step from the same params
   recorded, not held.  (2) tests/test_codec_accuracy.py's own workload
   through a ``cuda`` master and a ``cuda`` slave process over shm,
   probe times pinned: int8's dW within 1e-2 and dx within 5e-2 of the
   fp32 wire at more than 3.5x fewer bytes, top-k's 8-step loss drop
   above 0.7x fp32's at fewer bytes.  Every ``cuda`` slave's launches
   equal its shards, every shape meets the plain version, no pid or
   segment is left;
21. admission — a ``ClusterServer`` over tcp with a ``cuda`` master, a
   ``cuda`` and a ``numpy`` slave process (heartbeats every 2 s),
   serving the headline network with ``run_serve``'s weights: (a) 16
   requests into a queue of 8 before ``start()``: 8 ``rejected``, 8 ok
   within ``SERVE_ATOL`` of the float64 chain; (b) 8 requests with a
   1 ms deadline among 8 live ones: all 8 ``expired`` with no output,
   and the master's and the ``cuda`` slave's convs cover the 8 live
   images a layer, no more; (c) the ``cuda`` slave SIGKILLed from the
   first between stage: every response ok with retries, one failure,
   the detection time; (d) an ``AutoScaler`` on the survivors admits a
   ``cuda`` slave process for a burst of 12 and evicts it when the queue
   drains, its launches equal to its shards.  req/s, p50 and p99 and
   the status counts of each; no pid left;
22. axes — the flat cluster's other partition axes: phase 7's network,
   backends, batch, microbatches and lr, through ``run_hetero`` and
   ``run_serve``.  (a) In process, in one profiler trace: 2 training
   steps and 8 requests under ``spatial`` (height strips with halos)
   and under ``batch`` (sample slices, each member's dW summed); every
   request ok, 4 held against the float64 chain; K1, K2 and K3 each
   launched, each wrapper's count equal to the trace's and to the
   non-empty ``cuda`` shards (and probe launches) that ``ShardLog``
   counted; the strips' image-rows computed (with the halo, padded to
   ``strip_h + kh - 1``) against kept.  (b) Device 1, a ``cuda`` device,
   its probe time times ``AXES_ZERO_SHARE``: Eq. 1 leaves it no strip
   row, then no sample; it is sent only empty shards, and the launches
   still equal the non-empty ``cuda`` shards.  (c) ``auto``, ``kernel``,
   ``spatial`` and ``batch`` on emulated 1000 Mbps links, 2 steps each:
   s/step side by side, and each of ``auto``'s picks (``ResolveLog``:
   layer, op, the predictor's seconds) equal to the axis the predictor
   ranks first; the same decisions resolved again on 25 Mbps links from
   ``resolve_mode`` alone.  (d) ``spatial`` and ``batch`` over shm with
   device 1 a ``cuda`` slave process, 2 steps each: strips and halos
   cross the rings, the slave's launches equal its shards, no pid or
   segment is left.  (e) K1-K3 at every shape (a) gave them, with the
   ``cuda`` backend's copies of a call at each (K1: x, w up and y back;
   K2: x, w, g up and dX, dW back), and each run's copy ms and weight
   MiB sent to the card.  Step 1 of every run within 1e-5 / 1e-4 of
   phase 7's float64 step, each later step of one float64 step from the
   run's own params;
23. lm_zoo — phases 12-14 for each configuration of ``ZOO`` at full
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
24. mesh_train — lm_train's run (``launch/train.py::train``, its config,
   seed and batches) for 2 steps under the card's (1, 1) mesh
   (``launch/mesh.py::make_host_mesh``, an NCCL group of one) with
   ``tp_mode="megatron"``: the state and batches DTensors, K4 and K5 on
   the ranks' shards through ``local_map``, in a profiler trace of the
   card.  K4 and K5 128 launches a step, the trace's equal to the
   wrappers'; the losses against lm_train's (step 1 within 1e-6, step 2
   within lm_train's own rerun bound, 1e-3); s/step and peak memory
   beside lm_train's;
25. mesh_serve — lm_serve's run through ``ServeEngine(mesh=...)`` on
   the same mesh: its 4 x 16 tokens must equal lm_serve's;
26. mesh_moe — moonshot-v1-16b-a3b at full width cut to 2 layers: the
   forward's logits through the MoE's expert-parallel mesh path (its
   ``local_map`` body and all-reduce over ``model``) against the
   mesh-less path's, within ``LM_RTOL`` of the largest logit;
27. mesh_cnn — one step of ``launch/dryrun_cnn.py``'s train step
   (``core/conv_shard.py``'s kernel-sharded conv: K1, K2 and K3 through
   ``local_map``) on the mesh, cifar_cnn_500_1500, batch 32, gather
   rules, held against phase 7's float64 step; K1-K3 at its shapes;
   then the §4.1.1 probe (``core/profiling.py``) on the card;
28. dryrun — ``launch/dryrun.py`` and ``launch/dryrun_cnn.py`` in
   subprocesses started together (each owns its fake process group):
   mamba2-370m train_4k on (16, 16) and decode_32k on (2, 16, 16), both
   under 80 GB a device; hymba-1.5b train_4k in megatron and gather;
   the CNN at batch 1024; and on the card's (1, 1) mesh mesh_train's
   exact shape (one microbatch, 2 x 4,096), whose roofline bound and
   counted peak are printed beside mesh_train's half step and
   ``max_memory_allocated``, with their ratios.  The records are also
   written under the gitignored ``build/chip_smoke_dryrun/``.
29. examples — the port's four examples (``EXAMPLES``), each module's
   ``main`` run in process with ``--device cuda`` at its reference's
   defaults, all in one profiler trace: ``quickstart_torch`` (the CNN
   trained 30 steps locally through ``Conv2dFunction`` and then over
   ``HeteroCluster([1.0, 1.0, 2.0])`` of ``cuda`` devices; the drift of
   the two loss curves under 1e-2 and the loss falling),
   ``hetero_cluster_torch`` (one conv on one device, Eq. 1 and the equal
   split over three ``cuda`` devices, the barrier and pipelined ``sim``
   clusters at 50 Mbps, a ``numpy`` master with ``cuda`` slaves),
   ``serve_batched_torch`` (dense, sliding-window 16 and SSM caches,
   sampled at temperature 0.8) and ``train_lm_torch`` (lm-100m, 300
   adam steps, a checkpoint saved, restored and evaluated; the learned
   assertion).  Each example's own assertions are the run's checks.
   K1-K5 each launched, each wrapper's count equal to the trace's (read
   from the profiler's raw records: ~1.4 M device events) and to the calls
   ``KernelShapes`` saw; one line of each example's numbers; then each
   kernel against its plain version at every shape the examples gave
   it (fp32: K4 at window 16 against S 32, K5 at chunk 16 inside one
   64-step tile).

Every wrapper's launch count is set to 0 just before a main-path run
(serve, train, lm_serve, each lm_train run, the in-process hierarchy,
each lm_zoo run, mesh_train, mesh_serve, mesh_moe, mesh_cnn, the wire,
recover, codec and admission runs, parts (a), (b) and (d) of the axes
phase, and the examples) and read just after; a slave
process starts with its own counts at 0 and writes them when it leaves,
with whether it imported ``ml_dtypes`` (the run fails if any process
did: the bf16 wire stage is numpy only).
Then, on lines of their own: the ``nvidia-smi`` line, the kernels line (``{"kernels": [...]}``) and,
last, ``{"ok": true, "device": ...}``.  Any mismatch or failure raises
and exits non-zero; without a card, or without the rest of the
repository beside this file, it exits non-zero before printing any
result.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import re
import shutil
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
# recover: the slaves beat every 2 s, so the master's deadline is 6 s
# (tests/test_fault_tolerance.py's SIGKILL case)
RECOVER_HEARTBEAT_S = 2.0
# wire and recover: the master and device 1 on the card (device 1 a slave
# process), device 2 a numpy slave process; recover admits one more
# slave of device 1's backend
WIRE_BACKENDS = ["cuda", "cuda", "numpy"]
# codec: the wire codec's stages at full width, 2 training steps each over
# shm (each spawns a cuda slave process: Part 1's time is mostly spawns)
CODEC_SPECS = ("int8", "bf16", "grads=topk:0.05")
CODEC_STEPS = 2
# admission: run_serve's weights and images (16 drawn), and the deadline of
# the requests that must expire before start() (they wait 50 ms)
ADMISSION_IMAGES = 16
ADMISSION_DEADLINE_S = 1e-3
# phase 22 (axes): the steps of each training run, the requests of each
# serving run, part (c)'s emulated links and the thin links whose picks
# are resolved without a run, the factor on device 1's probe time that
# leaves it no strip row and no sample in part (b), and part (c)'s axes
AXES_STEPS = 2
AXES_REQUESTS = 8
AXES_MBPS = 1000.0
AXES_THIN_MBPS = 25.0
AXES_ZERO_SHARE = 1e4
AXES_MODES = ("auto", "kernel", "spatial", "batch")
# phase 29 (examples): the port's four examples, each run as its ``main``
# with --device cuda at its reference's defaults (train_lm's checkpoint
# under the checkout's gitignored build directory), and the last lines of
# each one's output kept in its record
EXAMPLES_DIR = ROOT / "build" / "chip_smoke_examples"
EXAMPLES = (("quickstart_torch", []), ("hetero_cluster_torch", []),
            ("serve_batched_torch", []),
            ("train_lm_torch", ["--ckpt-dir", str(EXAMPLES_DIR / "lm100m")]))
EXAMPLE_TAIL = 12
# the flat cluster's slave processes write their launch counts here (the
# checkout's gitignored build directory)
WIRE_DIR = ROOT / "build" / "chip_smoke_wire"
# a slave process run under this wrapper is the protocol module's slave
# (``protocol.main``).  When it leaves (through ``os._exit``, so no atexit
# hook would run) it writes to the file named first on its command line,
# as JSON, its pid, its exit code and whether ``ml_dtypes`` was imported
# in it; a ``cuda`` slave adds its K1-K3 launch counts and the part of
# them its Eq. 1 probes made.  Each conv and conv_vjp a ``cuda`` slave's
# backend completes appends its shape ``b h w cin cout k`` as one line to
# that name plus ``.shapes``, so a slave that is killed leaves its shapes
# too.  A slave of another backend never imports torch.  Nothing in the
# package changes for it.
SLAVE_WRAPPER = """
import importlib, json, os, sys, threading
out = sys.argv.pop(1)
from repro_torch.core.cluster import protocol
fns = None
if sys.argv[sys.argv.index("--backend") + 1] == "cuda":
    from repro_torch.core import backends
    k = importlib.import_module("repro_torch.kernels.conv2d")
    fns = {"conv2d_fwd": k.conv2d, "conv2d_dx": k.conv2d_dx, "conv2d_dw": k.conv2d_dw}
    probe = dict.fromkeys(fns, 0)
    probe_conv_time = backends.probe_conv_time

    def counted_probe(*a, **kw):
        before = {n: f.launches for n, f in fns.items()}
        try:
            return probe_conv_time(*a, **kw)
        finally:
            for n, f in fns.items():
                probe[n] += f.launches - before[n]

    backends.probe_conv_time = counted_probe
    shapes = open(out + ".shapes", "w", buffering=1)
    lock = threading.Lock()
    cls = backends.CudaBackend

    def logged(way, call):
        def run(self, x, w, *g):
            y = call(self, x, w, *g)
            with lock:
                shapes.write(" ".join(map(str, (way, *x.shape, w.shape[-1], w.shape[0]))) + "\\n")
            return y
        return run

    cls.conv = logged("fwd", cls.conv)
    cls.conv_vjp = logged("bwd", cls.conv_vjp)
exit_ = os._exit

def counted_exit(code):
    rec = {"pid": os.getpid(), "exit_code": code, "ml_dtypes": "ml_dtypes" in sys.modules}
    if fns is not None:
        rec.update(launches={n: f.launches for n, f in fns.items()}, probe_launches=probe)
    with open(out, "w") as f:
        json.dump(rec, f)
    exit_(code)

os._exit = counted_exit
protocol.main()
"""


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


#: seconds since the run began at which each numbered phase of main()
#: (a section's number, or a range of them) began, for the done line
PHASE_START_S = {}
_T0 = time.perf_counter()


def mark(section: str) -> None:
    PHASE_START_S[section] = time.perf_counter() - _T0


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
    ``window_s`` in which any kernel or copy ran (overlaps counted once).
    Read from the profiler's raw records, each distinct name matched
    against ``SYMBOLS`` once: building ``prof.events()``' objects for a
    trace of ~10^6 kernels takes minutes."""
    results = prof.profiler.kineto_results
    cuda = torch.autograd.DeviceType.CUDA
    kind_of = {}  # name -> (kernel kind or None, counts as a launch)
    kernels = {name: {"launches": 0, "ms": 0.0} for name in SYMBOLS}
    spans = []
    for e in results.events():
        if e.device_type() != cuda:
            continue
        name = e.name()
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        spans.append((t0, t1))
        if name not in kind_of:
            kind_of[name] = next(((k, syms[0] in name) for k, syms in SYMBOLS.items()
                                  if any(sym in name for sym in syms)), (None, False))
        kind, launch = kind_of[name]
        if kind is not None:
            kernels[kind]["launches"] += launch
            kernels[kind]["ms"] += (t1 - t0) / 1e6
    spans.sort()
    busy_ns, end = 0, float("-inf")
    for t0, t1 in spans:
        if t1 > end:
            busy_ns += t1 - max(t0, end)
            end = t1
    return {"device_events": len(spans), "kernels": kernels,
            "busy_ms": busy_ns / 1e6, "window_ms": window_s * 1e3,
            "busy_share": busy_ns / 1e9 / window_s}


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
        # the card, y comes back, on every conv call; every conv_vjp call
        # sends x, w and g and brings dX and dW back
        dw_back = torch.empty_like(wt) if kind == "conv2d_dx" else None

        def roundtrip():
            torch.from_numpy(xn).to(dev)
            torch.from_numpy(wn).to(dev)
            if dw_back is not None:
                torch.from_numpy(gn).to(dev)
                dw_back.cpu()
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


def compute_app_rows() -> list:
    """MiB of device memory of each process ``nvidia-smi`` lists as
    holding a context on the card (its pids are not usable: in the
    container every process shows as pid 1)."""
    return [_number(mib) for _, mib in smi_query("--query-compute-apps=pid,used_memory")]


def dev_shm() -> dict:
    """``/dev/shm``: its size and use in MiB, and its entries."""
    du = shutil.disk_usage("/dev/shm")
    return {"total_mib": du.total / 2 ** 20, "used_mib": du.used / 2 ** 20,
            "entries": set(os.listdir("/dev/shm"))}


def _arrays(obj) -> list:
    from repro_torch.core.cluster.codec import map_arrays

    found = []
    map_arrays(obj, found.append)
    return found


def empty_op(op, payload) -> bool:
    """Whether a conv or backward op asks for a shard with no output row
    or channel (a strip or sample slice of 0 rows, a kernel slice of 0
    kernels where the kernel itself is shipped), which launches nothing."""
    if op not in ("conv", "sconv", "bwd", "sbwd"):
        return False
    x, w = payload[0], payload[1]
    g = payload[2] if op in ("bwd", "sbwd") else None
    return x.size == 0 or (g is not None and g.size == 0) or (
        isinstance(w, np.ndarray) and w.shape[-1] == 0)


class WireLog:
    """Watches one ``run_hetero`` or ``run_serve`` call over a process
    transport (tcp or shm) through the cluster's own seams: while it is
    entered, ``launch/hetero.py`` builds a ``HeteroCluster`` subclass
    whose ``_slave_cmd`` runs each slave process under
    ``SLAVE_WRAPPER`` (its K1-K3 launch counts land in ``WIRE_DIR``),
    and whose overrides record each slave's spawn-to-welcome seconds,
    every op scattered to each device with its weight slot (a kernel
    shipped, a ``WeightRef`` token, or the per-op cache's ``None``), the
    arrays each way and those above the shm ring's capacity (which
    ``_shm_pack`` sends inline on the control socket), the bytes,
    kernels and tokens of each training step, and around ``shutdown``
    the card's compute apps, ``/dev/shm`` and whether each slave pid is
    gone.  ``before_step(cluster, i)`` and ``before_gather(cluster,
    step)`` let a run change the membership or inject a fault."""

    def __init__(self, tag: str, ring_bytes=None, before_step=None, before_gather=None):
        self.dir = WIRE_DIR / tag
        shutil.rmtree(self.dir, ignore_errors=True)
        self.dir.mkdir(parents=True)
        self.ring_bytes = ring_bytes  # None: not shm, every array inline
        self.before_step, self.before_gather = before_step, before_gather
        self.spawned, self.welcomed, self.procs, self.backends = {}, {}, {}, {}
        self.ops = collections.defaultdict(collections.Counter)  # device -> op -> n
        self.steps = []
        self.kernel_ships = []  # [device, op, the shard's Cout] per kernel shipped
        self.rings = set()
        self.shutdown_rec = None
        self.topk_faults = []  # top-k slices not of the size the spec gives
        self.membership = []  # [event, device, seconds] of each admit and evict
        self.reset()

    def reset(self):
        """Zero the running tallies (``reset_stats``: after the probe).
        ``ops`` runs on: a slave's own counts cover its whole life."""
        self.tally = collections.Counter()
        if self.ring_bytes is not None:  # shm: count the inline arrays, 0 too
            self.tally.update(inline_to_slave=0, inline_to_master=0)

    def counts_path(self, dev) -> Path:
        return self.dir / f"slave_{dev}.json"

    def sent(self, cluster, sock, msg):
        from repro_torch.core.cluster.codec import WeightRef

        self._raw(msg, "down")
        dev = next(d for d, s in cluster._registry.items() if s is sock)
        op, payload = msg
        self.ops[dev][op] += 1
        if empty_op(op, payload):
            self.ops[dev][f"{op} empty"] += 1
        w = payload[1]
        if isinstance(w, WeightRef):
            w = w.w
            slot = "kernel" if w is not None else "token"
        else:
            slot = "kernel" if w is not None else "cache"
        self.tally[slot] += 1
        if slot == "kernel":
            self.tally["kernel_bytes"] += w.nbytes
            self.kernel_ships.append([dev, op, int(w.shape[-1])])
        self._count(payload, "to_slave")
        if hasattr(sock, "_tx"):  # an shm link: its two ring segments
            self.rings.update((sock._tx.name, sock._rx.name))

    def _raw(self, msg, way):
        """The canonical bytes of a message as the master holds it (an
        op before its link encodes it, a result after it decodes it) and
        the part of them in float arrays."""
        from repro_torch.core.cluster.codec import wire_nbytes

        self.tally[f"raw_{way}"] += wire_nbytes(msg)
        self.tally[f"float_{way}"] += sum(a.nbytes for a in _arrays(msg) if a.dtype.kind == "f")

    def encoded(self, link_codec, msg, out):
        """One master->slave message as its link's codec encoded it:
        its canonical bytes, and for a backward op the gradient slice's
        form (top-k entries kept against the slice's size, or dense)."""
        from repro_torch.core.cluster.codec import SparseGrad, wire_nbytes

        self.tally["enc_down"] += wire_nbytes(out)
        if not (isinstance(msg, tuple) and msg and msg[0] in ("bwd", "sbwd")):
            return
        g, enc = msg[1][2], out[1][2]
        if isinstance(enc, SparseGrad):
            self.tally["grad_sparse_slices"] += 1
            self.tally["grad_sparse_elems"] += g.size
            self.tally["grad_kept"] += enc.idx.size
            self.tally["grad_sparse_bytes"] += wire_nbytes(enc)
            frac = link_codec.grad_topk
            want_kept = max(1, int(round(frac * g.size)))
            if enc.idx.size != want_kept or wire_nbytes(enc) != 8 * want_kept + 8:
                self.topk_faults.append([list(g.shape), int(enc.idx.size), want_kept,
                                         wire_nbytes(enc)])
        else:
            self.tally["grad_dense_slices"] += 1
            self.tally["grad_dense_elems"] += g.size
            self.tally["grad_dense_bytes"] += wire_nbytes(enc)

    def _count(self, obj, way):
        for a in _arrays(obj):
            self.tally[f"arrays_{way}"] += 1
            if self.ring_bytes is not None and (a.nbytes == 0 or a.nbytes > self.ring_bytes):
                self.tally[f"inline_{way}"] += 1

    def step_begin(self, cluster):
        if self.before_step is not None:
            self.before_step(cluster, len(self.steps))
        self._mark = (dict(self.tally), cluster.comm_bytes, time.perf_counter())

    def step_end(self, cluster):
        tally, comm, t0 = self._mark
        rec = {k: n - tally.get(k, 0) for k, n in self.tally.items()}
        rec.update(comm_bytes=cluster.comm_bytes - comm,
                   comm_mib=(cluster.comm_bytes - comm) / 2 ** 20,
                   s=time.perf_counter() - t0, slave_ids=list(cluster.slave_ids))
        self.steps.append(rec)

    def before_shutdown(self, cluster):
        self.shutdown_rec = {"apps_mib_before": compute_app_rows(),
                             "memory_used_mib_before": memory_used_mib(),
                             "dev_shm_before": dev_shm()}

    def after_shutdown(self, cluster):
        r = self.shutdown_rec
        shm = dev_shm()
        r.update(apps_mib_after=compute_app_rows(), memory_used_mib_after=memory_used_mib())
        if None not in (r["memory_used_mib_before"], r["memory_used_mib_after"]):
            r["freed_mib"] = r["memory_used_mib_before"] - r["memory_used_mib_after"]
        r.update(
                 rings=sorted(self.rings), rings_left=sorted(self.rings & shm["entries"]),
                 dev_shm_after=shm)
        for key in ("dev_shm_before", "dev_shm_after"):
            r[key] = {k: v for k, v in r[key].items() if k != "entries"}

    def subclass(self, base):
        log = self

        class Observed(base):
            def _slave_cmd(self, dev, slowdown, backend):
                cmd = super()._slave_cmd(dev, slowdown, backend)
                at = cmd.index("-m")
                return [cmd[0], "-c", SLAVE_WRAPPER, str(log.counts_path(dev))] + cmd[at + 2:]

            def _spawn_slave_proc(self, dev, slowdown, backend, env):
                log.spawned[dev] = time.perf_counter()
                log.backends[dev] = backend
                log.procs[dev] = super()._spawn_slave_proc(dev, slowdown, backend, env)
                return log.procs[dev]

            def _accept_slave(self, timeout_s):
                chan, dev, meta = super()._accept_slave(timeout_s)
                log.welcomed[dev] = time.perf_counter()
                write = chan.write_to_slave

                def probed(msg):
                    # a training plan's layer probes write past _write_op
                    if isinstance(msg, tuple) and msg[0] == "probe":
                        log._raw(msg, "down")
                    return write(msg)

                chan.write_to_slave = probed
                return chan, dev, meta

            def _write_op(self, sock, msg):
                if not sock.lost:
                    log.sent(self, sock, msg)
                super()._write_op(sock, msg)

            def _check_result(self, out):
                log._count(out, "to_master")
                log._raw(out, "up")
                return super()._check_result(out)

            def _link_codec(self):
                link_codec = super()._link_codec()
                encode_down = link_codec.encode_down

                def observed(msg):
                    out = encode_down(msg)
                    log.encoded(link_codec, msg, out)
                    return out

                link_codec.encode_down = observed
                return link_codec

            def admit(self, *a, **kw):
                t0 = time.perf_counter()
                dev = super().admit(*a, **kw)
                log.membership.append(["admit", dev, time.perf_counter() - t0])
                return dev

            def evict(self, device):
                t0 = time.perf_counter()
                super().evict(device)
                log.membership.append(["evict", device, time.perf_counter() - t0])

            def reset_stats(self):
                super().reset_stats()
                log.reset()

            def conv_train_step(self, *a, **kw):
                log.step_begin(self)
                out = super().conv_train_step(*a, **kw)
                log.step_end(self)
                return out

            def gather_conv(self, p):
                if log.before_gather is not None:
                    log.before_gather(self, len(log.steps))
                return super().gather_conv(p)

            def shutdown(self):
                first = not self._shut
                if first:
                    log.before_shutdown(self)
                super().shutdown()
                if first:
                    log.after_shutdown(self)

        return Observed

    def __enter__(self):
        import repro_torch.launch.hetero as hetero

        self._hetero, self._base = hetero, hetero.HeteroCluster
        self._shm_before = dev_shm()["entries"]
        hetero.HeteroCluster = self.subclass(self._base)
        return self

    def __exit__(self, *exc):
        self._hetero.HeteroCluster = self._base

    def slaves(self) -> list:
        """One record per spawned slave process: its backend, pid,
        spawn-to-welcome seconds, the ops it was sent, its own launch
        counts (None if it was killed), the shapes its backend's convs
        and conv_vjps completed (a killed slave's too), and whether it is
        gone."""
        out = []
        for dev, p in sorted(self.procs.items()):
            path = self.counts_path(dev)
            counts = json.loads(path.read_text()) if path.exists() else None
            shapes = {"fwd": collections.Counter(), "bwd": collections.Counter()}
            shapes_path = Path(f"{path}.shapes")
            if shapes_path.exists():
                for ln in shapes_path.read_text().splitlines():
                    way, *dims = ln.split()
                    shapes[way][tuple(map(int, dims))] += 1
            out.append({"device": dev, "backend": self.backends[dev], "pid": p.pid,
                        "spawn_to_welcome_s": (self.welcomed[dev] - self.spawned[dev]
                                               if dev in self.welcomed else None),
                        "ops_sent": dict(self.ops[dev]), "returncode": p.poll(),
                        "gone": p.poll() is not None and not Path(f"/proc/{p.pid}").exists(),
                        "counts": counts,
                        **{f"{way}_by_shape": [list(k) + [n] for k, n in sorted(c.items())]
                           for way, c in shapes.items()}})
        return out

    def new_shm_entries(self) -> list:
        return sorted(dev_shm()["entries"] - self._shm_before)


def nonempty(shapes) -> int:
    """The launches a ``(b, h, w, cin, cout, k)`` counter stands for: a
    conv with an empty operand launches nothing."""
    return sum(n for shape, n in shapes.items() if math.prod(shape) > 0)


def run_shapes(phase, master_log, master_counts, slaves) -> tuple:
    """The K1 and K2/K3 shapes of one run over slave processes, the
    master's (``master_log``, a ``ShapeLog`` of its ``cuda`` backend)
    and every ``cuda`` slave's, merged.  Fails where a process's shapes
    do not add up to its own launch counts (a killed slave has none:
    its shapes are taken as they are).  Returns (fwd, bwd) counters."""
    fwd, bwd = collections.Counter(master_log.fwd), collections.Counter(master_log.bwd)
    who = [("the master", master_log.fwd, master_log.bwd, master_counts)]
    for r in slaves:
        if r["backend"] != "cuda":
            continue
        sf = collections.Counter({tuple(k[:-1]): k[-1] for k in r["fwd_by_shape"]})
        sb = collections.Counter({tuple(k[:-1]): k[-1] for k in r["bwd_by_shape"]})
        fwd.update(sf)
        bwd.update(sb)
        if r["counts"] is not None:
            who.append((f"cuda slave {r['device']}", sf, sb, r["counts"]["launches"]))
    for name, f, b, n in who:
        got = {"conv2d_fwd": nonempty(f), "conv2d_dx": nonempty(b), "conv2d_dw": nonempty(b)}
        if got != {k: n[k] for k in got}:
            fail(f"{phase}: {name}'s conv shapes stand for {got} launches, "
                 f"it counted {n}")
    return fwd, bwd


def check_slave_launches(phase, slaves, training) -> dict:
    """Each ``cuda`` slave process that left on its own launched K1 once
    per non-empty conv shard it was sent beyond its probes' launches, and
    K2 and K3 once per non-empty backward shard (none when serving);
    fails otherwise.  Returns its shard launches by kernel name, summed
    over the slaves."""
    total = collections.Counter()
    for r in slaves:
        if r["backend"] != "cuda":
            continue
        if r["counts"] is None:  # killed: it wrote nothing
            if r["returncode"] == 0:
                fail(f"{phase}: cuda slave {r['device']} left without its counts")
            continue
        shard = {k: n - r["counts"]["probe_launches"][k]
                 for k, n in r["counts"]["launches"].items()}
        ops = collections.Counter(r["ops_sent"])
        want = {"conv2d_fwd": sum(ops[op] - ops[f"{op} empty"] for op in ("conv", "sconv"))}
        bwd = sum(ops[op] - ops[f"{op} empty"] for op in ("bwd", "sbwd"))
        want["conv2d_dx"] = want["conv2d_dw"] = bwd
        if shard != want or want["conv2d_fwd"] == 0 or (training and bwd == 0):
            fail(f"{phase}: cuda slave {r['device']} launched {shard} beyond its "
                 f"probes for the shards it was sent, {want}")
        r["shard_launches"] = shard
        total.update(shard)
    return dict(total)


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


def path_shapes(ks, kind, dev, shapes, phase, path, copy=False):
    """The kernel against its plain version at every shape a main-path
    run gave it (K1 and K3 run twice: the same bits); each record carries
    its launch count, and with ``copy`` the cuda backend's copies of a
    call at that shape (K1: its conv's, K2: its conv_vjp's)."""
    recs = []
    for shape, n in sorted(shapes.items()):
        r = check_shape(ks, kind, dev, *shape, torch.float32,
                        label=f"{path} x{n}", phase=phase,
                        copy=copy and kind != "conv2d_dw",
                        rerun=kind in ("conv2d_fwd", "conv2d_dw"))
        r.update(launches=n, path=path)
        emit(r)
        recs.append(r)
    return recs


def float64_steps(cfg, batch, steps, lr, dev, start=None):
    """``steps`` single-device SGD steps in float64 on the card from the
    train run's params (or ``start``) and batch: ``cnn_loss`` with the
    plain conv, autograd.  Returns (losses, params after each step)."""
    from repro_torch.launch.hetero import sgd_step, train_inputs
    from repro_torch.models.cnn import cnn_loss

    params, images, labels = train_inputs(cfg, batch, dev)
    if start is not None:
        params = start
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


def bound_of(groups) -> tuple:
    """(bound ms, bound_by) of the work of ``groups``, pairs of (shape
    records, their input dtype): each group's operations over its
    dtype's peak, all bytes over the memory rate, the larger."""
    t_ops = sum(total(rs, "flops") / PEAK_FLOPS[dt] for rs, dt in groups)
    t_mem = sum(total(rs, "bytes") for rs, _ in groups) / PEAK_BYTES_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def path_totals(rs, dtype) -> dict:
    return {"plain_ms": total(rs, "plain_ms"), "library_ms": library_total(rs),
            "bound_ms": bound_of([(rs, dtype)])[0]}


def entry(kind, source, replaces, runs, dtype=torch.float32, untraced=None,
          path_dtypes=None):
    """One kernels-line entry over the main-path runs that launched
    it: ``runs`` maps a path to (its shape records, its trace); the
    bound takes the peak rate of the runs' input ``dtype``, or of a
    path's own in ``path_dtypes``.
    ``untraced`` maps a path that ran partly in slave processes, outside
    this process's counters and profiler, to its shape records: its
    ``by_path`` entry counts the launches of its master and slaves from
    their shapes, has no trace time, and stays out of the totals above
    it but for ``max_abs_err``."""
    recs = [r for rs, _ in runs.values() for r in rs]
    untraced = untraced or {}
    path_dtypes = path_dtypes or {}

    def dtype_of(path):
        return path_dtypes.get(path, dtype)

    bound_ms, bound_by = bound_of([(rs, dtype_of(path)) for path, (rs, _) in runs.items()])
    return {
        "name": kind, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(tr["kernels"][kind]["launches"] for _, tr in runs.values()),
        "max_abs_err": max(r["max_abs_err"]
                           for r in recs + [r for rs in untraced.values() for r in rs]),
        "ms": sum(tr["kernels"][kind]["ms"] for _, tr in runs.values()),
        "plain_ms": total(recs, "plain_ms"),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_total(recs),
        "isolated_ms": total(recs, "ms"),
        "by_path": {**{path: {"launches": tr["kernels"][kind]["launches"],
                              "ms": tr["kernels"][kind]["ms"],
                              **path_totals(rs, dtype_of(path))}
                       for path, (rs, tr) in runs.items()},
                    **{path: {"launches": sum(r["launches"] for r in rs), "ms": None,
                              "traced": False, "max_abs_err": max(
                                  (r["max_abs_err"] for r in rs), default=0.0),
                              **path_totals(rs, dtype)}
                       for path, rs in untraced.items()}},
        "per": "all launches of the traced main-path runs in by_path; ms: "
               "the profiler trace of those runs; plain_ms, library_ms, "
               "isolated_ms: each shape's isolated median times its "
               "launch count, summed; by_path entries with traced false "
               "(the master and its slave processes) count launches from "
               "the shapes each process ran, each shape checked against "
               "the plain version, and are not in the totals but for "
               "max_abs_err",
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


def lm_train(ks, dev):
    """The port's ``launch/train.py`` (``train``) on hymba-1.5b at full
    width (``full=True``: the published config in bf16, remat full):
    ``TRAIN_STEPS`` steps of adam at lr 1e-3 (cosine) on batch
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` in ``TRAIN_ACCUM`` microbatches,
    untraced (losses, s/step, tokens/s, peak memory); then
    ``TRAIN_TRACED_STEPS`` steps from the same seed inside a profiler
    trace with CPU activity (K4's and K5's traced time, the busy
    share).  Every loss, aux and grad_norm finite; each
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
                      "busy_ms_per_step": trace["busy_ms"] / n,
                      "device_events_per_step": trace["device_events"] / n}}
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


# -- the mesh layer (phases 24-27) -------------------------------------------


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


def serve_f64_err(ks, dev, outputs, c1, c2, image, requests, n_check=4) -> float:
    """Max abs difference of the first ``n_check`` served outputs from a
    single-device float64 chain on the card (the plain conv, ReLU and
    pool, the fc head) over the same weights and requests; fails on a
    wrong shape or a non-finite output."""
    from repro_torch.launch.hetero import relu_pool, serve_inputs

    weights, fc, images = serve_inputs(SEED, c1, c2, image, requests)
    x = torch.from_numpy(np.stack(images[:n_check])).to(dev, torch.float64)
    for wk in weights:
        y = ks.conv2d_ref(x, torch.from_numpy(wk).to(dev, torch.float64))
        x = torch.from_numpy(relu_pool(y.cpu().numpy())).to(dev)
    want = (x.reshape(n_check, -1) @ torch.from_numpy(fc).to(dev, torch.float64)).cpu().numpy()
    got = np.stack(outputs[:n_check])
    if got.shape != (n_check, 10) or not np.isfinite(got).all():
        fail(f"served outputs of shape {got.shape} or non-finite")
    return float(np.abs(got - want).max())


def step_errs(phase, losses, history, ref_losses, ref_params, held) -> tuple:
    """Each step's loss and param errors against the float64 steps;
    fails unless the first ``held`` steps are within LOSS_ATOL and
    PARAM_ATOL."""
    l_errs = [abs(a - b) for a, b in zip(losses, ref_losses)]
    p_errs = [params_err(a, b) for a, b in zip(history, ref_params)]
    for i in range(held):
        if l_errs[i] > LOSS_ATOL or p_errs[i] > PARAM_ATOL:
            fail(f"{phase}: step {i + 1} vs the float64 step, loss err {l_errs[i]} "
                 f"(atol {LOSS_ATOL}), param err {p_errs[i]} (atol {PARAM_ATOL})")
    return l_errs, p_errs


def local_step_errs(phase, cfg, batch, lr, dev, losses, history, first=None) -> tuple:
    """Each step of a run against one float64 step taken from the run's
    own params before it (the initial params for step 1), so no step
    inherits an earlier step's error; fails unless every step is within
    LOSS_ATOL and PARAM_ATOL.  ``first``, the float64 step's (loss,
    params) from the initial params (phase 7's), spares recomputing it.
    Returns (loss errs, param errs)."""
    l_errs, p_errs = [], []
    for i, (loss, got) in enumerate(zip(losses, history)):
        if i == 0 and first is not None:
            want_loss, want = first
        else:
            (want_loss,), (want,) = float64_steps(cfg, batch, 1, lr, dev,
                                                  start=history[i - 1] if i else None)
        l_errs.append(abs(loss - want_loss))
        p_errs.append(params_err(got, want))
        if l_errs[-1] > LOSS_ATOL or p_errs[-1] > PARAM_ATOL:
            fail(f"{phase}: step {i + 1} vs one float64 step from the run's own "
                 f"params, loss err {l_errs[-1]} (atol {LOSS_ATOL}), param err "
                 f"{p_errs[-1]} (atol {PARAM_ATOL})")
    return l_errs, p_errs


def worst_leaves(history, ref_params) -> list:
    """Each step's param leaf furthest from the float64 step's."""
    return [max(((f"{l}.{n}", (got[l][n].double() - want[l][n]).abs().max().item())
                 for l in want for n in want[l]), key=lambda t: t[1])
            for got, want in zip(history, ref_params)]


def check_left(phase, log, slaves):
    """Fails if a slave pid or one of the cluster's ring segments
    outlived ``shutdown``, or if a slave imported ``ml_dtypes``.  What
    else appeared in ``/dev/shm`` meanwhile (another program's segment,
    say) is recorded, not held."""
    imported = [r["device"] for r in slaves if r["counts"] and r["counts"]["ml_dtypes"]]
    if imported:
        fail(f"{phase}: slave devices {imported} imported ml_dtypes")
    left = [r["pid"] for r in slaves if not r["gone"]]
    if left:
        fail(f"{phase}: slave pids left after shutdown: {left}")
    if log.shutdown_rec["rings_left"]:
        fail(f"{phase}: ring segments left in /dev/shm after shutdown: "
             f"{log.shutdown_rec['rings_left']}")
    log.shutdown_rec["other_new_dev_shm_entries"] = sorted(
        set(log.new_shm_entries()) - set(log.rings))


def wire_phase(ks, dev, cfg, c1, c2, train_kw, serve_kw, ref_losses, ref_params,
               train_rec, serve_rec) -> tuple:
    """Phase 18: the flat cluster's ``cuda`` and ``numpy`` slave
    processes, training over shm and serving over tcp.  Returns (its two
    JSON records, the cuda slaves' shard launches by run, K1-K3 against
    their plain versions at every shape the two runs gave them in the
    master and the slaves)."""
    from repro_torch.core.backends import get_backend
    from repro_torch.core.cluster.transport import ShmTransport
    from repro_torch.launch.hetero import run_hetero, run_serve

    backends = WIRE_BACKENDS
    recs, launches = [], {}
    builds_before = build_dir_state()
    with WireLog("train", ring_bytes=ShmTransport.DEFAULT_RING_BYTES) as log, \
            ShapeLog(get_backend("cuda")) as master_log:
        reset_counts(ks)
        t_run = time.perf_counter()
        rec, hist = run_hetero([1.0, 1.0, 1.0], backends, transport="shm", **train_kw)
        run_s = time.perf_counter() - t_run
        master_counts = read_counts(ks, CONV_KINDS)
    if not np.isfinite(rec["losses"]).all():
        fail(f"wire train: non-finite losses {rec['losses']}")
    # held: each step against one float64 step from the run's own params;
    # recorded: each step against the float64 run from the start
    local_l, local_p = local_step_errs("wire train", cfg, train_kw["batch"], train_kw["lr"],
                                       dev, rec["losses"], hist)
    l_errs, p_errs = step_errs("wire train", rec["losses"], hist, ref_losses, ref_params, 1)
    slaves = log.slaves()
    launches["wire_train"] = check_slave_launches("wire train", slaves, training=True)
    fwd, bwd = run_shapes("wire train", master_log, master_counts, slaves)
    check_left("wire train", log, slaves)
    n_links = len(backends) - 1
    for i, st in enumerate(log.steps):
        # each step's SGD update makes new kernels: a new cache version, so
        # each layer's shard crosses each link once, and every other op of
        # the step carries its token
        if st.get("kernel", 0) != 2 * n_links or st.get("token", 0) == 0:
            fail(f"wire train: step {i + 1} shipped {st.get('kernel', 0)} kernel shards "
                 f"(want {2 * n_links}) and {st.get('token', 0)} WeightRef tokens")
    recs.append({
        "phase": "wire", "run": "train", "net": f"cifar_cnn_{c1}_{c2}", "backends": backends,
        "transport": "shm", "ring_mib": ShmTransport.DEFAULT_RING_BYTES / 2 ** 20,
        **{k: train_kw[k] for k in ("batch", "microbatches", "steps", "lr", "partition")},
        "losses": rec["losses"], "local_loss_err_by_step": local_l,
        "local_param_err_by_step": local_p, "loss_err_by_step": l_errs,
        "param_err_by_step": p_errs, "worst_param_leaf_by_step": worst_leaves(hist, ref_params),
        "loss_atol": LOSS_ATOL, "param_atol": PARAM_ATOL,
        "held": "every step against one float64 step from the run's own params "
                "(local_*); *_err_by_step: against the float64 run from the start",
        "s_per_step": rec["wall_s"] / train_kw["steps"], "wall_s": rec["wall_s"],
        "run_s": run_s, "inproc_s_per_step": train_rec["s_per_step"],
        "probe_s": rec["probe_s"], "shares": rec["shares"],
        "kernels_per_device_after": rec["kernels_per_device"],
        "measured_bandwidth_mbps": rec["measured_bandwidth_mbps"],
        "comm_mib": rec["comm_mb"], "timing_s": rec["timing"],
        "wire": dict(log.tally), "steps_wire": log.steps, "kernel_ships": log.kernel_ships,
        "master_launches": master_counts,
        "master_fwd_by_shape": [list(k) + [n] for k, n in sorted(master_log.fwd.items())],
        "master_bwd_by_shape": [list(k) + [n] for k, n in sorted(master_log.bwd.items())],
        "slaves": slaves, "slave_shard_launches": launches["wire_train"],
        "shutdown": log.shutdown_rec,
        "kernel_libraries_reloaded_not_rebuilt": build_dir_state() == builds_before})
    if not recs[-1]["kernel_libraries_reloaded_not_rebuilt"]:
        fail("wire train: a slave process rebuilt a kernel library")
    emit(recs[-1])

    with WireLog("serve") as log, ShapeLog(get_backend("cuda")) as master_log:
        reset_counts(ks)
        t_run = time.perf_counter()
        rec, outputs = run_serve([1.0, 1.0, 1.0], backends, transport="tcp", **serve_kw)
        run_s = time.perf_counter() - t_run
        master_counts = read_counts(ks, CONV_KINDS)
    if not rec["all_ok"]:
        fail(f"wire serve: statuses {rec['statuses']}")
    err = serve_f64_err(ks, dev, outputs, c1, c2, serve_kw["image_size"], serve_kw["requests"])
    if err > SERVE_ATOL:
        fail(f"wire serve: max abs err {err} vs the float64 chain > {SERVE_ATOL}")
    slaves = log.slaves()
    launches["wire_serve"] = check_slave_launches("wire serve", slaves, training=False)
    serve_fwd, serve_bwd = run_shapes("wire serve", master_log, master_counts, slaves)
    if serve_bwd:
        fail(f"wire serve: backward shards while serving: {dict(serve_bwd)}")
    fwd.update(serve_fwd)
    check_left("wire serve", log, slaves)
    recs.append({
        "phase": "wire", "run": "serve", "net": f"cifar_cnn_{c1}_{c2}", "backends": backends,
        "transport": "tcp", "requests": serve_kw["requests"],
        "max_batch": serve_kw["max_batch"], "statuses": rec["statuses"],
        "throughput_rps": rec["throughput_rps"], "p50_ms": rec["p50_ms"],
        "p99_ms": rec["p99_ms"], "wall_s": rec["wall_s"], "run_s": run_s,
        "inproc_throughput_rps": serve_rec["throughput_rps"],
        "inproc_p50_ms": serve_rec["p50_ms"], "probe_s": rec["probe_s"],
        "shares": rec["shares"], "kernels_per_device_after": rec["kernels_per_device"],
        "max_abs_err_vs_f64_chain": err, "atol": SERVE_ATOL,
        "comm_mib": rec["comm_mb"], "wire": dict(log.tally),
        # the serving weights are static, but a token only stands for the
        # shard of the same Eq. 1 counts: each kernel shipped, with the
        # shard's Cout, shows whether the split moved between slabs
        "kernel_ships": log.kernel_ships,
        "master_launches": master_counts,
        "master_fwd_by_shape": [list(k) + [n] for k, n in sorted(master_log.fwd.items())],
        "slaves": slaves,
        "slave_shard_launches": launches["wire_serve"], "shutdown": log.shutdown_rec})
    emit(recs[-1])
    shape_recs = conv_path_shapes(ks, dev, fwd, bwd, "wire")
    return recs, launches, shape_recs


def conv_path_shapes(ks, dev, fwd, bwd, path, copy=False) -> dict:
    """K1 at every forward shape and K2 and K3 at every backward shape
    of a path, each against its plain version (``path_shapes``)."""
    return {"conv2d_fwd": path_shapes(ks, "conv2d_fwd", dev, fwd, "main_path_shape", path,
                                      copy),
            "conv2d_dx": path_shapes(ks, "conv2d_dx", dev, bwd, "main_path_shape", path, copy),
            "conv2d_dw": path_shapes(ks, "conv2d_dw", dev, bwd, "main_path_shape", path)}


def plan_record(cluster, c1, c2, event) -> dict:
    from repro_torch.core.partitioner import workload_shares

    return {"event": event, "slave_ids": list(cluster.slave_ids),
            "backends": list(cluster.backends),
            "probe_s": [float(t) for t in cluster.probe_times],
            "shares": [float(x) for x in workload_shares(cluster.probe_times)],
            "kernels_per_device": {"c1": cluster.shares_for(c1).tolist(),
                                   "c2": cluster.shares_for(c2).tolist()}}


def recover_phase(ks, dev, cfg, c1, c2, train_kw) -> tuple:
    """Phase 19: SIGKILL the ``cuda`` slave process mid-step 2 over shm,
    then admit a new ``cuda`` slave before step 3 and evict it before
    step 4.  Returns (its JSON record, the cuda slaves' shard launches,
    K1-K3 against their plain versions at every shape the run gave them
    in the master and the slaves)."""
    from repro_torch.core.backends import get_backend
    from repro_torch.core.cluster.transport import ShmTransport
    from repro_torch.launch.hetero import run_hetero

    backends = WIRE_BACKENDS
    steps = 4
    kw = dict(train_kw, steps=steps)
    ref_losses, ref_params = float64_steps(cfg, kw["batch"], steps, kw["lr"], dev)
    plans, events = [], {}

    def before_gather(cluster, step):
        if step == 1 and not events:
            pos = cluster.backends.index(backends[1], 1) - 1
            events.update(device=cluster.slave_ids[pos], proc=cluster.procs[pos],
                          plan_before=plan_record(cluster, c1, c2, "before the kill"))
            events["t"] = time.monotonic()
            events["proc"].kill()

    def before_step(cluster, step):
        if step == 2:
            plans.append(plan_record(cluster, c1, c2, "after the kill"))
            t0 = time.perf_counter()
            events["admitted"] = cluster.admit(slowdown=1.0, backend=backends[1])
            events["admit_s"] = time.perf_counter() - t0
            plans.append(plan_record(cluster, c1, c2, "after the admit"))
        elif step == 3:
            t0 = time.perf_counter()
            cluster.evict(events["admitted"])
            events["evict_s"] = time.perf_counter() - t0
            plans.append(plan_record(cluster, c1, c2, "after the evict"))

    with WireLog("recover", ring_bytes=ShmTransport.DEFAULT_RING_BYTES,
                 before_step=before_step, before_gather=before_gather) as log, \
            ShapeLog(get_backend("cuda")) as master_log:
        reset_counts(ks)
        t_run = time.perf_counter()
        rec, hist = run_hetero([1.0, 1.0, 1.0], backends, transport="shm",
                               heartbeat_s=RECOVER_HEARTBEAT_S, **kw)
        run_s = time.perf_counter() - t_run
        master_counts = read_counts(ks, CONV_KINDS)
    if not np.isfinite(rec["losses"]).all():
        fail(f"recover: non-finite losses {rec['losses']}")
    # held: each step against one float64 step from the run's own params
    # (step 2 the survivors finished, step 3 the admitted slave's);
    # recorded: each step against the float64 run from the start
    local_l, local_p = local_step_errs("recover", cfg, kw["batch"], kw["lr"], dev,
                                       rec["losses"], hist)
    l_errs, p_errs = step_errs("recover", rec["losses"], hist, ref_losses, ref_params, 0)
    failures = rec["failures"]
    if len(failures) != 1 or failures[0]["device"] != events["device"]:
        fail(f"recover: failures {failures}, the killed slave was device {events['device']}")
    detect_s = failures[0]["t_detected"] - events["t"]
    timeout_s = 3.0 * RECOVER_HEARTBEAT_S
    if not 0.0 <= detect_s < timeout_s:
        fail(f"recover: the kill was detected after {detect_s} s, not within {timeout_s}")
    if rec["timing"]["recompute_s"] <= 0.0:
        fail("recover: the master recomputed none of the lost shards")
    slaves = log.slaves()
    admitted = next((r for r in slaves if r["device"] == events["admitted"]), None)
    if admitted is None or admitted["backend"] != backends[1] or admitted["counts"] is None:
        fail(f"recover: the admitted cuda slave did not run and leave: {admitted}")
    if log.steps[2]["slave_ids"] != plans[1]["slave_ids"] or \
            log.steps[3]["slave_ids"] != plans[2]["slave_ids"]:
        fail(f"recover: steps 3 and 4 ran on {[s['slave_ids'] for s in log.steps]}")
    launches = check_slave_launches("recover", slaves, training=True)
    fwd, bwd = run_shapes("recover", master_log, master_counts, slaves)
    check_left("recover", log, slaves)
    out = {
        "phase": "recover", "net": f"cifar_cnn_{c1}_{c2}", "backends": backends,
        "transport": "shm", "heartbeat_s": RECOVER_HEARTBEAT_S,
        "heartbeat_timeout_s": timeout_s, "steps": steps,
        **{k: kw[k] for k in ("batch", "microbatches", "lr", "partition")},
        "victim_device": events["device"], "victim_pid": events["proc"].pid,
        "victim_returncode": events["proc"].returncode, "detect_s": detect_s,
        "failure": {k: v for k, v in failures[0].items() if k != "t_detected"},
        "recompute_s": rec["timing"]["recompute_s"],
        "admitted_device": events["admitted"], "admit_s": events["admit_s"],
        "evict_s": events["evict_s"],
        "plans": [events["plan_before"]] + plans,
        "losses": rec["losses"], "f64_losses": ref_losses,
        "local_loss_err_by_step": local_l, "local_param_err_by_step": local_p,
        "loss_err_by_step": l_errs, "param_err_by_step": p_errs,
        "worst_param_leaf_by_step": worst_leaves(hist, ref_params),
        "loss_atol": LOSS_ATOL, "param_atol": PARAM_ATOL,
        "held": "every step against one float64 step from the run's own params "
                "(local_*); *_err_by_step: against the float64 run from the start",
        "step_s": [st["s"] for st in log.steps], "wall_s": rec["wall_s"], "run_s": run_s,
        "wire": dict(log.tally), "steps_wire": log.steps,
        "master_launches": master_counts,
        "master_fwd_by_shape": [list(k) + [n] for k, n in sorted(master_log.fwd.items())],
        "master_bwd_by_shape": [list(k) + [n] for k, n in sorted(master_log.bwd.items())],
        "slaves": slaves, "slave_shard_launches": launches, "shutdown": log.shutdown_rec}
    emit(out)
    return out, launches, conv_path_shapes(ks, dev, fwd, bwd, "recover")


def update_errs(cfg, batch, lr, dev, history) -> list:
    """Each step's update (params after it less params before it)
    against one float64 step's from the same params, per leaf, as
    norm-relative errors: ``[{leaf: err}, ...]`` by step."""
    from repro_torch.launch.hetero import train_inputs

    start = train_inputs(cfg, batch, dev)[0]
    out = []
    for i, got in enumerate(history):
        before = start if i == 0 else history[i - 1]
        (_,), (want,) = float64_steps(cfg, batch, 1, lr, dev, start=before)
        errs = {}
        for l in want:
            for n in want[l]:
                b = before[l][n].double()
                du, dw = got[l][n].double() - b, want[l][n] - b
                errs[f"{l}.{n}"] = ((du - dw).norm() / dw.norm().clamp_min(1e-30)).item()
        out.append(errs)
    return out


def wire_bytes(steps) -> dict:
    """A run's bytes summed over its steps: the canonical bytes the
    links counted (``comm``, encoded), the same messages as the master
    held them (``raw``: each op before its link encoded it, each result
    after its link decoded it), their float-array part, and the
    gradient slices' forms."""
    tot = collections.Counter()
    for st in steps:
        tot.update({k: v for k, v in st.items() if isinstance(v, int)})
    raw = tot["raw_down"] + tot["raw_up"]
    return {"comm": tot["comm_bytes"], "raw": raw,
            "float": tot["float_down"] + tot["float_up"],
            "enc_down": tot["enc_down"], "enc_up": tot["comm_bytes"] - tot["enc_down"],
            "raw_down": tot["raw_down"], "raw_up": tot["raw_up"],
            "ratio": tot["comm_bytes"] / raw,
            **{k: tot[k] for k in ("grad_sparse_slices", "grad_sparse_elems", "grad_kept",
                                   "grad_sparse_bytes", "grad_dense_slices",
                                   "grad_dense_elems", "grad_dense_bytes")}}


def check_codec_bytes(spec, b, faults) -> dict:
    """Holds one codec run's encoded-to-raw ratio of the same messages
    (``wire_bytes``) to what the spec ships; returns the bound held."""
    if spec == "int8":
        bound = 1 / 3.5  # the reference's: bytes32 / bytes8 > 3.5
        ok = b["ratio"] < bound
    elif spec == "bf16":
        # float arrays at 2 of their 4 bytes; every 8-byte scalar token
        # and any other array crosses whole
        bound = (b["raw"] - b["float"] / 2) / b["raw"]
        ok = b["comm"] <= b["raw"] - b["float"] // 2
    else:
        # top-k: each sparse slice at most 8 B a kept entry (an int32
        # index and an fp32 value) plus its shape token, so 0.4 B an
        # element plus 12 B; a slice too small to pay ships dense; the
        # (dX, dW) results come back in fp32 (the grads stage is fp32)
        frac = float(spec.split(":")[1])
        sparse_bound = 8 * frac * b["grad_sparse_elems"] + 12 * b["grad_sparse_slices"]
        bound = {"sparse_bytes": sparse_bound, "up": b["raw_up"]}
        ok = (b["grad_sparse_bytes"] <= sparse_bound and not faults
              and b["grad_dense_bytes"] == 4 * b["grad_dense_elems"]
              and b["grad_sparse_slices"] > 0 and b["enc_up"] == b["raw_up"]
              and b["ratio"] < 1.0)
    if not ok:
        fail(f"codec {spec}: the bytes of the same messages {b} (top-k slices not "
             f"of their size: {faults}) against {bound}")
    return bound


def codec_phase(ks, dev, cfg, c1, c2, train_kw) -> tuple:
    """Phase 20: the wire codec between the master and a ``cuda`` and a
    ``numpy`` slave process over shm.  Part 1: ``CODEC_SPECS`` at full
    width, 2 training steps each, the encoded-to-raw bytes of the same
    messages held to what each spec ships; part 2: the reference codec
    accuracy test's own workload through a ``cuda`` slave process, held
    at its bounds.  Returns (its JSON records, the cuda slaves' shard
    launches by run, K1-K3 against their plain versions at every shape
    the master and the slaves ran)."""
    from repro_torch.core.backends import get_backend
    from repro_torch.core.cluster.transport import ShmTransport
    from repro_torch.launch.hetero import run_hetero

    backends = WIRE_BACKENDS
    kw = dict(train_kw, steps=CODEC_STEPS)
    recs, launches = [], {}
    fwd, bwd = collections.Counter(), collections.Counter()
    (f64_loss,), _ = float64_steps(cfg, kw["batch"], 1, kw["lr"], dev)
    for spec in CODEC_SPECS:
        with WireLog(f"codec_{spec.replace('=', '_').replace(':', '_')}",
                     ring_bytes=ShmTransport.DEFAULT_RING_BYTES) as log, \
                ShapeLog(get_backend("cuda")) as master_log:
            reset_counts(ks)
            t_run = time.perf_counter()
            rec, hist = run_hetero([1.0, 1.0, 1.0], backends, transport="shm",
                                   wire_codec=spec, **kw)
            run_s = time.perf_counter() - t_run
            master_counts = read_counts(ks, CONV_KINDS)
        if not np.isfinite(rec["losses"]).all():
            fail(f"codec {spec}: non-finite losses {rec['losses']}")
        loss_err = abs(rec["losses"][0] - f64_loss)
        if spec.startswith("grads=topk") and loss_err > LOSS_ATOL:
            # the forward crosses the wire uncompressed: the loss is exact
            fail(f"codec {spec}: step-1 loss err {loss_err} vs float64 > {LOSS_ATOL}")
        b = wire_bytes(log.steps)
        bound = check_codec_bytes(spec, b, log.topk_faults)
        slaves = log.slaves()
        launches[spec] = check_slave_launches(f"codec {spec}", slaves, training=True)
        f, bw = run_shapes(f"codec {spec}", master_log, master_counts, slaves)
        fwd.update(f)
        bwd.update(bw)
        check_left(f"codec {spec}", log, slaves)
        recs.append({
            "phase": "codec", "run": spec, "net": f"cifar_cnn_{c1}_{c2}",
            "backends": backends, "transport": "shm",
            **{k: kw[k] for k in ("batch", "microbatches", "steps", "lr", "partition")},
            "losses": rec["losses"], "f64_step1_loss": f64_loss, "step1_loss_err": loss_err,
            "loss_atol_held": spec.startswith("grads=topk"),
            "update_rel_err_by_step": update_errs(cfg, kw["batch"], kw["lr"], dev, hist),
            "held": "bytes of the same messages; top-k: the step-1 loss; "
                    "update errors recorded, not held",
            "bytes": b, "bytes_bound": bound, "s_per_step": rec["wall_s"] / kw["steps"],
            "run_s": run_s, "probe_s": rec["probe_s"], "shares": rec["shares"],
            "kernels_per_device_after": rec["kernels_per_device"],
            "steps_wire": log.steps, "master_launches": master_counts,
            "slaves": slaves, "slave_shard_launches": launches[spec],
            "shutdown": log.shutdown_rec})
        emit(recs[-1])

    # part 2: tests/test_codec_accuracy.py's workload, a cuda master and a
    # cuda slave process over shm, probe times pinned as the test pins them
    rec, acc_launches, f, bw = codec_accuracy(ks, dev)
    launches.update(acc_launches)
    fwd.update(f)
    bwd.update(bw)
    recs.append(rec)
    emit(rec)
    return recs, launches, conv_path_shapes(ks, dev, fwd, bwd, "codec")


def _relu_between():
    def between(y):
        mask = (y > 0).astype(np.float32)
        return np.maximum(y, 0.0), lambda gz: gz * mask

    return between


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def codec_accuracy(ks, dev) -> tuple:
    """The codec accuracy test's two cases on the card: uniform(-1, 1)
    images (8, 32, 32, 3), kernels (3, 3, 3, 8) and (3, 3, 8, 12) at a 0.3
    scale; one train chain under 0.5 ||y||^2 over the fp32 wire and over
    int8 (dW within 1e-2, dx within 5e-2, bytes more than 3.5x fewer),
    then 8 SGD steps at lr 2 on 0.5 mean(y^2) over fp32 and over
    top-k 0.05 (a loss drop above 0.7x fp32's, fewer bytes).  One fp32
    cluster is both baselines.  Returns (its record, the cuda slaves'
    shard launches, the fwd and bwd shapes of every process)."""
    from repro_torch.core.backends import get_backend
    from repro_torch.core.cluster.cluster import HeteroCluster
    from repro_torch.core.cluster.transport import ShmTransport

    def data(seed):
        rng = np.random.default_rng(seed)
        x = rng.uniform(-1.0, 1.0, size=(8, 32, 32, 3)).astype(np.float32)
        w1 = (0.3 * rng.uniform(-1.0, 1.0, size=(3, 3, 3, 8))).astype(np.float32)
        w2 = (0.3 * rng.uniform(-1.0, 1.0, size=(3, 3, 8, 12))).astype(np.float32)
        return x, w1, w2

    def train_step(c, x, w1, w2):
        c.reset_stats()
        res = c.conv_train_chain(x, [w1, w2], [_relu_between(), None],
                                 lambda z, i: (None, z))
        return res, c.comm_bytes

    def sgd_losses(c, x, w1, w2, steps=8, lr=2.0):
        losses, total_bytes = [], 0
        for _ in range(steps):
            ys = []

            def head(z, i):
                z = np.asarray(z, np.float32)
                ys.append(z)
                return None, z / z.size

            c.reset_stats()
            res = c.conv_train_chain(x, [w1, w2], [_relu_between(), None], head)
            total_bytes += c.comm_bytes
            y = np.concatenate(ys, axis=0)
            losses.append(0.5 * float(np.mean(y * y)))
            w1 = w1 - lr * res.dw[0]
            w2 = w2 - lr * res.dw[1]
        return losses, total_bytes

    specs = {"fp32": None, "int8": "int8", "topk": "grads=topk:0.05"}
    logs = {name: WireLog(f"codec_accuracy_{name}", ring_bytes=ShmTransport.DEFAULT_RING_BYTES)
            for name in specs}
    with contextlib.ExitStack() as stack, ShapeLog(get_backend("cuda")) as master_log:
        for log in logs.values():
            stack.enter_context(log)
        reset_counts(ks)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(specs)) as pool:  # the three spawns overlap
            made = {name: pool.submit(logs[name].subclass(HeteroCluster), [1.0, 1.0],
                                      WIRE_BACKENDS[:2], transport="shm", wire_codec=spec)
                    for name, spec in specs.items()}
            clusters = {name: fut.result() for name, fut in made.items()}
        up_s = time.perf_counter() - t0
        try:
            for c in clusters.values():
                c.probe_times = [1.0, 1.0]
            x, w1, w2 = data(0)
            (ref, bytes32), (got, bytes8) = (train_step(clusters[n], x, w1, w2)
                                             for n in ("fp32", "int8"))
            x, w1, w2 = data(1)
            (ref_losses, ref_bytes), (tk_losses, tk_bytes) = (
                sgd_losses(clusters[n], x, w1, w2) for n in ("fp32", "topk"))
        finally:
            for c in clusters.values():
                c.shutdown()
        master_counts = read_counts(ks, CONV_KINDS)
    errs = {"dw0": _rel(got.dw[0], ref.dw[0]), "dw1": _rel(got.dw[1], ref.dw[1]),
            "dx": _rel(got.dx, ref.dx)}
    ref_drop, tk_drop = ref_losses[0] - ref_losses[-1], tk_losses[0] - tk_losses[-1]
    if not (errs["dw0"] <= 1e-2 and errs["dw1"] <= 1e-2 and errs["dx"] <= 5e-2
            and bytes32 / bytes8 > 3.5):
        fail(f"codec accuracy: int8 rel errs {errs} (dW <= 1e-2, dx <= 5e-2), "
             f"bytes fp32/int8 {bytes32 / bytes8} (> 3.5)")
    if not (ref_losses[-1] < ref_losses[0] and tk_losses[-1] < tk_losses[0]
            and tk_drop > 0.7 * ref_drop and tk_bytes < ref_bytes):
        fail(f"codec accuracy: top-k losses {tk_losses} against fp32 {ref_losses} "
             f"(drop > 0.7x fp32's), bytes {tk_bytes} against {ref_bytes}")
    slaves = [r for log in logs.values() for r in log.slaves()]
    launches = check_slave_launches("codec accuracy", slaves, training=True)
    fwd, bwd = run_shapes("codec accuracy", master_log, master_counts, slaves)
    for name, log in logs.items():
        check_left(f"codec accuracy {name}", log, [r for r in log.slaves()])
    rec = {"phase": "codec", "run": "accuracy", "workload": "tests/test_codec_accuracy.py",
           "backends": WIRE_BACKENDS[:2], "transport": "shm", "probe_times": [1.0, 1.0],
           "int8_rel_err": errs, "bytes_fp32": bytes32, "bytes_int8": bytes8,
           "bytes_ratio": bytes32 / bytes8,
           "bounds": {"dw": 1e-2, "dx": 5e-2, "bytes_ratio": 3.5, "topk_drop": 0.7},
           "fp32_losses": ref_losses, "topk_losses": tk_losses,
           "topk_drop_over_fp32": tk_drop / ref_drop, "fp32_bytes_8_steps": ref_bytes,
           "topk_bytes_8_steps": tk_bytes, "clusters_up_s": up_s,
           "master_launches": master_counts, "slaves": slaves,
           "slave_shard_launches": launches,
           "shutdown": {name: log.shutdown_rec for name, log in logs.items()}}
    return rec, {"accuracy": launches}, fwd, bwd


def admission_phase(ks, dev, c1, c2, image, max_batch) -> tuple:
    """Phase 21: ``ClusterServer``'s admission, deadlines, SlaveLost and
    ``AutoScaler`` over tcp, with a ``cuda`` master, a ``cuda`` and a
    ``numpy`` slave process, serving the headline network with
    ``run_serve``'s weights.  Returns (its JSON record, the cuda slaves'
    shard launches, K1 against its plain version at every shape the
    master and the slaves ran)."""
    import repro_torch.launch.hetero as hetero
    from repro_torch.core.backends import get_backend
    from repro_torch.launch.hetero import relu_pool, serve_inputs
    from repro_torch.serve.server import AutoScaler, ClusterServer

    weights, fc, images = serve_inputs(SEED, c1, c2, image, ADMISSION_IMAGES)

    def head(z):
        return z.reshape(z.shape[0], -1) @ fc

    def burst(cluster, xs, *, deadline_s=None, start_after=0.0, **server_kw):
        """Submits ``xs`` (each with ``deadline_s``, or None) before the
        server starts, then starts it and waits for every response."""
        server = ClusterServer(cluster, weights, head=head, max_batch=max_batch,
                               **{"between": [relu_pool, relu_pool], **server_kw})
        futs = [server.submit(x, deadline_s=d) for x, d in zip(xs, deadline_s or [None] * len(xs))]
        time.sleep(start_after)
        t0 = time.perf_counter()
        with server:
            resps = [f.result(timeout=600.0) for f in futs]
        wall = time.perf_counter() - t0
        st = server.stats()
        statuses = [r.status for r in resps]
        n_ok = statuses.count("ok")
        return resps, {"requests": len(xs), "statuses": dict(collections.Counter(statuses)),
                       "wall_s": wall, "ok_per_s": n_ok / wall, "p50_ms": st["p50_ms"],
                       "p99_ms": st["p99_ms"], "stats": st,
                       "retries": sum(r.retries for r in resps)}

    def f64_err(resps, label):
        """Max abs error of ``resps`` (for ``images[:len(resps)]``, in
        order) against the float64 chain; fails above ``SERVE_ATOL``."""
        err = serve_f64_err(ks, dev, [r.output for r in resps], c1, c2, image,
                            ADMISSION_IMAGES, n_check=len(resps))
        if err > SERVE_ATOL:
            fail(f"admission {label}: max abs err {err} vs the float64 chain > {SERVE_ATOL}")
        return err

    def slave_fwd(log):
        """The cuda slave processes' forward shapes so far, by device."""
        return {r["device"]: collections.Counter({tuple(k[:-1]): k[-1] for k in r["fwd_by_shape"]})
                for r in log.slaves() if r["backend"] == "cuda"}

    out = {"phase": "admission", "net": f"cifar_cnn_{c1}_{c2}", "backends": WIRE_BACKENDS,
           "transport": "tcp", "max_batch": max_batch, "heartbeat_s": RECOVER_HEARTBEAT_S}
    with WireLog("admission") as log, ShapeLog(get_backend("cuda")) as master_log:
        reset_counts(ks)
        t0 = time.perf_counter()
        cluster = hetero.HeteroCluster([1.0, 1.0, 1.0], WIRE_BACKENDS, transport="tcp",
                                       pipeline=True, microbatches=4, partition="kernel",
                                       heartbeat_s=RECOVER_HEARTBEAT_S)
        try:
            probe = cluster.probe(image_size=image, in_channels=3, kernel_size=5,
                                  num_kernels=max(8, c1), batch=max_batch)
            out.update(up_s=time.perf_counter() - t0, probe_s=[float(t) for t in probe],
                       kernels_per_device={"c1": cluster.shares_for(c1).tolist(),
                                           "c2": cluster.shares_for(c2).tolist()})

            # (a) rejection: a burst of 16 into a queue of 8, before start()
            resps, rec = burst(cluster, images[:16], max_queue=8)
            rejected = [i for i, r in enumerate(resps) if r.status == "rejected"]
            if rejected != list(range(8, 16)) or rec["stats"]["rejected"] != 8 or \
                    rec["statuses"].get("ok") != 8:
                fail(f"admission rejection: statuses {rec['statuses']}, rejected {rejected}, "
                     f"stats {rec['stats']}")
            if any("queue full" not in resps[i].detail for i in rejected):
                fail("admission rejection: a rejection without 'queue full'")
            rec["max_abs_err_vs_f64_chain"] = f64_err(resps[:8], "rejection")
            out["rejection"] = rec

            # (b) deadlines: 1 ms deadlines queued before start(), among live
            # requests; the expired ones are never computed
            m_before, s_before = collections.Counter(master_log.fwd), slave_fwd(log)
            launches_before = read_counts(ks, ("conv2d_fwd",))["conv2d_fwd"]
            xs = [images[i // 2] if i % 2 == 0 else images[8 + i // 2] for i in range(16)]
            dl = [None if i % 2 == 0 else ADMISSION_DEADLINE_S for i in range(16)]
            resps, rec = burst(cluster, xs, deadline_s=dl, start_after=0.05)
            live = [r for r, d in zip(resps, dl) if d is None]
            dead = [r for r, d in zip(resps, dl) if d is not None]
            if any(r.status != "expired" or r.output is not None for r in dead) or \
                    any(r.status != "ok" for r in live):
                fail(f"admission deadlines: statuses {[r.status for r in resps]}")
            m_fwd = master_log.fwd - m_before
            s_fwd = {d: c - s_before.get(d, collections.Counter())
                     for d, c in slave_fwd(log).items()}
            served = {"master": m_fwd, **{f"cuda slave {d}": c for d, c in s_fwd.items()}}
            images_by_layer = {who: {cin: sum(k[0] * n for k, n in c.items() if k[3] == cin)
                                     for cin in (3, c1)} for who, c in served.items()}
            n_launched = read_counts(ks, ("conv2d_fwd",))["conv2d_fwd"] - launches_before
            if n_launched != nonempty(m_fwd) or \
                    any(n not in (0, len(live)) for v in images_by_layer.values()
                        for n in v.values()) or \
                    set(images_by_layer["master"].values()) != {len(live)}:
                fail(f"admission deadlines: the images each process convolved by layer "
                     f"{images_by_layer} (want {len(live)} live requests), master K1 "
                     f"launches {n_launched} for {nonempty(m_fwd)} shards")
            rec.update(expired=len(dead), live=len(live), deadline_s=ADMISSION_DEADLINE_S,
                       images_by_layer={w: {str(k): n for k, n in v.items()}
                                        for w, v in images_by_layer.items()},
                       master_k1_launches=n_launched,
                       max_abs_err_vs_f64_chain=f64_err(live, "deadlines"))
            out["deadlines"] = rec

            # (c) SlaveLost: SIGKILL the cuda slave from the first between
            # stage of the first slab
            pos = cluster.backends.index(WIRE_BACKENDS[1], 1) - 1
            victim, victim_dev = cluster.procs[pos], cluster.slave_ids[pos]
            killed = {}

            def kill_then_pool(y):
                if not killed:
                    killed["t"] = time.monotonic()
                    victim.kill()
                return relu_pool(y)

            resps, rec = burst(cluster, images[:8], between=[kill_then_pool, relu_pool])
            failures = list(cluster.failures)
            if rec["statuses"] != {"ok": 8} or rec["retries"] < 1 or len(failures) != 1 or \
                    failures[0]["device"] != victim_dev:
                fail(f"admission slave_lost: statuses {rec['statuses']}, retries "
                     f"{rec['retries']}, failures {failures}")
            rec.update(victim_device=victim_dev, victim_returncode=victim.wait(timeout=30),
                       detect_s=failures[0]["t_detected"] - killed["t"],
                       failure={k: v for k, v in failures[0].items() if k != "t_detected"},
                       max_abs_err_vs_f64_chain=f64_err(resps, "slave_lost"))
            out["slave_lost"] = rec

            # (d) AutoScaler on the survivors: a burst of 12 admits a cuda
            # slave process, the drained queue evicts it
            scaler = AutoScaler(cluster, scale_up_depth=6, scale_down_depth=0, min_slaves=1,
                                max_slaves=2, cooldown_s=0.0,
                                admit_kwargs={"backend": WIRE_BACKENDS[1]})
            resps, rec = burst(cluster, images[:12], max_queue=16, autoscaler=scaler)
            deadline = time.monotonic() + 60.0
            while cluster.n_slaves > 1 and time.monotonic() < deadline:
                time.sleep(0.01)  # idle loop iterations evict to min
            actions = [e[1] for e in scaler.events]
            if rec["statuses"] != {"ok": 12} or actions != ["admit", "evict"] or \
                    cluster.n_slaves != 1:
                fail(f"admission autoscaler: statuses {rec['statuses']}, events "
                     f"{scaler.events}, {cluster.n_slaves} slaves after the drain")
            admitted = scaler.events[0][2]
            rec.update(events=[[e[1], e[2]] for e in scaler.events],
                       membership_s=log.membership,
                       max_abs_err_vs_f64_chain=f64_err(resps, "autoscaler"))
            out["autoscaler"] = rec
        finally:
            cluster.shutdown()
        master_counts = read_counts(ks, CONV_KINDS)
    slaves = log.slaves()
    adm = next((r for r in slaves if r["device"] == admitted), None)
    if adm is None or adm["backend"] != WIRE_BACKENDS[1] or adm["counts"] is None:
        fail(f"admission autoscaler: the admitted cuda slave did not run and leave: {adm}")
    launches = check_slave_launches("admission", slaves, training=False)
    fwd, bwd = run_shapes("admission", master_log, master_counts, slaves)
    if bwd:
        fail(f"admission: backward shards while serving: {dict(bwd)}")
    check_left("admission", log, slaves)
    out.update(master_launches=master_counts, slaves=slaves,
               slave_shard_launches=launches, shutdown=log.shutdown_rec)
    emit(out)
    return out, launches, conv_path_shapes(ks, dev, fwd, bwd, "admission")


class ShardLog:
    """Every shard each device computes, through the four functions the
    three axes compute one with (``protocol.conv_shard`` and
    ``bwd_shard``: a kernel or sample shard; ``backends.strip_conv`` and
    ``strip_conv_vjp``: a height strip), and the K1 launches of the Eq.
    1 probes.  In-process slave threads carry their device id
    (``protocol.slave_loop``); every other thread computes device 0's,
    the master's.  A shard is empty when it has no output row or channel
    (a strip or sample slice of 0 rows, or 0 kernels).  Each non-empty
    strip also adds its image-rows computed (the strip and its halo,
    zero padded to ``strip_h + kh - 1`` rows) and kept (``strip_h``)
    under its backend, way and Cin."""

    def __init__(self, ks):
        self.ks = ks
        self.shards = collections.Counter()  # (device, backend, way, empty) -> n
        self.rows = {}  # (backend, way, cin) -> [computed, kept]
        self.probe_k1 = 0
        self.lock = threading.Lock()
        self.tls = threading.local()

    def _counted(self, fn, way, strip):
        def run(backend, x, w, *rest):
            out = fn(backend, x, w, *rest)
            empty = (out if way == "fwd" else rest[0]).size == 0 or x.size == 0
            with self.lock:
                self.shards[(getattr(self.tls, "device", 0), backend.name, way, empty)] += 1
                if strip and not empty:
                    computed = x.shape[1] + rest[-2] + rest[-1]
                    r = self.rows.setdefault((backend.name, way, int(x.shape[-1])), [0, 0])
                    r[0] += x.shape[0] * computed
                    r[1] += x.shape[0] * (computed - (w.shape[0] - 1))
            return out
        return run

    def _probe(self, fn):
        k1 = self.ks.wrapper["conv2d_fwd"]

        def run(*a, **kw):  # probes run one device at a time
            before = k1.launches
            try:
                return fn(*a, **kw)
            finally:
                with self.lock:
                    self.probe_k1 += k1.launches - before
        return run

    def __enter__(self):
        from repro_torch.core import backends
        from repro_torch.core.cluster import cluster, protocol

        loop = protocol.slave_loop

        def slave_loop(endpoint, slowdown, backend_name, device):
            self.tls.device = device
            return loop(endpoint, slowdown, backend_name, device)

        fwd, bwd = backends.strip_conv, backends.strip_conv_vjp
        self._saved = [(m, name, getattr(m, name)) for m, name in (
            (protocol, "slave_loop"), (protocol, "conv_shard"), (protocol, "bwd_shard"),
            (backends, "strip_conv"), (backends, "strip_conv_vjp"),
            (backends, "probe_conv_time"), (cluster, "probe_conv_time"))]
        protocol.slave_loop = slave_loop
        protocol.conv_shard = self._counted(protocol.conv_shard, "fwd", False)
        protocol.bwd_shard = self._counted(protocol.bwd_shard, "bwd", False)
        backends.strip_conv = self._counted(fwd, "fwd", True)
        backends.strip_conv_vjp = self._counted(bwd, "bwd", True)
        backends.probe_conv_time = self._probe(backends.probe_conv_time)
        cluster.probe_conv_time = self._probe(cluster.probe_conv_time)
        return self

    def __exit__(self, *exc):
        for m, name, fn in self._saved:
            setattr(m, name, fn)

    def nonempty(self, backend, way) -> int:
        return sum(n for (_, b, w, empty), n in self.shards.items()
                   if b == backend and w == way and not empty)

    def check_launches(self, phase, counts) -> dict:
        """Fails unless K1 ran once per non-empty ``cuda`` forward shard
        and probe launch, and K2 and K3 once per non-empty ``cuda``
        backward shard: an empty shard launches nothing."""
        want = {"conv2d_fwd": self.nonempty("cuda", "fwd") + self.probe_k1,
                "conv2d_dx": self.nonempty("cuda", "bwd"),
                "conv2d_dw": self.nonempty("cuda", "bwd")}
        got = {k: counts[k] for k in want}
        if got != want:
            fail(f"{phase}: launches {got}, the non-empty cuda shards and probes {want}")
        return want

    def record(self) -> dict:
        return {"shards": [[d, b, w, "empty" if e else "nonempty", n]
                           for (d, b, w, e), n in sorted(self.shards.items())],
                "probe_k1_launches": self.probe_k1,
                "strip_rows": [[b, w, cin, c, k, c / k]
                               for (b, w, cin), (c, k) in sorted(self.rows.items())],
                "strip_rows_fields": ["backend", "way", "cin", "image_rows_computed",
                                      "image_rows_kept", "computed_over_kept"]}


class ProbeScale:
    """While entered, ``launch/hetero.py`` builds a ``HeteroCluster``
    whose ``probe()`` multiplies device ``dev``'s measured time by
    ``factor``, as setting ``probe_times`` does: its Eq. 1 share falls
    without the sleeps an emulated slowdown would add to its ops."""

    def __init__(self, dev, factor):
        self.dev, self.factor = dev, factor

    def __enter__(self):
        import repro_torch.launch.hetero as hetero

        self._hetero, self._base = hetero, hetero.HeteroCluster
        dev, factor = self.dev, self.factor

        class Scaled(self._base):
            def probe(self, **kw):
                times = super().probe(**kw)
                self.probe_times = [t * factor if i == dev else t for i, t in enumerate(times)]
                return self.probe_times

        hetero.HeteroCluster = Scaled
        return self

    def __exit__(self, *exc):
        self._hetero.HeteroCluster = self._base


def ranked_first(pred) -> str:
    """The axis ``predict_partition_seconds`` ranks fastest, ties to the
    paper's order (kernel, spatial, batch), as the resolver breaks them."""
    return min(("kernel", "spatial", "batch"), key=pred.get)


class ResolveLog:
    """Every ``auto`` axis decision (``plans.resolve_mode``) while
    entered: the layer's shapes, the op its plan governs, the weight
    cache's state, the pick, whether the cluster's memo answered, and
    ``predict_partition_seconds`` over the cluster's state at that call
    with the axis it ranks first, and that state (probe times and FLOPs,
    the master's duty), so the same layers can be resolved on another
    link."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.core.cluster import plans

        self.plans, self.real = plans, plans.resolve_mode

        def resolve_mode(cluster, x_shape, w_shape, override, op="conv",
                         weights_cached=False, layer=None):
            memo = getattr(cluster, "_mode_cache", None)
            hit = memo is not None and (tuple(x_shape), tuple(w_shape), op,
                                        bool(weights_cached), layer is not None) in memo
            pick = self.real(cluster, x_shape, w_shape, override, op, weights_cached,
                             layer=layer)
            if (override or cluster.partition) == "auto":
                pred = plans.predict_partition_seconds(cluster, x_shape, w_shape, op,
                                                       weights_cached=weights_cached,
                                                       layer=layer)
                times = cluster.probe_times if layer is None else layer.times
                self.calls.append({
                    "layer": "conv1" if w_shape[2] == 3 else "conv2", "op": op,
                    "x": list(x_shape), "w": list(w_shape),
                    "weights_cached": bool(weights_cached), "pick": pick, "memo_hit": hit,
                    "predicted_s": pred, "ranked_first": ranked_first(pred),
                    "state": {"probe_s": [float(t) for t in times],
                              "probe_flops": (cluster.probe_flops if layer is None
                                              else layer.flops),
                              "layer_probe": layer is not None,
                              "comp_duty": cluster.comp_duty}})
            return pick

        plans.resolve_mode = resolve_mode
        return self

    def __exit__(self, *exc):
        self.plans.resolve_mode = self.real


def thin_link_picks(calls, mbps) -> list:
    """``resolve_mode`` alone, nothing run: each distinct decision of
    ``calls`` resolved again on links of ``mbps`` from the state it was
    made in (a cluster of ``numpy`` threads holding that state)."""
    from repro_torch.core.cluster import plans
    from repro_torch.core.master_slave import HeteroCluster

    c = HeteroCluster([1.0] * 3, ["numpy"] * 3, partition="auto", bandwidth_mbps=mbps)
    out, seen = [], set()
    try:
        for call in calls:
            key = (call["layer"], call["op"], tuple(call["x"]), call["weights_cached"])
            if key in seen:
                continue
            seen.add(key)
            st = call["state"]
            c.probe_times, c.probe_flops, c.comp_duty = (
                list(st["probe_s"]), st["probe_flops"], st["comp_duty"])
            layer = (plans.LayerProbe(list(st["probe_s"]), st["probe_flops"])
                     if st["layer_probe"] else None)
            c._mode_cache.clear()
            pick = plans.resolve_mode(c, tuple(call["x"]), tuple(call["w"]), None, call["op"],
                                      call["weights_cached"], layer=layer)
            pred = plans.predict_partition_seconds(c, tuple(call["x"]), tuple(call["w"]),
                                                   call["op"], call["weights_cached"],
                                                   layer=layer)
            if pick != ranked_first(pred):
                fail(f"axes auto at {mbps} Mbps: {call['layer']} picked {pick}, the "
                     f"predictor ranks {ranked_first(pred)} first: {pred}")
            out.append({"layer": call["layer"], "op": call["op"], "x": call["x"],
                        "weights_cached": call["weights_cached"], "pick": pick,
                        "predicted_s": pred, "at_1000_mbps": call["pick"]})
    finally:
        c.shutdown()
    return out


def strip_rows(log) -> dict:
    """A ``ShardLog``'s image-rows computed and kept by the ``cuda``
    devices' forward strips, by layer."""
    out = {}
    for (b, way, cin), (computed, kept) in log.rows.items():
        if b == "cuda" and way == "fwd":
            out["conv1" if cin == 3 else "conv2"] = {
                "computed": computed, "kept": kept, "computed_over_kept": computed / kept}
    return out


def axes_phase(ks, dev, cfg, c1, c2, train_kw, serve_kw, ref_losses, ref_params) -> tuple:
    """Phase 22: the flat cluster's other partition axes at full width,
    through ``run_hetero`` and ``run_serve`` over phase 7's network,
    backends, batch, microbatches and lr.  (a) In process, in one
    profiler trace: ``AXES_STEPS`` training steps and ``AXES_REQUESTS``
    requests under ``spatial`` and under ``batch``; (b) device 1 left no
    strip row, then no sample, by its probe time; (c) ``auto``,
    ``kernel``, ``spatial`` and ``batch`` on emulated ``AXES_MBPS``
    links, and ``auto``'s picks on ``AXES_THIN_MBPS`` from the resolver
    alone; (d) ``spatial`` and ``batch`` over shm with device 1 a
    ``cuda`` slave process; (e) K1-K3 at every shape (a) gave them.
    Step 1 of every run is held against phase 7's float64 step, every
    later step against one float64 step from the run's own params.
    Returns (its JSON records, the cuda slaves' shard launches by run,
    (a)'s shape records and trace, (d)'s shape records)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.backends import get_backend
    from repro_torch.core.cluster.transport import ShmTransport
    from repro_torch.launch.hetero import run_hetero, run_serve

    backends = WIRE_BACKENDS
    first = (ref_losses[0], ref_params[0])
    kw = dict(train_kw, steps=AXES_STEPS)
    skw = dict(serve_kw, requests=AXES_REQUESTS)
    cuda_backend = get_backend("cuda")
    recs, launches = [], {}

    def step_errs_of(run, rec, hist):
        if not np.isfinite(rec["losses"]).all():
            fail(f"axes {run}: non-finite losses {rec['losses']}")
        return local_step_errs(f"axes {run}", cfg, kw["batch"], kw["lr"], dev,
                               rec["losses"], hist, first=first)

    def train_record(part, run, rec, hist, run_s, **extra):
        t0 = time.perf_counter()
        l_errs, p_errs = step_errs_of(run, rec, hist)
        extra["f64_check_s"] = time.perf_counter() - t0
        return {"phase": "axes", "part": part, "run": run, "net": f"cifar_cnn_{c1}_{c2}",
                "backends": backends, "transport": rec["transport"],
                "partition": rec["partition"], "batch": kw["batch"],
                "microbatches": kw["microbatches"], "lr": kw["lr"],
                "steps": len(rec["losses"]), "losses": rec["losses"],
                "loss_err_by_step": l_errs, "param_err_by_step": p_errs,
                "loss_atol": LOSS_ATOL, "param_atol": PARAM_ATOL,
                "held": "step 1 against phase 7's float64 step, each later step "
                        "against one float64 step from the run's own params",
                "s_per_step": rec["wall_s"] / len(rec["losses"]), "wall_s": rec["wall_s"],
                "run_s": run_s, "probe_s": rec["probe_s"], "shares": rec["shares"],
                "partition_choices": rec["partition_choices"],
                "bandwidth_mbps": rec["bandwidth_mbps"], "comm_mib": rec["comm_mb"],
                "timing_s": rec["timing"], **extra}

    # (a) in process, one trace: spatial and batch, training and serving
    # (the float64 references run after the trace)
    fwd, bwd = collections.Counter(), collections.Counter()
    shape_logs, runs = {}, {}
    pad = torch.zeros(1, device=dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof, ShardLog(ks) as shards:
        for _ in range(TRACE_PAD_KERNELS):  # a trace after others can lose its first records
            pad.add_(1)
        torch.cuda.synchronize()
        reset_counts(ks)
        t_run = time.perf_counter()
        for run, call, run_kw in (
                [(f"train {a}", run_hetero, dict(kw, partition=a)) for a in ("spatial", "batch")]
                + [(f"serve {a}", run_serve, dict(skw, partition=a))
                   for a in ("spatial", "batch")]):
            with ShapeLog(cuda_backend) as shape_logs[run]:
                t0 = time.perf_counter()
                out = call([1.0] * 3, backends, **run_kw)
                torch.cuda.synchronize()
                runs[run] = out + (time.perf_counter() - t0,)
        run_s = time.perf_counter() - t_run
        counts = read_counts(ks, CONV_KINDS)
    trace = device_trace(prof, run_s)
    for kind in CONV_KINDS:
        if counts[kind] == 0:
            fail(f"axes (a): the {kind} kernel was never launched")
        if trace["kernels"][kind]["launches"] != counts[kind]:
            fail(f"axes (a): the trace holds {trace['kernels'][kind]['launches']} {kind} "
                 f"launches, the wrapper counted {counts[kind]}")
    shards.check_launches("axes (a)", counts)
    for run, (rec, out, t) in runs.items():
        if run.startswith("train"):
            recs.append(train_record("a", run, rec, out, t))
            continue
        axis = rec["partition"]
        if not rec["all_ok"]:
            fail(f"axes {run}: statuses {rec['statuses']}")
        err = serve_f64_err(ks, dev, out, c1, c2, skw["image_size"], skw["requests"])
        if err > SERVE_ATOL:
            fail(f"axes {run}: max abs err {err} vs the float64 chain > {SERVE_ATOL}")
        recs.append({"phase": "axes", "part": "a", "run": run, "partition": axis,
                     "requests": skw["requests"], "max_batch": skw["max_batch"],
                     "statuses": rec["statuses"], "throughput_rps": rec["throughput_rps"],
                     "p50_ms": rec["p50_ms"], "p99_ms": rec["p99_ms"], "wall_s": rec["wall_s"],
                     "run_s": t, "checked_outputs": 4, "max_abs_err_vs_f64_chain": err,
                     "atol": SERVE_ATOL, "probe_s": rec["probe_s"], "shares": rec["shares"],
                     "comm_mib": rec["comm_mb"]})
    for r in recs:
        emit(r)
    for log in shape_logs.values():
        fwd.update(log.fwd)
        bwd.update(log.bwd)
    emit({"phase": "axes", "part": "a", "run": "launches", "launches": counts,
          "trace": trace, "run_s": run_s, **shards.record(),
          "strip_rows_by_layer": strip_rows(shards),
          "by_run": {run: {"fwd_by_shape": [list(k) + [n] for k, n in sorted(log.fwd.items())],
                           "bwd_by_shape": [list(k) + [n] for k, n in sorted(log.bwd.items())]}
                     for run, log in shape_logs.items()}})

    # (b) device 1, a cuda device, left no strip row, then no sample
    for axis in ("spatial", "batch"):
        with ProbeScale(1, AXES_ZERO_SHARE), ShardLog(ks) as shards:
            reset_counts(ks)
            t0 = time.perf_counter()
            rec, hist = run_hetero([1.0] * 3, backends, **dict(kw, partition=axis, steps=1))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts = read_counts(ks, CONV_KINDS)
        dev1 = {(way, empty): n for (d, b, way, empty), n in shards.shards.items() if d == 1}
        if not dev1 or any(not empty for (_, empty) in dev1) or \
                not all((way, True) in dev1 for way in ("fwd", "bwd")):
            fail(f"axes (b) {axis}: device 1's shards {dev1}, want only empty ones")
        shards.check_launches(f"axes (b) {axis}", counts)
        r = train_record("b", f"zero share {axis}", rec, hist, run_s,
                         probe_factor_device_1=AXES_ZERO_SHARE, launches=counts,
                         **shards.record())
        recs.append(r)
        emit(r)

    # (c) every axis on emulated links of AXES_MBPS; auto's picks held to
    # the predictor's ranking, and resolved again on thin links
    walls, picks = {}, None
    for axis in AXES_MODES:
        with ResolveLog() as resolved:
            t0 = time.perf_counter()
            rec, hist = run_hetero([1.0] * 3, backends, bandwidth_mbps=AXES_MBPS,
                                   **dict(kw, partition=axis))
            run_s = time.perf_counter() - t0
        extra = {}
        if axis == "auto":
            calls = resolved.calls
            fresh = [c for c in calls if not c["memo_hit"]]
            wrong = [c for c in fresh if c["pick"] != c["ranked_first"]]
            if not fresh or wrong:
                fail(f"axes (c): auto's picks against the predictor's ranking: {wrong or calls}")
            picks = calls
            extra = {"picks": calls,
                     "memo_picks_not_ranked_first": sum(
                         c["pick"] != c["ranked_first"] for c in calls if c["memo_hit"]),
                     "picks_at_thin_link": thin_link_picks(calls, AXES_THIN_MBPS),
                     "thin_link_mbps": AXES_THIN_MBPS}
        r = train_record("c", f"{axis} at {AXES_MBPS:g} Mbps", rec, hist, run_s, **extra)
        walls[axis] = r["s_per_step"]
        recs.append(r)
        emit(r)
    emit({"phase": "axes", "part": "c", "run": "s_per_step", "bandwidth_mbps": AXES_MBPS,
          "s_per_step": walls, "fastest": min(walls, key=walls.get),
          "auto_picks": sorted({(c["layer"], c["pick"]) for c in picks})})

    # (d) spatial and batch over shm, device 1 a cuda slave process
    p_fwd, p_bwd = collections.Counter(), collections.Counter()
    for axis in ("spatial", "batch"):
        with WireLog(f"axes_{axis}", ring_bytes=ShmTransport.DEFAULT_RING_BYTES) as log, \
                ShapeLog(cuda_backend) as master_log:
            reset_counts(ks)
            t0 = time.perf_counter()
            rec, hist = run_hetero([1.0] * 3, backends, transport="shm",
                                   **dict(kw, partition=axis))
            run_s = time.perf_counter() - t0
            master_counts = read_counts(ks, CONV_KINDS)
        slaves = log.slaves()
        run = f"shm {axis}"
        launches[f"axes {axis}"] = check_slave_launches(f"axes {run}", slaves, training=True)
        ops = ("sconv", "sbwd") if axis == "spatial" else ("conv", "bwd")
        cuda_slaves = [s for s in slaves if s["backend"] == "cuda"]
        if not cuda_slaves or any(
                min(s["ops_sent"].get(op, 0) - s["ops_sent"].get(f"{op} empty", 0)
                    for op in ops) == 0 for s in cuda_slaves):
            fail(f"axes {run}: the cuda slave was not sent non-empty {ops}: "
                 f"{[s['ops_sent'] for s in cuda_slaves]}")
        f, b = run_shapes(f"axes {run}", master_log, master_counts, slaves)
        p_fwd.update(f)
        p_bwd.update(b)
        check_left(f"axes {run}", log, slaves)
        r = train_record("d", run, rec, hist, run_s,
                         ring_mib=ShmTransport.DEFAULT_RING_BYTES / 2 ** 20,
                         measured_bandwidth_mbps=rec["measured_bandwidth_mbps"],
                         wire=dict(log.tally), steps_wire=log.steps,
                         master_launches=master_counts, slaves=slaves,
                         slave_shard_launches=launches[f"axes {axis}"],
                         shutdown=log.shutdown_rec)
        recs.append(r)
        emit(r)

    # (e) K1-K3 at (a)'s shapes, with the cuda backend's copies of a call
    t0 = time.perf_counter()
    shape_recs = conv_path_shapes(ks, dev, fwd, bwd, "axes", copy=True)
    shapes_s = time.perf_counter() - t0
    copies = {}
    for run, log in shape_logs.items():
        per = kw["steps"] if run.startswith("train") else skw["requests"]
        by = {kind: {tuple(r["shape"]["x"]) + (r["shape"]["w"][3], r["shape"]["w"][0]): r
                     for r in shape_recs[kind]} for kind in ("conv2d_fwd", "conv2d_dx")}
        copy_ms = (sum(n * by["conv2d_fwd"][s]["copy_ms"] for s, n in log.fwd.items())
                   + sum(n * by["conv2d_dx"][s]["copy_ms"] for s, n in log.bwd.items()))
        w_mib = sum(n * s[3] * s[4] * s[5] ** 2 * 4 for s, n in
                    list(log.fwd.items()) + list(log.bwd.items())) / 2 ** 20
        copies[run] = {"copy_ms": copy_ms, "weight_mib_to_card": w_mib,
                       "per": "step" if run.startswith("train") else "request",
                       "copy_ms_per": copy_ms / per, "weight_mib_per": w_mib / per}
    emit({"phase": "axes", "part": "e", "run": "copies", "by_run": copies,
          "shapes_checked": sum(len(r) for r in shape_recs.values()), "shapes_s": shapes_s,
          "note": "each call's copies at its shape (x, w up and y back for a conv; "
                  "x, w, g up and dX, dW back for a conv_vjp), the probes' included"})
    process_recs = conv_path_shapes(ks, dev, p_fwd, p_bwd, "axes shm")
    return recs, launches, (shape_recs, trace), process_recs


class KernelShapes:
    """Records the shape of every call of K1-K5 on CUDA tensors, by the
    routes the examples take to them: the ``cuda`` backend's ``conv``
    and ``conv_vjp`` (a cluster's devices and its probes: ``ShapeLog``),
    ``Conv2dFunction``'s three operators (a local CNN's convs), and K4's
    and K5's launch functions (``_flash_forward``, ``_ssd_forward``),
    which every attention and SSD scan of a model reaches.  The keys are
    ``path_shapes``', ``attn_path_shapes``' and ``ssd_path_shapes``'."""

    def __init__(self, backend):
        self.backend_log = ShapeLog(backend)
        self.fwd, self.dx, self.dw = (collections.Counter() for _ in range(3))
        self.attn, self.ssd = collections.Counter(), collections.Counter()
        self.lock = threading.Lock()

    def _tally(self, counter, key, t):
        if t.is_cuda:
            with self.lock:
                counter[key] += 1

    def __enter__(self):
        from repro_torch.kernels import conv2d as conv_mod
        from repro_torch.kernels import flash_attn as attn_mod
        from repro_torch.kernels import ssd as ssd_mod

        fwd, dx, dw = conv_mod.conv2d_op, conv_mod.conv2d_dx_op, conv_mod.conv2d_dw_op
        flash, scan = attn_mod._flash_forward, ssd_mod._ssd_forward

        def fwd_op(x, w):
            self._tally(self.fwd, tuple(x.shape) + (w.shape[3], w.shape[0]), x)
            return fwd(x, w)

        def dx_op(g, w):
            self._tally(self.dx, tuple(g.shape[:3]) + (w.shape[2], w.shape[3], w.shape[0]), g)
            return dx(g, w)

        def dw_op(x, g, kh, kw):
            self._tally(self.dw, tuple(x.shape) + (g.shape[3], kh), x)
            return dw(x, g, kh, kw)

        def flash_forward(q, k, v, *, causal, window):
            self._tally(self.attn, (q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                                    k.shape[2], q.shape[3], causal, window, q.dtype), q)
            return flash(q, k, v, causal=causal, window=window)

        def ssd_forward(x, dt, a, bm, cm, *, chunk):
            self._tally(self.ssd, tuple(x.shape[:3]) + (bm.shape[2], x.shape[3], bm.shape[3],
                                                        chunk, x.dtype), x)
            return scan(x, dt, a, bm, cm, chunk=chunk)

        self._saved = [(conv_mod, "conv2d_op", fwd), (conv_mod, "conv2d_dx_op", dx),
                       (conv_mod, "conv2d_dw_op", dw), (attn_mod, "_flash_forward", flash),
                       (ssd_mod, "_ssd_forward", scan)]
        conv_mod.conv2d_op, conv_mod.conv2d_dx_op, conv_mod.conv2d_dw_op = fwd_op, dx_op, dw_op
        attn_mod._flash_forward, ssd_mod._ssd_forward = flash_forward, ssd_forward
        self.backend_log.__enter__()
        return self

    def __exit__(self, *exc):
        self.backend_log.__exit__(*exc)
        for m, name, fn in self._saved:
            setattr(m, name, fn)

    def conv(self) -> tuple:
        """(K1's, K2's, K3's) shapes over both conv routes."""
        log = self.backend_log
        return (self.fwd + log.fwd, self.dx + log.bwd, self.dw + log.bwd)


def load_example(name: str):
    """examples/<name>.py as a module (its ``main`` not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(ks, dev) -> tuple:
    """Phase 29: the four examples of the port, each module's ``main``
    run in process with ``--device cuda`` at its reference's defaults
    (``EXAMPLES``), all inside one profiler trace and ``KernelShapes``.
    Each example's own assertions are the run's checks; its output goes
    into its record (the last ``EXAMPLE_TAIL`` lines).  K1-K5 each
    launched, each wrapper's count equal to the trace's and to the calls
    ``KernelShapes`` saw (an empty conv launches nothing); then each
    kernel against its plain version at every shape the examples gave
    it.  Returns (the records, {kernel: (shape records, trace)})."""
    import io
    import traceback

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.backends import get_backend

    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    EXAMPLES_DIR.mkdir(parents=True)
    recs, by_example = [], {}
    pad = torch.zeros(1, device=dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            KernelShapes(get_backend("cuda")) as shapes:
        for _ in range(TRACE_PAD_KERNELS):  # a trace after others can lose its first records
            pad.add_(1)
        torch.cuda.synchronize()
        reset_counts(ks)
        t_run = time.perf_counter()
        for name, argv in EXAMPLES:
            mod = load_example(name)
            before = read_counts(ks)
            buf = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    out = mod.main(["--device", "cuda", *argv])
                torch.cuda.synchronize()
            except (Exception, SystemExit):
                fail(f"examples {name}: {traceback.format_exc()}\n"
                     f"its output: {buf.getvalue()[-4000:]}")
            after = read_counts(ks)
            by_example[name] = (out, time.perf_counter() - t0,
                                {k: after[k] - before[k] for k in after},
                                buf.getvalue().splitlines()[-EXAMPLE_TAIL:])
        run_s = time.perf_counter() - t_run
        counts = read_counts(ks)
    t0 = time.perf_counter()
    trace = device_trace(prof, run_s)
    trace_read_s = time.perf_counter() - t0
    del prof
    fwd, dx, dw = shapes.conv()
    seen = {"conv2d_fwd": nonempty(fwd), "conv2d_dx": nonempty(dx),
            "conv2d_dw": nonempty(dw), "flash_attention": sum(shapes.attn.values()),
            "ssd": sum(shapes.ssd.values())}
    for kind in SYMBOLS:
        if counts[kind] == 0:
            fail(f"examples: the {kind} kernel was never launched")
        if trace["kernels"][kind]["launches"] != counts[kind]:
            fail(f"examples: the trace holds {trace['kernels'][kind]['launches']} {kind} "
                 f"launches, the wrapper counted {counts[kind]}")
        if seen[kind] != counts[kind]:
            fail(f"examples: the {kind} calls seen stand for {seen[kind]} launches, the "
                 f"wrapper counted {counts[kind]}")

    def rec(example, **numbers):
        _, run_s_, launches, tail = by_example[example]
        return {"phase": "examples", "example": example, **numbers,
                "run_s": run_s_, "launches": launches, "output_tail": tail}

    qs, _, _, _ = by_example["quickstart_torch"]
    recs.append(rec("quickstart_torch", local_s=qs["local_s"],
                    distributed_s=qs["distributed_s"],
                    final_acc_local=qs["final_acc_local"],
                    final_acc_distributed=qs["final_acc_distributed"], drift=qs["drift"],
                    comm_mib=qs["comm_mib"], probe_times=qs["probe_times"],
                    shares=qs["shares"], losses_local=qs["losses_local"]))
    hc, _, _, _ = by_example["hetero_cluster_torch"]
    recs.append(rec("hetero_cluster_torch", **{k: hc[k] for k in (
        "single_ms", "balanced_ms", "equal_ms", "gain", "barrier_ms", "pipelined_ms",
        "pipeline_gain", "mixed_ms", "probe_times", "shares", "kernels", "mixed_backends",
        "mixed_probe_times", "mixed_kernels")}))
    sb, _, _, _ = by_example["serve_batched_torch"]
    recs.append(rec("serve_batched_torch", regimes=sb))
    tl, _, _, _ = by_example["train_lm_torch"]
    recs.append(rec("train_lm_torch", **{k: tl[k] for k in (
        "params_m", "steps", "batch", "seq", "s_per_step", "tokens_per_s", "first_loss",
        "last_loss", "logged_losses", "logged_evals", "restored_eval_loss")}))
    for r in recs:
        emit(r)
    emit({"phase": "examples", "example": "launches", "launches": counts, "trace": trace,
          "run_s": run_s, "trace_read_s": trace_read_s,
          "by_example": {n: v[2] for n, v in by_example.items()}})
    t0 = time.perf_counter()
    shape_recs = {
        "conv2d_fwd": path_shapes(ks, "conv2d_fwd", dev, fwd, "main_path_shape", "examples"),
        "conv2d_dx": path_shapes(ks, "conv2d_dx", dev, dx, "main_path_shape", "examples"),
        "conv2d_dw": path_shapes(ks, "conv2d_dw", dev, dw, "main_path_shape", "examples"),
        "flash_attention": attn_path_shapes(ks, dev, shapes.attn, "examples"),
        "ssd": ssd_path_shapes(ks, dev, shapes.ssd, "examples"),
    }
    emit({"phase": "examples", "example": "shapes",
          "shapes_checked": sum(len(rs) for rs in shape_recs.values()),
          "shapes_s": time.perf_counter() - t0})
    return recs, {kind: (rs, trace) for kind, rs in shape_recs.items()}


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
    from repro_torch.launch.hetero import run_hetero, run_serve, sgd_step, train_inputs
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

    mark("2")
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

    mark("3")
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

    mark("4")
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

    mark("5")
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
    n_check = 4
    serve_err = serve_f64_err(ks, dev, outputs, c1, c2, image, requests, n_check)
    if serve_err > SERVE_ATOL:
        fail(f"serve: max abs err {serve_err} vs the float64 chain > {SERVE_ATOL}")
    serve_rec = rec
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

    mark("6")
    # -- 6. K1 at every shape the serve run gave it ---------------------------
    serve_recs = path_shapes(ks, "conv2d_fwd", dev, serve_log.fwd,
                             "main_path_shape", "serve")

    mark("7")
    # -- 7. train the headline network through the port ----------------------
    cfg = make_cnn_config(c1, c2)
    # 2 steps, which also set the hierarchy's and wire's: with the axes
    # phase, 3 took the whole run past 800 s
    batch, micro, steps, lr = 32, 4, 2, 0.05
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

    mark("8")
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

    mark("9")
    # -- 9. K1, K2, K3 at every shape the train run gave them ----------------
    train_recs = {
        "conv2d_fwd": path_shapes(ks, "conv2d_fwd", dev, train_log.fwd,
                                  "main_path_shape", "train"),
        "conv2d_dx": path_shapes(ks, "conv2d_dx", dev, train_log.bwd,
                                 "main_path_shape", "train"),
        "conv2d_dw": path_shapes(ks, "conv2d_dw", dev, train_log.bwd,
                                 "main_path_shape", "train"),
    }

    mark("10")
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

    mark("11")
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

    mark("12")
    # -- 12. serve hymba-1.5b at full width through the port -----------------
    arch, lm_batch, prompt, new = "hymba-1.5b", 4, 2048, 16
    hymba_layers = 32
    lm_rec, attn_shapes, ssd_shapes, lm_trace = serve_lm(
        ks, dev, arch, lm_batch, prompt, new,
        {"flash_attention": hymba_layers, "ssd": hymba_layers}, "lm_serve")
    emit(lm_rec)

    mark("13")
    # -- 13. the kernel path against the plain path, fp32 at full width ------
    emit(lm_check(dev, arch, lm_batch, prompt, new, SEED))
    torch.cuda.empty_cache()

    mark("14")
    # -- 14. K4 and K5 at every shape the lm_serve run gave them -------------
    attn_recs = attn_path_shapes(ks, dev, attn_shapes, "lm_serve")
    ssd_recs = ssd_path_shapes(ks, dev, ssd_shapes, "lm_serve")
    gc.collect()
    torch.cuda.empty_cache()

    mark("15")
    # -- 15. K4 and K5 with their gradients, at the training shapes ---------
    for dtype in (torch.float32, torch.bfloat16):
        emit(check_grad_attn(ks, dev, 2, 25, 5, TRAIN_SEQ, TRAIN_SEQ, 64, True, 1024, dtype))
        emit(check_grad_ssd(ks, dev, 2, TRAIN_SEQ, 50, 1, 64, 16, 256, dtype))

    mark("16")
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

    mark("17")
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

    mark("18-19")
    # -- 18-19. the flat cluster's slave processes -------------------------
    train_kw = dict(device="cuda", train_pipeline=True, microbatches=micro, c1=c1,
                    c2=c2, batch=batch, steps=steps, lr=lr, partition="kernel")
    serve_kw = dict(device="cuda", c1=c1, c2=c2, image_size=image, requests=requests,
                    max_batch=max_batch, partition="kernel", deadline_s=600.0, seed=SEED)
    _, slave_launches, wire_recs = wire_phase(
        ks, dev, cfg, c1, c2, train_kw, serve_kw, ref_losses, ref_params,
        {"s_per_step": trec["wall_s"] / steps}, serve_rec)
    _, slave_launches["recover"], recover_recs = recover_phase(ks, dev, cfg, c1, c2,
                                                               train_kw)
    mark("20-21")
    # -- 20-21. the wire codec, and ClusterServer's admission -----------------
    _, codec_launches, codec_recs = codec_phase(ks, dev, cfg, c1, c2, train_kw)
    slave_launches.update({f"codec {run}": n for run, n in codec_launches.items()})
    _, slave_launches["admission"], admission_recs = admission_phase(ks, dev, c1, c2, image,
                                                                     max_batch)
    mark("22")
    # -- 22. the spatial, batch and auto axes ---------------------------------
    _, axes_launches, (axes_recs, axes_trace), axes_process_recs = axes_phase(
        ks, dev, cfg, c1, c2, train_kw, serve_kw, ref_losses, ref_params)
    slave_launches.update(axes_launches)
    process_recs = {kind: {"wire": wire_recs[kind], "recover": recover_recs[kind],
                           "codec": codec_recs[kind], "admission": admission_recs[kind],
                           "axes shm": axes_process_recs[kind]}
                    for kind in CONV_KINDS}

    mark("23")
    # -- 23. the rest of the model zoo at full width -------------------------
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

    mark("24-27")
    # -- 24-27. the mesh layer on the card's (1, 1) mesh ---------------------
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

    mark("28")
    # -- 28. the dry run at 256 / 512 GPUs and on the card's mesh -----------
    for r in dryrun_records(mt_rec):
        emit(r)

    mark("29")
    # -- 29. the port's four examples on the card ------------------------------
    _, ex_runs = examples_phase(ks, dev)

    kernels = [
        entry("conv2d_fwd", "src/repro_torch/kernels/csrc/conv2d_fwd.cu",
              "src/repro/kernels/conv2d.py:78",
              {"serve": (serve_recs, serve_trace),
               "train": (train_recs["conv2d_fwd"], train_trace),
               "hierarchy": (hier_recs["conv2d_fwd"], hier_trace),
               "axes": (axes_recs["conv2d_fwd"], axes_trace),
               "mesh_cnn": (mc_recs["conv2d_fwd"], mc_trace),
               "examples": ex_runs["conv2d_fwd"]},
              untraced=process_recs["conv2d_fwd"]),
        entry("conv2d_dx", "src/repro_torch/kernels/csrc/conv2d_bwd.cu",
              "src/repro/kernels/conv2d.py:94",
              {"train": (train_recs["conv2d_dx"], train_trace),
               "hierarchy": (hier_recs["conv2d_dx"], hier_trace),
               "axes": (axes_recs["conv2d_dx"], axes_trace),
               "mesh_cnn": (mc_recs["conv2d_dx"], mc_trace),
               "examples": ex_runs["conv2d_dx"]},
              untraced=process_recs["conv2d_dx"]),
        entry("conv2d_dw", "src/repro_torch/kernels/csrc/conv2d_bwd.cu",
              "src/repro/kernels/conv2d.py:138",
              {"train": (train_recs["conv2d_dw"], train_trace),
               "hierarchy": (hier_recs["conv2d_dw"], hier_trace),
               "axes": (axes_recs["conv2d_dw"], axes_trace),
               "mesh_cnn": (mc_recs["conv2d_dw"], mc_trace),
               "examples": ex_runs["conv2d_dw"]},
              untraced=process_recs["conv2d_dw"]),
        entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attn_fwd.cu",
              "src/repro/kernels/flash_attn.py:97",
              {"lm_serve": (attn_recs, lm_trace), "lm_train": (train_attn_recs,
                                                               train_lm_trace),
               **zoo_runs, "mesh_train": (mt_attn, mt_trace),
               "examples": ex_runs["flash_attention"]}, dtype=torch.bfloat16,
              path_dtypes={"examples": torch.float32}),
        entry("ssd", "src/repro_torch/kernels/csrc/ssd_fwd.cu",
              "src/repro/kernels/ssd.py:75",
              {"lm_serve": (ssd_recs, lm_trace),
               "lm_train": (train_ssd_recs, train_lm_trace),
               "mesh_train": (mt_ssd, mt_trace),
               "examples": ex_runs["ssd"]}, dtype=torch.float32),
    ]
    # the cuda slave processes' own launches (outside this process's
    # counters and traces), by run
    for k in kernels[:3]:
        by_run = {run: n.get(k["name"], 0) for run, n in slave_launches.items()}
        k.update(slave_process_launches=sum(by_run.values()),
                 slave_process_launches_by_run=by_run)
    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.")
                                  for m in sys.modules):
        fail("the JAX package or jax was imported")
    if "ml_dtypes" in sys.modules:
        fail("ml_dtypes was imported (the bf16 wire stage is numpy only)")
    mark("done")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "phase_start_s": PHASE_START_S})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
