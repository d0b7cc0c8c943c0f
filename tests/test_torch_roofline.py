"""The port's op counter (``repro_torch/roofline/op_count.py``) and
roofline, the counterparts of tests/test_hlo_parse.py's checks:

* a single matmul's FLOPs are exactly 2·m·n·k;
* a stack of L layers counts L times one layer — the Python loop is
  counted in full, which is why the port has no ``models/unroll.py``
  (XLA's ``cost_analysis`` counts a ``while`` body once);
* the backward's matmuls are counted (2x the forward's for a linear);
* on a fake (16, 16) process group a matmul whose output is sharded on
  ``model`` counts a sixteenth of its global FLOPs, a replicated one
  all of them, and a Partial one (a contraction over a sharded axis)
  a sixteenth;
* an all-gather of a known tensor counts the formula's bytes (its
  result), an all-reduce twice its operand;
* the custom operators of K4, K5 and K1 (and K2 and K3, which the
  CNN's dry run needs on fake tensors) count their FLOP formulas, which
  equal the work ``chip_smoke.py`` bounds them with;
* the live-bytes peak follows allocation and release;
* the roofline's terms use the H100's figures, none of the TPU's.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels.conv2d import conv2d_dw_op, conv2d_dx_op, conv2d_op, conv_flops
from repro_torch.kernels.flash_attn import attention_flops, flash_attention_op
from repro_torch.kernels.ssd import ssd_flops, ssd_op
from repro_torch.roofline.analysis import HW, RooflineReport
from repro_torch.roofline.op_count import OpCounter

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_single_matmul_flops_exact():
    a, b = torch.randn(64, 48), torch.randn(48, 80)
    with OpCounter() as c:
        a @ b
    assert c.flops == 2 * 64 * 48 * 80


@pytest.mark.parametrize("layers", [1, 3, 8])
def test_stack_of_layers_counts_every_layer(layers):
    """What ``unroll.py`` exists for in the JAX package holds here
    without it: L layers count L times one."""
    ws = [torch.randn(32, 32) for _ in range(layers)]
    x = torch.randn(16, 32)
    with OpCounter() as c:
        h = x
        for w in ws:
            h = torch.tanh(h @ w)
    assert c.flops == layers * 2 * 16 * 32 * 32


def test_backward_matmuls_counted():
    x = torch.randn(16, 32)
    w = torch.randn(32, 24, requires_grad=True)
    with OpCounter() as fwd:
        y = (x @ w).sum()
    with OpCounter() as bwd:
        y.backward()
    assert fwd.flops == 2 * 16 * 32 * 24
    assert bwd.flops == fwd.flops  # dW = x^T g (x needs no gradient)
    x.requires_grad_(True)
    y = (x @ w).sum()
    with OpCounter() as both:
        y.backward()
    assert both.flops == 2 * fwd.flops


def test_peak_live_bytes_follow_release():
    with OpCounter() as c:
        a = torch.ones(1024)            # 4 KiB
        b = torch.ones(2048)            # 8 KiB
        del a
        d = torch.ones(512)             # 2 KiB
        del b, d
    assert c.peak_bytes == (1024 + 2048) * 4
    assert c.live_bytes == 0


@pytest.fixture
def fake_mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    try:
        yield init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_sharded_and_replicated_matmuls_on_the_fake_group(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    m, k, n = 256, 512, 1024
    full = 2 * m * k * n
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(m, k), fake_mesh, [Replicate(), Replicate()])
        w_col = distribute_tensor(torch.empty(k, n), fake_mesh, [Replicate(), Shard(1)])
        w_rep = distribute_tensor(torch.empty(k, n), fake_mesh, [Replicate(), Replicate()])
        x_row = distribute_tensor(torch.empty(m, k), fake_mesh, [Replicate(), Shard(1)])
        w_row = distribute_tensor(torch.empty(k, n), fake_mesh, [Replicate(), Shard(0)])
        with OpCounter() as col:
            y = x @ w_col
        assert y.placements[1] == Shard(1)
        with OpCounter() as rep:
            x @ w_rep
        with OpCounter() as row:
            z = x_row @ w_row
        assert z.placements[1].is_partial()
    assert col.flops == full / 16
    assert rep.flops == full
    assert row.flops == full / 16
    assert col.collective_bytes == rep.collective_bytes == 0


def test_collective_bytes_follow_the_ring_formulas(fake_mesh):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    with FakeTensorMode():
        t = distribute_tensor(torch.empty(64, 128), fake_mesh, [Replicate(), Shard(0)])
        with OpCounter() as ag:
            t.redistribute(fake_mesh, [Replicate(), Replicate()])
        p = DTensor.from_local(torch.empty(64, 128), fake_mesh, [Replicate(), Partial()])
        with OpCounter() as ar:
            p.redistribute(fake_mesh, [Replicate(), Replicate()])
        with OpCounter() as rs:
            p.redistribute(fake_mesh, [Replicate(), Shard(0)])
    assert ag.by_kind["all-gather"] == 64 * 128 * 4  # the gathered result
    assert ar.by_kind["all-reduce"] == 2 * 64 * 128 * 4  # twice the operand
    assert rs.by_kind["reduce-scatter"] == 64 * 128 * 4  # the operand
    assert ag.flops == ar.flops == 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("causal,window,s,t", [(True, None, 128, 128), (True, 32, 96, 96),
                                               (False, None, 40, 64), (True, None, 1, 77)])
def test_k4_operator_counts_its_formula(causal, window, s, t):
    smoke = _chip_smoke()
    b, h, kv, d = 2, 4, 2, 16
    want = smoke.attn_work(b, h, kv, s, t, d, causal, window, torch.float32)[0]
    assert attention_flops((b, h, s, d), (b, kv, t, d), causal, window) == want
    with FakeTensorMode():
        q, k, v = torch.empty(b, h, s, d), torch.empty(b, kv, t, d), torch.empty(b, kv, t, d)
        with OpCounter() as c:
            out = flash_attention_op(q, k, v, causal, window)
    assert c.flops == want and tuple(out.shape) == (b, h, s, d)


def test_k5_and_k1_operators_count_their_formulas():
    smoke = _chip_smoke()
    b, s, h, g, p, n, chunk = 2, 200, 4, 1, 16, 8, 64
    want = smoke.ssd_work(b, s, h, g, p, n, chunk, torch.float32)[0]
    assert ssd_flops((b, s, h, p), (b, s, g, n), chunk) == want
    x_shape, w_shape = (4, 16, 16, 3), (5, 5, 3, 32)
    want_conv = smoke.conv_work("conv2d_fwd", 4, 16, 16, 3, 32, 5, torch.float32)[0]
    assert conv_flops(x_shape, w_shape) == want_conv
    with FakeTensorMode():
        with OpCounter() as c5:
            y, st = ssd_op(torch.empty(b, s, h, p), torch.empty(b, s, h), torch.empty(h),
                           torch.empty(b, s, g, n), torch.empty(b, s, g, n), chunk)
        with OpCounter() as c1:
            out = conv2d_op(torch.empty(x_shape), torch.empty(w_shape))
    assert c5.flops == want and tuple(st.shape) == (b, h, p, n)
    assert c1.flops == want_conv and tuple(out.shape) == (4, 16, 16, 32)


def test_k2_and_k3_operators_count_their_formulas():
    smoke = _chip_smoke()
    b, h, w, cin, cout, k = 4, 16, 16, 8, 32, 5
    want = smoke.conv_work("conv2d_dx", b, h, w, cin, cout, k, torch.float32)[0]
    with FakeTensorMode():
        with OpCounter() as c2:
            dx = conv2d_dx_op(torch.empty(b, h, w, cout), torch.empty(k, k, cin, cout))
        with OpCounter() as c3:
            dw = conv2d_dw_op(torch.empty(b, h, w, cin), torch.empty(b, h, w, cout), k, k)
    assert c2.flops == c3.flops == want
    assert tuple(dx.shape) == (b, h, w, cin) and tuple(dw.shape) == (k, k, cin, cout)
    assert dw.dtype == torch.float32


def test_custom_operators_run_the_plain_versions_on_cpu_tensors():
    """On CPU tensors the operators compute (their plain versions), the
    same numbers as the reference functions."""
    from repro_torch.kernels.ref import conv2d_ref, flash_attention_ref

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 8, 4, generator=g) for _ in range(3))
    np.testing.assert_array_equal(flash_attention_op(q, k, v, True, None).numpy(),
                                  flash_attention_ref(q, k, v, causal=True).numpy())
    x, w = torch.randn(1, 6, 6, 2, generator=g), torch.randn(3, 3, 2, 4, generator=g)
    np.testing.assert_array_equal(conv2d_op(x, w).numpy(), conv2d_ref(x, w).numpy())


def test_roofline_terms_use_the_h100():
    assert (HW.peak_flops, HW.hbm_bw, HW.link_bw) == (989e12, 3.35e12, 450e9)
    r = RooflineReport("a", "s", "16x16", "megatron", 256, flops_per_device=989e12,
                       bytes_per_device=3.35e12 / 2, collective_bytes_per_device=450e9 * 2,
                       collective_breakdown={}, model_flops=989e12 * 256 * 0.5)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 0.5, 2.0)
    assert r.dominant == "collective" and r.bound_s == 2.0
    assert r.useful_flops_ratio == 0.5 and r.mfu_upper_bound == 0.25
