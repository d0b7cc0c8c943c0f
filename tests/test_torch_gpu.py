"""The port on the card: the hand-written CUDA kernels (forward K1, dX
K2, dW K3, flash attention K4, SSD scan K5) against their plain PyTorch
versions, the ``cuda`` backend serving and running the backward through
the cluster, and the model zoo's prefill and decode through K4 and K5
(the MoE, VLM and encoder-decoder families included).

Every test here is marked ``gpu`` and skips without a CUDA card (the
kernels have no CPU mode; their arithmetic is held against the JAX
package on the CPU by tests/test_torch_kernels.py).  The file imports neither
jax nor the JAX package, so it runs on a machine that has neither:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are tests/test_kernels.py's: fp32 atol 2e-4, bf16 atol 5e-2,
both with rtol 0.05 (10x the atol for the SSD scan).  K4 and K5 compute
in fp32 and round a bf16 output once, so theirs is held against the
float64 plain version rounded to bf16 (``BF16_OUT_TOL``): at most one bf16
step (2^-7 of the value) apart, which rtol 1e-2 holds.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core.backends import get_backend
from repro_torch.core.cluster.cluster import HeteroCluster
from repro_torch.kernels.conv2d import (
    Conv2dFunction,
    conv2d,
    conv2d_dw,
    conv2d_dx,
    dw_plan,
    dx_plan,
    fwd_plan,
)
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.ref import (
    conv2d_dw_ref,
    conv2d_dx_ref,
    conv2d_ref,
    flash_attention_ref,
    ssd_chunked_ref,
)
from repro_torch.kernels.ssd import ssd
from repro_torch.launch.hetero import relu_pool
from repro_torch.serve.server import ClusterServer

pytestmark = pytest.mark.gpu

TOL = {"float32": (torch.float32, 2e-4), "bfloat16": (torch.bfloat16, 5e-2)}
BF16_OUT_TOL = (1e-3, 1e-2)  # (atol, rtol) against a reference rounded to bf16
SHAPES = [
    (1, 8, 8, 3, 16, 3),
    (2, 16, 16, 8, 24, 5),
    (2, 32, 32, 3, 50, 5),
    (1, 16, 16, 50, 40, 5),
    (2, 8, 8, 4, 0, 3),          # 0 kernels: no launch
    (2, 1, 8, 4, 8, 5),          # a one-row strip
    (2, 8, 8, 6, 21, 5),         # Cout not a multiple of the tile
    (4, 32, 32, 3, 500, 5),      # C1 at full width
    (4, 16, 16, 500, 1500, 5),   # C2 at full width
] + [
    # ResNet-50's convs on a microbatch of 32 (models/resnet.py runs each
    # at stride 1): conv1 7x7 over Cin 3 at 224x224; 1x1 convs of every
    # stage, Cin 64 to 2048, Cout 64 to 2048 (a projection, a 2a, a 2c,
    # conv3_1's subsampled 2a); conv5_x's 3x3 at 7x7
    (32, 224, 224, 3, 64, 7), (32, 56, 56, 64, 256, 1), (32, 56, 56, 256, 64, 1),
    (32, 28, 28, 256, 128, 1), (32, 14, 14, 1024, 256, 1), (32, 7, 7, 512, 2048, 1),
    (32, 7, 7, 2048, 512, 1), (32, 7, 7, 1024, 2048, 1), (32, 7, 7, 512, 512, 3),
]
# the backward's extra cases: a 7-row strip, ragged Cout, no pixels
BWD_SHAPES = SHAPES + [
    (4, 7, 16, 500, 1500, 5),
    (4, 16, 16, 500, 437, 5),
    (0, 16, 16, 8, 12, 5),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(b, h, w, cin, cout, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wk = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    return x, wk


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("b,h,w,cin,cout,k", SHAPES)
def test_kernel_matches_plain_version(dev, b, h, w, cin, cout, k, dtype):
    tdtype, atol = TOL[dtype]
    x, wk = _inputs(b, h, w, cin, cout, k)
    tx = torch.from_numpy(x).to(dev).to(tdtype)
    tw = torch.from_numpy(wk).to(dev).to(tdtype)
    before = conv2d.launches
    got = conv2d(tx, tw)
    torch.cuda.synchronize()
    assert conv2d.launches == before + (1 if got.numel() else 0)
    assert got.dtype == tdtype and tuple(got.shape) == (b, h, w, cout)
    want = conv2d_ref(tx.float(), tw.float())
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=0.05)


def test_kernel_takes_a_sliced_weight_shard(dev):
    """The cluster slices kernel shards on the last axis: a
    non-contiguous weight view gives the contiguous copy's result."""
    x, wk = _inputs(2, 8, 8, 5, 12, 3)
    tx, tw = torch.from_numpy(x).to(dev), torch.from_numpy(wk).to(dev)
    shard = tw[..., 3:9]
    assert not shard.is_contiguous()
    torch.testing.assert_close(conv2d(tx, shard), conv2d(tx, shard.contiguous()))


def test_kernel_refuses_what_it_does_not_take(dev):
    x = torch.zeros((1, 4, 4, 3), device=dev)
    with pytest.raises(ValueError, match="odd kernels"):
        conv2d(x, torch.zeros((2, 2, 3, 4), device=dev))
    with pytest.raises(TypeError, match="float32 or both bfloat16"):
        conv2d(x, torch.zeros((3, 3, 3, 4), device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="one CUDA device"):
        conv2d(x, torch.zeros((3, 3, 3, 4)))


def test_cuda_backend_serves_through_the_cluster(dev):
    rng = np.random.default_rng(2)
    kernels = [(rng.standard_normal((5, 5, 3, 6)) * 0.1).astype(np.float32),
               (rng.standard_normal((5, 5, 6, 10)) * 0.1).astype(np.float32)]
    fc = (rng.standard_normal((2 * 2 * 10, 10)) * 0.1).astype(np.float32)
    images = [rng.standard_normal((8, 8, 3)).astype(np.float32) for _ in range(6)]
    cluster = HeteroCluster([1.0, 1.0, 1.0], backends=["cuda", "cuda", "numpy"],
                            pipeline=True)
    cluster.probe_times = [1.0, 1.0, 1.0]
    server = ClusterServer(cluster, kernels, between=[relu_pool, relu_pool],
                           head=lambda z: z.reshape(z.shape[0], -1) @ fc,
                           max_batch=4)
    before = conv2d.launches
    try:
        with server:
            resps = [f.result(timeout=120) for f in
                     [server.submit(x) for x in images]]
    finally:
        cluster.shutdown()
    assert [r.status for r in resps] == ["ok"] * len(images)
    assert conv2d.launches > before
    z = np.stack(images)
    numpy_backend = get_backend("numpy")
    for w in kernels:
        z = relu_pool(numpy_backend.conv(z, w))
    np.testing.assert_allclose(np.stack([r.output for r in resps]),
                               z.reshape(len(images), -1) @ fc, atol=1e-4, rtol=0)


def _bwd_inputs(dev, b, h, w, cin, cout, k, dtype):
    rng = np.random.default_rng([b, h, w, cin, cout, k])
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin)).astype(np.float32))
    wk = torch.from_numpy((rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, h, w, cout)).astype(np.float32))
    return (t.to(dev).to(dtype) for t in (x, wk, g))


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("b,h,w,cin,cout,k", BWD_SHAPES)
def test_dx_kernel_matches_plain_version(dev, b, h, w, cin, cout, k, dtype):
    tdtype, atol = TOL[dtype]
    _, tw, tg = _bwd_inputs(dev, b, h, w, cin, cout, k, tdtype)
    before = conv2d_dx.launches
    got = conv2d_dx(tg, tw)
    torch.cuda.synchronize()
    assert conv2d_dx.launches == before + (1 if got.numel() and cout else 0)
    assert got.dtype == tdtype and tuple(got.shape) == (b, h, w, cin)
    want = conv2d_dx_ref(tg.float(), tw.float())
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=0.05)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("b,h,w,cin,cout,k", BWD_SHAPES)
def test_dw_kernel_matches_plain_version(dev, b, h, w, cin, cout, k, dtype):
    tdtype, atol = TOL[dtype]
    tx, _, tg = _bwd_inputs(dev, b, h, w, cin, cout, k, tdtype)
    before = conv2d_dw.launches
    got = conv2d_dw(tx, tg, k, k)
    torch.cuda.synchronize()
    assert conv2d_dw.launches == before + (1 if got.numel() and b else 0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (k, k, cin, cout)
    want = conv2d_dw_ref(tx.float(), tg.float(), k, k)
    torch.testing.assert_close(got, want, atol=atol, rtol=0.05)
    if b == 0:
        assert torch.count_nonzero(got) == 0


@pytest.mark.parametrize("shape", [(8, 32, 32, 3, 500, 5), (8, 16, 16, 500, 1500, 5)])
def test_dw_kernel_reruns_bit_identical(dev, shape):
    """No float atomics: the split-K partial sums reduce in a fixed
    order, so a rerun gives the same bits (both shapes split the pixel
    axis)."""
    tx, _, tg = _bwd_inputs(dev, *shape, torch.float32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert dw_plan(tx.shape, 5, 5, shape[4], 4, sms).splits > 1
    assert torch.equal(conv2d_dw(tx, tg, 5, 5), conv2d_dw(tx, tg, 5, 5))


# the main path's shard shapes of K1 and K3: serving (4 images) and
# training (8) shards of C2 and C1; Cout 363 is not a multiple of 4, so
# w and g rows take the 4-byte copies
MAIN_PATH_SHARDS = [
    (4, 16, 16, 500, 449, 5), (4, 16, 16, 500, 544, 5), (8, 16, 16, 500, 459, 5),
    (8, 16, 16, 500, 363, 5), (4, 32, 32, 3, 165, 5), (8, 32, 32, 3, 175, 5),
]


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("b,h,w,cin,cout,k", MAIN_PATH_SHARDS)
def test_fwd_and_dw_kernels_on_main_path_shards(dev, b, h, w, cin, cout, k, dtype):
    tdtype, atol = TOL[dtype]
    tx, tw, tg = _bwd_inputs(dev, b, h, w, cin, cout, k, tdtype)
    before = (conv2d.launches, conv2d_dw.launches)
    y = conv2d(tx, tw)
    dw = conv2d_dw(tx, tg, k, k)
    torch.cuda.synchronize()
    assert (conv2d.launches, conv2d_dw.launches) == tuple(n + 1 for n in before)
    torch.testing.assert_close(y.float(), conv2d_ref(tx.float(), tw.float()), atol=atol,
                               rtol=0.05)
    torch.testing.assert_close(dw, conv2d_dw_ref(tx.float(), tg.float(), k, k), atol=atol,
                               rtol=0.05)


def _offset_view(t, offset):
    """``t``'s values in a tensor whose storage starts ``offset`` elements
    into a larger buffer: contiguous, but its base address is not 16-byte
    aligned for an odd ``offset``."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


# K1's and K3's copy paths: rows of a multiple of 4 floats (K3's x and g,
# K1's w) take 16-byte cp.async copies, others 4-byte ones, and so does a
# row whose base address is not 16-byte aligned (offset 1); K1 copies x 4
# bytes at a time into its transposed slab
@pytest.mark.parametrize("cin,cout", [(8, 24), (8, 21), (6, 24), (6, 21), (12, 132)])
@pytest.mark.parametrize("offset", [0, 1])
def test_fwd_and_dw_kernels_take_every_copy_path(dev, cin, cout, offset):
    tx, tw, tg = _bwd_inputs(dev, 2, 9, 11, cin, cout, 5, torch.float32)
    x_, w_, g_ = (_offset_view(t, offset) for t in (tx, tw, tg))
    assert (x_.data_ptr() % 16 == 0) == (offset == 0)
    torch.testing.assert_close(conv2d(x_, w_), conv2d_ref(tx, tw), atol=2e-4, rtol=0.05)
    torch.testing.assert_close(conv2d_dw(x_, g_, 5, 5), conv2d_dw_ref(tx, tg, 5, 5),
                               atol=2e-4, rtol=0.05)


@pytest.mark.parametrize("shape", [(4, 16, 16, 500, 449, 5), (8, 16, 16, 500, 459, 5)])
def test_fwd_kernel_splits_the_taps_and_reruns_bit_identical(dev, shape):
    """The serving and training C2 shards split K1's taps; the splits
    reduce in a fixed order, so a rerun gives the same bits."""
    tx, tw, _ = _bwd_inputs(dev, *shape, torch.float32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert fwd_plan(tx.shape, 5, 5, shape[4], 4, sms).splits > 1
    y = conv2d(tx, tw)
    assert torch.equal(y, conv2d(tx, tw))
    torch.testing.assert_close(y, conv2d_ref(tx, tw), atol=2e-4, rtol=0.05)


def test_kernel_takes_a_weight_shard_of_the_c2_layer(dev):
    """A shard sliced from the full C2 weight on its last axis, as the
    kernel-axis partition hands it to a device (Cout 449)."""
    tx, tw, _ = _bwd_inputs(dev, 4, 16, 16, 500, 1500, 5, torch.float32)
    shard = tw[..., 100:549]
    assert not shard.is_contiguous()
    torch.testing.assert_close(conv2d(tx, shard), conv2d_ref(tx, shard), atol=2e-4,
                               rtol=0.05)


# K2's variants: Cin on both sides of the small-Cin boundary (16), and a
# small-M, large-K shape (16 pixels, K = 25 * 1500) that splits the taps
DX_CIN_SHAPES = [(2, 9, 11, cin, 24, 5) for cin in (1, 3, 4, 5, 16, 17, 64, 65)] + [
    (1, 4, 4, 40, 1500, 5),
]


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("b,h,w,cin,cout,k", DX_CIN_SHAPES)
def test_dx_kernel_variants_match_plain_version(dev, b, h, w, cin, cout, k, dtype):
    tdtype, atol = TOL[dtype]
    _, tw, tg = _bwd_inputs(dev, b, h, w, cin, cout, k, tdtype)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = dx_plan(tg.shape, k, k, cin, tg.element_size(), sms)
    assert plan.variant == ("small_cin" if cin <= 16 else "tiled")
    if h * w == 16:
        assert plan.splits > 1
    before = conv2d_dx.launches
    got = conv2d_dx(tg, tw)
    torch.cuda.synchronize()
    assert conv2d_dx.launches == before + 1
    assert got.dtype == tdtype and tuple(got.shape) == (b, h, w, cin)
    want = conv2d_dx_ref(tg.float(), tw.float())
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=0.05)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("shape", [(8, 32, 32, 3, 167, 5), (8, 16, 16, 500, 500, 5)])
def test_dx_kernel_reruns_bit_identical(dev, shape, dtype):
    """The training path's C1 and C2 microbatch shards take the split-K
    path (C1 the small-Cin variant too); the splits reduce in a fixed
    order, so a rerun gives the same bits."""
    _, tw, tg = _bwd_inputs(dev, *shape, TOL[dtype][0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = dx_plan(tg.shape, 5, 5, shape[3], tg.element_size(), sms)
    assert plan.splits > 1 and plan.variant == ("small_cin" if shape[3] <= 16 else "tiled")
    assert torch.equal(conv2d_dx(tg, tw), conv2d_dx(tg, tw))


# the training path's dX shards: 8-image microbatches of C2 (Cin 500,
# the tiled variant) and C1 (Cin 3, the small-Cin variant) with the Cout
# of a device's Eq. 1 share, as chip runs have seen them
DX_TRAIN_SHARDS = (
    [(8, 16, 16, 500, cout, 5) for cout in (297, 336, 363, 382, 407, 444, 459, 476, 487)]
    + [(8, 32, 32, 3, cout, 5) for cout in (106, 112, 127, 136, 148, 154, 159)]
)


@pytest.mark.parametrize("b,h,w,cin,cout,k", DX_TRAIN_SHARDS)
def test_dx_kernel_on_train_path_shards(dev, b, h, w, cin, cout, k):
    _, tw, tg = _bwd_inputs(dev, b, h, w, cin, cout, k, torch.float32)
    got = conv2d_dx(tg, tw)
    torch.testing.assert_close(got, conv2d_dx_ref(tg, tw), atol=2e-4, rtol=0.05)
    assert torch.equal(got, conv2d_dx(tg, tw))


def test_conv2d_function_matches_plain_autograd(dev):
    tx, tw, tg = _bwd_inputs(dev, 2, 8, 8, 6, 10, 5, torch.float32)
    x1, w1 = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    x2, w2 = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    before = (conv2d.launches, conv2d_dx.launches, conv2d_dw.launches)
    y1 = Conv2dFunction.apply(x1, w1)
    got = torch.autograd.grad(y1, (x1, w1), tg)
    assert (conv2d.launches, conv2d_dx.launches, conv2d_dw.launches) == tuple(
        n + 1 for n in before)
    want = torch.autograd.grad(conv2d_ref(x2, w2), (x2, w2), tg)
    torch.testing.assert_close(y1, conv2d_ref(tx, tw), atol=2e-4, rtol=0.05)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=0.05)


@pytest.mark.parametrize("partition", ["kernel", "spatial", "batch"])
def test_cuda_backend_backward_through_the_cluster(dev, partition):
    """The cluster's backward with a ``cuda`` device (K2 + K3 on its
    shard) reassembles the ``torch:cpu`` backend's VJP."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    w = (rng.standard_normal((5, 5, 3, 6)) * 0.1).astype(np.float32)
    g = rng.standard_normal((4, 8, 8, 6)).astype(np.float32)
    cluster = HeteroCluster([1.0, 1.0], backends=["cuda", "torch:cpu"],
                            partition=partition)
    before = (conv2d_dx.launches, conv2d_dw.launches)
    try:
        cluster.probe_times = [1.0, 1.0]
        dx, dw = cluster.conv_backward(x, w, g)
    finally:
        cluster.shutdown()
    assert conv2d_dx.launches > before[0] and conv2d_dw.launches > before[1]
    dx_want, dw_want = get_backend("torch:cpu").conv_vjp(x, w, g)
    np.testing.assert_allclose(dx, dx_want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(dw, dw_want, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("b,h,w,cin,cout,k", [(2, 16, 16, 8, 24, 5), (4, 32, 32, 3, 500, 5),
                                             (4, 16, 16, 500, 1500, 5), (2, 8, 8, 4, 0, 3)])
def test_cuda_backend_on_card_operands_equals_its_numpy_path(dev, b, h, w, cin, cout, k):
    """Tensors on the card in, tensors on the card out, bitwise the numpy
    path's (the same kernels on the same operands)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    g = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    backend = get_backend("cuda")
    y = backend.conv(x, wt)
    dx, dw = backend.conv_vjp(x, wt, g)
    on = [torch.from_numpy(a).to(dev) for a in (x, wt, g)]
    ty = backend.conv(on[0], on[1])
    tdx, tdw = backend.conv_vjp(*on)
    for a, t in ((y, ty), (dx, tdx), (dw, tdw)):
        assert isinstance(a, np.ndarray) and t.device == dev
        np.testing.assert_array_equal(a, t.cpu().numpy())


def _cuda_steps(dev, backends, card, steps=3, batch=8):
    """``make_cluster_train_step`` at C1 8, C2 16 from seed-0 params, with
    pinned probe times and no comp-aware discount: the card path, or the
    host path (the same master handed numpy)."""
    from repro_torch.models.cnn import init_cnn, make_cluster_train_step, make_cnn_config

    cfg = make_cnn_config(8, 16)
    params = init_cnn(torch.Generator().manual_seed(0), cfg, dev)
    rng = np.random.default_rng(4)
    c = HeteroCluster([1.0] * len(backends), backends, pipeline=True, microbatches=2,
                      comp_aware=False)
    try:
        c.probe_times = [1.0, 2.0][:len(backends)]
        if not card:
            c.master_device = None
        step = make_cluster_train_step(c, cfg, lr=0.05, device="cuda")
        losses = []
        for _ in range(steps):
            x = rng.standard_normal((batch, 32, 32, 3), dtype=np.float32)
            y = rng.integers(0, 10, batch).astype(np.int32)
            params, loss, _ = step(params, x, y)
            losses.append(loss)
    finally:
        c.shutdown()
    return losses, {f"{l}.{n}": v.cpu().numpy() for l, d in params.items()
                    for n, v in d.items()}


@pytest.mark.parametrize("backends", [["cuda"], ["cuda", "numpy"]])
def test_a_cuda_master_step_on_the_card_path_equals_the_host_path(dev, backends):
    """The master's shard on card tensors: the same kernels on the same
    operands, the same float32 sums in the same order, so three steps
    are bitwise the host path's."""
    assert get_backend("cuda").device == dev
    card_losses, card = _cuda_steps(dev, backends, card=True)
    host_losses, host = _cuda_steps(dev, backends, card=False)
    assert card_losses == host_losses
    for k in host:
        np.testing.assert_array_equal(card[k], host[k], err_msg=k)


def test_a_cuda_master_s_layer_probe_times_its_card_tensors(dev):
    """On the card path a cuda master's Eq. 1 probe of conv2 (batch 8)
    runs on tensors on the card: its span reads ``operands="card"``, no
    ``cuda.to_card`` falls inside it, and it takes less than the same
    geometry's probe on numpy operands, which copies x and w over and y
    back each call."""
    import time

    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import spans

    x_shape, w_shape = (8, 16, 16, 500), (5, 5, 500, 1500)
    c = HeteroCluster([1.0, 1.0], ["cuda", "numpy"], comp_aware=False)
    try:
        c.probe(image_size=32, in_channels=3, kernel_size=5, num_kernels=500, batch=8)
        on_card, on_host = torch.zeros(x_shape, device=dev), np.zeros(x_shape, np.float32)
        spans.record("test.off", time.perf_counter(), time.perf_counter())
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)):
            card = c.layer_probe(on_card, w_shape)
            host = c.layer_probe(on_host, w_shape)
        sp = spans.spans()
    finally:
        c.shutdown()
    probes = [s for s in sp if s.name == "cluster.layer_probe"]
    assert [(s.attrs["device"], s.attrs["operands"]) for s in probes] == [
        (0, "card"), (1, "host"), (0, "host"), (1, "host")]
    master = probes[0]
    copies = [s for s in sp if s.name == "cuda.to_card"]
    assert copies  # the host probe's copies
    assert not [s for s in copies
                if master.start_ns <= s.start_ns and s.end_ns <= master.end_ns]
    assert card.times[0] < host.times[0]


def test_cuda_hierarchy_matches_float64_and_reruns_bit_identical(dev):
    """An in-process ``HierarchicalCluster("2x2")`` whose five devices all
    take the default ``cuda`` backend, at tests/test_hierarchy.py's
    shapes: the two-tier VJP of conv -> ReLU -> conv (K1, K2, K3 in every
    group) against float64 ``conv2d_ref`` autograd at the hierarchy
    tests' tolerance, and a second step on the same fixed plans gives
    the same bits (K2 and K3 sum in a fixed order)."""
    from repro_torch.core.cluster.hierarchy import HierarchicalCluster

    rng = np.random.default_rng(7)
    x = rng.normal(size=(8, 8, 8, 3)).astype(np.float32)
    w1 = rng.normal(size=(3, 3, 3, 6)).astype(np.float32)
    w2 = rng.normal(size=(3, 3, 6, 9)).astype(np.float32)
    g = rng.normal(size=(8, 8, 8, 9)).astype(np.float32)
    tx, t1, t2 = (torch.from_numpy(a).to(dev, torch.float64).requires_grad_()
                  for a in (x, w1, w2))
    y2 = conv2d_ref(torch.relu(conv2d_ref(tx, t1)), t2)
    want = torch.autograd.grad((y2 * torch.from_numpy(g).to(dev, torch.float64)).sum(),
                               (tx, t1, t2))
    c = HierarchicalCluster("2x2", microbatches=2, comp_aware=False)
    before = (conv2d.launches, conv2d_dx.launches, conv2d_dw.launches)
    try:
        assert c.backends == ["cuda"] * 3
        c.probe_times = [1.0, 1.0, 1.0]
        for inner in c.group_clusters:
            assert inner.backends == ["cuda", "cuda"]
            inner.comp_aware = False
            inner.probe_times = [1.0, 1.0]

        def between(y):
            mask = (y > 0).astype(np.float32)
            return np.maximum(y, 0.0), lambda gz: gz * mask

        slices = c.microbatch_slices(x.shape[0])
        runs = [c.conv_train_chain(x, [w1, w2], [between, None],
                                   lambda z, i: (None, g[slices[i]]))
                for _ in range(2)]
    finally:
        c.shutdown()
    after = (conv2d.launches, conv2d_dx.launches, conv2d_dw.launches)
    assert all(a > b for a, b in zip(after, before)), (before, after)
    for res in runs:
        for got, ref in zip((res.dx, res.dw[0], res.dw[1]), want):
            np.testing.assert_allclose(got, ref.cpu().numpy(), rtol=1e-4, atol=1e-3)
    for a, b in zip((runs[0].dx, *runs[0].dw), (runs[1].dx, *runs[1].dw)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# K4 (flash attention) and K5 (SSD scan), and the model zoo's serving path

ATTN_SHAPES = [  # (B, H, KV, S, T, D)
    (2, 2, 2, 32, 32, 16), (2, 2, 2, 48, 80, 32), (2, 2, 2, 17, 33, 8),
    (2, 6, 2, 40, 70, 64),    # GQA
    (1, 25, 5, 300, 300, 64),  # hymba's heads, a ragged S
    (2, 4, 4, 1, 200, 128),    # one query (decode-like) at head_dim 128
]
SSD_SHAPES = [  # (B, S, H, G, P, N, chunk)
    (2, 32, 2, 2, 8, 4, 8), (2, 48, 3, 3, 16, 8, 16), (2, 25, 1, 1, 4, 4, 8),
    (2, 300, 50, 1, 64, 16, 256),  # hymba's heads, a ragged last chunk
    (1, 70, 4, 2, 32, 128, 64),    # mamba2-370m's d_state, grouped B/C
    (2, 9, 2, 1, 16, 4, 256),      # shorter than one chunk
    (4, 2048, 50, 1, 64, 16, 256),  # hymba's prefill: 8 chunks of 4 row tiles
    (2, 700, 6, 6, 64, 16, 256),    # G = H, a ragged last chunk of 188 steps
    (1, 100, 3, 1, 64, 16, 256),    # S < L at hymba's widths
    (2, 600, 4, 2, 20, 16, 256),    # P = 20, padded to 32
]


def _attn_inputs(dev, dtype, b, h, kv, s, t, d, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
            for shape in ((b, h, s, d), (b, kv, t, d), (b, kv, t, d))]


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("causal,window", [(True, None), (True, 16), (False, 16),
                                           (False, None)])
@pytest.mark.parametrize("b,h,kv,s,t,d", ATTN_SHAPES)
def test_flash_attention_matches_plain_version(dev, b, h, kv, s, t, d, causal, window,
                                               dtype):
    tdtype, atol = TOL[dtype]
    q, k, v = _attn_inputs(dev, tdtype, b, h, kv, s, t, d)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == tdtype and tuple(got.shape) == (b, h, s, d)
    want = flash_attention_ref(q.double(), k.double(), v.double(), causal=causal,
                               window=window)
    rtol = 0.05
    if tdtype == torch.bfloat16:
        want, (atol, rtol) = want.to(tdtype).double(), BF16_OUT_TOL
    torch.testing.assert_close(got.double(), want, atol=atol, rtol=rtol)


def test_flash_attention_reads_strided_views(dev):
    """The model passes (B, S, H, D) projections as transposed views."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
               for shape in ((2, 50, 6, 32), (2, 50, 3, 32), (2, 50, 3, 32)))
    got = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=True, window=20)
    want = flash_attention(*(x.transpose(1, 2).contiguous() for x in (q, k, v)),
                           causal=True, window=20)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# the bf16 tensor-core kernel's edges: D 20 (not a multiple of 8, so the
# scalar-load path), S 130 with hymba's GQA 25/5, one query against 1024 keys
BF16_ATTN_SHAPES = [(2, 2, 2, 40, 70, 20), (1, 25, 5, 130, 130, 64),
                    (1, 25, 5, 1, 1024, 64)]


@pytest.mark.parametrize("causal,window", [(True, None), (True, 16), (False, None)])
@pytest.mark.parametrize("b,h,kv,s,t,d", BF16_ATTN_SHAPES)
def test_flash_attention_bf16_edges_match_plain_version(dev, b, h, kv, s, t, d, causal,
                                                        window):
    q, k, v = _attn_inputs(dev, torch.bfloat16, b, h, kv, s, t, d, seed=3)
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = flash_attention_ref(q.double(), k.double(), v.double(), causal=causal,
                               window=window).to(torch.bfloat16).double()
    torch.testing.assert_close(got.double(), want, atol=BF16_OUT_TOL[0],
                               rtol=BF16_OUT_TOL[1])


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_flash_attention_reads_unaligned_row_strides(dev, dtype):
    """Views whose row stride (70 elements per head) is not a multiple of
    16 bytes: the bf16 kernel loads them with scalar loads into the same
    layout, and both dtypes give the contiguous copy's bits."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(dev, TOL[dtype][0])[..., :64].transpose(1, 2)
               for shape in ((2, 90, 10, 70), (2, 90, 5, 70), (2, 90, 5, 70)))
    assert q.stride(2) % 8 and k.stride(1) % 8
    got = flash_attention(q, k, v, causal=True, window=32)
    want = flash_attention(*(x.contiguous() for x in (q, k, v)), causal=True, window=32)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_flash_attention_refuses_what_it_does_not_take(dev):
    q = torch.zeros((1, 2, 4, 8), device=dev)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention(q, q.cpu(), q)
    with pytest.raises(TypeError, match="float32 or all"):
        flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(TypeError, match="float32 or all"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="T >= S"):
        flash_attention(q, q[:, :, :3], q[:, :, :3])
    with pytest.raises(ValueError, match="KV dividing H"):
        flash_attention(torch.zeros((1, 3, 4, 8), device=dev), q, q)


# the model zoo's new shapes for K4: head_dim 128 with GQA 32/8 under a
# window (llava), whisper's non-causal encoder (S = T = 1500), its
# cross-attention (S < T), and more queries than keys without masks (a
# prompt longer than the encoder's frames)
ZOO_ATTN_CASES = [  # (B, H, KV, S, T, D, causal, window)
    (1, 32, 8, 600, 600, 128, True, 256),
    (1, 16, 16, 1500, 1500, 64, False, None),
    (2, 16, 16, 224, 1500, 64, False, None),
    (2, 16, 16, 300, 100, 64, False, None),
    (1, 4, 4, 130, 7, 128, False, None),
]


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window", ZOO_ATTN_CASES)
def test_flash_attention_zoo_shapes_match_plain_version(dev, b, h, kv, s, t, d, causal,
                                                        window, dtype):
    tdtype, atol = TOL[dtype]
    q, k, v = _attn_inputs(dev, tdtype, b, h, kv, s, t, d, seed=5)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q.double(), k.double(), v.double(), causal=causal,
                               window=window)
    rtol = 0.05
    if tdtype == torch.bfloat16:
        want, (atol, rtol) = want.to(tdtype).double(), BF16_OUT_TOL
    torch.testing.assert_close(got.double(), want, atol=atol, rtol=rtol)


def test_flash_attention_refuses_more_queries_than_keys_under_a_mask(dev):
    q = torch.zeros((1, 2, 9, 8), device=dev)
    k = q[:, :, :4]
    for causal, window in ((True, None), (False, 3)):
        with pytest.raises(ValueError, match="T >= S"):
            flash_attention(q, k, k, causal=causal, window=window)


@pytest.mark.parametrize("arch,per_layer", [("moonshot-v1-16b-a3b", 1),
                                            ("llava-next-mistral-7b", 1),
                                            ("whisper-medium", 3)])
def test_zoo_prefill_and_decode_on_the_card_match_the_plain_path(dev, arch, per_layer):
    """Reduced MoE, VLM and encoder-decoder models on the card: K4 once
    per attention of the prefill (whisper: encoder, decoder self- and
    cross-attention, each a layer group of 2), never in decode; logits
    and every cache entry against the same model with K4's plain version."""
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.launch.serve import make_batch
    from repro_torch.models.registry import build_model

    cfg = reduced_for_smoke(get_config(arch))
    api = build_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    batch = make_batch(cfg, seed=0, batch=2, prompt_len=40, device=dev)
    prompt = dict(batch, tokens=batch["tokens"][:, :30])
    before = flash_attention.launches
    logits, cache = api.prefill(params, prompt, cache_len=40)
    assert flash_attention.launches == before + per_layer * cfg.num_layers
    want, want_cache = api.prefill(params, prompt, cache_len=40,
                                   attention_fn=flash_attention_ref)
    torch.testing.assert_close(logits, want, atol=2e-3, rtol=2e-3)
    for key in sorted(set(cache) - {"t"}):
        torch.testing.assert_close(cache[key], want_cache[key], atol=2e-3, rtol=2e-3)
    mid = flash_attention.launches
    for t in range(30, 40):
        got, cache = api.decode_step(params, cache, batch["tokens"][:, t : t + 1])
        want, want_cache = api.decode_step(params, want_cache,
                                           batch["tokens"][:, t : t + 1])
        torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    assert flash_attention.launches == mid


def _ssd_inputs_on(dev, dtype, b, s, h, g, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32)).to(dev)
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32))).to(dev)
    a = -torch.exp(torch.from_numpy(rng.standard_normal(h).astype(np.float32)) * 0.5).to(dev)
    bm, cm = (torch.from_numpy(rng.standard_normal((b, s, g, n)).astype(np.float32)).to(dev)
              for _ in range(2))
    return x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("b,s,h,g,p,n,chunk", SSD_SHAPES)
def test_ssd_matches_plain_version(dev, b, s, h, g, p, n, chunk, dtype):
    """y and the fp32 final state against the plain version in float64,
    at 10x the fp32 kernel sweep's atol (tests/test_kernels.py's SSD
    rule); a bf16 y against the reference rounded to bf16."""
    tdtype, _ = TOL[dtype]
    atol = 10 * TOL["float32"][1]
    x, dt, a, bm, cm = _ssd_inputs_on(dev, tdtype, b, s, h, g, p, n)
    before = ssd.launches
    y, final = ssd(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    assert y.dtype == tdtype and tuple(y.shape) == (b, s, h, p)
    assert final.dtype == torch.float32 and tuple(final.shape) == (b, h, p, n)
    y_want, final_want = ssd_chunked_ref(x.double(), dt.double(), a.double(), bm.double(),
                                         cm.double(), min(chunk, s))
    y_rtol = 0.05
    if tdtype == torch.bfloat16:
        y_want, y_rtol = y_want.to(tdtype).double(), BF16_OUT_TOL[1]
    torch.testing.assert_close(y.double(), y_want, atol=atol, rtol=y_rtol)
    torch.testing.assert_close(final.double(), final_want, atol=atol, rtol=0.05)


def _projection_views(dev, dtype, b, s, h, g, p, n, cols, width, seed=0):
    """x, B and C as the model slices them from its in-projection: views
    of one (B, S, width) buffer starting at columns ``cols`` (x, B, C),
    so each is read through a row stride of ``width`` elements; an odd
    column or width leaves an operand's rows off 16 bytes."""
    x, dt, a, bm, cm = _ssd_inputs_on(dev, torch.float32, b, s, h, g, p, n, seed)
    buf = torch.zeros((b, s, width), dtype=dtype, device=dev)
    views = []
    for t, col in zip((x, bm, cm), cols):
        sl = buf[:, :, col : col + t.shape[2] * t.shape[3]]
        sl.copy_(t.reshape(b, s, -1))
        views.append(sl.view(t.shape))
    return views[0], dt, a, views[1], views[2]


# K5's copy paths, fp32: every operand 16-byte copies (aligned columns
# and row stride), then each of x, B and C alone on the 4-byte copies (a
# column off 16 bytes), then all of them (an odd row stride)
SSD_VIEW_CASES = {  # name: (columns of x, B, C; row width), at H 4, P 64, G 1, N 16
    "aligned": ((32, 0, 16), 288),
    "x unaligned": ((33, 0, 16), 292),
    "B unaligned": ((0, 257, 276), 292),
    "C unaligned": ((0, 256, 273), 292),
    "odd row stride": ((0, 256, 272), 289),
}


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("case", sorted(SSD_VIEW_CASES))
def test_ssd_reads_strided_projection_views(dev, case, dtype):
    tdtype, _ = TOL[dtype]
    cols, width = SSD_VIEW_CASES[case]
    x, dt, a, bm, cm = _projection_views(dev, tdtype, 2, 600, 4, 1, 64, 16, cols, width)
    assert x.stride(1) == bm.stride(1) == cm.stride(1) == width
    y, final = ssd(x, dt, a, bm, cm, chunk=256)
    y_want, final_want = ssd_chunked_ref(x.double(), dt.double(), a.double(), bm.double(),
                                         cm.double(), 256)
    atol, y_rtol = 10 * TOL["float32"][1], 0.05
    if tdtype == torch.bfloat16:
        y_want, y_rtol = y_want.to(tdtype).double(), BF16_OUT_TOL[1]
    torch.testing.assert_close(y.double(), y_want, atol=atol, rtol=y_rtol)
    torch.testing.assert_close(final.double(), final_want, atol=atol, rtol=0.05)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_ssd_reruns_bit_identical(dev, dtype):
    """Each chunk's state is summed and folded in a fixed order, without
    atomics: a rerun at hymba's prefill shape gives the same bits."""
    args = _ssd_inputs_on(dev, TOL[dtype][0], 4, 2048, 50, 1, 64, 16)
    y, final = ssd(*args, chunk=256)
    y2, final2 = ssd(*args, chunk=256)
    assert torch.equal(y, y2) and torch.equal(final, final2)


def _traced_grids(path, fn, calls=3):
    """The launch grids of each kernel ``fn`` runs on the card, by name,
    from the profiler's trace of ``calls`` calls written to ``path`` (a
    trace that follows another in the same process can lose its first
    kernel records)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    grids = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "kernel":
            grids.setdefault(e["name"], set()).add(tuple(e["args"]["grid"]))
    return grids


def test_ssd_tile_passes_launch_more_blocks_than_heads(dev, tmp_path):
    """K5 is chunk-parallel: at hymba's prefill each tile pass launches
    more blocks than the B * H = 200 of one block per (batch, head)."""
    args = _ssd_inputs_on(dev, torch.float32, 4, 2048, 50, 1, 64, 16)
    ssd(*args, chunk=256)  # built and warm outside the trace
    grids = _traced_grids(tmp_path / "trace.json", lambda: ssd(*args, chunk=256))
    for kernel in ("ssd_fwd_kernel", "ssd_out_kernel"):
        (found,) = [g for name, g in grids.items() if kernel in name]
        (grid,) = found
        assert grid[0] > 4 * 50 and grid[1:] == (1, 1), (kernel, grid)


def test_ssd_refuses_what_it_does_not_take(dev):
    x, dt, a, bm, cm = _ssd_inputs_on(dev, torch.float32, 1, 8, 2, 1, 4, 4)
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd(x, dt.cpu(), a, bm, cm)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        ssd(x, dt, a, bm.bfloat16(), cm)
    with pytest.raises(TypeError, match="dt and a must be float32"):
        ssd(x, dt.double(), a, bm, cm)
    with pytest.raises(ValueError, match="shared memory"):
        ssd(*_ssd_inputs_on(dev, torch.float32, 1, 512, 2, 1, 128, 256), chunk=512)


def test_lm_prefill_and_decode_on_the_card_match_the_plain_path(dev):
    """reduced hymba-1.5b on the card: K4 and K5 launched once per layer
    in the prefill and never in decode; logits and cache against the
    same model with the kernels' plain versions."""
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.models.registry import build_model

    cfg = reduced_for_smoke(get_config("hymba-1.5b"))
    api = build_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40))).to(dev)
    before = (flash_attention.launches, ssd.launches)
    logits, cache = api.prefill(params, {"tokens": toks[:, :30]}, cache_len=40)
    assert (flash_attention.launches, ssd.launches) == tuple(
        n + cfg.num_layers for n in before)
    plain = {"attention_fn": flash_attention_ref, "ssd_fn": ssd_chunked_ref}
    want, want_cache = api.prefill(params, {"tokens": toks[:, :30]}, cache_len=40, **plain)
    torch.testing.assert_close(logits, want, atol=2e-3, rtol=2e-3)
    for key in ("k", "v", "conv", "ssm"):
        torch.testing.assert_close(cache[key], want_cache[key], atol=2e-3, rtol=2e-3)
    mid = (flash_attention.launches, ssd.launches)
    for t in range(30, 40):
        got, cache = api.decode_step(params, cache, toks[:, t : t + 1])
        want, want_cache = api.decode_step(params, want_cache, toks[:, t : t + 1])
        torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    assert (flash_attention.launches, ssd.launches) == mid


# ---------------------------------------------------------------------------
# gradients through K4 and K5, and the train step on the card

GRAD_ATTN_CASES = [
    (2, 4, 2, 300, 300, 64, True, 64),    # a ragged last query tile, a window
    (1, 6, 2, 90, 200, 32, True, None),   # S < T, causal, GQA
    (2, 2, 2, 130, 70, 16, False, None),  # S > T, no mask
]


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window", GRAD_ATTN_CASES)
def test_flash_attention_gradients_on_the_card(dev, b, h, kv, s, t, d, causal, window,
                                               dtype):
    """With grad on, ``flash_attention`` runs K4 forward (one launch) and
    ``flash_attention_vjp`` backward (no launch); dq, dk, dv against
    float64 autograd through the plain version (bf16 gradients against
    the reference rounded to bf16: ``BF16_OUT_TOL``)."""
    tdtype, atol = TOL[dtype]
    gen = torch.Generator(device=dev).manual_seed(s + t)
    q, k, v = (torch.randn((b, n, heads, d), generator=gen, device=dev).to(tdtype)
               .transpose(1, 2).requires_grad_(True)
               for n, heads in ((s, h), (t, kv), (t, kv)))
    dout = torch.randn((b, h, s, d), generator=gen, device=dev).to(tdtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert out.grad_fn is not None and flash_attention.launches == before + 1
    out.backward(dout)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    refs = [x.detach().double().requires_grad_(True) for x in (q, k, v)]
    flash_attention_ref(*refs, causal=causal, window=window).backward(dout.double())
    for x, r in zip((q, k, v), refs):
        assert x.grad.dtype == tdtype and x.grad.shape == x.shape
        want, tol = r.grad, (2e-4, 0.05)
        if tdtype == torch.bfloat16:
            want, tol = want.to(tdtype).double(), BF16_OUT_TOL
        torch.testing.assert_close(x.grad.double(), want, atol=tol[0], rtol=tol[1])


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("b,s,h,g,p,n,chunk", [(2, 300, 4, 2, 32, 16, 128),
                                               (1, 700, 6, 6, 64, 16, 256)])
def test_ssd_gradients_on_the_card(dev, b, s, h, g, p, n, chunk, dtype):
    """With grad on, ``ssd`` runs K5 forward (one launch) and ``ssd_vjp``
    backward (no launch); every input gradient against float64 autograd
    through the plain version, at K5's 10x atol."""
    tdtype, atol = TOL[dtype]
    ins = [t.requires_grad_(True) for t in _ssd_inputs_on(dev, tdtype, b, s, h, g, p, n)]
    gen = torch.Generator(device=dev).manual_seed(s)
    dy = torch.randn((b, s, h, p), generator=gen, device=dev).to(tdtype)
    dstate = torch.randn((b, h, p, n), generator=gen, device=dev)
    before = ssd.launches
    y, state = ssd(*ins, chunk=chunk)
    assert ssd.launches == before + 1
    torch.autograd.backward((y, state), (dy, dstate))
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    refs = [t.detach().double().requires_grad_(True) for t in ins]
    torch.autograd.backward(ssd_chunked_ref(*refs, min(chunk, s)),
                            (dy.double(), dstate.double()))
    for x, r in zip(ins, refs):
        assert x.grad.dtype == x.dtype and x.grad.shape == x.shape
        want, tol = r.grad, (10 * 2e-4, 0.05)
        if x.dtype == torch.bfloat16:
            want, tol = want.to(torch.bfloat16).double(), (10 * 2e-4, BF16_OUT_TOL[1])
        torch.testing.assert_close(x.grad.double(), want, atol=tol[0], rtol=tol[1])


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_on_the_card_matches_the_plain_path(dev, remat):
    """Two steps of reduced hymba-1.5b on the card (sgd, 2
    microbatches): K4 and K5 each launched per layer per microbatch,
    twice under remat full; losses, grad norms and params against the
    same steps through the kernels' plain versions."""
    from repro_torch.configs import RunConfig, get_config, reduced_for_smoke
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    cfg = reduced_for_smoke(get_config("hymba-1.5b"))
    api = build_model(cfg)
    run = RunConfig(optimizer="sgd", learning_rate=0.1, grad_accum=2, remat=remat)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             zip(("tokens", "labels"),
                 np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 4, 64)))}
    plain = {"attention_fn": flash_attention_ref, "ssd_fn": ssd_chunked_ref}
    states = {}
    for path, fns in (("kernel", {}), ("plain", plain)):
        state = init_train_state(torch.Generator(device=dev).manual_seed(0), api, run, dev)
        step = make_train_step(api, run, **fns)
        before = (flash_attention.launches, ssd.launches)
        metrics = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        launched = (flash_attention.launches - before[0], ssd.launches - before[1])
        per_step = 2 * cfg.num_layers * (2 if remat == "full" else 1)
        assert launched == ((2 * per_step,) * 2 if path == "kernel" else (0, 0))
        states[path] = (state, metrics)
    (sk, mk), (sp, mp) = states["kernel"], states["plain"]
    for a, b in zip(mk, mp):
        assert np.isclose(a["loss"], b["loss"], rtol=1e-5)
        assert np.isclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
    for a, b in zip(tree_leaves(sk.params), tree_leaves(sp.params)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
