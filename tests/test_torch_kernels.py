"""The port's conv2d kernels (repro_torch/kernels) against the JAX
package's Pallas kernels: forward K1, dX K2 and dW K3.

The same numpy inputs, made from a seed, go through
``repro.kernels.conv2d``'s ``conv2d_pallas``, ``conv2d_dx_pallas`` and
``conv2d_dw_pallas`` in interpret mode (the kernel body runs in Python
on the CPU, as tests/test_kernels.py runs it) and through the port's
plain versions (``conv2d_ref``, ``conv2d_dx_ref``, ``conv2d_dw_ref``)
and kernel wrappers — which, given CPU tensors, run the plain versions.
The hand-written CUDA kernels themselves run only on the card:
tests/test_torch_gpu.py holds them against their plain versions there.

Tolerances are tests/test_kernels.py's: fp32 atol 2e-4, bf16 atol 5e-2,
both with rtol 0.05 (the two sides sum the taps in different orders,
and bf16 inputs are rounded by each framework).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backends import get_backend as jax_get_backend
from repro.core.backends import make_conv_fn
from repro.core.cluster.protocol import bwd_shard as jax_bwd_shard
from repro.core.cluster.protocol import conv_shard as jax_conv_shard
from repro.kernels.conv2d import conv2d_dw_pallas, conv2d_dx_pallas, conv2d_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import conv2d as conv2d_module
from repro_torch.kernels.conv2d import (
    conv2d,
    conv2d_dw,
    conv2d_dx,
    dw_plan,
    dx_plan,
    fwd_plan,
)
from repro_torch.kernels.ref import (
    conv2d_dw_ref,
    conv2d_dx_ref,
    conv2d_ref,
    ieee_fp32_matmul,
)
from repro_torch.models.cnn import conv_fn_for_backend

DTYPES = {
    "float32": (jnp.float32, torch.float32, 2e-4),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2),
}
SHAPES = [
    (1, 8, 8, 3, 16, 3),
    (2, 16, 16, 8, 24, 5),   # odd cout vs tile
    (2, 32, 32, 3, 50, 5),   # the paper's C1 layer (reduced batch)
    (1, 16, 16, 50, 40, 5),
    (2, 8, 8, 4, 0, 3),      # a device allocated 0 kernels by Eq. 1
    (2, 1, 8, 4, 8, 5),      # a one-row strip
    (2, 8, 8, 6, 21, 5),     # Cout not a multiple of 16
    (1, 4, 4, 64, 256, 1),   # ResNet-50's 1x1 convs: a projection, a 2c
    (1, 4, 4, 256, 64, 1),   # a 2a
    (1, 2, 2, 256, 2048, 1),  # Cout 2048, as conv5_x's 2c
    (1, 16, 16, 3, 64, 7),   # its conv1: 7x7 over Cin 3
]
# the wrappers' empty cases besides Cout 0: no pixels (a zero-row batch
# shard, whose dW is zeros of the full shape) and no input channels
EMPTY_SHAPES = [(0, 8, 8, 4, 6, 3), (2, 8, 8, 0, 6, 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one intra-op thread: these tests share the host with
    the suite's timing-sensitive cluster tests, and need no more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, h, w, cin, cout, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wk = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    return x, wk


def _pallas(x, wk, jdtype):
    """The JAX package's forward conv on these inputs, as float32 numpy.
    A 0-kernel shard never reaches the Pallas kernel (its Cout tiling
    divides by Cout): the JAX protocol's ``conv_shard`` answers it."""
    if wk.shape[-1] == 0:
        return jax_conv_shard(jax_get_backend("pallas:interpret"), x, wk)
    y = conv2d_pallas(
        jnp.asarray(x).astype(jdtype), jnp.asarray(wk).astype(jdtype),
        cout_tile=16, interpret=True,
    )
    return np.asarray(y.astype(jnp.float32))


def _bwd_pallas(x, wk, g, jdtype):
    """The JAX package's dX and dW on these inputs, as float32 numpy.  A
    0-kernel shard never reaches the Pallas kernels (their Cout tiling
    divides by Cout): the JAX protocol's ``bwd_shard`` answers it."""
    if wk.shape[-1] == 0:
        return jax_bwd_shard(jax_get_backend("pallas:interpret"), x, wk, g)
    jx, jw, jg = (jnp.asarray(a).astype(jdtype) for a in (x, wk, g))
    k = wk.shape[0]
    dx = conv2d_dx_pallas(jg, jw, cin_tile=16, interpret=True)
    dw = conv2d_dw_pallas(jx, jg, k, k, cout_tile=16, interpret=True)
    return np.asarray(dx.astype(jnp.float32)), np.asarray(dw)


def _grad(b, h, w, cout, seed=2):
    return np.random.default_rng(seed).standard_normal((b, h, w, cout)).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,w,cin,cout,k", SHAPES)
def test_conv2d_bwd_refs_match_pallas(b, h, w, cin, cout, k, dtype):
    """conv2d_dx_ref against conv2d_dx_pallas (in g's dtype) and
    conv2d_dw_ref against conv2d_dw_pallas (always float32)."""
    jdtype, tdtype, atol = DTYPES[dtype]
    x, wk = _inputs(b, h, w, cin, cout, k)
    g = _grad(b, h, w, cout)
    dx_want, dw_want = _bwd_pallas(x, wk, g, jdtype)
    tx, tw, tg = (torch.from_numpy(a).to(tdtype) for a in (x, wk, g))
    dx = conv2d_dx_ref(tg, tw)
    dw = conv2d_dw_ref(tx, tg, k, k)
    assert dx.dtype == tdtype and tuple(dx.shape) == (b, h, w, cin)
    assert dw.dtype == torch.float32 and tuple(dw.shape) == (k, k, cin, cout)
    np.testing.assert_allclose(dx.float().numpy(), dx_want, atol=atol, rtol=0.05)
    np.testing.assert_allclose(dw.numpy(), dw_want, atol=atol, rtol=0.05)


@pytest.mark.parametrize("b,h,w,cin,cout,k", SHAPES + EMPTY_SHAPES)
def test_bwd_wrappers_on_cpu_are_the_plain_versions(b, h, w, cin, cout, k):
    """On CPU tensors conv2d_dx and conv2d_dw (and their ops entries)
    run the plain versions, exactly, and launch nothing; empty shapes
    give zeros of the full shape."""
    x, wk = _inputs(b, h, w, cin, cout, k, seed=3)
    tx, tw, tg = (torch.from_numpy(a) for a in (x, wk, _grad(b, h, w, cout)))
    before = (conv2d_dx.launches, conv2d_dw.launches)
    dx = ops.conv2d_dx(tg, tw)
    dw = ops.conv2d_dw(tx, tg, k, k)
    assert (conv2d_dx.launches, conv2d_dw.launches) == before
    assert torch.equal(dx, conv2d_dx_ref(tg, tw))
    assert torch.equal(dw, conv2d_dw_ref(tx, tg, k, k))
    assert tuple(dx.shape) == (b, h, w, cin) and tuple(dw.shape) == (k, k, cin, cout)
    if b == 0 or cout == 0:
        assert not dx.any() and not dw.any()
    if b == 0:
        assert dw.shape == (k, k, cin, cout) and dw.numel() > 0


# ResNet-50's convs on a microbatch of 32 (models/resnet.py runs every
# conv at stride 1): conv1 7x7 over Cin 3 at 224x224; the 1x1 convs of
# each stage (a projection, a 2a, a 2c, the subsampled 2a of conv3_1),
# Cin 64 to 2048 and Cout 64 to 2048; conv5_x's 3x3 at 7x7
RESNET_SHAPES = [
    (32, 224, 224, 3, 64, 7), (32, 56, 56, 64, 256, 1), (32, 56, 56, 256, 64, 1),
    (32, 28, 28, 256, 128, 1), (32, 14, 14, 1024, 256, 1), (32, 7, 7, 512, 2048, 1),
    (32, 7, 7, 2048, 512, 1), (32, 7, 7, 1024, 2048, 1), (32, 7, 7, 512, 512, 3),
]


# K3's and K1's plans: the test sweep, C1 and C2 at batch 32 and 4
# (chip_smoke.py's kernel phases), the serving and training paths' C1
# and C2 shards (Cout 363 and 459 are not multiples of 4), a 7-row strip
# and fewer pixels than one chunk, in both dtypes
CONV_PLAN_CASES = [
    ((b, h, w, cin), k, cout, itemsize)
    for (b, h, w, cin, cout, k) in [s for s in SHAPES if s[4]] + [
        (32, 32, 32, 3, 500, 5), (32, 16, 16, 500, 1500, 5),
        (4, 32, 32, 3, 500, 5), (4, 16, 16, 500, 1500, 5),
        (4, 32, 32, 3, 165, 5), (4, 16, 16, 500, 449, 5),
        (8, 32, 32, 3, 175, 5), (8, 16, 16, 500, 459, 5), (8, 16, 16, 500, 363, 5),
        (8, 7, 16, 500, 437, 5), (1, 1, 8, 4, 8, 5), (1, 4, 4, 40, 1500, 5),
    ] + RESNET_SHAPES
    for itemsize in (4, 2)
]


@pytest.mark.parametrize("x_shape,k,cout,itemsize", CONV_PLAN_CASES)
def test_dw_plan_chunks_cover_every_pixel_once(x_shape, k, cout, itemsize):
    """K3's pixel chunks: whole 8-pixel slabs, none empty, covering B*H*W
    exactly once, at least 32 slabs long where there are that many; a
    split only where it lowers the cost of (waves of blocks over the
    card's block slots) x (slabs per chunk)."""
    plan = dw_plan(x_shape, k, k, cout, itemsize, 132)
    pixels = x_shape[0] * x_shape[1] * x_shape[2]
    assert plan.chunk % 8 == 0 and plan.bn == (64 if cout <= 64 else 128)
    assert (plan.splits - 1) * plan.chunk < pixels <= plan.splits * plan.chunk
    if plan.splits > 1:
        assert plan.chunk >= 8 * conv2d_module._DW_MIN_CHUNK_SLABS
    slots = conv2d_module._TILED_BLOCKS_PER_SM * 132
    slabs = -(-pixels // 8)

    def cost(splits):
        return -(-plan.tiles * splits // slots) * -(-slabs // splits)

    assert cost(plan.splits) <= cost(1)
    if plan.splits > 1:
        assert cost(plan.splits) < cost(1)


@pytest.mark.parametrize("x_shape,k,cout,itemsize", CONV_PLAN_CASES)
def test_dw_plan_workspace_stays_within_its_cap(x_shape, k, cout, itemsize):
    """K3's fp32 workspace is at most twice the bytes of x and g (in
    their dtype) and dW together."""
    plan = dw_plan(x_shape, k, k, cout, itemsize, 132)
    b, h, w, cin = x_shape
    dw_bytes = 4 * k * k * cin * cout
    ws_bytes = dw_bytes * plan.splits if plan.splits > 1 else 0
    assert ws_bytes <= 2 * (itemsize * b * h * w * (cin + cout) + dw_bytes)


def test_dw_plan_is_a_function_of_the_shapes():
    """The same shapes give the same plan (a rerun sums in the same
    order).  Pinned: the training path's C1 shards (1 or 2 tiles) split
    into 32 chunks of 256 pixels, its C2 shards (392 tiles, 1.5 waves)
    into 2 of 1,024; C1 at batch 32 (4 tiles) into 66 of 504, C2 at
    batch 32 (1,176 tiles, 4.5 waves) into 2 of 4,096."""
    for x_shape, k, cout, itemsize in CONV_PLAN_CASES:
        assert dw_plan(x_shape, k, k, cout, itemsize, 132) == dw_plan(
            tuple(x_shape), k, k, cout, itemsize, 132)
    assert dw_plan((8, 32, 32, 3), 5, 5, 175, 4, 132) == (128, 2, 32, 256)
    assert dw_plan((8, 32, 32, 3), 5, 5, 107, 4, 132) == (128, 1, 32, 256)
    assert dw_plan((8, 16, 16, 500), 5, 5, 459, 4, 132) == (128, 392, 2, 1024)
    assert dw_plan((32, 32, 32, 3), 5, 5, 500, 4, 132) == (128, 4, 66, 504)
    assert dw_plan((32, 16, 16, 500), 5, 5, 1500, 4, 132) == (128, 1176, 2, 4096)


@pytest.mark.parametrize("x_shape,k,cout,itemsize", CONV_PLAN_CASES)
def test_fwd_plan_splits_cover_every_tap_once(x_shape, k, cout, itemsize):
    """K1's split of the K axis: runs of whole taps, none empty, that
    cover the kh*kw taps exactly once, at most one split per 256
    products; a split only where it lowers the cost of (waves of blocks
    over the card's block slots) x (taps per split)."""
    plan = fwd_plan(x_shape, k, k, cout, itemsize, 132)
    taps, cin = k * k, x_shape[3]
    covered = [t for z in range(plan.splits)
               for t in range(z * plan.taps_per_split,
                              min((z + 1) * plan.taps_per_split, taps))]
    assert covered == list(range(taps))
    assert (plan.splits - 1) * plan.taps_per_split < taps
    assert plan.bn in (64, 128) and (cout > 64 or plan.bn == 64)
    if plan.splits > 1:
        assert plan.splits * conv2d_module._FWD_MIN_SPLIT_K <= taps * cin
        assert plan.bn == 128 or cout <= 64
    slots = conv2d_module._TILED_BLOCKS_PER_SM * 132

    def cost(splits):
        return -(-plan.tiles * splits // slots) * -(-taps // splits)

    assert cost(plan.splits) <= cost(1)
    if plan.splits > 1:
        assert cost(plan.splits) < cost(1)


@pytest.mark.parametrize("x_shape,k,cout,itemsize", CONV_PLAN_CASES)
def test_fwd_plan_workspace_stays_within_its_cap(x_shape, k, cout, itemsize):
    """K1's fp32 split workspace is at most 8x y's bytes in x's dtype."""
    plan = fwd_plan(x_shape, k, k, cout, itemsize, 132)
    y_elems = x_shape[0] * x_shape[1] * x_shape[2] * cout
    ws_bytes = 4 * y_elems * plan.splits if plan.splits > 1 else 0
    assert ws_bytes <= 8 * y_elems * itemsize


def test_fwd_plan_is_a_function_of_the_shapes():
    """The same shapes give the same plan.  Pinned: a serving C2 shard
    (1,024 pixels: 32 tiles on 264 block slots) splits into 7 runs of 4
    taps, a training C2 shard (64 tiles) into 4 of 7; C1 (K = 75) never
    splits, and takes 64-wide tiles on a serving or training shard (256
    or 192 blocks, not 128) but not at batch 32 (1,024 tiles of 128
    already make 4 waves)."""
    for x_shape, k, cout, itemsize in CONV_PLAN_CASES:
        assert fwd_plan(x_shape, k, k, cout, itemsize, 132) == fwd_plan(
            tuple(x_shape), k, k, cout, itemsize, 132)
    assert fwd_plan((4, 16, 16, 500), 5, 5, 449, 4, 132) == (128, 32, 7, 4)
    assert fwd_plan((8, 16, 16, 500), 5, 5, 459, 4, 132) == (128, 64, 4, 7)
    assert fwd_plan((4, 32, 32, 3), 5, 5, 500, 4, 132) == (64, 256, 1, 25)
    assert fwd_plan((8, 32, 32, 3), 5, 5, 159, 4, 132) == (64, 192, 1, 25)
    assert fwd_plan((32, 32, 32, 3), 5, 5, 500, 4, 132) == (128, 1024, 1, 25)


# K2's plans: the test sweep, C1 and C2 at batch 32 (chip_smoke.py's
# kernel_bwd) and the training path's microbatch shards, in both dtypes
DX_PLAN_CASES = [
    ((b, h, w, cout), k, cin, itemsize)
    for (b, h, w, cin, cout, k) in SHAPES + [
        (32, 32, 32, 3, 500, 5), (32, 16, 16, 500, 1500, 5),
        (8, 32, 32, 3, 167, 5), (8, 16, 16, 500, 500, 5),
        (8, 7, 16, 500, 1500, 5), (1, 4, 4, 65, 9, 7),
    ] + [(2, 8, 8, cin, 12, 5) for cin in (1, 4, 5, 9, 16, 17, 64, 65)] + RESNET_SHAPES
    for itemsize in (4, 2)
]


@pytest.mark.parametrize("g_shape,k,cin,itemsize", DX_PLAN_CASES)
def test_dx_plan_splits_cover_every_tap_once(g_shape, k, cin, itemsize):
    """K2's split of the K axis: runs of whole taps, none empty, that
    cover the kh*kw taps exactly once; a split only where it lowers the
    cost of (waves of blocks over the card's block slots) x (taps per
    split), so a shape whose tiles fill the slots in whole waves does not
    split."""
    plan = dx_plan(g_shape, k, k, cin, itemsize, 132)
    taps = k * k
    covered = [t for z in range(plan.splits)
               for t in range(z * plan.taps_per_split,
                              min((z + 1) * plan.taps_per_split, taps))]
    assert covered == list(range(taps))
    assert (plan.splits - 1) * plan.taps_per_split < taps
    per_sm = conv2d_module._DX_BLOCKS_PER_SM[
        "tiled" if plan.variant == "tiled" else plan.bn]
    slots = per_sm * 132

    def cost(splits):
        return -(-plan.tiles * splits // slots) * -(-taps // splits)

    assert cost(plan.splits) <= cost(1)
    if plan.splits > 1:
        assert cost(plan.splits) < cost(1)
    if plan.tiles % slots == 0:
        assert plan.splits == 1


@pytest.mark.parametrize("cin", list(range(1, 18)) + [64, 65, 500])
def test_dx_plan_small_cin_tile_fits_cin(cin):
    """Cin <= 16 takes the small-Cin variant, whose N tile holds Cin and
    is at most 4x Cin (or 16); larger Cin the 64- or 128-wide tiles."""
    plan = dx_plan((8, 32, 32, 167), 5, 5, cin, 4, 132)
    if cin <= 16:
        assert plan.variant == "small_cin"
        assert cin <= plan.bn <= max(4 * cin, 16) and plan.bn in (4, 8, 16)
    else:
        assert plan.variant == "tiled" and plan.bn == (64 if cin <= 64 else 128)


def test_dx_plan_is_a_function_of_the_shapes():
    """The same shapes give the same plan (a rerun sums in the same
    order); the training path's microbatch shards (64 tiles) split in
    four, C1 and C2 at batch 32 (256 tiles, one wave of 264 slots) do
    not split."""
    for g_shape, k, cin, itemsize in DX_PLAN_CASES:
        assert dx_plan(g_shape, k, k, cin, itemsize, 132) == dx_plan(
            tuple(g_shape), k, k, cin, itemsize, 132)
    assert dx_plan((8, 32, 32, 167), 5, 5, 3, 4, 132) == ("small_cin", 4, 64, 4, 7)
    assert dx_plan((8, 16, 16, 500), 5, 5, 500, 4, 132) == ("tiled", 128, 64, 4, 7)
    assert dx_plan((32, 32, 32, 500), 5, 5, 3, 4, 132) == ("small_cin", 4, 256, 1, 25)
    assert dx_plan((32, 16, 16, 1500), 5, 5, 500, 4, 132) == ("tiled", 128, 256, 1, 25)


@pytest.mark.parametrize("g_shape,k,cin,itemsize", DX_PLAN_CASES)
def test_dx_plan_workspace_stays_within_its_cap(g_shape, k, cin, itemsize):
    """The fp32 split workspace is at most 8x dX's bytes in g's dtype."""
    plan = dx_plan(g_shape, k, k, cin, itemsize, 132)
    dx_elems = g_shape[0] * g_shape[1] * g_shape[2] * cin
    ws_bytes = 4 * dx_elems * plan.splits if plan.splits > 1 else 0
    assert ws_bytes <= 8 * dx_elems * itemsize


@pytest.mark.parametrize("b,h,w,cin,cout,k", [(2, 8, 8, 3, 5, 3), (2, 7, 6, 4, 21, 5)])
def test_conv2d_function_grads_match_pallas_vjp(b, h, w, cin, cout, k):
    """The port's differentiable conv (Conv2dFunction, through
    ``conv_fn_for_backend("cuda")``, plain versions on the CPU) against
    the JAX package's ``make_conv_fn("pallas")`` custom VJP: y, dX, dW
    and d(bias) for one cotangent."""
    x, wk = _inputs(b, h, w, cin, cout, k, seed=4)
    bias = np.random.default_rng(5).standard_normal(cout).astype(np.float32)
    g = _grad(b, h, w, cout, seed=6)
    jfn = make_conv_fn("pallas", interpret=True)
    y_want, vjp = jax.vjp(lambda xx, kk, bb: jfn({"kernel": kk, "bias": bb}, xx),
                          jnp.asarray(x), jnp.asarray(wk), jnp.asarray(bias))
    want = vjp(jnp.asarray(g))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, wk, bias))
    y = conv_fn_for_backend("cuda")({"kernel": tw, "bias": tb}, tx)
    got = torch.autograd.grad(y, (tx, tw, tb), torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want), atol=2e-4, rtol=0)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=2e-4, rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,w,cin,cout,k", SHAPES)
def test_conv2d_ref_matches_pallas(b, h, w, cin, cout, k, dtype):
    jdtype, tdtype, atol = DTYPES[dtype]
    x, wk = _inputs(b, h, w, cin, cout, k)
    want = _pallas(x, wk, jdtype)
    got = conv2d_ref(torch.from_numpy(x).to(tdtype), torch.from_numpy(wk).to(tdtype))
    assert got.dtype == tdtype and tuple(got.shape) == (b, h, w, cout)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0.05)


@pytest.mark.parametrize("b,h,w,cin,cout,k", SHAPES)
def test_conv2d_wrapper_on_cpu_is_the_plain_version(b, h, w, cin, cout, k):
    """On CPU tensors the wrapper (and the ops entry) run the plain
    version and launch nothing."""
    x, wk = _inputs(b, h, w, cin, cout, k, seed=1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(wk)
    before = conv2d.launches
    got = ops.conv2d(tx, tw)
    assert conv2d.launches == before
    assert torch.equal(got, conv2d_ref(tx, tw))
    np.testing.assert_allclose(
        got.numpy(), _pallas(x, wk, jnp.float32), atol=2e-4, rtol=0.05
    )


def test_conv2d_wrapper_refuses_a_device_it_cannot_run():
    """Neither CPU nor CUDA (here the meta device): the wrapper raises
    instead of falling back to the plain version."""
    x = torch.empty((1, 4, 4, 3), device="meta")
    w = torch.empty((3, 3, 3, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        conv2d(x, w)


def test_conv2d_ref_float64_stays_float64():
    """The plain version accumulates in float64 for float64 inputs — the
    exact chain chip_smoke.py holds the served outputs against."""
    x, wk = _inputs(2, 8, 8, 3, 5, 3)
    got = conv2d_ref(torch.from_numpy(x).double(), torch.from_numpy(wk).double())
    assert got.dtype == torch.float64
    np.testing.assert_allclose(
        got.numpy(), _pallas(x, wk, jnp.float32), atol=2e-4, rtol=0.05
    )


@pytest.mark.parametrize("before", [True, False])
def test_ieee_fp32_matmul_restores_the_tf32_flag(before):
    """The plain version turns TF32 off on the card only while it runs:
    the process-wide flag other callers see comes back as it was, after
    nesting too."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = before
    try:
        with ieee_fp32_matmul(torch.device("cuda")):
            assert torch.backends.cuda.matmul.allow_tf32 is False
            with ieee_fp32_matmul(torch.device("cuda")):
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is before
        with ieee_fp32_matmul(torch.device("cpu")):
            assert torch.backends.cuda.matmul.allow_tf32 is before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
