"""The port's conv2d (repro_torch/kernels) against the JAX package's
Pallas kernel.

The same numpy inputs, made from a seed, go through
``repro.kernels.conv2d.conv2d_pallas`` in interpret mode (the kernel
body runs in Python on the CPU, as tests/test_kernels.py runs it) and
through the port's plain version ``conv2d_ref`` and its kernel wrapper
``conv2d`` — which, given CPU tensors, runs the plain version.  The
hand-written CUDA kernel itself runs only on the card:
tests/test_torch_gpu.py holds it against ``conv2d_ref`` there.

Tolerances are tests/test_kernels.py's: fp32 atol 2e-4, bf16 atol 5e-2,
both with rtol 0.05 (the two sides sum the taps in different orders,
and bf16 inputs are rounded by each framework).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backends import get_backend as jax_get_backend
from repro.core.cluster.protocol import conv_shard as jax_conv_shard
from repro.kernels.conv2d import conv2d_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.conv2d import conv2d
from repro_torch.kernels.ref import conv2d_ref, ieee_fp32_matmul

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
]


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
