"""The port on the card: the hand-written CUDA kernels (forward K1, dX
K2, dW K3) against their plain PyTorch versions, and the ``cuda``
backend serving and running the backward through the cluster.

Every test here is marked ``gpu`` and skips without a CUDA card (the
kernels have no CPU mode; their arithmetic is held against the JAX
package on the CPU by tests/test_torch_kernels.py).  The file imports neither
jax nor the JAX package, so it runs on a machine that has neither:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are tests/test_kernels.py's: fp32 atol 2e-4, bf16 atol 5e-2,
both with rtol 0.05.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.backends import get_backend
from repro_torch.core.cluster.cluster import HeteroCluster
from repro_torch.kernels.conv2d import Conv2dFunction, conv2d, conv2d_dw, conv2d_dx
from repro_torch.kernels.ref import conv2d_dw_ref, conv2d_dx_ref, conv2d_ref
from repro_torch.launch.hetero import relu_pool
from repro_torch.serve.server import ClusterServer

pytestmark = pytest.mark.gpu

TOL = {"float32": (torch.float32, 2e-4), "bfloat16": (torch.bfloat16, 5e-2)}
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
    order, so a rerun gives the same bits (C1 splits the pixel axis)."""
    tx, _, tg = _bwd_inputs(dev, *shape, torch.float32)
    assert torch.equal(conv2d_dw(tx, tg, 5, 5), conv2d_dw(tx, tg, 5, 5))


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
