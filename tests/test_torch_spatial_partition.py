"""Twin of tests/test_spatial_partition.py over ``repro_torch``: the
height-strip (spatial) axis, the compact wire codec and the ``auto``
axis chooser.

Each reference case runs here but one: the wall-clock race
``test_auto_end_to_end_improves_wall_clock_under_slow_link`` is
measured on the card instead (``chip_smoke.py``'s ``axes`` phase, part
(c)).  The same seeded numpy inputs go through the port's strip helpers
and ``HeteroCluster`` (master ``torch:cpu``, slaves ``numpy``) and the
JAX package's; each result is held against the single-device reference
at the reference case's tolerance and against the other package's.
Strip geometry, accounted wire bytes, Eq. 1 row counts and the ``auto``
picks and predictions must equal the JAX package's.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_cluster_parity import clusters, ref_conv, single_device_grads, train_step
from repro.core.backends import get_backend as jax_get_backend
from repro.core.backends import strip_conv as jax_strip_conv
from repro.core.backends import strip_conv_vjp as jax_strip_conv_vjp
from repro.core.master_slave import _Socket as JaxSocket
from repro.core.master_slave import _strip_plan as jax_strip_plan
from repro.core.master_slave import resolve_wire_dtype as jax_resolve_wire_dtype
from repro_torch.core.backends import get_backend, strip_conv, strip_conv_vjp
from repro_torch.core.master_slave import (
    HeteroCluster,
    _Socket,
    _strip_plan,
    resolve_wire_dtype,
)


def _vjp_ref(x, w, g):
    _, pullback = jax.vjp(
        lambda a, b: jax.lax.conv_general_dilated(
            a, b, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jnp.asarray(x), jnp.asarray(w))
    dx, dw = pullback(jnp.asarray(g))
    return np.asarray(dx), np.asarray(dw)


def _data(b=2, h=8, wd=6, cin=3, cout=5, k=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, wd, cin)).astype(np.float32)
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    g = rng.normal(size=(b, h, wd, cout)).astype(np.float32)
    return x, w, g


def _close(port, jax_, want, atol, rtol=1e-7):
    """Both packages' arrays against the reference, and against each
    other, at the reference case's tolerance."""
    for a, b, c in zip(port, jax_, want):
        np.testing.assert_allclose(a, c, rtol=rtol, atol=atol)
        np.testing.assert_allclose(b, c, rtol=rtol, atol=atol)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _pinned(c, jc, times):
    for cl in (c, jc):
        cl.probe_times = list(times)


# ---------------------------------------------------------------------------
# the strip helpers themselves (backends.py), outside the protocol
# ---------------------------------------------------------------------------


def _tiles(strip, strip_vjp, backend, x, w, g, rows, halos):
    ys, dx, dw = [], np.zeros_like(x), np.zeros_like(w)
    for (r0, r1), (lo, hi, pt, pb) in zip(rows, halos):
        ys.append(strip(backend, x[:, lo:hi], w, pt, pb))
        dxh, dwp = strip_vjp(backend, x[:, lo:hi], w, g[:, r0:r1], pt, pb)
        dx[:, lo:hi] += dxh  # the halo seams overlap-add
        dw += dwp
    return np.concatenate(ys, axis=1), dx, dw


@pytest.mark.parametrize("h", [7, 8])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_strip_conv_tiles_reconstruct_reference(h, k):
    """Any strip tiling of H — including clipped halos at both borders —
    concatenates back to the exact SAME conv, fwd and bwd: the port's
    helpers on its plain PyTorch backend and the JAX package's on
    numpy."""
    x, w, g = _data(h=h, k=k, seed=1)
    want = (ref_conv(x, w), *_vjp_ref(x, w, g))
    counts = [h // 3, h - h // 3 - 1, 1]
    rows, halos = _strip_plan(h, k, counts)
    assert (rows, halos) == jax_strip_plan(h, k, counts)
    port = _tiles(strip_conv, strip_conv_vjp, get_backend("torch:cpu"), x, w, g, rows, halos)
    ref = _tiles(jax_strip_conv, jax_strip_conv_vjp, jax_get_backend("numpy"),
                 x, w, g, rows, halos)
    _close(port, ref, want, atol=1e-4)


def test_strip_plan_covers_height_with_clipped_halos():
    for plan in (_strip_plan, jax_strip_plan):
        rows, halos = plan(10, 5, [4, 0, 6])
        assert rows == [(0, 4), (4, 4), (4, 10)]
        # first strip: top halo clipped at the border -> 2 pad rows restore it
        assert halos[0] == (0, 6, 2, 0)
        assert halos[1] == (4, 4, 0, 0)  # empty strip, empty window
        assert halos[2] == (2, 10, 0, 2)
        with pytest.raises(AssertionError):
            plan(10, 3, [4, 4])  # counts must sum to H


# ---------------------------------------------------------------------------
# the protocol in spatial mode
# ---------------------------------------------------------------------------


def _fwd_bwd(c, x, w, g):
    y = c.conv_forward(x, w)
    return (y, *c.conv_backward(x, w, g))


@pytest.mark.parametrize("h", [7, 8])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_spatial_cluster_matches_reference(h, k):
    """Spatial-mode conv_forward/conv_backward over uneven Eq. 1 strips
    == the single-device reference, for even/odd H and kh in {1,3,5},
    with the JAX package's strip counts."""
    x, w, g = _data(h=h, k=k, cout=5, seed=2)
    want = (ref_conv(x, w), *_vjp_ref(x, w, g))
    c, jc = clusters([1.0, 1.5, 2.0], partition="spatial")
    try:
        _pinned(c, jc, [1.0, 1.5, 2.0])
        assert c.shares_for(h).tolist() == jc.shares_for(h).tolist()
        port, ref = _fwd_bwd(c, x, w, g), _fwd_bwd(jc, x, w, g)
        _close(port[:1], ref[:1], want[:1], atol=1e-4)
        _close(port[1:], ref[1:], want[1:], atol=1e-3)
    finally:
        c.shutdown()
        jc.shutdown()


def test_spatial_mode_with_zero_row_device():
    """A device whose Eq. 1 share rounds to 0 rows must not break the
    strip reassembly (it ships an empty window and returns empty rows).
    The slow device sleeps its slowdown times each empty op's time (~100
    s a package), so the two packages run side by side."""
    x, w, g = _data(h=6, k=3, seed=3)
    want = (ref_conv(x, w), *_vjp_ref(x, w, g))
    c, jc = clusters([1.0, 1e6], partition="spatial")
    try:
        _pinned(c, jc, [1.0, 1e6])
        assert c.shares_for(6).tolist() == jc.shares_for(6).tolist() == [6, 0]
        with ThreadPoolExecutor(2) as pool:
            port, ref = pool.map(lambda cl: _fwd_bwd(cl, x, w, g), (c, jc))
        _close(port[:1], ref[:1], want[:1], atol=1e-4)
        _close(port[1:], ref[1:], want[1:], atol=1e-3)
    finally:
        c.shutdown()
        jc.shutdown()


def test_spatial_train_chain_matches_single_device_vjp():
    """The pipelined fwd+bwd train chain in spatial mode == jax.grad on
    one device, microbatched and with a relu between, in both packages."""
    x, w1, _ = _data(b=5, h=8, wd=8, cout=6, k=5, seed=4)
    rng = np.random.default_rng(5)
    w2 = rng.normal(size=(5, 5, 6, 9)).astype(np.float32)
    g = rng.normal(size=(5, 8, 8, 9)).astype(np.float32)
    want = single_device_grads(x, w1, w2, g)
    c, jc = clusters([1.0, 1.5, 2.0], partition="spatial", pipeline=True, microbatches=3)
    try:
        _pinned(c, jc, [1.0, 1.5, 2.0])
        res, jres = train_step(c, x, w1, w2, g), train_step(jc, x, w1, w2, g)
        _close((res.dx, *res.dw), (jres.dx, *jres.dw), want, atol=1e-3, rtol=1e-4)
    finally:
        c.shutdown()
        jc.shutdown()


def test_spatial_mode_cuts_scatter_gather_bytes():
    """At 3 slaves, one fwd+bwd layer moves >= 2x fewer bytes in spatial
    mode than in kernel mode, and each mode's accounted bytes equal the
    JAX package's."""
    x, w, g = _data(b=4, h=16, wd=16, cin=8, cout=8, k=3, seed=6)
    bytes_by_mode = {}
    for mode in ("kernel", "spatial"):
        c, jc = clusters([1.0, 1.0, 1.0, 1.0], partition=mode)
        try:
            _pinned(c, jc, [1.0] * 4)
            for cl in (c, jc):
                cl.conv_forward(x, w)
                cl.conv_backward(x, w, g)
            assert c.comm_bytes == jc.comm_bytes, (mode, c.comm_bytes, jc.comm_bytes)
            bytes_by_mode[mode] = c.comm_bytes
        finally:
            c.shutdown()
            jc.shutdown()
    assert bytes_by_mode["kernel"] >= 2 * bytes_by_mode["spatial"], bytes_by_mode


# ---------------------------------------------------------------------------
# the compact wire codec
# ---------------------------------------------------------------------------


def test_resolve_wire_dtype():
    for resolve in (resolve_wire_dtype, jax_resolve_wire_dtype):
        assert resolve(None) is None
        assert resolve("fp32") is None
        assert resolve("fp16") == np.dtype(np.float16)
        assert resolve("bf16").itemsize == 2
        with pytest.raises(ValueError):
            resolve("int8")


@pytest.mark.parametrize("dtype", ["fp16", "bf16"])
def test_codec_halves_accounted_bytes_and_roundtrips(dtype):
    """The encoded wire: byte counters see the 2-byte arrays (≈2x fewer
    bytes than fp32, exactly 2x on the float payload) and equal the JAX
    package's, results come back float32, and the numerics stay within
    the codec's precision of the fp32 wire and of the JAX package's."""
    x, w, g = _data(b=2, h=8, wd=8, cin=4, cout=6, k=3, seed=7)
    got = {}
    for wd_ in (None, dtype):
        c, jc = clusters([1.0, 1.0], wire_dtype=wd_)
        try:
            _pinned(c, jc, [1.0, 1.0])
            got[wd_ or "fp32"] = [(*_fwd_bwd(cl, x, w, g), cl.comm_bytes) for cl in (c, jc)]
        finally:
            c.shutdown()
            jc.shutdown()
    for pkg in (0, 1):
        y32, dx32, dw32, b32 = got["fp32"][pkg]
        y16, dx16, dw16, b16 = got[dtype][pkg]
        assert y16.dtype == np.float32 and dx16.dtype == np.float32
        # flags/None markers keep the ratio just under 2
        assert 1.8 < b32 / b16 <= 2.0, (pkg, b32, b16)
        np.testing.assert_allclose(y16, y32, rtol=0.05, atol=0.15)
        np.testing.assert_allclose(dx16, dx32, rtol=0.05, atol=0.2)
        np.testing.assert_allclose(dw16, dw32, rtol=0.05, atol=0.6)
    for key in ("fp32", dtype):
        (y, dx, dw, nbytes), (jy, jdx, jdw, jbytes) = got[key]
        assert nbytes == jbytes, (key, nbytes, jbytes)
        np.testing.assert_allclose(y, jy, rtol=0.05, atol=0.15)
        np.testing.assert_allclose(dx, jdx, rtol=0.05, atol=0.2)
        np.testing.assert_allclose(dw, jdw, rtol=0.05, atol=0.6)


def test_codec_socket_roundtrip_is_lossless_for_fp16_representable():
    """fp16-representable payloads cross the codec bit-exactly, nested
    structures included, and the counters see the ENCODED size — the
    JAX package's count."""
    payload = {
        "a": np.arange(8, dtype=np.float32),
        "b": (np.ones((2, 2), np.float32), [np.zeros(3, np.float64)]),
        "flag": "keep-me",
        "i": np.arange(4, dtype=np.int32),  # non-float: untouched
    }
    counted = []
    for sock_cls in (_Socket, JaxSocket):
        s = sock_cls(wire_dtype=np.dtype(np.float16))
        s.write_to_slave(payload)
        got = s.read_on_slave()
        assert got["flag"] == "keep-me"
        assert got["a"].dtype == np.float32
        np.testing.assert_array_equal(got["a"], payload["a"])
        np.testing.assert_array_equal(got["b"][0], payload["b"][0])
        assert got["i"].dtype == np.int32
        counted.append(s.bytes_to_slave)
    # 8 + 4 + 3 floats at 2B encoded + 4 int32 at 4B + 8B for the string
    # + 4 dict keys at the 8B scalar rate
    assert counted == [(8 + 4 + 3) * 2 + 4 * 4 + 8 + 4 * 8] * 2


# ---------------------------------------------------------------------------
# partition="auto": the comm-extended Eq. 1 chooses the axis
# ---------------------------------------------------------------------------


def _auto_pick(bandwidth, x_shape, w_shape, probe_flops=None):
    """(mode, predictions, picks) of the port's cluster, each equal to
    the JAX package's on the same probe state."""
    c, jc = clusters([1.0, 1.0, 1.0], partition="auto", bandwidth_mbps=bandwidth)
    try:
        out = []
        for cl in (c, jc):
            cl.probe_times = [1.0, 1.0, 1.0]
            cl.probe_flops = probe_flops
            mode = cl._resolve_mode(x_shape, w_shape, None)
            pred = (cl.predict_partition_seconds(x_shape, w_shape)
                    if bandwidth is not None else None)
            out.append((mode, pred, dict(cl.partition_choices)))
    finally:
        c.shutdown()
        jc.shutdown()
    (mode, pred, choices), (jmode, jpred, jchoices) = out
    assert (mode, choices) == (jmode, jchoices)
    if pred is not None:
        assert pred.keys() == jpred.keys()
        for m in pred:
            assert pred[m] == pytest.approx(jpred[m], rel=1e-12)
    return mode, pred, choices


def test_auto_picks_spatial_on_slow_link_for_activation_heavy_layer():
    """Activation-dominated layer (big H, cin == cout, small kernel) on a
    slow link: spatial's row-strip scatter beats re-broadcasting the full
    input, and auto must say so — and record its pick."""
    x_shape, w_shape = (8, 32, 32, 16), (3, 3, 16, 16)
    mode, pred, choices = _auto_pick(10.0, x_shape, w_shape)
    assert mode == "spatial"
    assert pred["spatial"] < pred["kernel"]
    assert choices[(x_shape, w_shape)] == "spatial"


def test_predictor_weighs_backward_wire():
    """op="bwd"/"train" predictions include the backward's wire, so never
    a smaller predicted time, and kernel mode's backward is penalized
    more than spatial's — with the JAX package's numbers."""
    c, jc = clusters([1.0, 1.0, 1.0], partition="auto", bandwidth_mbps=10.0)
    try:
        _pinned(c, jc, [1.0, 1.0, 1.0])
        shapes = ((8, 32, 32, 16), (3, 3, 16, 16))
        pred = {op: c.predict_partition_seconds(*shapes, op)
                for op in ("conv", "bwd", "train")}
        for op, p in pred.items():
            jp = jc.predict_partition_seconds(*shapes, op)
            assert p == pytest.approx(jp, rel=1e-12), op
        for mode in ("kernel", "spatial"):
            assert pred["bwd"][mode] > pred["conv"][mode]
            assert pred["train"][mode] > pred["bwd"][mode]
        assert (pred["train"]["kernel"] / pred["conv"]["kernel"]
                > pred["train"]["spatial"] / pred["conv"]["spatial"])
    finally:
        c.shutdown()
        jc.shutdown()


def test_cluster_rejects_sub_one_slowdowns():
    """The op-level emulation can only sleep, never speed up — a sub-1
    slowdown is refused, pointing at parameterized sim backends, in
    both packages."""
    with pytest.raises(ValueError, match="sim:5e9"):
        HeteroCluster([1.0, 0.5], ["torch:cpu", "numpy"])
    with pytest.raises(ValueError, match="sim:5e9"):
        clusters([1.0, 0.5])


def test_auto_picks_kernel_on_free_links():
    """Infinitely fast links: the wire is free, the halo isn't — auto
    keeps the paper's kernel axis."""
    mode, _, _ = _auto_pick(None, (8, 32, 32, 16), (3, 3, 16, 16))
    assert mode == "kernel"


def test_auto_picks_kernel_when_gather_dominates():
    """cout >> cin: the y gather dwarfs the x scatter, spatial saves
    little and pays the halo + full-kernel broadcast — kernel wins."""
    mode, pred, _ = _auto_pick(10.0, (4, 8, 8, 4), (5, 5, 4, 256))
    assert mode == "kernel"
    assert pred["kernel"] <= pred["spatial"]
