"""Twin of tests/test_wire_codec.py over ``repro_torch``: the port's
compressor stack (``core/cluster/codec.py``) against the JAX package's.

Every reference case runs here with its parametrisation, and where it
encodes, the same seeded numpy message goes through both codecs: the
same marker kinds, ``QuantArray`` values and scales bit-equal,
``SparseGrad`` entries equal as sets of (index, value) pairs, the same
error-feedback residuals, the same canonical ``wire_nbytes`` and
bit-equal decodes.  The reference's own assertions hold on the port.

Then the bf16 stage without ``ml_dtypes`` (numpy has no bfloat16, and
the machine with the card has no ``ml_dtypes``): with the package
blocked, the port's bits equal the JAX codec's ``ml_dtypes.bfloat16``
bits on edge values and its byte counts equal the JAX codec's; and a
kernel-axis train chain with ``wire_codec="bf16"`` over tcp and shm,
to a spawned slave process whose ``ml_dtypes`` import fails, equals the
JAX package's bf16 run (rtol 1e-4, atol 1e-3, the transport twins').
"""
import sys

import numpy as np
import pytest

from _torch_cluster_parity import ATOL, assert_matches, data, grads, train_step
from repro.core.cluster import codec as jax_codec
from repro.core.master_slave import HeteroCluster as JaxHeteroCluster
from repro_torch.core.cluster import codec
from repro_torch.core.cluster.codec import (
    QuantArray,
    SparseGrad,
    WeightRef,
    WireCodec,
    resolve_wire_dtype,
    wire_nbytes,
)
from repro_torch.core.master_slave import HeteroCluster

PACKAGES = (codec, jax_codec)


def _pairs(sp):
    """A ``SparseGrad``'s entries as a set of (index, value bits)."""
    return set(zip(sp.idx.tolist(), sp.vals.view(np.uint32).tolist()))


def assert_same_wire(got, want):
    """The port's encoded message equals the JAX codec's: the same
    marker kinds and containers, int8 values and scales bit-equal,
    sparse entries equal as sets of pairs, arrays bit-equal."""
    kinds = (QuantArray, SparseGrad, WeightRef)
    jax_kinds = (jax_codec.QuantArray, jax_codec.SparseGrad, jax_codec.WeightRef)
    for mine, theirs in zip(kinds, jax_kinds):
        assert isinstance(got, mine) == isinstance(want, theirs), (got, want)
    if isinstance(got, QuantArray):
        assert got.q.dtype == want.q.dtype == np.int8
        np.testing.assert_array_equal(got.q, want.q)
        assert np.float32(got.scale).tobytes() == np.float32(want.scale).tobytes()
    elif isinstance(got, SparseGrad):
        assert got.shape == want.shape
        assert got.idx.dtype == want.idx.dtype and got.vals.dtype == want.vals.dtype
        assert _pairs(got) == _pairs(want)
    elif isinstance(got, WeightRef):
        assert (got.key, got.version) == (want.key, want.version)
        if got.w is None or want.w is None:
            assert got.w is None and want.w is None
        else:
            assert_same_wire(got.w, want.w)
    elif isinstance(got, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            assert_same_wire(a, b)
    elif isinstance(got, dict):
        assert list(got) == list(want)
        for k in got:
            assert_same_wire(got[k], want[k])
    elif isinstance(got, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    else:
        assert got == want


def assert_bit_equal(got, want):
    """Decoded messages: float32 leaves equal bit for bit."""
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_bit_equal(a, b)
    elif isinstance(got, dict):
        for k in got:
            assert_bit_equal(got[k], want[k])
    else:
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _both(spec, wire_dtype=None):
    return (WireCodec.from_spec(spec, wire_dtype),
            jax_codec.WireCodec.from_spec(spec, wire_dtype))


# ---------------------------------------------------------------------------
# spec parsing
# ---------------------------------------------------------------------------


def test_single_stage_spec_applies_to_all_classes():
    c, j = _both("int8")
    assert c.weights == "int8" and c.acts == "int8" and c.grads == "int8"
    assert c.spec == "int8" == j.spec
    assert (c.weights, c.acts, c.grads) == (j.weights, j.acts, j.grads)


def test_per_class_spec_and_canonical_roundtrip():
    c, j = _both("weights=fp16,acts=int8,grads=topk:0.05")
    assert c.weights == np.dtype(np.float16) == j.weights
    assert c.acts == "int8" == j.acts
    assert c.grad_topk == pytest.approx(0.05) and c.grad_topk == j.grad_topk
    spec = c.spec
    assert spec == "weights=fp16,acts=int8,grads=topk:0.05" == j.spec
    c2 = WireCodec.from_spec(spec)
    assert c2.spec == spec == jax_codec.WireCodec.from_spec(j.spec).spec


def test_empty_spec_falls_back_to_wire_dtype():
    for cd in PACKAGES:
        assert cd.WireCodec.from_spec(None, "fp16").acts == np.dtype(np.float16)
        assert cd.WireCodec.from_spec("", None).spec is None


@pytest.mark.parametrize("bad", [
    "float8",                   # unknown stage
    "voltage=fp16",             # unknown message class
    "acts=fp16,acts=int8",      # duplicate class
    "acts=topk:0.1",            # topk only valid for grads
    "grads=topk:1.5",           # fraction out of (0, 1)
    "fp16 int8",                # missing class=stage shape
])
def test_bad_specs_raise(bad):
    for cd in PACKAGES:
        with pytest.raises(ValueError):
            cd.WireCodec.from_spec(bad)


def test_int8_is_a_codec_stage_not_a_wire_dtype():
    """The legacy single-dtype knob stays dtype-only in both packages:
    ``wire_dtype='int8'`` fails loudly instead of half-working."""
    for cd in PACKAGES:
        with pytest.raises(ValueError):
            cd.resolve_wire_dtype("int8")


# ---------------------------------------------------------------------------
# int8 absmax stage
# ---------------------------------------------------------------------------


def test_int8_roundtrip_error_bounded_by_half_step():
    rng = np.random.default_rng(0)
    a = rng.uniform(-3.0, 3.0, size=(64, 33)).astype(np.float32)
    qa = codec._quant_int8(a)
    assert qa.q.dtype == np.int8
    assert_same_wire(qa, jax_codec._quant_int8(a))
    back = codec._dequant_int8(qa)
    assert_bit_equal(back, jax_codec._dequant_int8(jax_codec._quant_int8(a)))
    step = float(np.max(np.abs(a))) / 127.0
    assert np.max(np.abs(back - a)) <= step / 2 + 1e-7


def test_int8_degenerate_tensors():
    z = codec._dequant_int8(codec._quant_int8(np.zeros(5, np.float32)))
    np.testing.assert_array_equal(z, np.zeros(5, np.float32))
    assert_bit_equal(z, jax_codec._dequant_int8(jax_codec._quant_int8(np.zeros(5, np.float32))))
    e = codec._quant_int8(np.zeros((0, 3), np.float32))
    assert e.q.shape == (0, 3)
    assert_same_wire(e, jax_codec._quant_int8(np.zeros((0, 3), np.float32)))


# ---------------------------------------------------------------------------
# top-k sparsification + error feedback
# ---------------------------------------------------------------------------


def test_topk_keeps_largest_and_densifies_back():
    g = np.array([[0.1, -5.0, 0.2], [4.0, -0.3, 0.05]], np.float32)
    sp = codec._sparsify_topk(g, 1 / 3)
    assert_same_wire(sp, jax_codec._sparsify_topk(g, 1 / 3))
    dense = codec._densify(sp)
    assert dense.shape == g.shape
    np.testing.assert_array_equal(dense, [[0, -5.0, 0], [4.0, 0, 0]])


def test_topk_too_small_ships_dense():
    for cd in PACKAGES:
        assert cd._sparsify_topk(np.ones(3, np.float32), 0.5) is None


def test_error_feedback_reinjects_dropped_mass():
    """With a CONSTANT gradient, the shipped top-k stream averages to
    the true gradient; every step's encoding and the stored residual
    equal the JAX codec's."""
    rng = np.random.default_rng(1)
    g = rng.normal(size=(6, 40)).astype(np.float32)
    c, j = _both("grads=topk:0.1")
    shipped = np.zeros_like(g)
    n = 30
    for _ in range(n):
        enc = c._grad_down(g, "layer0")
        assert isinstance(enc, SparseGrad)
        assert_same_wire(enc, j._grad_down(g, "layer0"))
        shipped += codec._densify(enc)
    key = ("layer0", g.shape)
    assert_bit_equal(c._ef[key], j._ef[key])
    resid = n * g - shipped
    np.testing.assert_allclose(resid, c._ef[key], rtol=1e-4, atol=1e-4)
    assert np.linalg.norm(shipped / n - g) / np.linalg.norm(g) < 0.15


def test_topk_dense_fallback_pops_residual():
    c, j = _both("grads=topk:0.4")
    big = np.arange(100, dtype=np.float32)
    tiny = np.ones(2, np.float32)
    for cd in (c, j):
        out = cd._grad_down(big, "k")
        assert out.__class__.__name__ == "SparseGrad"
        assert ("k", big.shape) in cd._ef
        out_t = cd._grad_down(tiny, "t")
        assert isinstance(out_t, np.ndarray)  # dense: indices would not pay
        assert ("t", tiny.shape) not in cd._ef
    assert_bit_equal(c._ef[("k", big.shape)], j._ef[("k", big.shape)])


# ---------------------------------------------------------------------------
# grammar routing and accounting
# ---------------------------------------------------------------------------


def test_down_grammar_routes_classes_independently():
    c, j = _both("weights=int8,acts=fp16,grads=topk:0.05")
    x = np.random.default_rng(2).normal(size=(2, 8, 8, 3)).astype(np.float32)
    w = np.ones((3, 3, 3, 4), np.float32)
    g = np.random.default_rng(3).normal(size=(2, 8, 8, 4)).astype(np.float32)
    msg = c.encode_down(("bwd", (x, w, g)))
    op, (ex, ew, eg) = msg
    assert op == "bwd"
    assert ex.dtype == np.float16
    assert isinstance(ew, QuantArray)
    assert isinstance(eg, SparseGrad)
    theirs = j.encode_down(("bwd", (x, w, g)))
    assert_same_wire(msg, theirs)
    assert wire_nbytes(msg) == jax_codec.wire_nbytes(theirs)
    assert_bit_equal(c.decode(msg)[1], j.decode(theirs)[1])


def test_ping_passes_through_uncompressed():
    """Bandwidth probes must measure the raw wire, whatever the codec."""
    blob = np.ones(256, np.float32)
    for cd in _both("int8"):
        op, payload = cd.encode_down(("ping", blob))
        assert op == "ping"
        assert payload is blob


def test_up_pair_is_grads_everything_else_acts():
    c, j = _both("acts=fp16,grads=int8")
    pair = (np.arange(4, dtype=np.float32), np.linspace(-1, 1, 3).astype(np.float32))
    dx, dw = c.encode_up(pair)
    assert isinstance(dx, QuantArray) and isinstance(dw, QuantArray)
    assert_same_wire((dx, dw), j.encode_up(pair))
    y = c.encode_up(np.ones(4, np.float32))
    assert y.dtype == np.float16
    assert_same_wire(y, j.encode_up(np.ones(4, np.float32)))


def test_decode_restores_float32_for_every_marker():
    c, j = _both("int8")
    a = np.random.default_rng(4).uniform(-1, 1, 50).astype(np.float32)
    enc = c.encode_down({"a": a})["a"]
    assert_same_wire(enc, j.encode_down({"a": a})["a"])
    dec = c.decode(enc)
    assert dec.dtype == np.float32
    np.testing.assert_allclose(dec, a, atol=1.0 / 127.0)
    assert_bit_equal(dec, j.decode(j.encode_down({"a": a})["a"]))
    sp = codec._sparsify_topk(a, 0.1)
    np.testing.assert_array_equal(c.decode(sp), codec._densify(sp))
    assert_bit_equal(c.decode(sp), j.decode(jax_codec._sparsify_topk(a, 0.1)))


def test_wire_nbytes_of_marker_classes():
    for cd in PACKAGES:
        qa = cd.QuantArray(np.zeros(10, np.int8), 0.5)
        assert cd.wire_nbytes(qa) == 10 + 8
        sp = cd.SparseGrad(np.zeros(3, np.int32), np.zeros(3, np.float32), (30,))
        assert cd.wire_nbytes(sp) == 3 * 4 + 3 * 4 + 8
        assert cd.wire_nbytes(cd.WeightRef("layer", 7, None)) == 8 + 8
        assert cd.wire_nbytes(cd.WeightRef("layer", 7, np.zeros(4, np.float32))) == 32
    # the port's bf16 marker counts 2 bytes an element, as a 2-byte array
    assert wire_nbytes(codec.Bf16Array(np.zeros(10, np.uint16))) == 20


def test_itemsize_feeds_the_planner():
    for cd in PACKAGES:
        assert cd.WireCodec.from_spec(None).itemsize("acts") == 4.0
        assert cd.WireCodec.from_spec("fp16").itemsize("weights") == 2.0
        assert cd.WireCodec.from_spec("int8").itemsize("acts") == 1.0
        c = cd.WireCodec.from_spec("grads=topk:0.05")
        assert c.itemsize("grads") == pytest.approx(8.0 * 0.05)
        assert c.itemsize("acts") == 4.0
    assert WireCodec.from_spec("bf16").itemsize("grads") == 2.0


# ---------------------------------------------------------------------------
# the bf16 stage without ml_dtypes
# ---------------------------------------------------------------------------

_F32 = np.finfo(np.float32)
_EDGES = {
    # every binade from the subnormals to near fp32 max, both signs
    "random": (np.random.default_rng(5).uniform(-9.99, 9.99, 4096)
               * 10.0 ** np.random.default_rng(6).integers(-44, 38, 4096)).astype(np.float32),
    "signed zeros": np.array([0.0, -0.0], np.float32),
    # the smallest subnormal, one that rounds up into bf16's range, the largest
    "subnormals": np.array([1e-45, -1e-45, 1e-40, -9.2e-41, _F32.tiny * 0.99999], np.float32),
    # exact ties between two bf16 values: to the even one, down and up
    "ties": np.array([1.00390625, 1.01171875, -1.00390625, -1.01171875, 3.0078125],
                     np.float32),
    "fp32 max": np.array([_F32.max, -_F32.max, 3.3961776e38, 3.3895314e38], np.float32),
    "infinities": np.array([np.inf, -np.inf], np.float32),
}


@pytest.fixture
def no_ml_dtypes(monkeypatch):
    """Any import of ``ml_dtypes`` from here on raises ImportError."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)


@pytest.mark.parametrize("edge", sorted(_EDGES))
def test_bf16_bits_equal_ml_dtypes_without_it(edge, request):
    """The JAX codec's bf16 (``ml_dtypes.bfloat16``) first; then, with
    ``ml_dtypes`` unimportable, the port's bits through the stack and
    the legacy single-dtype path: equal bit for bit, decodes equal, and
    the same canonical bytes for the same message."""
    a = _EDGES[edge]
    jc = jax_codec.WireCodec.from_spec("bf16")
    msg = ("conv", ({"x": a, "flag": "keep"}, a.astype(np.float64)))
    theirs = jc.encode_down(msg)
    their_bits = theirs[1][0]["x"].view(np.uint16)
    their_dec = jc.decode(theirs)
    their_legacy = jax_codec.encode(a, jax_codec.resolve_wire_dtype("bf16")).view(np.uint16)
    request.getfixturevalue("no_ml_dtypes")
    with pytest.raises(ImportError):
        import ml_dtypes  # noqa: F401
    c = WireCodec.from_spec("bf16")
    mine = c.encode_down(msg)
    x_enc = mine[1][0]["x"]
    assert isinstance(x_enc, codec.Bf16Array) and x_enc.bits.dtype == np.uint16
    np.testing.assert_array_equal(x_enc.bits, their_bits)
    np.testing.assert_array_equal(mine[1][1].bits, theirs[1][1].view(np.uint16))
    assert wire_nbytes(mine) == jax_codec.wire_nbytes(theirs)
    dec = c.decode(mine)
    assert_bit_equal((dec[1][0]["x"], dec[1][1]), (their_dec[1][0]["x"], their_dec[1][1]))
    legacy = codec.encode(a, resolve_wire_dtype("bf16"))
    np.testing.assert_array_equal(legacy.bits, their_legacy)
    assert_bit_equal(codec.decode(legacy, resolve_wire_dtype("bf16")), dec[1][0]["x"])
    assert codec.wire_dtype_name(resolve_wire_dtype("bf16")) == "bf16"


def test_bf16_nan_stays_nan_without_ml_dtypes(no_ml_dtypes):
    """Every NaN pattern, quiet or signalling, of either sign, stays a
    NaN of its sign (never rounds into an infinity)."""
    u = np.array([0x7FC00000, 0x7F800001, 0x7FBFFFFF, 0xFFFFFFFF, 0xFF800001],
                 np.uint32)
    a = u.view(np.float32)
    enc = codec._to_bf16(a)
    back = codec._from_bf16(enc)
    assert np.isnan(back).all()
    np.testing.assert_array_equal(np.signbit(back), np.signbit(a))


@pytest.mark.parametrize("kind", ["tcp", "shm"])
def test_bf16_train_chain_without_ml_dtypes(kind, tmp_path, monkeypatch):
    """A kernel-axis train chain with ``wire_codec="bf16"`` over real
    slave processes whose ``ml_dtypes`` is a stub that raises (first on
    their ``PYTHONPATH``) and records the attempt: the slaves encode and
    decode bf16 without it, import nothing of it, and the gradients
    equal the JAX package's bf16 run on the same inputs.  Every device
    is ``numpy`` in both packages, so the only difference is the codec's
    code."""
    x, w1, w2, g = data()
    jc = JaxHeteroCluster([1.0, 1.0, 1.0], transport=kind, wire_codec="bf16",
                          pipeline=True, microbatches=3)
    try:
        jc.probe_times = [1.0, 1.0, 1.0]
        want = grads(train_step(jc, x, w1, w2, g))
        want_bytes = jc.comm_bytes
    finally:
        jc.shutdown()
    stub = tmp_path / "stub" / "ml_dtypes"
    stub.mkdir(parents=True)
    tried = tmp_path / "ml_dtypes_imported"
    (stub / "__init__.py").write_text(
        f"open({str(tried)!r}, 'a').write('x')\n"
        "raise ImportError('ml_dtypes is not installed on this host')\n")
    monkeypatch.setenv("PYTHONPATH", str(stub.parent))
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    c = HeteroCluster([1.0, 1.0, 1.0], ["numpy"] * 3, transport=kind,
                      wire_codec="bf16", pipeline=True, microbatches=3)
    try:
        c.probe_times = [1.0, 1.0, 1.0]
        got = grads(train_step(c, x, w1, w2, g))
        got_bytes = c.comm_bytes
    finally:
        c.shutdown()
    assert [p.returncode for p in c.procs] == [0, 0]
    assert not tried.exists(), "a slave process imported ml_dtypes"
    assert_matches(got, want, atol=ATOL)
    assert got_bytes == want_bytes
