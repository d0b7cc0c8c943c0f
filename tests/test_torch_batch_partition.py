"""Twin of tests/test_batch_partition.py over ``repro_torch``: the batch
axis (replicate the kernel, split the N axis, sum each member's dW),
its ``auto`` picks, the bounded decision caches and the axis under
admit/evict and a SIGKILL.

Each reference case runs here but one: the wall-clock race
``test_batch_beats_kernel_wall_clock_on_fat_emulated_link`` is measured
on the card instead (``chip_smoke.py``'s ``axes`` phase, part (c)).
The same seeded numpy inputs go through the port's ``HeteroCluster``
(master ``torch:cpu``, slaves ``numpy``, spawned as the port's protocol
module over tcp and shm) and the JAX package's; each result is held
against the single-device reference at the reference case's tolerance
and against the other package's.  Plans, row ranges, unit bytes,
predictions, picks and cache sizes must equal the JAX package's.
"""
import numpy as np
import pytest

from _torch_cluster_parity import (
    assert_matches,
    check,
    clusters,
    grads,
    single_device_grads,
    train_step,
)
from repro.core.backends import get_backend as jax_get_backend
from repro.core.cluster import plans as jax_plans
from repro_torch.core.cluster import plans


def _data(batch, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 8, 8, 3)).astype(np.float32)
    w1 = rng.normal(size=(3, 3, 3, 6)).astype(np.float32)
    w2 = rng.normal(size=(3, 3, 6, 9)).astype(np.float32)
    g = rng.normal(size=(batch, 8, 8, 9)).astype(np.float32)
    return x, w1, w2, g


def _pinned(c, jc, times):
    for cl in (c, jc):
        cl.probe_times = list(times)


def _fwd_matches(c, jc, x, w, want):
    """Both packages' batch-axis forward against the numpy reference
    (rtol/atol 1e-5) and each other."""
    y, jy = c.conv_forward(x, w), jc.conv_forward(x, w)
    for got in (y, jy):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-5)


def _bwd_matches(c, jc, x, w, g):
    """Both packages' batch-axis backward against the numpy VJP (dX
    1e-4/1e-4, dW 1e-4/1e-3) and each other."""
    rdx, rdw = jax_get_backend("numpy").conv_vjp(x, w, g)
    (dx, dw), (jdx, jdw) = c.conv_backward(x, w, g), jc.conv_backward(x, w, g)
    for got_dx, want_dx in ((dx, rdx), (jdx, rdx), (dx, jdx)):
        np.testing.assert_allclose(got_dx, want_dx, rtol=1e-4, atol=1e-4)
    for got_dw, want_dw in ((dw, rdw), (jdw, rdw), (dw, jdw)):
        np.testing.assert_allclose(got_dw, want_dw, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# plan geometry


def test_batch_ranges_recut_even_odd_and_exact():
    """batch_ranges re-cuts a plan's proportions to any slab size:
    b == sum(counts) reproduces the counts, odd slabs tile exactly,
    zero-share devices keep empty ranges — the JAX package's ranges."""
    counts = [3, 3, 2]
    assert plans.batch_ranges(counts, 8) == [(0, 3), (3, 6), (6, 8)]
    for b in (1, 2, 5, 7, 16):
        rng = plans.batch_ranges(counts, b)
        assert rng == jax_plans.batch_ranges(counts, b)
        assert rng[0][0] == 0 and rng[-1][1] == b
        assert all(r0 <= r1 for r0, r1 in rng)
        assert [r0 for (r0, _), (_, p1) in zip(rng[1:], rng)] == [
            p1 for (_, p1) in rng[:-1]
        ]
    assert plans.batch_ranges([4, 0, 2], 3) == [(0, 2), (2, 2), (2, 3)]


def test_check_plan_accepts_batch_plan():
    c, jc = clusters([1.0, 1.0, 1.0], partition="batch")
    try:
        _pinned(c, jc, [1.0, 1.0, 1.0])
        w = np.zeros((3, 3, 3, 6), np.float32)
        plan = c.plan_conv((6, 8, 8, 3), w, "train")
        assert plan.mode == "batch"
        assert plan.w is not None and plan.shards is None
        plans.check_plan(plan, n_units=6, n_devices=3)
        jplan = jc.plan_conv((6, 8, 8, 3), w, "train")
        assert plan.counts.tolist() == jplan.counts.tolist()
        assert plan.rows == jplan.rows
    finally:
        c.shutdown()
        jc.shutdown()


def test_unit_bytes_batch_counts_sample_traffic():
    """One batch unit is one sample: x + y out/back forward; the bwd
    adds the sample's g out and dX back — the JAX package's bytes."""
    x_shape, w_shape = (8, 4, 4, 3), (3, 3, 3, 5)
    smp_x, smp_y = 4 * 4 * 3, 4 * 4 * 5
    conv = plans.unit_bytes(x_shape, w_shape, "batch", "conv", 4.0)
    assert conv == jax_plans.unit_bytes(x_shape, w_shape, "batch", "conv", 4.0)
    assert conv == pytest.approx((smp_x + smp_y) * 4.0)
    train = plans.unit_bytes(x_shape, w_shape, "batch", "train", 4.0, g_itemsize=2.0)
    assert train == jax_plans.unit_bytes(
        x_shape, w_shape, "batch", "train", 4.0, g_itemsize=2.0)
    assert train == pytest.approx(conv + smp_x * 4.0 + (smp_x + smp_y) * 2.0)


# ---------------------------------------------------------------------------
# numerics: batch axis vs single-device reference


@pytest.mark.parametrize("batch", [6, 5])  # even and odd splits over 3 devices
def test_batch_forward_backward_match_reference(batch):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch, 8, 8, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 8)).astype(np.float32)
    g = rng.normal(size=(batch, 8, 8, 8)).astype(np.float32)
    c, jc = clusters([1.0, 1.5, 2.0], partition="batch")
    try:
        _pinned(c, jc, [1.0, 1.5, 2.0])
        _fwd_matches(c, jc, x, w, jax_get_backend("numpy").conv(x, w))
        _bwd_matches(c, jc, x, w, g)
    finally:
        c.shutdown()
        jc.shutdown()


def test_batch_zero_row_device_is_exact():
    """A device too slow to earn a single batch row legally ships zero
    rows (its dW contribution is a zero array) and the result is still
    exact."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 8)).astype(np.float32)
    g = rng.normal(size=(4, 8, 8, 8)).astype(np.float32)
    c, jc = clusters([1.0, 1.0, 1000.0], partition="batch")
    try:
        _pinned(c, jc, [1.0, 1.0, 1000.0])
        plan = c.plan_conv(x.shape, w, "train")
        assert int(plan.counts[-1]) == 0  # the slow device got no rows
        assert plan.counts.tolist() == jc.plan_conv(x.shape, w, "train").counts.tolist()
        _fwd_matches(c, jc, x, w, jax_get_backend("numpy").conv(x, w))
        _bwd_matches(c, jc, x, w, g)
    finally:
        c.shutdown()
        jc.shutdown()


def test_batch_train_chain_matches_vjp_inproc():
    """The pipelined fwd+bwd train chain on the batch axis: microbatch
    slices are re-cut per slab, dW sums across members AND microbatches,
    and the result matches the single-device VJP at fp32 tolerance."""
    x, w1, w2, g = _data(batch=7)  # 7 rows: odd per-microbatch re-cuts
    want = single_device_grads(x, w1, w2, g)
    c, jc = clusters([1.0, 1.5, 2.0], partition="batch", pipeline=True, microbatches=3)
    try:
        _pinned(c, jc, [1.0, 1.5, 2.0])
        check(train_step(c, x, w1, w2, g), train_step(jc, x, w1, w2, g), want)
    finally:
        c.shutdown()
        jc.shutdown()


@pytest.mark.parametrize("transport", ["tcp", "shm"])
def test_batch_train_chain_matches_vjp_subprocess(transport):
    """Batch-axis train-step gradients over real OS-subprocess slaves
    (framed TCP sockets / shm rings) match the single-device VJP."""
    x, w1, w2, g = _data(batch=6)
    want = single_device_grads(x, w1, w2, g)
    c, jc = clusters([1.0, 1.0, 1.0], transport=transport, partition="batch",
                     pipeline=True, microbatches=2)
    try:
        _pinned(c, jc, [1.0, 1.0, 1.0])
        check(train_step(c, x, w1, w2, g), train_step(jc, x, w1, w2, g), want)
    finally:
        c.shutdown()
        jc.shutdown()


# ---------------------------------------------------------------------------
# hybrid auto: per-regime picks


def _auto_clusters(bandwidth_mbps):
    """Both packages' auto clusters with fast devices (the wire
    decides), as the reference builds them."""
    c, jc = clusters([1.0, 1.0, 1.0], partition="auto", bandwidth_mbps=bandwidth_mbps)
    for cl in (c, jc):
        cl.probe_times = [1e-4, 1e-4, 1e-4]
        cl.probe_flops = 2.0 * 4 * 8 * 8 * 9 * 3 * 4
    return c, jc


def _predict(c, jc, x_shape, w_shape, op):
    """The port's prediction, equal to the JAX package's."""
    pred = c.predict_partition_seconds(x_shape, w_shape, op)
    assert pred == pytest.approx(jc.predict_partition_seconds(x_shape, w_shape, op),
                                 rel=1e-12)
    return pred


def _resolve(c, jc, x_shape, w_shape, op):
    """The port's pick, equal to the JAX package's."""
    mode = c._resolve_mode(x_shape, w_shape, None, op)
    assert mode == jc._resolve_mode(x_shape, w_shape, None, op)
    return mode


def test_auto_picks_batch_on_fat_link_for_train():
    """Activation-heavy layer, big batch, >= 1 Gbps: batch must beat both
    kernel and spatial for the train op."""
    x_shape, w_shape = (32, 32, 32, 16), (3, 3, 16, 16)
    c, jc = _auto_clusters(1000.0)
    try:
        pred = _predict(c, jc, x_shape, w_shape, "train")
        assert pred["batch"] < pred["kernel"]
        assert pred["batch"] < pred["spatial"]
        assert _resolve(c, jc, x_shape, w_shape, "train") == "batch"
        assert c.partition_choices[(x_shape, w_shape)] == "batch"
    finally:
        c.shutdown()
        jc.shutdown()


def test_auto_keeps_kernel_or_spatial_on_thin_link():
    """At 25 Mbps on a parameter-heavy layer the per-slave full-dW return
    sinks batch, so auto keeps the kernel axis or spatial."""
    x_shape, w_shape = (4, 8, 8, 4), (5, 5, 4, 256)
    c, jc = _auto_clusters(25.0)
    try:
        pred = _predict(c, jc, x_shape, w_shape, "train")
        assert pred["kernel"] < pred["batch"]
        assert _resolve(c, jc, x_shape, w_shape, "train") in ("kernel", "spatial")
    finally:
        c.shutdown()
        jc.shutdown()


def test_auto_small_batch_granularity_prefers_intra_image_axes():
    """Batch's allocation unit is one SAMPLE: at b=2 over 3 slow devices
    the 2-row quantum hurts, and the chooser keeps an intra-image axis."""
    x_shape, w_shape = (2, 32, 32, 16), (3, 3, 16, 16)
    c, jc = _auto_clusters(25.0)
    try:
        _pinned(c, jc, [3e-3, 3e-3, 3e-3])
        pred = _predict(c, jc, x_shape, w_shape, "conv")
        assert pred["batch"] > min(pred["kernel"], pred["spatial"])
        assert _resolve(c, jc, x_shape, w_shape, "conv") in ("kernel", "spatial")
    finally:
        c.shutdown()
        jc.shutdown()


# ---------------------------------------------------------------------------
# decision caches: bounded, memoized, invalidated on membership change


def test_mode_cache_memoizes_repeated_slab_sizes(monkeypatch):
    """Repeated slab sizes must hit the memo instead of re-running the
    predictor every slab, in both packages."""
    c, jc = _auto_clusters(50.0)
    calls = {"port": 0, "jax": 0}
    for name, mod in (("port", plans), ("jax", jax_plans)):
        def counting(*a, _real=mod.predict_partition_seconds, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, "predict_partition_seconds", counting)
    try:
        w_shape = (3, 3, 16, 16)
        for slab in (1, 3, 4, 3, 1, 4, 3, 1):  # 3 distinct sizes
            _resolve(c, jc, (slab, 16, 16, 16), w_shape, "conv")
        assert calls == {"port": 3, "jax": 3}
        # picks recorded per (x_shape, w_shape), batch dim included
        assert len(c.partition_choices) == 3
        assert dict(c.partition_choices) == dict(jc.partition_choices)
    finally:
        c.shutdown()
        jc.shutdown()


def test_partition_caches_are_bounded_under_mixed_slabs():
    """A serve lane cycling through many distinct slab sizes must not
    grow the planner's caches without bound."""
    c, jc = _auto_clusters(50.0)
    try:
        w_shape = (3, 3, 8, 8)
        for slab in range(1, 400):
            _resolve(c, jc, (slab, 16, 16, 8), w_shape, "conv")
        for cl in (c, jc):
            assert len(cl.partition_choices) <= cl.partition_choices.maxsize
            assert len(cl._mode_cache) <= cl._mode_cache.maxsize
            # the most recent slab's pick is still present (FIFO evicts old)
            assert ((399, 16, 16, 8), w_shape) in cl.partition_choices
        assert dict(c.partition_choices) == dict(jc.partition_choices)
    finally:
        c.shutdown()
        jc.shutdown()


def test_mode_cache_invalidated_on_membership_change():
    """admit()/evict() change the Eq. 1 inputs, so memoized auto picks
    are dropped with partition_choices."""
    c, jc = _auto_clusters(50.0)
    try:
        for cl in (c, jc):
            cl._resolve_mode((8, 16, 16, 8), (3, 3, 8, 8), None, "conv")
            assert len(cl._mode_cache) == 1
            dev = cl.admit(slowdown=1.0, backend="numpy", probe_time=1e-4)
            assert len(cl._mode_cache) == 0 and len(cl.partition_choices) == 0
            cl._resolve_mode((8, 16, 16, 8), (3, 3, 8, 8), None, "conv")
            cl.evict(dev)
            assert len(cl._mode_cache) == 0 and len(cl.partition_choices) == 0
    finally:
        c.shutdown()
        jc.shutdown()


# ---------------------------------------------------------------------------
# elasticity + chaos on the batch axis


def test_admit_evict_replan_moves_batch_rows():
    """Membership changes re-run the comm-aware Eq. 1 over the batch
    axis: an admitted member takes rows, an evicted member's rows fold
    back, and numerics stay exact throughout — with the JAX package's
    counts."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(9, 8, 8, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 8)).astype(np.float32)
    ref = jax_get_backend("numpy").conv(x, w)
    c, jc = clusters([1.0, 1.0], partition="batch")
    try:
        _pinned(c, jc, [1.0, 1.0])

        def counts(n_devices):
            plan = c.plan_conv(x.shape, w, "conv")
            plans.check_plan(plan, n_units=9, n_devices=n_devices)
            assert plan.counts.tolist() == jc.plan_conv(x.shape, w, "conv").counts.tolist()
            return plan.counts

        assert len(counts(2)) == 2
        _fwd_matches(c, jc, x, w, ref)
        devs = [cl.admit(slowdown=1.0, backend="numpy", probe_time=1.0) for cl in (c, jc)]
        assert devs[0] == devs[1]
        assert int(counts(3)[-1]) > 0  # the newcomer took batch rows
        _fwd_matches(c, jc, x, w, ref)
        for cl, dev in zip((c, jc), devs):
            cl.evict(dev)
        counts(2)
        _fwd_matches(c, jc, x, w, ref)
    finally:
        c.shutdown()
        jc.shutdown()


def test_sigkill_mid_step_batch_axis_recovers_on_survivors():
    """SIGKILL a TCP slave while a pipelined batch-partition train step
    has row slices in flight: the master recomputes the dead member's
    ROWS, the dW all-reduce still sums every row exactly once, and the
    gradients match the single-device VJP; the next step re-plans the
    batch rows over the survivors — in both packages."""
    x, w1, w2, g = _data(batch=6)
    want = single_device_grads(x, w1, w2, g)
    c, jc = clusters([1.0, 1.0, 1.0], transport="tcp", partition="batch",
                     pipeline=True, microbatches=3, heartbeat_s=2.0)
    try:
        results = []
        for cl in (c, jc):
            cl.probe_times = [1.0, 1.0, 1.0]
            victim_proc, victim_dev = cl.procs[0], cl.slave_ids[0]
            res = train_step(cl, x, w1, w2, g, first_between=victim_proc.kill)
            assert_matches(grads(res), want)
            assert len(cl.failures) == 1
            assert cl.failures[0]["device"] == victim_dev
            assert cl.slave_ids == [2] and cl.n_slaves == 1
            assert cl.timing.recompute_s > 0.0
            plan = cl.plan_conv(x.shape, w1, "train")
            plans.check_plan(plan, n_units=6, n_devices=2)
            results.append((res, train_step(cl, x, w1, w2, g)))
        (res, res2), (jres, jres2) = results
        check(res, jres, want)
        check(res2, jres2, want)
    finally:
        c.shutdown()
        jc.shutdown()
