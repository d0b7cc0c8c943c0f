"""Per-layer partition plans: which axis a conv layer splits on, and how.

The paper splits only the output-channel ("kernel") axis; the hybrid
runtime can also split the HEIGHT axis ("spatial": row strips + a
``kh//2`` halo), the BATCH axis ("batch": replicate the kernel, split
the N axis, sum the per-slave dW — an exact all-reduce), or pick the
cheapest axis per layer ("auto") from the comm-extended Eq. 1
prediction.  This module holds the pure planning math — strip/halo
geometry, batch-row ranges, per-unit wire bytes, the wall-clock
predictor and the axis resolver, and what each axis means for an op
(``axis``: a member's message, and the assembly of the members'
results) — over a duck-typed ``cluster`` that
supplies device state (``_effective_times``, ``shares_for``,
``bandwidths``, ``probe_flops``, ``_wire_itemsize``, ``partition``,
``partition_choices``).  No transport, no threads; each plan is a span
(``core/spans.py``) while a profiler records.  A kernel on the master's
device stays there in a kernel-axis plan; the spatial and batch axes
take its host copy (the span ``cluster.to_host``).
"""
from __future__ import annotations

import dataclasses
import functools
import operator
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import spans
from repro_torch.core.backends import concat, is_tensor, seam

PARTITION_MODES = ("kernel", "spatial", "batch", "auto")
# the FLOPs of what a plan governs, in forward passes of the layer: the
# backward (dX + dW) costs ~2x the forward's
FLOPS_MULT = {"conv": 1.0, "bwd": 2.0, "train": 3.0}


class LayerProbe(NamedTuple):
    """One conv layer's Eq. 1 input (``HeteroCluster.layer_probe``):
    each device's time of the reference convolution at the layer's own
    geometry, in device order, and that convolution's FLOPs."""

    times: List[float]
    flops: float


class BoundedDict(dict):
    """A dict with a FIFO size bound: inserting past ``maxsize`` evicts
    the oldest key.  Backs ``partition_choices`` and the auto-mode memo
    so serve-lane dynamic batching (a new key per slab batch size)
    cannot grow the planner's caches without bound."""

    def __init__(self, maxsize: int = 128):
        super().__init__()
        self.maxsize = int(maxsize)

    def __setitem__(self, key, value):
        if key in self:
            del self[key]  # re-insert at the back so live keys survive
        super().__setitem__(key, value)
        while len(self) > self.maxsize:
            del self[next(iter(self))]


def strip_plan(
    h: int, kh: int, counts: Sequence[int]
) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int, int, int]]]:
    """Cut H output rows into per-device strips sized by ``counts`` and
    derive each strip's halo'd input window: rows [lo, hi) of the input
    plus (pad_top, pad_bot) zero rows that restore the clipped SAME
    padding at the image border.  Empty strips get empty windows."""
    ph, pb = kh // 2, kh - 1 - (kh // 2)
    rows: List[Tuple[int, int]] = []
    halos: List[Tuple[int, int, int, int]] = []
    r0 = 0
    for c in counts:
        r1 = r0 + int(c)
        if r1 == r0:
            rows.append((r0, r0))
            halos.append((r0, r0, 0, 0))
            continue
        lo, hi = max(0, r0 - ph), min(h, r1 + pb)
        halos.append((lo, hi, ph - (r0 - lo), pb - (hi - r1)))
        rows.append((r0, r1))
        r0 = r1
    assert r0 == h, "strip counts must sum to H"
    return rows, halos


def batch_ranges(counts: Sequence[int], b: int) -> List[Tuple[int, int]]:
    """Per-device ``[r0, r1)`` batch-row ranges for a slab of ``b``
    rows, proportional to ``counts`` (largest-remainder rounding,
    deterministic).  A batch plan is built from the FULL batch shape
    but each microbatch scatter moves a slice whose N differs — the
    plan's proportions are re-cut to the actual slab here, so the
    device shares hold at every pipeline depth.  When ``b`` equals
    ``sum(counts)`` the ranges reproduce ``counts`` exactly.  Devices
    with a zero share get empty ranges (and ship zero rows)."""
    c = np.asarray(counts, dtype=np.float64)
    total = float(c.sum())
    assert total > 0, "batch plan must cover at least one row"
    ideal = c * (b / total)
    base = np.floor(ideal).astype(np.int64)
    rem = int(b - base.sum())
    order = np.argsort(-(ideal - np.floor(ideal)), kind="stable")
    for j in range(rem):
        base[order[j % len(base)]] += 1
    out: List[Tuple[int, int]] = []
    r0 = 0
    for cc in base:
        out.append((r0, r0 + int(cc)))
        r0 += int(cc)
    assert r0 == b, "batch ranges must tile the slab"
    return out


@dataclasses.dataclass
class LayerPlan:
    """How ONE conv layer is split over the devices — fixed for every
    microbatch of the layer (the slave caches one kernel shard per op,
    so the split must not drift between microbatches).

    ``member_ids`` pins the membership the plan was built for: the
    stable slave ids behind ``counts[1:]``, in order.  An elastic
    cluster may lose a slave while a plan is still live (later
    microbatches, the backward sweep) — scatters resolve shard k to
    member ``member_ids[k-1]``, never to "whatever the k-th live slave
    is now", and the master absorbs shards of members that died."""

    mode: str                     # "kernel" | "spatial" | "batch" (auto is resolved)
    counts: np.ndarray            # kernels / H rows / batch rows per device
    shards: Optional[List[np.ndarray]] = None  # kernel mode: w split per device
    w: Optional[np.ndarray] = None             # spatial+batch: the full kernel
    rows: Optional[List[Tuple[int, int]]] = None  # H strips or batch ranges
    halos: Optional[List[Tuple[int, int, int, int]]] = None
    member_ids: Optional[Tuple[int, ...]] = None  # slave ids behind counts[1:]
    # versioned weight-broadcast cache: the stable key this layer's
    # kernel is cached under on the slaves (None = legacy per-op cache)
    # and the version frozen when the plan was built — scatters ship a
    # WeightRef token instead of the kernel when a slave already holds
    # (wkey, wversion) with this plan's geometry
    wkey: Optional[object] = None
    wversion: int = 0


def split_kernels(w: np.ndarray, counts: np.ndarray) -> List[np.ndarray]:
    """Split the kernel's (or a gradient's) output-channel axis into
    contiguous per-device shards, on ``w``'s device where it is a tensor:
    each device computes on the layout a wire delivers, whichever side
    of the seam its shard comes from."""
    if is_tensor(w):
        return [s.contiguous() for s in w.split([int(c) for c in counts], dim=-1)]
    edges = np.cumsum(counts)[:-1]
    return [np.ascontiguousarray(s) for s in np.split(w, edges, axis=-1)]


def _sum(terms):
    """The terms added in their order (device order)."""
    return functools.reduce(operator.add, terms)


class _Axis:
    """What a partition axis means for one op (``"conv"`` or ``"bwd"``).

    ``message(plan, op, k, x, g, cut)`` is member k's part of the op,
    ``(wire op, operands)`` with the kernel or its shard in operand
    slot 1, built from the slab ``x`` (and the gradient ``g``) as that
    member takes it; ``cut`` is what ``cut(plan, op, x, g)`` derives once
    per op from the slab.  ``assemble(plan, op, parts, x)`` puts the
    members' results, in device order, back together.

    ``card``: whether the master computes its part on the op's own
    operands, card tensors on the card path; each slave's result then
    crosses to the card before the assembly.  Otherwise the op's x and g
    cross to the host at its boundary, and every part is computed and
    assembled there."""

    card = False

    def cut(self, plan, op, x, g):
        return None


class _KernelAxis(_Axis):
    """Output channels: every member convolves the whole x with its
    kernel shard (and its slice of g's channels); y and dW concatenate
    on the channels, the partial dX sum."""

    card = True

    def cut(self, plan, op, x, g):
        return None if op == "conv" else split_kernels(g, plan.counts)

    def message(self, plan, op, k, x, g, cut):
        if op == "conv":
            return "conv", (x, plan.shards[k])
        return "bwd", (x, plan.shards[k], cut[k])

    def assemble(self, plan, op, parts, x):
        if op == "conv":
            return concat(parts, -1)
        return _sum(dx for dx, _ in parts), concat([dw for _, dw in parts], -1)


class _SpatialAxis(_Axis):
    """Height strips: member k convolves its rows of x with their halo
    and the full kernel (the ops ``sconv``/``sbwd``); y's strips
    concatenate on the height, the halo'd dX overlap-add into zeros and
    dW sums."""

    def message(self, plan, op, k, x, g, cut):
        lo, hi, pt, pb = plan.halos[k]
        if op == "conv":
            return "sconv", (x[:, lo:hi], plan.w, pt, pb)
        r0, r1 = plan.rows[k]
        return "sbwd", (x[:, lo:hi], plan.w, g[:, r0:r1], pt, pb)

    def assemble(self, plan, op, parts, x):
        if op == "conv":
            return concat(parts, 1)
        dx = np.zeros(x.shape, np.float32)
        for (dxh, _), (lo, hi, _, _) in zip(parts, plan.halos):
            dx[:, lo:hi] += dxh  # the halo seams overlap-sum here
        return dx, _sum(dw for _, dw in parts)


class _BatchAxis(_Axis):
    """Sample rows: member k convolves its rows of x (and of g) with the
    full kernel, the plan's shares re-cut to this slab's rows by
    ``batch_ranges`` (a microbatch's N differs from the planning
    shape); y and dX concatenate on the rows, and dW sums, an exact
    all-reduce over disjoint rows."""

    def cut(self, plan, op, x, g):
        return batch_ranges(plan.counts, x.shape[0])

    def message(self, plan, op, k, x, g, cut):
        r0, r1 = cut[k]
        if op == "conv":
            return "conv", (x[r0:r1], plan.w)
        return "bwd", (x[r0:r1], plan.w, g[r0:r1])

    def assemble(self, plan, op, parts, x):
        if op == "conv":
            return concat(parts, 0)
        return concat([dx for dx, _ in parts], 0), _sum(dw for _, dw in parts)


AXES = {"kernel": _KernelAxis(), "spatial": _SpatialAxis(), "batch": _BatchAxis()}


def axis(plan: LayerPlan) -> _Axis:
    """The rule of the axis ``plan`` splits on."""
    return AXES[plan.mode]


def unit_bytes(
    x_shape, w_shape, mode: str, op: str, itemsize: float,
    w_itemsize: Optional[float] = None, g_itemsize: Optional[float] = None,
    w_cached: bool = False,
) -> float:
    """Share-proportional wire bytes per allocation unit — one KERNEL
    (w column out + feature-map column back, plus the gradient slice
    and dW column for bwd), one H ROW (x row out + y row back, plus
    the g row and dX row for bwd), or one BATCH ROW (one sample's x
    out + y back; bwd adds the sample's g out and dX back).
    ``op="train"`` is one forward plus one backward, what a
    train-chain plan governs.  Fixed per-slave costs (the x broadcast,
    the halo, the full kernel, the kernel-mode backward's full-dX
    return, the batch-mode backward's full-dW return) do not move the
    optimal split and are left to the mode predictor.

    Byte prediction sees the codec and the weight cache: ``itemsize``
    prices activation elements, ``w_itemsize``/``g_itemsize`` (default:
    same) price weight/gradient elements, and ``w_cached=True`` zeroes
    the weight-shipping terms — a versioned-cache hit means the slaves
    already hold this layer's kernel."""
    w_item = itemsize if w_itemsize is None else w_itemsize
    g_item = itemsize if g_itemsize is None else g_itemsize
    b, h, wd, cin = x_shape
    kh, kw, _, cout = w_shape
    if mode == "kernel":
        w_col = kh * kw * cin
        y_col = b * h * wd
        w_ship = 0.0 if w_cached else w_col * w_item
        conv = w_ship + y_col * itemsize   # w col out + y col back
        # bwd: w col + g col out, dW col back; the full-dX return is
        # a FIXED per-slave cost, excluded by this contract
        bwd = w_ship + y_col * g_item + w_col * g_item
    elif mode == "batch":
        x_smp = h * wd * cin
        y_smp = h * wd * cout
        conv = (x_smp + y_smp) * itemsize  # x sample out + y sample back
        # x + g samples out, dX sample back; the full-dW return is a
        # FIXED per-slave cost, excluded by this contract
        bwd = x_smp * itemsize + (y_smp + x_smp) * g_item
    else:
        x_row = b * wd * cin
        y_row = b * wd * cout
        conv = (x_row + y_row) * itemsize  # x row out + y row back
        # x + g rows out, dX row back
        bwd = x_row * itemsize + (y_row + x_row) * g_item
    if op == "conv":
        return conv
    if op == "bwd":
        return bwd
    return conv + bwd              # "train"


def predict_partition_seconds(
    cluster, x_shape, w_shape, op: str = "conv",
    weights_cached: bool = False, layer: Optional[LayerProbe] = None,
) -> Dict[str, float]:
    """Predicted per-layer wall-clock of each partition axis: every
    slave's wire bytes over its OWN link plus its balanced compute
    share (absolute once a real ``probe()`` has calibrated
    ``probe_flops``; otherwise the comm term alone decides — the
    compute splits near-identically on both axes).  ``op`` is what
    the plan will govern: ``"conv"`` (forward only), ``"bwd"``, or
    ``"train"`` (one forward + one backward) — the backward's wire
    differs by axis (kernel mode re-broadcasts x AND returns a
    full-size dX per slave; spatial ships strips both ways; batch
    ships row slices both ways but returns a FULL dW per slave, the
    all-reduce cost that sinks data parallelism on thin links), so a
    train-step plan must weigh both directions.  The prediction sees
    the codec (per-class wire itemsizes — batch's dW return is priced
    at the grads itemsize, so ``grads=topk`` + error feedback
    discounts the all-reduce per slave) and the versioned weight
    cache (``weights_cached=True`` zeroes the kernel-shipping terms,
    which makes batch's replica broadcast nearly free after step 1).
    ``layer``: the layer's own probe, in place of the cluster-wide
    one."""
    b, h, wd, cin = x_shape
    kh, kw, _, cout = w_shape
    item = cluster._wire_itemsize
    item_w = getattr(cluster, "_wire_itemsize_w", item)
    item_g = getattr(cluster, "_wire_itemsize_g", item)
    x_e = float(b * h * wd * cin)    # activation elements
    y_e = float(b * h * wd * cout)   # output / gradient-slice elements
    w_e = float(kh * kw * cin * cout)
    x_b, y_b, w_b = x_e * item, y_e * item, w_e * item
    w_ship = 0.0 if weights_cached else w_e * item_w
    times = cluster._effective_times(layer)
    layer_flops = 2.0 * b * h * wd * kh * kw * cin * cout
    flops_mult = FLOPS_MULT[op]
    probe_flops = cluster.probe_flops if layer is None else layer.flops
    scale = (layer_flops / probe_flops) if probe_flops else None
    out: Dict[str, float] = {}
    for mode in ("kernel", "spatial", "batch"):
        n_units = {"kernel": cout, "spatial": h, "batch": b}[mode]
        counts = cluster.shares_for(
            n_units,
            unit_bytes=unit_bytes(
                x_shape, w_shape, mode, op, item,
                w_itemsize=item_w, g_itemsize=item_g,
                w_cached=weights_cached,
            ),
            layer_flops=flops_mult * layer_flops,
            layer=layer,
        )
        worst = 0.0
        for i, c in enumerate(counts):
            bw = None if i == 0 else cluster.bandwidths[i - 1]
            frac = float(c) / n_units if n_units else 0.0
            halo = min(kh - 1, h) if c > 0 else 0
            if mode == "kernel":
                fwd_wire = x_b + frac * (w_ship + y_b)
                # x re-broadcast + g slice out; full dX + dW cols back
                bwd_wire = (
                    x_b + x_e * item_g
                    + frac * (w_ship + y_e * item_g)
                )
                comp_frac = frac
                active = i > 0
            elif mode == "batch":
                # x rows + full kernel out; y rows back
                fwd_wire = frac * (x_b + y_b) + w_ship
                # x + g rows out; dX rows + the FULL dW back per slave
                # (the exact all-reduce — its cost is constant in the
                # batch share, priced at the grads itemsize)
                bwd_wire = (
                    frac * (x_b + x_e * item_g + y_e * item_g)
                    + w_ship + w_e * item_g
                )
                comp_frac = frac
                active = i > 0 and c > 0
            else:
                hfrac = (c + halo) / h
                fwd_wire = hfrac * x_b + w_ship + frac * y_b
                # x strip + g strip out; dX halo strip + full dW back
                bwd_wire = (
                    hfrac * (x_b + x_e * item_g)
                    + w_ship + w_e * item_g
                    + frac * y_e * item_g
                )
                comp_frac = hfrac
                active = i > 0 and c > 0
            wire = {
                "conv": fwd_wire,
                "bwd": bwd_wire,
                "train": fwd_wire + bwd_wire,
            }[op] if active else 0.0
            t_comm = wire * 8.0 / (bw * 1e6) if bw is not None else 0.0
            t_comp = (
                times[i] * scale * comp_frac * flops_mult if scale else 0.0
            )
            worst = max(worst, t_comm + t_comp)
        out[mode] = worst
    return out


def resolve_mode(
    cluster, x_shape, w_shape, override: Optional[str], op: str = "conv",
    weights_cached: bool = False, layer: Optional[LayerProbe] = None,
) -> str:
    """The partition axis for one layer; ``"auto"`` resolves against
    the predicted wall-clock of ``op`` and records its pick in
    ``cluster.partition_choices``.

    The decision key includes the batch dimension (it rides in
    ``x_shape``: batch mode's unit count and every mode's bytes scale
    with N), ``op`` and the weight-cache state — serve-lane dynamic
    batching re-resolves per slab size deliberately, but through the
    cluster's bounded ``_mode_cache`` memo so repeated slab sizes skip
    the predictor and the caches stay bounded.  Ties break toward the
    paper's order (kernel, then spatial, then batch): a challenger
    axis must be strictly faster to displace the incumbent.  ``layer``:
    the layer's own probe (``predict_partition_seconds``)."""
    mode = override or cluster.partition
    if mode not in PARTITION_MODES:
        raise ValueError(
            f"partition must be one of {PARTITION_MODES}, got {mode!r}"
        )
    if mode != "auto":
        return mode
    shape_key = (tuple(x_shape), tuple(w_shape))
    memo = getattr(cluster, "_mode_cache", None)
    memo_key = shape_key + (op, bool(weights_cached), layer is not None)
    if memo is not None and memo_key in memo:
        choice = memo[memo_key]
        cluster.partition_choices[shape_key] = choice
        return choice
    if all(bw is None for bw in cluster.bandwidths):
        # free links: the paper's kernel axis, no halo / all-reduce
        # overhead to pay back
        choice = "kernel"
    else:
        pred = predict_partition_seconds(
            cluster, x_shape, w_shape, op, weights_cached=weights_cached,
            layer=layer,
        )
        choice = "kernel"
        for challenger in ("spatial", "batch"):
            if pred[challenger] < pred[choice]:
                choice = challenger
    if memo is not None:
        memo[memo_key] = choice
    cluster.partition_choices[shape_key] = choice
    return choice


def plan_conv(
    cluster, x_shape, w: np.ndarray, op: str = "conv",
    partition: Optional[str] = None, weight_key=None,
    layer: Optional[LayerProbe] = None,
) -> LayerPlan:
    """Freeze how one conv layer splits over the devices: the axis
    (resolving ``"auto"`` against what the plan will govern — ``op``
    is ``"conv"``, ``"bwd"`` or ``"train"``), the Eq. 1(+comm) unit
    counts, the per-device kernel shards or row strips, and the
    membership snapshot (``member_ids``) the split binds to.  One
    plan serves every microbatch of the layer — the slave caches ONE
    kernel shard per op, so the split must not drift within a
    layer.

    ``weight_key`` opts the layer into the versioned weight-broadcast
    cache: the cluster's version store decides whether this kernel
    object is ALREADY current on the slaves (same array identity as
    the version it last shipped), and a current version both discounts
    the weight terms in the byte prediction and lets scatters ship a
    ~24-byte ``WeightRef`` token instead of the kernel.

    ``layer`` (a training chain's, ``HeteroCluster.layer_probe``) feeds
    Eq. 1 the layer's own probe times in place of the cluster-wide
    ones; its comm term then scales them by what the plan governs
    (``FLOPS_MULT``).  Without it the comm term keeps the forward's
    FLOPs, as the JAX package's planner does.

    While a profiler records, each plan is the span ``cluster.plan``
    (labels ``eq1``: ``layer`` or ``probe``; ``units``: the plan's
    kernels or rows; ``cpu_units``: those on devices whose backend is
    not ``cuda``; ``axis``)."""
    t0 = time.perf_counter()
    plan = _plan_conv(cluster, x_shape, w, op, partition, weight_key, layer)
    if spans.recording():
        spans.record(
            "cluster.plan", t0, time.perf_counter(),
            eq1="probe" if layer is None else "layer",
            units=int(np.sum(plan.counts)),
            cpu_units=int(sum(c for c, b in zip(plan.counts, cluster.backends)
                              if b != "cuda")),
            axis=plan.mode,
        )
    return plan


def _plan_conv(cluster, x_shape, w, op, partition, weight_key, layer):
    wkey = weight_key if getattr(cluster, "weight_cache", False) else None
    wversion, wcached = 0, False
    if wkey is not None:
        wversion, wcached = cluster._weight_version(wkey, w)
    mode = resolve_mode(
        cluster, tuple(x_shape), tuple(w.shape), partition, op,
        weights_cached=wcached, layer=layer,
    )
    b, h, wd, cin = x_shape
    kh, kw, _, cout = w.shape
    layer_flops = 2.0 * b * h * wd * kh * kw * cin * cout
    if layer is not None:
        layer_flops *= FLOPS_MULT[op]
    item = cluster._wire_itemsize
    ub = unit_bytes(
        x_shape, w.shape, mode, op, item,
        w_itemsize=getattr(cluster, "_wire_itemsize_w", item),
        g_itemsize=getattr(cluster, "_wire_itemsize_g", item),
        w_cached=wcached,
    )
    members = getattr(cluster, "slave_ids", None)
    members = tuple(members) if members is not None else None
    if mode == "kernel":
        counts = cluster.shares_for(
            cout, unit_bytes=ub, layer_flops=layer_flops, layer=layer
        )
        return LayerPlan(
            "kernel", counts, shards=split_kernels(w, counts),
            member_ids=members, wkey=wkey, wversion=wversion,
        )
    if mode == "batch":
        # replicate the kernel, split the N axis; each microbatch
        # scatter re-cuts ``counts`` to its slab via ``batch_ranges``
        counts = cluster.shares_for(
            b, unit_bytes=ub, layer_flops=layer_flops, layer=layer
        )
        return LayerPlan(
            "batch", counts, w=seam(None, "cluster.to_host", w=w),
            rows=batch_ranges(counts, int(b)),
            member_ids=members, wkey=wkey, wversion=wversion,
        )
    counts = cluster.shares_for(
        h, unit_bytes=ub, layer_flops=layer_flops, layer=layer
    )
    rows, halos = strip_plan(h, kh, counts)
    return LayerPlan(
        "spatial", counts, w=seam(None, "cluster.to_host", w=w), rows=rows,
        halos=halos, member_ids=members, wkey=wkey, wversion=wversion,
    )


def group_aggregate_time(times: Sequence[float]) -> float:
    """Aggregate Eq. 1 probe time of a GROUP of devices working in
    parallel: member compute RATES add, so the group's time per probe
    workload is the harmonic combination ``1 / sum(1 / t_i)`` — always
    positive, and degenerate topologies stay well-defined (a one-member
    group is just that member's time; equal members divide it by the
    member count).  This is the single number a sub-master reports
    upward so the root can price a whole group as one Eq. 1 device.

    Raises:
        ValueError: on an empty group or a non-positive member time
            (a zero time would divide by zero AND claim infinite
            capacity — a probe that fast is a bug, not a device).
    """
    ts = [float(t) for t in times]
    if not ts:
        raise ValueError("group_aggregate_time needs at least one member")
    if any(t <= 0.0 for t in ts):
        raise ValueError(f"member probe times must be positive, got {ts}")
    return 1.0 / sum(1.0 / t for t in ts)


def group_capacity(
    times: Sequence[float], bandwidths: Sequence[Optional[float]]
) -> Tuple[float, Optional[float]]:
    """A group's (aggregate probe time, internal bandwidth) as ONE
    Eq. 1 device: compute rates SUM (``group_aggregate_time``), while
    the internal bandwidth is the MIN of the members' finite link
    speeds — a chain is as fast as its narrowest hop, and the root
    folds this into the group's uplink so rows are never priced faster
    than the group can internally redistribute them.  ``None`` entries
    mean an unmetered (in-proc) link and are skipped; all-``None``
    yields ``None`` (no finite internal bottleneck to report)."""
    finite = [float(b) for b in bandwidths if b is not None]
    return group_aggregate_time(times), (min(finite) if finite else None)


def check_plan(plan: LayerPlan, n_units: int, n_devices: int) -> None:
    """Invariants every live plan must satisfy — what the re-partition
    conformance tests assert after an evict/admit: unit counts cover the
    layer exactly once over exactly the current membership, spatial
    strips tile [0, n_units) with in-bounds halo windows, and batch
    ranges tile the batch.  Raises AssertionError with a named
    reason."""
    assert len(plan.counts) == n_devices, (
        f"plan covers {len(plan.counts)} devices, membership has {n_devices}"
    )
    assert int(np.sum(plan.counts)) == n_units, (
        f"plan units sum to {int(np.sum(plan.counts))}, layer has {n_units}"
    )
    if plan.member_ids is not None:
        assert len(plan.member_ids) == n_devices - 1, "one member id per slave"
    if plan.mode == "kernel":
        assert plan.shards is not None and len(plan.shards) == n_devices
        assert sum(s.shape[-1] for s in plan.shards) == n_units
        return
    if plan.mode == "batch":
        assert plan.w is not None, "batch plan carries the full kernel"
        assert plan.rows is not None and len(plan.rows) == n_devices
        r_prev = 0
        for r0, r1 in plan.rows:
            assert r1 >= r0, "batch range non-negative"
            if r1 > r0:
                assert r0 == r_prev, "batch ranges tile in order"
                r_prev = r1
        assert r_prev == n_units, "batch ranges cover every row"
        return
    assert plan.rows is not None and plan.halos is not None
    r_prev = 0
    for (r0, r1), (lo, hi, pt, pb) in zip(plan.rows, plan.halos):
        assert r0 == (r_prev if r1 > r0 else r0), "strips tile in order"
        if r1 > r0:
            r_prev = r1
        assert 0 <= lo <= hi <= n_units, "halo window inside the image"
        assert pt >= 0 and pb >= 0, "halo pads non-negative"
    assert r_prev == n_units, "strips cover every output row"
