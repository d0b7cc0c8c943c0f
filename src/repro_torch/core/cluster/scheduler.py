"""Pipelined schedules over a cluster's scatter/gather primitives.

The per-op barrier (scatter -> compute -> gather -> ack) is replaced by
split ``scatter_*`` / ``gather_*`` halves with FIFO ordering per link.
With ``pipeline=True`` the batch is cut into microbatches and
double-buffered: the master issues the next microbatch's scatter while
the slaves' results for the current one are still in flight, and
``conv_forward_chain`` keeps slave queues non-empty across consecutive
conv layers so the master's non-conv work overlaps slave compute.

``conv_train_chain`` / ``conv_train_step`` extend the pipeline to the
WHOLE training step: the forward chain stashes each conv layer's input
and the VJP of every master-only between stage, the master computes the
loss head, and the backward chain reuses the same ``Pending`` FIFO and
microbatch machinery for the ``bwd`` op — the backward scatter of layer
k is issued while layer k+1's backward gathers (and the master's
between-VJP / head gradients) are still in flight.  Unlike the depth-2
forward chain, the train chain keeps up to ``microbatches`` ops in
flight per phase boundary (the total queued bytes still equal ONE
barrier-mode scatter of the full batch); a real flow-controlled
transport behind the channel would need a window of that many messages
— which is why ``TCPTransport`` writes through an async writer thread.

Every driver takes the cluster as its first argument and runs over
whatever transport the cluster was built on; ``HeteroCluster`` exposes
them as methods.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster.plans import LayerPlan, plan_conv


@dataclasses.dataclass
class LayerTiming:
    """Wall-clock breakdown of the cluster's work, accumulated across
    ops until ``reset_stats``; every field is seconds."""

    comm_s: float = 0.0         # scatter writes (master -> slave links)
    conv_s: float = 0.0         # conv phase: master's shard + gather
    comp_s: float = 0.0         # non-conv layers (master only)
    gather_wait_s: float = 0.0  # time the master blocked on slave results
    overlap_s: float = 0.0      # scatter->gather window minus the blocked
    #                             wait: comm/compute genuinely overlapped
    master_conv_s: float = 0.0  # master's own conv/bwd shard compute — the
    #                             denominator of its non-conv duty
    recompute_s: float = 0.0    # master time absorbing DEAD slaves' shards
    #                             (fault recovery; see cluster._recover_shard)


@dataclasses.dataclass
class TrainStepResult:
    """What one distributed training step hands back to the driver."""

    head_aux: list                 # per-microbatch head outputs (loss, ...)
    dw: List[np.ndarray]           # kernel gradient per conv layer
    dx: np.ndarray                 # gradient wrt the chain input


@dataclasses.dataclass
class Pending:
    """An in-flight scatter: the master's own shard is deferred to the
    gather so issuing the NEXT scatter never waits on local compute.

    An elastic cluster may lose a slave between this scatter and its
    gather, so a Pending carries enough to finish WITHOUT that slave:
    ``plan`` (the full split, every device's shard derivable), ``parts``
    (the participant links, frozen at scatter time — membership lists
    may have shrunk by gather time), and ``g_all`` (backward only: the
    whole microbatch gradient, so any member's slice can be recut).
    The gather reads live participants and recomputes dead ones' shards
    on the master — the step drains on the survivors."""

    op: str                       # "conv" | "bwd"
    seq: int                      # FIFO position; gathers must match
    x: np.ndarray                 # kernel mode: the broadcast input;
    #                               spatial/batch: the FULL input (the
    #                               master slices its own strip/rows at
    #                               gather)
    my_w: np.ndarray              # master's kernel shard (spatial/batch: full w)
    my_g: Optional[np.ndarray]    # bwd only: master's grad slice/strip/rows
    t_issued: float
    mode: str = "kernel"          # partition axis this op was split on
    rows: Optional[List[Tuple[int, int]]] = None
    #                               spatial: H strips [r0, r1) per device;
    #                               batch: N-axis ranges per device,
    #                               re-cut to THIS slab's batch size (a
    #                               microbatch's N differs from the
    #                               planning shape) — recovery recomputes
    #                               a dead member's rows from these
    halos: Optional[List[Tuple[int, int, int, int]]] = None
    #                               spatial: (lo, hi, pad_top, pad_bot) per device
    plan: Optional[LayerPlan] = None  # the split this op rode (recovery)
    parts: Optional[list] = None      # participant transports, scatter-time
    g_all: Optional[np.ndarray] = None  # bwd: full microbatch gradient


def microbatch_slices(cluster, batch: int) -> List[slice]:
    """The batch-axis slices the pipelined schedules will use for a
    given batch size — drivers split labels/targets identically."""
    n = cluster._n_micro(batch)
    sizes = [a.size for a in np.array_split(np.arange(batch), n)]
    out, start = [], 0
    for s in sizes:
        out.append(slice(start, start + s))
        start += s
    return out


def conv_forward(
    cluster, x: np.ndarray, w: np.ndarray, *, partition: Optional[str] = None
) -> np.ndarray:
    """Distributed convolution over the planned partition axis.
    Pipelined mode double-buffers microbatches along the batch axis
    (orthogonal to either split axis); the plan — and so the kernel
    shard each slave caches — is fixed across the microbatches."""
    x = np.asarray(x, np.float32)
    plan = plan_conv(cluster, x.shape, w, "conv", partition)
    n = cluster._n_micro(x.shape[0])
    if n == 1:
        return cluster.gather_conv(cluster._scatter_conv_planned(x, plan, True))
    parts = np.array_split(x, n, axis=0)
    outs = []
    pending = cluster._scatter_conv_planned(parts[0], plan, True)
    for nxt in parts[1:]:
        # next scatter in flight; slaves reuse the cached kernel
        nxt_pending = cluster._scatter_conv_planned(nxt, plan, False)
        outs.append(cluster.gather_conv(pending))
        pending = nxt_pending
    outs.append(cluster.gather_conv(pending))
    return np.concatenate(outs, axis=0)


def conv_backward(
    cluster, x: np.ndarray, w: np.ndarray, g: np.ndarray,
    *, partition: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Distributed VJP over the planned partition axis: kernel mode
    returns (partial-dX sums, concatenated dW shards); spatial mode
    seam-sums halo'd dX strips and sums full-kernel dW parts.
    Pipelined mode double-buffers microbatches; per-microbatch dW
    contributions are summed."""
    x = np.asarray(x, np.float32)
    g = np.asarray(g, np.float32)
    plan = plan_conv(cluster, x.shape, w, "bwd", partition)
    n = cluster._n_micro(x.shape[0])
    if n == 1:
        return cluster.gather_bwd(cluster._scatter_bwd_planned(x, plan, g, True))
    xs = np.array_split(x, n, axis=0)
    gs = np.array_split(g, n, axis=0)
    dxs: List[np.ndarray] = []
    dw_total: Optional[np.ndarray] = None
    pending = cluster._scatter_bwd_planned(xs[0], plan, gs[0], True)
    for xi, gi in zip(xs[1:], gs[1:]):
        nxt_pending = cluster._scatter_bwd_planned(xi, plan, gi, False)
        dx_i, dw_i = cluster.gather_bwd(pending)
        dxs.append(dx_i)
        dw_total = dw_i if dw_total is None else dw_total + dw_i
        pending = nxt_pending
    dx_i, dw_i = cluster.gather_bwd(pending)
    dxs.append(dx_i)
    dw_total = dw_i if dw_total is None else dw_total + dw_i
    return np.concatenate(dxs, axis=0), dw_total


def group_forward(cluster, x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """One tier-2 forward: what a sub-master computes when the root
    ships it a ``("conv", (x, w))`` batch-row slice — the inner
    cluster's full (pipelined, per-layer-partitioned) ``conv_forward``,
    guarded for the degenerate slices a two-level batch plan legally
    produces.  A zero-row slice (this group earned no rows of the slab)
    or a zero-kernel layer never touches the inner planner — batch
    plans require at least one row — and returns the exact
    correctly-shaped zero-size result instead."""
    x = np.asarray(x, np.float32)
    if x.shape[0] == 0 or w.shape[-1] == 0:
        return np.zeros(x.shape[:3] + (w.shape[-1],), np.float32)
    return conv_forward(cluster, x, w)


def group_backward(
    cluster, x: np.ndarray, w: np.ndarray, g: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """One tier-2 backward: the sub-master's answer to ``("bwd",
    (x, w, g))`` — the inner cluster's distributed VJP over the group's
    batch rows, returning (dX over those rows, the FULL dW summed over
    the group's members).  The root sums these per-group full dWs over
    disjoint row sets: the same exact all-reduce the flat batch axis
    proved, just with groups as the members.  Zero-row / zero-kernel
    slices short-circuit to zero arrays (a zero dW contribution is the
    correct term for a group holding no rows)."""
    x = np.asarray(x, np.float32)
    if x.shape[0] == 0 or w.shape[-1] == 0:
        return (
            np.zeros(x.shape, np.float32),
            np.zeros(w.shape, np.float32),
        )
    return conv_backward(cluster, x, w, np.asarray(g, np.float32))


def conv_forward_chain(
    cluster,
    x: np.ndarray,
    layer_weights: Sequence[np.ndarray],
    between: Optional[Sequence[Optional[Callable[[np.ndarray], np.ndarray]]]] = None,
) -> np.ndarray:
    """Run consecutive conv layers over the cluster; ``between[k]``
    is the master-only non-conv stage after layer k (ReLU/LRN/pool).

    In pipelined mode the microbatches are double-buffered through
    each layer, so the master's between-layer work for microbatch i
    overlaps the slaves' convolutions for microbatch i+1 — the
    slave queues stay non-empty across the whole chain.  In barrier
    mode every layer is scatter -> compute -> gather -> between on
    the full batch, the paper's schedule."""
    if between is None:
        between = [None] * len(layer_weights)
    assert len(between) == len(layer_weights)
    x = np.asarray(x, np.float32)
    batch = x.shape[0]
    n = cluster._n_micro(batch)
    parts: List[np.ndarray] = np.array_split(x, n, axis=0) if n > 1 else [x]
    for w, f in zip(layer_weights, between):
        # plan from the FULL batch shape: one split per layer, every
        # microbatch rides it (and the slave's cached kernel)
        plan = plan_conv(cluster, (batch,) + parts[0].shape[1:], w, "conv")
        if len(parts) == 1:
            y = cluster.gather_conv(cluster._scatter_conv_planned(parts[0], plan, True))
            parts = [cluster._master_comp(f, y) if f else y]
            continue
        outs: List[np.ndarray] = []
        pending = cluster._scatter_conv_planned(parts[0], plan, True)
        for nxt in parts[1:]:
            nxt_pending = cluster._scatter_conv_planned(nxt, plan, False)
            y = cluster.gather_conv(pending)
            outs.append(cluster._master_comp(f, y) if f else y)
            pending = nxt_pending
        y = cluster.gather_conv(pending)
        outs.append(cluster._master_comp(f, y) if f else y)
        parts = outs
    cluster._update_comp_duty()
    return np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]


def conv_train_chain(
    cluster,
    x: np.ndarray,
    layer_weights: Sequence[np.ndarray],
    between: Optional[Sequence[Optional[Callable]]] = None,
    head: Optional[Callable] = None,
) -> TrainStepResult:
    """One distributed training step over consecutive conv layers —
    forward AND backward pipelined across the cluster.

    ``between[k]`` is the master-only stage after conv layer k:
    ``f(y) -> (z, vjp)`` with ``vjp(gz) -> gy`` (None = identity).
    ``head(z, i) -> (aux, gz)`` is the master-only loss head on the
    final stage output of microbatch i (indices follow
    ``microbatch_slices``); its gradient seeds the backward chain.

    The schedule is ONE software pipeline over the phases
    ``[fwd L0 .. fwd Lk, bwd Lk .. bwd L0]``: each phase's scatters
    are issued as the previous phase's gathers complete, so the
    backward scatter of layer k goes out while layer k+1's backward
    gathers — and the master-only between-VJPs / head gradients — are
    still in flight, and the slave queues stay non-empty across the
    forward->backward turnaround.  The forward stashes each conv
    layer's input and each between stage's VJP; every phase re-sends
    its kernel shard once and microbatches after the first ride the
    slave's cached copy.  Gathers follow global scatter order, so the
    FIFO contract holds even though ``conv`` and ``bwd`` ops
    interleave on the wire.
    """
    L = len(layer_weights)
    assert L >= 1 and head is not None, "need >= 1 conv layer and a head"
    if between is None:
        between = [None] * L
    assert len(between) == L
    # split along the SAME slices drivers use for labels/targets, by
    # construction (head(z, i) pairs activations with slice i)
    x = np.asarray(x, np.float32)
    slices = microbatch_slices(cluster, x.shape[0])
    parts: List[np.ndarray] = [x[sl] for sl in slices]
    n = len(parts)

    # plans fixed for the whole step: fwd and bwd must split every
    # layer identically (comp_duty updates only at the end).  Built
    # lazily at each layer's first microbatch — spatial/auto plans
    # need the layer's ACTUAL activation shape, unknown until the
    # between stages have run.
    plans: List[Optional[LayerPlan]] = [None] * L

    def plan_for(k: int, xi: np.ndarray) -> LayerPlan:
        if plans[k] is None:
            # op="train": the plan governs BOTH sweeps, so the auto
            # axis and the comm-aware counts weigh fwd + bwd wire.
            # weight_key opts the layer into the versioned broadcast
            # cache: the backward sweep (and every microbatch after
            # the first) ships a token, never the kernel again
            plans[k] = plan_conv(
                cluster, (x.shape[0],) + xi.shape[1:], layer_weights[k],
                "train", weight_key=("train", k),
            )
        return plans[k]

    stash_x: List[List[Optional[np.ndarray]]] = [[None] * n for _ in range(L)]
    stash_vjp: List[List[Optional[Callable]]] = [[None] * n for _ in range(L)]
    head_aux: list = [None] * n

    def fwd_finish(k: int, i: int, p: Pending) -> np.ndarray:
        """Gather conv layer k / microbatch i and run the master-only
        between stage, stashing its VJP for the backward sweep."""
        y = cluster.gather_conv(p)
        f = between[k]
        if f is None:
            return y
        t0 = time.perf_counter()
        z, vjp = f(y)
        cluster.timing.comp_s += time.perf_counter() - t0
        stash_vjp[k][i] = vjp
        return z

    def bwd_through(k: int, i: int, g: np.ndarray) -> np.ndarray:
        """Pull g back through layer k's between stage (master-only)."""
        vjp = stash_vjp[k][i]
        if vjp is None:
            return g
        t0 = time.perf_counter()
        gy = vjp(g)
        cluster.timing.comp_s += time.perf_counter() - t0
        return gy

    # ---- forward phases: layer k's scatters interleave with k-1's
    # gathers (and the between stages between them)
    pend: List[Pending] = []
    for k in range(L):
        cur: List[Pending] = []
        for i in range(n):
            xi = parts[i] if k == 0 else fwd_finish(k - 1, i, pend[i])
            xi = np.asarray(xi, np.float32)
            stash_x[k][i] = xi
            cur.append(
                cluster._scatter_conv_planned(
                    xi, plan_for(k, xi), send_weights=(i == 0)
                )
            )
        pend = cur

    # ---- turnaround: finish the last fwd layer, compute the head
    # grads, and seed the backward — the bwd scatter of the last layer
    # goes out while its later fwd microbatches are still in flight
    cur = []
    for i in range(n):
        z = fwd_finish(L - 1, i, pend[i])
        t0 = time.perf_counter()
        head_aux[i], gz = head(z, i)
        cluster.timing.comp_s += time.perf_counter() - t0
        gy = bwd_through(L - 1, i, np.asarray(gz, np.float32))
        cur.append(
            cluster._scatter_bwd_planned(
                stash_x[L - 1][i], plans[L - 1], gy, send_weights=(i == 0)
            )
        )
    pend = cur

    # ---- backward phases: layer k's scatters interleave with layer
    # k+1's gathers and the between-VJPs; dW shards sum per microbatch
    dw: List[Optional[np.ndarray]] = [None] * L

    def acc_dw(k: int, dwi: np.ndarray):
        dw[k] = dwi if dw[k] is None else dw[k] + dwi

    for k in range(L - 2, -1, -1):
        cur = []
        for i in range(n):
            dx_next, dw_next = cluster.gather_bwd(pend[i])
            acc_dw(k + 1, dw_next)
            gy = bwd_through(k, i, dx_next)
            cur.append(
                cluster._scatter_bwd_planned(
                    stash_x[k][i], plans[k], gy, send_weights=(i == 0)
                )
            )
        pend = cur

    # ---- drain the first layer's backward
    dxs: List[np.ndarray] = []
    for i in range(n):
        dx_i, dw_i = cluster.gather_bwd(pend[i])
        acc_dw(0, dw_i)
        dxs.append(dx_i)
    cluster._update_comp_duty()
    return TrainStepResult(
        head_aux=head_aux,
        dw=[d for d in dw],
        dx=np.concatenate(dxs, axis=0) if n > 1 else dxs[0],
    )


class ServeChain:
    """Cross-batch pipelined forward chain for the serving lane.

    ``conv_forward_chain`` pipelines microbatches WITHIN one batch;
    a request server instead sees a stream of small, irregular batches
    and wants batch k+1's layer-0 scatter on the wire while batch k's
    final layer is still computing on the slaves.  ``push(x)`` issues
    exactly that overlap and keeps ONE batch in flight:

        push(x_k+1):  scatter L0(x_k+1)      # rides the links while ...
                      gather  L-1(x_k)       # ... batch k finishes
                      gather/scatter L1..L-1(x_k+1), leave L-1 pending
                      -> returns batch k's output (None on first push)

    Gathers stay in global scatter order, so the transport FIFO
    contract holds across batch boundaries.  Plans are rebuilt per
    push from the batch's actual shape and the CURRENT membership, so
    an ``admit()``/``evict()`` between pushes is picked up at the next
    batch — and a ``SlaveLost`` mid-batch drains on the survivors via
    the ``Pending`` recovery path, invisible here.

    Serve weights are STATIC, so every layer opts into the cluster's
    versioned weight-broadcast cache under a per-chain key: the first
    push ships each slave its kernel shard once, and every later push
    (same geometry, same membership) ships a ~24-byte version token
    instead — the per-slab broadcast that dominated serve wire bytes
    collapses to O(1) per layer.  A membership or batch-geometry
    change invalidates the token and the affected shards re-ship
    automatically.

    Args:
        cluster: the ``HeteroCluster`` to serve through.
        layer_weights: conv kernel per layer, ``(kh, kw, cin, cout)``.
        between: optional master-only stage after each layer,
            ``f(y) -> z`` (None = identity); ``between[k]`` runs after
            layer k, including the final layer (applied at the NEXT
            push, or at ``flush()``).
    """

    def __init__(
        self,
        cluster,
        layer_weights: Sequence[np.ndarray],
        between: Optional[Sequence[Optional[Callable[[np.ndarray], np.ndarray]]]] = None,
    ):
        if between is None:
            between = [None] * len(layer_weights)
        assert len(layer_weights) >= 1 and len(between) == len(layer_weights)
        self.cluster = cluster
        self.weights = [np.asarray(w, np.float32) for w in layer_weights]
        self.between = list(between)
        self._tail: Optional[Pending] = None  # previous batch's final layer

    def _finish_tail(self) -> Optional[np.ndarray]:
        """Gather the previous batch's final layer and run its between
        stage.  Returns None when no batch is in flight."""
        if self._tail is None:
            return None
        y = self.cluster.gather_conv(self._tail)
        self._tail = None
        f = self.between[-1]
        out = self.cluster._master_comp(f, y) if f else y
        self.cluster._update_comp_duty()
        return out

    def push(self, x: np.ndarray) -> Optional[np.ndarray]:
        """Feed one batch into the pipeline.

        Args:
            x: batch input ``(B, H, W, Cin)``, any float dtype.

        Returns:
            The PREVIOUS pushed batch's chain output (its final-layer
            between stage applied), or None on the first push.

        Raises:
            SlaveError: a slave raised while computing a shard (the
                batch cannot be recovered; membership faults are NOT
                errors — those drain on the survivors).
        """
        cluster, weights, between = self.cluster, self.weights, self.between
        x = np.asarray(x, np.float32)
        # batch k+1's first scatter goes out BEFORE batch k's last
        # gather: its bytes ride the links while the slaves still
        # compute batch k's final layer
        plan = plan_conv(
            cluster, x.shape, weights[0], "conv",
            weight_key=(id(self), 0),
        )
        p = cluster._scatter_conv_planned(x, plan, True)
        prev_out = self._finish_tail()
        for k in range(1, len(weights)):
            y = cluster.gather_conv(p)
            f = between[k - 1]
            y = cluster._master_comp(f, y) if f else y
            plan = plan_conv(
                cluster, y.shape, weights[k], "conv",
                weight_key=(id(self), k),
            )
            p = cluster._scatter_conv_planned(y, plan, True)
        self._tail = p
        return prev_out

    def flush(self) -> Optional[np.ndarray]:
        """Drain the pipeline: finish the in-flight batch (if any) and
        return its output, or None when the pipeline is empty."""
        return self._finish_tail()

    @property
    def in_flight(self) -> bool:
        """Whether a pushed batch is still awaiting its final gather."""
        return self._tail is not None


def conv_train_step(
    cluster,
    x: np.ndarray,
    layer_weights: Sequence[np.ndarray],
    between: Optional[Sequence[Optional[Callable]]] = None,
    head: Optional[Callable] = None,
    *,
    update: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]] = None,
) -> Tuple[List[np.ndarray], TrainStepResult]:
    """One full forward+backward ``conv_train_chain`` plus the
    optimizer step on the conv kernels: ``update(w, dw) -> new_w``
    (None leaves the weights untouched and just returns the grads)."""
    res = conv_train_chain(cluster, x, layer_weights, between=between, head=head)
    if update is None:
        return list(layer_weights), res
    return [update(w, d) for w, d in zip(layer_weights, res.dw)], res
