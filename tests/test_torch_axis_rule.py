"""A lost member's part, recomputed by the master, is bit for bit what
that member sent over the wire: on every partition axis (``kernel``,
``spatial``, ``batch``), for both ops (``conv``, ``bwd``), on the host
path (a ``numpy`` master and slave, numpy in) and on the card path (a
``torch:cpu`` master and slave, tensors in, the master's device the
CPU).

Each case scatters and gathers one op over two in-process devices with
pinned probe times and no comp-aware discount, then recomputes member 1
(``_recover_shard(p, 1)``) and member 0, the master's own part, and
holds them against the gathered result: member 1's slice of ``y``;
for ``bwd`` member 1's slice of dW (kernel axis) or of dX (batch axis),
the dX rows only member 1's halo window covers (spatial axis), and the
sum of the two parts in device order.  On the card path the recomputed
part is a tensor where the master computes on its device (the kernel
axis) and numpy where the axis runs its host path (spatial, batch);
the gathered result is a tensor on every axis.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.backends import is_tensor
from repro_torch.core.cluster.cluster import HeteroCluster
from repro_torch.core.cluster.plans import batch_ranges

PATHS = {"host": "numpy", "card": "torch:cpu"}
# the axes on which the master computes on the op's own operands
CARD_AXES = {"kernel"}


def _data():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 8, 8, 3), dtype=np.float32)
    w = rng.standard_normal((3, 3, 3, 6), dtype=np.float32)
    g = rng.standard_normal((4, 8, 8, 6), dtype=np.float32)
    return x, w, g


def _np(a):
    return a.numpy() if is_tensor(a) else a


def _eq(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and np.array_equal(a, b)


def _op(axis, op, path):
    """(plan, gathered result, member 0's part, member 1's part)."""
    backend = PATHS[path]
    x, w, g = _data()
    if path == "card":
        x, w, g = (torch.from_numpy(a) for a in (x, w, g))
    c = HeteroCluster([1.0, 1.0], [backend, backend], comp_aware=False)
    try:
        c.probe_times = [1.0, 2.0]
        plan = c.plan_conv(tuple(x.shape), w, "train", partition=axis)
        if op == "conv":
            p = c._scatter_conv_planned(x, plan, True)
            got = c.gather_conv(p)
        else:
            p = c._scatter_bwd_planned(x, plan, g, True)
            got = c.gather_bwd(p)
        part0, part1 = c._recover_shard(p, 0), c._recover_shard(p, 1)
    finally:
        c.shutdown()
    return plan, got, part0, part1


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("op", ["conv", "bwd"])
@pytest.mark.parametrize("axis", ["kernel", "spatial", "batch"])
def test_recovery_equals_the_wire(axis, op, path):
    plan, got, part0, part1 = _op(axis, op, path)
    assert plan.mode == axis
    assert 0 < int(plan.counts[0]) and 0 < int(plan.counts[1])
    c0 = int(plan.counts[0])
    r0, r1 = (plan.rows[1] if axis == "spatial"
              else batch_ranges(plan.counts, 4)[1])
    if op == "conv":
        member1 = {"kernel": lambda y: y[..., c0:],
                   "spatial": lambda y: y[:, r0:r1],
                   "batch": lambda y: y[r0:r1]}[axis]
        _eq(part1, member1(got))
        results, parts = [got], [part0, part1]
    else:
        (dx, dw), (dx0, dw0), (dx1, dw1) = got, part0, part1
        if axis == "kernel":
            _eq(dw1, dw[..., c0:])
            _eq(dx, dx0 + dx1)
        elif axis == "batch":
            _eq(dx1, dx[r0:r1])
            _eq(dw, dw0 + dw1)
        else:
            # rows of dX below the master's halo window come from member
            # 1's halo'd strip alone
            (_, hi0, _, _), (lo1, hi1, _, _) = plan.halos[0], plan.halos[1]
            assert hi0 < hi1
            _eq(dx1[:, hi0 - lo1:], dx[:, hi0:hi1])
            _eq(dw, dw0 + dw1)
        results, parts = [dx, dw], [dx0, dw0, dx1, dw1]
    on_card = path == "card"
    assert all(is_tensor(a) == on_card for a in results)
    assert all(is_tensor(a) == (on_card and axis in CARD_AXES) for a in parts)
