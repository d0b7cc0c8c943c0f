"""Two-tier cluster hierarchy: a root master over sub-master groups.

One master fanning out to N slaves is the runtime's scalability
ceiling — every scatter, gather and recovery path funnels through one
protocol node and one NIC.  The Bi-layered Parallel Training
Architecture (PAPERS.md, 1810.07742) breaks that ceiling by layering
data-parallel groups that each run model parallelism internally, with
gradient aggregation between groups.  The layered ``core/cluster/``
split makes that a composition job, and this module is the
composition:

* A **sub-master** (``protocol.sub_master_loop``) is simultaneously a
  slave to the root — it speaks the ordinary wire grammar over any
  transport — and a full ``HeteroCluster`` master to its own group,
  which internally uses the existing kernel/spatial/batch/auto
  per-layer partitioning, pipelining and fault tolerance.
* The **root** (:class:`HierarchicalCluster`) is a ``HeteroCluster``
  whose "slaves" are sub-masters and whose partition axis is pinned to
  ``"batch"``: each group gets disjoint sample rows priced by its
  aggregate Eq. 1 capacity (member compute rates SUM —
  ``plans.group_aggregate_time``; internal bandwidth is the MIN member
  link, folded into the uplink price), and the root's sum of per-group
  full dW over disjoint rows is the exact all-reduce of the flat
  batch axis.  Two-tier losses therefore match
  single-device training to fp32 tolerance.

Fault tolerance composes instead of multiplying:

* a lost **leaf slave** is handled entirely by its group's sub-master
  (evict + master-side recompute of its in-flight rows) — the root
  never sees the failure, only the capacity drop the next ``probe()``
  reports, which it re-plans on (``refresh_capacity``);
* a lost **sub-master** is one dead batch member to the root: the
  stock batch-axis recovery recomputes the whole GROUP's rows on the
  root and evicts the slot, VJP-exact for the survivors.

Topology strings: ``"2x3"`` = 2 groups x 3 devices each, where each
group's first device IS its sub-master's own compute (the inner
master) — a 2x3 hierarchy totals 7 protocol nodes, the same device
count as a flat 1-master/6-slave cluster, which is what makes the
JAX package's ``hierarchy_vs_flat_gain`` bench a fair fight.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

from repro_torch.core.cluster import plans, protocol
from repro_torch.core.cluster.cluster import HeteroCluster
from repro_torch.core.cluster.transport import InProcTransport


@dataclasses.dataclass
class GroupSpec:
    """One group's recipe: the inner cluster a sub-master builds and
    masters.  ``slowdowns[0]``/``backends[0]`` are the sub-master's OWN
    compute (it is the group's inner master, not a pure router); the
    rest are its leaf slaves.  ``transport`` is the INNER wire —
    ``"inproc"`` leaf threads inside the sub-master, or ``"tcp"``/
    ``"shm"`` real leaf subprocesses (give those a ``heartbeat_s`` so
    the sub-master can tell busy from dead)."""

    slowdowns: Sequence[float]
    backends: Optional[Sequence[str]] = None
    transport: str = "inproc"
    partition: str = "auto"
    pipeline: bool = True
    microbatches: int = 4
    bandwidth_mbps: Optional[float] = None
    nic_mbps: Optional[float] = None
    heartbeat_s: Optional[float] = None

    @property
    def size(self) -> int:
        """Device count of the group, sub-master's own compute included."""
        return len(self.slowdowns)


def parse_groups(
    spec: str,
    slowdowns: Optional[Sequence[float]] = None,
    backends: Optional[Sequence[str]] = None,
    **kw,
) -> List[GroupSpec]:
    """``"GxM"`` -> G :class:`GroupSpec` of M devices each (the
    ``--groups 2x3`` CLI).  ``slowdowns``/``backends`` optionally carry
    the G*M per-device values, chunked M per group in order; omitted
    they default to 1.0 / ``cuda`` (the card, as a flat cluster's
    devices do; name ``numpy`` or ``torch:cpu`` for a CPU device).
    Extra keyword args (``transport``, ``nic_mbps``, ...) apply to every
    group."""
    try:
        g_s, m_s = spec.lower().split("x")
        g, m = int(g_s), int(m_s)
    except ValueError:
        raise ValueError(
            f"groups topology must look like '2x3' (groups x devices "
            f"per group), got {spec!r}"
        ) from None
    if g < 1 or m < 1:
        raise ValueError(f"topology {spec!r} needs >= 1 group of >= 1 device")
    if slowdowns is not None and len(slowdowns) != g * m:
        raise ValueError(
            f"topology {spec} has {g * m} group devices but "
            f"{len(slowdowns)} slowdowns were given"
        )
    if backends is not None and len(backends) != g * m:
        raise ValueError(
            f"topology {spec} has {g * m} group devices but "
            f"{len(backends)} backends were given"
        )
    out = []
    for i in range(g):
        sl = (
            list(slowdowns[i * m:(i + 1) * m]) if slowdowns is not None
            else [1.0] * m
        )
        bk = (
            list(backends[i * m:(i + 1) * m]) if backends is not None
            else None
        )
        out.append(GroupSpec(slowdowns=sl, backends=bk, **kw))
    return out


def build_group_cluster(
    spec: GroupSpec, clock: Callable[[], float] = time.monotonic
) -> HeteroCluster:
    """The inner ``HeteroCluster`` a sub-master masters, straight from
    its :class:`GroupSpec` — every per-layer partition axis, the
    pipeline and the group's own elastic machinery come along for
    free."""
    return HeteroCluster(
        list(spec.slowdowns),
        list(spec.backends) if spec.backends is not None else None,
        transport=spec.transport,
        partition=spec.partition,
        pipeline=spec.pipeline,
        microbatches=spec.microbatches,
        bandwidth_mbps=spec.bandwidth_mbps,
        master_nic_mbps=spec.nic_mbps,
        heartbeat_s=spec.heartbeat_s,
        clock=clock,
    )


def group_hello_meta(inner: HeteroCluster) -> dict:
    """The ``"group"`` entry a sub-master's hello meta carries upward:
    the group's size and its internal bandwidth bottleneck (MIN of the
    members' finite planning bandwidths, None when every inner link is
    unmetered).  The root folds the bandwidth into the group's uplink
    price — rows must never be priced faster than the group can
    internally redistribute them."""
    finite = [b for b in inner.bandwidths if b is not None]
    return {
        "size": 1 + inner.n_slaves,
        "bandwidth_mbps": min(finite) if finite else None,
    }


class HierarchicalCluster(HeteroCluster):
    """The two-tier root: a ``HeteroCluster`` whose members are whole
    groups behind sub-masters, planned on the batch axis.

    ``groups`` is a topology string (``"2x3"``), one :class:`GroupSpec`,
    or a sequence of them — heterogeneous group shapes are fine.  With
    ``transport="inproc"`` each sub-master runs as a thread in this
    process (its inner cluster built eagerly and reachable through
    ``group_clusters`` — what the leaf-failure tests poke); with
    ``"tcp"``/``"shm"`` each sub-master is an OS subprocess built from
    ``--group-*`` CLI flags, and SIGKILLing it takes its whole group
    down in one failure domain.

    Everything elastic is inherited: the stock batch scatter/gather,
    ``Pending`` recovery (a dead sub-master's ROWS recompute on the
    root), heartbeat deadlines, ``admit()``/``evict()``.  This class
    only adds the group plumbing: spec-driven member startup,
    group-aggregate capacity (sub-masters answer ``probe`` with their
    Eq. 1 harmonic aggregate), hello-meta bandwidth folding, and
    ``admit_group``/``refresh_capacity``.

    Every device whose backend is not named — the root's, and each
    group's — runs ``cuda``, the hand-written kernels on the card, as in
    a flat ``HeteroCluster``; without a card construction raises "no
    CUDA device" before any sub-master starts."""

    def __init__(
        self,
        groups: Union[str, GroupSpec, Sequence[GroupSpec]],
        *,
        master_slowdown: float = 1.0,
        master_backend: str = "cuda",
        pipeline: bool = True,
        microbatches: int = 4,
        bandwidth_mbps=None,
        master_nic_mbps: Optional[float] = None,
        comp_aware: bool = True,
        wire_dtype: Optional[str] = None,
        wire_codec: Optional[str] = None,
        weight_cache: bool = True,
        transport: str = "inproc",
        heartbeat_s: Optional[float] = None,
        heartbeat_timeout_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if isinstance(groups, str):
            groups = parse_groups(groups)
        elif isinstance(groups, GroupSpec):
            groups = [groups]
        groups = list(groups)
        if not groups:
            raise ValueError("a hierarchy needs at least one group")
        # state the base __init__'s member startup (which we override)
        # consumes — must exist before super().__init__ runs
        self._pending_specs: "collections.deque[GroupSpec]" = (
            collections.deque(groups)
        )
        self._group_by_dev: Dict[int, HeteroCluster] = {}
        self._spec_by_dev: Dict[int, GroupSpec] = {}
        super().__init__(
            [master_slowdown] + [float(g.slowdowns[0]) for g in groups],
            [master_backend] + [
                (g.backends[0] if g.backends else "cuda") for g in groups
            ],
            pipeline=pipeline,
            microbatches=microbatches,
            bandwidth_mbps=bandwidth_mbps,
            comp_aware=comp_aware,
            partition="batch",  # the inter-group axis: exact dW all-reduce
            wire_dtype=wire_dtype,
            wire_codec=wire_codec,
            weight_cache=weight_cache,
            transport=transport,
            master_nic_mbps=master_nic_mbps,
            heartbeat_s=heartbeat_s,
            heartbeat_timeout_s=heartbeat_timeout_s,
            clock=clock,
        )
        self._fold_group_bandwidths()

    # -- member startup: a pending GroupSpec turns a slot into a group ----
    @property
    def group_clusters(self) -> List[HeteroCluster]:
        """The LIVE in-proc groups' inner clusters, in slot order —
        empty on tcp/shm (those groups live inside their sub-master
        subprocesses).  Tests reach a group's leaf procs through this;
        inner-tier ``admit``/``evict`` go through these handles too."""
        return [
            self._group_by_dev[d]
            for d in self.slave_ids
            if d in self._group_by_dev
        ]

    def group_of(self, device: int) -> Optional[HeteroCluster]:
        """The inner cluster behind root member ``device`` (in-proc
        sub-masters only; None for plain leaves and subprocess
        sub-masters)."""
        return self._group_by_dev.get(device)

    def _start_inproc_slave(self, slowdown, backend, bandwidth) -> int:
        """A root in-proc slot: with a pending :class:`GroupSpec` it
        becomes a SUB-MASTER thread driving ``protocol.sub_master_loop``
        over an eagerly-built inner cluster; without one it falls back
        to a plain leaf slave (so ``admit()`` of a bare device at the
        root tier still works)."""
        if not self._pending_specs:
            return super()._start_inproc_slave(slowdown, backend, bandwidth)
        spec = self._pending_specs.popleft()
        inner = build_group_cluster(spec, clock=self._clock)
        try:
            link = InProcTransport(
                bandwidth, self._wire_np_dtype,
                wire_codec=self._link_codec(), nic=self._nic,
            )
            dev = self._next_slave_id
            self._next_slave_id += 1
            t = threading.Thread(
                target=protocol.sub_master_loop,
                args=(link.slave_endpoint(), inner, dev),
                daemon=True,
            )
            t.start()
        except Exception:
            inner.shutdown()  # never leak a built group on a failed start
            raise
        self._add_slot(dev, link, None, t)
        self._group_by_dev[dev] = inner
        self._spec_by_dev[dev] = spec
        self.hello_meta[dev] = {"group": group_hello_meta(inner)}
        return dev

    def _slave_cmd(self, dev: int, slowdown: float, backend: str) -> list:
        """A root tcp/shm spawn: with a pending :class:`GroupSpec` the
        subprocess gets ``--group-*`` flags and comes up as a
        sub-master (its inner group is in-proc INSIDE that process —
        one process, one failure domain); without one it is a plain
        leaf slave."""
        cmd = super()._slave_cmd(dev, slowdown, backend)
        if not self._pending_specs:
            return cmd
        spec = self._pending_specs.popleft()
        self._spec_by_dev[dev] = spec
        cmd += [
            "--group-slowdowns", ",".join(str(s) for s in spec.slowdowns),
            "--group-partition", spec.partition,
            "--group-microbatches", str(spec.microbatches),
        ]
        if spec.backends is not None:
            cmd += ["--group-backends", ",".join(spec.backends)]
        if not spec.pipeline:
            cmd += ["--group-no-pipeline"]
        if spec.bandwidth_mbps is not None:
            cmd += ["--group-bandwidth-mbps", str(spec.bandwidth_mbps)]
        if spec.nic_mbps is not None:
            cmd += ["--group-nic-mbps", str(spec.nic_mbps)]
        return cmd

    # -- group-aggregate capacity -----------------------------------------
    def _fold_group_bandwidths(self) -> None:
        """Cap each group's planning bandwidth at its internal
        bottleneck (the hello meta's ``group.bandwidth_mbps``): the
        root's uplink may be fast, but rows still have to fan out
        inside the group over its narrowest link.  Idempotent (min)."""
        for pos, dev in enumerate(self.slave_ids):
            g = (self.hello_meta.get(dev) or {}).get("group")
            if not g:
                continue
            gbw = g.get("bandwidth_mbps")
            if gbw is None:
                continue
            cur = self.bandwidths[pos]
            self.bandwidths[pos] = gbw if cur is None else min(cur, gbw)

    def probe(self, **probe_kwargs) -> List[float]:
        """The two-level §4.1.1 probe: each sub-master re-probes its
        OWN members and answers its aggregate Eq. 1 time (compute rates
        sum), so the root's ``probe_times`` price whole groups — and a
        leaf lost inside a group surfaces here as that group's capacity
        drop, no root-tier failure involved.  Group-internal bandwidth
        bottlenecks re-fold after the base probe refreshes links."""
        times = super().probe(**probe_kwargs)
        self._fold_group_bandwidths()
        return times

    def refresh_capacity(self, **probe_kwargs) -> List[float]:
        """Re-price every group after an INNER membership change (a
        leaf died or joined): re-runs the two-level probe with the last
        (or a default) workload so the next plan's rows follow the
        groups' ACTUAL remaining capacity.  Root membership is
        untouched — that is the point: leaf churn is a number changing,
        not a topology event."""
        kw = probe_kwargs or self._probe_kwargs or dict(
            image_size=16, in_channels=3, kernel_size=3,
            num_kernels=8, batch=4, repeats=1,
        )
        return self.probe(**kw)

    # -- root-tier elasticity over whole groups ---------------------------
    def admit_group(
        self,
        spec: Union[str, GroupSpec],
        *,
        bandwidth_mbps: Optional[float] = None,
        timeout_s: float = 120.0,
        probe_time: Optional[float] = None,
    ) -> int:
        """Grow the ROOT tier by one whole group: queue the spec, ride
        the stock ``admit()`` (which starts the sub-master thread or
        subprocess, probes its aggregate capacity, and re-plans), and
        fold the newcomer's internal bandwidth.  ``spec`` may be a
        :class:`GroupSpec` or a ``"1x3"``-style topology naming ONE
        group.  Returns the sub-master's device id."""
        if isinstance(spec, str):
            parsed = parse_groups(spec)
            if len(parsed) != 1:
                raise ValueError(
                    f"admit_group takes ONE group, {spec!r} names "
                    f"{len(parsed)}"
                )
            spec = parsed[0]
        self._pending_specs.append(spec)
        try:
            dev = self.admit(
                float(spec.slowdowns[0]),
                spec.backends[0] if spec.backends else "cuda",
                bandwidth_mbps=bandwidth_mbps,
                timeout_s=timeout_s,
                probe_time=probe_time,
            )
        except Exception:
            try:
                self._pending_specs.remove(spec)
            except ValueError:
                pass  # the failed start consumed it
            raise
        self._fold_group_bandwidths()
        return dev

    def shutdown(self) -> None:
        """Stop both tiers: the base shutdown's trainOver fan-out makes
        every sub-master loop shut its own group down; any in-proc
        inner cluster is then shut again here (idempotent) so a group
        whose sub-master thread never drained cannot leak leaf
        threads/processes."""
        super().shutdown()
        for inner in self._group_by_dev.values():
            inner.shutdown()
