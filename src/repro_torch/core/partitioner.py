"""Heterogeneity-aware workload partitioner — the paper's Eq. 1.

Given per-device probe times ``t_i`` (seconds to run the same reference
workload), the workload share of device i is

    w_i = (max(t) / t_i) / sum_j (max(t) / t_j)                    (Eq. 1)

i.e. shares proportional to measured throughput.  ``allocate_kernels``
turns the fractional shares into an integer number of kernels per device
with the largest-remainder method, preserving the total and guaranteeing
every device at least ``min_per_device`` kernels (0 allowed).

The allocator is axis-agnostic: the same Eq. 1 shares split output
kernels (partition="kernel"), image rows (partition="spatial"), or
batch samples (partition="batch") — only the unit and its per-unit
wire bytes change (cluster/plans.py:unit_bytes).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


def workload_shares(times: Sequence[float]) -> np.ndarray:
    """Eq. 1.  times[i] > 0 is device i's probe time; returns shares
    summing to 1, inversely proportional to time."""
    t = np.asarray(times, dtype=np.float64)
    if t.ndim != 1 or t.size == 0:
        raise ValueError("times must be a non-empty 1-D sequence")
    if np.any(t <= 0) or not np.all(np.isfinite(t)):
        raise ValueError("probe times must be positive and finite")
    perf = t.max() / t  # max(t)/t_i — the paper's performance values
    return perf / perf.sum()


def allocate_kernels(
    num_kernels: int, times: Sequence[float], *, min_per_device: int = 0
) -> np.ndarray:
    """Integer kernel counts per device via largest-remainder rounding of
    the Eq. 1 shares.  sum == num_kernels always holds."""
    if num_kernels < 0:
        raise ValueError("num_kernels must be >= 0")
    shares = workload_shares(times)
    n = shares.size
    if num_kernels < n * min_per_device:
        raise ValueError("num_kernels too small for min_per_device")
    ideal = shares * num_kernels
    base = np.floor(ideal).astype(np.int64)
    base = np.maximum(base, min_per_device)
    # distribute the remainder to the largest fractional parts
    while base.sum() > num_kernels:  # over-allocated due to min clamp
        i = int(np.argmax(base - ideal))
        if base[i] <= min_per_device:
            candidates = np.where(base > min_per_device)[0]
            i = candidates[int(np.argmax((base - ideal)[candidates]))]
        base[i] -= 1
    rem = num_kernels - base.sum()
    if rem > 0:
        frac = ideal - np.floor(ideal)
        order = np.argsort(-frac, kind="stable")
        for j in range(int(rem)):
            base[order[j % n]] += 1
    return base


_MAX_COMP_DUTY = 0.95  # clamp: a duty of 1.0 would zero the device out


def effective_times(
    times: Sequence[float],
    *,
    comp_duties=None,
    wire_bytes: Optional[Sequence[float]] = None,
    bandwidths_mbps: Optional[Sequence[Optional[float]]] = None,
) -> np.ndarray:
    """THE parameterized Eq. 1 input: probe times adjusted for every
    modelled effect, in one place.

    Two orthogonal adjustments (either may be omitted):

    * **non-conv duty** (multiplicative): a device that spends fraction
      ``d`` of its busy time on master-only non-conv layers has only
      ``1 - d`` of its throughput left for its conv shard, so its probe
      time inflates to ``t / (1 - d)`` (clamped at ``_MAX_COMP_DUTY``).
      ``comp_duties`` is a mapping ``{device: duty}`` or a per-device
      sequence.
    * **link comm** (additive): ``wire_bytes[i]`` is the bytes device i
      would move over its link if it took the WHOLE workload
      (share-proportional traffic only — fixed broadcast costs do not
      move the optimal split); ``bandwidths_mbps[i]`` its measured link
      (None/inf = no link, e.g. the master).  Both terms scale linearly
      with the share, so Eq. 1 over the sums minimizes the predicted
      wall-clock, not just the compute makespan.

    ``comp_aware_times`` / ``link_aware_times`` / ``profiles_to_shares``
    and ``HeteroCluster.shares_for`` are all thin parameterizations of
    this one path."""
    t = np.asarray(times, dtype=np.float64).copy()
    if comp_duties is not None:
        items = (
            comp_duties.items()
            if hasattr(comp_duties, "items")
            else enumerate(comp_duties)
        )
        for i, duty in items:
            d = min(float(duty), _MAX_COMP_DUTY)
            if d > 0.0:
                t[i] = t[i] / (1.0 - d)
    if wire_bytes is not None:
        if bandwidths_mbps is None or not (
            len(wire_bytes) == len(bandwidths_mbps) == t.size
        ):
            raise ValueError("times, wire_bytes, bandwidths must align")
        for i, (b, bw) in enumerate(zip(wire_bytes, bandwidths_mbps)):
            if bw is not None and np.isfinite(bw):
                if bw <= 0:
                    raise ValueError("bandwidths must be positive")
                t[i] += float(b) * 8.0 / (bw * 1e6)
    return t


def comp_aware_times(
    times: Sequence[float], comp_duty: float, *, device: int = 0
) -> np.ndarray:
    """One device's Eq. 1 share discounted by its non-conv duty — the
    single-device parameterization of ``effective_times``."""
    return effective_times(times, comp_duties={device: comp_duty})


def link_aware_times(
    times: Sequence[float],
    wire_bytes: Sequence[float],
    bandwidths_mbps: Sequence[Optional[float]],
) -> np.ndarray:
    """Eq. 1 extension: each device's COMM term added to its probe time
    — the links-only parameterization of ``effective_times``."""
    return effective_times(
        times, wire_bytes=wire_bytes, bandwidths_mbps=bandwidths_mbps
    )


def comm_aware_allocate(
    num_units: int,
    times: Sequence[float],
    wire_bytes: Sequence[float],
    bandwidths_mbps: Sequence[Optional[float]],
    *,
    min_per_device: int = 0,
) -> np.ndarray:
    """Integer unit counts (kernels, image rows, or batch samples) from
    the comm-extended Eq. 1: shares inversely proportional to compute +
    wire time."""
    return allocate_kernels(
        num_units,
        link_aware_times(times, wire_bytes, bandwidths_mbps),
        min_per_device=min_per_device,
    )


def predicted_conv_time(
    times: Sequence[float], kernels: Sequence[int], num_kernels: int
) -> float:
    """Time for the slowest device to finish its kernel share, given that
    device i convolves `num_kernels` kernels in `times[i]` seconds
    (linear-in-kernels model, the paper's assumption)."""
    t = np.asarray(times, dtype=np.float64)
    k = np.asarray(kernels, dtype=np.float64)
    return float(np.max(t * k / num_kernels))


def speedup(times: Sequence[float], kernels: Sequence[int], num_kernels: int,
            *, baseline_device: int = 0) -> float:
    """Speedup of the distributed conv phase vs the baseline device doing
    all kernels alone (the paper compares against a single device)."""
    t = np.asarray(times, dtype=np.float64)
    return float(t[baseline_device] / predicted_conv_time(times, kernels, num_kernels))


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """A device's measured capability, as the paper's probe reports it."""

    name: str
    conv_time: float  # seconds for the reference conv workload
    bandwidth_mbps: float = 5.0  # link to the master (paper: ~5 Mbps Wi-Fi)
    backend: str = "numpy"  # conv compute backend the device runs (core/backends.py)
    comp_duty: float = 0.0  # measured fraction of busy time spent on the
    #                         master-only non-conv layers (LayerTiming.comp_s
    #                         over comp_s + master_conv_s); 0 for slaves

    @property
    def gflops(self) -> float:
        # informational only; the partitioner uses times, not FLOPs
        return 1.0 / self.conv_time

    @property
    def effective_conv_time(self) -> float:
        """Probe time inflated by the non-conv duty — the Eq. 1 input for
        a device that cannot devote its whole throughput to conv."""
        return float(
            effective_times([self.conv_time], comp_duties=[self.comp_duty])[0]
        )

    def with_comp_duty(self, comp_duty: float) -> "DeviceProfile":
        """Record a measured non-conv duty (e.g. from a cluster's
        ``LayerTiming``) on an otherwise identical profile."""
        return dataclasses.replace(self, comp_duty=float(comp_duty))


def probe_device(
    name: str,
    backend: str = "numpy",
    *,
    slowdown: float = 1.0,
    bandwidth_mbps: float = 5.0,
    **probe_kwargs,
) -> DeviceProfile:
    """Run the §4.1.1 reference convolution on the named compute backend
    and return the resulting profile.  Probing the backend a device will
    actually run keeps the Eq. 1 shares exact for mixed-backend clusters
    (probe_kwargs: image_size, in_channels, kernel_size, num_kernels,
    batch, repeats, seed — see core/backends.py)."""
    from repro_torch.core.backends import probe_conv_time

    t = probe_conv_time(backend, slowdown=slowdown, **probe_kwargs)
    return DeviceProfile(name, t, bandwidth_mbps, backend)


def profiles_to_shares(
    profiles: Sequence[DeviceProfile],
    *,
    wire_bytes: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Eq. 1 over a probed device set, comp-aware: each profile's
    non-conv duty discounts its share.  With ``wire_bytes`` (the bytes
    device i would move if it took the whole layer) the shares also
    weigh each profile's measured link — the comm-extended Eq. 1.  One
    ``effective_times`` call applies both adjustments."""
    return workload_shares(
        effective_times(
            [p.conv_time for p in profiles],
            comp_duties=[p.comp_duty for p in profiles],
            wire_bytes=wire_bytes,
            bandwidths_mbps=(
                [p.bandwidth_mbps for p in profiles]
                if wire_bytes is not None
                else None
            ),
        )
    )
