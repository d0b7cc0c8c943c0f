"""Communication cost model — the paper's Eq. 2 — plus the step-time
predictor used for the 32/128-node scalability simulations (Figs 9-13).

Eq. 2 counts the elements exchanged between master and slaves per batch:

    upload = sum_i  in_i^2 * inCh_i * batch        (broadcast the inputs)
           + k_i^2 * numK_i * inCh_i               (scatter the kernels)
           + out_i^2 * numK_i * batch              (gather the outputs)

All values are doubles (8 bytes) in the paper's Matlab implementation.
The same expression evaluated at ICI bandwidth is the collective term of
the TPU roofline (see repro/roofline) — the model transfers unchanged,
only the bandwidth constant differs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

BYTES_PER_ELEMENT = 8  # Matlab double


@dataclasses.dataclass(frozen=True)
class ConvLayerSpec:
    """Geometry of one distributed convolutional layer."""

    in_size: int  # input width == height (square, like the paper)
    in_channels: int
    kernel_size: int
    num_kernels: int
    padding: str = "SAME"

    @property
    def out_size(self) -> int:
        if self.padding == "SAME":
            return self.in_size
        return self.in_size - self.kernel_size + 1


def upload_elements(layers: Sequence[ConvLayerSpec], batch: int) -> int:
    """Eq. 2: total elements master<->slaves per batch over all layers."""
    total = 0
    for l in layers:
        total += l.in_size ** 2 * l.in_channels * batch          # inputs
        total += l.kernel_size ** 2 * l.num_kernels * l.in_channels  # kernels
        total += l.out_size ** 2 * l.num_kernels * batch          # outputs
    return int(total)


def upload_bytes(layers: Sequence[ConvLayerSpec], batch: int,
                 bytes_per_element: int = BYTES_PER_ELEMENT) -> int:
    return upload_elements(layers, batch) * bytes_per_element


def comm_time_s(layers: Sequence[ConvLayerSpec], batch: int,
                bandwidth_mbps: float, *,
                bytes_per_element: int = BYTES_PER_ELEMENT) -> float:
    """Seconds to move Eq. 2's volume at the given link rate (paper
    measures ~5 Mbps on Wi-Fi)."""
    bits = upload_bytes(layers, batch, bytes_per_element) * 8
    return bits / (bandwidth_mbps * 1e6)


def upload_elements_nodes(
    layers: Sequence[ConvLayerSpec], batch: int, slave_shares: Sequence[float],
    *, broadcast_inputs: bool = False,
) -> float:
    """Node-aware refinement of Eq. 2 used by the simulator.  Kernels and
    outputs move only for the slaves' workload shares (the master keeps
    its own shard local); with one device the volume is 0.

    ``broadcast_inputs``: the paper's Eq. 2 counts the input volume ONCE
    (and its Figs 9-13 scalability conclusions — "stabilises, no loss" —
    depend on that); Algorithm 1 line 10 however writes the inputs to
    EVERY slave socket, so the physically-consistent model scales the
    input term by n_slaves.  False reproduces the paper's own simulator;
    True is the corrected (beyond-paper) model — both are reported in
    benchmarks/bench_scalability.py.

    ``slave_shares``: Eq. 1 shares of the slave nodes (excludes master).
    """
    n_slaves = len(slave_shares)
    frac = float(np.sum(slave_shares))
    in_mult = n_slaves if broadcast_inputs else 1.0
    total = 0.0
    for l in layers:
        total += l.in_size ** 2 * l.in_channels * batch * in_mult
        total += l.kernel_size ** 2 * l.num_kernels * l.in_channels * frac
        total += l.out_size ** 2 * l.num_kernels * batch * frac
    return total


def comm_time_nodes_s(
    layers: Sequence[ConvLayerSpec], batch: int, slave_shares: Sequence[float],
    bandwidth_mbps: float, *, bytes_per_element: int = BYTES_PER_ELEMENT,
    broadcast_inputs: bool = False,
) -> float:
    bits = (
        upload_elements_nodes(
            layers, batch, slave_shares, broadcast_inputs=broadcast_inputs
        )
        * bytes_per_element * 8
    )
    return bits / (bandwidth_mbps * 1e6)


def paper_network(c1: int, c2: int, *, image_size: int = 32,
                  kernel_size: int = 5, image_channels: int = 3,
                  pool_stride: int = 2) -> List[ConvLayerSpec]:
    """The paper's 2-conv-layer CIFAR-10 network geometry."""
    l1 = ConvLayerSpec(image_size, image_channels, kernel_size, c1)
    l2_in = image_size // pool_stride
    l2 = ConvLayerSpec(l2_in, c1, kernel_size, c2)
    return [l1, l2]


# ---------------------------------------------------------------------------
# step-time predictor (the scalability simulator's inner model)


@dataclasses.dataclass(frozen=True)
class StepTimePrediction:
    comm_time: float
    conv_time: float  # slowest device's conv time (they finish together under Eq. 1)
    comp_time: float  # non-conv layers, computed serially on the master
    num_devices: int

    @property
    def total(self) -> float:
        return self.comm_time + self.conv_time + self.comp_time


def predict_step_time(
    *,
    layers: Sequence[ConvLayerSpec],
    batch: int,
    device_conv_times: Sequence[float],
    master_comp_time: float,
    bandwidth_mbps: float,
    bytes_per_element: int = BYTES_PER_ELEMENT,
    broadcast_inputs: bool = False,
) -> StepTimePrediction:
    """Predict one distributed training-step's wall time.

    ``device_conv_times[i]``: time for device i to convolve ALL kernels of
    the network alone (the probe, scaled to the full workload).  Under the
    Eq. 1 balanced shares every device finishes in

        T_conv = 1 / sum_i (1 / t_i)

    (the harmonic aggregate — equal-finish-time work splitting).
    With a single device there is no communication.
    """
    t = np.asarray(device_conv_times, dtype=np.float64)
    n = t.size
    if n == 1:
        return StepTimePrediction(0.0, float(t[0]), master_comp_time, 1)
    conv = 1.0 / np.sum(1.0 / t)
    shares = (1.0 / t) / np.sum(1.0 / t)  # Eq. 1
    comm = comm_time_nodes_s(layers, batch, shares[1:], bandwidth_mbps,
                             bytes_per_element=bytes_per_element,
                             broadcast_inputs=broadcast_inputs)
    return StepTimePrediction(float(comm), float(conv), master_comp_time, int(n))
