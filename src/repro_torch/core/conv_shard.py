"""Kernel-sharded convolution on a device mesh — the paper's distribution
expressed as DTensor layouts.

Counterpart of ``repro/core/conv_shard.py``.  "Broadcast the inputs" =
activations replicated over ``model``; "scatter the kernels" = HWIO
weights sharded on the output-channel axis (``conv_out``); "gather the
feature maps" = the all-gather that gather-mode rules force when they
pin the conv output back to replicated (``act_conv``), where the
megatron rules keep the feature maps channel-sharded through ReLU, LRN
and pooling instead.

Each rank convolves its own kernels with ``Conv2dFunction`` (K1 forward,
K2 and K3 backward on the card; their plain versions on CPU tensors)
through ``local_map``: the kernel launches on the rank's local shards.
On a homogeneous mesh the Eq. 1 shares degenerate to the uniform split
(its fixed point): the shards are even by construction; the uneven
heterogeneous allocation is the cluster's (``core/cluster``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.conv2d import Conv2dFunction
from repro_torch.layers.conv import apply_conv
from repro_torch.sharding.axes import AxisRules
from repro_torch.sharding.local import as_dtensor, grad_placements
from repro_torch.sharding.partitioning import constrain, is_dtensor, placements_for


def _conv_local(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return Conv2dFunction.apply(x, w.to(x.dtype))


def make_sharded_conv(rules: AxisRules):
    """conv_fn for ``models/cnn.py`` running under a mesh: the kernel axis
    is sharded over ``model``, the output layout follows the rule mode.
    Plain tensors (no mesh) take ``layers/conv.py::apply_conv``."""

    def conv_fn(params, x):
        w = params["kernel"]
        if not (is_dtensor(x) or is_dtensor(w)):
            return apply_conv(params, x)
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        mesh = (x if is_dtensor(x) else w).device_mesh
        b, h, wd, _ = x.shape
        out_pl = placements_for(mesh, rules, (b, h, wd, w.shape[3]),
                                ("batch", None, None, "act_conv_col"))
        x_pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
                     for p in out_pl)
        w_pl = tuple(Shard(3) if isinstance(p, Shard) and p.dim == 3 else Replicate()
                     for p in out_pl)
        x, w = as_dtensor(x, mesh, x_pl), as_dtensor(w, mesh, w_pl)
        y = local_map(_conv_local, out_placements=list(out_pl), in_placements=(x_pl, w_pl),
                      in_grad_placements=(grad_placements(x_pl, out_pl),
                                          grad_placements(w_pl, out_pl)),
                      device_mesh=mesh, redistribute_inputs=True)(x, w)
        y = y + params["bias"].to(y.dtype)
        # column layout right after the convolution (every mode)
        y = constrain(y, rules, "batch", None, None, "act_conv_col")
        # gather mode: force the paper's all-gather; sharded mode: keep
        return constrain(y, rules, "batch", None, None, "act_conv")

    return conv_fn
