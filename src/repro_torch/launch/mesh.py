"""Mesh definitions of the port: ``torch.distributed`` DeviceMeshes with the
JAX package's axis names.

Counterpart of ``repro/launch/mesh.py``.  Each mesh is built by a
FUNCTION, never at import.

* ``make_production_mesh``: single pod (16, 16) = 256 devices, axes
  ("data", "model"); multi-pod (2, 16, 16) = 512, axes ("pod", "data",
  "model").  It lays the mesh over the default process group, which must
  have 256 or 512 ranks: in this repo that group is the fake one of the
  dry run (``launch/dryrun.py``), one process standing in for every
  rank.  A real multi-GPU NCCL world of that size is not part of it.
* ``make_host_mesh``: the (1, 1) mesh of one device, with the same axis
  names, so every rule degenerates to replication.  It is on the card
  unless the caller asks for the CPU, and starts a one-rank process
  group (NCCL on the card, gloo on the CPU, at a free localhost port)
  when none is up.
"""
from __future__ import annotations

import contextlib
import socket

import torch
import torch.distributed as dist


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The (16, 16) or (2, 16, 16) mesh over the default process group."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    if not dist.is_initialized() or dist.get_world_size() != want:
        have = dist.get_world_size() if dist.is_initialized() else "no"
        raise RuntimeError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a default process "
            f"group of {want} ranks, found {have} process group; the dry run "
            f"starts a fake one (repro_torch.launch.dryrun)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device: str = "cuda"):
    """The (1, 1) ("data", "model") mesh on one device: ``cuda`` (the
    default; an error without a card, never a CPU fallback) or ``cpu``."""
    from torch.distributed.device_mesh import init_device_mesh

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: device 'cuda' needs a CUDA card and "
                           "torch.cuda.is_available() is False; pass device='cpu'")
    if device == "cuda":
        torch.cuda.set_device(0)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=f"tcp://127.0.0.1:{_free_port()}",
                                rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise RuntimeError(f"make_host_mesh: the default process group has "
                           f"{dist.get_world_size()} ranks, the host mesh one")
    return init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def host_mesh(device: str = "cuda"):
    """``make_host_mesh(device)`` for the enclosed region; the process
    group it had to start is destroyed on the way out."""
    owned = not dist.is_initialized()
    mesh = make_host_mesh(device)
    try:
        yield mesh
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def mesh_name(mesh) -> str:
    """The mesh's shape as the JAX package names it ("16x16")."""
    return "x".join(str(s) for s in mesh.mesh.shape)
