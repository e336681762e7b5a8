"""Production and host meshes (port of ``repro.launch.mesh``), as
``DeviceMesh``es over the installed process group.

Defined as functions, so importing this module touches no process group.
``make_production_mesh`` needs a group of 256 or 512 ranks; the dry run
installs a fake one (``launch.dryrun``).  ``make_host_mesh`` takes the
ranks of the installed group, and where none is installed makes a group
of one (``gloo`` on the CPU, ``nccl`` on the card) over a ``HashStore``:
``owns_group`` tells the caller to destroy it when done.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _mesh(device_type: str, shape, axes):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for d in shape:
        n *= d
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of {shape} needs {n} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    """16x16 single pod (256 chips) or 2x16x16 two-pod (512 chips)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def owns_group(device_type: str = "cuda") -> bool:
    """Install a process group of one where none is installed (``nccl``
    for the card, ``gloo`` for the CPU); True when this call installed it
    (the caller destroys it)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    return True


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """(world // model, model) as ("data", "model") over the installed
    group's ranks (a group of one where none is installed: see
    ``owns_group``)."""
    owns_group(device_type)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"a model axis of {model} does not divide "
                         f"{n} ranks")
    return _mesh(device_type, (n // model, model), ("data", "model"))


def batch_axes(mesh) -> tuple:
    """Mesh axes the batch dim shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
