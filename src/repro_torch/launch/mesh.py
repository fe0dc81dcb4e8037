"""Production meshes, as ``torch.distributed`` device meshes.

The JAX package's ``launch/mesh.py``: functions, not constants, so importing
this module touches no process group and no device.  Both make an
``init_device_mesh`` of the JAX package's shapes and axis names on the card
by default (``device_type="cpu"`` gives gloo meshes, as the tests use).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.runtime import resolve_device


def _device_type(device_type: str) -> str:
    """``device_type`` after the port's rule: the card unless asked for the
    CPU, and an error, not the CPU, when there is no card."""
    return resolve_device(device_type).type


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod.

    Axis semantics: ``data`` carries DP/FSDP, ``model`` carries TP/EP/SP,
    ``pod`` carries cross-pod DP.  The process group must already hold
    that many ranks (``init_device_mesh`` raises otherwise).
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """Degenerate 1-position ``(data=1, model=1)`` mesh with the production
    axis names, so the same step code runs on one device.

    Starts a world-1 process group (a ``HashStore``, no port) only when
    none exists; a group of another world size raises, as ``jax.make_mesh``
    does for a device count that does not match.
    """
    kind = _device_type(device_type)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if world != 1:
        raise ValueError(f"make_host_mesh needs a world of 1 rank, the "
                         f"process group has {world}")
    return init_device_mesh(kind, (1, 1), mesh_dim_names=("data", "model"))
