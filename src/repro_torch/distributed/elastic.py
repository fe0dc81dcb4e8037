"""Elastic resharding: move a sharded tree between meshes of any size.

The JAX package's ``distributed/elastic.py``.  Failure recovery and elastic
scaling both reduce to one primitive: a tree placed under mesh A (N
positions) must be placed under mesh B (M positions, possibly another
shape).  Checkpoints store *global* shapes plus logical axes (see
:mod:`repro_torch.checkpoint`), so a restore rebuilds each global tensor
under the new mesh's placements: placement is re-derived, not replayed.

:func:`reshard_arrays` is the in-memory variant: it gathers each leaf whole
(``full_tensor()`` of a DTensor, a collective over the source mesh) and
``distribute_tensor``\\ s it under the target placements, each rank cutting
its own block.
"""

from __future__ import annotations

from typing import Any

import torch

from ..models.params import map_tree
from .sharding import distribute_tree


def _to_global(x: Any) -> torch.Tensor:
    """A leaf as a whole tensor: a DTensor gathered, anything else as is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else torch.as_tensor(x)


def gather_tree(tree: Any) -> Any:
    """Every leaf whole: DTensors gathered (a collective every rank of their
    mesh joins), other leaves as they are.  What a checkpoint saves."""
    return map_tree(_to_global, tree)


def reshard_arrays(tree: Any, placements_tree: Any, mesh: Any) -> Any:
    """Re-place every leaf of ``tree`` under the matching placements of
    ``placements_tree`` on ``mesh`` (a ``DeviceMesh``).  Works across meshes
    (the source placement is irrelevant); shapes must match.  Every rank of
    the source mesh must call it (the gather is a collective)."""
    return distribute_tree(gather_tree(tree), placements_tree, mesh)


def replicate(tree: Any, mesh: Any) -> Any:
    """Fully replicate a tree over a mesh (small states, rng, schedules)."""
    from torch.distributed.tensor import Replicate
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    return reshard_arrays(tree, map_tree(lambda _x: rep, tree), mesh)
