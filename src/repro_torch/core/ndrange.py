"""NDRange — the Tiny-OpenCL execution model (paper §III-B / §V-B).

OpenCL launches a *kernel* over a ``global_size`` of work-items, grouped into
work-groups of ``local_size``.  The paper's Tiny-OpenCL scheduler distributes
work-groups over compute units and performs all boundary checks up-front so
the user kernel never has to.  :class:`NDRange` carries those sizes for the
machine model (:mod:`repro_torch.core.scheduler`), and
:func:`pad_to_groups` / :func:`crop_from_groups` pad a tensor to whole
work-groups and back.

The JAX package also has in-kernel helpers (``global_ids`` and ``edge_mask``)
that rebuild a work-item's id and the tail mask from the Pallas grid.  They
have no counterpart here: the CUDA kernels under ``repro_torch/csrc`` compute
their ids from ``blockIdx``/``threadIdx`` and mask the ragged tail with a
bounds check.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class NDRange:
    """An OpenCL-style NDRange: 1-D or 2-D global/local sizes.

    ``global_size`` need not divide by ``local_size`` — the scheduler pads to
    whole work-groups and masks the tail, mirroring the paper's up-front
    boundary checks (§V-B: "the user kernel is relieved from handling such
    logic").
    """

    global_size: Tuple[int, ...]
    local_size: Tuple[int, ...]

    def __post_init__(self):
        if len(self.global_size) not in (1, 2):
            raise ValueError("NDRange supports 1-D and 2-D launches")
        if len(self.global_size) != len(self.local_size):
            raise ValueError("global/local rank mismatch")
        if any(g <= 0 for g in self.global_size) or any(l <= 0 for l in self.local_size):
            raise ValueError("sizes must be positive")

    @property
    def rank(self) -> int:
        return len(self.global_size)

    @property
    def num_groups(self) -> Tuple[int, ...]:
        """Work-groups per dimension (ceil division — tail groups are masked)."""
        return tuple(-(-g // l) for g, l in zip(self.global_size, self.local_size))

    @property
    def total_groups(self) -> int:
        return math.prod(self.num_groups)

    @property
    def total_work_items(self) -> int:
        return math.prod(self.global_size)

    @property
    def padded_size(self) -> Tuple[int, ...]:
        return tuple(n * l for n, l in zip(self.num_groups, self.local_size))

    def to_grid(self) -> Tuple[int, ...]:
        """One grid entry per work-group, per dimension."""
        return self.num_groups


def pad_to_groups(x: torch.Tensor, ndr: NDRange, axis: int = 0,
                  fill: float | int = 0) -> torch.Tensor:
    """Pad ``x`` along ``axis`` so whole work-groups tile it exactly."""
    target = ndr.padded_size[axis if ndr.rank > 1 else 0]
    axis = axis % x.dim()
    cur = x.shape[axis]
    if cur == target:
        return x
    # F.pad lists (left, right) pairs from the LAST dimension backwards
    pads = [0, 0] * (x.dim() - axis)
    pads[-1] = target - cur
    return F.pad(x, pads, value=fill)


def crop_from_groups(x: torch.Tensor, ndr: NDRange, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`pad_to_groups`."""
    size = ndr.global_size[axis if ndr.rank > 1 else 0]
    return x.narrow(axis, 0, size)
