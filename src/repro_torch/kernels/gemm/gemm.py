"""The CUDA GeMM kernel (``csrc/gemm.cu``): its tilings and its binding.

``csrc/gemm.cu`` replaces the TPU kernel
``src/repro/kernels/gemm/gemm.py:_gemm_kernel``.  Each block owns one
(bm, bn) output tile and runs the whole K loop itself, streaming (bm, bk)
and (bk, bn) input tiles through ``stages`` shared-memory buffers.  The
tiling comes from the e-GPU config, as on the TPU:
:meth:`~repro_torch.core.device.EGPUConfig.cuda_knobs` projects the config's
knobs onto a tile shape, a pipeline depth and a shared-memory budget, and
:func:`tiles_from_knobs` picks the largest tiling the kernel was compiled
for that fits them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...core.device import KernelKnobs, check_smem_budget
from ..common import launch, ptr, stream_of

#: (bm, bn) output tiles csrc/gemm.cu is compiled for, largest last
COMPILED_TILES = ((16, 32), (32, 64), (64, 128))
#: pipeline depths csrc/gemm.cu is compiled for, largest last
COMPILED_STAGES = (2, 4)
#: K-tile depth of every compiled tiling
BK = 16
#: bytes of one element inside the kernel (inputs are widened to int32 or
#: float32 before the launch)
ITEMSIZE = 4


class GemmTiling(NamedTuple):
    bm: int
    bn: int
    bk: int
    stages: int


def tiles_from_knobs(knobs: KernelKnobs) -> GemmTiling:
    """The largest compiled tiling within the knobs' tile shape and pipeline
    depth whose shared memory (``stages`` × one (bm, bk) and one (bk, bn)
    tile) fits the knobs' budget (the D$-size knob)."""
    stages = max([s for s in COMPILED_STAGES if s <= knobs.pipeline_depth],
                 default=COMPILED_STAGES[0])
    for bm, bn in reversed(COMPILED_TILES):
        if bm > knobs.tile_m or bn > knobs.tile_n:
            continue
        try:
            check_smem_budget(knobs, bm * BK * ITEMSIZE, BK * bn * ITEMSIZE)
        except ValueError:
            continue
        return GemmTiling(bm, bn, BK, stages)
    raise ValueError(f"no compiled GeMM tiling fits {knobs}")


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_SYMBOL = {torch.int32: "repro_gemm_i32", torch.float32: "repro_gemm_f32"}


def launch_gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                tiling: GemmTiling) -> None:
    """Launch ``csrc/gemm.cu`` on contiguous int32 or float32 CUDA tensors
    a (m, k), b (k, n) into c (m, n), on the current stream."""
    m, k = a.shape
    n = b.shape[1]
    launch("gemm", _SYMBOL[a.dtype], _ARGS, ptr(a), ptr(b), ptr(c), m, n, k,
           tiling.bm, tiling.bn, tiling.stages, a.device.index, stream_of(a))
