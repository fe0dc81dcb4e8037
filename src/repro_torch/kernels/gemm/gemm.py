"""The CUDA GeMM kernel (``csrc/gemm.cu``): its tilings, its split-K plan
and its binding.

``csrc/gemm.cu`` replaces the TPU kernel
``src/repro/kernels/gemm/gemm.py:_gemm_kernel``.  Each block owns one
(bm, bn) output tile and runs its K loop itself, streaming (bm, bk) and
(bk, bn) input tiles through ``stages`` shared-memory buffers filled with
16-byte ``cp.async`` copies; each thread keeps a register tile of outputs
and reads both operands as vectors, so that on the H100 the FFMA (float32)
or INT32 multiply-add (int32) rate, not shared memory, is what it meets.  The
tiling comes from the e-GPU config, as on the TPU:
:meth:`~repro_torch.core.device.EGPUConfig.cuda_knobs` projects the config's
knobs onto a tile shape, a pipeline depth and a shared-memory budget, and
:func:`tiles_from_knobs` picks the largest tiling the kernel was compiled
for that fits them.  Where that tiling leaves most SMs idle, an int32
product splits K across blocks (:func:`plan_split_k`); a float32 product
never does, so its bits are one in-order chain per output.
"""

from __future__ import annotations

import ctypes
import logging
from typing import NamedTuple

import torch

from ...core.device import KernelKnobs, check_smem_budget
from ..common import cdiv, launch, ptr, stream_of

_LOG = logging.getLogger(__name__)

#: (bm, bn) output tiles csrc/gemm.cu is compiled for, largest last
COMPILED_TILES = ((16, 32), (32, 64), (64, 128))
#: pipeline depths csrc/gemm.cu is compiled for, largest last
COMPILED_STAGES = (2, 4)
#: K-tile depth of every compiled tiling
BK = 16
#: bytes of one element inside the kernel (inputs are widened to int32 or
#: float32 before the launch)
ITEMSIZE = 4
#: the fewest k-tiles one split of an int32 product's K takes
MIN_K_TILES_PER_SPLIT = 2


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


class SplitK(NamedTuple):
    splits: int
    k_tiles_per_split: int


def plan_split_k(m: int, n: int, k: int, tiling: GemmTiling, sm_count: int,
                 dtype: torch.dtype) -> SplitK:
    """How the kernel cuts K across blocks: ``splits`` runs of
    ``k_tiles_per_split`` whole k-tiles (the last may be shorter, none is
    empty).

    A float32 product never splits (one in-order chain per output).  An
    int32 product splits only when its ``cdiv(m, bm) * cdiv(n, bn)`` tiles
    fill at most half the card's ``sm_count`` SMs, and then aims the grid
    at about one block per SM with at least :data:`MIN_K_TILES_PER_SPLIT`
    k-tiles a split.  uint32 sums are exact modulo 2^32 in any order, so
    the split changes no bit.  The plan depends on its arguments only.
    """
    k_tiles = cdiv(k, tiling.bk)
    whole = SplitK(1, max(1, k_tiles))
    if dtype.is_floating_point:
        return whole
    blocks = cdiv(m, tiling.bm) * cdiv(n, tiling.bn)
    if 2 * blocks > sm_count:
        return whole
    want = min(sm_count // max(1, blocks), k_tiles // MIN_K_TILES_PER_SPLIT)
    if want <= 1:
        return whole
    per = cdiv(k_tiles, want)
    return SplitK(cdiv(k_tiles, per), per)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = {torch.int32: [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
         torch.float32: [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]}
_SYMBOL = {torch.int32: "repro_gemm_i32", torch.float32: "repro_gemm_f32"}


def launch_gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                tiling: GemmTiling) -> None:
    """Launch ``csrc/gemm.cu`` on contiguous int32 or float32 CUDA tensors
    a (m, k), b (k, n) into c (m, n), on the current stream, with the
    split-K plan of :func:`plan_split_k` (logged at debug level)."""
    m, k = a.shape
    n = b.shape[1]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    plan = plan_split_k(m, n, k, tiling, sms, a.dtype)
    _LOG.debug("gemm %dx%dx%d %s, tiling %s: %d split(s) of %d k-tiles",
               m, k, n, a.dtype, tiling[:2], *plan)
    split = (plan.k_tiles_per_split,) if a.dtype == torch.int32 else ()
    launch("gemm", _SYMBOL[a.dtype], _ARGS[a.dtype], ptr(a), ptr(b), ptr(c),
           m, n, k, tiling.bm, tiling.bn, tiling.stages, *split,
           a.device.index, stream_of(a))
