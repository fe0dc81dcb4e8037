"""The CUDA norm kernel (``csrc/norm.cu``) and its binding.

``csrc/norm.cu`` replaces no TPU kernel (the JAX package leaves its norms
to XLA).  It normalises each row of x, or each group of a row, in f32, with
every sum in one order fixed by the group's width and the dtype alone
(:func:`plan_norm`), so a decode step's row keeps its bits in any batch;
and it is one launch where the norm in PyTorch ops is about eight.  Bytes
bound it, and at decode widths the launch: it reads each row once with
16-byte loads into registers, the scale and bias as 16-byte vectors, and
writes y once with 16-byte stores; x may be a view whose rows lie a fixed
stride apart.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..common import launch, ptr, stream_of

DTYPES = (torch.float32, torch.bfloat16)

#: csrc/norm.cu: bytes a vector load moves, the most threads a group takes,
#: the most vectors a thread holds
VEC_BYTES = 16
MAX_GROUP_THREADS = 512
MAX_LOADS = 8
#: threads of a block whose groups take fewer
BLOCK_THREADS = 256

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _LL, _I, _I, _I, ctypes.c_float,
         _I, _I, _P]
_SYMBOL = {torch.float32: "repro_norm_f32", torch.bfloat16: "repro_norm_bf16"}


class NormPlan(NamedTuple):
    vec: int       # values a 16-byte vector holds
    loads: int     # vectors a thread holds
    threads: int   # threads a group
    groups: int    # groups a block


@functools.lru_cache(maxsize=None)
def plan_norm(group: int, dtype: torch.dtype) -> NormPlan:
    """How the kernel reduces a group of ``group`` values of ``dtype``: a
    function of the two alone, never of the row count, so a row's sums run
    in one order in any batch.  The group is cut into 16-byte vectors; each
    thread holds ``loads`` of them (a power of two, as few as the cap of
    512 threads a group allows), thread l the vectors l, l + threads, ...;
    up to 32 threads a group is a power of two (small groups share a warp),
    more are whole warps.  A block holds ``groups`` whole groups, 256
    threads where the groups are small."""
    if dtype not in DTYPES:
        raise TypeError(f"plan_norm: no kernel for {dtype}")
    if group <= 0:
        raise ValueError(f"plan_norm: a group of {group}")
    vec = VEC_BYTES // dtype.itemsize
    vectors = -(-group // vec)
    loads = 1
    while loads * MAX_GROUP_THREADS < vectors:
        loads *= 2
    if loads > MAX_LOADS:
        raise ValueError(
            f"the norm kernel takes groups of at most "
            f"{MAX_LOADS * MAX_GROUP_THREADS * vec} {dtype} values; got {group}")
    per = -(-vectors // loads)
    if per <= 32:
        threads = 1
        while threads < per:
            threads *= 2
    else:
        threads = 32 * -(-per // 32)
    groups = max(1, BLOCK_THREADS // threads)
    return NormPlan(vec, loads, threads, groups)


def row_stride(x: torch.Tensor) -> Optional[int]:
    """The stride between the rows of ``x`` read as (rows, last axis), or
    None where the last axis is not contiguous or the leading axes do not
    fold into one stride (the caller copies then)."""
    if x.stride(-1) != 1:
        return None
    lead = [(n, s) for n, s in zip(x.shape[:-1], x.stride()[:-1]) if n != 1]
    if not lead:
        return x.shape[-1]
    inner = lead[-1][1]
    expect = inner
    for n, s in reversed(lead):
        if s != expect:
            return None
        expect = s * n
    return inner


def launch_norm(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor], mean: Optional[torch.Tensor],
                rstd: Optional[torch.Tensor], *, group: int, eps: float,
                layer: bool, stride: int) -> None:
    """Launch on CUDA tensors: x (..., d) whose rows lie ``stride`` elements
    apart (its last axis contiguous), the contiguous y of x's shape and
    dtype, the contiguous f32 ``scale`` and ``bias`` (d,) (bias may be
    None), the f32 ``mean`` and ``rstd`` (rows, d / group) or None, on the
    current stream, by :func:`plan_norm`.  Counts one launch of ``norm``."""
    d = x.shape[-1]
    rows = x.numel() // d
    plan = plan_norm(group, x.dtype)
    launch("norm", _SYMBOL[x.dtype], _ARGS, ptr(x), ptr(y), ptr(scale),
           ptr(bias), ptr(mean), ptr(rstd), rows, d, group, stride,
           plan.threads, plan.loads, plan.groups, float(eps), int(layer),
           x.device.index, stream_of(x))
