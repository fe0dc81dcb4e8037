"""The CUDA SVM kernel (``csrc/svm.cu``), its launch plan and its binding.

``csrc/svm.cu`` replaces the TPU kernel ``src/repro/kernels/svm/svm.py:
_svm_kernel``.  A block of :data:`THREADS` threads owns ``queries`` query
rows (:func:`plan_svm`) and sums over all m support vectors itself, thread
t over vectors t, t + THREADS, .., read straight from device memory, so no
atomics are needed and the bits depend on neither the plan nor the rows'
alignment.  The bias is added in the kernel, from a device pointer or a
float (:func:`bias_args`), so a call on the card is one launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..common import cdiv, launch, ptr, stream_of

#: threads per block (csrc/svm.cu: kThreads)
THREADS = 256
#: queries per block the kernel is compiled for
QUERIES = (1, 2, 4, 8)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _F, _P, _I, _I, _I, _F, _I, _I, _I, _P]


class SvmPlan(NamedTuple):
    queries: int   # query rows a block owns
    blocks: int    # ceil(q / queries)


def plan_svm(q: int, sm_count: int) -> SvmPlan:
    """The launch of an SVM over ``q`` queries on a card of ``sm_count``
    SMs: the most queries a block (of :data:`QUERIES`) that still give at
    least one block per SM, else 1.  Each block reads every support vector,
    so fewer, fuller blocks move fewer bytes from L2 while the grid still
    covers the card.

    A pure function of its arguments; the plan changes no bits.
    """
    if min(q, sm_count) < 1:
        raise ValueError(f"plan_svm needs q, sm_count >= 1; got q={q}, "
                         f"sm_count={sm_count}")
    queries = max((k for k in QUERIES if cdiv(q, k) >= sm_count), default=1)
    return SvmPlan(queries, cdiv(q, queries))


def bias_args(b, device: torch.device) -> Tuple[Optional[torch.Tensor], float]:
    """(tensor whose device pointer the kernel reads, or None; the float it
    adds when there is none) for the bias ``b``: a 0-d tensor on ``device``
    goes by pointer (as float32), so nothing waits for the card; a number
    or a 0-d CPU tensor goes by value."""
    if isinstance(b, torch.Tensor):
        if b.dim() != 0:
            raise ValueError(f"svm takes a number or a 0-d tensor as the "
                             f"bias; got shape {tuple(b.shape)}")
        if b.device == device:
            return b.to(torch.float32), 0.0
        if b.device.type != "cpu":
            raise ValueError(f"svm bias on {b.device}, queries on {device}")
    return None, float(b)


def launch_svm(x: torch.Tensor, sv: torch.Tensor, alpha: torch.Tensor, b,
               gamma: Optional[float], out: torch.Tensor) -> None:
    """Launch on contiguous float32 CUDA tensors x (q, d), sv (m, d) and
    alpha (m,) into ``out`` (q,), on the current stream, with
    :func:`plan_svm`'s plan; ``gamma=None`` is the linear kernel."""
    (q, d), m = x.shape, sv.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    b_dev, b_val = bias_args(b, x.device)
    launch("svm", "repro_svm_f32", _ARGS, ptr(x), ptr(sv), ptr(alpha),
           ptr(b_dev), b_val, ptr(out), q, m, d,
           0.0 if gamma is None else float(gamma), int(gamma is not None),
           plan_svm(q, sms).queries, x.device.index, stream_of(x))
