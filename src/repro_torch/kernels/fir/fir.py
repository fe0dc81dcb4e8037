"""The CUDA FIR kernel (``csrc/fir.cu``), its launch plan and its binding.

``csrc/fir.cu`` replaces the TPU kernel ``src/repro/kernels/fir/fir.py:
_fir_kernel``.  A thread owns ``rows`` consecutive outputs and slides a
window of ``rows + 4`` samples through its registers, four taps at a time;
the taps and the window they need stream through shared memory in chunks
of :data:`CHUNK` taps, so any number of taps runs and each output still
adds its taps in order t = 0..taps-1.  :func:`plan_fir` picks ``rows`` and
the threads a block for one signal; a (batch, n) stack of signals is one
launch whose grid repeats that plan for every row.  The plan changes no
bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..common import cdiv, launch, ptr, stream_of
from .ref import FXP_SHIFT

#: outputs a thread the kernel is compiled for (csrc/fir.cu: the cases of
#: launch_fir)
ROWS = (1, 2, 4, 8)
#: taps staged in shared memory at a time (csrc/fir.cu: kChunk)
CHUNK = 512
#: the most threads a block (csrc/fir.cu: kMaxThreads)
MAX_THREADS = 256
#: warp schedulers an SM (Hopper)
SCHEDULERS = 4
#: the most threads a block the plan takes: one warp for each scheduler
PLAN_THREADS = 128
#: what a warp pays besides its products (staging its block's window, the
#: loads of each group of four taps), in products a lane: fitted to the
#: sweep of ``bench_tinybio_kernels.py --sweep`` on an H100 (PERF.md,
#: Findings), where at 2^20 samples and 128 taps a scheduler's 8 warps of
#: 8 outputs a thread took 0.90x the time of its 16 warps of 4 (float32
#: and Q15), about one output of 128 taps a lane
WARP_FIXED_PRODUCTS = 128
_P, _I = ctypes.c_void_p, ctypes.c_int
_FLOAT_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_FIXED_ARGS = [_P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P]
#: the most signals a launch takes (the grid's second axis)
MAX_BATCH = 65535
_FIXED_SYMBOL = {torch.int16: "repro_fir_i16", torch.int32: "repro_fir_i32"}


class FirPlan(NamedTuple):
    rows: int      # outputs a thread
    threads: int   # threads a block (csrc/fir.cu launches ceil(n / (rows *
                   # threads)) blocks)


def plan_fir(n: int, taps: int, sm_count: int) -> FirPlan:
    """The launch of a ``taps``-tap FIR over ``n`` samples on a card of
    ``sm_count`` SMs.

    Each scheduler of the card runs ``rounds`` warps in turn, ``rounds =
    ceil(warps / (SCHEDULERS * sm_count))`` for ``warps = ceil(n / (32 *
    rows))``, and a warp costs ``32 * rows * taps`` products plus
    :data:`WARP_FIXED_PRODUCTS` a lane.  ``rows`` (of :data:`ROWS`) makes
    ``rounds * (rows * taps + WARP_FIXED_PRODUCTS)`` least, the larger on a
    tie.  The threads a block are then the fewest that cover the signal
    with one block per SM, at most :data:`PLAN_THREADS` (one warp for each
    scheduler), so at TinyBio's 65,536 samples every SM runs one block of
    125 threads, four warps, and beyond it blocks of 128 threads.

    A pure function of its arguments; the plan changes no bits.
    """
    if min(n, taps, sm_count) < 1:
        raise ValueError(f"plan_fir needs n, taps, sm_count >= 1; got n={n}, "
                         f"taps={taps}, sm_count={sm_count}")

    def cost(rows: int) -> int:
        rounds = cdiv(cdiv(n, 32 * rows), SCHEDULERS * sm_count)
        return rounds * (rows * taps + WARP_FIXED_PRODUCTS)

    rows = min(reversed(ROWS), key=cost)
    return FirPlan(rows, min(PLAN_THREADS, cdiv(n, rows * sm_count)))


def launch_fir(x: torch.Tensor, h: torch.Tensor, y: torch.Tensor,
               plan: Optional[FirPlan] = None) -> None:
    """Launch on contiguous CUDA tensors: a float32 signal ``x`` (n,) or
    stack of signals (batch, n) with float32 taps ``h``, or an int16/int32
    ``x`` with int16/int32 Q15 taps ``h``, into ``y`` (like ``x``), on the
    current stream, with ``plan`` or :func:`plan_fir`'s for one signal."""
    n, taps = x.shape[-1], h.shape[0]
    batch = x.shape[0] if x.dim() == 2 else 1
    if batch > MAX_BATCH:
        raise ValueError(f"fir launches at most {MAX_BATCH} signals, got {batch}")
    if plan is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        plan = plan_fir(n, taps, sms)
    dev = x.device.index
    if x.dtype == torch.float32:
        launch("fir", "repro_fir_f32", _FLOAT_ARGS, ptr(x), ptr(h), ptr(y),
               n, taps, plan.rows, plan.threads, batch, dev, stream_of(x))
    else:
        launch("fir", _FIXED_SYMBOL[x.dtype], _FIXED_ARGS, ptr(x), ptr(h),
               int(h.dtype == torch.int16), ptr(y), n, taps, FXP_SHIFT,
               plan.rows, plan.threads, batch, dev, stream_of(x))
