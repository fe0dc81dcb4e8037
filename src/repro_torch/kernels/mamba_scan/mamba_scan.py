"""The CUDA Mamba selective-scan kernel (``csrc/mamba_scan.cu``), its launch
plan and its binding.

``csrc/mamba_scan.cu`` replaces the TPU kernel
``src/repro/kernels/mamba_scan/mamba_scan.py:_mamba_kernel``.  A block of
:data:`THREADS` threads owns ``THREADS / lanes`` channels of one batch row;
``lanes`` threads share a channel's N f32 states, kept in registers across
T and seeded from ``state0`` or from zeros.  x, delta, b and c stream
through a ring of stages in shared memory (16-byte copies where
:func:`rows_16b` allows them, one element at a time elsewhere), so the
chain of steps never waits on device memory; the exponentials are
``2^(delta * a log2 e)`` on the special-function unit.  :func:`plan_mamba`
picks ``lanes``.  The output leaves out the D * x skip term, as the TPU
kernel does.

``csrc/mamba_scan_bwd.cu`` is the scan's gradient (no state in, no gradient
into the final state), which replaces no TPU kernel: the JAX package takes
it from ``jax.grad`` of its XLA path.  :func:`plan_mamba_bwd` splits a
channel's N states over lanes (at most :data:`BWD_MAX_STATES` a thread,
:data:`BWD_THREADS` threads of one batch row a block, whatever B is).  A
sweep keeps each thread's state at the start of every chunk of
:data:`BWD_CHUNK` steps (in shared memory, or a scratch buffer whose size
:func:`bwd_scratch_words` asks the library for); then each chunk, from the
last, runs forward again with the forward's own exponentials, keeping
every h and exponential in registers for the reverse walk, which takes
none.  b's and c's gradients are summed over channels in a fixed order.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..common import cdiv, kernel_library, launch, ptr, stream_of

#: state sizes the kernel is compiled for (the state lives in registers)
COMPILED_N = (2, 4, 8, 16, 32)
#: threads per block (csrc/mamba_scan.cu: kThreads)
THREADS = 128
#: how many threads may share a channel's states, fewest first
LANES = (1, 2, 4)
#: the most states one thread keeps
MAX_STATES_PER_LANE = 16
#: the fewest states one thread keeps when N has that many: each lane pays
#: the per-step work (the loads of x, delta, b and c, the sum of y across
#: lanes, the store) for its share of the states, and at 4 states a lane
#: that cost outweighed the warps gained at every shape of the sweep
#: below (N = 16: 4 lanes lost to 2 by 11-41 %)
MIN_STATES_PER_LANE = 8
#: the warps per SM the plan aims at before it splits a channel's states
#: across more lanes: 12 for a scan of fewer than LONG_SCAN steps, 6 for a
#: longer one.  A short scan spends a large share of its time filling and
#: draining the ring, which more warps hide; a long one pays each lane's
#: per-step work at every step, which fewer lanes cut.  Read from
#: ``bench_mamba_scan.py --lanes`` on an H100 (Dm = 16384, N = 16, B = 1,
#: 2, 4, T = 128 .. 4096; PERF.md, Findings): at B = 2, 2 lanes (15.5
#: warps an SM) beat 1 (7.8) at T = 128 and 256 and lost from T = 512 on.
#: The warps counted are one batch row's (the plan does not read B, so a
#: row's bits do not depend on its batch): at B = 2 and 4 it takes B = 1's
#: lanes, 2 at jamba's width, which can be slower than 1 lane there.
WARPS_PER_SM = 12
WARPS_PER_SM_LONG = 6
LONG_SCAN = 512

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
#: (dtype of x, dtype of delta) -> entry point
_SYMBOL = {(torch.float32, torch.float32): "repro_mamba_scan_f32",
           (torch.bfloat16, torch.float32): "repro_mamba_scan_bf16",
           (torch.bfloat16, torch.bfloat16): "repro_mamba_scan_bf16d"}
DTYPES = tuple(_SYMBOL)
_BWD_ARGS = [_P] * 15 + [_I] * 7 + [_P]
_BWD_SYMBOL = {key: name.replace("scan", "scan_bwd")
               for key, name in _SYMBOL.items()}
#: the backward kernel's threads a block, steps a chunk and most states a
#: thread (csrc/mamba_scan_bwd.cu: kThreads, kC, kMaxStates)
BWD_THREADS = 256
BWD_CHUNK = 8
BWD_MAX_STATES = 4


class MambaPlan(NamedTuple):
    lanes: int        # threads that share a channel's N states
    channels: int     # channels per block (THREADS // lanes)
    blocks: int       # B * ceil(Dm / channels)
    warps_per_sm: float


def lane_choices(n: int):
    """The lane counts the kernel is compiled for at state size ``n``: each
    thread keeps between ``min(n,`` :data:`MIN_STATES_PER_LANE` ``)`` and
    :data:`MAX_STATES_PER_LANE` states (none when ``n`` is not in
    :data:`COMPILED_N`): 1 lane for N <= 8, 1 or 2 for 16, 2 or 4 for
    32."""
    return tuple(l for l in LANES if n in COMPILED_N and n % l == 0
                 and min(n, MIN_STATES_PER_LANE) <= n // l <= MAX_STATES_PER_LANE)


def plan_mamba(b: int, t: int, dm: int, n: int, sm_count: int) -> MambaPlan:
    """The launch of a (B = ``b``, T = ``t``, Dm = ``dm``, N = ``n``) scan
    on a card of ``sm_count`` SMs: the fewest lanes a channel with which
    ONE batch row's channels give :data:`WARPS_PER_SM` warps an SM
    (:data:`WARPS_PER_SM_LONG` from :data:`LONG_SCAN` steps on), else the
    most lanes allowed; the grid then holds ``b`` times that row's blocks.

    A pure function of its arguments.  The lanes fix the order of y's sum
    over N, and they do not depend on ``b``: a row's bits are the same in a
    batch of any size (the decode engine prefills one prompt at a time and
    ``greedy_generate`` a batch of them).
    """
    if min(b, dm, sm_count) < 1 or t < 0:
        raise ValueError(f"plan_mamba needs positive sizes, got b={b}, t={t}, "
                         f"dm={dm}, sm_count={sm_count}")
    choices = lane_choices(n)
    if not choices:
        raise ValueError(f"the mamba_scan kernel is compiled for N in "
                         f"{COMPILED_N}; got N={n}")
    target = WARPS_PER_SM_LONG if t >= LONG_SCAN else WARPS_PER_SM
    lanes = next((l for l in choices if dm * l >= target * sm_count * 32),
                 choices[-1])
    channels = THREADS // lanes
    blocks = b * cdiv(dm, channels)
    return MambaPlan(lanes, channels, blocks,
                     blocks * THREADS / 32 / sm_count)


def rows_16b(data_ptr: int, dm: int, itemsize: int) -> bool:
    """Whether the kernel streams a contiguous (B, T, Dm) tensor with
    16-byte copies: a 16-byte aligned base and rows of a whole number of 16
    bytes (Dm a multiple of 4 in f32, of 8 in bf16).  The kernel copies any
    other tensor one element at a time, and refuses the 16-byte path for
    it."""
    return data_ptr % 16 == 0 and (dm * itemsize) % 16 == 0


def launch_mamba_scan(x: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor,
                      state0: Optional[torch.Tensor], y: torch.Tensor,
                      state: torch.Tensor, lanes: Optional[int] = None) -> None:
    """Launch on contiguous CUDA tensors x/delta (B,T,Dm), f32 a (Dm,N),
    b/c (B,T,N) and ``state0`` (B,Dm,N) or None, into the contiguous ``y``
    (B,T,Dm) in x's dtype and f32 ``state`` (B,Dm,N), on the current
    stream, with :func:`plan_mamba`'s lanes, or ``lanes`` (one of
    :func:`lane_choices`) where the caller names them."""
    bsz, t, dm = x.shape
    n = a.shape[1]
    if lanes is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        lanes = plan_mamba(bsz, t, dm, n, sms).lanes
    elif lanes not in lane_choices(n):
        raise ValueError(f"mamba_scan at N={n} takes lanes in "
                         f"{lane_choices(n)}; got {lanes}")
    copy16 = (rows_16b(x.data_ptr(), dm, x.element_size())
              and rows_16b(delta.data_ptr(), dm, delta.element_size()))
    launch("mamba_scan", _SYMBOL[x.dtype, delta.dtype], _ARGS, ptr(x),
           ptr(delta), ptr(a), ptr(b), ptr(c), ptr(state0), ptr(y),
           ptr(state), bsz, t, dm, n, lanes, int(copy16),
           x.device.index, stream_of(x))


class MambaBwdPlan(NamedTuple):
    lanes: int        # threads that share a channel's N states
    states: int       # states a thread (N / lanes)
    channels: int     # channels a block (BWD_THREADS // lanes)
    blocks: int       # blocks of one batch row
    chunk: int        # steps between the kept states (BWD_CHUNK)


def plan_mamba_bwd(dm: int, n: int) -> MambaBwdPlan:
    """The backward kernel's launch for Dm = ``dm`` channels of state size
    ``n``: ``min(n,`` :data:`BWD_MAX_STATES` ``)`` states a thread, so
    ``n / states`` lanes a channel, and ``ceil(dm / channels)`` blocks a
    batch row.

    A pure function of its arguments, with no B and no SM count: a
    channel's sums over its states and the order of db's and dc's sums over
    channels (lanes in a warp, the block's warps, then the blocks) are the
    same in a batch of any size.
    """
    if n not in COMPILED_N or dm < 1:
        raise ValueError(f"the mamba_scan backward kernel is compiled for N in "
                         f"{COMPILED_N} and Dm >= 1; got N={n}, Dm={dm}")
    states = min(n, BWD_MAX_STATES)
    lanes = n // states
    channels = BWD_THREADS // lanes
    return MambaBwdPlan(lanes, states, channels, cdiv(dm, channels), BWD_CHUNK)


def bwd_scratch_words(b: int, t: int, dm: int, n: int) -> int:
    """f32 words of scratch the backward kernel needs for its chunk states
    at these sizes: 0 where they stay in shared memory (T <= 136 at N =
    16), else B (ceil(T / 8) - 1) Dm N with Dm rounded up to a block."""
    fn = kernel_library().repro_mamba_scan_bwd_scratch
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _I, _I]
        fn.restype = ctypes.c_longlong
    words = fn(b, t, dm, n)
    if words < 0:
        raise RuntimeError(f"repro_mamba_scan_bwd_scratch failed for B={b}, "
                           f"T={t}, Dm={dm}, N={n}")
    return words


def launch_mamba_scan_bwd(x: torch.Tensor, delta: torch.Tensor,
                          a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                          dy: torch.Tensor, dx: torch.Tensor,
                          ddelta: torch.Tensor, da: torch.Tensor,
                          db: torch.Tensor, dc: torch.Tensor) -> None:
    """Launch the backward on contiguous CUDA tensors x/delta/dy (B,T,Dm),
    T >= 1, f32 a (Dm,N) and b/c (B,T,N), into the contiguous ``dx`` (x's
    dtype), ``ddelta`` (delta's dtype), f32 ``da`` (Dm,N), ``db`` and ``dc``
    (B,T,N), on the current stream, with :func:`plan_mamba_bwd`'s plan.
    The spilled chunk states (if any) and the partial sums are scratch
    allocated here."""
    bsz, t, dm = x.shape
    n = a.shape[1]
    plan = plan_mamba_bwd(dm, n)
    f32, dev = torch.float32, x.device
    words = bwd_scratch_words(bsz, t, dm, n)
    ckpt = torch.empty(words, dtype=f32, device=dev) if words else None
    da_part = torch.empty((bsz, dm, n), dtype=f32, device=dev)
    db_part, dc_part = (torch.empty((bsz, plan.blocks, t, n), dtype=f32,
                                    device=dev) for _ in range(2))
    # b's and c's rows are whole 16 bytes from N = 4 on: they then come by
    # TMA too, and need 16-byte aligned bases for it
    copy16 = (all(rows_16b(z.data_ptr(), dm, z.element_size())
                  for z in (x, delta, dy))
              and (n * 4 % 16 != 0
                   or all(rows_16b(z.data_ptr(), n, 4) for z in (b, c))))
    launch("mamba_scan_bwd", _BWD_SYMBOL[x.dtype, delta.dtype], _BWD_ARGS,
           ptr(x), ptr(delta), ptr(a), ptr(b), ptr(c), ptr(dy), ptr(ckpt),
           ptr(dx), ptr(ddelta), ptr(da_part), ptr(db_part), ptr(dc_part),
           ptr(da), ptr(db), ptr(dc), bsz, t, dm, n, plan.blocks,
           int(copy16), dev.index, stream_of(x))
