#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. card and build — prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them, and builds the CUDA kernels from ``src/repro_torch/csrc`` with the
   toolkit's ``nvcc`` (one process per source, all at once);
2. each kernel against its plain PyTorch version, on the card, at the main
   paths' shapes plus ragged sizes, with the tolerance stated beside each
   check; every call must move the kernel's launch counter by one.
   ``fir`` must equal the plain version bit for bit (f32, Q15 int16, int32
   wraparound, int32 taps on an int16 signal, views off 16-byte alignment,
   taps 1 .. 5000), also under every outputs-a-thread count and block
   sizes of 1, 125 and 256 threads (``FirPlan``); ``delineate``'s flags must
   equal the plain version's for f32, int16 and int32, n = 1 .. 33 and
   unaligned views.
   ``stockham_fft`` runs every n from 1 to 8192 (and a row base off 16-byte
   alignment at n = 512), and ``power_spectrum`` must give the bits of
   ``re*re + im*im`` over the card's own ``fft``; ``svm`` must give
   ``svm(0) + b`` bit for bit with the bias as a card tensor, a float and a
   CPU tensor, and runs d = 1024, d = 7 and q that give 4 and 8 queries a
   block (``plan_svm``).  The GeMM's three config tilings must give
   identical bits, int32 included where a tiling splits K across blocks
   (each case logs the split plans, and some must split).  Flash attention
   runs qwen's prefill shape, a ragged S = T = 300, a suffix with
   ``q_offset``, a non-causal case, Dk = 96 / Dv = 64 in float32 and in
   bfloat16, Dk = Dv = 64 in bfloat16, B = 1, S = T = 4096 in bfloat16,
   rows that see no key (``q_offset = -16``), and a bfloat16 view that no
   TMA tensor map describes (rows D + 1 elements apart), which the wrapper
   must copy once (``CONTIGUOUS_COPIES``).  ``rwkv6_scan`` runs bf16 and
   f32 inputs with ``state0`` absent, zero and random at T = 1, 256 and 300
   and D = 64 and 32, and decays drawn near 1 and near 0 (w = exp(-exp(x)),
   x over [-6, 3]) at the prefill shape and at T = 300, D = 32;
   ``decode_attention`` must give a B = 1 call the bits of the same row of
   a B = 4 call (output and partial triple, bf16 and f32, T = 512, 4096 and
   32768), and runs qwen's decode shape in bf16, a
   ragged MHA T = 300 in f32, an MQA group at Dk = Dv = 256, T = 32768,
   T = 1 and an MQA group of 16 at T = 1000, each with ``partial=True`` over
   the whole cache (the combine pass's unnormalized output where the split
   plan cuts T) and over 4 T-shards combined against the full result; the
   plans must include a single split, several, and a T that is no multiple
   of ``keys_per_split``, and each case's plan is logged;
   ``mamba_scan`` jamba's width (Dm = 16384, N = 16) at B = 4, T = 256
   and B = 1, T = 4096 with the dtypes the jamba block passes under bf16,
   a ragged T = 100, ``state0``, N = 32, bf16 rows of Dm = 300 and 301
   (no 16-byte copy describes them: the kernel's element-wise path, x and
   delta both bf16 at 301) and decays from 0 to 0.99999 over T = 512; each
   case logs its lane count (``plan_mamba``) and copy path, and every lane
   count and both paths must run;
   2b. the four TinyBio kernels with a leading batch axis, for B = 1, 2,
   4, 8: ``fir`` (f32 and Q15 int16), ``delineate`` (with extrema at every
   row's edges), ``power_spectrum`` on (B, 128, 512) and ``svm`` on
   (B, 128, 36) (the bias a card tensor and a float) must give each row
   the bits of its single call, ``fir`` and ``delineate`` the plain
   version's bits on the whole batch, the ``torch.func.vmap`` of each
   wrapper the batched call's bits, and a ``torch.profiler`` trace one
   device kernel per batched call;
3. kernel timings at the main paths' shapes: device time per call from
   CUDA events around replays of a CUDA graph of many warm calls, for the
   kernel, its plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``); the eager cost per call, host
   dispatch included, is logged beside them.  ``bound_ms`` is the least time
   the card could take, from the bytes and operations of this run's inputs.
   ``power_spectrum`` is timed beside ``fft``, against the parent's four
   launches (``fft``, then ``re*re + im*im``), and an empty kernel
   (``csrc/launch_floor.cu``) gives the card's launch floor; a
   ``torch.profiler`` trace must show one device kernel per call of
   ``svm_decision``, ``power_spectrum``, ``fir`` and ``delineate``.  The
   plan ``fir`` took is logged, and the bound of its bits (an FMUL and an FADD per tap and output, no fused
   multiply-add) beside the FMA bound, with Q15 int16 timed at the same
   shape.  Each batched TinyBio call at B = 4 is timed beside four single
   calls and the launch floor.
   The GeMM is also timed at 2048³, where launch latency no longer hides
   the kernel's own rate; flash attention at qwen's prefill shape and at
   B = 1, S = T = 4096, against ``F.scaled_dot_product_attention``;
   ``rwkv6_scan`` at rwkv6-3b's prefill (B = 4, T = 256) and decode-step
   (T = 1) shapes, with B = 1, T = 4096 beside them; ``decode_attention``
   at qwen's decode shape and at T = 32768, against SDPA with one query,
   with its split plan, and at T = 32768 also with the plan sized for one
   sequence alone (the rule the batch-free plan did not take); each
   attention row logs its share of the bound;
   ``mamba_scan``'s kernel at jamba's width at B = 4, T = 256, with
   B = 2, T = 128 (phase 4c's shape) and B = 1, T = 4096 beside it, each
   with its byte bound and the special-function unit's floor (one
   exponential per step, channel and state);
4. the two main paths, each with the launch counters reset just before and
   read just after:

   * TinyBio — ``run_tinybio`` on the card for the 4T, 8T and 16T configs,
     in graph and eager mode, at the paper's full workload: each of its
     kernels must have launched once per graph offload and twice per eager
     one.  The decisions of graph and eager must agree bitwise, every
     report must equal the CPU run's field for field, and every stage's
     output must match the CPU run's within the stated tolerances;
   * GeMM (paper Fig 3) — the quickstart's 256³ int32 ``APU.offload`` for
     the 4T, 8T and 16T configs, graph and eager: ``gemm`` must have
     launched once per graph offload and twice per eager one, the outputs
     must be exact and every report equal to the CPU run's; then the
     ports of the Fig-3, transfer and multi-queue benches on the card,
     their modeled rows equal to the CPU run's;
   * 4c. the registry's ``decode_attention`` and ``mamba_scan`` families
     (the JAX package reaches these two kernels only through the registry):
     ``Program.build(cfg).create_kernel(...)`` for 4T, 8T and 16T, through a
     ``CommandQueue`` and ``APU.offload`` (graph and eager): each result
     equal to the op's, each report equal to the CPU run's, and each kernel
     launched once per enqueue and graph offload and twice per eager one;
   * 4d. the queue options with the registry's ``gemm`` (256³ int32) and
     TinyBio families at the paper's size (65,536 samples, 128 taps, FFT
     128 × 512, SVM 128 queries × 256 × 36), on 16T: the default queue, an
     unprofiled blocking one (``profile=False, blocking=True``) and a
     windowed one (``max_events=2``), the latter two with blocking
     transfers.  Outputs bit-equal to the default queue's, blocking events
     ``done`` on return, the unprofiled ``finish()`` releasing every event,
     the windowed totals ``==`` the full-history queue's, one launch an
     enqueue, ``dispatch_s > 0`` on every kernel event (also once released),
     ``flush()`` returning; ``create_buffer`` aliasing a card tensor
     (``copy=False``, ``use_host_ptr=True``), copying on ``copy=True`` and
     refusing a CPU tensor.  Then ``bench_dispatch``'s eager-sync, async
     and graph microseconds a kernel on the card, and ``bench_static``'s
     rows;

5. the LM serving path (qwen2.5-3b at full width and depth, bf16, random
   weights from ``init_params(seed=0)`` on the card): ``greedy_generate``
   answers 4 requests of 256-token prompts with 16 new tokens each, with
   the launch counters reset just before and read just after:
   ``flash_attention`` must launch once per layer per prefill and never in
   a decode step, the tokens must repeat on a second run, and a
   ``torch.profiler`` trace of one prefill must show the hand-written
   kernel and no library attention kernel.  Prefill and per-step decode
   walls, tokens/s, the device's busy and idle share of one prefill and one
   decode step, and peak device memory are printed;
   5b. the card against the CPU: a 2-layer cut of qwen2.5-3b at full width
   in float32, the same parameters on both, prefill of 2 × 64 tokens and
   4 decode steps teacher-forced from the CPU's tokens: logits within the
   stated tolerances, greedy tokens equal;

6. the rwkv serving path (rwkv6-3b at full width and depth: 32 layers,
   d_model 2560, 40 heads of 64, bf16, random weights from seed 0 on the
   card): ``greedy_generate`` answers 4 requests of 256-token prompts with
   16 new tokens each; ``rwkv6_scan`` must launch once per layer in the
   prefill and in every decode step, and no other kernel of ours; the
   tokens must repeat on a second run.  Walls, tokens/s, the device's idle
   share of one prefill and one decode step, ``rwkv6_kernel``'s device time
   in the prefill (``rwkv6_step_kernel`` in a decode step), and peak memory
   are printed;
   6b. the card against the CPU: a 2-layer cut of rwkv6-3b at full width in
   float32, as in 5b;

7. TinyBio served on the card at full size: ``Server`` over a 16T and an
   8T ``QueueWorker``, ``bucket_sizes=(65536,)``, ``max_batch=4``, warmed
   up, then 16 requests (``synth_signal``, seeds 0..15) with the launch
   counters reset just before and read just after (one launch a stage a
   micro-batch).  Every request's decisions must equal ``APU.offload`` of
   it alone on the card bit for bit; the cache must miss exactly once per
   lane, at warmup; on a virtual clock every modeled ``ServeReport`` field
   must equal the CPU port's run (``==``); a traced twin must give complete
   request trees, a valid Chrome trace and the same bits and report; a
   ``FaultPlan`` run (a lane blacked out, seeded failures) must retry and
   give the same bits.  The serving wall, requests/s, the device's idle
   share of one warm micro-batch and a warm ``APU.offload`` graph wall are
   printed side by side;

   7b. ``bench_overload`` and ``bench_power`` on the card: every modeled row
   ``==`` the same bench's CPU run, their gates and bit-identity checks
   holding on the card; each bench's wall on the card and on the CPU;

8. one ``{"kernels": [...]}`` line for all nine kernels (launches: phase
   4's main paths, plus phase 4d's and phase 7's for the GeMM and TinyBio
   kernels), then, last, ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The card's published peaks (H100 SXM data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# INT32 multiply-adds per clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0), times the SMs
# and the card's max SM clock from nvidia-smi give the int32 peak.
INT32_MAC_PER_CLK_PER_SM = 64
# FP32 adds or multiplies per clock per SM, from the same table.
FP32_LANES_PER_CLK_PER_SM = 128
# Exponentials (MUFU.EX2) per clock per SM, from the same table.
SFU_PER_CLK_PER_SM = 16

TINYBIO_KERNELS = {
    "fir": ("src/repro_torch/csrc/fir.cu", "src/repro/kernels/fir/fir.py:27"),
    "delineate": ("src/repro_torch/csrc/delineate.cu",
                  "src/repro/kernels/delineate/delineate.py:22"),
    "stockham_fft": ("src/repro_torch/csrc/stockham_fft.cu",
                     "src/repro/kernels/stockham_fft/stockham_fft.py:29"),
    "svm": ("src/repro_torch/csrc/svm.cu", "src/repro/kernels/svm/svm.py:22"),
}
GEMM_KERNELS = {
    "gemm": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm/gemm.py:27"),
}
LM_KERNELS = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:29"),
}
REGISTRY_KERNELS = {
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/decode_attention.py:29"),
    "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan/mamba_scan.py:26"),
}
RWKV_KERNELS = {
    "rwkv6_scan": ("src/repro_torch/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:34"),
}
KERNELS = {**TINYBIO_KERNELS, **GEMM_KERNELS, **LM_KERNELS, **REGISTRY_KERNELS,
           **RWKV_KERNELS}
# the LM path's geometry (qwen2.5-3b) and its serving run
LM_ARCH = "qwen2.5-3b"
LM_BATCH, LM_PROMPT, LM_NEW, LM_MAX_LEN = 4, 256, 16, 512
# the rwkv serving path (rwkv6-3b) and its run; jamba gives mamba_scan
# its width (d_inner, d_state)
RWKV_ARCH = "rwkv6-3b"
RWKV_BATCH, RWKV_PROMPT, RWKV_NEW, RWKV_MAX_LEN = 4, 256, 16, 512
MAMBA_ARCH = "jamba-1.5-large-398b"
# the hand-written flash-attention kernels (csrc/flash_attention.cu), and
# names of library attention kernels the LM path must not run
FLASH_KERNEL_NAMES = ("flash_kernel<", "flash_wgmma_kernel<")
LIBRARY_ATTENTION = ("fmha", "sdpa", "cudnn", "attention", "pytorch_flash",
                     "flash_fwd")


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float, ops_per_s: float = PEAK_FP32_FLOPS):
    """(least ms, what bounds it) for moving ``nbytes`` and doing ``flops``
    operations at ``ops_per_s``."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def fir_bits_bound(n: int, taps: int, sms: int, max_sm_mhz: float) -> float:
    """Least ms of an FIR whose bits forbid the fused multiply-add: an FMUL
    and an FADD per tap and output at 128 FP32 lanes a clock per SM (the
    Q15 path's one IMAD at 64 a clock takes the same time)."""
    return 2.0 * n * taps / (FP32_LANES_PER_CLK_PER_SM * sms * max_sm_mhz * 1e6) * 1e3


def nvidia_smi(query: str) -> str:
    smi = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def device_profile(torch, fn):
    """Run ``fn`` once under ``torch.profiler``: (host wall s, device busy
    s, device microseconds by kernel name).  Only device-side events
    (kernels and copies) count — a CPU op's row would count its kernels'
    time a second time — and busy time is the union of their intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    per_kernel = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        t0_us, t1_us = ev.time_range.start, ev.time_range.end
        spans.append((t0_us, t1_us))
        per_kernel[ev.name] = per_kernel.get(ev.name, 0.0) + (t1_us - t0_us)
    busy_us, reach = 0.0, -math.inf
    for t0_us, t1_us in sorted(spans):
        busy_us += max(0.0, t1_us - max(t0_us, reach))
        reach = max(reach, t1_us)
    return wall_s, busy_us * 1e-6, per_kernel


def profile_line(what: str, wall_s: float, busy_s: float, per_kernel) -> str:
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    idle = "not measured" if busy_s == 0 else f"{1 - busy_s / wall_s:.4f}"
    return (f"{what}: wall {wall_s * 1e3:.3f} ms, device busy "
            f"{busy_s * 1e3:.4f} ms, idle share {idle}; device us by kernel: "
            + "; ".join(f"{k[:60]} {v:.1f}" for k, v in top))


def device_kernels(torch, fn, calls: int):
    """Names of the device kernels that ``calls`` calls of ``fn`` ran, from
    a ``torch.profiler`` trace (copies and memsets included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]


def launch_floor(common):
    """``floor(blocks, threads)`` launches ``csrc/launch_floor.cu``'s empty
    kernel on the current stream (no counter: no path of the port runs
    it)."""
    import ctypes
    import torch
    fn = common.kernel_library().repro_launch_floor
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def floor(blocks: int, threads: int) -> None:
        dev = torch.cuda.current_device()
        err = fn(blocks, threads, dev, torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"the empty kernel failed to launch: CUDA error {err}")
    return floor


def call_ms(torch, fn, iters: int, warmup: int = 10) -> float:
    """Mean milliseconds per eager call over ``iters`` back-to-back calls,
    host dispatch included (CUDA events around the loop)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, per_graph: int, replays: int = 20) -> float:
    """Mean device milliseconds per call: ``per_graph`` calls captured into
    one CUDA graph, replayed ``replays`` times between CUDA events, so the
    host's dispatch cost drops out and only the launches' device time (and
    the small gaps between graph nodes) remains."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (per_graph * replays)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    try:
        from benchmarks_torch import (bench_dispatch, bench_gemm_overhead,
                                      bench_multiqueue, bench_overload,
                                      bench_power, bench_static,
                                      bench_transfer)
        from repro_torch.configs import get as get_arch
        from repro_torch.apps import tinybio
        from repro_torch.core import (APU, EGPU_4T, EGPU_8T, EGPU_16T,
                                      CommandQueue, Context, Device, Program,
                                      Stage, optimal_ndrange)
        from repro_torch.kernels import common
        from repro_torch.kernels.gemm.gemm import plan_split_k, tiles_from_knobs
        from repro_torch.kernels.gemm.ops import gemm
        from repro_torch.kernels.gemm.ref import gemm_plain
        from repro_torch.kernels.delineate.ops import delineate
        from repro_torch.kernels.delineate.ref import delineate_ref
        from repro_torch.kernels.fir.fir import MAX_THREADS as FIR_MAX_THREADS
        from repro_torch.kernels.fir.fir import ROWS as FIR_ROWS
        from repro_torch.kernels.fir.fir import FirPlan, launch_fir, plan_fir
        from repro_torch.kernels.fir.ops import fir
        from repro_torch.kernels.fir.ref import fir_ref
        from repro_torch.kernels.stockham_fft.ops import fft, power_spectrum
        from repro_torch.kernels.stockham_fft.ref import stockham_fft_ref
        from repro_torch.kernels.svm.ops import svm_decision
        from repro_torch.kernels.svm.svm import plan_svm
        from repro_torch.kernels.svm.ref import svm_decision_ref
        from repro_torch.kernels.flash_attention.ops import flash_attention
        from repro_torch.kernels.flash_attention import (
            flash_attention as fa_module)
        from repro_torch.kernels.decode_attention import (
            decode_attention as da_module)
        from repro_torch.kernels.decode_attention.decode_attention import (
            plan_decode_splits)
        from repro_torch.kernels.flash_attention.ref import flash_attention_plain
        from repro_torch.kernels.decode_attention.ops import (combine_partials,
                                                              decode_attention)
        from repro_torch.kernels.decode_attention.ref import (
            decode_attention_partial_ref, decode_attention_ref)
        from repro_torch.kernels.mamba_scan.mamba_scan import (plan_mamba,
                                                               rows_16b)
        from repro_torch.kernels.mamba_scan.ops import mamba_scan, selective_scan
        from repro_torch.kernels.mamba_scan.ref import mamba_scan_plain
        from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
        from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_plain
        from repro_torch.models.params import init_params, map_tree
        from repro_torch.models.transformer import (Transformer, decode_step,
                                                    model_spec, prefill)
        from repro_torch.train.serve import (greedy_generate, make_decode_step,
                                             make_prefill_step)
    except ImportError as e:
        print(f"chip_smoke: cannot import the port from {ROOT / 'src'}: {e}",
              file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    # Full fp32 everywhere: the plain SVM's and GeMM's matmul and the conv1d
    # yardstick would otherwise be allowed TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. card and build --------------------------------------------------
    card = nvidia_smi("name,power.limit")
    log(card)
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    peak_int32_macs = INT32_MAC_PER_CLK_PER_SM * n_sms * max_sm_mhz * 1e6
    log(f"int32 multiply-add peak: {INT32_MAC_PER_CLK_PER_SM} per clock per "
        f"SM x {n_sms} SMs x {max_sm_mhz:.0f} MHz (max SM clock) = "
        f"{peak_int32_macs / 1e12:.3f} T MAC/s")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    info = common.build_kernels()
    common.kernel_library()
    log(f"phase 1: kernels {'built' if info['built'] else 'found'} at "
        f"{info['path'].relative_to(ROOT)} in {info['seconds']:.1f} s")

    # -- 2. each kernel against its plain version, on the card --------------
    def launched(name, fn):
        before = common.LAUNCHES[name]
        out = fn()
        torch.cuda.synchronize()
        check(common.LAUNCHES[name] == before + 1,
              f"{name}: the launch counter did not move by one")
        return out

    def err(a, b):
        return float((a.double() - b.double()).abs().max().item()) if a.numel() else 0.0

    stages, inputs = tinybio.tinybio_stages(EGPU_16T, 0, dev)
    x, h = inputs[0], stages[0].consts[0]
    sv_main, alpha_main = stages[3].consts[0], stages[3].consts[1]
    rng = np.random.default_rng(0)
    max_err = {}

    # fir: the same sums in the same order and roundings as the plain
    # version (float: separate __fmul_rn / __fadd_rn; integer: uint32
    # wraparound, then >> 15), so every output must equal it bit for bit
    def same_bits(a, b_):
        return a.dtype == b_.dtype and a.shape == b_.shape and torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b_.view(torch.int32) if b_.dtype == torch.float32 else b_)

    def int_tensor(lo, hi, size, dtype):
        return torch.from_numpy(rng.integers(lo, hi, size).astype(dtype)).to(dev)

    y = launched("fir", lambda: fir(x, h))
    max_err["fir"] = err(y, fir_ref(x, h))
    check(same_bits(y, fir_ref(x, h)), f"fir f32 not bit-equal (max err {max_err['fir']})")
    xr = torch.from_numpy(rng.standard_normal(1000).astype(np.float32)).to(dev)
    hr = torch.from_numpy(rng.standard_normal(33).astype(np.float32) / 33).to(dev)
    check(same_bits(launched("fir", lambda: fir(xr, hr)), fir_ref(xr, hr)),
          "fir f32 ragged")
    xi = int_tensor(-2 ** 15, 2 ** 15, 65_536, np.int16)
    hi = int_tensor(-2 ** 15, 2 ** 15, 128, np.int16)
    check(torch.equal(launched("fir", lambda: fir(xi, hi)), fir_ref(xi, hi)),
          "fir Q15 int16 not exact")
    check(torch.equal(launched("fir", lambda: fir(xi[:1001], hi[:17])),
                      fir_ref(xi[:1001], hi[:17])), "fir Q15 ragged not exact")
    # int32 products of ~2^30 x 2^30 that wrap; int32 taps with an int16
    # signal; views off 16-byte alignment (the element-by-element loads);
    # taps from 1 to 5000 (5000: ten chunks of the kernel's shared memory)
    xw_ = int_tensor(2 ** 29, 2 ** 31 - 1, 3001, np.int32)
    hw_ = int_tensor(2 ** 29, 2 ** 31 - 1, 40, np.int32)
    fir_cases = {"int32 wraparound": (xw_, hw_),
                 "int16 signal, int32 taps": (xi[:5003], hi[:77].to(torch.int32)),
                 "f32 view at +4 bytes": (x[1:20_001], h),
                 "int16 view at +2 bytes": (xi[1:9_001], hi)}
    for taps_ in (1, 3, 17, 33, 127, 128, 129, 4096, 5000):
        fir_cases[f"f32 taps {taps_}"] = (
            xr[:997] if taps_ < 100 else x[:10_007],
            torch.from_numpy(rng.standard_normal(taps_).astype(np.float32) / taps_).to(dev))
        fir_cases[f"Q15 taps {taps_}"] = (xi[:10_007], int_tensor(-2 ** 15, 2 ** 15, taps_, np.int16))
    for what, (xc_, hc_) in fir_cases.items():
        check(same_bits(launched("fir", lambda: fir(xc_, hc_)), fir_ref(xc_, hc_)),
              f"fir {what} not bit-equal to the plain version")
    # every outputs-a-thread count and block sizes from 1 to 256 threads
    # (the most the kernel takes) give the same bits (the plan changes none)
    fir_plans = 0
    for xc_, hc_ in ((x, h), (xi[:1001], hi[:17]), fir_cases["f32 taps 5000"]):
        want_ = fir_ref(xc_, hc_)
        for rows_ in FIR_ROWS:
            for threads_ in (1, 125, FIR_MAX_THREADS):
                plan_ = FirPlan(rows_, threads_)
                out_ = torch.empty_like(xc_)
                launched("fir", lambda: launch_fir(xc_, hc_, out_, plan_))
                check(same_bits(out_, want_),
                      f"fir with plan {plan_} not bit-equal to the plain version")
                fir_plans += 1
    log(f"phase 2: fir ok (bit-equal to the plain version: TinyBio f32 and Q15, "
        f"{len(fir_cases)} more cases with taps 1 .. 5000, int32 wraparound and "
        f"unaligned views, and {fir_plans} forced plans; TinyBio's plan "
        f"{tuple(plan_fir(x.numel(), h.numel(), n_sms))})")

    # delineate: exact, on the FIR output and on ragged, short and unaligned
    # signals of each dtype, with the thresholds cast to x's dtype
    flags = launched("delineate", lambda: delineate(y, 0))
    check(torch.equal(flags, delineate_ref(y, 0)), "delineate not exact")
    max_err["delineate"] = 0.0
    xd = (xi[:1001] // 512).contiguous()
    xs32 = (xw_ // (2 ** 26)).contiguous()
    dl_cases = {"int16 ragged": (xd, 3), "f32 ragged": (xr, 0.25),
                "int32": (xs32, 3), "int16 thr 2.7": (xd, 2.7),
                "f32 view at +4 bytes": (y[1:60_001], 0),
                "int16 view at +2 bytes": (xd[1:], 3)}
    for n_ in (1, 2, 3, 7, 9, 33):
        dl_cases[f"f32 n={n_}"] = (xr[:n_], 0.25)
        dl_cases[f"int16 n={n_}"] = (xd[:n_], 3)
    for what, (xc_, thr_) in dl_cases.items():
        check(torch.equal(launched("delineate", lambda: delineate(xc_, thr_)),
                          delineate_ref(xc_, thr_)), f"delineate {what} not exact")
    log(f"phase 2: delineate ok (exact, {int((flags != 0).sum())} extrema; "
        f"{len(dl_cases)} more cases)")

    # fft on TinyBio's 128 windows of 512: the same butterflies and twiddle
    # angles as the plain version, cosf/sinf from the same CUDA math library;
    # tolerance 1e-6 of the largest |X|
    w = y[: 128 * 512].reshape(128, 512)
    re, im = launched("stockham_fft", lambda: fft(w))
    pre, pim = stockham_fft_ref(w, torch.zeros_like(w))
    scale = float(torch.sqrt(pre * pre + pim * pim).max())
    max_err["stockham_fft"] = max(err(re, pre), err(im, pim))
    check(max_err["stockham_fft"] <= 1e-6 * scale,
          f"fft error {max_err['stockham_fft']} vs scale {scale}")
    wr = torch.from_numpy(rng.standard_normal((3, 2048)).astype(np.float32)).to(dev)
    wi = torch.from_numpy(rng.standard_normal((3, 2048)).astype(np.float32)).to(dev)
    gre, gim = launched("stockham_fft", lambda: fft(wr, wi))
    rre, rim = stockham_fft_ref(wr, wi)
    ref_np = np.fft.fft(wr.cpu().numpy() + 1j * wi.cpu().numpy())
    check(max(err(gre, rre), err(gim, rim)) <= 1e-6 * float(np.abs(ref_np).max()),
          "fft (3, 2048) vs plain")
    check(np.allclose(gre.cpu().numpy() + 1j * gim.cpu().numpy(), ref_np,
                      rtol=1e-4, atol=1e-4 * 2048), "fft (3, 2048) vs numpy")
    # every n the kernel takes, 1 .. 8192 (batch 3, complex input), on the
    # 16-byte copy path and, at n = 512, on the 4-byte one (a base 4 bytes
    # off 16-byte alignment): the same tolerance
    fft_err = {}
    for s_ in range(14):
        n_ = 1 << s_
        for offset in (0, 1) if n_ == 512 else (0,):
            flat = torch.from_numpy(rng.standard_normal(2 * 3 * n_ + offset).astype(
                np.float32)).to(dev)
            pr_, pi_ = (flat[offset + i * 3 * n_:offset + (i + 1) * 3 * n_].view(3, n_)
                        for i in range(2))
            gre, gim = launched("stockham_fft", lambda: fft(pr_, pi_))
            rre, rim = stockham_fft_ref(pr_, pi_)
            mag = float(torch.sqrt(rre * rre + rim * rim).max())
            fft_err[n_, offset] = max(err(gre, rre), err(gim, rim)) / mag
            check(fft_err[n_, offset] <= 1e-6,
                  f"fft n={n_} (offset {offset}) error {fft_err[n_, offset]} of max |X|")
    # power_spectrum is the same launch with |X|^2 in its last pass: the bits
    # of re*re + im*im over the card's own fft, for TinyBio's windows, one
    # 1-D signal and n = 8192
    for sig in (w, w[5], flat[:3 * 8192].view(3, 8192)):
        ps = launched("stockham_fft", lambda: power_spectrum(sig))
        fre, fim = fft(sig)
        check(torch.equal(ps.view(torch.int32), (fre * fre + fim * fim).view(torch.int32)),
              f"power_spectrum {tuple(sig.shape)} differs from re*re + im*im of fft")
    log(f"phase 2: stockham_fft ok (max abs err {max_err['stockham_fft']:.3g}, "
        f"max |X| {scale:.4g}; n = 1 .. 8192, error / max |X| at most "
        f"{max(fft_err.values()):.3g}; power_spectrum bit-equal to re*re + im*im "
        f"of fft)")

    # svm at q=128, m=256, d=36, with support vectors drawn near the queries
    # so the RBF values are not all 0; fp32 dots and sums in another order
    # than the plain version's matmul: rtol 1e-4, atol 1e-5
    feats = tinybio._feature_kernel(512, 128)(y, flags)
    idx = torch.from_numpy(rng.integers(0, 128, 256)).to(dev)
    sv_near = (feats[idx] + 0.1 * torch.from_numpy(
        rng.standard_normal((256, 36)).astype(np.float32)).to(dev)).contiguous()
    b = torch.tensor(0.1, device=dev)
    got = launched("svm", lambda: svm_decision(feats, sv_near, alpha_main, b, 0.5))
    want = svm_decision_ref(feats, sv_near, alpha_main, b, 0.5)
    check(float((want - b).abs().max()) > 1e-3, "svm check has no RBF signal")
    max_err["svm"] = err(got, want)
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-5),
          f"svm rbf error {max_err['svm']}")
    check(torch.allclose(launched("svm", lambda: svm_decision(feats, sv_near, alpha_main, b)),
                         svm_decision_ref(feats, sv_near, alpha_main, b),
                         rtol=1e-4, atol=1e-5), "svm linear")
    xq = torch.from_numpy(rng.uniform(-1, 1, (13, 7)).astype(np.float32)).to(dev)
    svq = torch.from_numpy(rng.uniform(-1, 1, (300, 7)).astype(np.float32)).to(dev)
    aq = torch.from_numpy(rng.standard_normal(300).astype(np.float32) / 300).to(dev)
    check(torch.allclose(launched("svm", lambda: svm_decision(xq, svq, aq, 0.0, 0.5)),
                         svm_decision_ref(xq, svq, aq, 0.0, 0.5),
                         rtol=1e-4, atol=1e-5), "svm ragged")
    # the bias inside the kernel: svm(b) has the bits of svm(0) + b, with b a
    # 0-d tensor on the card, a float and a 0-d CPU tensor
    s0 = launched("svm", lambda: svm_decision(feats, sv_near, alpha_main, 0.0, 0.5))
    for what, bb in (("card tensor", b), ("float", 0.1),
                     ("CPU tensor", torch.tensor(0.1))):
        got_b = launched("svm", lambda: svm_decision(feats, sv_near, alpha_main, bb, 0.5))
        check(torch.equal(got_b.view(torch.int32), (s0 + bb).view(torch.int32)),
              f"svm with the bias as a {what} differs from svm(0) + b")
    # other shapes: d = 1024, q that give 4 and 8 queries a block (1024,
    # 1100; plan_svm), a ragged d = 7 on the 4-byte load path; the same
    # tolerance
    svm_plans = {}
    for q_, m_, d_ in ((64, 512, 1024), (1024, 1024, 36), (1100, 1024, 36),
                       (13, 300, 7)):
        xq = torch.from_numpy(rng.uniform(-1, 1, (q_, d_)).astype(np.float32)).to(dev)
        spread = 0.2 if d_ < 100 else 0.01
        svq = (xq[torch.from_numpy(rng.integers(0, q_, m_)).to(dev)] + spread
               * torch.from_numpy(rng.standard_normal((m_, d_)).astype(np.float32)).to(dev))
        aq = torch.from_numpy(rng.standard_normal(m_).astype(np.float32) / m_).to(dev)
        want = svm_decision_ref(xq, svq, aq, b, 0.5)
        check(float((want - b).abs().max()) > 1e-3, f"svm {q_, m_, d_} has no RBF signal")
        check(torch.allclose(launched("svm", lambda: svm_decision(xq, svq, aq, b, 0.5)),
                             want, rtol=1e-4, atol=1e-5), f"svm at {q_, m_, d_}")
        svm_plans[q_, m_, d_] = plan_svm(q_, n_sms)
    check({p_.queries for p_ in svm_plans.values()} >= {1, 4, 8},
          f"svm: phase 2 missed a queries-per-block count: {svm_plans}")
    log(f"phase 2: svm ok (max abs err {max_err['svm']:.3g}; svm(b) bit-equal to "
        f"svm(0) + b for b on the card, a float and a CPU tensor; plans "
        + ", ".join(f"{k_}: {p_.queries} queries a block" for k_, p_ in svm_plans.items())
        + ")")

    # gemm, each case through the tilings of all three configs, which must
    # give identical bits (compared as int32 words, so -0.0 != +0.0).
    # int32: exact against the plain version (uint32 wraparound on both
    # sides).  f32: one in-order fused multiply-add chain per output against
    # the plain version's matmul (TF32 off): rtol = atol = 2e-4, as
    # tests/test_kernels.py states for the JAX kernel at these shapes.
    configs = (EGPU_4T, EGPU_8T, EGPU_16T)
    knobs = {cfg.name: cfg.cuda_knobs() for cfg in configs}

    def gemm_case(a, b, what):
        outs = [launched("gemm", lambda k=k: gemm(a, b, k)) for k in knobs.values()]
        bits = [o.view(torch.int32) for o in outs]
        check(all(torch.equal(x, bits[0]) for x in bits),
              f"gemm {what}: the config tilings' outputs differ")
        want = gemm_plain(a, b)
        if a.dtype == torch.int32:
            check(torch.equal(outs[0], want), f"gemm {what}: not exact")
        else:
            check(torch.allclose(outs[0], want, rtol=2e-4, atol=2e-4),
                  f"gemm {what}: error {err(outs[0], want)}")
        return err(outs[0], want)

    def ints(lo, hi, *shape):
        return torch.from_numpy(
            rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)).to(dev)

    def floats(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    # the int32 cases where the tiling leaves the card idle split K across
    # blocks (atomic uint32 sums, exact in any order); each case logs the
    # plan of every tiling, and some must split
    split_plans = {}

    def log_splits(what, m, k, n):
        split_plans[what] = [tuple(plan_split_k(m, n, k, tiles_from_knobs(kn),
                                                n_sms, torch.int32))
                             for kn in knobs.values()]

    gemm_err = {}
    for size in (32, 64, 128, 256):
        log_splits(f"int32 {size}", size, size, size)
        gemm_err[f"int32 {size}"] = gemm_case(
            ints(-64, 64, size, size), ints(-64, 64, size, size), f"int32 {size}")
    log_splits("int32 257x129x65", 257, 129, 65)
    log_splits("int32 wraparound 96x200x80", 96, 200, 80)
    gemm_err["int32 257x129x65"] = gemm_case(
        ints(-64, 64, 257, 129), ints(-64, 64, 129, 65), "int32 ragged")
    aw, bw_ = ints(2 ** 20 - 64, 2 ** 20 + 64, 96, 200), ints(-2 ** 20 - 64, -2 ** 20 + 64, 200, 80)
    exact = aw.cpu().numpy().astype(np.int64) @ bw_.cpu().numpy().astype(np.int64)
    check(bool((np.abs(exact) >= 2 ** 31).all()), "gemm wraparound case does not wrap")
    gemm_err["int32 wraparound"] = gemm_case(aw, bw_, "int32 wraparound")
    check(np.array_equal(gemm(aw, bw_).cpu().numpy(),
                         ((exact + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)),
          "gemm wraparound differs from the int64 product modulo 2^32")
    for m, k, n in ((8, 8, 8), (100, 70, 50), (128, 128, 128), (257, 129, 65),
                    (512, 256, 384)):
        gemm_err[f"f32 {m}x{k}x{n}"] = gemm_case(floats(m, k), floats(k, n),
                                                 f"f32 {m}x{k}x{n}")
    max_err["gemm"] = max(v for key, v in gemm_err.items() if key.startswith("int32"))
    check(any(p[0] > 1 for plans in split_plans.values() for p in plans),
          f"gemm: no int32 case split K: {split_plans}")
    log("phase 2: gemm ok (int32 exact incl. ragged and wraparound; 4T/8T/16T "
        "tilings bit-identical; int32 (splits, k-tiles a split) for 4T/8T/16T: "
        + ", ".join(f"{k} {v}" for k, v in split_plans.items())
        + "; max abs err vs plain: "
        + ", ".join(f"{k} {v:.3g}" for k, v in gemm_err.items()) + ")")

    # flash_attention against its plain version (the JAX package's blocked
    # online softmax, what JAX runs off a TPU), at the LM path's geometry.
    # Both compute in f32 and sum in another order: float32 within 1e-5 of
    # max |out|; bfloat16 outputs, which both round from f32, within one
    # bf16 ulp of each value plus the same 1e-5 of max |out|.  v is a
    # strided (B, T, KVH, D) -> (B, KVH, T, D) view, as the model passes it.
    def qkv(b, h, kvh, s, t, dk, dv, dtype):
        def arr(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
        return (arr(b, h, s, dk), arr(b, kvh, t, dk),
                arr(b, t, kvh, dv).transpose(1, 2))

    def flash_case(what, dims, dtype, **kw):
        q, k, v = qkv(*dims, dtype)
        got = launched("flash_attention", lambda: flash_attention(q, k, v, **kw))
        want = flash_attention_plain(q, k, v, **kw)
        check(got.shape == want.shape and got.dtype == dtype,
              f"flash_attention {what}: shape or dtype")
        g, w = got.float(), want.float()
        tol = 1e-5 * float(w.abs().max())
        if dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * torch.maximum(g.abs(), w.abs())
        check(bool(((g - w).abs() <= tol).all()) and bool(torch.isfinite(g).all()),
              f"flash_attention {what}: error {err(got, want)}")
        return err(got, want)

    bf16 = torch.bfloat16
    lm_cfg = get_arch(LM_ARCH)
    lm_h, lm_kvh, lm_d = lm_cfg.n_heads, lm_cfg.n_kv_heads, lm_cfg.head_dim
    fa_err = {
        "prefill B=4 S=T=256 bf16": flash_case(
            "prefill", (LM_BATCH, lm_h, lm_kvh, LM_PROMPT, LM_PROMPT, lm_d, lm_d), bf16),
        "ragged S=T=300 bf16": flash_case(
            "ragged", (2, lm_h, lm_kvh, 300, 300, lm_d, lm_d), bf16),
        "suffix S=64 T=512 q_offset=448 bf16": flash_case(
            "suffix", (2, lm_h, lm_kvh, 64, 512, lm_d, lm_d), bf16, q_offset=448),
        "non-causal S=256 T=512 bf16": flash_case(
            "non-causal", (2, lm_h, lm_kvh, 256, 512, lm_d, lm_d), bf16, causal=False),
        "prefill geometry f32": flash_case(
            "f32", (2, lm_h, lm_kvh, LM_PROMPT, LM_PROMPT, lm_d, lm_d), torch.float32),
        "Dk=96 Dv=64 f32": flash_case(
            "Dk=96 Dv=64", (2, 8, 4, 200, 200, 96, 64), torch.float32),
        "Dk=Dv=32 S=T=77 f32": flash_case(
            "Dk=Dv=32", (1, 4, 4, 77, 77, 32, 32), torch.float32),
        # rows 0..15 see no key: the kernel's final pass gives them what
        # the plain version's blocking gives them
        "no-key rows S=64 T=512 q_offset=-16 bf16": flash_case(
            "no-key rows", (2, lm_h, lm_kvh, 64, 512, lm_d, lm_d), bf16,
            q_offset=-16),
        "no-key rows S=64 T=512 q_offset=-16 f32": flash_case(
            "no-key rows f32", (2, lm_h, lm_kvh, 64, 512, lm_d, lm_d),
            torch.float32, q_offset=-16),
        "long B=1 S=T=4096 bf16": flash_case(
            "long", (1, lm_h, lm_kvh, 4096, 4096, lm_d, lm_d), bf16),
        "Dk=Dv=64 S=T=333 bf16": flash_case(
            "Dk=Dv=64", (2, 8, 2, 333, 333, 64, 64), bf16),
        "Dk=96 Dv=64 bf16": flash_case(
            "Dk=96 Dv=64 bf16", (2, 8, 4, 200, 200, 96, 64), bf16),
    }
    # a bf16 view that no tensor map describes (rows D + 1 elements apart):
    # the wrapper copies it contiguous, then launches the same kernel
    q, _, v = qkv(2, lm_h, lm_kvh, 300, 300, lm_d, lm_d, bf16)
    k = torch.from_numpy(rng.standard_normal((2, lm_kvh, 300, lm_d + 1)).astype(
        np.float32)).to(dev, bf16)[..., :lm_d]
    copies = fa_module.CONTIGUOUS_COPIES
    got = launched("flash_attention", lambda: flash_attention(q, k, v))
    check(fa_module.CONTIGUOUS_COPIES == copies + 1,
          "flash_attention: a view no tensor map describes was not copied once")
    want = flash_attention_plain(q, k, v)
    tol = 1e-5 * float(want.float().abs().max()) + 2.0 ** -7 * torch.maximum(
        got.float().abs(), want.float().abs())
    check(bool(((got.float() - want.float()).abs() <= tol).all()),
          f"flash_attention copied view: error {err(got, want)}")
    fa_err["row stride D+1 (copied) bf16"] = err(got, want)
    max_err["flash_attention"] = fa_err["prefill B=4 S=T=256 bf16"]
    log("phase 2: flash_attention ok (max abs err vs plain: "
        + ", ".join(f"{k} {v:.3g}" for k, v in fa_err.items()) + ")")

    # The three scans and decode attention against their plain versions.
    # Both sides compute in f32 and sum in another order (the rwkv kernel
    # takes the chunked form with decays as running products and its
    # products in three TF32 parts on the tensor cores, its plain version
    # the chunked log-decay form; tests/test_torch_rwkv_chunked.py holds
    # the kernel's algorithm within 1e-5 of max |y| on the CPU):
    # float32 outputs and every f32 state within 1e-5 of their largest
    # magnitude; bfloat16 outputs, which both round from f32, within one
    # bf16 ulp of each value plus the same 1e-5.
    def agree(what, got, want):
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{what}: shape or dtype {tuple(got.shape)} {got.dtype} vs "
              f"{tuple(want.shape)} {want.dtype}")
        g, w = got.float(), want.float()
        tol = 1e-5 * float(w.abs().max())
        if got.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * torch.maximum(g.abs(), w.abs())
        check(bool(((g - w).abs() <= tol).all()) and bool(torch.isfinite(g).all()),
              f"{what}: error {err(got, want)}")
        return err(got, want)

    def normal(*shape, dtype=torch.float32, sc=1.0):
        return torch.from_numpy(
            (sc * rng.standard_normal(shape)).astype(np.float32)).to(dev, dtype)

    rw_cfg = get_arch(RWKV_ARCH)
    rw_h, rw_d = rw_cfg.rwkv_heads, rw_cfg.rwkv_head_dim

    def rwkv_inputs(b, h, t, d, dtype):
        """r/k/v in ``dtype``, w = exp(-exp(w_log)) in f32 with w_log around
        the spec's w0 = -1, as the model makes them; u f32."""
        r, k, v = (normal(b, h, t, d, dtype=dtype, sc=0.5) for _ in range(3))
        w = torch.exp(-torch.exp(normal(b, h, t, d, sc=0.5) - 1.0))
        return r, k, v, w, normal(h, d, sc=0.5)

    rw_err = {}
    for dtype in (bf16, torch.float32):
        for b_, h_, t_, d_ in ((RWKV_BATCH, rw_h, RWKV_PROMPT, rw_d),
                               (RWKV_BATCH, rw_h, 1, rw_d), (2, 8, 300, rw_d),
                               (2, 8, 300, 32), (2, 8, 1, 32),
                               (2, 8, 256, 32)):
            ins = rwkv_inputs(b_, h_, t_, d_, dtype)
            for state in ("absent", "zero", "random"):
                s0 = {"absent": None,
                      "zero": torch.zeros(b_, h_, d_, d_, device=dev),
                      "random": normal(b_, h_, d_, d_)}[state]
                got = launched("rwkv6_scan", lambda: rwkv6_scan(*ins, s0))
                want = rwkv6_scan_plain(*ins, s0)
                what = (f"rwkv6_scan {str(dtype)[6:]} B={b_} H={h_} T={t_} "
                        f"D={d_} state0 {state}")
                rw_err[what] = max(agree(what, got[0], want[0]),
                                   agree(what + " state", got[1], want[1]))
    # decays near 1 and near 0: w = exp(-exp(w_log)), w_log over [-6, 3]
    # (w from about 0.998 down to about 2e-9), where products of 32 decays
    # underflow; the same tolerances
    for dtype, (b_, h_, t_, d_) in ((bf16, (RWKV_BATCH, rw_h, RWKV_PROMPT, rw_d)),
                                    (torch.float32, (RWKV_BATCH, rw_h, RWKV_PROMPT, rw_d)),
                                    (bf16, (2, 8, 300, 32)),
                                    (torch.float32, (2, 8, 300, 32))):
        ins = list(rwkv_inputs(b_, h_, t_, d_, dtype))
        ins[3] = torch.exp(-torch.exp(torch.from_numpy(rng.uniform(
            -6.0, 3.0, (b_, h_, t_, d_)).astype(np.float32)).to(dev)))
        for state in ("absent", "random"):
            s0 = normal(b_, h_, d_, d_) if state == "random" else None
            got = launched("rwkv6_scan", lambda: rwkv6_scan(*ins, s0))
            want = rwkv6_scan_plain(*ins, s0)
            what = (f"rwkv6_scan extreme w {str(dtype)[6:]} B={b_} H={h_} "
                    f"T={t_} D={d_} state0 {state}")
            rw_err[what] = max(agree(what, got[0], want[0]),
                               agree(what + " state", got[1], want[1]))
    # views whose rows are not 16-byte aligned (D + 1 elements apart): the
    # kernel reads them from device memory instead of staging them
    for dtype in (bf16, torch.float32):
        wide = [normal(2, 8, 100, rw_d + 1, dtype=dtype, sc=0.5)[..., :rw_d]
                for _ in range(3)]
        wl = normal(2, 8, 100, rw_d + 1)[..., 1:]
        ins = (*wide, torch.exp(-torch.exp(wl - 1.0)), normal(8, rw_d, sc=0.5))
        got = launched("rwkv6_scan", lambda: rwkv6_scan(*ins))
        want = rwkv6_scan_plain(*ins)
        what = f"rwkv6_scan unaligned rows {str(dtype)[6:]} B=2 H=8 T=100 D={rw_d}"
        rw_err[what] = max(agree(what, got[0], want[0]),
                           agree(what + " state", got[1], want[1]))
    max_err["rwkv6_scan"] = max(v_ for k_, v_ in rw_err.items()
                                if f"H={rw_h} T={RWKV_PROMPT}" in k_
                                and "bfloat16" in k_ and "extreme" not in k_)
    log(f"phase 2: rwkv6_scan ok ({len(rw_err)} cases: bf16 and f32, state0 "
        f"absent, zero and random, T = 1, 256, 300, D = {rw_d} and 32, decays "
        f"near 1 and near 0, rows not 16-byte aligned; max abs "
        f"err vs plain {max(rw_err.values()):.3g}, at the prefill shape "
        f"{max_err['rwkv6_scan']:.3g})")

    # decode attention: qwen's decode shape in bf16, a ragged MHA T in f32,
    # T = 32768 and T = 1, the whole cache with partial=True (the combine
    # pass's unnormalized output where the plan splits T), and partial=True
    # over 4 T-shards combined against the full result.  Each case logs the
    # plan's (n_splits, keys_per_split).
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    da_plans = {}

    def decode_case(what, b_, h_, kvh_, t_, d_, dtype):
        q = normal(b_, h_, d_, dtype=dtype)
        k = normal(b_, kvh_, t_, d_, dtype=dtype)
        v = normal(b_, t_, kvh_, d_, dtype=dtype).transpose(1, 2)
        da_plans[what] = (t_,) + plan_decode_splits(kvh_, t_, n_sms)
        e = agree(f"decode_attention {what}",
                  launched("decode_attention", lambda: decode_attention(q, k, v)),
                  decode_attention_ref(q, k, v))
        whole = launched("decode_attention",
                         lambda: decode_attention(q, k, v, partial=True))
        for name, g, w_ in zip(("acc", "m", "l"), whole,
                               decode_attention_partial_ref(q, k, v)):
            agree(f"decode_attention {what} partial {name}", g, w_)
        if t_ < 4:                        # too short for 4 T-shards
            return e
        cuts = [i * t_ // 4 for i in range(5)]
        parts = [launched("decode_attention", lambda a=a, z=z: decode_attention(
            q, k[:, :, a:z], v[:, :, a:z], partial=True))
            for a, z in zip(cuts, cuts[1:])]
        for (acc, m_, l_), a, z in zip(parts, cuts, cuts[1:]):
            pa, pm, pl = decode_attention_partial_ref(q, k[:, :, a:z], v[:, :, a:z])
            for name, g, w_ in (("acc", acc, pa), ("m", m_, pm), ("l", l_, pl)):
                agree(f"decode_attention {what} partial {name}", g, w_)
        full_acc, _, full_l = decode_attention_partial_ref(q, k, v)
        merged = combine_partials(parts)[0]
        agree(f"decode_attention {what} 4 shards combined", merged, full_acc / full_l)
        return e

    da_err = {
        "qwen decode B=4 H=16 KVH=2 T=512 D=128 bf16": decode_case(
            "decode", LM_BATCH, lm_h, lm_kvh, LM_MAX_LEN, lm_d, bf16),
        "MHA B=2 H=KVH=8 T=300 D=128 f32": decode_case(
            "MHA", 2, 8, 8, 300, lm_d, torch.float32),
        "MQA B=1 H=12 KVH=1 T=77 Dk=Dv=256 f32": decode_case(
            "MQA", 1, 12, 1, 77, 256, torch.float32),
        "B=2 H=6 KVH=2 T=33 D=48 bf16": decode_case(
            "D=48", 2, 6, 2, 33, 48, bf16),
        "B=4 H=16 KVH=2 T=32768 D=128 bf16": decode_case(
            "T=32768", LM_BATCH, lm_h, lm_kvh, 32768, lm_d, bf16),
        "B=4 H=16 KVH=2 T=1 D=128 bf16": decode_case(
            "T=1", LM_BATCH, lm_h, lm_kvh, 1, lm_d, bf16),
        "MQA B=2 H=16 KVH=1 T=1000 D=128 bf16": decode_case(
            "MQA T=1000", 2, 16, 1, 1000, lm_d, bf16),
    }
    plans = da_plans.values()
    check(any(n == 1 for _, n, _ in plans) and any(n > 1 for _, n, _ in plans)
          and any(n > 1 and t_ % kps for t_, n, kps in plans),
          f"decode_attention plans miss a single split, a split T or a T that "
          f"is no multiple of keys_per_split: {da_plans}")
    # a row of a batched call has the bits of the same row called alone
    # (the split plan does not read B): B = 1 against row 2 of B = 4, the
    # output and the partial triple, in bf16 and f32
    batch_free = []
    for dtype in (bf16, torch.float32):
        for t_ in (LM_MAX_LEN, 4096, 32768):
            q = normal(LM_BATCH, lm_h, lm_d, dtype=dtype)
            k = normal(LM_BATCH, lm_kvh, t_, lm_d, dtype=dtype)
            v = normal(LM_BATCH, t_, lm_kvh, lm_d, dtype=dtype).transpose(1, 2)
            row = slice(2, 3)
            for partial in (False, True):
                whole = launched("decode_attention", lambda: decode_attention(
                    q, k, v, partial=partial))
                alone = launched("decode_attention", lambda: decode_attention(
                    q[row], k[row], v[row], partial=partial))
                pairs = zip(whole, alone) if partial else ((whole, alone),)
                check(all(torch.equal(w_[row], a_) for w_, a_ in pairs),
                      f"decode_attention T={t_} {dtype} partial={partial}: "
                      f"row 2 of B=4 differs from the row alone")
            batch_free.append(f"{str(dtype)[6:]} T={t_} "
                              f"{plan_decode_splits(lm_kvh, t_, n_sms)}")
    max_err["decode_attention"] = da_err["qwen decode B=4 H=16 KVH=2 T=512 D=128 bf16"]
    log("phase 2: decode_attention ok (B=1 bit-equal to row 2 of B=4, output "
        "and partial triple: " + ", ".join(batch_free) + "; partial over 4 "
        "T-shards combined equals the full result in every case; plans (n_splits, "
        "keys_per_split): " + ", ".join(f"{k_} {v_[1:]}" for k_, v_ in da_plans.items())
        + "; max abs err vs plain: "
        + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in da_err.items()) + ")")

    # mamba_scan at jamba's width with the dtypes the jamba block passes
    # under bf16 (x bf16; delta, a, b, c, d f32; models/mamba.py:80-90).
    # d = 0 in the bf16 cases, so y is the scan's own output (the skip term
    # is the wrapper's plain PyTorch on both sides); the f32 cases keep d.
    # Each case logs plan_mamba's lanes and whether x and delta took the
    # kernel's 16-byte copies (rows_16b) or its element-wise path; both
    # paths and every lane count must run.  "extreme decays" draws
    # delta * a over [-150, -1e-5]: decays from 0 (below 2^-127) to
    # 0.99999, which compound over all T steps.  "decays near 1" draws
    # jamba's own ranges (delta in [1e-3, 1e-2] and a = -exp(A_log) in
    # [-16, -1], as mamba's A_log = log(1 .. 16) and its delta floor make
    # them), decays of 0.85 to 0.999, over one sequence of 4096 steps in
    # f32: the chain along which the kernel's approximate exponentials
    # (ex2.approx) could build up an error.
    mb_cfg = get_arch(MAMBA_ARCH)
    mb_dm, mb_n = mb_cfg.mamba_d_inner, mb_cfg.mamba_d_state

    def log_uniform(lo, hi, *shape):
        return torch.exp(torch.from_numpy(rng.uniform(
            math.log(lo), math.log(hi), shape).astype(np.float32))).to(dev)

    def ssm_inputs(b_, t_, dm, n_, dtype, delta_dtype=torch.float32,
                   decays=None):
        x_ = normal(b_, t_, dm, dtype=dtype, sc=0.5)
        if decays == "extreme":
            delta = log_uniform(1e-3, 5.0, b_, t_, dm)
            a_ = -log_uniform(1e-2, 30.0, dm, n_)
        elif decays == "near 1":
            delta = log_uniform(1e-3, 1e-2, b_, t_, dm)
            a_ = -log_uniform(1.0, 16.0, dm, n_)
        else:
            delta = normal(b_, t_, dm, sc=0.3).abs() + 0.1
            a_ = -(normal(dm, n_).abs() + 0.1)
        return (x_, delta.to(delta_dtype), a_, normal(b_, t_, n_, sc=0.5),
                normal(b_, t_, n_, sc=0.5))

    def mamba_plain(x_, delta, a_, bm, cm, d_, s0):
        yp, hp = mamba_scan_plain(x_, delta, a_, bm, cm, s0)
        return yp + (x_.float() * d_[None, None].float()).to(yp.dtype), hp

    f32 = torch.float32
    mb_err, mb_paths, mb_share = {}, {}, {}
    for what, (b_, t_, dm, n_, dtype, d_dtype, with_d, with_s0, decays) in {
            f"jamba width B=4 T=256 Dm={mb_dm} N={mb_n} x bf16": (
                4, 256, mb_dm, mb_n, bf16, f32, False, False, None),
            "jamba width B=4 T=256 state0 x bf16": (
                4, 256, mb_dm, mb_n, bf16, f32, False, True, None),
            "jamba width B=1 T=4096 x bf16": (
                1, 4096, mb_dm, mb_n, bf16, f32, False, False, None),
            "decays near 1 jamba width B=1 T=4096 f32 state0": (
                1, 4096, mb_dm, mb_n, f32, f32, False, True, "near 1"),
            "ragged B=2 T=100 Dm=300 N=16 x bf16 state0": (
                2, 100, 300, 16, bf16, f32, False, True, None),
            "B=2 T=50 Dm=301 N=16 x and delta bf16 state0": (
                2, 50, 301, 16, bf16, bf16, False, True, None),
            "B=2 T=100 Dm=1024 N=32 x bf16 state0": (
                2, 100, 1024, 32, bf16, f32, False, True, None),
            "extreme decays B=2 T=512 Dm=2048 N=16 f32 state0": (
                2, 512, 2048, 16, f32, f32, False, True, "extreme"),
            "B=2 T=100 Dm=300 N=8 f32 with D": (2, 100, 300, 8, f32, f32, True, True, None),
            "B=1 T=7 Dm=64 N=2 f32": (1, 7, 64, 2, f32, f32, True, False, None)}.items():
        ins = ssm_inputs(b_, t_, dm, n_, dtype, d_dtype, decays)
        d_ = normal(dm) if with_d else torch.zeros(dm, device=dev)
        s0 = normal(b_, dm, n_) if with_s0 else None
        got = launched("mamba_scan", lambda: mamba_scan(*ins, d_, s0))
        want = mamba_plain(*ins, d_, s0)
        mb_err[what] = max(agree(f"mamba_scan {what}", got[0], want[0]),
                           agree(f"mamba_scan {what} state", got[1], want[1]))
        # the f32 outputs' error as a share of the tolerance (<= 1 passes)
        mb_share[what] = max(err(g_, w_) / (1e-5 * float(w_.abs().max()))
                             for g_, w_ in zip(got, want) if g_.dtype == f32)
        copy16 = all(rows_16b(z.data_ptr(), dm, z.element_size()) for z in ins[:2])
        mb_paths[what] = (plan_mamba(b_, t_, dm, n_, n_sms).lanes,
                          "16-byte" if copy16 else "element")
    check({p[0] for p in mb_paths.values()} == {1, 2, 4}
          and {p[1] for p in mb_paths.values()} == {"16-byte", "element"},
          f"mamba_scan: phase 2 missed a lane count or a copy path: {mb_paths}")
    max_err["mamba_scan"] = mb_err[f"jamba width B=4 T=256 Dm={mb_dm} N={mb_n} x bf16"]
    log("phase 2: mamba_scan ok (max abs err vs plain, f32 outputs' err over "
        "tolerance, [lanes, copy path]: " + ", ".join(
            f"{k_} {v_:.3g} {mb_share[k_]:.3f} {mb_paths[k_]}"
            for k_, v_ in mb_err.items()) + ")")

    # -- 2b. the four TinyBio kernels with a leading batch axis ---------------
    # Serving lifts each stage over a batch (torch.func.vmap); each card
    # kernel folds it into its own batch axis: ONE launch a call, each row
    # the bits of its request alone.  For B = 1, 2, 4, 8: the batched call
    # against B single calls on the card and against the plain version on
    # the whole batch, bit for bit (exact: the same sums in the same order);
    # the vmapped call against the batched call, bit for bit; and a
    # torch.profiler count of one device kernel for one batched call.
    xb_all = torch.from_numpy(np.stack([tinybio.synth_signal(x.numel(), s_)
                                        for s_ in range(8)])).to(dev)
    xib_all = int_tensor(-2 ** 15, 2 ** 15, (8, x.numel()), np.int16)
    qb_all = torch.from_numpy(rng.uniform(-1, 1, (8, 128, 36)).astype(np.float32)).to(dev)
    batched_kernels = {}
    for bsz in (1, 2, 4, 8):
        xb, xib, qb = xb_all[:bsz].contiguous(), xib_all[:bsz].contiguous(), qb_all[:bsz].contiguous()
        yb = launched("fir", lambda: fir(xb, h))
        check(same_bits(yb, fir_ref(xb, h)), f"batched fir B={bsz} vs plain")
        check(all(same_bits(yb[i_], fir(xb[i_], h)) for i_ in range(bsz)),
              f"batched fir B={bsz} vs single calls")
        check(same_bits(launched("fir", lambda: torch.func.vmap(lambda a_: fir(a_, h))(xb)), yb),
              f"vmapped fir B={bsz}")
        yib = launched("fir", lambda: fir(xib, hi))
        check(torch.equal(yib, fir_ref(xib, hi)), f"batched fir Q15 int16 B={bsz} vs plain")
        check(all(torch.equal(yib[i_], fir(xib[i_], hi)) for i_ in range(bsz)),
              f"batched fir Q15 int16 B={bsz} vs single calls")
        # extrema at both edges of every row: a peak at sample 0, a trough
        # at sample 1 and a peak at the last sample, which a flattened
        # (B * n) signal would flag as interior samples
        ye = yb.clone()
        ye[:, 0], ye[:, 1], ye[:, -1], ye[:, -2] = 9.0, -9.0, 9.0, -9.0
        fb = launched("delineate", lambda: delineate(ye, 0))
        check(torch.equal(fb, delineate_ref(ye, 0)), f"batched delineate B={bsz} vs plain")
        check(all(torch.equal(fb[i_], delineate(ye[i_], 0)) for i_ in range(bsz)),
              f"batched delineate B={bsz} vs single calls")
        check(bool((fb[:, 0] == 0).all() and (fb[:, -1] == 0).all()
                   and (fb[:, -2] == -1).all()), f"batched delineate B={bsz}: row edges")
        check(torch.equal(launched("delineate", lambda: torch.func.vmap(
            lambda a_: delineate(a_, 0))(ye)), fb), f"vmapped delineate B={bsz}")
        wb = yb.reshape(bsz, 128, 512)
        pb = launched("stockham_fft", lambda: power_spectrum(wb))
        check(all(same_bits(pb[i_], power_spectrum(wb[i_])) for i_ in range(bsz)),
              f"batched power_spectrum B={bsz} vs single calls")
        pre_, pim_ = stockham_fft_ref(wb.reshape(-1, 512), torch.zeros(bsz * 128, 512, device=dev))
        pref = (pre_ * pre_ + pim_ * pim_).reshape(bsz, 128, 512)
        # the fft's 1e-6 of max |X| carried through the square: 3e-6 of
        # max |X|^2
        check(float((pb - pref).abs().max()) <= 3e-6 * float(pref.max()),
              f"batched power_spectrum B={bsz} vs plain (3e-6 of max |X|^2)")
        check(same_bits(launched("stockham_fft", lambda: torch.func.vmap(power_spectrum)(wb)), pb),
              f"vmapped power_spectrum B={bsz}")
        for what_b, bb in (("b card tensor", b), ("b float", 0.1)):
            sb = launched("svm", lambda: svm_decision(qb, sv_main, alpha_main, bb, 0.5))
            check(all(same_bits(sb[i_], svm_decision(qb[i_], sv_main, alpha_main, bb, 0.5))
                      for i_ in range(bsz)), f"batched svm B={bsz} ({what_b}) vs single calls")
            check(torch.allclose(sb, svm_decision_ref(qb, sv_main, alpha_main, bb, 0.5),
                                 rtol=1e-4, atol=1e-5), f"batched svm B={bsz} ({what_b}) vs plain")
            check(same_bits(launched("svm", lambda: torch.func.vmap(
                lambda a_: svm_decision(a_, sv_main, alpha_main, bb, 0.5))(qb)), sb),
                f"vmapped svm B={bsz} ({what_b})")
        for name_, fn_, marker_ in (
                ("fir", lambda: fir(xb, h), "fir_kernel"),
                ("fir Q15", lambda: fir(xib, hi), "fir_kernel"),
                ("delineate", lambda: delineate(ye, 0), "delineate_kernel"),
                ("power_spectrum", lambda: power_spectrum(wb), "stockham_fft_kernel"),
                ("svm", lambda: svm_decision(qb, sv_main, alpha_main, b, 0.5), "svm_kernel")):
            names_ = device_kernels(torch, fn_, 1)
            check(len(names_) == 1 and marker_ in names_[0],
                  f"batched {name_} B={bsz} ran device kernels {names_}")
        batched_kernels[bsz] = 5
    log("phase 2: batched TinyBio kernels ok for B = 1, 2, 4, 8: fir (f32 and Q15 "
        "int16), delineate (extrema at the row edges), power_spectrum (B, 128, 512) "
        "and svm (B, 128, 36; b a card tensor and a float) bit-equal to B single "
        "calls, fir/delineate bit-equal to the plain version on the batch "
        "(power_spectrum within 3e-6 of max |X|^2, svm rtol 1e-4 + atol 1e-5), "
        "vmapped calls bit-equal to batched ones, one device kernel a batched call")

    # -- 3. timings at the main paths' shapes ------------------------------
    n, taps = x.numel(), h.numel()
    q, m, d = feats.shape[0], sv_main.shape[0], feats.shape[1]
    bw, bn = w.shape
    timed = {
        "fir": dict(
            kernel=lambda: fir(x, h), plain=lambda: fir_ref(x, h),
            library=lambda: F.conv1d(x.view(1, 1, -1), h.flip(0).view(1, 1, -1),
                                     padding=taps - 1),
            bound=bound(4.0 * (2 * n + taps), 2.0 * n * taps)),
        "delineate": dict(
            kernel=lambda: delineate(y, 0), plain=lambda: delineate_ref(y, 0),
            library=None, bound=bound(5.0 * n, 7.0 * n)),
        "stockham_fft": dict(
            kernel=lambda: fft(w),
            plain=lambda: stockham_fft_ref(w, torch.zeros_like(w)),
            library=lambda: torch.fft.fft(w),
            bound=bound(4.0 * 3 * bw * bn,
                        10.0 * bw * (bn // 2) * int(math.log2(bn)))),
        "svm": dict(
            kernel=lambda: svm_decision(feats, sv_main, alpha_main, b, 0.5),
            plain=lambda: svm_decision_ref(feats, sv_main, alpha_main, b, 0.5),
            library=None,
            bound=bound(4.0 * (q * d + m * d + m + q),
                        2.0 * q * m * d + 2.0 * (q + m) * d + 8.0 * q * m)),
    }
    rows = {}
    fmt = lambda v: "-" if v is None else f"{v:.6f} ms"
    for name, t in timed.items():
        # device time from CUDA-graph replay (the numbers reported), and the
        # eager per-call cost with the host's dispatch (logged beside them)
        ms = device_ms(torch, t["kernel"], 100)
        plain_ms = device_ms(torch, t["plain"], 5)
        lib_ms = (device_ms(torch, t["library"], 100)
                  if t["library"] is not None else None)
        eager = [call_ms(torch, t["kernel"], 300),
                 call_ms(torch, t["plain"], 30, warmup=3),
                 None if t["library"] is None else call_ms(torch, t["library"], 300)]
        bound_ms, bound_by = t["bound"]
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        log(f"phase 3: {name}: device time per call: kernel {fmt(ms)}, "
            f"plain {fmt(plain_ms)}, library {fmt(lib_ms)}; bound "
            f"{bound_ms:.6f} ms ({bound_by}); eager call incl. host "
            f"dispatch: kernel {fmt(eager[0])}, plain {fmt(eager[1])}, "
            f"library {fmt(eager[2])}")
    # fir's bits forbid the fused multiply-add: an FMUL and an FADD per tap
    # and output (the Q15 path: one IMAD at half that rate), so its own
    # bound is twice the FMA bound of the kernels line
    log(f"phase 3: fir plan {tuple(plan_fir(n, taps, n_sms))} (rows a thread, "
        f"threads a block); bound of its bits (FMUL + FADD at 128 a "
        f"clock per SM, or IMAD at 64) {fir_bits_bound(n, taps, n_sms, max_sm_mhz):.6f} "
        f"ms beside the FMA bound {rows['fir']['bound_ms']:.6f} ms; Q15 int16 at "
        f"the same shape: kernel "
        f"{fmt(device_ms(torch, lambda: fir(xi, hi), 100))}, plain "
        f"{fmt(device_ms(torch, lambda: fir_ref(xi, hi), 5))}")

    # power_spectrum (TinyBio's stage-3 call: the fft kernel with |X|^2 in
    # its last pass, one launch) beside fft; its "library" is the parent's
    # composition, fft and then re*re + im*im (four launches).  Bound: the
    # windows read once and the spectrum written once, against the fft's
    # flops and 3 a sample.
    def squares(r_, i_):
        return r_ * r_ + i_ * i_

    ps_bound = bound(4.0 * 2 * bw * bn, 10.0 * bw * (bn // 2) * int(math.log2(bn))
                     + 3.0 * bw * bn)
    ps_row = dict(
        ms=device_ms(torch, lambda: power_spectrum(w), 100),
        plain_ms=device_ms(torch, lambda: squares(*stockham_fft_ref(
            w, torch.zeros_like(w))), 5),
        library_ms=device_ms(torch, lambda: squares(*fft(w)), 100),
        bound_ms=ps_bound[0], bound_by=ps_bound[1])
    log(f"phase 3: power_spectrum {bw} x {bn}: device time per call: kernel "
        f"{fmt(ps_row['ms'])}, plain {fmt(ps_row['plain_ms'])}, fft then "
        f"re*re + im*im (the parent's four launches) {fmt(ps_row['library_ms'])}; "
        f"bound {ps_bound[0]:.6f} ms ({ps_bound[1]}); eager call incl. host "
        f"dispatch: kernel {fmt(call_ms(torch, lambda: power_spectrum(w), 300))}")
    # the card's launch floor: an empty kernel (csrc/launch_floor.cu) of one
    # block of 32 threads and of TinyBio's fft/svm grid, 128 blocks of 256,
    # timed as the kernels are (100 a graph)
    floor = launch_floor(common)
    floor_ms = {g_: device_ms(torch, lambda g_=g_: floor(*g_), 100)
                for g_ in ((1, 32), (128, 256))}
    log("phase 3: launch floor (empty kernel): device time per call: "
        + ", ".join(f"{b_} x {t_} threads {v_:.6f} ms" for (b_, t_), v_ in floor_ms.items())
        + "; over the 1-block floor: " + ", ".join(
            f"{k_} {rows[k_]['ms'] / floor_ms[1, 32]:.2f}x" for k_ in TINYBIO_KERNELS)
        + f", power_spectrum {ps_row['ms'] / floor_ms[1, 32]:.2f}x")
    # one device kernel per call of svm_decision, power_spectrum, fir and
    # delineate (torch.profiler over 10 calls)
    for what, fn_, marker in (
            ("svm_decision", timed["svm"]["kernel"], "svm_kernel"),
            ("power_spectrum", lambda: power_spectrum(w), "stockham_fft_kernel"),
            ("fir", timed["fir"]["kernel"], "fir_kernel"),
            ("delineate", timed["delineate"]["kernel"], "delineate_kernel")):
        names = device_kernels(torch, fn_, 10)
        check(len(names) == 10 and all(marker in k_ for k_ in names),
              f"{what}: 10 calls ran {len(names)} device kernels: {sorted(set(names))}")
        log(f"phase 3: {what}: 10 calls ran 10 device kernels ({names[0][:60]})")

    # the batched calls at B = 4 (phase 7's micro-batch): device time of one
    # batched call beside four single calls and the launch floor
    xb4, xib4 = xb_all[:4].contiguous(), xib_all[:4].contiguous()
    yb4 = fir(xb4, h)
    wb4, qb4 = yb4.reshape(4, 128, 512), qb_all[:4].contiguous()
    batched_ms = {}
    for name_, one_, four_ in (
            ("fir", lambda: fir(x, h), lambda: fir(xb4, h)),
            ("fir Q15 int16", lambda: fir(xi, hi), lambda: fir(xib4, hi)),
            ("delineate", lambda: delineate(y, 0), lambda: delineate(yb4, 0)),
            ("power_spectrum", lambda: power_spectrum(w), lambda: power_spectrum(wb4)),
            ("svm", lambda: svm_decision(feats, sv_main, alpha_main, b, 0.5),
             lambda: svm_decision(qb4, sv_main, alpha_main, b, 0.5))):
        one_ms, four_ms = device_ms(torch, one_, 100), device_ms(torch, four_, 100)
        batched_ms[name_] = (four_ms, one_ms)
        log(f"phase 3: batched {name_} B=4: device time per call {four_ms:.6f} ms, "
            f"4 x the single call {4 * one_ms:.6f} ms (single {one_ms:.6f} ms), "
            f"{four_ms / floor_ms[1, 32]:.2f}x the 1 x 32 launch floor")

    # gemm at the GeMM path's 256^3 int32, once per config's tiling; the
    # kernels line reports the 16T tiling (the quickstart's config).
    side = 256
    ga, gb = ints(-64, 64, side, side), ints(-64, 64, side, side)
    per_cfg = {name: device_ms(torch, lambda k=k: gemm(ga, gb, k), 100)
               for name, k in knobs.items()}
    k16 = knobs[EGPU_16T.name]
    int_library = None
    try:
        torch.matmul(ga[:2, :2], gb[:2, :2])
    except (NotImplementedError, RuntimeError) as e:
        log(f"phase 3: gemm int32 library call: none — torch.matmul on CUDA "
            f"int32 raises {type(e).__name__}: {str(e).splitlines()[0][:80]}")
    else:
        int_library = lambda: torch.matmul(ga, gb)
    g_bound = bound(4.0 * 3 * side * side, float(side) ** 3, peak_int32_macs)
    rows["gemm"] = dict(
        ms=per_cfg[EGPU_16T.name],
        plain_ms=device_ms(torch, lambda: gemm_plain(ga, gb), 5),
        library_ms=(None if int_library is None
                    else device_ms(torch, int_library, 100)),
        bound_ms=g_bound[0], bound_by=g_bound[1])
    r = rows["gemm"]
    log(f"phase 3: gemm 256^3 int32: device time per call: kernel "
        + ", ".join(f"{c} {v:.6f} ms ({tuple(plan_split_k(side, side, side, tiles_from_knobs(k), n_sms, torch.int32))} "
                    f"splits, k-tiles)" for (c, v), k in zip(per_cfg.items(), knobs.values()))
        + f"; plain {fmt(r['plain_ms'])}, library {fmt(r['library_ms'])}; "
        f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}, int32 peak); eager "
        f"call incl. host dispatch: kernel 16T "
        f"{fmt(call_ms(torch, lambda: gemm(ga, gb, k16), 300))}, plain "
        f"{fmt(call_ms(torch, lambda: gemm_plain(ga, gb), 30, warmup=3))}")
    # ... and at 2048^3 with the 16T tiling, where launch latency no longer
    # hides the kernel's own rate.  int32 exact against the plain version;
    # f32 against torch.matmul (TF32 off): sums of 2048 products of N(0, 1)
    # values reach |c| ~ 200, where the two summation orders differ by a few
    # 1e-5, so rtol 1e-4 and atol 1e-3.
    big = 2048
    ba, bb = ints(-64, 64, big, big), ints(-64, 64, big, big)
    fa, fb = floats(big, big), floats(big, big)
    check(torch.equal(launched("gemm", lambda: gemm(ba, bb, k16)), gemm_plain(ba, bb)),
          "gemm int32 2048^3 not exact")
    check(torch.allclose(launched("gemm", lambda: gemm(fa, fb, k16)),
                         torch.matmul(fa, fb), rtol=1e-4, atol=1e-3),
          "gemm f32 2048^3 differs from torch.matmul")
    big_rows = {}
    for dtype, (xa, xb, peak, ops) in {
            "int32": (ba, bb, peak_int32_macs, float(big) ** 3),
            "f32": (fa, fb, PEAK_FP32_FLOPS, 2.0 * float(big) ** 3)}.items():
        k_ms = device_ms(torch, lambda: gemm(xa, xb, k16), 10)
        lib = (None if dtype == "int32"
               else device_ms(torch, lambda: torch.matmul(fa, fb), 10))
        b_ms, b_by = bound(4.0 * 3 * big * big, ops, peak)
        big_rows[dtype] = dict(ms=k_ms, library_ms=lib, bound_ms=b_ms)
        log(f"phase 3: gemm 2048^3 {dtype} (16T tiling): kernel {k_ms:.6f} ms "
            f"({ops / (k_ms * 1e-3) / 1e12:.3f} T {'MAC' if dtype == 'int32' else 'FLOP'}/s), "
            f"library {fmt(lib)}, bound {b_ms:.6f} ms ({b_by})")

    # flash_attention at qwen's prefill shape (the kernels line reports it)
    # and at B=1, S=T=4096.  Bound: q, k, v read once and the output
    # written once in bf16 over 3.35 TB/s, against 2 (Dk + Dv) flops for
    # each (q, k) pair the causal mask keeps over the bf16 peak.
    def fa_bound(b, h, kvh, s, t, dk, dv):
        nbytes = 2.0 * (b * h * s * dk + b * kvh * t * (dk + dv) + b * h * s * dv)
        pairs = sum(min(t, i + 1) for i in range(s))
        return bound(nbytes, 2.0 * b * h * pairs * (dk + dv), PEAK_BF16_FLOPS)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    fa_rows = {}
    for label, b_, s_, per_graph in (("prefill", LM_BATCH, LM_PROMPT, 50),
                                     ("long", 1, 4096, 3)):
        dims = (b_, lm_h, lm_kvh, s_, s_, lm_d, lm_d)
        q, k, v = (x.contiguous() for x in qkv(*dims, bf16))
        check(err(sdpa(q, k, v), flash_attention_plain(q, k, v)) <= 5e-2,
              f"SDPA differs from the plain version at {label}")
        b_ms, b_by = fa_bound(*dims)
        fa_rows[label] = dict(
            ms=device_ms(torch, lambda: flash_attention(q, k, v), per_graph),
            plain_ms=device_ms(torch, lambda: flash_attention_plain(q, k, v), 1),
            library_ms=device_ms(torch, lambda: sdpa(q, k, v), per_graph),
            bound_ms=b_ms, bound_by=b_by)
        r = fa_rows[label]
        log(f"phase 3: flash_attention {label} B={b_} H={lm_h} KVH={lm_kvh} "
            f"S=T={s_} D={lm_d} bf16 causal: device time per call: kernel "
            f"{fmt(r['ms'])}, plain {fmt(r['plain_ms'])}, library (SDPA) "
            f"{fmt(r['library_ms'])}; bound {b_ms:.6f} ms ({b_by}); kernel "
            f"{r['ms'] / b_ms:.1f}x its bound ({b_ms / r['ms']:.3f} of it), "
            f"{r['ms'] / r['library_ms']:.2f}x SDPA")
    rows["flash_attention"] = fa_rows["prefill"]

    # rwkv6_scan at rwkv6-3b's prefill shape (state0 absent, as the prefill
    # passes it) and one decode step (T = 1 from a state), with B = 1,
    # T = 4096 logged beside them.  Bound: r, k, v (bf16) and w (f32) read
    # once, u and any state0 read once, y (bf16) and the f32 state written
    # once, against 5 D^2 f32 flops per step and head (rwkv6_scan's counts).
    # No single PyTorch call computes the scan: library none.
    def rwkv_bound(b_, t_, with_state):
        n_in = b_ * rw_h * t_ * rw_d
        state = 4.0 * b_ * rw_h * rw_d * rw_d
        nbytes = (n_in * (3 * 2 + 4 + 2) + 4.0 * rw_h * rw_d + state
                  + (state if with_state else 0.0))
        return bound(nbytes, 5.0 * n_in * rw_d)

    rw_rows = {}
    for label, b_, t_, with_state, per_graph in (
            ("prefill", RWKV_BATCH, RWKV_PROMPT, False, 50),
            ("decode step", RWKV_BATCH, 1, True, 100),
            ("long", 1, 4096, False, 3)):
        ins = rwkv_inputs(b_, rw_h, t_, rw_d, bf16)
        s0 = normal(b_, rw_h, rw_d, rw_d) if with_state else None
        b_ms, b_by = rwkv_bound(b_, t_, with_state)
        rw_rows[label] = dict(
            ms=device_ms(torch, lambda: rwkv6_scan(*ins, s0), per_graph),
            plain_ms=device_ms(torch, lambda: rwkv6_scan_plain(*ins, s0),
                               max(1, per_graph // 10)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by)
        r = rw_rows[label]
        log(f"phase 3: rwkv6_scan {label} B={b_} H={rw_h} T={t_} D={rw_d} "
            f"(r/k/v bf16, w f32{', from a state' if with_state else ''}): "
            f"device time per call: kernel {fmt(r['ms'])}, plain "
            f"{fmt(r['plain_ms'])}, library none; bound {b_ms:.6f} ms ({b_by}); "
            f"kernel {r['ms'] / b_ms:.1f}x its bound")
    rows["rwkv6_scan"] = rw_rows["prefill"]

    # decode_attention at qwen's decode shape (the cache of the LM path's
    # max_len), T = 32768 logged beside it; the library call is SDPA with
    # one query and enable_gqa.  Bound: q, k, v read once and out written
    # once in bf16, against 2 (Dk + Dv) flops per (head, key) at the bf16 peak.
    def sdpa_one(q, k, v):
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              enable_gqa=True)[:, :, 0]

    da_rows = {}
    for label, t_, per_graph in (("decode", LM_MAX_LEN, 100), ("long", 32768, 10)):
        q = normal(LM_BATCH, lm_h, lm_d, dtype=bf16)
        k, v = (normal(LM_BATCH, lm_kvh, t_, lm_d, dtype=bf16) for _ in range(2))
        check(err(sdpa_one(q, k, v), decode_attention_ref(q, k, v)) <= 5e-2,
              f"SDPA differs from the plain decode attention at T={t_}")
        b_ms, b_by = bound(
            2.0 * (2 * LM_BATCH * lm_h * lm_d + 2 * LM_BATCH * lm_kvh * t_ * lm_d),
            2.0 * LM_BATCH * lm_h * t_ * 2 * lm_d, PEAK_BF16_FLOPS)
        da_rows[label] = dict(
            ms=device_ms(torch, lambda: decode_attention(q, k, v), per_graph),
            plain_ms=device_ms(torch, lambda: decode_attention_ref(q, k, v),
                               max(1, per_graph // 10)),
            library_ms=device_ms(torch, lambda: sdpa_one(q, k, v), per_graph),
            bound_ms=b_ms, bound_by=b_by)
        r = da_rows[label]
        if label == "long":
            # the rule this plan replaced: one sequence alone aimed at the
            # card (PLAN_BATCH = 1), whose cut is as B-free but finer
            da_module.PLAN_BATCH, kept = 1, da_module.PLAN_BATCH
            fine = plan_decode_splits(lm_kvh, t_, n_sms)
            fine_ms = device_ms(torch, lambda: decode_attention(q, k, v), per_graph)
            da_module.PLAN_BATCH = kept
            log(f"phase 3: decode_attention long, the plan for one sequence "
                f"alone ({fine[0]} splits of {fine[1]} keys, "
                f"{fine[0] * LM_BATCH * lm_kvh} blocks): kernel {fmt(fine_ms)} "
                f"against {fmt(r['ms'])} with the plan batch of "
                f"{da_module.PLAN_BATCH}")
        n_split, kps = plan_decode_splits(lm_kvh, t_, n_sms)
        log(f"phase 3: decode_attention {label} B={LM_BATCH} H={lm_h} "
            f"KVH={lm_kvh} T={t_} D={lm_d} bf16 ({n_split} splits of {kps} "
            f"keys, {n_split * LM_BATCH * lm_kvh} blocks): device time per call: kernel "
            f"{fmt(r['ms'])}, plain {fmt(r['plain_ms'])}, library (SDPA, one "
            f"query) {fmt(r['library_ms'])}; bound {b_ms:.6f} ms ({b_by}); "
            f"kernel {r['ms'] / b_ms:.1f}x its bound ({b_ms / r['ms']:.3f} of "
            f"it), {r['ms'] / r['library_ms']:.2f}x SDPA")
    rows["decode_attention"] = da_rows["decode"]

    # mamba_scan's kernel (selective_scan: the scan without the D x skip,
    # which the op adds in plain PyTorch as the JAX op does) at jamba's
    # width with the dtypes the jamba block passes under bf16: B = 4,
    # T = 256 (the row reported), phase 4c's B = 2, T = 128 and one long
    # sequence, B = 1, T = 4096, beside it.  Bound: x (bf16), delta (f32),
    # a, b, c (f32) read once, y (bf16) and the f32 state written once,
    # against 6 N flops per step and channel (mamba_scan's counts).  The
    # special-function unit's floor is logged beside it: one exponential
    # per step, channel and state at 16 a clock per SM (CUDA C++
    # Programming Guide, compute capability 9.0) and the max SM clock.
    # Library none.
    mb_rows = {}
    for b_, t_, per_graph in ((4, 256, 20), (2, 128, 80), (1, 4096, 5)):
        ins = ssm_inputs(b_, t_, mb_dm, mb_n, bf16)
        elems = b_ * t_ * mb_dm
        mb_bound = bound(elems * (2 + 4 + 2) + 4.0 * (
            mb_dm * mb_n + 2 * b_ * t_ * mb_n + b_ * mb_dm * mb_n),
            6.0 * elems * mb_n)
        sfu_ms = elems * mb_n / (SFU_PER_CLK_PER_SM * n_sms * max_sm_mhz * 1e6) * 1e3
        mb_rows[b_, t_] = r = dict(
            ms=device_ms(torch, lambda: selective_scan(*ins), per_graph),
            plain_ms=device_ms(torch, lambda: mamba_scan_plain(*ins), 1),
            library_ms=None, bound_ms=mb_bound[0], bound_by=mb_bound[1])
        plan = plan_mamba(b_, t_, mb_dm, mb_n, n_sms)
        log(f"phase 3: mamba_scan B={b_} T={t_} Dm={mb_dm} N={mb_n} (x bf16, "
            f"the rest f32; {plan.lanes} lanes a channel, {plan.blocks} blocks, "
            f"{plan.warps_per_sm:.2f} warps an SM): device time per call: "
            f"kernel {fmt(r['ms'])}, plain {fmt(r['plain_ms'])}, library none; "
            f"bound {mb_bound[0]:.6f} ms ({mb_bound[1]}), SFU floor "
            f"{sfu_ms:.6f} ms; kernel {r['ms'] / mb_bound[0]:.2f}x its bound, "
            f"{r['ms'] / sfu_ms:.2f}x the SFU floor")
    rows["mamba_scan"] = mb_rows[4, 256]

    # -- 4a. the TinyBio main path --------------------------------------------
    runs = {}
    torch.cuda.synchronize()
    common.reset_launches()
    walls = {}
    for cfg in configs:
        for mode in ("graph", "eager"):
            t0 = time.perf_counter()
            runs[cfg.name, mode] = tinybio.run_tinybio(cfg, 0, mode, device="cuda")
            torch.cuda.synchronize()
            walls[cfg.name, mode] = time.perf_counter() - t0
    wall = sum(walls.values())
    launches = dict(common.LAUNCHES)
    expected = len(configs) * (1 + 2)
    for name in KERNELS:
        want = expected if name in TINYBIO_KERNELS else 0
        check(launches[name] == want,
              f"TinyBio main path launched {name} {launches[name]} times, "
              f"expected {want}")
    log(f"phase 4: TinyBio main path (3 configs x graph + eager) in {wall:.3f} s "
        f"(per run: {', '.join(f'{c} {m} {t:.3f} s' for (c, m), t in walls.items())}), "
        f"launches {launches}")
    for cfg in configs:
        dg, rg = runs[cfg.name, "graph"]
        de, re_ = runs[cfg.name, "eager"]
        check(dg.is_cuda and dg.shape == (128,) and bool(torch.isfinite(dg).all()),
              "decisions are not 128 finite values on the card")
        check(torch.equal(dg, de), f"{cfg.name}: graph and eager decisions differ")
        for mode, (dec, rep) in (("graph", (dg, rg)), ("eager", (de, re_))):
            cd, cr = tinybio.run_tinybio(cfg, 0, mode, device="cpu")
            check(dataclasses.asdict(rep) == dataclasses.asdict(cr),
                  f"{cfg.name} {mode}: report differs from the CPU run's")
            check(torch.allclose(dec.cpu(), cd, rtol=0, atol=1e-6),
                  f"{cfg.name} {mode}: decisions differ from the CPU run's")
        log(f"phase 4: {cfg.name}: report == CPU report, fused speed-up "
            f"{rg.fused_speedup!r}")

    # each stage on the card, fed the CPU run's previous-stage output
    cstages, cinputs = tinybio.tinybio_stages(EGPU_16T, 0, "cpu")
    cur = tuple(cinputs)
    tol = {"fir": dict(rtol=0, atol=1e-6), "delineate_keep": None,
           "fft_features": dict(rtol=1e-4, atol=5e-5),
           "svm": dict(rtol=0, atol=1e-6)}
    for cs, gs in zip(cstages, stages):
        want = cs.kernel.executor(*cur, *cs.consts, **cs.params)
        want = want if isinstance(want, tuple) else (want,)
        got = gs.kernel.executor(*[a.to(dev) for a in cur], *gs.consts,
                                 **gs.params)
        got = got if isinstance(got, tuple) else (got,)
        for a, bb in zip(got, want):
            t = tol[gs.kernel.name]
            ok = (torch.equal(a.cpu(), bb) if t is None or not bb.is_floating_point()
                  else torch.allclose(a.cpu(), bb, **t))
            check(ok, f"stage {gs.kernel.name} differs from the CPU run's")
        cur = want
    yc = cstages[0].kernel.executor(cinputs[0], cstages[0].consts[0])
    flips = int((delineate_ref(yc, 0) != flags.cpu()).sum())
    check(flips <= 8, f"{flips} flags differ end to end from the CPU run's")
    log(f"phase 4: every stage matches the CPU run's; end-to-end flag flips {flips}")

    # where one warm graph offload's time goes: device time by kernel name
    # (torch.profiler) against the host's wall clock
    tinybio.run_tinybio(EGPU_16T, 0, "graph", device="cuda")
    torch.cuda.synchronize()
    log("phase 4: " + profile_line(
        "one warm 16T TinyBio graph offload", *device_profile(
            torch, lambda: tinybio.run_tinybio(EGPU_16T, 0, "graph",
                                               device="cuda"))))

    # -- 4b. the GeMM main path (paper Fig 3, the quickstart's offload) -------
    qa = np.random.default_rng(0).integers(-64, 64, (2, 256, 256)).astype(np.int32)
    qa, qb = qa[0], qa[1]
    cp = {"m": 256, "n": 256, "k": 256}

    def gemm_offload(cfg, mode, device):
        stage = Stage(Program.build(cfg).create_kernel("gemm"), counts_params=cp)
        return APU(cfg, device=device).offload([stage], (qa, qb), mode=mode)

    gruns, gwalls = {}, {}
    torch.cuda.synchronize()
    common.reset_launches()
    for cfg in configs:
        for mode in ("graph", "eager"):
            t0 = time.perf_counter()
            gruns[cfg.name, mode] = gemm_offload(cfg, mode, "cuda")
            torch.cuda.synchronize()
            gwalls[cfg.name, mode] = time.perf_counter() - t0
    gemm_launches = dict(common.LAUNCHES)
    for name in KERNELS:
        want = expected if name in GEMM_KERNELS else 0
        check(gemm_launches[name] == want,
              f"GeMM main path launched {name} {gemm_launches[name]} times, "
              f"expected {want}")
    launches.update({name: gemm_launches[name] for name in GEMM_KERNELS})
    log(f"phase 4: GeMM main path (3 configs x graph + eager, 256^3 int32) in "
        f"{sum(gwalls.values()):.3f} s (per run: "
        f"{', '.join(f'{c} {m} {t:.3f} s' for (c, m), t in gwalls.items())}), "
        f"launches {gemm_launches}")
    exact = qa.astype(np.int64) @ qb.astype(np.int64)
    for (cfg_name, mode), ((out,), rep) in gruns.items():
        check(out.data.is_cuda and out.data.dtype == torch.int32
              and np.array_equal(out.data.cpu().numpy(), exact),
              f"GeMM offload {cfg_name} {mode}: output is not A @ B")
        cfg = next(c for c in configs if c.name == cfg_name)
        _, crep = gemm_offload(cfg, mode, "cpu")
        check(dataclasses.asdict(rep) == dataclasses.asdict(crep),
              f"GeMM offload {cfg_name} {mode}: report differs from the CPU run's")
    rep16 = gruns[EGPU_16T.name, "graph"][1].stages[0]
    log(f"phase 4: GeMM offloads exact, reports == CPU reports; 16T modeled "
        f"speed-up {rep16.speedup!r}, energy reduction {rep16.energy_reduction!r}")
    gemm_offload(EGPU_16T, "graph", "cuda")
    torch.cuda.synchronize()
    g_wall, g_busy, g_kernels = device_profile(
        torch, lambda: gemm_offload(EGPU_16T, "graph", "cuda"))
    log("phase 4: " + profile_line("one warm 16T GeMM graph offload",
                                   g_wall, g_busy, g_kernels))
    # no library product and no plain version on the path: the only
    # device-side kernel is the hand-written one (besides the copies)
    library = [k for k in g_kernels
               if any(t in k.lower() for t in ("sgemm", "xmma", "cutlass",
                                               "cublas", "gemv", "elementwise",
                                               "reduce"))]
    check(not library, f"GeMM offload ran library or plain kernels: {library}")
    check(any("gemm_kernel" in k for k in g_kernels),
          "GeMM offload's profile shows no gemm_kernel")

    # the Fig-3, transfer and multi-queue benches on the card, their
    # modeled numbers equal to the CPU run's
    check(bench_gemm_overhead.run("cuda") == bench_gemm_overhead.run("cpu"),
          "bench_gemm_overhead rows differ between the card and the CPU")
    for bench in (bench_transfer, bench_multiqueue):
        on_card, on_cpu = bench.run("cuda"), bench.run("cpu")
        for key in on_cpu:
            if key not in ("device", "fused_launch_wall_us"):
                check(on_card[key] == on_cpu[key],
                      f"{bench.__name__} {key}: {on_card[key]} on the card, "
                      f"{on_cpu[key]} on the CPU")
    ctx = Context(Device(EGPU_16T), "cuda")
    for graph, per_launch in (
            (bench_transfer._capture_explicit(ctx), 4),
            (bench_transfer._capture_naive(ctx), 4),
            (bench_multiqueue._capture(ctx, True), 5)):   # pre + 4 branches
        scratch = CommandQueue(ctx)
        torch.cuda.synchronize()
        before = dict(common.LAUNCHES)
        graph.launch(queue=scratch)
        torch.cuda.synchronize()
        moved = {k: common.LAUNCHES[k] - before[k] for k in before}
        check(moved == {k: per_launch if k == "gemm" else 0 for k in before},
              f"a DAG bench graph launch moved the counters by {moved}")
    log("phase 4: bench_gemm_overhead rows, bench_transfer and "
        "bench_multiqueue modeled numbers equal the CPU run's; gemm launches "
        "4 per transfer-graph launch, 5 per multi-queue graph launch")

    # -- 4c. the registry's decode_attention and mamba_scan families -------
    # Program.build(cfg).create_kernel(family) for 4T, 8T and 16T, each
    # enqueued once through a CommandQueue and offloaded through APU.offload
    # in graph and eager mode, with the launch counters reset just before
    # and read just after: each family launched once per queue enqueue and
    # graph offload, twice per eager one (its e-GPU and host contexts), and
    # no other kernel.  Both kernels are deterministic, so every result
    # equals the op's bit for bit; every modeled report equals the CPU run's
    # (the same inputs, copied to the CPU) float for float.
    reg_inputs = {
        "decode_attention": (
            (normal(LM_BATCH, lm_h, lm_d, dtype=bf16),
             normal(LM_BATCH, lm_kvh, LM_MAX_LEN, lm_d, dtype=bf16),
             normal(LM_BATCH, lm_kvh, LM_MAX_LEN, lm_d, dtype=bf16)),
            {"b": LM_BATCH, "h": lm_h, "t": LM_MAX_LEN, "dk": lm_d, "dv": lm_d,
             "itemsize": 2}),
        "mamba_scan": (
            ssm_inputs(2, 128, mb_dm, mb_n, bf16) + (normal(mb_dm),),
            {"bsz": 2, "t": 128, "dm": mb_dm, "n": mb_n}),
    }
    reg_ops = {"decode_attention": decode_attention, "mamba_scan": mamba_scan}
    reg_runs = {}
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    for family, (ins, cp) in reg_inputs.items():
        for cfg in configs:
            kern = Program.build(cfg).create_kernel(family)
            queue = CommandQueue(Context(Device(cfg), "cuda"))
            kern.set_args(*ins)
            reg_runs[family, cfg.name, "queue"] = (
                queue.enqueue_kernel(kern, counts_params=cp).wait(), None)
            for mode in ("graph", "eager"):
                reg_runs[family, cfg.name, mode] = APU(cfg, device="cuda").offload(
                    [Stage(kern, counts_params=cp)], ins, mode=mode)
    torch.cuda.synchronize()
    reg_wall = time.perf_counter() - t0
    reg_launches = dict(common.LAUNCHES)
    for name in KERNELS:
        want = len(configs) * (1 + 1 + 2) if name in REGISTRY_KERNELS else 0
        check(reg_launches[name] == want,
              f"the registry phase launched {name} {reg_launches[name]} times, "
              f"expected {want}")
    launches.update({name: reg_launches[name] for name in REGISTRY_KERNELS})
    for family, (ins, cp) in reg_inputs.items():
        direct = reg_ops[family](*ins)
        direct = direct if isinstance(direct, tuple) else (direct,)
        cpu_ins = tuple(t.cpu() for t in ins)
        for cfg in configs:
            for mode in ("queue", "graph", "eager"):
                outs, rep = reg_runs[family, cfg.name, mode]
                check(len(outs) == len(direct) and all(
                    o.data.is_cuda and torch.equal(o.data, d_)
                    for o, d_ in zip(outs, direct)),
                    f"{family} {cfg.name} {mode}: result differs from the op's")
                if rep is None:
                    continue
                cpu_kern = Program.build(cfg).create_kernel(family)
                _, crep = APU(cfg, device="cpu").offload(
                    [Stage(cpu_kern, counts_params=cp)], cpu_ins, mode=mode)
                check(dataclasses.asdict(rep) == dataclasses.asdict(crep),
                      f"{family} {cfg.name} {mode}: report differs from the CPU run's")
        rep16 = reg_runs[family, EGPU_16T.name, "graph"][1].stages[0]
        log(f"phase 4c: registry family {family} (4T/8T/16T; queue, graph and "
            f"eager): results equal the op's, reports == CPU reports; 16T "
            f"modeled speed-up {rep16.speedup!r}")
    log(f"phase 4c: registry phase in {reg_wall:.3f} s, launches {reg_launches}")

    # -- 4d. the queue options on the card, with the registry's kernels --------
    # The gemm family (256^3 int32) and the four TinyBio families at the
    # paper's size, on 16T, through three queues: the default one, an
    # unprofiled blocking one and a profiled one with a window of 2 events,
    # the latter two with blocking transfers.  Each family: a write of its
    # first input into a fresh buffer, the kernel, a read of its output.
    # The launch counters are reset just before and read just after.
    fam_x = inputs[0]
    fam_in = {
        "gemm": ((torch.from_numpy(qa).to(dev), torch.from_numpy(qb).to(dev)),
                 {}, {"m": 256, "n": 256, "k": 256}),
        "fir": ((fam_x, h), {}, {"n": fam_x.numel(), "taps": h.numel()}),
        "delineate": ((fir(fam_x, h),), {}, {"n": fam_x.numel()}),
        "stockham_fft": ((fam_x[:128 * 512].reshape(128, 512),), {},
                         {"n": 512}),
        "svm": ((normal(128, sv_main.shape[1]), sv_main, alpha_main,
                 stages[3].consts[2]), {"gamma": 0.5},
                {"q": 128, "m": sv_main.shape[0], "d": sv_main.shape[1]}),
    }
    opt_queues = {
        "default": ({}, False),
        "unprofiled blocking": ({"profile": False, "blocking": True}, True),
        "windowed": ({"profile": True, "max_events": 2}, True),
    }
    prog16 = Program.build(EGPU_16T)
    ctx16 = Context(Device(EGPU_16T), "cuda")
    opt_runs = {}
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    for qname, (qopts, tblock) in opt_queues.items():
        q = CommandQueue(ctx16, **qopts)
        kernel_events, outs = [], {}
        for family, (ins, params, cps) in fam_in.items():
            src = ctx16.create_buffer(torch.empty_like(ins[0]))
            wr = q.enqueue_write_buffer(src, ins[0], blocking=tblock)
            ev = q.enqueue_nd_range(
                prog16.create_kernel(family),
                optimal_ndrange(ins[0].numel(), EGPU_16T),
                (src,) + tuple(ctx16.create_buffer(a) for a in ins[1:]),
                params=params, counts_params=cps)
            ev_done = ev.done
            rd = q.enqueue_read_buffer(ev.outputs[0], blocking=tblock)
            if q.blocking:
                check(ev_done, f"4d {qname}: {family} not done on return")
            if tblock:
                check(wr.done and rd.done and ev.done,
                      f"4d {qname}: {family}: a blocking transfer returned "
                      "before its work was done")
            check(wr.dispatch_s == 0.0 and rd.dispatch_s == 0.0,
                  f"4d {qname}: a transfer booked host dispatch time")
            kernel_events.append(ev)
            outs[family] = tuple(b.data for b in ev.outputs)
        check(q.flush() is None, f"4d {qname}: flush returned something")
        q.finish()
        opt_runs[qname] = (q, kernel_events, outs)
    torch.cuda.synchronize()
    opt_wall = time.perf_counter() - t0
    opt_launches = dict(common.LAUNCHES)
    for name in KERNELS:
        want = len(opt_queues) if name in fam_in else 0
        check(opt_launches[name] == want,
              f"phase 4d launched {name} {opt_launches[name]} times, expected "
              f"{want} (one launch an enqueue)")
    n_cmds = 3 * len(fam_in)
    (q_def, ev_def, out_def) = opt_runs["default"]
    for qname, (q, evs, outs) in opt_runs.items():
        for family, got in outs.items():
            check(len(got) == len(out_def[family]) and all(
                same_bits(a_, b_) for a_, b_ in zip(got, out_def[family])),
                f"4d {qname}: {family} output differs from the default queue's")
        for ev in evs:
            check(ev.dispatch_s > 0.0 and ev.wall_s == ev.dispatch_s,
                  f"4d {qname}: {ev.kernel.name} dispatch_s {ev.dispatch_s}")
    q_unp, ev_unp, _ = opt_runs["unprofiled blocking"]
    check(q_unp.events == () and q_unp.released_count == n_cmds
          and all(e.released and e.modeled is None for e in ev_unp),
          f"4d unprofiled finish: {len(q_unp.events)} events kept, "
          f"{q_unp.released_count} released, expected () and {n_cmds}")
    q_win, ev_win, _ = opt_runs["windowed"]
    check(len(q_win.events) == 2 and q_win.released_count == n_cmds - 2,
          f"4d windowed queue kept {len(q_win.events)} events")
    check((q_win.total_modeled_s(), q_win.total_energy_j())
          == (q_def.total_modeled_s(), q_def.total_energy_j()),
          "4d windowed totals differ from the full-history queue's: "
          f"{q_win.total_modeled_s()!r} s / {q_win.total_energy_j()!r} J vs "
          f"{q_def.total_modeled_s()!r} s / {q_def.total_energy_j()!r} J")
    check(all(e.released and e.dispatch_s > 0.0 for e in ev_win[:-1]),
          "4d windowed queue: released events lost their dispatch_s")
    launches.update({name: launches[name] + opt_launches[name] for name in fam_in})
    # create_buffer: adoption and aliasing of a card tensor, a fresh copy on
    # request, and a CPU tensor that a card context cannot adopt
    card_t = fam_x[:1024]
    for kw in ({"copy": False}, {"use_host_ptr": True}):
        b_ = ctx16.create_buffer(card_t, **kw)
        check(b_.data is card_t and b_.data.data_ptr() == card_t.data_ptr(),
              f"4d create_buffer({kw}) did not alias the card tensor")
    fresh = ctx16.create_buffer(card_t, copy=True).data
    check(fresh.is_cuda and fresh.data_ptr() != card_t.data_ptr()
          and torch.equal(fresh, card_t), "4d create_buffer(copy=True) aliased")
    try:
        ctx16.create_buffer(card_t.cpu(), copy=False)
    except TypeError as e:
        adopt_err = str(e)
    else:
        raise SmokeFailure("4d create_buffer adopted a CPU tensor on the card")
    def_ev = {e.kernel.name: e.dispatch_s for e in ev_def}
    blk_ev = {e.kernel.name: e.dispatch_s for e in ev_unp}
    log(f"phase 4d: queue options on the card (gemm 256^3 int32, fir "
        f"{fam_x.numel()} x {h.numel()}, delineate, fft 128 x 512, svm 128 x "
        f"{sv_main.shape[0]} x {sv_main.shape[1]}; default, unprofiled "
        f"blocking, windowed max_events=2) in {opt_wall:.3f} s: outputs "
        f"bit-equal to the default queue's, blocking events done on return, "
        f"unprofiled finish released {q_unp.released_count}, windowed totals "
        f"== full history ({q_win.total_modeled_s()!r} s, "
        f"{q_win.total_energy_j()!r} J), launches {opt_launches}; "
        f"create_buffer aliases a card tensor, copies on copy=True, refuses a "
        f"CPU tensor ({adopt_err!r})")
    log("phase 4d: dispatch_s per kernel (ms), async / blocking: " + ", ".join(
        f"{k_} {def_ev[k_] * 1e3:.3f} / {blk_ev[k_] * 1e3:.3f}" for k_ in def_ev))
    disp = bench_dispatch.run("cuda")
    us = disp["per_launch_us"]
    log(f"phase 4d: bench_dispatch on the card (chain of {disp['chain_len']} "
        f"{disp['size']}^2 f32 GeMMs, best of {disp['trials']}x{disp['reps']}): "
        f"eager-sync {us['eager-sync']:.3f}, async {us['async']:.3f}, graph "
        f"{us['graph']:.3f} us a kernel; graph {us['async'] / us['graph']:.3f}x "
        f"cheaper than async, {disp['graph_vs_eager_sync_speedup']:.3f}x than "
        f"eager-sync")
    static_rows = bench_static.run()
    check(len(static_rows) == 4 and all(
        math.isfinite(r_[k_]) for r_ in static_rows for k_ in r_ if k_ != "name"),
        "bench_static rows are not 4 rows of finite numbers")
    log("phase 4d: bench_static rows (no device runs them; the CPU tests hold "
        "them == the JAX rows): " + json.dumps(static_rows))

    # -- 5. the LM serving path: qwen2.5-3b, full width and depth, bf16 -----
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer(lm_cfg, init_params(model_spec(lm_cfg), 0, device=dev))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 5: {LM_ARCH}: {lm_cfg.n_layers} layers, d_model "
        f"{lm_cfg.d_model}, {lm_h} heads over {lm_kvh} kv heads of {lm_d}, "
        f"d_ff {lm_cfg.d_ff}, vocab {lm_cfg.vocab} (padded "
        f"{lm_cfg.vocab_padded}); {n_params} parameters in {lm_cfg.dtype}, "
        f"initialised from seed 0 on the card in {time.perf_counter() - t0:.3f} s")
    prompt = np.random.default_rng(0).integers(
        0, lm_cfg.vocab, (LM_BATCH, LM_PROMPT))

    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    tokens = greedy_generate(model, prompt, LM_NEW, LM_MAX_LEN)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    lm_launches = dict(common.LAUNCHES)
    for name in KERNELS:
        want = lm_cfg.n_layers if name in LM_KERNELS else 0
        check(lm_launches[name] == want,
              f"LM main path launched {name} {lm_launches[name]} times, "
              f"expected {want} (one per layer of the prefill, none per "
              f"decode step)")
    launches.update({name: lm_launches[name] for name in LM_KERNELS})
    check(tokens.is_cuda and tokens.dtype == torch.int32
          and tokens.shape == (LM_BATCH, LM_NEW)
          and bool(((tokens >= 0) & (tokens < lm_cfg.vocab)).all()),
          "greedy tokens are not (4, 16) int32 ids below the vocabulary")
    t0 = time.perf_counter()
    again = greedy_generate(model, prompt, LM_NEW, LM_MAX_LEN)
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    check(torch.equal(tokens, again), "greedy tokens differ on a second run")
    log(f"phase 5: greedy_generate {LM_BATCH} x {LM_PROMPT}-token prompts, "
        f"{LM_NEW} new tokens each, max_len {LM_MAX_LEN}: first run "
        f"{first_wall:.3f} s, second {warm_wall:.3f} s, "
        f"{LM_BATCH * LM_NEW / warm_wall:.1f} tokens/s; launches {lm_launches}; "
        f"same tokens on both runs; first request's tokens "
        f"{tokens[0].tolist()}")

    # the steps one at a time: prefill moves flash_attention by one launch
    # per layer, a decode step by none
    prefill_step = make_prefill_step(lm_cfg, LM_MAX_LEN)
    decode_fn = make_decode_step(lm_cfg)
    ptoks = {"tokens": torch.from_numpy(prompt).to(dev)}
    before = common.LAUNCHES["flash_attention"]
    t0 = time.perf_counter()
    logits, cache = prefill_step(model, ptoks)
    torch.cuda.synchronize()
    prefill_wall = time.perf_counter() - t0
    check(common.LAUNCHES["flash_attention"] - before == lm_cfg.n_layers,
          "a prefill did not launch flash_attention once per layer")
    check(logits.shape == (LM_BATCH, lm_cfg.vocab_padded)
          and bool(torch.isfinite(logits[:, :lm_cfg.vocab]).all())
          and bool((logits[:, lm_cfg.vocab:] == -1e30).all()),
          "prefill logits: shape, finiteness or padding columns")
    tok = torch.argmax(logits, -1).to(torch.int32)
    steps = [tok]
    before = common.LAUNCHES["flash_attention"]
    t0 = time.perf_counter()
    for i in range(LM_NEW - 1):
        tok, _, cache = decode_fn(model, cache, tok, LM_PROMPT + i)
        steps.append(tok)
    torch.cuda.synchronize()
    decode_wall = (time.perf_counter() - t0) / (LM_NEW - 1)
    check(common.LAUNCHES["flash_attention"] == before,
          "a decode step launched flash_attention")
    check(torch.equal(torch.stack(steps, 1), tokens),
          "prefill + decode steps differ from greedy_generate")
    log(f"phase 5: prefill wall {prefill_wall * 1e3:.3f} ms "
        f"({LM_BATCH * LM_PROMPT} prompt tokens), decode step wall "
        f"{decode_wall * 1e3:.3f} ms (mean of {LM_NEW - 1}, {LM_BATCH} "
        f"sequences)")
    p_wall, p_busy, p_kernels = device_profile(
        torch, lambda: prefill_step(model, ptoks))
    log("phase 5: " + profile_line("one prefill", p_wall, p_busy, p_kernels))
    library = [k for k in p_kernels
               if any(t in k.lower() for t in LIBRARY_ATTENTION)]
    check(not library, f"the prefill ran library attention kernels: {library}")
    ours = [k for k in p_kernels if any(n in k for n in FLASH_KERNEL_NAMES)]
    check(bool(ours), "the prefill's profile shows no hand-written "
          "flash-attention kernel")
    d_wall, d_busy, d_kernels = device_profile(
        torch, lambda: decode_fn(model, cache, tok, LM_PROMPT + LM_NEW - 1))
    log("phase 5: " + profile_line("one decode step", d_wall, d_busy, d_kernels))
    log(f"phase 5: hand-written attention kernels in the prefill: {ours}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
        f"GiB (the f32 init tree beside the bf16 model included)")
    del model, cache, logits
    torch.cuda.empty_cache()

    # -- 5b. the card against the CPU: a 2-layer cut at full width, f32 ----
    # The same parameters (drawn on the CPU, then copied to the card), the
    # same prompts; decode teacher-forced from the CPU run's tokens.  The
    # card's f32 matmuls (TF32 off) and the kernel sum in another order than
    # the CPU's matmuls and the plain version: prefill logits within 1e-4 of
    # max |logit|; decode within 1e-2, since a key that differs in its last
    # bits can round to the neighbouring bf16 value in the cache (the CPU
    # tests hold the port to the JAX package with the same tolerances).
    cut = dataclasses.replace(lm_cfg, n_layers=2, dtype="float32")
    tree = init_params(model_spec(cut), 0, device="cpu")
    on_cpu = Transformer(cut, tree)
    on_card = Transformer(cut, map_tree(lambda t: t.to(dev), tree))
    prompt2 = torch.from_numpy(np.random.default_rng(1).integers(
        0, cut.vocab, (2, 64)))

    def run_cut(m, device, feed=None):
        """Prefill + 4 decode steps; each step is fed ``feed[i]`` or, with
        no feed, this run's own greedy token.  -> (logits, tokens) on the
        CPU."""
        lg, c = prefill(m, {"tokens": prompt2.to(device)}, 128)
        out_logits, out_tokens = [lg.cpu()], [torch.argmax(lg, -1).cpu()]
        for i in range(4):
            tok_in = out_tokens[-1] if feed is None else feed[i]
            lg, c = decode_step(m, c, tok_in.to(device), 64 + i)
            out_logits.append(lg.cpu())
            out_tokens.append(torch.argmax(lg, -1).cpu())
        return out_logits, out_tokens

    cpu_logits, cpu_tokens = run_cut(on_cpu, "cpu")
    before = common.LAUNCHES["flash_attention"]
    card_logits, card_tokens = run_cut(on_card, dev, feed=cpu_tokens)
    check(common.LAUNCHES["flash_attention"] - before == cut.n_layers,
          "the 2-layer card run did not launch flash_attention per layer")
    cut_err = []
    for i, (g, w) in enumerate(zip(card_logits, cpu_logits)):
        rtol = 1e-4 if i == 0 else 1e-2
        scale = float(w[:, :cut.vocab].abs().max())
        e = err(g[:, :cut.vocab], w[:, :cut.vocab])
        cut_err.append(e / scale)
        check(e <= rtol * scale, f"card vs CPU logits, step {i}: error {e} "
              f"against max |logit| {scale}")
    check(all(torch.equal(g, w) for g, w in zip(card_tokens, cpu_tokens)),
          "card and CPU greedy tokens differ")
    log("phase 5b: 2-layer full-width f32 cut, card vs CPU: greedy tokens "
        "equal over prefill + 4 decode steps; logits error / max |logit| "
        + ", ".join(f"{e:.3g}" for e in cut_err))
    del on_card
    torch.cuda.empty_cache()

    # -- 6. the rwkv serving path: rwkv6-3b, full width and depth, bf16 ----
    # 32 layers of 40 heads of 64, random weights from seed 0 on the card
    # (the qwen model above is freed first).  rwkv6_scan must launch once
    # per layer in the prefill and once per layer in every decode step, and
    # no other kernel of ours.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rw_model = Transformer(rw_cfg, init_params(model_spec(rw_cfg), 0, device=dev))
    torch.cuda.synchronize()
    rw_params = sum(p_.numel() for p_ in rw_model.parameters())
    log(f"phase 6: {RWKV_ARCH}: {rw_cfg.n_layers} layers, d_model "
        f"{rw_cfg.d_model}, {rw_h} heads of {rw_d}, d_ff {rw_cfg.d_ff}, vocab "
        f"{rw_cfg.vocab}; {rw_params} parameters in the model's tree "
        f"(ModelConfig.param_count() says {rw_cfg.param_count()}: it counts "
        f"the decay lora at rank 32, the spec at 64), {rw_cfg.dtype}, "
        f"initialised from seed 0 on the card in {time.perf_counter() - t0:.3f} s")
    rw_prompt = np.random.default_rng(0).integers(
        0, rw_cfg.vocab, (RWKV_BATCH, RWKV_PROMPT))
    n_layers = rw_cfg.n_layers

    def only_rwkv(moved, want, what):
        for name in KERNELS:
            expect = want if name in RWKV_KERNELS else 0
            check(moved[name] == expect,
                  f"{what} launched {name} {moved[name]} times, expected {expect}")

    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    rw_tokens = greedy_generate(rw_model, rw_prompt, RWKV_NEW, RWKV_MAX_LEN)
    torch.cuda.synchronize()
    rw_first = time.perf_counter() - t0
    rw_launches = dict(common.LAUNCHES)
    only_rwkv(rw_launches, n_layers * RWKV_NEW,
              "the rwkv main path (one prefill and 15 decode steps)")
    launches.update({name: rw_launches[name] for name in RWKV_KERNELS})
    check(rw_tokens.is_cuda and rw_tokens.dtype == torch.int32
          and rw_tokens.shape == (RWKV_BATCH, RWKV_NEW)
          and bool(((rw_tokens >= 0) & (rw_tokens < rw_cfg.vocab)).all()),
          "rwkv greedy tokens are not (4, 16) int32 ids below the vocabulary")
    t0 = time.perf_counter()
    rw_again = greedy_generate(rw_model, rw_prompt, RWKV_NEW, RWKV_MAX_LEN)
    torch.cuda.synchronize()
    rw_warm = time.perf_counter() - t0
    check(torch.equal(rw_tokens, rw_again), "rwkv greedy tokens differ on a second run")
    log(f"phase 6: greedy_generate {RWKV_BATCH} x {RWKV_PROMPT}-token prompts, "
        f"{RWKV_NEW} new tokens each: first run {rw_first:.3f} s, second "
        f"{rw_warm:.3f} s, {RWKV_BATCH * RWKV_NEW / rw_warm:.1f} tokens/s; "
        f"launches {rw_launches}; same tokens on both runs; first request's "
        f"tokens {rw_tokens[0].tolist()}")

    # the steps one at a time: the prefill and each decode step move
    # rwkv6_scan by one launch per layer
    rw_prefill_step = make_prefill_step(rw_cfg, RWKV_MAX_LEN)
    rw_decode_fn = make_decode_step(rw_cfg)
    rw_ptoks = {"tokens": torch.from_numpy(rw_prompt).to(dev)}
    before = dict(common.LAUNCHES)
    t0 = time.perf_counter()
    rw_logits, rw_cache = rw_prefill_step(rw_model, rw_ptoks)
    torch.cuda.synchronize()
    rw_prefill_wall = time.perf_counter() - t0
    only_rwkv({k_: common.LAUNCHES[k_] - before[k_] for k_ in before}, n_layers,
              "an rwkv prefill")
    check(rw_logits.shape == (RWKV_BATCH, rw_cfg.vocab_padded)
          and bool(torch.isfinite(rw_logits[:, :rw_cfg.vocab]).all()),
          "rwkv prefill logits: shape or finiteness")
    tok = torch.argmax(rw_logits, -1).to(torch.int32)
    steps = [tok]
    step_walls = []
    for i in range(RWKV_NEW - 1):
        before = dict(common.LAUNCHES)
        t0 = time.perf_counter()
        tok, _, rw_cache = rw_decode_fn(rw_model, rw_cache, tok, RWKV_PROMPT + i)
        torch.cuda.synchronize()
        step_walls.append(time.perf_counter() - t0)
        only_rwkv({k_: common.LAUNCHES[k_] - before[k_] for k_ in before},
                  n_layers, f"rwkv decode step {i}")
        steps.append(tok)
    check(torch.equal(torch.stack(steps, 1), rw_tokens),
          "rwkv prefill + decode steps differ from greedy_generate")
    rw_decode_wall = sum(step_walls) / len(step_walls)
    log(f"phase 6: prefill wall {rw_prefill_wall * 1e3:.3f} ms "
        f"({RWKV_BATCH * RWKV_PROMPT} prompt tokens), decode step wall "
        f"{rw_decode_wall * 1e3:.3f} ms (mean of {RWKV_NEW - 1}, {RWKV_BATCH} "
        f"sequences); {n_layers} rwkv6_scan launches per prefill and per step")
    rp_wall, rp_busy, rp_kernels = device_profile(
        torch, lambda: rw_prefill_step(rw_model, rw_ptoks))
    log("phase 6: " + profile_line("one rwkv prefill", rp_wall, rp_busy, rp_kernels))
    check(any("rwkv6_kernel" in k_ for k_ in rp_kernels),
          "the rwkv prefill's profile shows no rwkv6_kernel")
    scan_us = sum(v_ for k_, v_ in rp_kernels.items() if "rwkv6_kernel" in k_)
    log(f"phase 6: rwkv6_kernel in the profiled prefill: {scan_us / 1e3:.4f} ms "
        f"for {n_layers} launches, of {rp_busy * 1e3:.4f} ms busy")
    rd_wall, rd_busy, rd_kernels = device_profile(
        torch, lambda: rw_decode_fn(rw_model, rw_cache, tok,
                                    RWKV_PROMPT + RWKV_NEW - 1))
    log("phase 6: " + profile_line("one rwkv decode step", rd_wall, rd_busy, rd_kernels))
    check(any("rwkv6_step_kernel" in k_ for k_ in rd_kernels),
          "the rwkv decode step's profile shows no rwkv6_step_kernel")
    log(f"phase 6: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB (the f32 init "
        f"tree beside the bf16 model included)")
    del rw_model, rw_cache, rw_logits
    torch.cuda.empty_cache()

    # -- 6b. the card against the CPU: a 2-layer rwkv cut at full width, f32
    # The same parameters on both, the same prompts; decode teacher-forced
    # from the CPU run's tokens.  The tolerances of phase 5b: prefill logits
    # within 1e-4 of max |logit|, decode within 1e-2.
    rw_cut = dataclasses.replace(rw_cfg, n_layers=2, dtype="float32")
    rw_tree = init_params(model_spec(rw_cut), 0, device="cpu")
    rw_cpu = Transformer(rw_cut, rw_tree)
    rw_card = Transformer(rw_cut, map_tree(lambda t: t.to(dev), rw_tree))
    # run_cut (phase 5b) reads prompt2 when called: ids below rwkv's vocab
    prompt2 = torch.from_numpy(np.random.default_rng(1).integers(
        0, rw_cut.vocab, (2, 64)))
    before = common.LAUNCHES["rwkv6_scan"]
    cpu_logits, cpu_tokens = run_cut(rw_cpu, "cpu")
    card_logits, card_tokens = run_cut(rw_card, dev, feed=cpu_tokens)
    check(common.LAUNCHES["rwkv6_scan"] - before == rw_cut.n_layers * 5,
          "the 2-layer rwkv card run did not launch rwkv6_scan per layer and step")
    rw_cut_err = []
    for i, (g, w_) in enumerate(zip(card_logits, cpu_logits)):
        rtol = 1e-4 if i == 0 else 1e-2
        scale = float(w_[:, :rw_cut.vocab].abs().max())
        e = err(g[:, :rw_cut.vocab], w_[:, :rw_cut.vocab])
        rw_cut_err.append(e / scale)
        check(e <= rtol * scale, f"rwkv card vs CPU logits, step {i}: error {e} "
              f"against max |logit| {scale}")
    check(all(torch.equal(g, w_) for g, w_ in zip(card_tokens, cpu_tokens)),
          "rwkv card and CPU greedy tokens differ")
    log("phase 6b: 2-layer full-width f32 rwkv cut, card vs CPU: greedy tokens "
        "equal over prefill + 4 decode steps; logits error / max |logit| "
        + ", ".join(f"{e:.3g}" for e in rw_cut_err))
    del rw_card
    torch.cuda.empty_cache()

    # -- 7. TinyBio served on the card, at full size -----------------------------
    # Server over two lanes (16T and 8T), exact-fit bucket (the features
    # reduce over the whole signal), micro-batches of 4, warmed up first; 16
    # requests from synth_signal(n, seed), seeds 0..15.  The counters are
    # reset just before the served run and read just after it.
    from repro_torch.obs import Tracer, validate_chrome_trace
    from repro_torch.serve import Blackout, FaultPlan, QueueWorker, Server
    n_sig = x.numel()
    serve_stages, _ = tinybio.tinybio_stages(EGPU_16T, 0, dev)
    cpu_serve_stages, _ = tinybio.tinybio_stages(EGPU_16T, 0, "cpu")
    signals = [tinybio.synth_signal(n_sig, s_) for s_ in range(16)]
    serve_batch = 4

    class VClock:
        """A virtual clock: the serving timeline becomes the machine
        model's, so reports of two runs compare with ==."""
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            return self.t

    def make_server(device, **kw):
        return Server(serve_stages if device == "cuda" else cpu_serve_stages,
                      workers=(QueueWorker(EGPU_16T, device=device),
                               QueueWorker(EGPU_8T, device=device)),
                      bucket_sizes=(n_sig,), max_batch=serve_batch,
                      device=device, **kw)

    def serve(srv, vclock=None):
        rids = []
        for i_, sig_ in enumerate(signals):
            if vclock is not None:
                vclock.t = 1e-4 * i_
            rids.append(srv.submit(sig_))
        if vclock is not None:
            vclock.t = 1e-4 * len(signals) + 1e-3
        srv.flush()
        return [srv.result(r_) for r_ in rids]

    srv = make_server("cuda")
    warmed = srv.warmup(signals[0])
    check(warmed == 2 and srv.cache.misses == 2,
          f"warmup captured {warmed} graphs, expected 2 (2 lanes x 1 bucket)")
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    served = serve(srv)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    serve_launches = dict(common.LAUNCHES)
    n_batches = len(signals) // serve_batch
    for name in KERNELS:
        want = n_batches if name in TINYBIO_KERNELS else 0
        check(serve_launches[name] == want,
              f"served TinyBio launched {name} {serve_launches[name]} times, "
              f"expected {want} (one launch a stage a micro-batch)")
    check(srv.cache.misses == 2 and srv.cache.hits == n_batches,
          f"served TinyBio cache {srv.cache.stats()}: a miss after warmup")
    # every request's outputs bit-equal to APU.offload of it alone on the card
    apu_serve = APU(EGPU_16T, device="cuda")
    offload_walls = []
    for i_, sig_ in enumerate(signals):
        sx = torch.from_numpy(sig_).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_outs, _ = apu_serve.offload(serve_stages, (sx,))
        torch.cuda.synchronize()
        offload_walls.append(time.perf_counter() - t0)
        (got_,) = served[i_]
        check(got_.is_cuda and got_.shape == (128,) and bool(torch.isfinite(got_).all()),
              f"served request {i_}: not 128 finite decisions on the card")
        check(same_bits(got_, ref_outs[0].data),
              f"served request {i_} differs from its own APU.offload")
    rep_main = srv.report()
    log(f"phase 7: served {len(signals)} TinyBio requests (n={n_sig}) over lanes "
        f"{[w_.name for w_ in srv.dispatcher.workers]} in {n_batches} micro-batches "
        f"of {serve_batch}: launches {serve_launches}; cache {srv.cache.stats()}; "
        f"every request bit-equal to its own APU.offload on the card")
    # modeled fields on a virtual clock: the card's run equals the CPU's
    measured = ("wall_s", "requests_per_s", "goodput_per_s")

    def modeled(rep_):
        return {k_: v_ for k_, v_ in dataclasses.asdict(rep_).items() if k_ not in measured}

    vc_card, vc_cpu = VClock(), VClock()
    srv_vc = make_server("cuda", clock=vc_card)
    srv_vc.warmup(signals[0])
    outs_vc = serve(srv_vc, vc_card)
    srv_cpu = make_server("cpu", clock=vc_cpu)
    srv_cpu.warmup(signals[0])
    outs_cpu = serve(srv_cpu, vc_cpu)
    check(modeled(srv_vc.report()) == modeled(srv_cpu.report()),
          "served TinyBio: a modeled ServeReport field differs between card and CPU")
    check(all(same_bits(a_[0], b_[0]) for a_, b_ in zip(outs_vc, served)),
          "served TinyBio on a virtual clock differs from the real-clock run")
    dec_err = max(err(a_[0].cpu(), b_[0]) for a_, b_ in zip(outs_vc, outs_cpu))
    check(dec_err <= 1e-6, f"served decisions card vs CPU differ by {dec_err}")
    # a traced twin: complete request trees, a valid Chrome trace, the bits
    # and modeled report of the untraced run
    tracer = Tracer()
    vc_tr = VClock()
    srv_tr = make_server("cuda", clock=vc_tr, tracer=tracer)
    srv_tr.warmup(signals[0])
    outs_tr = serve(srv_tr, vc_tr)
    tree_errors = tracer.validate_request_trees()
    check(tree_errors == [], f"traced serving: request trees {tree_errors[:3]}")
    trace_doc = tracer.to_chrome_json()
    schema_errors = validate_chrome_trace(trace_doc)
    check(schema_errors == [], f"traced serving: chrome trace {schema_errors[:3]}")
    check(all(same_bits(a_[0], b_[0]) for a_, b_ in zip(outs_tr, outs_vc)),
          "traced serving changed the outputs")
    check(modeled(srv_tr.report()) == modeled(srv_vc.report()),
          "tracing perturbed the modeled report")
    # faults: the 16T lane blacked out for its first two launches plus
    # seeded launch failures; every failed attempt retries on a lane, and
    # the retried batches give the fault-free bits
    plan = FaultPlan(seed=0, p_launch_fail=0.25,
                     blackouts=(Blackout("e-gpu-16t", 0, 2),))
    vc_f = VClock()
    srv_f = make_server("cuda", clock=vc_f, fault_plan=plan)
    srv_f.warmup(signals[0])
    outs_f = serve(srv_f, vc_f)
    rep_f = srv_f.report()
    check(rep_f.n_retries > 0 and rep_f.n_shed == 0 and rep_f.n_requests == len(signals),
          f"fault run: {rep_f.n_retries} retries, {rep_f.n_shed} shed, "
          f"{rep_f.n_requests} served")
    check(all(same_bits(a_[0], b_[0]) for a_, b_ in zip(outs_f, outs_vc)),
          "retried batches differ from the fault-free run")
    log(f"phase 7: virtual clock: every modeled ServeReport field == the CPU run's "
        f"(decisions card vs CPU within {dec_err:.3g}); traced twin: "
        f"{len(tracer.spans)} spans, {len(tracer.request_rids())} complete request "
        f"trees, Chrome trace valid, bits and report unperturbed; fault run: "
        f"{plan.injected_failures} injected failures, {rep_f.n_retries} retries, "
        f"{rep_f.n_quarantines} quarantines, 0 shed, bits equal")
    # where one warm batch launch's time goes (submit 4 requests -> one
    # launch, flush retires it), beside a warm APU.offload graph wall
    batch_prof = device_profile(torch, lambda: (
        [srv.submit(sig_) for sig_ in signals[:serve_batch]], srv.flush()))
    sx0 = torch.from_numpy(signals[0]).to(dev)
    offload_prof = device_profile(torch, lambda: apu_serve.offload(serve_stages, (sx0,)))
    log(f"phase 7: serving wall {serve_wall * 1e3:.3f} ms for {len(signals)} requests: "
        f"{serve_wall / len(signals) * 1e3:.3f} ms a request, "
        f"{len(signals) / serve_wall:.1f} requests/s (report: "
        f"{rep_main.requests_per_s:.1f}); per-request APU.offload graph wall (host "
        f"capture included) median {sorted(offload_walls)[len(offload_walls) // 2] * 1e3:.3f} ms, "
        f"min {min(offload_walls) * 1e3:.3f} ms")
    log("phase 7: " + profile_line("one warm served micro-batch of 4 (submit + "
                                   "launch + retire)", *batch_prof))
    log("phase 7: " + profile_line("one warm 16T APU.offload graph of one request",
                                   *offload_prof))
    launches.update({name: launches[name] + serve_launches[name]
                     for name in TINYBIO_KERNELS})

    # -- 7b. the overload and power serving benches on the card ---------------
    # Every modeled row (the whole result) must equal the same bench's CPU
    # run; the benches' own gates and bit-identity asserts hold inside run().
    for bench in (bench_overload, bench_power):
        t0 = time.perf_counter()
        on_card = bench.run("cuda")
        torch.cuda.synchronize()
        card_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = bench.run("cpu")
        cpu_wall = time.perf_counter() - t0
        for key in on_cpu:
            check(on_card[key] == on_cpu[key],
                  f"{bench.__name__} {key}: {on_card[key]} on the card, "
                  f"{on_cpu[key]} on the CPU")
        log(f"phase 7b: {bench.__name__.rsplit('.', 1)[-1]}: every modeled row "
            f"== the CPU run's; wall {card_wall:.3f} s on the card, "
            f"{cpu_wall:.3f} s on the CPU; " + json.dumps(
                {k_: on_card[k_] for k_ in (
                    "goodput_vs_fifo_speedup", "goodput_faulted_vs_fifo_speedup",
                    "n_bit_identity_checked", "goodput_per_watt_speedup",
                    "n_power_throttled") if k_ in on_card}))

    # -- 8. summary ---------------------------------------------------------------
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
