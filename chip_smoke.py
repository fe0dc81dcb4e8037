#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. card and build — prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them, and builds the CUDA kernels from ``src/repro_torch/csrc`` with the
   toolkit's ``nvcc`` (one process per source, all at once);
2. each kernel against its plain PyTorch version, on the card, at TinyBio's
   shapes plus a ragged size, with the tolerance stated beside each check;
   every call must move the kernel's launch counter by one;
3. kernel timings at TinyBio's shapes: device time per call from CUDA
   events around replays of a CUDA graph of many warm calls, for the
   kernel, its plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``); the eager cost per call, host
   dispatch included, is logged beside them.  ``bound_ms`` is the least time
   the card could take, from the bytes and flops of this run's inputs;
4. the main path — ``run_tinybio`` on the card for the 4T, 8T and 16T
   configs, in graph and eager mode, at the paper's full workload — with
   the launch counters reset just before and read just after: each kernel
   must have launched once per graph offload and twice per eager one.  The
   decisions of graph and eager must agree bitwise, every report must equal
   the CPU run's field for field, and every stage's output must match the
   CPU run's within the stated tolerances;
5. one ``{"kernels": [...]}`` line, then, last, ``{"ok": true, "device":
   {...}}``.

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

KERNELS = {
    "fir": ("src/repro_torch/csrc/fir.cu", "src/repro/kernels/fir/fir.py:27"),
    "delineate": ("src/repro_torch/csrc/delineate.cu",
                  "src/repro/kernels/delineate/delineate.py:22"),
    "stockham_fft": ("src/repro_torch/csrc/stockham_fft.cu",
                     "src/repro/kernels/stockham_fft/stockham_fft.py:29"),
    "svm": ("src/repro_torch/csrc/svm.cu", "src/repro/kernels/svm/svm.py:22"),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.apps import tinybio
        from repro_torch.core import EGPU_4T, EGPU_8T, EGPU_16T
        from repro_torch.kernels import common
        from repro_torch.kernels.delineate.ops import delineate
        from repro_torch.kernels.delineate.ref import delineate_ref
        from repro_torch.kernels.fir.ops import fir
        from repro_torch.kernels.fir.ref import fir_ref
        from repro_torch.kernels.stockham_fft.ops import fft
        from repro_torch.kernels.stockham_fft.ref import stockham_fft_ref
        from repro_torch.kernels.svm.ops import svm_decision
        from repro_torch.kernels.svm.ref import svm_decision_ref
    except ImportError as e:
        print(f"chip_smoke: cannot import the port from {ROOT / 'src'}: {e}",
              file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    # Full fp32 everywhere: the plain SVM's matmul and the conv1d yardstick
    # would otherwise be allowed TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. card and build --------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
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

    # fir, f32: same taps order and roundings as the plain version, so the
    # expected error is 0; tolerance 1e-6 (a few ulps of |y| <= 1.5)
    y = launched("fir", lambda: fir(x, h))
    max_err["fir"] = err(y, fir_ref(x, h))
    check(max_err["fir"] <= 1e-6, f"fir f32 error {max_err['fir']}")
    xr = torch.from_numpy(rng.standard_normal(1000).astype(np.float32)).to(dev)
    hr = torch.from_numpy(rng.standard_normal(33).astype(np.float32) / 33).to(dev)
    check(err(launched("fir", lambda: fir(xr, hr)), fir_ref(xr, hr)) <= 1e-6,
          "fir f32 ragged")
    # fir, int16 signal with Q15 int16 taps: exact
    xi = torch.from_numpy(rng.integers(-2 ** 15, 2 ** 15, 65_536).astype(np.int16)).to(dev)
    hi = torch.from_numpy(rng.integers(-2 ** 15, 2 ** 15, 128).astype(np.int16)).to(dev)
    check(torch.equal(launched("fir", lambda: fir(xi, hi)), fir_ref(xi, hi)),
          "fir Q15 int16 not exact")
    check(torch.equal(launched("fir", lambda: fir(xi[:1001], hi[:17])),
                      fir_ref(xi[:1001], hi[:17])), "fir Q15 ragged not exact")
    log(f"phase 2: fir ok (f32 max abs err {max_err['fir']:.3g}, Q15 exact)")

    # delineate: exact, on the FIR output and on a ragged int16 signal
    flags = launched("delineate", lambda: delineate(y, 0))
    check(torch.equal(flags, delineate_ref(y, 0)), "delineate not exact")
    max_err["delineate"] = 0.0
    xd = (xi[:1001] // 512).contiguous()
    check(torch.equal(launched("delineate", lambda: delineate(xd, 3)),
                      delineate_ref(xd, 3)), "delineate int16 ragged")
    check(torch.equal(launched("delineate", lambda: delineate(xr, 0.25)),
                      delineate_ref(xr, 0.25)), "delineate f32 ragged")
    log(f"phase 2: delineate ok (exact, {int((flags != 0).sum())} extrema)")

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
    log(f"phase 2: stockham_fft ok (max abs err {max_err['stockham_fft']:.3g}, "
        f"max |X| {scale:.4g})")

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
    log(f"phase 2: svm ok (max abs err {max_err['svm']:.3g})")

    # -- 3. timings at TinyBio's shapes ------------------------------------
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

    # -- 4. the main path ------------------------------------------------------
    configs = (EGPU_4T, EGPU_8T, EGPU_16T)
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
        check(launches[name] == expected,
              f"main path launched {name} {launches[name]} times, "
              f"expected {expected}")
    log(f"phase 4: main path (3 configs x graph + eager) in {wall:.3f} s "
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
    from torch.profiler import ProfilerActivity, profile
    tinybio.run_tinybio(EGPU_16T, 0, "graph", device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tinybio.run_tinybio(EGPU_16T, 0, "graph", device="cuda")
        torch.cuda.synchronize()
        offload_s = time.perf_counter() - t0
    # Only the device-side events (kernels and copies): a CPU op's row
    # would count its kernels' time a second time.  Busy time is the union
    # of their intervals on the card's clock.
    from torch.autograd import DeviceType
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
    busy_s = busy_us * 1e-6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    log(f"phase 4: one warm 16T graph offload: wall {offload_s * 1e3:.3f} ms, "
        f"device busy {busy_s * 1e3:.4f} ms, idle share "
        f"{'not measured' if busy_s == 0 else f'{1 - busy_s / offload_s:.4f}'}; "
        f"device us by kernel: "
        + "; ".join(f"{k[:60]} {v:.1f}" for k, v in top))

    # -- 5. summary ---------------------------------------------------------------
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
