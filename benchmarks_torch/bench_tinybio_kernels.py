"""Device time of TinyBio's four kernels on one card, at TinyBio's shapes and
beside them at larger ones, with the card's launch floor (an empty kernel,
``csrc/launch_floor.cu``).

* ``fir`` f32 and Q15 int16 (128 taps) and ``delineate`` f32 and int16, at
  n = 65,536 (TinyBio's) and 2^20;
* ``svm`` at q 128, m 256, d 36 (TinyBio's) and q 1024, m 1024, d 36;
* ``fft`` and ``power_spectrum`` at 128 windows of 512 (TinyBio's) and of
  4096.

Run from the root of a checkout, on a machine with a card::

    python3 benchmarks_torch/bench_tinybio_kernels.py [--src DIR] [--sweep]

``--src`` names the ``src`` directory of another tree (another commit
unpacked beside this checkout).  Its ``repro_torch`` is loaded beside this
tree's under another name, with its own kernel library built from its own
sources, and both are timed in one process, in turns (other, this, this,
other).  Each row names its tree; ``compare`` rows report whether this
tree's outputs equal the other tree's bit for bit: ``fir`` f32 and Q15 at
taps 1, 3, 17, 33, 127, 128, 129 and 4096 on a ragged n, ``delineate``
flags for f32, int16 and int32, ``fft`` and ``power_spectrum`` at both
shapes and ``fft`` at every n = 1 .. 8192; for ``svm`` how far the two
outputs lie apart.

``--sweep`` times this tree's ``fir`` at every outputs-a-thread count and
block size the kernel takes (``FirPlan``; f32 and Q15 at 128 taps), at
n = 65,536 and 2^20, and prints the plan ``plan_fir`` would take beside
them.

Device ms per call come from CUDA events around 20 replays of a CUDA graph
of 100 calls (``chip_smoke.device_ms``); bounds as ``chip_smoke.py``
computes them (for ``fir`` also the bound of its bits: an FMUL and an FADD,
or one IMAD, per tap and output).  Inputs are made with numpy from seed 0.
Prints one JSON object per row and writes no file.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: (q, m, d) of the svm and (windows, n) of the fft rows
SVM_SHAPES = ((128, 256, 36), (1024, 1024, 36))
FFT_SHAPES = ((128, 512), (128, 4096))
#: signal lengths of the fir and delineate rows, and fir's taps
SIGNALS = (65_536, 1 << 20)
TAPS = 128
#: taps of the fir compare rows, on a ragged signal of COMPARE_N samples
COMPARE_TAPS = (1, 3, 17, 33, 127, 128, 129, 4096)
COMPARE_N = 10_007
#: block sizes of the sweep (fir takes at most 256 threads a block; 125 is
#: what plan_fir gives at TinyBio's 65,536 samples)
FIR_THREADS = (32, 64, 125, 128, 256)


def load_tree(src: Path, name: str):
    """The ``repro_torch`` package under ``src``, imported as ``name``."""
    init = src / "repro_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def kernels_of(package: str) -> dict:
    """The TinyBio kernels' wrappers of a package, and its
    ``kernels.common``."""
    svm = importlib.import_module(f"{package}.kernels.svm.ops")
    fft = importlib.import_module(f"{package}.kernels.stockham_fft.ops")
    fir = importlib.import_module(f"{package}.kernels.fir.ops")
    dl = importlib.import_module(f"{package}.kernels.delineate.ops")
    common = importlib.import_module(f"{package}.kernels.common")
    return dict(svm=svm.svm_decision, fft=fft.fft,
                power_spectrum=fft.power_spectrum, fir=fir.fir,
                delineate=dl.delineate, common=common)


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=None)
    parser.add_argument("--sweep", action="store_true")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bench_tinybio_kernels: needs a card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import (bound, device_ms, fir_bits_bound, launch_floor,
                            nvidia_smi)

    torch.backends.cuda.matmul.allow_tf32 = False
    print(nvidia_smi("name,power.limit"), flush=True)
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    trees = {"this": kernels_of("repro_torch")}
    if args.src:
        load_tree(Path(args.src).resolve(), "repro_torch_other")
        trees["other"] = kernels_of("repro_torch_other")
    for label, k in trees.items():
        info = k["common"].build_kernels()
        print(f"{label}: kernels built in {info['seconds']:.1f} s", flush=True)
    rng = np.random.default_rng(0)

    def on(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    def bits(t):
        return t.contiguous().view(torch.int32)

    order = ["other", "this", "this", "other"] if args.src else ["this"]
    floor = launch_floor(trees["this"]["common"])
    for blocks, threads in ((1, 32), (128, 256)):
        emit(kernel="launch_floor", blocks=blocks, threads=threads,
             ms=device_ms(torch, lambda: floor(blocks, threads), 100))

    # fir and delineate at TinyBio's n and at 2^20
    for n in SIGNALS:
        xf = on(rng.standard_normal(n))
        hf = on(rng.standard_normal(TAPS) / TAPS)
        xi = on(rng.integers(-2 ** 15, 2 ** 15, n), np.int16)
        hi = on(rng.integers(-2 ** 15, 2 ** 15, TAPS), np.int16)
        for what, x, h, itemsize in (("fir f32", xf, hf, 4),
                                     ("fir q15 int16", xi, hi, 2)):
            b_ms, b_by = bound(itemsize * (2.0 * n + TAPS), 2.0 * n * TAPS)
            bits_ms = fir_bits_bound(n, TAPS, sms, max_sm_mhz)
            for label in order:
                fir = trees[label]["fir"]
                emit(tree=label, kernel=what, n=n, taps=TAPS,
                     ms=device_ms(torch, lambda: fir(x, h), 100),
                     bound_ms=b_ms, bound_by=b_by, bits_bound_ms=bits_ms)
        yd = trees["this"]["fir"](xf, hf)
        yi = (xi // 512).contiguous()
        for what, x, itemsize in (("delineate f32", yd, 4),
                                  ("delineate int16", yi, 2)):
            b_ms, b_by = bound((itemsize + 1.0) * n, 7.0 * n)
            for label in order:
                dl = trees[label]["delineate"]
                emit(tree=label, kernel=what, n=n,
                     ms=device_ms(torch, lambda: dl(x, 0), 100),
                     bound_ms=b_ms, bound_by=b_by)

    if args.src:
        unequal = []
        for taps in COMPARE_TAPS:
            for kind in ("f32", "q15"):
                if kind == "f32":
                    x = on(rng.standard_normal(COMPARE_N))
                    h = on(rng.standard_normal(taps) / taps)
                else:
                    x = on(rng.integers(-2 ** 15, 2 ** 15, COMPARE_N), np.int16)
                    h = on(rng.integers(-2 ** 15, 2 ** 15, taps), np.int16)
                got, want = (trees[t]["fir"](x, h) for t in ("this", "other"))
                same = (torch.equal(bits(got), bits(want)) if kind == "f32"
                        else torch.equal(got, want))
                if not same:
                    unequal.append([kind, taps])
        emit(compare="fir", n=COMPARE_N, taps=list(COMPARE_TAPS),
             kinds=["f32", "q15 int16"], bit_equal=not unequal, unequal=unequal)
        unequal = []
        for dtype in (np.float32, np.int16, np.int32):
            for n in (COMPARE_N, 65_536, 7):
                xs = (np.sin(np.arange(n) / 9.0) * 20
                      + 3 * rng.standard_normal(n)).astype(dtype)
                x = on(xs, dtype)
                for thr in (0, 3, 2.7):
                    got, want = (trees[t]["delineate"](x, thr)
                                 for t in ("this", "other"))
                    if not torch.equal(got, want):
                        unequal.append([np.dtype(dtype).name, n, thr])
        emit(compare="delineate", dtypes=["float32", "int16", "int32"],
             n=[COMPARE_N, 65_536, 7], thr=[0, 3, 2.7], bit_equal=not unequal,
             unequal=unequal)

    if args.sweep:
        from repro_torch.kernels.fir.fir import ROWS, FirPlan, launch_fir, plan_fir
        for n in SIGNALS:
            for kind in ("f32", "q15 int16"):
                if kind == "f32":
                    x, h = on(rng.standard_normal(n)), on(rng.standard_normal(TAPS) / TAPS)
                else:
                    x = on(rng.integers(-2 ** 15, 2 ** 15, n), np.int16)
                    h = on(rng.integers(-2 ** 15, 2 ** 15, TAPS), np.int16)
                y = torch.empty_like(x)
                ms = {}
                for rows in ROWS:
                    for threads in FIR_THREADS:
                        plan = FirPlan(rows, threads)
                        ms[rows, threads] = device_ms(
                            torch, lambda: launch_fir(x, h, y, plan), 100)
                emit(sweep="fir", kind=kind, n=n, taps=TAPS,
                     plan=list(plan_fir(n, TAPS, sms)),
                     ms={f"{r}x{t}": v for (r, t), v in ms.items()},
                     best=list(min(ms, key=ms.get)), best_ms=min(ms.values()))

    for q, m, d in SVM_SHAPES:
        xn = rng.uniform(-1, 1, (q, d))
        # support vectors near the queries, so the RBF values are not all 0
        sv = on(xn[rng.integers(0, q, m)] + 0.2 * rng.standard_normal((m, d)))
        x, alpha = on(xn), on(rng.standard_normal(m) / m)
        b = torch.tensor(0.1, device=dev)
        b_ms, b_by = bound(4.0 * (q * d + m * d + m + q),
                           2.0 * q * m * d + 2.0 * (q + m) * d + 8.0 * q * m)
        outs = {}
        for label in order:
            svm = trees[label]["svm"]
            outs[label] = svm(x, sv, alpha, b, 0.5)
            emit(tree=label, kernel="svm", q=q, m=m, d=d,
                 ms=device_ms(torch, lambda: svm(x, sv, alpha, b, 0.5), 100),
                 bound_ms=b_ms, bound_by=b_by)
        if args.src:
            emit(compare="svm", q=q, m=m, d=d, max_abs_diff=float(
                (outs["this"] - outs["other"]).abs().max()))

    for windows, n in FFT_SHAPES:
        w = on(rng.standard_normal((windows, n)))
        flops = 10.0 * windows * (n // 2) * int(math.log2(n))
        outs = {}
        for label in order:
            fft, power_spectrum = trees[label]["fft"], trees[label]["power_spectrum"]
            outs[label] = (*fft(w), power_spectrum(w))
            for what, fn, nbytes, ops in (
                    ("fft", lambda: fft(w), 4.0 * 3 * windows * n, flops),
                    ("power_spectrum", lambda: power_spectrum(w),
                     4.0 * 2 * windows * n, flops + 3.0 * windows * n)):
                b_ms, b_by = bound(nbytes, ops)
                emit(tree=label, kernel=what, windows=windows, n=n,
                     ms=device_ms(torch, fn, 100), bound_ms=b_ms, bound_by=b_by)
        if args.src:
            this, other = outs["this"], outs["other"]
            emit(compare="fft", windows=windows, n=n,
                 fft_bit_equal=all(torch.equal(bits(a), bits(o))
                                   for a, o in zip(this[:2], other[:2])),
                 power_spectrum_bit_equal=torch.equal(bits(this[2]), bits(other[2])))
    if args.src:
        # every n the kernel takes, on complex and on real input
        unequal = []
        for s in range(14):
            n = 1 << s
            re_, im_ = on(rng.standard_normal((3, n))), on(rng.standard_normal((3, n)))
            for im_in in (im_, None):
                got, want = (trees[t]["fft"](re_, im_in) for t in ("this", "other"))
                if not all(torch.equal(bits(a), bits(o)) for a, o in zip(got, want)):
                    unequal.append([n, im_in is not None])
        emit(compare="fft", n="1 .. 8192, batch 3", fft_bit_equal=not unequal,
             unequal=unequal)
    return 0


if __name__ == "__main__":
    sys.exit(main())
