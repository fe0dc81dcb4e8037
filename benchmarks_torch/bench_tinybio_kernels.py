"""Device time of TinyBio's ``svm``, ``fft`` and ``power_spectrum`` on one
card, at TinyBio's shapes (q 128, m 256, d 36; 128 windows of 512) and
beside them at q 1024, m 1024, d 36 and 128 windows of 4096, with the
card's launch floor (an empty kernel, ``csrc/launch_floor.cu``).

Run from the root of a checkout, on a machine with a card::

    python3 benchmarks_torch/bench_tinybio_kernels.py [--src DIR]

``--src`` names the ``src`` directory of another tree (another commit
unpacked beside this checkout).  Its ``repro_torch`` is loaded beside this
tree's under another name, with its own kernel library built from its own
sources, and both are timed in one process, in turns (other, this, this,
other).  Each row names its tree; for every shape, one more row reports
whether this tree's ``fft`` and ``power_spectrum`` outputs equal the other
tree's bit for bit, and how far the two ``svm`` outputs lie apart; a last
row does the same for ``fft`` at every n = 1 .. 8192.
Device ms per call come from CUDA events around 20 replays of a CUDA graph
of 100 calls (``chip_smoke.device_ms``); bounds as ``chip_smoke.py``
computes them.  Inputs are made with numpy from seed 0.  Prints one JSON
object per row and writes no file.
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


def load_tree(src: Path, name: str):
    """The ``repro_torch`` package under ``src``, imported as ``name``."""
    init = src / "repro_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def kernels_of(package: str):
    """(svm_decision, fft, power_spectrum, its ``kernels.common``) of a
    package."""
    svm = importlib.import_module(f"{package}.kernels.svm.ops")
    fft = importlib.import_module(f"{package}.kernels.stockham_fft.ops")
    common = importlib.import_module(f"{package}.kernels.common")
    return svm.svm_decision, fft.fft, fft.power_spectrum, common


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=None)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bench_tinybio_kernels: needs a card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import bound, device_ms, launch_floor, nvidia_smi

    torch.backends.cuda.matmul.allow_tf32 = False
    print(nvidia_smi("name,power.limit"), flush=True)
    dev = torch.device("cuda")
    trees = {"this": kernels_of("repro_torch")}
    if args.src:
        load_tree(Path(args.src).resolve(), "repro_torch_other")
        trees["other"] = kernels_of("repro_torch_other")
    for label, (*_, common) in trees.items():
        info = common.build_kernels()
        print(f"{label}: kernels built in {info['seconds']:.1f} s", flush=True)
    rng = np.random.default_rng(0)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def bits(t):
        return t.contiguous().view(torch.int32)

    order = ["other", "this", "this", "other"] if args.src else ["this"]
    floor = launch_floor(trees["this"][3])
    for blocks, threads in ((1, 32), (128, 256)):
        print(json.dumps({"kernel": "launch_floor", "blocks": blocks,
                          "threads": threads, "ms": device_ms(
                              torch, lambda: floor(blocks, threads), 100)}),
              flush=True)

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
            svm = trees[label][0]
            outs[label] = svm(x, sv, alpha, b, 0.5)
            print(json.dumps({"tree": label, "kernel": "svm", "q": q, "m": m,
                              "d": d, "ms": device_ms(
                                  torch, lambda: svm(x, sv, alpha, b, 0.5), 100),
                              "bound_ms": b_ms, "bound_by": b_by}), flush=True)
        if args.src:
            print(json.dumps({"compare": "svm", "q": q, "m": m, "d": d,
                              "max_abs_diff": float((outs["this"] - outs["other"])
                                                    .abs().max())}), flush=True)

    for windows, n in FFT_SHAPES:
        w = on(rng.standard_normal((windows, n)))
        flops = 10.0 * windows * (n // 2) * int(math.log2(n))
        outs = {}
        for label in order:
            _, fft, power_spectrum, _ = trees[label]
            outs[label] = (*fft(w), power_spectrum(w))
            for what, fn, nbytes, ops in (
                    ("fft", lambda: fft(w), 4.0 * 3 * windows * n, flops),
                    ("power_spectrum", lambda: power_spectrum(w),
                     4.0 * 2 * windows * n, flops + 3.0 * windows * n)):
                b_ms, b_by = bound(nbytes, ops)
                print(json.dumps({"tree": label, "kernel": what,
                                  "windows": windows, "n": n,
                                  "ms": device_ms(torch, fn, 100),
                                  "bound_ms": b_ms, "bound_by": b_by}), flush=True)
        if args.src:
            this, other = outs["this"], outs["other"]
            print(json.dumps({
                "compare": "fft", "windows": windows, "n": n,
                "fft_bit_equal": all(torch.equal(bits(a), bits(o))
                                     for a, o in zip(this[:2], other[:2])),
                "power_spectrum_bit_equal": torch.equal(bits(this[2]),
                                                        bits(other[2]))}),
                flush=True)
    if args.src:
        # every n the kernel takes, on complex and on real input
        unequal = []
        for s in range(14):
            n = 1 << s
            re_, im_ = on(rng.standard_normal((3, n))), on(rng.standard_normal((3, n)))
            for im_in in (im_, None):
                got, want = (trees[t][1](re_, im_in) for t in ("this", "other"))
                if not all(torch.equal(bits(a), bits(o)) for a, o in zip(got, want)):
                    unequal.append([n, im_in is not None])
        print(json.dumps({"compare": "fft", "n": "1 .. 8192, batch 3",
                          "fft_bit_equal": not unequal, "unequal": unequal}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
