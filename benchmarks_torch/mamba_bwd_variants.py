"""Ablations of the Mamba backward kernel on the card: what each design
choice of ``csrc/mamba_scan_bwd.cu`` is worth at jamba's training shape.

Each variant is this tree's kernel source with a few edits
(:data:`VARIANTS`, each with a note): a design choice taken back, or,
marked ``timing only``, a piece of work taken out so that its cost shows
(those gradients are wrong and are not checked).  A constant's edit finds
its ``constexpr int`` whatever its value; a text edit raises where the
kernel no longer holds its text.  Every variant is built with the
library's own ``nvcc`` flags (``-Xptxas -v`` added, for its registers) into
``build/repro_torch/``, all builds at once, and called through this tree's
wrapper (``ops.mamba_scan_bwd``) with its launches sent to the variant's
library (``_kernel_copy.py``), at B 8, T 128, Dm 16384, N 16,
x/dy bf16, delta f32 (numpy seed 0), beside the library's own kernel,
which runs first and again last::

    python3 -m benchmarks_torch.mamba_bwd_variants [NAME ...]

Prints the card's name and power limit, then one JSON object a variant:
its device ms a call (``chip_smoke.device_ms``: CUDA events around 10
replays of a CUDA graph of calls), its registers at N = 16 (bf16 x, f32
delta), and for a design variant whether its gradients are bit-equal to
the library's and within ``chip_smoke.py`` phase 2's tolerance of them (it
raises if not).  Needs the card.
"""

from __future__ import annotations

import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from . import _kernel_copy as kc

ROOT = Path(__file__).resolve().parents[1]


def constant(name: str, value: int):
    """The edit that sets the kernel's ``constexpr int name`` to ``value``."""
    return (rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};")


def text(old: str, new: str):
    """The edit that replaces the kernel's text ``old`` by ``new``."""
    return (re.escape(old), new)


#: name -> (note, edits, timing only, the plan's constants in
#: kernels/mamba_scan/mamba_scan.py that the variant changes)
VARIANTS = {
    "128 threads a block, 4 blocks an SM": (
        "half the channels a block: twice the blocks' partial sums",
        [constant("kThreads", 128), constant("kBlocksPerSm", 4)],
        False, {"BWD_THREADS": 128}),
    "2 states a thread, 3 blocks an SM": (
        "half the history in registers, twice the lanes a channel",
        [constant("kMaxStates", 2), constant("kBlocksPerSm", 3),
         text("static_assert(L <= 8 && ", "static_assert(L <= 16 && ")],
        False, {"BWD_MAX_STATES": 2}),
    "chunks of 4, 3 blocks an SM": (
        "half the history in registers, the chunk states in a scratch buffer",
        [constant("kC", 4), constant("kBlocksPerSm", 3)],
        False, {}),
    "channel sums whole in the warp": (
        "the reduce-scatter's whole adds done by shuffles, one share a warp",
        [text("  static constexpr int G = 32 / L / S;", "  static constexpr int G = 1;"),
         text("warp_reduce_scatter<S, 16, 32 / S>(pc, lane, idx);",
              "warp_reduce_scatter<S, 16, L>(pc, lane, idx);"),
         text("warp_reduce_scatter<S, 16, 32 / S>(pb, lane, idx);",
              "warp_reduce_scatter<S, 16, L>(pb, lane, idx);")],
        False, {}),
    "b and c by cp.async": (
        "4-byte copies by every thread instead of two TMA boxes",
        [text("constexpr bool kBcTma = N * 4 % 16 == 0;", "constexpr bool kBcTma = false;")],
        False, {}),
    "no exponentials": (
        "2^z replaced by z in the sweep and the recomputed chunk",
        [text("h[j] = fmaf(ex2_sfu(dt * ap[j]), h[j], dx * bv[j]);",
              "h[j] = fmaf(dt * ap[j], h[j], dx * bv[j]);"),
         text("da[tt][j] = ex2_sfu(dt * ap[j]);", "da[tt][j] = dt * ap[j];")],
        True, {}),
    "no shuffles": (
        "the sums over states and over channels left undone",
        [text("warp_reduce_scatter<S, 16, 32 / S>(pc, lane, idx);", ""),
         text("warp_reduce_scatter<S, 16, 32 / S>(pb, lane, idx);", ""),
         text("if constexpr (L > 1) warp_reduce_scatter<2, L / 2, 1>(v2, lane, which);", "")],
        True, {}),
    "no dx, ddelta stores": (
        "the walk's two stores a step left out",
        [text("if (on && part == 0) store_as(dxp, dt * v2[0]);", ""),
         text("if (on && part == L / 2) store_as(ddp, v2[L == 1]);", "")],
        True, {}),
}


def agrees(got: torch.Tensor, want: torch.Tensor) -> bool:
    """``chip_smoke.py`` phase 2's rule: within 1e-5 of the largest
    magnitude, and one bf16 ulp more for a bf16 gradient."""
    g, w = got.float(), want.float()
    tol = 1e-5 * float(w.abs().max())
    if got.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * torch.maximum(g.abs(), w.abs())
    return bool(((g - w).abs() <= tol).all())


def variant_source(src: str, edits) -> str:
    for pattern, new in edits:
        src, found = re.subn(pattern, lambda _m: new, src)
        if found == 0:
            raise RuntimeError(f"mamba_bwd_variants: {pattern[:60]!r} is not in "
                               f"the kernel's source; update VARIANTS")
    return src


def registers(ptxas: str):
    """The registers of mamba_bwd_kernel at N = 16, bf16 x, f32 delta."""
    regs, current = None, ""
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and "mamba_bwd_kernel" in current and "13__nv_bfloat16fLi16E" in current:
            regs = int(m.group(1))
    return regs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("mamba_bwd_variants needs the card")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import device_ms, nvidia_smi
    from repro_torch.kernels import common
    from repro_torch.kernels.mamba_scan import mamba_scan as mm
    from repro_torch.kernels.mamba_scan.ops import mamba_scan_bwd

    names = sys.argv[1:] or list(VARIANTS)
    src = (common.CSRC_DIR / "mamba_scan_bwd.cu").read_text()
    print(nvidia_smi("name,power.limit"), flush=True)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda k: kc.build(common, f"mamba_bwd_variant_{k}", variant_source(
                src, VARIANTS[k][1]), ptxas=True), names)))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def normal(*shape, dtype=torch.float32, sc=1.0):
        return torch.from_numpy((sc * rng.standard_normal(shape)).astype(
            np.float32)).to(dev, dtype)

    b, t, dm, n = 8, 128, 16384, 16
    ins = (normal(b, t, dm, dtype=torch.bfloat16, sc=0.5),
           normal(b, t, dm, sc=0.3).abs() + 0.1, -(normal(dm, n).abs() + 0.1),
           normal(b, t, n, sc=0.5), normal(b, t, n, sc=0.5),
           normal(b, t, dm, dtype=torch.bfloat16))
    want = mamba_scan_bwd(*ins)

    def library_row(label):
        print(json.dumps({"variant": label, "ms": device_ms(
            torch, lambda: mamba_scan_bwd(*ins), 10)}), flush=True)

    library_row("the library's kernel")
    for name in names:
        note, _edits, timing_only, constants = VARIANTS[name]
        lib, ptxas = built[name]
        with kc.redirect(mm, lib, **constants):
            got = mamba_scan_bwd(*ins)
            row = {"variant": name, "note": note, "timing_only": timing_only,
                   "ms": device_ms(torch, lambda: mamba_scan_bwd(*ins), 10),
                   "registers": registers(ptxas)}
        if not timing_only:
            row["bits_equal"] = all(torch.equal(g, w) for g, w in zip(got, want))
            row["within_phase_2_tolerance"] = all(
                agrees(g, w) for g, w in zip(got, want))
            if not row["within_phase_2_tolerance"]:
                raise RuntimeError(f"{name}: gradients off the library's")
        print(json.dumps(row), flush=True)
    library_row("the library's kernel, again")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
