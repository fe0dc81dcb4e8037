"""Registers, spills and stack of the port's hand-written kernels, as
``ptxas -v`` reports them for ``sm_90a``.

Each source of ``src/repro_torch/csrc`` named (default: the flash-attention
forward and backward) is compiled once more with the build's own flags
(``repro_torch.kernels.common.NVCC_FLAGS``) plus ``-Xptxas -v``, all at
once, into a temporary directory; the kernels' names are demangled with
the toolkit's ``cu++filt``.  Needs the CUDA toolkit (``nvcc``), not the
card::

    python3 -m benchmarks_torch.ptxas_report [--match 192] [SOURCE.cu ...]

Prints one line a kernel: registers, spill stores, spill loads, stack
bytes and the name (those containing ``--match``, if given).
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu")


def report(sources, match: str = ""):
    """[(source, kernel, registers, spill stores, spill loads, stack)]."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import common
    nvcc = common._nvcc()
    cufilt = Path(nvcc).parent / "cu++filt"
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(src, subprocess.Popen(
            [nvcc, *common.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(common.CSRC_DIR), "-c", str(common.CSRC_DIR / src), "-o",
             str(Path(tmp) / f"{Path(src).stem}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in sources]
        for src, proc in procs:
            text, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src}:\n{text}")
            name, stack, stores, loads = None, 0, 0, 0
            for line in text.splitlines():
                m = re.search(r"Compiling entry function '([^']+)'", line)
                if m:
                    name = subprocess.run([str(cufilt), m.group(1)],
                                          capture_output=True,
                                          text=True).stdout.strip()
                    continue
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", line)
                if m:
                    stack, stores, loads = map(int, m.groups())
                    continue
                m = re.search(r"Used (\d+) registers", line)
                if m and name is not None:
                    if match in name:
                        rows.append((src, name, int(m.group(1)), stores,
                                     loads, stack))
                    name = None
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", default=list(DEFAULT_SOURCES))
    ap.add_argument("--match", default="",
                    help="only kernels whose demangled name contains this")
    args = ap.parse_args(argv)
    for src, name, regs, stores, loads, stack in report(args.sources,
                                                        args.match):
        print(f"{src}: {regs} registers, spill stores {stores} B, spill "
              f"loads {loads} B, stack {stack} B: {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
