"""An edited copy of a kernel source, built beside the library and called
through the library's own wrapper, for the phase profiles
(``rwkv_bwd_phases.py``, ``mamba_bwd_phases.py``) and the ablations
(``mamba_bwd_variants.py``).

A phase profile puts :func:`mark` statements into a kernel's body (thread
0 of each block reads ``clock64()`` and adds the cycles since its last mark
to that phase's counter, one ``atomicAdd`` a mark) and :func:`with_counters`
adds the counters (a ``__device__`` array) and their C accessor; the copy
is built by :func:`build` with the library's ``nvcc`` flags into
``build/repro_torch/``; :func:`redirect` sends a kernel module's launches
to it, and :func:`read_cycles` reads the counters of one call.  Needs the
card (and ``nvcc``) to run.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import subprocess


def mark(k: int) -> str:
    """The statement that closes phase ``k`` where it stands."""
    return ("if (threadIdx.x == 0) { long long now_ = clock64(); atomicAdd("
            "reinterpret_cast<unsigned long long*>(&g_phase_cycles[" + str(k)
            + "]), static_cast<unsigned long long>(now_ - last_)); "
            "last_ = now_; }")


#: the statement, put first in the kernel's body, that the first mark
#: counts from
CLOCK_START = "long long last_ = clock64();"


def with_counters(src: str, phases: int) -> str:
    """``src`` with ``phases`` counters and ``repro_phase_cycles(out,
    reset)``, which zeroes them (reset) or copies them to ``out``."""
    out = src.replace("namespace {\n", "__device__ long long g_phase_cycles"
                      f"[{phases}];\nnamespace {{\n", 1)
    return out + (
        "\nREPRO_API int repro_phase_cycles(long long* out, int reset) {\n"
        "  if (reset) {\n"
        f"    long long z[{phases}] = {{0}};\n"
        "    return static_cast<int>(cudaMemcpyToSymbol(g_phase_cycles, z, sizeof(z)));\n"
        "  }\n"
        "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_cycles, "
        f"{phases} * sizeof(long long)));\n"
        "}\n")


def build(common, stem: str, text: str, ptxas: bool = False):
    """(the copy's library, ``nvcc``'s output): ``text`` built with the
    library's flags (``-Xptxas -v`` added with ``ptxas``) into
    ``common.BUILD_DIR``, under a name of ``stem`` and this process."""
    common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    name = re.sub(r"\W+", "_", stem)
    cu = common.BUILD_DIR / f"{name}.{os.getpid()}.cu"
    cu.write_text(text)
    so = cu.with_suffix(".so")
    out = subprocess.run([common._nvcc(), *common.NVCC_FLAGS,
                          *(["-Xptxas", "-v"] if ptxas else []), "-shared",
                          "-I", str(common.CSRC_DIR), "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"{stem}: nvcc failed\n{out.stdout}{out.stderr}")
    return ctypes.CDLL(str(so)), out.stdout + out.stderr


@contextlib.contextmanager
def redirect(module, lib: ctypes.CDLL, **constants):
    """Within the block, ``module``'s launches (its ``launch``) call
    ``lib``'s entry points and its ``kernel_library`` is ``lib``, with the
    module's ``constants`` set to the values given; all restored after."""

    def to_copy(kernel, symbol, argtypes, *args):
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        err = fn(*args)
        if err:
            raise RuntimeError(f"the copy's {symbol} failed: CUDA error {err}")

    names = {"launch": to_copy, **constants}
    if hasattr(module, "kernel_library"):
        names["kernel_library"] = lambda: lib
    saved = {k: getattr(module, k) for k in names}
    for k, v in names.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def read_cycles(lib: ctypes.CDLL, phases: int, call) -> list:
    """Each phase's cycles, summed over the blocks, in one ``call()``."""
    import torch
    lib.repro_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.repro_phase_cycles.restype = ctypes.c_int
    counts = (ctypes.c_longlong * phases)()
    torch.cuda.synchronize()
    if lib.repro_phase_cycles(counts, 1):
        raise RuntimeError("repro_phase_cycles: the reset failed")
    call()
    torch.cuda.synchronize()
    if lib.repro_phase_cycles(counts, 0):
        raise RuntimeError("repro_phase_cycles: the read failed")
    return list(counts)
