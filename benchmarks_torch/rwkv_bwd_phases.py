"""Where the RWKV-6 backward kernel's cycles go, phase by phase, on the card.

A copy of ``src/repro_torch/csrc/rwkv6_scan_bwd.cu`` is instrumented: at
every barrier of ``rwkv6_bwd_kernel`` thread 0 of each block reads
``clock64()`` and adds the cycles since its last reading to that phase's
counter (one ``atomicAdd`` a barrier, a ``__device__`` array).  The copy is
built with the library's own ``nvcc`` flags into ``build/repro_torch/``
beside the library and called through its C entry point at rwkv6-3b's
training shape (B 8, H 40, T 128, D 64, r/k/v/dy bf16, w f32, numpy seed
0), once to check it against the plain backward and once counted; the
uninstrumented kernel's device ms (``chip_smoke.device_ms``) is printed
beside it::

    python3 -m benchmarks_torch.rwkv_bwd_phases

Prints one JSON object: the card's name and power limit, the device ms of
the kernel and of the instrumented copy (the counters cost a few per
cent), whether the copy's gradients are bit-equal to the kernel's, and the
mean cycles a block by phase with each phase's share.  Needs the card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

#: the phase each barrier of the kernel closes, in source order: the sweep
#: loop's top (the last sweep chunk's product and state write), its staging,
#: its decays; the backward loop's top (the last chunk's walks), its
#: staging, its decays / c / A, its products; the barrier after the loop
#: (the last chunk's walks)
BARRIER_PHASES = ("sweep: products and state", "sweep: staging",
                  "sweep: decays", "backward: walks", "backward: staging",
                  "backward: decays, c and A", "backward: shared products",
                  "backward: walks")
#: the mark put before the shared products (the carry's product ends there)
CARRY_MARK = "    // The shared products, in strips"
PHASES = tuple(dict.fromkeys(BARRIER_PHASES)) + ("backward: the carry",)


def instrument(src: str) -> str:
    """The source with a counter at each barrier of rwkv6_bwd_kernel."""
    head = src.index("rwkv6_bwd_kernel(Args a, int hist_smem) {")
    end = src.index("\n}\n", head)
    body = src[head:end]

    def mark(phase: str) -> str:
        k = PHASES.index(phase)
        return ("__syncthreads(); if (threadIdx.x == 0) { long long now_ = "
                f"clock64(); atomicAdd(reinterpret_cast<unsigned long long*>("
                f"&g_phase_cycles[{k}]), static_cast<unsigned long long>("
                f"now_ - last_)); last_ = now_; }}")

    parts = body.split("__syncthreads();")
    if len(parts) - 1 != len(BARRIER_PHASES):
        raise RuntimeError(f"rwkv6_bwd_kernel has {len(parts) - 1} barriers, "
                           f"expected {len(BARRIER_PHASES)}")
    body = parts[0] + "".join(mark(p) + rest for p, rest in
                              zip(BARRIER_PHASES, parts[1:]))
    body = body.replace(CARRY_MARK, "    " + mark("backward: the carry") + "\n"
                        + CARRY_MARK, 1)
    body = body.replace("extern __shared__ __align__(16) float sm[];",
                        "extern __shared__ __align__(16) float sm[];\n"
                        "  long long last_ = clock64();", 1)
    out = src[:head] + body + src[end:]
    out = out.replace("namespace {\n", f"__device__ long long g_phase_cycles"
                      f"[{len(PHASES)}];\nnamespace {{\n", 1)
    n = len(PHASES)
    return out + (
        "\nREPRO_API int repro_phase_cycles(long long* out, int reset) {\n"
        "  if (reset) {\n"
        f"    long long z[{n}] = {{0}};\n"
        "    return static_cast<int>(cudaMemcpyToSymbol(g_phase_cycles, z, sizeof(z)));\n"
        "  }\n"
        "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_cycles, "
        f"{n} * sizeof(long long)));\n"
        "}\n")


def build() -> ctypes.CDLL:
    from repro_torch.kernels import common
    common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = common.BUILD_DIR / "rwkv6_scan_bwd_phases.cu"
    cu.write_text(instrument((common.CSRC_DIR / "rwkv6_scan_bwd.cu").read_text()))
    so = cu.with_suffix(".so")
    subprocess.run([common._nvcc(), *common.NVCC_FLAGS, "-shared", "-I",
                    str(common.CSRC_DIR), "-o", str(so), str(cu)], check=True)
    return ctypes.CDLL(str(so))


def launch(lib, r, k, v, w, u, dy):
    """The instrumented copy's entry, called as the wrapper calls the
    library's -> (dr, dk, dv, dw, du)."""
    from repro_torch.kernels.rwkv6_scan.rwkv6_scan import bwd_scratch_words
    b, h, t, d = r.shape
    words = bwd_scratch_words(t, d, r.device.index or 0)
    hist = torch.empty(b * h * words, device=r.device) if words else None
    dr, dk, dv = (torch.empty_like(x) for x in (r, k, v))
    dw = torch.empty_like(w, dtype=torch.float32)
    du = torch.empty((h, d), device=r.device)
    du_part = torch.empty((b, h, d), device=r.device)
    strides = (ctypes.c_longlong * 27)(*(s for x in (r, k, v, w, dy, dr, dk,
                                                     dv, dw)
                                         for s in x.stride()[:3]))
    fn = lib.repro_rwkv6_scan_bwd_bf16
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 13 + [I] * 4 + [P, I, P]
    fn.restype = I
    p = lambda x: P(None if x is None else x.data_ptr())  # noqa: E731
    err = fn(p(r), p(k), p(v), p(w), p(u), p(dy), p(dr), p(dk), p(dv), p(dw),
             p(hist), p(du_part), p(du), b, h, t, d, ctypes.cast(strides, P),
             r.device.index or 0, P(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"the instrumented kernel failed: CUDA error {err}")
    return dr, dk, dv, dw, du


def run() -> dict:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import device_ms, nvidia_smi
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan_bwd
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_bwd_plain
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def normal(*shape, dtype=torch.float32, sc=1.0):
        return torch.from_numpy((sc * rng.standard_normal(shape)).astype(
            np.float32)).to(dev, dtype)

    b, h, t, d = 8, 40, 128, 64
    r, k, v = (normal(b, h, t, d, dtype=torch.bfloat16, sc=0.5) for _ in range(3))
    w = torch.exp(-torch.exp(normal(b, h, t, d, sc=0.5) - 1.0))
    u = normal(h, d, sc=0.5)
    dy = normal(b, h, t, d, dtype=torch.bfloat16)
    lib = build()
    got = launch(lib, r, k, v, w, u, dy)
    want = rwkv6_scan_bwd(r, k, v, w, u, dy)
    plain = rwkv6_scan_bwd_plain(*(z.float() for z in (r, k, v, w, u, dy)))
    same = all(torch.equal(a, c) for a, c in zip(got, want))
    lib.repro_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counts = (ctypes.c_longlong * len(PHASES))()
    lib.repro_phase_cycles(counts, 1)
    launch(lib, r, k, v, w, u, dy)
    torch.cuda.synchronize()
    lib.repro_phase_cycles(counts, 0)
    total = sum(counts)
    return {
        "card": nvidia_smi("name,power.limit"),
        "kernel_ms": device_ms(torch, lambda: rwkv6_scan_bwd(r, k, v, w, u, dy), 20),
        "instrumented_ms": device_ms(torch, lambda: launch(lib, r, k, v, w, u, dy), 20),
        "bits_equal_to_the_kernel": same,
        "max_err_vs_plain_over_max": max(
            float((a.float() - c.float()).abs().max() / c.float().abs().max())
            for a, c in zip(got, plain)),
        "cycles_a_block": {name: round(c / (b * h)) for name, c in zip(PHASES, counts)},
        "share": {name: round(c / total, 4) for name, c in zip(PHASES, counts)},
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("rwkv_bwd_phases needs the card")
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
