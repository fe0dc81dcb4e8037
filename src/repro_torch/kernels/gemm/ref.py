"""Plain PyTorch versions + structural work counts for the GeMM kernel.

The GeMM benchmark is the paper's vehicle for quantifying Tiny-OpenCL
overheads (Fig 3): matrix sizes 32x32 .. 256x256, integer arithmetic (the
e-GPU has no FPU).  ``counts()`` feeds the analytic machine model and is the
JAX package's, code for code, so the modeled numbers are the same floats.

Two plain versions, as in the JAX package:

* :func:`gemm_plain` computes what the kernel wrapper ``ops.gemm`` computes:
  integer inputs give int32 (products and sums wrap modulo 2^32, as XLA's
  int32 dot does), float inputs float32.  It sits beside the CUDA kernel
  (``csrc/gemm.cu``): the wrapper runs it for CPU and ``meta`` tensors.
* :func:`gemm_ref` mirrors the JAX ``gemm_ref``, including its dtype rule:
  integer inputs come back in the *input* dtype (int8 in, int8 out, the
  int32 sum narrowed with wraparound), float inputs as float32.
"""

from __future__ import annotations

import torch

from ...core.machine import WorkCounts

# Register-blocking reuse factor of the tuned Tiny-OpenCL GeMM kernel: each
# thread computes a 4x1 strip of C keeping A values in registers, so each
# loaded word is used ~4 times before returning to the D$.
REGISTER_REUSE = 4
# D$ tile edge used by the blocked kernel (3 * 32*32 * 4B = 12 KiB < 16 KiB).
DCACHE_TILE = 32

#: integer and float input dtypes the GeMM takes (widened to int32 / float32)
INT_DTYPES = (torch.int8, torch.int16, torch.int32)
FLOAT_DTYPES = (torch.float32, torch.float16, torch.bfloat16)
_LOW32 = 0xFFFFFFFF
#: int64 elements of one k-chunk's (m, chunk, n) product block
_CHUNK_ELEMS = 1 << 22


def gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B: int32 for integer inputs, float32 for float inputs.

    Integer inputs: PyTorch's CUDA matmul takes no integer types, so the
    products are formed in int64 one k-chunk at a time, each product and
    each chunk's sum kept in its low 32 bits (no step overflows int64), and
    the result read back as int32 — the modulo-2^32 sum XLA's int32 dot
    gives.  Float inputs: a float32 ``matmul``.
    """
    if not a.dtype.is_floating_point:
        m, k = a.shape
        n = b.shape[1]
        a64, b64 = a.to(torch.int64), b.to(torch.int64)
        acc = torch.zeros((m, n), dtype=torch.int64, device=a.device)
        chunk = max(1, _CHUNK_ELEMS // max(1, m * n))
        for k0 in range(0, k, chunk):
            prod = a64[:, k0:k0 + chunk, None] * b64[None, k0:k0 + chunk, :]
            acc = (acc + (prod & _LOW32).sum(dim=1)) & _LOW32
        acc = torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc)
        return acc.to(torch.int32)
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with an accumulator wide enough for the input dtype, cast
    back to the input dtype for integers (the JAX ``gemm_ref``'s rule)."""
    out = gemm_plain(a, b)
    return out if a.dtype.is_floating_point else out.to(a.dtype)


def counts(m: int, n: int, k: int, itemsize: int = 4) -> WorkCounts:
    macs = float(m) * n * k
    # core <-> D$ traffic of the register-blocked inner loop
    dcache = (2.0 * macs / REGISTER_REUSE + m * n) * itemsize
    # host <-> D$ traffic of the two-level blocked kernel: compulsory
    # (all three matrices once) + capacity re-streams of A/B panels, one
    # reload per (register x tile) block — the kernel tiles to FIT the D$,
    # so working_set stays under 16 KiB by construction.
    compulsory = float(m * k + k * n + m * n) * itemsize
    capacity = 2.0 * macs / (REGISTER_REUSE * DCACHE_TILE) * itemsize
    host = compulsory + capacity
    ws = 3.0 * DCACHE_TILE * DCACHE_TILE * itemsize
    return WorkCounts(ops=macs, dcache_bytes=dcache, host_bytes=host,
                      working_set=ws, barriers=0, divergence=0.0)
