"""Kernels shared by the DAG benches (``bench_transfer``, ``bench_multiqueue``).

Each GeMM branch is the registry's ``gemm`` kernel (the hand-written kernel
on the card) renamed per branch and priced at a fixed ``SIZE``³ GeMM; the
combine stage is a plain sum of the branch outputs, as in the JAX benches.
"""

from repro_torch.core import EGPU_16T, Kernel, Program
from repro_torch.kernels.gemm.ref import counts as gemm_counts

SIZE = 128         # per-branch GeMM operand size
BRANCHES = 4       # independent branches between fan-out and fan-in


def gemm_kernel(name: str) -> Kernel:
    base = Program.build(EGPU_16T).create_kernel("gemm")
    return Kernel(name=name, executor=base.executor,
                  counts=lambda **kw: gemm_counts(m=SIZE, n=SIZE, k=SIZE))


def combine_kernel() -> Kernel:
    def combine(*xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out
    return Kernel(name="combine", executor=combine,
                  counts=lambda **kw: gemm_counts(m=SIZE, n=SIZE, k=1))
