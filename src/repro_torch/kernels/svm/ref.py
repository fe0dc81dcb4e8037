"""Plain PyTorch version + counts for the SVM decision function (TinyBio
stage 4).

MBio-Tracker's final stage classifies cognitive workload from the extracted
features with a support vector machine, the kernelized decision function

    f(x) = sum_i alpha_i * K(sv_i, x) + b

for linear (K = <sv, x>) and RBF (K = exp(-gamma * ||sv - x||^2)) kernels.
The distance matrix is computed as ||a-b||^2 = |a|^2 + |b|^2 - 2 a.b.
"""

from __future__ import annotations

import torch

from ...core.machine import WorkCounts


def svm_decision_ref(x: torch.Tensor, sv: torch.Tensor, alpha: torch.Tensor,
                     b, gamma: float | None = None) -> torch.Tensor:
    """Decision values for queries ``x`` (..., q, d) against support vectors
    ``sv`` (m, d) with dual coefficients ``alpha`` (m,); leading axes of
    ``x`` are a batch of query sets.  ``gamma=None`` selects the linear
    kernel."""
    x = x.to(torch.float32)
    sv = sv.to(torch.float32)
    dots = x @ sv.T                                    # (..., q, m)
    if gamma is None:
        k = dots
    else:
        d2 = ((x * x).sum(dim=-1, keepdim=True)
              + (sv * sv).sum(dim=1)[None, :] - 2.0 * dots)
        k = torch.exp(-gamma * torch.clamp(d2, min=0.0))
    return k @ alpha.to(torch.float32) + b


def counts(q: int, m: int, d: int, itemsize: int = 4,
           rbf: bool = True) -> WorkCounts:
    macs = float(q) * m * d                      # the distance/dot GEMM
    extra = float(q) * m * (6 if rbf else 1)     # norms, exp, alpha reduce
    host = (q * d + m * (d + 1) + q) * itemsize
    return WorkCounts(ops=macs + extra, dcache_bytes=2.0 * macs / 4 * itemsize,
                      host_bytes=host, working_set=host)
