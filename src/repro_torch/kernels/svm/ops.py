"""Dispatching wrapper for the SVM kernel + TinyCL registration.

``svm_decision(x, sv, alpha, b, gamma)`` launches ``csrc/svm.cu`` (which
replaces the TPU kernel ``src/repro/kernels/svm/svm.py:_svm_kernel``) on
CUDA tensors, bias included, in one launch, and runs
:func:`~repro_torch.kernels.svm.ref.svm_decision_ref` on CPU and ``meta``
tensors.
"""

from __future__ import annotations

import torch

from ...core.device import EGPU_16T, EGPUConfig
from ...core.program import kernel_family
from ...core.runtime import Kernel
from ..common import check_contiguous, check_dtype, on_card
from .ref import counts as svm_counts, svm_decision_ref
from .svm import launch_svm


def svm_decision(x: torch.Tensor, sv: torch.Tensor, alpha: torch.Tensor, b,
                 gamma: float | None = None) -> torch.Tensor:
    """Decision values (q,) for float32 queries ``x`` (q, d), support
    vectors ``sv`` (m, d) and dual coefficients ``alpha`` (m,), plus the
    bias ``b`` (a number or a 0-d tensor).  ``gamma=None`` selects the
    linear kernel, else the RBF kernel with that gamma.  On the card the
    kernel adds ``b`` itself: the result has the bits of
    ``svm_decision(x, sv, alpha, 0.0, gamma) + b``."""
    if x.dim() != 2 or sv.dim() != 2 or alpha.dim() != 1:
        raise ValueError(
            f"svm takes x (q, d), sv (m, d), alpha (m,); got "
            f"{tuple(x.shape)}, {tuple(sv.shape)}, {tuple(alpha.shape)}")
    if sv.shape[1] != x.shape[1] or alpha.shape[0] != sv.shape[0]:
        raise ValueError(
            f"svm shapes disagree: x {tuple(x.shape)}, sv {tuple(sv.shape)}, "
            f"alpha {tuple(alpha.shape)}")
    for what, t in (("svm queries", x), ("svm support vectors", sv),
                    ("svm alpha", alpha)):
        check_dtype(what, t, (torch.float32,))
    if not on_card(x, sv, alpha):
        return svm_decision_ref(x, sv, alpha, b, gamma)
    check_contiguous("svm", x, sv, alpha)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    launch_svm(x, sv, alpha, b, gamma, out)
    return out


@kernel_family("svm")
def build_kernel(config: EGPUConfig = EGPU_16T) -> Kernel:
    return Kernel(
        name="svm",
        executor=svm_decision,
        counts=lambda q, m, d, itemsize=4, rbf=True: svm_counts(q, m, d, itemsize, rbf),
    )
