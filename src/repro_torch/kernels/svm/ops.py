"""Dispatching wrapper for the SVM kernel + TinyCL registration.

``svm_decision(x, sv, alpha, b, gamma)`` launches ``csrc/svm.cu`` (which
replaces the TPU kernel ``src/repro/kernels/svm/svm.py:_svm_kernel``) on
CUDA tensors, bias included, in one launch, and runs
:func:`~repro_torch.kernels.svm.ref.svm_decision_ref` on CPU and ``meta``
tensors.  Leading axes of the queries are a batch of query sets: the kernel
takes them as one list of queries, so any stack is one launch.  The card
path is the custom op ``repro_torch::svm``, whose vmap rule folds a
vmapped batch into the queries.
"""

from __future__ import annotations

import torch

from ...core.device import EGPU_16T, EGPUConfig
from ...core.program import kernel_family
from ...core.runtime import Kernel
from typing import Optional

from ..common import (card_op, check_contiguous, check_dtype, fold_batch,
                      on_card, unbatched_rest)
from .ref import counts as svm_counts, svm_decision_ref
from .svm import bias_args, launch_svm


def svm_decision(x: torch.Tensor, sv: torch.Tensor, alpha: torch.Tensor, b,
                 gamma: float | None = None) -> torch.Tensor:
    """Decision values (..., q) for float32 queries ``x`` (..., q, d),
    support vectors ``sv`` (m, d) and dual coefficients ``alpha`` (m,),
    plus the bias ``b`` (a number or a 0-d tensor).  ``gamma=None`` selects
    the linear kernel, else the RBF kernel with that gamma.  On the card
    the kernel adds ``b`` itself: the result has the bits of
    ``svm_decision(x, sv, alpha, 0.0, gamma) + b``."""
    if x.dim() < 2 or sv.dim() != 2 or alpha.dim() != 1:
        raise ValueError(
            f"svm takes x (..., q, d), sv (m, d), alpha (m,); got "
            f"{tuple(x.shape)}, {tuple(sv.shape)}, {tuple(alpha.shape)}")
    if sv.shape[1] != x.shape[-1] or alpha.shape[0] != sv.shape[0]:
        raise ValueError(
            f"svm shapes disagree: x {tuple(x.shape)}, sv {tuple(sv.shape)}, "
            f"alpha {tuple(alpha.shape)}")
    for what, t in (("svm queries", x), ("svm support vectors", sv),
                    ("svm alpha", alpha)):
        check_dtype(what, t, (torch.float32,))
    if not on_card(x, sv, alpha):
        return svm_decision_ref(x, sv, alpha, b, gamma)
    b_dev, b_val = bias_args(b, x.device)
    return svm_card(x, sv, alpha, b_dev, b_val,
                    None if gamma is None else float(gamma))


@card_op("svm")
def svm_card(x: torch.Tensor, sv: torch.Tensor, alpha: torch.Tensor,
             b_dev: Optional[torch.Tensor], b_val: float,
             gamma: Optional[float]) -> torch.Tensor:
    """The card path of :func:`svm_decision`: one launch over every query
    of ``x`` (..., q, d); the bias from ``b_dev`` (a 0-d float32 tensor on
    the queries' device) or, when that is None, ``b_val``."""
    rows = x.reshape(-1, x.shape[-1])
    check_contiguous("svm", rows, sv, alpha)
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=x.device)
    if rows.shape[0]:
        launch_svm(rows, sv, alpha, b_val if b_dev is None else b_dev, gamma, out)
    return out.reshape(x.shape[:-1])


@svm_card.register_fake
def _svm_fake(x, sv, alpha, b_dev, b_val, gamma):
    return torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)


@svm_card.register_vmap
def _svm_vmap(info, in_dims, x, sv, alpha, b_dev, b_val, gamma):
    unbatched_rest("svm", in_dims)
    rows, lead = fold_batch(x, in_dims[0], 1)
    out = svm_card(rows, sv, alpha, b_dev, b_val, gamma)
    return out.reshape(lead), 0


@kernel_family("svm")
def build_kernel(config: EGPUConfig = EGPU_16T) -> Kernel:
    return Kernel(
        name="svm",
        executor=svm_decision,
        counts=lambda q, m, d, itemsize=4, rbf=True: svm_counts(q, m, d, itemsize, rbf),
    )
