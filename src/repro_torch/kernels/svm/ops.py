"""Dispatching wrapper for the SVM kernel + TinyCL registration.

``svm_decision(x, sv, alpha, b, gamma)`` launches ``csrc/svm.cu`` (which
replaces the TPU kernel ``src/repro/kernels/svm/svm.py:_svm_kernel``) on
CUDA tensors and runs :func:`~repro_torch.kernels.svm.ref.svm_decision_ref`
on CPU and ``meta`` tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.device import EGPU_16T, EGPUConfig
from ...core.program import kernel_family
from ...core.runtime import Kernel
from ..common import check_contiguous, check_dtype, launch, on_card, ptr, stream_of
from .ref import counts as svm_counts, svm_decision_ref

#: four query rows of d floats live in 48 KB of shared memory
MAX_D = 3072

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P]


def svm_decision(x: torch.Tensor, sv: torch.Tensor, alpha: torch.Tensor, b,
                 gamma: float | None = None) -> torch.Tensor:
    """Decision values (q,) for float32 queries ``x`` (q, d), support
    vectors ``sv`` (m, d) and dual coefficients ``alpha`` (m,), plus the
    bias ``b`` (a number or a 0-d tensor).  ``gamma=None`` selects the
    linear kernel, else the RBF kernel with that gamma."""
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
    (q, d), m = x.shape, sv.shape[0]
    if d > MAX_D:
        raise ValueError(f"svm kernel takes d <= {MAX_D} features, got {d}")
    out = torch.empty(q, dtype=torch.float32, device=x.device)
    launch("svm", "repro_svm_f32", _ARGS, ptr(x), ptr(sv), ptr(alpha),
           ptr(out), q, m, d, 0.0 if gamma is None else float(gamma),
           int(gamma is not None), x.device.index, stream_of(x))
    return out + b


@kernel_family("svm")
def build_kernel(config: EGPUConfig = EGPU_16T) -> Kernel:
    return Kernel(
        name="svm",
        executor=svm_decision,
        counts=lambda q, m, d, itemsize=4, rbf=True: svm_counts(q, m, d, itemsize, rbf),
    )
