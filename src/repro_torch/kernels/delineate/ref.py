"""Plain PyTorch version + counts for delineation (TinyBio stage 2).

The paper's delineation detects the peaks and troughs of the filtered
respiration signal to determine inspiration/expiration times (§VII-B).  It is
the *control-intensive* stage: on the e-GPU, divergent branches serialize
under thread masking (§VIII-C), which is why its speed-up trails the FIR's.

Output encoding (int8): +1 = peak, -1 = trough, 0 = neither.  Endpoints are
never extrema (they lack a neighbour).  A plateau credits its first sample
(strict rise before, non-strict fall after), matching the usual biosignal
delineator convention.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...core.machine import WorkCounts


def thresholds(thr: float | int, dtype: torch.dtype) -> Tuple[float | int, float | int]:
    """``thr`` and ``-thr`` cast to the signal's dtype (the negation is
    taken in that dtype too), as Python numbers."""
    t = torch.tensor(thr).to(dtype)
    return t.item(), (-t).item()


def delineate_ref(x: torch.Tensor, thr: float | int = 0) -> torch.Tensor:
    """Flags[i] = +1 if x[i] is a local max above ``thr``, -1 if a local min
    below ``-thr``, else 0.  x: a float or integer signal along its last
    axis (leading axes are a batch of signals, each delineated on its own,
    with its own endpoints); the thresholds are compared in x's dtype."""
    t, neg_t = thresholds(thr, x.dtype)
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    nxt = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    interior = (idx > 0) & (idx < n - 1)
    is_peak = (x > prev) & (x >= nxt) & (x > t) & interior
    is_trough = (x < prev) & (x <= nxt) & (x < neg_t) & interior
    return is_peak.to(torch.int8) - is_trough.to(torch.int8)


def counts(n: int, itemsize: int = 4) -> WorkCounts:
    # ~8 compare/select ops per sample, both predicate paths always evaluated
    ops = 8.0 * n
    dcache = 3.0 * n * itemsize + n  # x, prev, next reads + int8 flags out
    host = n * itemsize + n
    # streaming 3-point stencil: live working set is a few cache lines
    return WorkCounts(ops=ops, dcache_bytes=dcache, host_bytes=host,
                      working_set=1024.0 * itemsize,
                      divergence=1.0)  # fully control-dominated stage
