"""Plain PyTorch Stockham FFT + counts (TinyBio feature extraction).

The paper motivates Stockham (§VIII-C): no bit-reversal permutation, a
ping-pong buffer between stages, regular sequential accesses at every stage,
output already in order.  The vectorized recurrence (Van Loan form), per
signal:

view X as (2r, l)  [initially (n, 1)]:
    a, b = X[:r], X[r:]
    w_j  = exp(-i * pi * j / l),  j = 0..l-1
    X'   = concat([a + w*b, a - w*b], axis=1)      # shape (r, 2l)

After log2(n) stages X has shape (1, n) and *is* the DFT, in order.  Real and
imaginary parts are kept as separate float32 planes.  The twiddle angle is
the JAX kernel's, ``float32(-pi / l) * j``; the CUDA kernel
(``csrc/stockham_fft.cu``) repeats exactly this arithmetic.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ...core.machine import WorkCounts


def stockham_fft_ref(re: torch.Tensor, im: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched FFT of float32 (batch, n) planes, n a power of two."""
    b, n = re.shape
    stages = n.bit_length() - 1
    if 1 << stages != n:
        raise ValueError(f"n={n} must be a power of two")
    re = re.to(torch.float32).reshape(b, n, 1)
    im = im.to(torch.float32).reshape(b, n, 1)
    for _ in range(stages):
        l = re.shape[2]
        r = re.shape[1] // 2
        step = torch.full((), -math.pi / l, dtype=torch.float32,
                          device=re.device)
        ang = torch.arange(l, dtype=torch.float32, device=re.device) * step
        wr, wi = torch.cos(ang), torch.sin(ang)
        ar, ai = re[:, :r], im[:, :r]
        br, bi = re[:, r:], im[:, r:]
        tr = wr * br - wi * bi
        ti = wr * bi + wi * br
        re = torch.cat([ar + tr, ar - tr], dim=2)
        im = torch.cat([ai + ti, ai - ti], dim=2)
    return re.reshape(b, n), im.reshape(b, n)


OPS_PER_BUTTERFLY = 10  # 4 mul + 6 add/sub (complex twiddle + butterfly)


# Power-of-two butterfly strides hit the line-interleaved banks
# periodically: ~1.5x effective D$ traffic from serialized conflicts.
BANK_CONFLICT = 1.5


def counts(n: int, itemsize: int = 4) -> WorkCounts:
    stages = int(math.log2(n))
    ops = (n / 2) * stages * OPS_PER_BUTTERFLY
    # ping-pong: every stage reads and writes both planes
    dcache = stages * (2.0 * n * itemsize) * 2 * BANK_CONFLICT
    host = 4.0 * n * itemsize           # re/im in + re/im out
    return WorkCounts(ops=ops, dcache_bytes=dcache, host_bytes=host,
                      working_set=4.0 * n * itemsize, barriers=stages)
