"""The served pipeline of the overload and power benches: a chain of
``CHAIN`` dependent ``D``x``D`` GeMM stages (``relu(gemm_ref(x, w))``, the
plain version, as the JAX benches use), and their numpy-seeded requests."""

import numpy as np
import torch

from repro_torch.core import Kernel, Stage
from repro_torch.kernels.gemm.ref import counts as gemm_counts
from repro_torch.kernels.gemm.ref import gemm_ref

D = 8              # feature width of the GeMM chain
CHAIN = 4          # dependent stages per request
BUCKET = 16        # single pad bucket (requests are 3..16 rows)
MAX_BATCH = 4


class VClock:
    """Injected virtual clock: the bench owns time."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def stages(dev: torch.device):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(
        (rng.standard_normal((D, D)) * 0.2).astype(np.float32)).to(dev)

    def mlp(x, w):
        return torch.clamp_min(gemm_ref(x, w), 0.0)

    kern = Kernel("mlp", executor=mlp,
                  counts=lambda **kw: gemm_counts(m=D, n=D, k=D))
    return [Stage(kern, consts=(w,), n_inputs=1) for _ in range(CHAIN)]


def requests(n: int, seed: int, dev: torch.device):
    """``n`` requests of 3..``BUCKET`` rows, the JAX benches' draws."""
    rng = np.random.default_rng(seed)
    host = [rng.standard_normal((int(rng.integers(3, BUCKET + 1)), D))
            .astype(np.float32) for _ in range(n)]
    return [torch.from_numpy(a).to(dev) for a in host]
