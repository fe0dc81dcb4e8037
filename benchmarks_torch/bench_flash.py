"""Device time of the flash-attention kernels at hubert-xlarge's heads, for
whichever tree of the port is on ``PYTHONPATH``, so that two trees are
compared in one call, in turns (parent, change, change, parent)::

    PYTHONPATH=<tree>/src python3 -m benchmarks_torch.bench_flash [--label NAME]

Shapes (16 heads of 80, bidirectional, bf16, inputs from numpy seed 0):
the training shape (B = 8, S = T = 128: the forward keeping the
log-sum-exp, as the differentiable call runs it, and the backward from
that log-sum-exp) and the encode shape (B = 4, S = T = 256: the forward).
Each time is the mean device ms a call over 20 replays of a CUDA graph of
20 calls, between CUDA events (``chip_smoke.device_ms``, phase 3's
timer); ``F.scaled_dot_product_attention``'s forward and backward (its
forward and backward less its forward) are timed beside them as the
yardstick, and a ``torch.profiler`` window of one
forward and one backward names the device kernels that ran.  It checks
nothing: ``chip_smoke.py`` holds the kernels against their plain versions.

Prints the card's name and power limit, then one JSON line a shape.
Needs the card.
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np
import torch
import torch.nn.functional as F

from chip_smoke import device_ms as _device_ms
from chip_smoke import nvidia_smi
from repro_torch.kernels.flash_attention.ops import (_card_forward,
                                                     flash_attention_bwd)

HEADS, HEAD_DIM = 16, 80
SHAPES = (("train", 8, 128), ("encode", 4, 256))
#: ``chip_smoke.py``'s timer (phase 3's), at 20 calls a graph
device_ms = functools.partial(_device_ms, torch, per_graph=20)


def kernels_of(fn) -> list:
    """Names of the device kernels with ``flash`` in them that ``fn()``
    ran, under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key.replace("void ", "", 1).replace(
        "(anonymous namespace)::", "").split("(")[0]
        for e in prof.key_averages()
        if "flash" in e.key and e.device_type.name == "CUDA"})


def run(label: str) -> list:
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    scale = HEAD_DIM ** -0.5
    rows = []
    for name, b, s in SHAPES:
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(
            (b, HEADS, s, HEAD_DIM)).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(4))
        train = name == "train"
        fwd = lambda: _card_forward(q, k, v, False, scale, 0, s, s,  # noqa: E731
                                    with_lse=train)
        row = {"label": label, "shape": name, "b": b, "h": HEADS, "s": s,
               "d": HEAD_DIM, "causal": False, "forward_ms": device_ms(fwd),
               "sdpa_forward_ms": device_ms(
                   lambda: F.scaled_dot_product_attention(q, k, v))}
        if train:
            _, lse = fwd()
            bwd = lambda: flash_attention_bwd(q, k, v, dout, lse,  # noqa: E731
                                              causal=False)
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(qg, kg, vg)
                return torch.autograd.grad(out, (qg, kg, vg), dout)

            row["backward_ms"] = device_ms(bwd)
            row["sdpa_backward_ms"] = (device_ms(sdpa_fwd_bwd)
                                       - row["sdpa_forward_ms"])
            row["kernels"] = kernels_of(lambda: (fwd(), bwd()))
        else:
            row["kernels"] = kernels_of(fwd)
        rows.append(row)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default="tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash needs the card")
    print(nvidia_smi("name,power.limit"), flush=True)
    for row in run(args.label):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
