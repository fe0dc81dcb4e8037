"""Device time of the norm kernel and the RWKV-6 backward kernel at the
shapes the port's paths give them, for whichever tree of the port is on
``PYTHONPATH``, so that two trees are compared in one call, in turns
(parent, change, change, parent)::

    PYTHONPATH=<tree>/src python3 -m benchmarks_torch.bench_norm_rwkv_bwd [--label NAME]

Shapes (bf16 activations, f32 scale, bias and w, inputs from numpy seed
0), ``chip_smoke.py`` phase 3's: the norm at qwen's decode step (4 x 2048,
RMS) and prefill (256 x 2048), stablelm's training LayerNorm (1024 x
2048), rwkv's step group norm (4 x 40 groups of 64) and deepseek's latent
RMS (4 x 512), that last one also on the latent slice the model passes
(``kv_a[..., :512]`` of 4 x 576); beside each, ``F.rms_norm`` /
``F.layer_norm`` / ``F.group_norm`` (scale and bias in bf16, as those calls
take them).  ``rwkv6_scan_bwd`` at rwkv6-3b's training shape (B 8, H 40,
T 128, D 64, w f32), on contiguous tensors and on the transposed (B, H, T,
D) views the model passes, with the forward kernel beside it.  Each time
is the mean device ms a call over 20 replays of a CUDA graph of calls,
between CUDA events (``chip_smoke.device_ms``, phase 3's timer); a
``torch.profiler`` window of one call names the device kernels that ran.
It checks nothing: ``chip_smoke.py`` holds the kernels against their plain
versions.

Prints the card's name and power limit, then one JSON line a shape.
Needs the card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from chip_smoke import device_ms, nvidia_smi
from repro_torch.kernels.norm.ops import group_norm, layer_norm, rms_norm
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan, rwkv6_scan_bwd

NORM_SHAPES = (("qwen step RMS", 4, 2048, "rms"),
               ("qwen prefill RMS", 256, 2048, "rms"),
               ("stablelm train LayerNorm", 1024, 2048, "layer"),
               ("rwkv step groups of 64", 4, 2560, "group"),
               ("deepseek latent RMS", 4, 512, "rms"),
               ("deepseek latent slice RMS", 4, 512, "slice"))
RWKV_SHAPE = (8, 40, 128, 64)


def kernels_of(fn) -> list:
    """Names of the device kernels that ``fn()`` ran, under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key.replace("void ", "", 1).replace(
        "(anonymous namespace)::", "").split("(")[0]
        for e in prof.key_averages() if e.device_type.name == "CUDA"})


def run(label: str) -> list:
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16

    def normal(*shape, dtype=torch.float32, sc=1.0):
        return torch.from_numpy((sc * rng.standard_normal(shape)).astype(
            np.float32)).to(dev, dtype)

    rows = []
    for name, n_rows, d, form in NORM_SHAPES:
        x = normal(n_rows, 576 if form == "slice" else d, dtype=bf16)
        x = x[:, :d]
        scale, bias = normal(d), normal(d)
        if form in ("rms", "slice"):
            fn = lambda: rms_norm(x, scale, 1e-6)  # noqa: E731
            lib = lambda: F.rms_norm(x, (d,), scale.to(bf16), 1e-6)  # noqa: E731
        elif form == "layer":
            fn = lambda: layer_norm(x, scale, bias, 1e-5)  # noqa: E731
            lib = lambda: F.layer_norm(x, (d,), scale.to(bf16),  # noqa: E731
                                       bias.to(bf16), 1e-5)
        else:
            fn = lambda: group_norm(x, scale, None, 64, 1e-5)  # noqa: E731
            lib = lambda: F.group_norm(x, d // 64, scale.to(bf16), None,  # noqa: E731
                                       1e-5)
        rows.append({"label": label, "kernel": "norm", "shape": name,
                     "rows": n_rows, "d": d, "ms": device_ms(torch, fn, 100),
                     "library_ms": device_ms(torch, lib, 100),
                     "kernels": kernels_of(fn)})
    b, h, t, d = RWKV_SHAPE
    r, k, v = (normal(b, h, t, d, dtype=bf16, sc=0.5) for _ in range(3))
    w = torch.exp(-torch.exp(normal(b, h, t, d, sc=0.5) - 1.0))
    u = normal(h, d, sc=0.5)
    dy = normal(b, h, t, d, dtype=bf16)
    views = [z.transpose(1, 2).contiguous().transpose(1, 2)
             for z in (r, k, v, w, dy)]
    for name, (r_, k_, v_, w_, dy_) in (("contiguous", (r, k, v, w, dy)),
                                        ("transposed views", views)):
        fn = lambda: rwkv6_scan_bwd(r_, k_, v_, w_, u, dy_)  # noqa: E731
        rows.append({"label": label, "kernel": "rwkv6_scan_bwd",
                     "shape": f"rwkv6-3b training, {name}", "b": b, "h": h,
                     "t": t, "d": d, "ms": device_ms(torch, fn, 20),
                     "forward_ms": device_ms(
                         torch, lambda: rwkv6_scan(r_, k_, v_, w_, u), 20),
                     "kernels": kernels_of(fn)})
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default="tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_norm_rwkv_bwd needs the card")
    print(nvidia_smi("name,power.limit"), flush=True)
    for row in run(args.label):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
