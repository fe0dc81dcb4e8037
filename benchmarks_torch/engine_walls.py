"""The decode engine's walls for qwen2.5-3b and rwkv6-3b, as
``chip_smoke.py`` phase 8 measures them, in a process of their own.

Each model goes through ``chip_smoke.serve_engine`` (seed-0 weights as an
f32 tree, ``DecodeEngine(num_slots=4, max_len=512)`` behind an engine-only
``Server``, six staggered 256-token requests of 16 new tokens, every check
of phase 8), and its walls print as one JSON line.  Two trees of the port
are compared in one call by running this once for each, in turns, with
``PYTHONPATH`` naming each tree's ``src`` (the script and
``chip_smoke.py`` come from the working directory, the port from
``PYTHONPATH``)::

    PYTHONPATH=<tree>/src python3 -m benchmarks_torch.engine_walls \\
        [--label NAME] [--dense-silu]

``--dense-silu`` gives the dense MLPs ``F.silu`` (one kernel) in place of
the JAX package's expansion ``x * (1 / (1 + exp(-x)))`` (five), to price
the expansion on a step whose host bounds it.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke
import repro_torch
from repro_torch.configs import get as get_arch
from repro_torch.models import layers

#: (arch, the kernels of ours its engine path runs, their launches a layer
#: a step)
MODELS = ((chip_smoke.LM_ARCH, chip_smoke.LM_KERNELS, 0),
          (chip_smoke.RWKV_ARCH, chip_smoke.RWKV_KERNELS, 1))


def run(label: str, dense_silu: bool = False):
    """-> one row of walls for each model of :data:`MODELS`."""
    if dense_silu:
        expanded = layers.act_fn
        layers.act_fn = lambda cfg: (F.silu if cfg.act != "gelu"
                                     else expanded(cfg))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rows = []
    for arch, ours, per_step in MODELS:
        e = chip_smoke.serve_engine(torch, np, dev, get_arch(arch), ours,
                                    per_step)
        wall, busy, _ = e["profile"]
        rows.append({
            "label": label, "dense_silu": dense_silu, "arch": arch,
            "port": repro_torch.__file__, "step_ms": e["step_ms"],
            "prefill_ms": e["prefill_ms"], "served_wall_s": e["served_wall"],
            "tokens_per_s": e["tokens_per_s"],
            "profiled_step_ms": wall * 1e3, "step_busy_ms": busy * 1e3,
            "step_idle": 1 - busy / wall})
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="port")
    ap.add_argument("--dense-silu", action="store_true")
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    for row in run(args.label, args.dense_silu):
        print(json.dumps(row), flush=True)
