"""The decode engine's step walls, busy time and device kernels a step, for
qwen2.5-3b, rwkv6-3b and moonshot-v1-16b-a3b at full width and depth, in a
process of their own.

Each model: a bf16 tree drawn on the card from seed 0,
``DecodeEngine(num_slots=4, max_len=512, bf16 cache)``, its four slots
filled by prefills of 256-token prompts (numpy seed 2); then five warm
steps (``generate``, each ending in its tokens' read-back: the median is
``step_ms``) and one step under ``torch.profiler`` (device busy time, the
union of its kernels' and copies' intervals, and the number of device
kernels it ran).  It checks nothing of the port but that the engine runs:
two trees of the port are compared in one call by running this once for
each, in turns (parent, change, change, parent), with ``PYTHONPATH``
naming each tree's ``src``::

    PYTHONPATH=<tree>/src python3 -m benchmarks_torch.engine_walls \\
        [--label NAME] [--arch ARCH ...]

Prints the card's name and power limit, then one JSON line a model.
Needs the card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch

import repro_torch
from repro_torch.configs import get as get_arch
from repro_torch.models.params import init_params
from repro_torch.models.transformer import model_spec
from repro_torch.serve import DecodeEngine

ARCHS = ("qwen2.5-3b", "rwkv6-3b", "moonshot-v1-16b-a3b")
SLOTS, MAX_LEN, PROMPT = 4, 512, 256


def profile_step(fn):
    """(device busy ms, device kernels) of one ``fn()`` under
    ``torch.profiler``: busy is the union of the device events' intervals;
    kernels counts the device events that are kernels (not copies or
    sets)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, kernels = [], 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        kernels += not ev.name.startswith(("Memcpy", "Memset"))
    busy, reach = 0.0, -math.inf
    for t0, t1 in sorted(spans):
        busy += max(0.0, t1 - max(t0, reach))
        reach = max(reach, t1)
    return busy * 1e-3, kernels


def run(label: str, archs=ARCHS):
    """-> one row of walls for each model of ``archs``."""
    dev = torch.device("cuda")
    rows = []
    for arch in archs:
        cfg = get_arch(arch)
        tree = init_params(model_spec(cfg), 0, dtype=torch.bfloat16,
                           device=dev)
        eng = DecodeEngine(cfg, tree, num_slots=SLOTS, max_len=MAX_LEN,
                           cache_dtype=torch.bfloat16)
        prompts = np.random.default_rng(2).integers(
            0, cfg.vocab, (SLOTS, PROMPT)).astype(np.int32)
        state = eng.init_state()
        for i in range(SLOTS):
            state = eng.insert(eng.prefill(None, prompts[i]), state, i)
        for _ in range(2):                         # capture and warm up
            state, _ = eng.generate(None, state)
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            state, _ = eng.generate(None, state)
            walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        busy_ms, kernels = profile_step(lambda: eng.generate(None, state))
        profiled_ms = (time.perf_counter() - t0) * 1e3
        rows.append({
            "label": label, "arch": arch, "port": repro_torch.__file__,
            "step_ms": sorted(walls)[2] * 1e3, "profiled_step_ms": profiled_ms,
            "step_busy_ms": busy_ms, "kernels_a_step": kernels})
        del eng, tree, state
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="port")
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    for row in run(args.label, args.arch):
        print(json.dumps(row), flush=True)
