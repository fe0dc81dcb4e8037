"""Fig 4 — TinyBio: per-stage speed-up & energy reduction vs the host.

The port of ``benchmarks/bench_tinybio.py``.  Runs the real 4-stage
pipeline (FIR → delineation → FFT features → SVM) on the port's TinyCL
runtime for each e-GPU config: the modeled comparison (the paper's Fig-4
bands) equals the JAX package's, and eager and graph dispatch run side by
side, warmed up, with the wall clock of each per pipeline run and the
check that their outputs agree.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_tinybio
"""

import time
from typing import Any

import numpy as np
import torch

from repro_torch.apps.tinybio import tinybio_stages
from repro_torch.core import APU, EGPU_4T, EGPU_8T, EGPU_16T, CommandQueue
from repro_torch.core.runtime import resolve_device

PAPER = {  # (4T, 16T) anchors from the paper
    "fir": (3.6, 15.1), "delineate_keep": (3.1, 13.1),
    "fft_features": (3.3, 14.0), "app": (3.4, 14.3),
}
REPS = 5
TRIALS = 3         # best-of (min): robust to scheduler noise on shared hosts


def _best_of(once, dev):
    def synced():
        out = once()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out
    synced()                             # warm up
    best = float("inf")
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        for _ in range(REPS):
            out = synced()
        best = min(best, (time.perf_counter() - t0) / REPS)
    return out, best


def _wall_eager(apu, stages, inputs):
    # ONE queue across reps; finish() only drains events new since the
    # previous rep, and release_events() keeps the queue O(1).
    q = CommandQueue(apu.egpu_ctx)

    def once():
        bufs, _ = apu.wire_pipeline(q, stages, inputs)
        q.finish()
        q.release_events()
        return bufs

    return _best_of(once, apu.device)


def _wall_graph(apu, stages, inputs):
    graph = apu.capture_pipeline(stages, inputs)
    q = CommandQueue(apu.egpu_ctx)

    def once():
        outs = graph.launch(queue=q)
        q.finish()
        q.release_events()
        return outs

    return _best_of(once, apu.device)


def run(device: Any = "cuda"):
    dev = resolve_device(device)
    print("=" * 76)
    print(f"Fig 4 — TinyBio speed-up & energy vs X-HEEP host (modeled; walls "
          f"on {dev.type})")
    print("=" * 76)
    rows = []
    for cfg in (EGPU_4T, EGPU_8T, EGPU_16T):
        apu = APU(cfg, device=dev)
        stages, inputs = tinybio_stages(cfg, device=dev)
        (dec_buf,), rep = apu.offload(stages, inputs, mode="graph")
        (eager_out,), wall_eager = _wall_eager(apu, stages, inputs)
        (graph_out,), wall_graph = _wall_graph(apu, stages, inputs)
        np.testing.assert_allclose(graph_out.data.cpu().numpy(),
                                   eager_out.data.cpu().numpy(), atol=1e-5)
        np.testing.assert_allclose(graph_out.data.cpu().numpy(),
                                   dec_buf.data.cpu().numpy(), atol=1e-5)
        per = {s.name: (s.speedup, s.energy_reduction) for s in rep.stages}
        per["app"] = (rep.overall_speedup, rep.overall_energy_reduction)
        rows.append({"config": cfg.name, "device": dev.type,
                     **{k: v[0] for k, v in per.items()},
                     "fused_speedup": rep.fused_speedup,
                     "wall_eager_s": wall_eager,
                     "wall_graph_s": wall_graph})
        parts = " | ".join(f"{k.split('_')[0]} {v[0]:5.2f}x/E{v[1]:4.2f}"
                           for k, v in per.items())
        print(f"{cfg.name:10s} {parts}")
        print(f"{'':10s} fused-chain {rep.fused_speedup:5.2f}x | warm "
              f"pipeline wall: eager {wall_eager*1e3:7.3f} ms vs graph "
              f"{wall_graph*1e3:7.3f} ms (outputs agree)")
    print("\npaper bands:  fir 3.6–15.1x | delineation 3.1–13.1x | "
          "fft 3.3–14.0x | app 3.4–14.3x | energy 1.7–3.1x")
    return rows


if __name__ == "__main__":
    run()
