"""Continuous-batching decode: engine slots vs naive rebatch-per-step.

The port of ``benchmarks/bench_decode.py``.  The
:class:`~repro_torch.serve.DecodeEngine` turns steady-state autoregressive
decode into the replay of ONE cached ``CommandGraph``: the batched decode
state stays resident on the engine's device (donated back into every
launch and written in place), so a step's host traffic is exactly the
token/position I/O.  The naive baseline — rebatching per step, which
round-trips the whole KV cache through the host both ways every token — is
the SAME engine priced with ``resident=False``; both arms decode the same
staggered workload bit-identically, so the modeled tokens/s ratio isolates
residency, and it must stay >= 1.3x (deterministic: machine model, never
wall clock).

The roofline readout comes straight off the captured schedule
(:class:`~repro_torch.serve.EngineRoofline`): bytes/step, the
bandwidth-floor step time, and how memory-bound the step is.  A traced arm
replays the workload under a :class:`~repro_torch.obs.Tracer` on a virtual
clock and asserts ZERO modeled perturbation against an untraced twin.

Every modeled number equals the JAX bench's (the weights differ — this
bench draws them with the port's ``init_params(seed=0)`` — but no modeled
number reads a weight).  ``wall_tokens_per_s`` is this host's or card's
clock.  ``run()`` prints and returns the JAX bench's result keys; it
writes no file.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_decode [--device cpu]
"""

import argparse
import time
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.runtime import resolve_device
from repro_torch.models.params import init_params
from repro_torch.models.transformer import model_spec
from repro_torch.obs import Tracer
from repro_torch.serve import DecodeEngine
from repro_torch.train.serve import greedy_generate

ARCH = "qwen2.5-3b"
SLOTS = 4
N_REQ = 8          # staggered: 2x oversubscribed so slots churn
PROMPT = 12
NEW = 6            # tokens per request (1 from prefill + NEW-1 decode steps)
MAX_LEN = 96       # serving-sized KV allocation (what the naive arm moves)
GATE_X = 1.3       # resident vs rebatch-per-step, modeled tokens/s


def _workload(eng: DecodeEngine, prompts: np.ndarray) -> Dict[int, List[int]]:
    """Drain N_REQ staggered requests through the engine's slots."""
    state = eng.init_state()
    pending = list(range(len(prompts)))
    live = {}                                  # slot -> (req, remaining)
    outs: Dict[int, List[int]] = {}
    while pending or live:
        for slot in state.free_slots():
            if not pending:
                break
            r = pending.pop(0)
            pre = eng.prefill(None, prompts[r])
            state = eng.insert(pre, state, slot)
            live[slot] = (r, NEW - 1)
            outs[r] = [int(pre.token[0])]
        state, toks = eng.generate(None, state)
        for slot in list(live):
            r, rem = live[slot]
            outs[r].append(int(toks[slot]))
            if rem - 1 == 0:
                state = eng.release(state, slot)
                del live[slot]
            else:
                live[slot] = (r, rem - 1)
    return outs


def _arm(cfg, tree, prompts, dev, *, resident, tracer=None, clock=None):
    eng = DecodeEngine(cfg, tree, num_slots=SLOTS, max_len=MAX_LEN,
                       resident=resident, tracer=tracer,
                       clock=clock if clock is not None else time.perf_counter,
                       device=dev)
    outs = _workload(eng, prompts)             # warm: captures both graphs
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs2 = _workload(eng, prompts)            # steady state: replay only
    wall = time.perf_counter() - t0
    assert outs == outs2, "decode is deterministic"
    assert eng.cache.misses == 2, eng.cache.stats()
    return eng, outs, wall


def _traced_arm(cfg, tree, prompts, dev) -> Dict[str, Any]:
    """Tracing must not perturb the modeled totals by one bit."""
    t = [0.0]
    tracer = Tracer()
    eng_t, outs_t, _ = _arm(cfg, tree, prompts, dev, resident=True,
                            tracer=tracer, clock=lambda: t[0])
    eng_u, outs_u, _ = _arm(cfg, tree, prompts, dev, resident=True,
                            clock=lambda: t[0])
    assert outs_t == outs_u, "tracing perturbed the decoded tokens"
    totals_t = (eng_t.n_steps, eng_t.n_tokens, eng_t.n_prefills,
                eng_t.prefill_modeled_s, eng_t.decode_modeled_s,
                eng_t.energy_j, eng_t.occupancy)
    totals_u = (eng_u.n_steps, eng_u.n_tokens, eng_u.n_prefills,
                eng_u.prefill_modeled_s, eng_u.decode_modeled_s,
                eng_u.energy_j, eng_u.occupancy)
    assert totals_t == totals_u, "tracing perturbed the modeled totals"
    n_gen = len([s for s in tracer.spans if s.name == "engine.generate"])
    assert n_gen == eng_t.n_steps, (n_gen, eng_t.n_steps)
    print(f"  traced arm: {n_gen} engine.generate spans, modeled totals "
          f"identical to untraced twin")
    return {"n_generate_spans": n_gen, "modeled_totals_equal": True}


def run(device: Any = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    print("=" * 76)
    print("Continuous-batching decode: resident slots vs rebatch-per-step")
    print(f"({ARCH} reduced, {N_REQ} staggered requests x {NEW} tokens on "
          f"{SLOTS} slots, {dev})")
    print("=" * 76)
    cfg = configs.get(ARCH).reduced()
    tree = init_params(model_spec(cfg), 0, device=dev)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (N_REQ, PROMPT)).astype(np.int32)

    engine, outs_e, wall_e = _arm(cfg, tree, prompts, dev, resident=True)
    naive, outs_n, _ = _arm(cfg, tree, prompts, dev, resident=False)
    ref = greedy_generate(engine.model, prompts, NEW,
                          PROMPT + NEW + 1).cpu().numpy()

    # honesty first: both arms must deliver the whole-batch greedy bits
    for r in range(N_REQ):
        assert outs_e[r] == list(ref[r]), (r, outs_e[r], list(ref[r]))
    assert outs_n == outs_e, "naive arm diverged from engine arm"

    tps_e = engine.tokens_per_s_modeled
    tps_n = naive.tokens_per_s_modeled
    ratio = tps_e / tps_n
    assert ratio >= GATE_X, f"resident vs rebatch {ratio:.3f}x < {GATE_X}x"
    roof = engine.roofline()
    wall_tps = engine.n_tokens / 2 / wall_e    # stats span both workloads
    print(f"  engine (resident)   {tps_e:12.0f} tok/s modeled   "
          f"occupancy {engine.occupancy:.0%}")
    print(f"  naive rebatch/step  {tps_n:12.0f} tok/s modeled")
    print(f"  wall (steady state) {wall_tps:12.0f} tok/s on {dev}")
    print(f"\n  resident decode is {ratio:.2f}x the rebatch-per-step "
          f"baseline (>= {GATE_X}x gate)")
    print(f"  roofline: {roof.bytes_per_step:,.0f} B/step -> "
          f"{roof.min_step_s * 1e6:.1f} us bandwidth floor, "
          f"{roof.mem_bound_fraction:.0%} memory-bound")

    traced = _traced_arm(cfg, tree, prompts, dev)
    return {
        "bench": "decode",
        "arch": ARCH,
        "slots": SLOTS,
        "n_requests": N_REQ,
        "tokens_per_request": NEW,
        "tokens_per_s_modeled": {"engine": tps_e, "naive_rebatch": tps_n},
        "resident_vs_rebatch_speedup": ratio,
        "wall_tokens_per_s": wall_tps,
        "occupancy": engine.occupancy,
        "roofline": {
            "bytes_per_step": roof.bytes_per_step,
            "min_step_s": roof.min_step_s,
            "mem_bound_fraction": roof.mem_bound_fraction,
            "modeled_step_s": roof.modeled_step_s,
        },
        "bit_identical_to_greedy": True,
        "cache_stats": engine.cache.stats(),
        "traced": traced,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args().device)
