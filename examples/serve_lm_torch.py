"""Serving example on the PyTorch port: autoregressive LM decode through the
continuous-batching engine — ``Server(engine=DecodeEngine(...))`` with
per-request streaming, ending in a :class:`ServeReport` printout.  The port
of ``examples/serve_lm.py``.

A reduced GQA transformer (qwen2.5-3b's geometry cut to ``.reduced()``,
plain KV cache) serves a staggered stream of prompts over a handful of
decode slots: each request is prefilled batch-1, spliced into a free slot
of the persistent batched decode state, and advanced one token per step by
the replay of ONE cached ``CommandGraph`` — freed slots admit the next
waiting request mid-generation, and ``Server.stream`` yields each
request's tokens as its steps land.  The example asserts that

* the warm engine performs ZERO re-captures (one prefill graph + one
  decode graph, every launch after that a GraphCache hit), and
* every streamed result is bit-identical to whole-batch
  ``greedy_generate`` on the same device — slot insertion never perturbs
  a neighbor.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.models.params import init_params
from repro_torch.models.transformer import model_spec
from repro_torch.serve import DecodeEngine, Server
from repro_torch.train.serve import greedy_generate

ARCH = "qwen2.5-3b"
SLOTS = 4
N_REQUESTS = 12      # 3x oversubscribed: slots churn mid-generation
PROMPT = 12
MAX_NEW = 8
MAX_LEN = PROMPT + MAX_NEW + 1


def main(device="cuda"):
    cfg = configs.get(ARCH).reduced()
    params = init_params(model_spec(cfg), 0, device=device)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (N_REQUESTS, PROMPT)).astype(np.int32)

    engine = DecodeEngine(cfg, params, num_slots=SLOTS, max_len=MAX_LEN,
                          device=device)
    server = Server((), workers=(), engine=engine)

    # -- submit everything up front; stream one request while it decodes ----
    t0 = time.perf_counter()
    rids = [server.submit_decode(prompts[i], max_new=MAX_NEW)
            for i in range(N_REQUESTS)]
    streamed = list(server.stream(rids[0]))    # live per-step iterator
    server.flush()                             # drain the remaining slots
    wall = time.perf_counter() - t0

    # -- zero re-capture: ONE prefill graph + ONE decode graph --------------
    assert engine.cache.misses == 2, (
        f"engine re-captured a graph: {engine.cache.stats()}")

    # -- streamed == whole-batch greedy decode, bit for bit -----------------
    ref = greedy_generate(engine.model, prompts, MAX_NEW,
                          MAX_LEN).cpu().numpy()
    assert streamed == [int(t) for t in ref[0]], (
        "streamed tokens diverged from greedy decode")
    for i, rid in enumerate(rids):
        (got,) = server.result(rid)
        assert np.array_equal(got, ref[i]), (
            f"request {rid}: engine decode diverged from greedy decode")

    report = server.report()
    roof = engine.roofline()
    print("=" * 72)
    print(f"serve_lm_torch: {N_REQUESTS} requests x {MAX_NEW} tokens ({ARCH} "
          f"reduced) on {SLOTS} decode slots, {engine.device}")
    print("=" * 72)
    print(report.summary())
    print(f"\n{report.engine_tokens_per_s_modeled:,.0f} tok/s modeled "
          f"({N_REQUESTS * MAX_NEW / wall:,.0f} tok/s wall incl. capture), "
          f"occupancy {report.engine_slot_occupancy:.0%}, "
          f"{roof.bytes_per_step:,.0f} B/step "
          f"({roof.mem_bound_fraction:.0%} memory-bound)")
    print("\nserve_lm_torch OK — warm engine re-captured nothing; streamed "
          "results bit-identical to greedy decode")
    return report


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="torch device the model runs on (default: cuda)")
    main(parser.parse_args().device)
