"""The port's continuous-batching decode engine against the JAX package's,
on the CPU.

``tests/test_decode_serve.py``'s engine tests, ported for the cache
families the port builds — ``qwen2.5-3b`` (plain KV cache), ``rwkv6-3b``
(O(1) recurrent state), ``deepseek-v2-236b`` (MLA latent cache behind a
dense first layer, MoE MLPs with shared experts), ``moonshot-v1-16b-a3b``
(KV cache, MoE MLPs) and ``jamba-1.5-large-398b`` (seven mamba layers'
conv windows and ssm states beside one attention layer's KV cache, dense
and MoE MLPs; the conv window held in f32, the step's own dtype, under
the f32 compute dtype and a bf16 cache) at ``.reduced()`` size,
float32, at the configs' own capacity factor (the JAX package's test of
this engine raises it to 4).  Each test initialises the JAX package's parameters, carries the same
numpy tree to the port (``tree_from_jax``, the conversion
``params_from_jax`` uses) and runs both engines on the same numpy prompts.

Tolerances: none.  Tokens are compared bit for bit — against the JAX
engine, against whole-batch ``greedy_generate`` of both packages and, for
the per-row positions of the decode step, against the scalar-position step
row by row (logits and cache, ``torch.equal``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import init_params as j_init_params
from repro.models import model_spec as j_model_spec
from repro.serve import DecodeEngine as JDecodeEngine
from repro.serve import batch_axes as j_batch_axes
from repro.train.serve import greedy_generate as j_greedy_generate
from repro_torch import configs
from repro_torch.core import EGPU_16T
from repro_torch.models.convert import tree_from_jax
from repro_torch.models.transformer import decode_step, prefill
from repro_torch.serve import (DecodeEngine, QueueWorker, batch_axes,
                               graph_traffic)
from repro_torch.train.serve import greedy_generate

BATCH, PROMPT, NEW = 2, 12, 4

FAMILIES = ["qwen2.5-3b",       # GQA: plain KV cache
            "rwkv6-3b",         # O(1) recurrent state
            "deepseek-v2-236b",   # MLA latent cache, dense layer0, MoE
            "moonshot-v1-16b-a3b",  # KV cache, MoE
            "jamba-1.5-large-398b"]  # mamba states + one KV layer, MoE


def _setup(arch, batch, prompt_len, seed=1):
    """(port cfg, JAX cfg, JAX params, the same tree as CPU tensors,
    int32 numpy prompts)."""
    jcfg = J_ARCHS[arch].reduced()
    cfg = configs.get(arch).reduced()
    jparams = j_init_params(j_model_spec(jcfg), jax.random.PRNGKey(0))
    tree = tree_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                         device="cpu")
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    return cfg, jcfg, jparams, tree, prompts


def _run_both(arch, batch, max_len, prompts, jparams, jcfg, cfg, tree):
    """Both engines, one request per slot, NEW tokens each."""
    out = []
    for eng in (JDecodeEngine(jcfg, jparams, num_slots=batch,
                              max_len=max_len),
                DecodeEngine(cfg, tree, num_slots=batch, max_len=max_len,
                             device="cpu")):
        state = eng.init_state()
        for i in range(batch):
            state = eng.insert(eng.prefill(None, prompts[i]), state, slot=i)
        got = [np.asarray(state.tokens)]      # token 1 comes from prefill
        for _ in range(NEW - 1):
            state, toks = eng.generate(None, state)
            got.append(np.asarray(toks))
        out.append((eng, np.stack(got, axis=1)))
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_generate_cache_family(arch):
    """Deterministic, and the JAX package's tokens."""
    cfg, jcfg, jparams, tree, prompts = _setup(arch, BATCH, PROMPT)
    eng = DecodeEngine(cfg, tree, num_slots=BATCH, max_len=PROMPT + NEW + 1,
                       device="cpu")
    out = greedy_generate(eng.model, prompts, NEW, PROMPT + NEW + 1)
    assert out.shape == (BATCH, NEW) and out.dtype == torch.int32
    assert bool(((out >= 0) & (out < cfg.vocab_padded)).all())
    again = greedy_generate(eng.model, prompts, NEW, PROMPT + NEW + 1)
    assert torch.equal(out, again)
    want = j_greedy_generate(jparams, jcfg, jnp.asarray(prompts),
                             max_new=NEW, max_len=PROMPT + NEW + 1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_bit_identical_per_family(arch):
    """Engine slots == whole-batch greedy_generate == the JAX engine, bit
    for bit — off exactly one prefill + one decode graph."""
    cfg, jcfg, jparams, tree, prompts = _setup(arch, BATCH, PROMPT)
    max_len = PROMPT + NEW + 1
    (jeng, jgot), (eng, got) = _run_both(arch, BATCH, max_len, prompts,
                                         jparams, jcfg, cfg, tree)
    ref = greedy_generate(eng.model, prompts, NEW, max_len).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jgot)
    # zero re-capture: ONE prefill graph + ONE decode graph, period
    assert eng.cache.misses == 2 == jeng.cache.misses
    assert eng.cache.hits == (BATCH - 1) + (NEW - 2) == jeng.cache.hits
    assert eng.cache.findings == 0 and eng.cache.verified == 2
    assert eng.stats() == jeng.stats()


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v2-236b"])
def test_engine_routes_one_group_per_slot_as_the_jax_engine(arch):
    """The JAX engine vmaps a batch-1 step over its slots, so each slot's
    token is an MoE routing group of its own at any width; the JAX stack's
    rule groups B // 16 tokens of a batch-B step.  With a zero router every
    token ties on every expert and picks experts 0 and 1 (the lower index
    first), so at 144 slots the rule's groups of 9 overflow those experts'
    capacity of 8 and drop assignments that groups of one keep.  The port's
    engine must give the JAX engine's tokens, and whole-batch
    ``greedy_generate`` (the rule, in both packages) other ones."""
    slots, prompt_len = 144, 4
    cfg, jcfg, jparams, tree, prompts = _setup(arch, slots, prompt_len)
    pos = [k for k, v in jparams["blocks"].items() if "router" in v["mlp"]][0]
    jparams["blocks"][pos]["mlp"]["router"] = jnp.zeros_like(
        jparams["blocks"][pos]["mlp"]["router"])
    tree["blocks"][pos]["mlp"]["router"].zero_()
    max_len = prompt_len + NEW + 1
    (jeng, jgot), (eng, got) = _run_both(arch, slots, max_len, prompts,
                                         jparams, jcfg, cfg, tree)
    np.testing.assert_array_equal(got, jgot)
    assert eng.cache.misses == 2 == jeng.cache.misses
    assert eng.stats() == jeng.stats()
    whole = greedy_generate(eng.model, prompts, NEW, max_len).numpy()
    np.testing.assert_array_equal(whole, np.asarray(j_greedy_generate(
        jparams, jcfg, jnp.asarray(prompts), max_new=NEW, max_len=max_len)))
    assert not np.array_equal(whole, got)


def test_engine_staggered_insert_and_slot_reuse():
    """A request spliced into a freed slot mid-generation decodes the same
    bits as the whole-batch reference (and the JAX engine), and never
    perturbs its neighbor."""
    cfg, jcfg, jparams, tree, prompts = _setup("qwen2.5-3b", 3, PROMPT)
    new_long = 6
    max_len = PROMPT + new_long + 1
    runs = []
    for eng in (JDecodeEngine(jcfg, jparams, num_slots=2, max_len=max_len),
                DecodeEngine(cfg, tree, num_slots=2, max_len=max_len,
                             device="cpu")):
        state = eng.init_state()
        # r0 (short) and r1 (long) start together in slots 0/1
        state = eng.insert(eng.prefill(None, prompts[0]), state, slot=0)
        state = eng.insert(eng.prefill(None, prompts[1]), state, slot=1)
        out = {0: [int(state.tokens[0])], 1: [int(state.tokens[1])]}
        for _ in range(2):
            state, toks = eng.generate(None, state)
            out[0].append(int(toks[0]))
            out[1].append(int(toks[1]))
        # r0 finishes after 3 tokens; its slot is reused by r2
        state = eng.release(state, 0)
        state = eng.insert(eng.prefill(None, prompts[2]), state, slot=0)
        out[2] = [int(state.tokens[0])]
        for _ in range(new_long - 3):
            state, toks = eng.generate(None, state)
            out[2].append(int(toks[0]))
            out[1].append(int(toks[1]))
        assert eng.cache.misses == 2             # still just two graphs
        runs.append((eng, out))
    (jeng, jout), (eng, out) = runs
    ref = greedy_generate(eng.model, prompts, new_long, max_len).numpy()
    assert out[0] == list(ref[0][:3])
    assert out[1] == list(ref[1])                # neighbor never perturbed
    assert out[2] == list(ref[2][:new_long - 2])
    assert out == jout
    assert eng.stats() == jeng.stats()


def test_engine_decode_graph_carries_no_logits():
    """The per-step graph's outputs are tokens + cache only — no
    ``(num_slots, vocab)`` logits ride the hot decode loop — and its cache
    outputs are the donated cache tensors, written in place."""
    cfg, _, _, tree, prompts = _setup("qwen2.5-3b", 1, PROMPT)
    eng = DecodeEngine(cfg, tree, num_slots=2, max_len=PROMPT + 4,
                       device="cpu")
    state = eng.insert(eng.prefill(None, prompts[0]), eng.init_state(), 0)
    leaves = [state.cache["pos0"]["k"], state.cache["pos0"]["v"]]
    state, _ = eng.generate(None, state)
    assert eng.decode_graph is not None
    for aval in eng.decode_graph.out_avals:
        assert not (len(aval.shape) >= 2
                    and aval.shape[0] == eng.num_slots
                    and aval.shape[-1] == cfg.vocab_padded), (
            f"decode step leaked a logits-shaped output {aval.shape}")
    assert state.cache["pos0"]["k"] is leaves[0]
    assert state.cache["pos0"]["v"] is leaves[1]
    # roofline comes straight off the captured schedule
    roof = eng.roofline()
    assert roof is not None and roof.bytes_per_step > 0
    assert 0.0 <= roof.mem_bound_fraction <= 1.0
    assert graph_traffic(eng.decode_graph)[0] == roof.dcache_bytes


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_per_row_positions_bit_equal(arch):
    """A (B,) positions tensor of different values gives each row the bits
    of the scalar-position step of the same batch at that row's position
    (logits and cache); rwkv reads no position at all."""
    cfg, _, _, tree, prompts = _setup(arch, 3, 10)
    eng = DecodeEngine(cfg, tree, num_slots=3, max_len=16, device="cpu")
    _, cache = prefill(eng.model, {"tokens": torch.from_numpy(prompts)}, 16)
    tokens = torch.tensor([5, 17, 3], dtype=torch.int32)
    positions = torch.tensor([10, 13, 11], dtype=torch.int32)

    def clone(c):
        return {k: ({n: t.clone() for n, t in v.items()}
                    if isinstance(v, dict) else tuple(t.clone() for t in v))
                for k, v in c.items()}

    def leaves(c):
        out = []
        for k in sorted(c):
            v = c[k]
            out += [v[n] for n in sorted(v)] if isinstance(v, dict) else list(v)
        return out

    # each leaf's batch axis (1 behind the stacked layers, 0 in layer0)
    axes = leaves(batch_axes(cfg))
    logits, got = decode_step(eng.model, clone(cache), tokens, positions)
    for row, pos in enumerate(positions.tolist()):
        want_logits, want = decode_step(eng.model, clone(cache), tokens,
                                        pos if arch != "rwkv6-3b" else 0)
        assert torch.equal(logits[row], want_logits[row])
        for g, w, ax in zip(leaves(got), leaves(want), axes):
            assert torch.equal(g.select(ax, row), w.select(ax, row))
    # the step runs on meta tensors (capture) with a meta positions tensor
    meta = {k: ({n: t.to("meta") for n, t in v.items()}
                if isinstance(v, dict) else tuple(t.to("meta") for t in v))
            for k, v in cache.items()}
    mlogits, _ = decode_step(eng.model.to("meta"), meta, tokens.to("meta"),
                             positions.to("meta"))
    assert mlogits.device.type == "meta" and mlogits.shape == logits.shape


@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_layout_matches_the_jax_engine(arch):
    """batch_axes and the canonical persistent-cache structs (the decode
    step's own fixed point: rwkv's token shifts at the activation dtype)
    equal the JAX engine's."""
    cfg, jcfg, jparams, tree, _ = _setup(arch, 1, 4)
    assert batch_axes(cfg) == j_batch_axes(jcfg)
    eng = DecodeEngine(cfg, tree, num_slots=3, max_len=16, device="cpu")
    jeng = JDecodeEngine(jcfg, jparams, num_slots=3, max_len=16)
    got = eng._cache_structs()
    want = jeng._cache_structs()
    assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in got] == [(s.shape, str(s.dtype)) for s in want]
    state = eng.init_state()
    assert state.tokens.dtype == state.positions.dtype == torch.int32
    assert all(t.device.type == "cpu" for t in (state.tokens,
                                                state.positions))


def test_engine_runs_on_the_card_unless_asked_and_refuses_what_jax_refuses():
    cfg, _, _, tree, _ = _setup("qwen2.5-3b", 1, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DecodeEngine(cfg, tree)
    with pytest.raises(ValueError, match="explicit_transfers=False"):
        DecodeEngine(cfg, tree, worker=QueueWorker(EGPU_16T, device="cpu"),
                     device="cpu")
    enc = configs.get("hubert-xlarge").reduced()
    with pytest.raises(ValueError, match="encoder-only"):
        DecodeEngine(enc, tree, device="cpu")
    with pytest.raises(ValueError, match="num_slots"):
        DecodeEngine(cfg, tree, num_slots=0, device="cpu")
    eng = DecodeEngine(cfg, tree, num_slots=1, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.prefill(None, np.zeros(8, np.int32))
    with pytest.raises(ValueError, match="bound params"):
        eng.prefill({}, np.zeros(3, np.int32))
    # modeled bytes come from the f32 tree passed in, not the model storage
    assert eng._params_bytes == 4.0 * sum(
        p.numel() for p in eng.model.parameters())
