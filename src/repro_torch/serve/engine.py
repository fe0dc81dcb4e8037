"""Slot-based continuous-batching decode engine.

The JAX package's ``repro.serve.engine`` in PyTorch — the maxtext/JetStream
serving split, on TinyCL primitives:

- :meth:`DecodeEngine.prefill` runs one request's prompt through a cached
  per-prompt-length ``CommandGraph`` and returns a :class:`Prefix` — the
  first greedy token plus the request's batch-1 cache.
- :meth:`DecodeEngine.insert` splices a prefix into slot ``i`` of a
  persistent :class:`DecodeState` whose cache leaves live batch-``num_slots``
  wide on the engine's torch device.
- :meth:`DecodeEngine.generate` advances ALL occupied slots one token in
  exactly ONE cached-graph launch per step; freed slots admit freshly
  prefilled requests between steps, so a finished request never blocks its
  neighbors.

Engine invariants (pinned by ``tests/test_torch_engine.py``):

- **One cached graph per generate step.**  The step graph is captured once
  per (model config, num_slots) and re-launched with
  ``launch_prefix(..., donate=<cache leaves>)`` — slot insertion is a
  launch-time buffer update, never a re-capture, and the graphs stay pure:
  slot state is data the launch carries, not state the capture holds.
- **Slot insertion never perturbs other slots' outputs.**  The step is ONE
  batched decode step over a ``(num_slots,)`` positions tensor (where the
  JAX package ``jax.vmap``\\ s a per-slot step): every row reads only its
  own cache slot, token and position, and a scalar-position step goes
  through the same arithmetic, so decode under staggered arrival gives the
  bits of whole-batch :func:`~repro_torch.train.serve.greedy_generate` for
  every cache family the port builds (plain KV, MLA latents, rwkv6 and
  mamba O(1) states).
- **Honest accounting.**  The bytes-per-step roofline
  (:func:`engine_roofline`) is summed off the captured schedule's
  :class:`~repro_torch.core.runtime.GraphNode` counts — the
  :class:`~repro_torch.core.machine.WorkCounts` each node was actually
  priced with — never re-derived on the side.  The parameter bytes are
  those of the JAX-layout tree the caller passed (float32 from
  ``init_params``), not of the model's compute-dtype storage.
- **No full-vocabulary output rides the step graph.**  The decode kernel
  uses :func:`~repro_torch.train.serve.make_decode_step` with
  ``return_logits=False``; :attr:`DecodeEngine.decode_graph`'s out avals
  carry tokens + cache only (checked at capture).

The model's parameters are launch inputs: the executors map the leaves
back onto the :class:`~repro_torch.models.transformer.Transformer`'s
layout (:class:`_BoundModel`), so a captured graph holds no weights of its
own and its :class:`~repro_torch.serve.cache.GraphCache` key pins their
shapes.
Capture runs both executors on ``meta`` tensors; neither reads data on the
host.  The decode step writes the resident cache in place, so a launch's
cache outputs are the donated input tensors themselves — no cache copy per
step.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.apu import Stage
from ..core.device import EGPUConfig, EGPU_16T
from ..core.machine import WorkCounts
from ..core.program import KernelRegistry, Program, kernel_family
from ..core.runtime import CommandGraph, Kernel, canonical_device
from ..core.scheduler import optimal_ndrange
from ..models.config import ModelConfig
from ..models.params import leaves_with_path, map_tree
from ..models.transformer import (Transformer, cache_axes, cache_struct,
                                  model_spec, n_scanned)
from ..obs import Tracer
from ..train.serve import make_decode_step, make_prefill_step
from .batching import MicroBatch
from .cache import GraphCache
from .dispatch import QueueWorker

_TOKEN_BYTES = 4                     # int32 token / position ids


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x)


def _tree_leaves(tree: Any, is_leaf: Callable[[Any], bool] = lambda x: False
                 ) -> List[Any]:
    """Leaves of a cache-shaped tree in ``jax.tree_util`` order (dict keys
    sorted, tuples in order)."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _tree_leaves(t, is_leaf)]
    return [tree]


def _tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of cache-shaped trees of one structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_map(fn, *parts) for parts in zip(tree, *rest))
    return fn(tree, *rest)


def _tree_unflatten(structure: Any, leaves: Sequence[Any]) -> Any:
    """A tree of ``structure``'s shape holding ``leaves`` in
    :func:`_tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return tuple(build(x) for x in t)
        return next(it)

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def batch_axes(cfg: ModelConfig) -> Any:
    """Tree (cache structure) of each leaf's batch-axis index.

    Derived from :func:`~repro_torch.models.transformer.cache_axes` —
    stacked ``pos{i}`` leaves carry batch at axis 1 behind the leading
    "layers" axis — so the engine never hard-codes a layout the model
    family can vary.
    """
    def walk(t):
        if _is_axes(t):
            return t.index("batch")
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return tuple(walk(v) for v in t)

    return walk(cache_axes(cfg))


def _engine_counts(*, batch: int, params_bytes: float, cache_bytes: float,
                   write_bytes: float, ops: float, io_bytes: float,
                   resident: bool = True) -> WorkCounts:
    """First-order structural work of one engine step (or prefill).

    ``resident=True`` is the engine's captured-state contract: only token /
    position I/O crosses the host bus, the params + cache stream through
    the D$ hierarchy.  ``resident=False`` models the naive
    rebatch-per-step baseline that round-trips the whole cache through the
    host every token (out + back in) — the bench's comparison arm.
    """
    host = float(io_bytes) + (0.0 if resident else 2.0 * float(cache_bytes))
    return WorkCounts(
        ops=float(ops),
        dcache_bytes=float(params_bytes) + float(cache_bytes)
        + float(write_bytes),
        host_bytes=host,
        working_set=float(params_bytes) + float(cache_bytes))


class _BoundModel:
    """A :class:`Transformer`'s layout over launch-input parameter leaves:
    what :func:`~repro_torch.models.transformer.prefill` and
    :func:`~repro_torch.models.transformer.decode_step` read of a model
    (``cfg``, ``embed``, ``final_norm``, ``layer0``, ``layers``), holding
    no weights of its own."""

    def __init__(self, cfg: ModelConfig, names: Sequence[str],
                 leaves: Sequence[torch.Tensor]):
        if len(names) != len(leaves):
            raise ValueError(f"{len(leaves)} parameter leaves for "
                             f"{len(names)} parameters of {cfg.name}")
        tree: Dict[str, Any] = {}
        for name, leaf in zip(names, leaves):
            *parents, last = name.split(".")
            node = tree
            for key in parents:
                node = node.setdefault(key, {})
            node[last] = leaf
        self.cfg = cfg
        self.embed = tree["embed"]
        self.final_norm = tree["final_norm"]
        self.layer0 = tree.get("layer0")
        self.layers = [tree["layers"][str(i)] for i in range(n_scanned(cfg))]

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device


@functools.lru_cache(maxsize=16)
def _param_names(cfg: ModelConfig) -> Tuple[str, ...]:
    """The order of the parameter leaves an engine launch passes: the
    :class:`Transformer`'s parameter names as a storage-less (``meta``)
    build of ``cfg``'s spec lists them (a model built from another tree's
    key order lists them otherwise; the engine reorders its own)."""
    template = Transformer(cfg, map_tree(
        lambda s: torch.empty(s.shape, device="meta"), model_spec(cfg)))
    return tuple(name for name, _ in template.named_parameters())


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


#: engine kernel families live in a PRIVATE registry: their builders
#: require a ModelConfig (no default variant exists), so they must not
#: pollute the global registry that ``Program.create_kernels()`` sweeps
ENGINE_REGISTRY = KernelRegistry()


@kernel_family("engine.prefill", registry=ENGINE_REGISTRY)
def build_prefill_kernel(config: EGPUConfig = EGPU_16T, *,
                         cfg: ModelConfig, max_len: int,
                         cache_dtype: str = "bfloat16") -> Kernel:
    """Batch-1 prompt pass -> (first greedy token (1,), *cache leaves).

    One kernel serves every prompt length — the per-length specialization
    lives in the :class:`~repro_torch.serve.cache.GraphCache` key (input
    shapes), so distinct lengths get distinct captured graphs of the same
    kernel.
    """
    step = make_prefill_step(cfg, max_len, getattr(torch, cache_dtype))
    names = _param_names(cfg)

    def engine_prefill(prompt, *param_leaves):
        logits, cache = step(_BoundModel(cfg, names, param_leaves),
                             {"tokens": prompt})
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return (tok, *_tree_leaves(cache))

    return Kernel(name="engine.prefill", executor=engine_prefill,
                  counts=_engine_counts)


@kernel_family("engine.decode_step", registry=ENGINE_REGISTRY)
def build_decode_kernel(config: EGPUConfig = EGPU_16T, *,
                        cfg: ModelConfig, num_slots: int,
                        cache_dtype: str = "bfloat16") -> Kernel:
    """One token for every slot: (tokens (B,), positions (B,), *cache,
    *params) -> (next tokens (B,), *new cache leaves).

    ONE batched decode step with per-row positions — each row reads only
    its own cache slot, token and position, which is what makes staggered
    insertion bit-identical to each request's own whole-batch trajectory.
    An MoE layer routes each slot's token as a group of its own (the JAX
    engine vmaps a batch-1 step, whose group is that one token; the JAX
    stack's rule would group ``B // 16`` slots from 32 slots on).
    The cache leaves are written in place and returned.  The step body is
    the ``return_logits=False`` fast path, so no ``(B, vocab)`` buffer
    rides the captured graph's outputs.
    """
    del num_slots, cache_dtype           # identity only: one graph per width
    structure = batch_axes(cfg)
    n_cache = len(_tree_leaves(structure))
    step = make_decode_step(cfg, return_logits=False, moe_group_size=1)
    names = _param_names(cfg)

    def engine_decode(tokens, positions, *state):
        cache = _tree_unflatten(structure, state[:n_cache])
        model = _BoundModel(cfg, names, state[n_cache:])
        toks, new_cache = step(model, cache, tokens, positions)
        return (toks, *_tree_leaves(new_cache))

    return Kernel(name="engine.decode_step", executor=engine_decode,
                  counts=_engine_counts)


@dataclasses.dataclass
class Prefix:
    """One prefilled request, ready for :meth:`DecodeEngine.insert`."""

    token: torch.Tensor                  # (1,) int32 — first greedy token
    cache: Any                           # batch-1 cache tree
    pos: int                             # next decode position (= prompt len)
    prompt_len: int
    rid: Optional[int] = None            # server request id (None standalone)
    modeled_s: float = 0.0               # fused modeled prefill latency
    energy_j: float = 0.0


@dataclasses.dataclass
class DecodeState:
    """The persistent batched decode state (all ``num_slots`` wide).

    ``tokens``/``cache`` are replaced by each :meth:`DecodeEngine.generate`
    launch's outputs (the cache leaves are *donated* and written in place,
    so the outputs are the same tensors); ``positions`` is the (B,) int32
    tensor of next decode positions; ``occupied``/``rids`` are host-side
    bookkeeping.
    """

    tokens: torch.Tensor                 # (B,) int32 — last emitted per slot
    positions: torch.Tensor              # (B,) int32 — next decode position
    cache: Any                           # batch-B cache tree
    occupied: List[bool]
    rids: List[Optional[int]]

    @property
    def num_slots(self) -> int:
        return len(self.occupied)

    @property
    def n_occupied(self) -> int:
        return sum(self.occupied)

    def free_slots(self) -> List[int]:
        return [i for i, o in enumerate(self.occupied) if not o]


@dataclasses.dataclass(frozen=True)
class EngineRoofline:
    """Memory-bandwidth roofline of ONE captured generate step, summed off
    the schedule's :class:`~repro_torch.core.runtime.GraphNode` counts."""

    dcache_bytes: float                  # core <-> D$ traffic per step
    host_bytes: float                    # counts-level host traffic per step
    transfer_bytes: float                # explicit transfer-node bytes
    dcache_bw_bytes_per_s: float         # line width x CUs x clock
    modeled_step_s: float                # fused modeled latency of the step

    @property
    def bytes_per_step(self) -> float:
        return self.dcache_bytes + self.host_bytes + self.transfer_bytes

    @property
    def min_step_s(self) -> float:
        """Bandwidth-bound floor: D$ traffic over D$ bandwidth."""
        if self.dcache_bw_bytes_per_s <= 0.0:
            return 0.0
        return self.dcache_bytes / self.dcache_bw_bytes_per_s

    @property
    def mem_bound_fraction(self) -> float:
        """How much of the modeled step the bandwidth floor explains
        (→ 1.0 when decode is purely memory-bound, as AR decode is)."""
        if self.modeled_step_s <= 0.0:
            return 0.0
        return min(1.0, self.min_step_s / self.modeled_step_s)


def graph_traffic(graph: CommandGraph) -> Tuple[float, float, float]:
    """(dcache, host, transfer) bytes of one launch, read straight off the
    captured schedule — each kernel node carries the WorkCounts it was
    priced with, transfer nodes their payload size."""
    dcache = host = moved = 0.0
    for n in graph.nodes:
        if n.counts is not None:
            dcache += n.counts.dcache_bytes
            host += n.counts.host_bytes
        moved += n.nbytes
    return dcache, host, moved


def engine_roofline(graph: CommandGraph, config: EGPUConfig
                    ) -> EngineRoofline:
    dcache, host, moved = graph_traffic(graph)
    fused, _ = graph.fused_modeled()
    bw = (config.dcache_line_bytes * config.compute_units * config.freq_hz)
    return EngineRoofline(
        dcache_bytes=dcache, host_bytes=host, transfer_bytes=moved,
        dcache_bw_bytes_per_s=float(bw),
        modeled_step_s=fused.total_s if fused is not None else 0.0)


class DecodeEngine:
    """Continuous-batching decode on one :class:`QueueWorker` lane.

    ::

        engine = DecodeEngine(cfg, params, num_slots=4, max_len=64)
        state = engine.init_state()
        state = engine.insert(engine.prefill(None, prompt), state, slot=0)
        state, toks = engine.generate(None, state)   # ONE graph launch

    ``params`` is the JAX-layout parameter tree of tensors (what
    :func:`~repro_torch.models.params.init_params` makes and
    :class:`~repro_torch.models.transformer.Transformer` takes); the engine
    builds its :attr:`model` from it, on the tree's device, which must be
    the engine's: ``device`` (``"cuda"`` by default, ``"cpu"`` for the
    plain versions) or the given ``worker``'s.

    The worker must capture WITHOUT explicit transfers: the decode state is
    resident — donated back to each launch, never round-tripped — and the
    counts model prices exactly token/position I/O as host traffic
    (``resident=False`` builds the naive baseline arm for the bench).

    Donation discipline: every launch reads its tokens back to the host
    and retires (drains) before the next launch donates the cache leaves
    the previous outputs are.
    """

    def __init__(self, cfg: ModelConfig, params: Any, *,
                 num_slots: int = 4, max_len: int = 64,
                 config: EGPUConfig = EGPU_16T,
                 worker: Optional[QueueWorker] = None,
                 cache: Optional[GraphCache] = None,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 resident: bool = True,
                 tracer: Optional[Tracer] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 name: str = "engine", device: Any = "cuda"):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if cfg.is_encoder:
            raise ValueError(f"{cfg.name} is encoder-only: no decode engine")
        self.cfg = cfg
        self.params = params
        self.num_slots = num_slots
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.resident = resident
        self.name = name
        self.worker = worker if worker is not None else QueueWorker(
            config, name=name, max_in_flight=1, explicit_transfers=False,
            clock=clock, tracer=tracer, device=device)
        if self.worker.apu.explicit_transfers:
            raise ValueError(
                "DecodeEngine needs a worker with explicit_transfers=False: "
                "the decode state is resident (donated in place), not "
                "round-tripped through transfer nodes every step")
        self.device = self.worker.device
        self.config = self.worker.apu.egpu.config
        #: the served model, built from ``params`` on their device
        self.model = Transformer(cfg, params)
        if canonical_device(self.device) != self.model.device:
            raise ValueError(
                f"the parameters lie on {self.model.device}, the engine's "
                f"lane runs on {self.device}")
        self.cache = cache if cache is not None else GraphCache(capacity=16)
        self.tracer = tracer
        self.clock = clock
        self._program = Program.build(self.config, registry=ENGINE_REGISTRY)
        self._bidx = batch_axes(cfg)
        named = dict(self.model.named_parameters())
        self._param_leaves = tuple(named[n] for n in _param_names(cfg))
        # modeled bytes of the tree the caller passed (the JAX package
        # counts its f32 tree), never the model's compute-dtype copy
        tree = [t for _, t in leaves_with_path(params)]
        self._params_bytes = float(sum(t.numel() * t.element_size()
                                       for t in tree))
        self._param_elems = float(sum(t.numel() for t in tree))
        # per-slot cache traffic: kv_seq-indexed leaves write one position
        # per step, recurrent (O(1)) leaves rewrite whole; reads sweep all
        struct_leaves = _tree_leaves(
            cache_struct(cfg, 1, max_len, cache_dtype))
        axes_leaves = _tree_leaves(cache_axes(cfg), is_leaf=_is_axes)

        def _nbytes(s):
            return float(np.prod(tuple(s.shape))) * s.element_size()

        self._slot_cache_bytes = float(
            sum(_nbytes(x) for x in struct_leaves))
        self._slot_write_bytes = float(sum(
            (_nbytes(x) / max_len if "kv_seq" in ax else _nbytes(x))
            for x, ax in zip(struct_leaves, axes_leaves)))
        self._decode_stage: Optional[Tuple[Stage, ...]] = None
        self._prefill_stages: Dict[int, Tuple[Stage, ...]] = {}
        self._canonical_structs: Optional[Tuple[torch.Tensor, ...]] = None
        #: the captured per-step graph (None until the first generate) —
        #: tests pin the no-(B, vocab)-output invariant on its out_avals
        self.decode_graph: Optional[CommandGraph] = None
        # accounting (all modeled / machine-model virtual time)
        self.n_prefills = 0
        self.n_inserts = 0
        self.n_steps = 0
        self.n_tokens = 0                # tokens emitted from occupied slots
        self.prefill_modeled_s = 0.0
        self.decode_modeled_s = 0.0
        self.energy_j = 0.0
        self._occupancy_sum = 0.0

    # -- state construction -------------------------------------------------
    def _decode_kernel(self) -> Kernel:
        return self._program.create_kernel(
            "engine.decode_step", cfg=self.cfg, num_slots=self.num_slots,
            cache_dtype=_dtype_name(self.cache_dtype))

    def _cache_structs(self) -> Tuple[torch.Tensor, ...]:
        """Canonical per-leaf shapes/dtypes (``meta`` tensors) of the
        persistent cache: the decode step's OWN outputs (its fixed point),
        not ``cache_struct``'s advertised ones — rwkv's token shifts and
        mamba's conv window come back at the activation dtype (the
        promoted one), and seeding the state there keeps
        every step on ONE captured graph."""
        if self._canonical_structs is not None:
            return self._canonical_structs
        b = self.num_slots
        kern = self._decode_kernel()
        leaves = _tree_leaves(cache_struct(self.cfg, b, self.max_len,
                                           self.cache_dtype))
        io = (torch.empty((b,), dtype=torch.int32, device="meta"),
              torch.empty((b,), dtype=torch.int32, device="meta"))
        pstructs = [torch.empty(p.shape, dtype=p.dtype, device="meta")
                    for p in self._param_leaves]
        for _ in range(3):                       # fixed point in <= 1 pass
            outs = kern.executor(*io, *leaves, *pstructs)
            new = [torch.empty(o.shape, dtype=o.dtype, device="meta")
                   for o in outs[1:]]
            if [(tuple(n.shape), n.dtype) for n in new] == \
                    [(tuple(x.shape), x.dtype) for x in leaves]:
                break
            leaves = new
        self._canonical_structs = tuple(leaves)
        return self._canonical_structs

    def init_state(self) -> DecodeState:
        """An all-free decode state (zero cache, batch ``num_slots``)."""
        b = self.num_slots
        cache = _tree_unflatten(self._bidx, [
            torch.zeros(s.shape, dtype=s.dtype, device=self.device)
            for s in self._cache_structs()])
        return DecodeState(
            tokens=torch.zeros((b,), dtype=torch.int32, device=self.device),
            positions=torch.zeros((b,), dtype=torch.int32,
                                  device=self.device),
            cache=cache, occupied=[False] * b, rids=[None] * b)

    # -- counts -------------------------------------------------------------
    def _decode_counts_params(self) -> Dict[str, Any]:
        b = self.num_slots
        return dict(
            batch=b,
            params_bytes=self._params_bytes,
            cache_bytes=self._slot_cache_bytes * b,
            write_bytes=self._slot_write_bytes * b,
            ops=self._param_elems * b,
            io_bytes=float(3 * b * _TOKEN_BYTES),   # tokens+pos in, tokens out
            resident=self.resident)

    def _prefill_counts_params(self, prompt_len: int) -> Dict[str, Any]:
        return dict(
            batch=1,
            params_bytes=self._params_bytes,
            cache_bytes=self._slot_cache_bytes,
            write_bytes=self._slot_write_bytes * prompt_len,
            ops=self._param_elems * prompt_len,
            io_bytes=float(prompt_len * _TOKEN_BYTES + _TOKEN_BYTES),
            resident=self.resident)

    # -- graphs -------------------------------------------------------------
    def _prefill_graph(self, prompt: torch.Tensor) -> CommandGraph:
        s = int(prompt.shape[1])
        stages = self._prefill_stages.get(s)
        if stages is None:
            kern = self._program.create_kernel(
                "engine.prefill", cfg=self.cfg, max_len=self.max_len,
                cache_dtype=_dtype_name(self.cache_dtype))
            stages = (Stage(kern,
                            counts_params=self._prefill_counts_params(s)),)
            self._prefill_stages[s] = stages
        inputs = (prompt, *self._param_leaves)
        ndr = [optimal_ndrange(s * self.cfg.d_model, self.config)]
        graph, _hit = self.cache.get_or_capture(
            self.worker.apu, list(stages), inputs, ndranges=ndr)
        return graph

    def _generate_graph(self, state: DecodeState) -> CommandGraph:
        stages = self._decode_stage
        if stages is None:
            stages = (Stage(self._decode_kernel(),
                            counts_params=self._decode_counts_params()),)
            self._decode_stage = stages
        cache_leaves = _tree_leaves(state.cache)
        inputs = (state.tokens, state.positions, *cache_leaves,
                  *self._param_leaves)
        ndr = [optimal_ndrange(self.num_slots * self.cfg.d_model,
                               self.config)]
        graph, hit = self.cache.get_or_capture(
            self.worker.apu, list(stages), inputs, ndranges=ndr)
        if not hit:
            # checked at capture: no output aval is a full-vocabulary
            # (B, Vp) logits buffer
            bad = [a for a in graph.out_avals
                   if len(a.shape) >= 2
                   and a.shape[-1] == self.cfg.vocab_padded
                   and a.shape[0] == self.num_slots]
            if bad:
                raise AssertionError(
                    f"generate-step graph carries full-vocab outputs "
                    f"{[(tuple(a.shape), str(a.dtype)) for a in bad]}; "
                    "make_decode_step(return_logits=False) must elide them")
            # donation-aware sanitizer sweep at capture time
            # (repro_torch.analyze): steady-state launches donate the
            # cache-leaf slots, so prove NOW that every reader of those
            # slots sits on the ordered path to the read-then-drain
            # boundary.  Memoized on the graph.
            donate = tuple(range(2, 2 + len(cache_leaves)))
            findings = graph.verify(donate=donate)
            self.cache.findings += len(findings)
            if findings and os.environ.get("REPRO_VERIFY") == "1":
                from ..analyze.graph import GraphVerifyError
                raise GraphVerifyError(findings)
        self.decode_graph = graph
        return graph

    # -- the JetStream-style API -------------------------------------------
    def prefill(self, params: Optional[Any], prompt: Any,
                rid: Optional[int] = None) -> Prefix:
        """Run one request's prompt; returns its :class:`Prefix`.

        ``params`` may be ``None`` to use the engine's bound params (they
        are launch inputs either way — the captured graph is pure).
        """
        if params is not None and params is not self.params:
            raise ValueError(
                "prefill params must be the engine's bound params: the "
                "captured graphs pin their shapes (pass None to reuse)")
        prompt = torch.as_tensor(prompt, device=self.device).to(torch.int32)
        if prompt.dim() == 1:
            prompt = prompt[None, :]
        if prompt.dim() != 2 or prompt.shape[0] != 1:
            raise ValueError(
                f"prefill takes ONE request's prompt (S,) or (1, S); got "
                f"shape {tuple(prompt.shape)}")
        s = int(prompt.shape[1])
        if s < 1 or s >= self.max_len:
            raise ValueError(
                f"prompt length {s} must be in [1, max_len={self.max_len})")
        graph = self._prefill_graph(prompt)
        batch = MicroBatch(bucket_key=("engine.prefill", s),
                           inputs=(prompt, *self._param_leaves),
                           requests=(), capacity=1, crop_outputs=False)
        t_now = self.clock()
        ticket, _ = self.worker.launch(graph, batch, t_now=t_now)
        outs = ticket.outputs
        tok = outs[0].data
        cache = _tree_unflatten(self._bidx, [b.data for b in outs[1:]])
        self.worker.drain()
        modeled = ticket.modeled_latency_s or 0.0
        self.n_prefills += 1
        self.prefill_modeled_s += modeled
        self.energy_j += ticket.energy_j
        if self.tracer is not None and rid is not None:
            self.tracer.child(rid, "engine.prefill", t_now,
                              ticket.t_done_modeled or t_now,
                              prompt_len=s)
        return Prefix(token=tok, cache=cache, pos=s, prompt_len=s, rid=rid,
                      modeled_s=modeled, energy_j=ticket.energy_j)

    def insert(self, prefix: Prefix, state: DecodeState,
               slot: int) -> DecodeState:
        """Splice ``prefix`` into ``slot`` — an in-place copy into the
        persistent state's leaves along each leaf's batch axis (cast to the
        leaf's dtype), never a re-capture."""
        if not 0 <= slot < state.num_slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {state.num_slots})")
        if state.occupied[slot]:
            raise ValueError(f"slot {slot} is occupied (rid="
                             f"{state.rids[slot]}); release it first")
        state.tokens[slot] = prefix.token[0]
        state.positions[slot] = prefix.pos
        _tree_map(lambda dst, src, i: dst.narrow(i, slot, 1).copy_(src),
                  state.cache, prefix.cache, self._bidx)
        state.occupied[slot] = True
        state.rids[slot] = prefix.rid
        self.n_inserts += 1
        return state

    def release(self, state: DecodeState, slot: int) -> DecodeState:
        """Free a finished slot (its row keeps stepping on stale data —
        discarded — until a fresh prefix is inserted)."""
        state.occupied[slot] = False
        state.rids[slot] = None
        return state

    def generate(self, params: Optional[Any], state: DecodeState
                 ) -> Tuple[DecodeState, np.ndarray]:
        """Advance every slot one token — ONE cached-graph launch.

        Returns ``(state, tokens)`` where ``tokens`` is the (B,) int32
        next-token vector read back to the host (occupied slots' entries
        are live; free slots' entries are stale rows to ignore).
        """
        if params is not None and params is not self.params:
            raise ValueError(
                "generate params must be the engine's bound params: the "
                "captured graph pins their shapes (pass None to reuse)")
        graph = self._generate_graph(state)
        cache_leaves = _tree_leaves(state.cache)
        inputs = (state.tokens, state.positions, *cache_leaves,
                  *self._param_leaves)
        # donate exactly the persistent cache leaves (input slots 2..): the
        # step writes them in place, so its cache outputs are these tensors
        # and no cache is allocated per token
        donate = tuple(range(2, 2 + len(cache_leaves)))
        batch = MicroBatch(bucket_key=("engine.generate", self.num_slots),
                           inputs=inputs, requests=(),
                           capacity=self.num_slots, crop_outputs=False,
                           donate=donate)
        t_now = self.clock()
        ticket, _ = self.worker.launch(graph, batch, t_now=t_now)
        outs = ticket.outputs
        toks = outs[0].data
        new_leaves = [b.data for b in outs[1:]]
        # read back BEFORE retiring: the next launch donates these buffers
        tokens_np = toks.cpu().numpy()
        self.worker.drain()
        state.tokens = toks
        state.positions = state.positions + 1
        state.cache = _tree_unflatten(self._bidx, new_leaves)
        occ = state.n_occupied
        modeled = ticket.modeled_latency_s or 0.0
        self.n_steps += 1
        self.n_tokens += occ
        self.decode_modeled_s += modeled
        self.energy_j += ticket.energy_j
        self._occupancy_sum += occ / self.num_slots
        if self.tracer is not None:
            start = (ticket.t_done_modeled - modeled
                     if ticket.t_done_modeled is not None else t_now)
            self.tracer.span(
                "engine.generate", start,
                ticket.t_done_modeled if ticket.t_done_modeled is not None
                else t_now,
                track=f"engine/{self.name}", step=self.n_steps,
                occupied=occ, slots=self.num_slots)
            for slot, rid in enumerate(state.rids):
                if rid is not None and state.occupied[slot]:
                    self.tracer.request_event(
                        rid, ticket.t_done_modeled or t_now, "token",
                        slot=slot, step=self.n_steps)
        return state, tokens_np

    # -- reporting ----------------------------------------------------------
    @property
    def occupancy(self) -> float:
        """Mean occupied-slot fraction across generate steps."""
        return self._occupancy_sum / self.n_steps if self.n_steps else 0.0

    @property
    def tokens_per_s_modeled(self) -> float:
        """Steady-state decode throughput on the machine-model timeline."""
        if self.decode_modeled_s <= 0.0:
            return 0.0
        return self.n_tokens / self.decode_modeled_s

    def roofline(self) -> Optional[EngineRoofline]:
        """Bytes/step roofline of the captured generate graph (None before
        the first step)."""
        if self.decode_graph is None:
            return None
        return engine_roofline(self.decode_graph, self.config)

    def stats(self) -> Dict[str, float]:
        ro = self.roofline()
        return {
            "num_slots": self.num_slots,
            "n_prefills": self.n_prefills,
            "n_inserts": self.n_inserts,
            "n_steps": self.n_steps,
            "n_tokens": self.n_tokens,
            "prefill_modeled_s": self.prefill_modeled_s,
            "decode_modeled_s": self.decode_modeled_s,
            "energy_j": self.energy_j,
            "occupancy": self.occupancy,
            "tokens_per_s_modeled": self.tokens_per_s_modeled,
            "bytes_per_step": ro.bytes_per_step if ro is not None else 0.0,
            "mem_bound_fraction": (ro.mem_bound_fraction
                                   if ro is not None else 0.0),
        }

    def publish_metrics(self, registry) -> None:
        """Snapshot the engine counters into a
        :class:`~repro_torch.obs.MetricsRegistry` (idempotent set-style)."""
        c = registry.counter("repro_engine_events_total",
                             "decode-engine prefills/inserts/steps/tokens")
        c.set_total(self.n_prefills, kind="prefills")
        c.set_total(self.n_inserts, kind="inserts")
        c.set_total(self.n_steps, kind="steps")
        c.set_total(self.n_tokens, kind="tokens")
        registry.gauge("repro_engine_slots",
                       "decode-engine slot width").set(self.num_slots)
        registry.gauge("repro_engine_occupancy",
                       "mean occupied-slot fraction").set(self.occupancy)
        registry.gauge("repro_engine_tokens_per_s_modeled",
                       "modeled steady-state decode throughput").set(
            self.tokens_per_s_modeled)
        ro = self.roofline()
        if ro is not None:
            registry.gauge("repro_engine_bytes_per_step",
                           "modeled traffic of one generate step").set(
                ro.bytes_per_step)
            registry.gauge("repro_engine_mem_bound_fraction",
                           "bandwidth-floor share of the modeled step").set(
                ro.mem_bound_fraction)
