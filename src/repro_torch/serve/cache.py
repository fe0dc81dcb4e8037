"""GraphCache — memoized CommandGraph captures for the serving layer.

The paper's Tiny-OpenCL results (§IV-B, §VIII-B) show dispatch overhead only
amortizes when work is chained and *resident*; a ``CommandGraph`` gets
there for one offload, but every ``APU.offload`` still re-captures the
chain (running every plain version on ``meta`` tensors).  The cache closes
that gap: captured graphs are memoized on a key of

    (EGPUConfig, capture shape, per-stage signature, input
     shapes/dtypes/devices, per-stage NDRanges)

so steady-state traffic pays the capture once per distinct (pipeline,
shape bucket, device config, torch device) and every later launch is a
pure replay.  Eviction is LRU with hit/miss/eviction counters — the counters are
the contract the serving tests pin ("a warm server performs zero
re-captures").

Stage signatures identify the *computation*, not the closure object: kernel
name + executor identity (code object, defaults AND closure-cell contents —
two lambdas born at the same source line capturing different values must
not collide, because the captured graph bakes the capture in) + params +
counts-params + the content hash of every constant buffer.  Hashing
constants means two pipelines that share kernel names but carry different
weights can never collide (a false hit would serve the wrong model).
Executors that read module-level *globals* mutated between calls are
outside the contract — capture state via closures, params or consts.
For a long-lived server, compute the stage part once with
:func:`stages_signature` and pass it as ``key_prefix`` (plain
``APU.offload`` calls get the same effect from the cache's internal
signature memo, keyed on stage-object identity).  Hashing a constant
copies it to the host once, which is why a server signs its pipeline at
construction and never per submit.
"""

from __future__ import annotations

import functools
import hashlib
import os
from collections import OrderedDict
from typing import Any, Dict, Hashable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analyze.graph import GraphVerifyError
from ..core.apu import APU, Stage
from ..core.ndrange import NDRange
from ..core.runtime import CommandGraph

_SIG_MEMO_CAPACITY = 64


def _array_sig(v: Any) -> Tuple[Any, ...]:
    """Content signature of a captured constant (shape, dtype, device,
    sha1 of its bytes; a tensor on the card is copied to the host once)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().contiguous()
        raw = t.cpu().reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        return ("tensor", tuple(t.shape), str(t.dtype), str(t.device),
                hashlib.sha1(raw).hexdigest())
    arr = np.asarray(v)
    return ("arr", arr.shape, str(arr.dtype),
            hashlib.sha1(arr.tobytes()).hexdigest())


def _code_sig(code: Any, depth: int = 0) -> str:
    """Hash of a code object INCLUDING its constants (two lambdas differing
    only in an inline literal share co_code — the literal lives in
    co_consts; nested code objects recurse)."""
    h = hashlib.sha1(code.co_code)
    h.update(repr(code.co_names).encode())
    for const in code.co_consts:
        if hasattr(const, "co_code") and depth < 4:
            h.update(_code_sig(const, depth + 1).encode())
        else:
            h.update(repr(const).encode())
    return h.hexdigest()


def _callable_sig(fn: Any, depth: int = 0) -> Tuple[Any, ...]:
    """Identity of an executor: code (bytecode + consts) + defaults +
    closure contents.

    Closure cells holding arrays sign by content, nested callables recurse
    (bounded), anything else signs by ``repr`` — an unstable repr (default
    ``object.__repr__`` with an address) degrades to cache *misses*, never
    to a false hit.
    """
    if depth > 4:
        return ("depth",)
    if isinstance(fn, functools.partial):
        return ("partial", _callable_sig(fn.func, depth + 1),
                tuple(_value_sig(a, depth + 1) for a in fn.args),
                tuple(sorted((k, _value_sig(v, depth + 1))
                             for k, v in fn.keywords.items())))
    code = getattr(fn, "__code__", None)
    if code is None:        # builtin / callable object
        return ("obj", type(fn).__name__, getattr(fn, "__module__", ""),
                getattr(fn, "__qualname__", repr(fn)))
    cells = tuple(_value_sig(c.cell_contents, depth + 1)
                  for c in (fn.__closure__ or ()))
    defaults = tuple(_value_sig(d, depth + 1)
                     for d in (fn.__defaults__ or ()))
    return ("fn", getattr(fn, "__module__", ""), fn.__qualname__,
            _code_sig(code), defaults, cells)


def _value_sig(v: Any, depth: int = 0) -> Tuple[Any, ...]:
    """Signature of a kernel param / closure cell: arrays by content (they
    are baked into the captured node), containers element-wise (a repr of a
    large array inside a list truncates to '...' and would collide),
    callables structurally, everything else by repr."""
    if isinstance(v, (torch.Tensor, np.ndarray, np.generic)):
        return _array_sig(v)
    if isinstance(v, (list, tuple)) and depth <= 4:
        return ("seq", type(v).__name__,
                tuple(_value_sig(x, depth + 1) for x in v))
    if isinstance(v, dict) and depth <= 4:
        return ("map", tuple(sorted(
            (repr(k), _value_sig(x, depth + 1)) for k, x in v.items())))
    if callable(v):
        return _callable_sig(v, depth)
    return ("val", repr(v))


def _params_sig(params: Dict[str, Any]) -> Tuple[Any, ...]:
    return tuple(sorted((k, _value_sig(v)) for k, v in params.items()))


def kernel_signature(k: Any) -> Tuple[Any, ...]:
    """Hashable identity of a :class:`~repro_torch.core.runtime.Kernel`.

    Kernels created through the registry
    (:meth:`repro_torch.core.program.Program.create_kernel`) carry a
    *registry identity* — ``(family, config, variant)`` — which is both
    cheaper and more stable than hashing executor bytecode + closures:
    registry kernels are memoized singletons, so two pipelines built from
    the same program can never mint distinguishable-but-equal closures (the
    structural signature stays as the fallback for ad-hoc kernels).
    """
    if getattr(k, "family", None) is not None:
        return ("reg", k.family, k.config, k.variant, k.name)
    return (k.name, _callable_sig(k.executor))


def stage_signature(stage: Stage) -> Tuple[Any, ...]:
    """Hashable identity of one :class:`~repro_torch.core.apu.Stage`."""
    return (
        kernel_signature(stage.kernel),
        _params_sig(stage.params),
        _params_sig(stage.counts_params),
        stage.n_inputs,
        tuple(_array_sig(c) for c in stage.consts),
    )


def stages_signature(stages: Sequence[Stage]) -> Tuple[Any, ...]:
    """Hashable identity of a whole pipeline (compute once, reuse per batch)."""
    return tuple(stage_signature(s) for s in stages)


def input_signature(inputs: Sequence[Any],
                    device: Optional[Any] = None) -> Tuple[Any, ...]:
    """(shape, torch dtype, device) of each pipeline input (values
    excluded — a cached graph is re-launched on fresh data of the same
    shape, dtype and device).  Host data (numpy arrays, numbers) signs with
    the torch dtype it becomes.  ``device`` (an APU's, which every input is
    moved to before a launch) replaces each input's own."""
    sig = []
    for x in inputs:
        x = getattr(x, "data", x)           # a Buffer's tensor
        if isinstance(x, torch.Tensor):
            shape, dtype, where = tuple(x.shape), x.dtype, x.device
        else:
            arr = np.asarray(x)
            shape, where = arr.shape, "host"
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        sig.append((shape, str(dtype), str(where if device is None else device)))
    return tuple(sig)


class GraphCache:
    """LRU cache of captured :class:`CommandGraph`\\ s keyed on
    (device config, capture shape, pipeline signature, input
    shapes/dtypes/devices, NDRanges).

    One cache may be shared across several :class:`APU`\\ s with different
    ``EGPUConfig`` presets — the config is part of the key, so a 16T graph
    can never be served to an 8T device, and the APU's torch device is too,
    so a CPU capture is never replayed on the card.  Same-config callers
    genuinely *share* an entry; that is safe for accounting because
    launches bind to the caller's queue (``graph.launch(..., queue=...)``),
    so the shared graph's capture queue never accumulates anyone's launch
    events.  ``capacity`` bounds the number of resident graphs (each holds
    its captured constants); the least-recently-used entry is evicted
    first.
    """

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError("GraphCache capacity must be >= 1")
        self.capacity = capacity
        self._graphs: "OrderedDict[Hashable, CommandGraph]" = OrderedDict()
        # Memoized stages_signature keyed on stage-object identity: callers
        # that reuse their Stage list (APU.offload in a loop) skip re-hashing
        # every constant buffer per call.  Entries hold strong refs to the
        # stage tuple so an id() can never be recycled while memoized.
        self._sig_memo: "OrderedDict[Tuple[int, ...], Tuple[Tuple[Stage, ...], Hashable]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # capture-time sanitizer roll-up (repro_torch.analyze): every miss's
        # fresh capture is statically verified before admission.  Findings
        # are counted always (they surface in ServeReport / metrics) and
        # raise under REPRO_VERIFY=1 — a hit replays a verified graph, so
        # the warm path never re-verifies.
        self.verified = 0
        self.findings = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def _stages_sig(self, stages: Sequence[Stage]) -> Hashable:
        key = tuple(id(s) for s in stages)
        memo = self._sig_memo.get(key)
        if memo is not None and len(memo[0]) == len(stages) and all(
                a is b for a, b in zip(memo[0], stages)):
            self._sig_memo.move_to_end(key)
            return memo[1]
        sig = stages_signature(stages)
        self._sig_memo[key] = (tuple(stages), sig)
        if len(self._sig_memo) > _SIG_MEMO_CAPACITY:
            self._sig_memo.popitem(last=False)
        return sig

    def key_for(self, apu: APU, stages: Sequence[Stage],
                inputs: Sequence[Any],
                ndranges: Optional[Sequence[NDRange]] = None,
                key_prefix: Optional[Hashable] = None) -> Hashable:
        """The full cache key for one offload/capture request.

        ``key_prefix`` replaces the per-call :func:`stages_signature`
        (which hashes every constant buffer) with a precomputed identity —
        the hot-path form for a server whose pipeline never changes.
        Without it, the signature is memoized on stage-object identity, so
        repeated offloads of the *same* Stage list hash constants once.
        """
        pipe = key_prefix if key_prefix is not None else self._stages_sig(stages)
        ndr = (None if ndranges is None else
               tuple((n.global_size, n.local_size) for n in ndranges))
        # explicit-transfer captures have a different node structure (write/
        # read nodes, resident kernels) than classic ones — never share.
        # The APU's placement (a ShardedWorker's mesh + sharding-rule
        # signature, None for single-device callers) keys too: sharded and
        # single-device entries of one pipeline must never collide.  The
        # inputs sign with the APU's torch device: a graph captured for the
        # CPU replays the plain versions and must never serve the card, nor
        # the reverse.
        return (apu.egpu.config, getattr(apu, "explicit_transfers", False),
                getattr(apu, "placement", None),
                pipe, input_signature(inputs, apu.device), ndr)

    def get_or_capture(self, apu: APU, stages: Sequence[Stage],
                       inputs: Sequence[Any],
                       ndranges: Optional[Sequence[NDRange]] = None,
                       key_prefix: Optional[Hashable] = None,
                       ) -> Tuple[CommandGraph, bool]:
        """Return ``(graph, hit)`` — capturing only on a miss.  The entry is
        promoted to most-recently-used either way.  ``ndranges`` (one per
        stage) price the capture and key the entry."""
        key = self.key_for(apu, stages, inputs, ndranges, key_prefix)
        graph = self._graphs.get(key)
        if graph is not None:
            self.hits += 1
            self._graphs.move_to_end(key)
            return graph, True
        self.misses += 1
        graph = apu.capture_pipeline(stages, inputs, ndranges)
        findings = graph.verify()
        self.verified += 1
        self.findings += len(findings)
        if findings and os.environ.get("REPRO_VERIFY") == "1":
            raise GraphVerifyError(findings)
        self._graphs[key] = graph
        if len(self._graphs) > self.capacity:
            self._graphs.popitem(last=False)
            self.evictions += 1
        return graph, False

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "entries": len(self._graphs),
                "capacity": self.capacity, "verified": self.verified,
                "findings": self.findings}

    def publish_metrics(self, registry) -> None:
        """Publish the cache counters into a
        :class:`~repro_torch.obs.MetricsRegistry` (snapshot style,
        idempotent)."""
        c = registry.counter("repro_graph_cache_events_total",
                             "graph cache hits/misses/evictions")
        c.set_total(self.hits, kind="hits")
        c.set_total(self.misses, kind="misses")
        c.set_total(self.evictions, kind="evictions")
        registry.gauge("repro_graph_cache_entries",
                       "resident compiled graphs").set(len(self._graphs))
        registry.gauge("repro_graph_cache_capacity",
                       "configured cache capacity").set(self.capacity)
        s = registry.counter("repro_graph_sanitizer_total",
                             "capture-time graph sanitizer results")
        s.set_total(self.verified, kind="verified")
        s.set_total(self.findings, kind="findings")

    def clear(self) -> None:
        self._graphs.clear()
        self._sig_memo.clear()
