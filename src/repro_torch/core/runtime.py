"""TinyCL — the host-side Tiny-OpenCL runtime (paper §V / §VI-C), in PyTorch.

The paper's runtime is a subset of the OpenCL host API that works without an
OS, file system, or multithreading: create buffers, set kernel args, enqueue
an NDRange, wait for the completion interrupt.  This module reproduces that
API shape over torch tensors:

* a :class:`Buffer` wraps a ``torch.Tensor`` living on the context's torch
  device (the *unified* memory of the paper's §IV-B model);
* a :class:`Kernel` couples an executor (a function on tensors: a kernel
  wrapper from ``repro_torch.kernels``, which launches a hand-written CUDA
  kernel on a CUDA tensor and runs its plain PyTorch version on a CPU or
  ``meta`` tensor) with a ``counts`` function that derives the structural
  :class:`~repro_torch.core.machine.WorkCounts` for the analytic machine model;
* ``CommandQueue.enqueue_nd_range`` launches the kernel and returns an
  :class:`Event` carrying both the functional results and the modeled
  :class:`~repro_torch.core.machine.PhaseBreakdown` / energy for the queue's
  device configuration — the numbers behind Figs 3 & 4.

Execution model
---------------

The queue is in-order.  ``enqueue_nd_range`` is non-blocking on a CUDA
device: the kernel is queued on the current CUDA stream and the returned
:class:`Event` records a ``torch.cuda.Event`` behind it.  ``Event.wait()``
synchronizes that event and ``CommandQueue.finish()`` drains the queue
(``clFinish``).

``queue.capture()`` records every ``enqueue_nd_range`` issued inside the
``with`` block into a :class:`CommandGraph` **without executing it**: output
shapes come from running each executor on ``meta`` tensors, which carry a
shape and a dtype but no storage.  ``graph.launch(*inputs)`` then replays the
nodes in order on the current stream.  Per-stage machine-model accounting is
costed from each node's ``WorkCounts`` at capture time, and
:meth:`CommandGraph.fused_modeled` reports the chain's modeled latency with
startup and scheduling paid once.  A launch binds its events and modeled
totals to the caller's queue (``launch(..., queue=...)``).

Kernels execute functionally (outputs are fresh tensors), so a graph launch
and the eager path give the same bits.  :class:`Buffer` flags are enforced:
kernels cannot read write-only buffers.
"""

from __future__ import annotations

import dataclasses
import inspect
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .device import EGPUConfig, EGPU_16T, HOST
from .machine import (PhaseBreakdown, WorkCounts, egpu_time, fuse_breakdowns,
                      host_time)
from .ndrange import NDRange
from .power import egpu_energy_j, host_energy_j
from .scheduler import optimal_ndrange


#: valid CL_MEM-style access flags: read-only, write-only, read-write
_BUFFER_FLAGS = ("r", "w", "rw")


def resolve_device(device: Any = "cuda") -> torch.device:
    """The torch device a context executes on.

    ``"cuda"`` (the default of every entry point) requires a card: without
    one this raises instead of quietly running the plain PyTorch versions on
    the CPU.  Pass ``"cpu"`` to run them on purpose, as the tests do.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported torch device {dev}")
    return dev


def _meta_like(t: torch.Tensor) -> torch.Tensor:
    """A storage-less stand-in with ``t``'s shape and dtype."""
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


class Buffer:
    """A unified-memory buffer with **enforced** CL_MEM-style access flags.

    ``flags`` mirror CL_MEM_READ_ONLY / WRITE_ONLY / READ_WRITE: a kernel
    launch *reads* its argument buffers, so passing a write-only (``"w"``)
    buffer raises.  Kernels execute functionally (outputs are fresh
    buffers).
    """

    def __init__(self, data: Any, flags: str = "rw"):
        if flags not in _BUFFER_FLAGS:
            raise ValueError(
                f"invalid buffer flags {flags!r}: expected one of "
                f"{_BUFFER_FLAGS} (CL_MEM_READ_ONLY / WRITE_ONLY / "
                "READ_WRITE)")
        self.data = data if isinstance(data, torch.Tensor) else torch.as_tensor(data)
        self.flags = flags

    @property
    def readable(self) -> bool:
        return "r" in self.flags

    @property
    def writable(self) -> bool:
        return "w" in self.flags

    @property
    def nbytes(self) -> int:
        return self.data.numel() * self.data.element_size()

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    def read(self) -> torch.Tensor:
        """clEnqueueReadBuffer — a no-op copy under unified memory."""
        return self.data


class GraphBuffer(Buffer):
    """A symbolic buffer produced while capturing a :class:`CommandGraph`.

    Carries only a ``meta`` tensor (shape/dtype/numel all work); the
    concrete value exists only while the graph is launched.
    """

    def __init__(self, aval: torch.Tensor, slot: int):
        self.data = aval
        self.flags = "rw"          # kernel outputs are fresh rw buffers
        self.slot = slot

    def read(self) -> torch.Tensor:
        raise RuntimeError(
            "GraphBuffer holds no data during capture; launch the graph and "
            "read its outputs instead.")


@dataclasses.dataclass(frozen=True)
class ArgInfo:
    """clGetKernelArgInfo analogue: one executor argument's metadata.

    ``kind`` is ``"buffer"`` for required positional arguments (memory
    objects in OpenCL terms) and ``"param"`` for defaulted / keyword-only
    arguments (the kernel-args scalar region).
    """

    index: int
    name: str
    kind: str                       # "buffer" | "param"
    has_default: bool = False


class _ArgState:
    """Mutable clSetKernelArg storage (excluded from Kernel eq/hash)."""

    __slots__ = ("buffers", "params")

    def __init__(self) -> None:
        self.buffers: Optional[List[Optional["Buffer"]]] = None
        self.params: Dict[str, Any] = {}


#: memoized executor introspection: executor -> (arg_info, (min, max) buffer
#: arity).  Weak keys — the cache never outlives an ad-hoc executor.
_ARG_INFO_CACHE: "weakref.WeakKeyDictionary[Any, Tuple]" = (
    weakref.WeakKeyDictionary())


def _introspect_executor(executor: Callable[..., Any]) -> Tuple[
        Optional[Tuple["ArgInfo", ...]], Optional[Tuple[int, Optional[int]]]]:
    try:
        cached = _ARG_INFO_CACHE.get(executor)
    except TypeError:
        cached = None
    if cached is not None:
        return cached
    try:
        sig = inspect.signature(executor)
    except (TypeError, ValueError):
        result = (None, None)
    else:
        info: List[ArgInfo] = []
        lo = hi = 0
        variadic = False
        for i, p in enumerate(sig.parameters.values()):
            if p.kind is p.VAR_POSITIONAL:
                info.append(ArgInfo(i, f"*{p.name}", "buffer"))
                variadic = True
            elif p.kind is p.VAR_KEYWORD:
                continue
            elif p.kind is p.KEYWORD_ONLY or p.default is not p.empty:
                info.append(ArgInfo(i, p.name, "param",
                                    has_default=p.default is not p.empty))
            else:
                info.append(ArgInfo(i, p.name, "buffer"))
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
                hi += 1
                if p.default is p.empty:
                    lo += 1
        result = (tuple(info), (lo, None) if variadic else (lo, hi))
    try:
        _ARG_INFO_CACHE[executor] = result
    except TypeError:
        pass
    return result


@dataclasses.dataclass(frozen=True)
class Kernel:
    """An OpenCL kernel object: executor + structural work counts.

    ``executor(*tensors, **params) -> tensor | tuple[tensor]`` must be a
    pure function of its inputs, and must accept ``meta`` tensors (capture
    infers output shapes that way).  ``counts(**params) -> WorkCounts``
    derives the machine-model inputs from the problem size.

    Kernels created through a :class:`~repro_torch.core.program.Program`
    additionally carry their registry identity — ``family`` (registry name),
    ``config`` (the :class:`~repro_torch.core.device.EGPUConfig` they were
    built for) and ``variant`` (canonicalized builder keywords).

    clSetKernelArg-style argument state: :attr:`arg_info` introspects the
    executor signature, :meth:`set_arg`/:meth:`set_args` stage arguments on
    the kernel object, and :meth:`CommandQueue.enqueue_kernel` launches with
    the staged arguments.  The staged state is *per kernel object* (and
    Program-created kernels are memoized singletons), so concurrent users
    staging different args on one kernel must pass args explicitly through
    ``enqueue_nd_range`` instead.
    """

    name: str
    executor: Callable[..., Any]
    counts: Optional[Callable[..., WorkCounts]] = None
    #: registry identity (set by Program.create_kernel; None for ad-hoc kernels)
    family: Optional[str] = None
    config: Optional[Any] = None            # EGPUConfig (hashable, frozen)
    variant: Tuple[Any, ...] = ()
    #: mutable clSetKernelArg storage; excluded from eq/hash
    args_state: _ArgState = dataclasses.field(
        default_factory=_ArgState, compare=False, repr=False)

    def with_identity(self, family: str, config: Any,
                      variant: Tuple[Any, ...]) -> "Kernel":
        """A copy of this kernel stamped with its registry identity."""
        return dataclasses.replace(self, family=family, config=config,
                                   variant=variant, args_state=_ArgState())

    # -- clGetKernelArgInfo --------------------------------------------------
    @property
    def arg_info(self) -> Optional[Tuple[ArgInfo, ...]]:
        """Executor argument metadata, or ``None`` when the executor's
        signature cannot be introspected.  A ``*args`` executor reports a
        single trailing variadic buffer entry named ``"*<name>"``."""
        return _introspect_executor(self.executor)[0]

    @property
    def n_buffer_args(self) -> Optional[Tuple[int, Optional[int]]]:
        """(min, max) buffer-argument arity; max is None for ``*args``
        executors, and the whole thing None when not introspectable.
        Defaulted positionals may be fed either a buffer or a param, so they
        widen max without raising min."""
        return _introspect_executor(self.executor)[1]

    # -- clSetKernelArg ------------------------------------------------------
    def set_args(self, *buffers: Any, **params: Any) -> "Kernel":
        """Stage positional buffer args and keyword params (clSetKernelArg
        for every index at once).  Non-:class:`Buffer` positionals are
        wrapped.  Returns ``self`` for chaining."""
        arity = self.n_buffer_args
        if arity is not None:
            lo, hi = arity
            if len(buffers) < lo or (hi is not None and len(buffers) > hi):
                bound = f"exactly {lo}" if hi == lo else (
                    f">= {lo}" if hi is None else f"{lo}..{hi}")
                raise ValueError(
                    f"kernel {self.name!r} takes {bound} buffer args, "
                    f"got {len(buffers)}")
        self.args_state.buffers = [
            b if isinstance(b, Buffer) else Buffer(b) for b in buffers]
        self.args_state.params = dict(params)
        return self

    def set_arg(self, index: int, value: Any) -> "Kernel":
        """clSetKernelArg: stage one argument by position.

        Buffer-kind indices take a :class:`Buffer` (or tensor, wrapped);
        param-kind indices stage the value under the parameter's name.
        """
        info = self.arg_info
        if info is None:
            raise TypeError(
                f"kernel {self.name!r} executor is not introspectable; "
                "use set_args(...) or pass args to enqueue_nd_range")
        if not 0 <= index < len(info):
            raise IndexError(
                f"kernel {self.name!r} has {len(info)} args, index {index} "
                "out of range")
        arg = info[index]
        if arg.kind == "param":
            self.args_state.params[arg.name] = value
            return self
        if arg.name.startswith("*"):
            raise ValueError(
                f"kernel {self.name!r} is variadic; stage buffers with "
                "set_args(...)")
        n_buf = sum(1 for a in info if a.kind == "buffer")
        if self.args_state.buffers is None:
            self.args_state.buffers = [None] * n_buf
        slot = sum(1 for a in info[:index] if a.kind == "buffer")
        self.args_state.buffers[slot] = (
            value if isinstance(value, Buffer) else Buffer(value))
        return self

    def staged_args(self) -> Tuple[Tuple["Buffer", ...], Dict[str, Any]]:
        """The staged (buffers, params) — raises if any buffer slot is unset."""
        st = self.args_state
        if st.buffers is None:
            raise RuntimeError(
                f"kernel {self.name!r} has no staged args; call set_args "
                "first (or pass args to enqueue_nd_range)")
        missing = [i for i, b in enumerate(st.buffers) if b is None]
        if missing:
            raise RuntimeError(
                f"kernel {self.name!r} buffer args {missing} are unset")
        return tuple(st.buffers), dict(st.params)


def _record_done(outputs: Sequence[Buffer]) -> Optional[Any]:
    """A ``torch.cuda.Event`` recorded behind work that produced
    ``outputs`` on the current stream, or None for CPU outputs (computed
    synchronously)."""
    for b in outputs:
        if b.data.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(b.data.device))
            return done
    return None


class Event:
    """Kernel-completion event: functional results + modeled time/energy.

    ``wait()`` blocks until the results are realized.

    Events are reference-counted like ``cl_event`` (clRetainEvent /
    clReleaseEvent): :meth:`release` drops the event's hold on its output
    buffers once the count reaches zero, so a long-lived queue can return
    completed launches to O(in-flight) memory (see
    :meth:`CommandQueue.release_events`).  Modeled cost metadata survives
    release — only the functional outputs are dropped.
    """

    def __init__(self, kernel: Kernel, outputs: Tuple[Buffer, ...],
                 modeled: Optional[PhaseBreakdown], energy_j: Optional[float],
                 deps: Tuple["Event", ...] = (),
                 device_done: Optional[Any] = None):
        self.kernel = kernel
        self.outputs = outputs
        self.modeled = modeled
        self.energy_j = energy_j
        #: events this one waits on (the in-order queue's implicit
        #: predecessor plus dataflow producers); cleared once realized or
        #: released so a long-lived queue never chains its whole history
        self.deps = tuple(deps)
        #: the torch.cuda.Event recorded behind this launch (None on CPU)
        self._device_done = device_done
        self._done = False
        self._refcount = 1

    @property
    def done(self) -> bool:
        return self._done

    @property
    def released(self) -> bool:
        return self._refcount <= 0

    def retain(self) -> "Event":
        """clRetainEvent: keep output buffers alive across a queue release."""
        if self._refcount <= 0:
            raise RuntimeError("cannot retain a released Event")
        self._refcount += 1
        return self

    def release(self) -> None:
        """clReleaseEvent: drop one reference; at zero, free the outputs.

        Idempotent once released.  The modeled breakdown / energy stay
        readable (they are O(1)); only the buffer references are dropped.
        """
        if self._refcount <= 0:
            return
        self._refcount -= 1
        if self._refcount == 0:
            self.outputs = ()
            self.deps = ()
            self._device_done = None

    def wait(self) -> Tuple[Buffer, ...]:
        """Block until this event (and its dependencies) completed.

        Waiting a *released* event raises ``RuntimeError``: the outputs are
        gone, so a silent empty return would hide a use-after-release bug.
        """
        if self.released:
            raise RuntimeError("cannot wait a released Event")
        # Iterative traversal: a long in-order chain of implicit deps must
        # not overflow the stack; already-realized or released deps prune.
        stack, seen, pending = [self], set(), []
        while stack:
            ev = stack.pop()
            if id(ev) in seen or ev._done or ev.released:
                continue
            seen.add(id(ev))
            pending.append(ev)
            stack.extend(ev.deps)
        for ev in pending:
            if ev._device_done is not None:
                ev._device_done.synchronize()
                ev._device_done = None
            ev._done = True
            ev.deps = ()                   # realized: drop the chain refs
        return self.outputs


class CommandQueue:
    """An in-order command queue bound to one device.

    Asynchronous OpenCL semantics: enqueue returns once the kernel is queued
    on the CUDA stream, and only ``Event.wait()`` / :meth:`finish`
    synchronize.  Every launch is implicitly chained after the previous one
    (OpenCL's default queue semantics).

    Event lifecycle: the queue keeps every event until
    :meth:`release_events` drops drained ones, folding their modeled
    time/energy into the queue's running totals, so :meth:`total_modeled_s`
    / :meth:`total_energy_j` stay exact whatever has been released.
    """

    def __init__(self, ctx: "Context"):
        self.ctx = ctx
        self._events: List[Event] = []
        self._drained = 0              # finish() watermark: events before
                                       # this index are already waited
        # Running totals of *released* events, so dropping an event from the
        # retained window never changes the queue's modeled accounting.
        self._released_count = 0
        self._released_modeled_s = 0.0
        self._released_energy_j = 0.0
        self._capture: Optional[CommandGraph] = None

    def _model(self, kernel: Kernel, ndr: NDRange,
               counts_params: Dict[str, Any], resident: bool
               ) -> Tuple[Optional[PhaseBreakdown], Optional[float],
                          Optional[WorkCounts]]:
        """Machine-model (breakdown, energy, counts) of one enqueued command.

        The config comes off the queue's device, so the breakdown is stamped
        with *that config's* clock (``PhaseBreakdown.freq_hz``) and energy
        prices at its (f, V) point.
        """
        if kernel.counts is None:
            return None, None, None
        counts = kernel.counts(**counts_params)
        if resident:
            counts = dataclasses.replace(counts, host_bytes=0.0)
        cfg = self.ctx.device.config
        if self.ctx.device.is_host:
            modeled = host_time(counts, cfg)
            return modeled, host_energy_j(modeled), counts
        modeled = egpu_time(cfg, counts, ndr)
        return modeled, egpu_energy_j(cfg, modeled), counts

    def _implicit_deps(self) -> Tuple[Event, ...]:
        """The in-order queue's ordering edge for the next eager launch."""
        prev = self._events[-1] if self._events else None
        return (prev,) if prev is not None and not prev.released else ()

    # -- the OpenCL-subset entry point -------------------------------------
    def enqueue_nd_range(self, kernel: Kernel, ndr: NDRange,
                         args: Sequence[Buffer],
                         params: Optional[Dict[str, Any]] = None,
                         counts_params: Optional[Dict[str, Any]] = None,
                         _resident: bool = False) -> Event:
        """Launch ``kernel`` over ``ndr`` with buffer ``args`` (non-blocking).

        ``params`` are executor kwargs (the paper's kernel-args region);
        ``counts_params`` are the problem sizes handed to the kernel's
        ``counts()`` for the machine model (defaults to ``params``).
        ``_resident=True`` marks a stage whose inputs are already resident
        in the unified memory / D$ (paper §IV-B pipeline chaining): the
        modeled host<->D$ transfer is waived for it.

        Inside a :meth:`capture` block the launch is recorded into the
        active :class:`CommandGraph` instead of executed; the returned
        event carries symbolic :class:`GraphBuffer` outputs.
        """
        params = params or {}
        cp = counts_params if counts_params is not None else params
        for i, b in enumerate(args):
            if not b.readable:
                raise ValueError(
                    f"kernel {kernel.name!r} arg {i} is a write-only "
                    f"(flags={b.flags!r}) buffer; kernels read their "
                    "arguments (CL_MEM_WRITE_ONLY violation)")
        if self._capture is not None:
            return self._capture._record(self, kernel, ndr, args, params, cp,
                                         _resident)
        raw = kernel.executor(*[b.data for b in args], **params)
        outs = tuple(Buffer(r) for r in (raw if isinstance(raw, tuple) else (raw,)))

        modeled, energy, _counts = self._model(kernel, ndr, cp, _resident)
        deps = self._implicit_deps()
        # Dataflow edges: consuming another launch's output buffer is an
        # ordering edge, so wait() realizes the producer transitively.
        for b in args:
            producer = getattr(b, "_event", None)
            if (producer is not None and not producer._done
                    and not producer.released and producer not in deps):
                deps += (producer,)
        ev = Event(kernel, outs, modeled, energy, deps=deps,
                   device_done=_record_done(outs))
        for b in outs:
            b._event = ev
        self._events.append(ev)
        return ev

    def enqueue_kernel(self, kernel: Kernel, ndr: Optional[NDRange] = None,
                       counts_params: Optional[Dict[str, Any]] = None,
                       _resident: bool = False) -> Event:
        """clEnqueueNDRangeKernel over the kernel's *staged* arguments.

        The OpenCL-shaped companion to :meth:`enqueue_nd_range`: arguments
        come from :meth:`Kernel.set_args` / :meth:`Kernel.set_arg` instead
        of the call site.  ``ndr`` defaults to the paper's §VIII-B optimal
        NDRange for the first buffer's element count on this queue's device.
        """
        bufs, params = kernel.staged_args()
        if ndr is None:
            if not bufs:
                raise ValueError(
                    "enqueue_kernel needs an explicit NDRange for a kernel "
                    "with no buffer args")
            ndr = optimal_ndrange(bufs[0].data.numel(),
                                  self.ctx.device.config)
        return self.enqueue_nd_range(kernel, ndr, bufs, params=params,
                                     counts_params=counts_params,
                                     _resident=_resident)

    # -- graph capture ------------------------------------------------------
    def capture(self) -> "CommandGraph":
        """Record subsequent enqueues into a :class:`CommandGraph`.

        Use as a context manager::

            with q.capture() as graph:
                q.enqueue_nd_range(k1, ndr, (a, b))   # recorded, not run
                ...
            outs = graph.launch()                      # replay the chain

        Launches inside the block run their executors on ``meta`` tensors
        only, so capture itself never touches the device.
        """
        return CommandGraph(self)

    def finish(self) -> None:
        """Block until every enqueued kernel completed (clFinish).

        Only events enqueued since the last ``finish()`` are waited (a
        drained-watermark: repeated drains on a long-lived queue stay O(new
        work), not O(full history))."""
        for ev in self._events[self._drained:]:
            if not ev.released:            # user-released mid-history: the
                ev.wait()                  # outputs are gone, nothing to wait
        self._drained = len(self._events)

    def drain(self, n: int) -> None:
        """Wait the oldest ``n`` retained events (a *partial* clFinish).

        Starts at the ``finish()`` watermark — events a previous drain
        already realized are never re-waited.  Pair with
        ``release_events(upto=n)`` to drop exactly that segment."""
        n = min(n, len(self._events))
        for ev in self._events[self._drained:n]:
            if not ev.released:
                ev.wait()
        self._drained = max(self._drained, n)

    def release_events(self, upto: Optional[int] = None) -> int:
        """Release and drop the oldest ``upto`` events (clReleaseEvent sweep).

        Only *drained* events are eligible — an event :meth:`finish` has not
        waited yet may still be in flight.  Each dropped event's modeled
        time/energy is folded into the queue's running totals first, so
        :meth:`total_modeled_s` / :meth:`total_energy_j` are unaffected.
        ``Event.retain()``-ed events are still dropped from the queue's
        history, but keep their output buffers alive for the holder.
        Returns the number of events released.
        """
        upto = self._drained if upto is None else min(upto, self._drained)
        if upto <= 0:
            return 0
        for ev in self._events[:upto]:
            if ev.modeled is not None:
                self._released_modeled_s += ev.modeled.total_s
            if ev.energy_j is not None:
                self._released_energy_j += ev.energy_j
            self._released_count += 1
            ev.release()
        del self._events[:upto]
        self._drained -= upto
        return upto

    @property
    def events(self) -> Tuple[Event, ...]:
        """Retained (not yet released) events, oldest first."""
        return tuple(self._events)

    @property
    def released_count(self) -> int:
        """Events released from this queue's history so far."""
        return self._released_count

    def total_modeled_s(self) -> float:
        # `is not None`, not truthiness: an all-zero PhaseBreakdown (e.g. a
        # fully resident stage) must still be counted.  Released events are
        # accounted via the running totals.
        return self._released_modeled_s + sum(
            e.modeled.total_s for e in self._events if e.modeled is not None)

    def total_energy_j(self) -> float:
        return self._released_energy_j + sum(
            e.energy_j for e in self._events if e.energy_j is not None)


@dataclasses.dataclass
class GraphNode:
    """One captured launch: kernel + wiring + capture-time machine model."""

    kernel: Kernel
    call: Callable[..., Any]            # executor with params pre-bound
    in_slots: Tuple[int, ...]
    out_slots: Tuple[int, ...]
    out_avals: Tuple[torch.Tensor, ...]  # meta tensors: shape + dtype
    modeled: Optional[PhaseBreakdown]
    energy_j: Optional[float]
    n_items: int = 0                    # first input's element count (the
                                        # NDRange sizing the eager path uses)
    #: indices of earlier nodes this one depends on (dataflow slots + the
    #: in-order queue's chain) — the edges the critical-path model walks
    deps: Tuple[int, ...] = ()


class CommandGraph:
    """A captured kernel chain, replayed in order on launch.

    Built by :meth:`CommandQueue.capture`.  While capturing, every
    ``enqueue_nd_range`` appends a :class:`GraphNode`: inputs are resolved to
    *slots* — either graph-external buffers (concrete data seen during
    capture) or earlier nodes' outputs — and output shapes come from the
    executor run on ``meta`` tensors, so nothing executes.  Each node also
    records its dependency edges: dataflow and the in-order chain.

    :meth:`launch` replays all nodes; the graph's outputs are the final
    node's outputs.  Launches bind to the *caller's* queue
    (``launch(..., queue=...)``): events and modeled totals land on the
    queue that launched, not the one that captured.

    Per-node ``modeled`` / ``energy_j`` come from the captured schedule
    (``WorkCounts`` at capture time) on the capturing queue's device, giving
    the same per-stage Fig-3/Fig-4 accounting as eager dispatch;
    :meth:`fused_modeled` walks the dependency DAG's critical path.
    """

    def __init__(self, queue: CommandQueue):
        self.queue = queue                     # home queue: default binding
        self.nodes: List[GraphNode] = []
        self._n_slots = 0
        self._ext_slots: List[int] = []        # slot index of each external
        self._ext_values: List[torch.Tensor] = []  # captured concrete externals
        self._ext_avals: List[torch.Tensor] = []   # their meta stand-ins
        self._buf_slot: Dict[int, int] = {}    # id(Buffer) -> slot
        self._bufs_alive: List[Buffer] = []    # keep ids stable during capture
        self._slot_producer: Dict[int, int] = {}   # slot -> producing node
        self._sealed = False
        self._fused_memo: Optional[Tuple[Optional[PhaseBreakdown], float]] = None
        #: how many leading externals are pipeline inputs (set by
        #: APU.capture_pipeline; the rest are per-stage constants)
        self.n_request_inputs = 0

    # -- capture ------------------------------------------------------------
    def __enter__(self) -> "CommandGraph":
        if self.queue._capture is not None:
            raise RuntimeError("CommandQueue is already capturing")
        self.queue._capture = self
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.queue._capture is self:
            self.queue._capture = None
        # Only a capture body that completed cleanly yields a launchable
        # graph; an exception mid-capture leaves a truncated chain.
        self._sealed = exc_type is None

    def _slot_of(self, buf: Buffer) -> int:
        slot = self._buf_slot.get(id(buf))
        if slot is None:
            if isinstance(buf, GraphBuffer):
                raise RuntimeError(
                    "GraphBuffer from a different capture passed as input")
            slot = self._new_slot()
            self._buf_slot[id(buf)] = slot
            self._bufs_alive.append(buf)
            self._ext_slots.append(slot)
            self._ext_values.append(buf.data)
            self._ext_avals.append(_meta_like(buf.data))
        return slot

    def _new_slot(self) -> int:
        s = self._n_slots
        self._n_slots += 1
        return s

    def _record(self, queue: CommandQueue, kernel: Kernel, ndr: NDRange,
                args: Sequence[Buffer], params: Dict[str, Any],
                counts_params: Dict[str, Any], resident: bool) -> Event:
        in_slots = tuple(self._slot_of(b) for b in args)
        in_avals = tuple(_meta_like(b.data) for b in args)

        def call(*tensors, _exe=kernel.executor, _params=dict(params)):
            out = _exe(*tensors, **_params)
            return out if isinstance(out, tuple) else (out,)

        out_avals = tuple(call(*in_avals))
        for a in out_avals:
            if a.device.type != "meta":
                raise RuntimeError(
                    f"kernel {kernel.name!r} returned a {a.device} tensor "
                    "for meta inputs; executors must keep meta in, meta out")
        out_slots = tuple(self._new_slot() for _ in out_avals)
        modeled, energy, _counts = queue._model(kernel, ndr, counts_params,
                                                resident)

        # Dependency edges: dataflow + the in-order chain.
        deps = set()
        for s in in_slots:
            producer = self._slot_producer.get(s)
            if producer is not None:
                deps.add(producer)
        if self.nodes:
            deps.add(len(self.nodes) - 1)
        idx = len(self.nodes)
        self.nodes.append(
            GraphNode(kernel, call, in_slots, out_slots, out_avals, modeled,
                      energy,
                      n_items=int(args[0].data.numel()) if args else 0,
                      deps=tuple(sorted(deps))))
        for s in out_slots:
            self._slot_producer[s] = idx
        outs = tuple(GraphBuffer(a, s) for a, s in zip(out_avals, out_slots))
        for b in outs:
            self._buf_slot[id(b)] = b.slot
            self._bufs_alive.append(b)
        return Event(kernel, outs, modeled, energy)

    # -- accounting ---------------------------------------------------------
    @property
    def n_external(self) -> int:
        return len(self._ext_slots)

    @property
    def ext_avals(self) -> Tuple[torch.Tensor, ...]:
        """Meta stand-ins (shape/dtype) of each external input, in capture
        order."""
        return tuple(self._ext_avals)

    def modeled_breakdowns(self) -> Tuple[Optional[PhaseBreakdown], ...]:
        return tuple(n.modeled for n in self.nodes)

    def node_deps(self) -> Tuple[Tuple[int, ...], ...]:
        """Per-node dependency edges (indices into :attr:`nodes`)."""
        return tuple(n.deps for n in self.nodes)

    def total_modeled_s(self) -> float:
        return sum(n.modeled.total_s for n in self.nodes
                   if n.modeled is not None)

    def total_energy_j(self) -> float:
        return sum(n.energy_j for n in self.nodes if n.energy_j is not None)

    def fused_modeled(self) -> Tuple[Optional[PhaseBreakdown], float]:
        """(fused breakdown, total energy) of the captured chain, memoized.

        The breakdown is the critical path through the dependency DAG
        (:func:`~repro_torch.core.machine.fuse_breakdowns` with ``deps``);
        for the in-order chain this runtime captures it equals the classic
        chain fusion, with startup and scheduling paid once.  Energy sums
        over every node.  Both come from capture time and never change
        across launches.  The breakdown is ``None`` when no node carries a
        machine model.
        """
        if self._fused_memo is None:
            mods = self.modeled_breakdowns()
            fused = (fuse_breakdowns(mods, deps=self.node_deps())
                     if any(m is not None for m in mods) else None)
            self._fused_memo = (fused, self.total_energy_j())
        return self._fused_memo

    @property
    def out_avals(self) -> Tuple[torch.Tensor, ...]:
        """Meta stand-ins (shape/dtype) of each launch output, in output
        order."""
        slot_aval: Dict[int, torch.Tensor] = {}
        for node in self.nodes:
            for s, a in zip(node.out_slots, node.out_avals):
                slot_aval[s] = a
        return tuple(slot_aval[s] for s in self._output_slots())

    # -- launch -------------------------------------------------------------
    def _output_slots(self) -> Tuple[int, ...]:
        """The slots a launch returns: the last node's outputs."""
        return next(n.out_slots for n in reversed(self.nodes) if n.out_slots)

    def launch(self, *inputs: Any,
               queue: Optional[CommandQueue] = None) -> Tuple[Buffer, ...]:
        """Replay the captured chain (non-blocking on a CUDA device).

        ``inputs`` replace the graph's external buffers in capture order
        (shapes, dtypes and devices must match); with no inputs the tensors
        captured at record time are reused.  The nodes run in order on the
        current stream.  Returns the final node's outputs as fresh buffers.

        **Launch-time queue binding**: per-node modeled events are appended
        to ``queue`` — the *caller's* queue — defaulting to the capture
        queue for one-shot use.
        """
        if self.queue._capture is self:
            raise RuntimeError("cannot launch while still capturing")
        if not self._sealed:
            raise RuntimeError(
                "capture did not complete cleanly; re-capture the chain "
                "before launching")
        if not any(n.out_slots for n in self.nodes):
            raise RuntimeError(
                "cannot launch an empty CommandGraph (no kernel nodes)")
        ext = list(inputs) if inputs else list(self._ext_values)
        if len(ext) != len(self._ext_slots):
            raise ValueError(
                f"graph takes {len(self._ext_slots)} external inputs, "
                f"got {len(ext)}")
        ext = [x.data if isinstance(x, Buffer) else x for x in ext]
        # Shape/dtype/device must match the capture: a silent mismatch
        # would attach capture-time modeled costs to a differently-sized
        # computation.
        for i, (x, captured) in enumerate(zip(ext, self._ext_values)):
            if not isinstance(x, torch.Tensor):
                raise TypeError(
                    f"launch input {i} is a {type(x).__name__}, expected a "
                    "torch.Tensor")
            if x.shape != captured.shape or x.dtype != captured.dtype:
                raise ValueError(
                    f"launch input {i} is {tuple(x.shape)}/{x.dtype}, but "
                    f"the graph was captured with {tuple(captured.shape)}/"
                    f"{captured.dtype}; re-capture for a different problem "
                    "size")
            if x.device != captured.device:
                raise ValueError(
                    f"launch input {i} lies on {x.device}, but the graph was "
                    f"captured on {captured.device}")
        vals: List[Any] = [None] * self._n_slots
        for slot, v in zip(self._ext_slots, ext):
            vals[slot] = v
        for node in self.nodes:
            outs = node.call(*[vals[s] for s in node.in_slots])
            for slot, o in zip(node.out_slots, outs):
                vals[slot] = o
        outs = tuple(Buffer(vals[s]) for s in self._output_slots())
        done = _record_done(outs)
        target = queue if queue is not None else self.queue
        slot_buf = dict(zip(self._output_slots(), outs))
        for node in self.nodes:
            node_outs = tuple(slot_buf[s] for s in node.out_slots
                              if s in slot_buf)
            ev = Event(node.kernel, node_outs, node.modeled,
                       node.energy_j, device_done=done)
            target._events.append(ev)
            for b in node_outs:          # dataflow edge for later eager
                b._event = ev            # consumers, same as enqueue
        return outs

    def launch_prefix(self, inputs: Sequence[Any],
                      queue: Optional[CommandQueue] = None
                      ) -> Tuple[Buffer, ...]:
        """Launch with only the first ``len(inputs)`` externals replaced.

        The remaining externals keep the tensors captured at record time —
        for a pipeline graph these are the per-stage constant buffers
        (weights, coefficients), so a caller can feed fresh request data
        without re-threading the pipeline's parameters.  Pass ``queue=`` to
        bind the launch's events and modeled totals to the caller's queue.
        """
        inputs = list(inputs)
        if len(inputs) > len(self._ext_values):
            raise ValueError(
                f"launch_prefix got {len(inputs)} inputs but the graph has "
                f"only {len(self._ext_values)} externals")
        return self.launch(*inputs, *self._ext_values[len(inputs):],
                           queue=queue)


class Device:
    """One modeled compute device: an e-GPU instance or the scalar host."""

    def __init__(self, config: EGPUConfig = EGPU_16T):
        self.config = config

    @property
    def is_host(self) -> bool:
        return self.config.name == HOST.name


class Context:
    """A modeled device plus the torch device its buffers live on.

    ``torch_device`` defaults to ``"cuda"`` and raises when no card is
    present; pass ``"cpu"`` to run the kernels' plain PyTorch versions.
    """

    def __init__(self, device: Device, torch_device: Any = "cuda"):
        self.device = device
        self.torch_device = resolve_device(torch_device)

    def create_buffer(self, data: Any, flags: str = "rw") -> Buffer:
        """clCreateBuffer analogue: a tensor already on this context's torch
        device is adopted as-is (it already lives in the unified memory);
        anything else (a numpy array, a Python scalar, a tensor elsewhere)
        is copied onto the device."""
        if isinstance(data, torch.Tensor) and data.device == self.torch_device:
            return Buffer(data, flags)
        return Buffer(torch.as_tensor(data).to(self.torch_device), flags)
