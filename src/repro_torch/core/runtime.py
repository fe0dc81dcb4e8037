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

``enqueue_nd_range`` is non-blocking on a CUDA device: the kernel is queued
on the current CUDA stream and the returned :class:`Event` records a
``torch.cuda.Event`` behind it.  ``Event.wait()`` synchronizes that event
(and, transitively, the events it depends on) and ``CommandQueue.finish()``
drains the queue (``clFinish``).  ``CommandQueue(ctx, blocking=True)`` (and
``blocking=True`` on a transfer command) waits on each command's own
completion before the enqueue returns; ``Event.dispatch_s`` is the host
seconds the enqueue took.  ``CommandQueue(ctx, profile=False)`` books no
machine model and releases its events at every ``finish()``;
``max_events=N`` keeps only the newest N drained events of a profiled queue.

Ordering follows OpenCL.  An in-order queue (the default) chains every
command after the previous one.  ``CommandQueue(ctx, out_of_order=True)``
drops that chain: a command then depends only on its ``wait_events=``
list, on the commands that produced the buffers it reads (dataflow), and on
the queue's latest :meth:`~CommandQueue.enqueue_barrier`.
:meth:`~CommandQueue.enqueue_marker` aggregates events.  Kernels are pure
functions, so ordering never changes a result: it is a synchronization and
machine-model contract.

Data movement is first-class: ``enqueue_write_buffer`` /
``enqueue_read_buffer`` / ``enqueue_copy_buffer`` return events costed as
transfer-only :class:`PhaseBreakdown`\\ s from the machine model's bus
parameters.  Under unified memory no byte moves on the card: a write or a
copy *rebinds* the destination buffer to the source tensor (never writing
into it), and a read returns the buffer itself.

``queue.capture()`` records every command issued inside the ``with`` block
into a :class:`CommandGraph` **without executing it**: output shapes come
from running each executor on ``meta`` tensors, which carry a shape and a
dtype but no storage.  Each node records its dependency edges (dataflow,
``wait_events``, the queue's ordering rules); markers and barriers are
zero-cost nodes and transfers are identity nodes carrying their modeled
traffic.  ``graph.join(other_queue)`` records a second queue's commands
(the host's, say) into the same capture.  ``graph.launch(*inputs)`` replays
the nodes in order on the current stream.  Per-node machine-model
accounting is costed from each node's ``WorkCounts`` at capture time, and
:meth:`CommandGraph.fused_modeled` reports the DAG's critical path with
startup and scheduling paid once.  A launch binds its events and modeled
totals to the caller's queue (``launch(..., queue=...)``).

Kernels execute functionally (outputs are fresh tensors), so a graph launch
and the eager path give the same bits.  :class:`Buffer` flags are enforced:
kernels and reads cannot read write-only buffers, writes and copies cannot
write read-only ones.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import os
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .device import EGPUConfig, EGPU_16T, HOST
from .machine import (PhaseBreakdown, WorkCounts, egpu_time, fuse_breakdowns,
                      host_time, transfer_time)
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
    launch or an ``enqueue_read_buffer`` *reads* its buffers, so a
    write-only (``"w"``) buffer raises there; ``enqueue_write_buffer`` and
    ``enqueue_copy_buffer`` *write* their destination, so a read-only
    (``"r"``) destination raises.  Kernels execute functionally (outputs are
    fresh buffers), and a write or copy rebinds the destination to the
    source tensor, so no command writes into a tensor in place.
    """

    def __init__(self, data: Any, flags: str = "rw"):
        if flags not in _BUFFER_FLAGS:
            raise ValueError(
                f"invalid buffer flags {flags!r}: expected one of "
                f"{_BUFFER_FLAGS} (CL_MEM_READ_ONLY / WRITE_ONLY / "
                "READ_WRITE)")
        self.data = data if isinstance(data, torch.Tensor) else torch.as_tensor(data)
        self.flags = flags

    #: set once the buffer was donated to a graph launch
    #: (``CommandGraph.launch(..., donate=...)``): its storage belongs to
    #: the launch, so reading it or passing it to a later command raises
    consumed = False

    def _check_live(self, what: str) -> None:
        if self.consumed:
            raise RuntimeError(
                f"{what}: buffer was donated to a graph launch and is "
                "consumed; use the launch's outputs instead")

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
        self._check_live("read")
        return self.data


class GraphBuffer(Buffer):
    """A symbolic buffer produced while capturing a :class:`CommandGraph`.

    Carries only a ``meta`` tensor (shape/dtype/numel all work); the
    concrete value exists only while the graph is launched.  ``flags`` are
    the logical source buffer's for a transfer node's output and ``"rw"``
    for a kernel's, so access control survives capture.
    """

    def __init__(self, aval: torch.Tensor, slot: int, flags: str = "rw"):
        self.data = aval
        self.flags = flags
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


def _sum_step(acc: Tuple[float, float], x: float) -> Tuple[float, float]:
    """One step of the compensated (Neumaier) sum that Python's built-in
    ``sum()`` runs over floats (CPython 3.12+); ``acc`` is (sum, carry)."""
    s, c = acc
    t = s + x
    c += (s - t) + x if abs(s) >= abs(x) else (x - t) + s
    return t, c


def _sum_value(acc: Tuple[float, float]) -> float:
    """The sum ``acc`` stands for (``sum()``'s final carry-in)."""
    s, c = acc
    return s + c if c and math.isfinite(c) else s


class Event:
    """Kernel-completion event: functional results + modeled time/energy.

    ``dispatch_s`` is the host seconds the *enqueue* took (the executor
    call, plus the wait on the launch's completion on a blocking queue;
    0.0 for transfers, markers and capture-time events); ``wall_s`` is its
    alias.  ``wait()`` blocks until the results are realized.

    Events are reference-counted like ``cl_event`` (clRetainEvent /
    clReleaseEvent): :meth:`release` drops the event's hold on its output
    buffers once the count reaches zero, so a long-lived queue can return
    completed launches to O(in-flight) memory (see
    :meth:`CommandQueue.release_events`).  Modeled cost metadata survives
    release — only the functional outputs are dropped.
    """

    def __init__(self, kernel: Kernel, outputs: Tuple[Buffer, ...],
                 modeled: Optional[PhaseBreakdown], energy_j: Optional[float],
                 dispatch_s: float = 0.0, deps: Tuple["Event", ...] = (),
                 device_done: Optional[Any] = None):
        self.kernel = kernel
        self.outputs = outputs
        self.modeled = modeled
        self.energy_j = energy_j
        self.dispatch_s = dispatch_s
        #: events this one waits on (explicit ``wait_events``, the queue's
        #: implicit ordering edge, dataflow producers); cleared once realized
        #: or released so a long-lived queue never chains its whole history
        self.deps = tuple(deps)
        #: the torch.cuda.Event recorded behind this launch (None on CPU)
        self._device_done = device_done
        self._done = False
        self._refcount = 1
        #: set on events returned during a capture: the graph and the node
        #: indices the event stands for (what a ``wait_events`` list names)
        self._graph: Optional["CommandGraph"] = None
        self._dep_nodes: frozenset = frozenset()

    @property
    def wall_s(self) -> float:
        """Alias of ``dispatch_s``.  Readable on a released event, like
        ``modeled`` and ``energy_j``: release drops only the outputs."""
        return self.dispatch_s

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


#: sentinel kernel for marker/barrier events (clEnqueueMarkerWithWaitList /
#: clEnqueueBarrierWithWaitList) — never executed, carries no cost model
_MARKER = Kernel(name="marker", executor=lambda: ())

#: sentinel kernels identifying explicit data-movement commands; their
#: modeled cost is a transfer-only PhaseBreakdown attached per event/node
_WRITE = Kernel(name="write_buffer", executor=lambda x: (x,))
_READ = Kernel(name="read_buffer", executor=lambda x: (x,))
_COPY = Kernel(name="copy_buffer", executor=lambda x: (x,))


class CommandQueue:
    """A command queue bound to one device.

    ``blocking=False`` (default) gives asynchronous OpenCL semantics:
    enqueue returns once the kernel is queued on the CUDA stream, and only
    ``Event.wait()`` / :meth:`finish` synchronize.  ``blocking=True`` is
    eager-sync dispatch: every command waits on its own completion (the
    launch's recorded ``torch.cuda.Event``, never a device-wide
    synchronize) before the enqueue returns, and its event is ``done``.

    Ordering (``out_of_order``): an in-order queue (default) implicitly
    chains every command after the previous one, OpenCL's default queue
    semantics.  ``out_of_order=True`` is the
    ``CL_QUEUE_OUT_OF_ORDER_EXEC_MODE_ENABLE`` analogue: commands carry no
    implicit ordering — dependencies come only from ``wait_events=`` lists,
    dataflow (consuming a prior event's output buffers), and
    :meth:`enqueue_barrier` points.  Two commands with neither are
    unordered (concurrent in the machine model's critical path).

    Event lifecycle: an unprofiled queue (``profile=False``) books no
    machine model and releases its events on :meth:`finish`, so a
    long-lived queue stays O(in-flight) memory.  A profiled queue keeps
    every event by default; ``max_events=N`` is a bounded profiling window:
    :meth:`finish` keeps only the newest N drained events.  Released events
    have their modeled time/energy folded into the queue's running totals,
    so :meth:`total_modeled_s` / :meth:`total_energy_j` stay exact whatever
    has been released.

    ``tracer`` (a :class:`~repro_torch.obs.Tracer`) turns on span tracing:
    every booked event becomes one span on the track ``trace_track``
    (default ``queue:<config name>``), laid end to end on the queue's
    cumulative *modeled* timeline.  Strictly observational, and guarded at
    each booking site, so an untraced queue allocates nothing for it.
    """

    def __init__(self, ctx: "Context", profile: bool = True,
                 blocking: bool = False, max_events: Optional[int] = None,
                 out_of_order: bool = False, tracer: Optional[Any] = None,
                 trace_track: Optional[str] = None):
        if max_events is not None and max_events < 0:
            raise ValueError("max_events must be None or >= 0")
        self.ctx = ctx
        self.profile = profile
        self.blocking = blocking
        self.max_events = max_events
        self.out_of_order = out_of_order
        self._tracer = tracer
        self._trace_track = trace_track or f"queue:{ctx.device.config.name}"
        self._trace_t = 0.0
        self._barrier: Optional[Event] = None   # latest eager barrier event
        self._events: List[Event] = []
        self._drained = 0              # finish() watermark: events before
                                       # this index are already waited
        # Running totals of *released* events, so dropping an event from the
        # retained window never changes the queue's modeled accounting:
        # (sum, carry) of one compensated sum in enqueue order, which the
        # totals continue over the retained events — a windowed queue's
        # totals have the bits of a full-history queue's (and of ``sum()``
        # over every event, the JAX package's full-history totals).
        self._released_count = 0
        self._released_modeled_s = (0.0, 0.0)
        self._released_energy_j = (0.0, 0.0)
        self._capture: Optional[CommandGraph] = None

    def _model(self, kernel: Kernel, ndr: NDRange,
               counts_params: Dict[str, Any], resident: bool
               ) -> Tuple[Optional[PhaseBreakdown], Optional[float],
                          Optional[WorkCounts]]:
        """Machine-model (breakdown, energy, counts) of one enqueued command.

        The config comes off the queue's device, so the breakdown is stamped
        with *that config's* clock (``PhaseBreakdown.freq_hz``) and energy
        prices at its (f, V) point.  An unprofiled queue books nothing, in a
        capture too: a graph captured on it prices no node.
        """
        if not self.profile or kernel.counts is None:
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

    def _trace_event(self, ev: "Event") -> None:
        """Record one booked event as a span on this queue's modeled
        timeline (only reached when a tracer is installed)."""
        dur = ev.modeled.total_s if ev.modeled is not None else 0.0
        self._tracer.span(ev.kernel.name, self._trace_t,
                          self._trace_t + dur, track=self._trace_track,
                          dispatch_s=ev.dispatch_s)
        self._trace_t += dur

    def _model_transfer(self, nbytes: float
                        ) -> Tuple[Optional[PhaseBreakdown], Optional[float]]:
        """Transfer-only cost of an explicit buffer command on this device
        (nothing on an unprofiled queue)."""
        if not self.profile:
            return None, None
        cfg = self.ctx.device.config
        modeled = transfer_time(cfg, nbytes)
        if self.ctx.device.is_host:
            return modeled, host_energy_j(modeled)
        return modeled, egpu_energy_j(cfg, modeled)

    def _check_wait_events(self, wait_events: Optional[Sequence[Event]]
                           ) -> Tuple[Event, ...]:
        evs = tuple(wait_events or ())
        for ev in evs:
            if not isinstance(ev, Event):
                raise TypeError(
                    f"wait_events must contain Events, got "
                    f"{type(ev).__name__}")
            if ev.released:
                raise RuntimeError(
                    "wait_events contains a released Event (use-after-"
                    "release)")
            if self._capture is None and ev._graph is not None:
                raise RuntimeError(
                    "wait_events contains a capture-time Event; an eager "
                    "command can only wait events of executed launches")
        return evs

    def _implicit_deps(self) -> Tuple[Event, ...]:
        """The queue's implicit ordering edge for the next eager command:
        the previous command (in-order) or the latest barrier
        (out-of-order)."""
        if not self.out_of_order:
            prev = self._events[-1] if self._events else None
            return (prev,) if prev is not None and not prev.released else ()
        if self._barrier is not None and not self._barrier.released:
            return (self._barrier,)
        return ()

    def _eager_deps(self, waits: Tuple[Event, ...],
                    reads: Sequence[Buffer]) -> Tuple[Event, ...]:
        """``wait_events`` + the queue's ordering edge + dataflow edges:
        consuming another command's output buffer orders after it (even on
        an out-of-order queue, and across queues), so ``wait()`` realizes
        the producer transitively."""
        deps = waits + self._implicit_deps()
        for b in reads:
            producer = getattr(b, "_event", None)
            if (producer is not None and not producer._done
                    and not producer.released and producer not in deps):
                deps += (producer,)
        return deps

    # -- the OpenCL-subset entry point -------------------------------------
    def enqueue_nd_range(self, kernel: Kernel, ndr: NDRange,
                         args: Sequence[Buffer],
                         params: Optional[Dict[str, Any]] = None,
                         counts_params: Optional[Dict[str, Any]] = None,
                         wait_events: Optional[Sequence[Event]] = None,
                         _resident: bool = False) -> Event:
        """Launch ``kernel`` over ``ndr`` with buffer ``args`` (non-blocking
        unless the queue is).

        ``params`` are executor kwargs (the paper's kernel-args region);
        ``counts_params`` are the problem sizes handed to the kernel's
        ``counts()`` for the machine model (defaults to ``params``).
        ``wait_events`` is the OpenCL ``event_wait_list``: events this
        launch must observe beyond its dataflow inputs.  On an in-order
        queue it adds edges on top of the implicit chain; on an
        ``out_of_order`` queue it is the only explicit ordering.
        ``_resident=True`` marks a stage whose inputs are already resident
        in the unified memory / D$ (paper §IV-B pipeline chaining): the
        modeled host<->D$ transfer is waived for it.

        Inside a :meth:`capture` block the launch is recorded into the
        active :class:`CommandGraph` instead of executed; the returned
        event carries symbolic :class:`GraphBuffer` outputs and its
        dependency edges become the node's ``deps``.
        """
        params = params or {}
        cp = counts_params if counts_params is not None else params
        waits = self._check_wait_events(wait_events)
        for i, b in enumerate(args):
            b._check_live(f"kernel {kernel.name!r} arg {i}")
            if not b.readable:
                raise ValueError(
                    f"kernel {kernel.name!r} arg {i} is a write-only "
                    f"(flags={b.flags!r}) buffer; kernels read their "
                    "arguments (CL_MEM_WRITE_ONLY violation)")
        if self._capture is not None:
            return self._capture._record(self, kernel, ndr, args, params, cp,
                                         _resident, waits)
        t0 = time.perf_counter()
        raw = kernel.executor(*[b.data for b in args], **params)
        outs = tuple(Buffer(r) for r in (raw if isinstance(raw, tuple) else (raw,)))
        done = _record_done(outs)
        if self.blocking and done is not None:
            done.synchronize()           # this launch only, not the device
        dispatch = time.perf_counter() - t0

        modeled, energy, _counts = self._model(kernel, ndr, cp, _resident)
        ev = Event(kernel, outs, modeled, energy, dispatch,
                   deps=self._eager_deps(waits, args), device_done=done)
        for b in outs:
            b._event = ev
        if self.blocking:
            ev._done = True
            ev.deps = ()
            ev._device_done = None
        self._events.append(ev)
        if self._tracer is not None:
            self._trace_event(ev)
        return ev

    def enqueue_kernel(self, kernel: Kernel, ndr: Optional[NDRange] = None,
                       counts_params: Optional[Dict[str, Any]] = None,
                       wait_events: Optional[Sequence[Event]] = None,
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
                                     wait_events=wait_events,
                                     _resident=_resident)

    # -- explicit data movement ---------------------------------------------
    def _transfer_event(self, kernel: Kernel, outputs: Tuple[Buffer, ...],
                        nbytes: float, waits: Tuple[Event, ...],
                        reads: Sequence[Buffer], blocking: bool) -> Event:
        """Eager transfer command: modeled cost + event-DAG bookkeeping.
        No device work is queued (unified memory), so the event is realized
        once its dependencies are; a blocking transfer waits on them before
        it returns."""
        modeled, energy = self._model_transfer(nbytes)
        ev = Event(kernel, outputs, modeled, energy,
                   deps=self._eager_deps(waits, reads))
        if self.blocking or blocking:
            ev.wait()
        self._events.append(ev)
        if self._tracer is not None:
            self._trace_event(ev)
        return ev

    @staticmethod
    def _check_aval_match(what: str, data: torch.Tensor, buf: Buffer) -> None:
        if tuple(data.shape) != tuple(buf.shape) or data.dtype != buf.dtype:
            raise ValueError(
                f"{what}: source {tuple(data.shape)}/{data.dtype} does not "
                f"match destination buffer {tuple(buf.shape)}/{buf.dtype} "
                "(sub-buffer offsets are not supported)")

    def enqueue_write_buffer(self, buf: Buffer, src: Any,
                             wait_events: Optional[Sequence[Event]] = None,
                             blocking: bool = False) -> Event:
        """clEnqueueWriteBuffer: move host data into ``buf`` (host -> D$).

        A first-class command: it returns a real :class:`Event`, is costed
        as a transfer-only :class:`PhaseBreakdown` from the device's bus
        parameters, obeys the queue's ordering rules (implicit chain /
        ``wait_events`` / barriers) and — under :meth:`capture` — records a
        transfer :class:`GraphNode`, so the DAG critical path can overlap
        it with compute on independent branches.  ``buf`` must be writable.
        ``src`` is a :class:`Buffer` or anything ``Context.create_buffer``
        takes (a numpy array or a tensor elsewhere is copied onto the
        context's device).  ``buf`` is rebound to the source tensor, never
        written in place; later commands consuming ``buf`` observe the
        written value (the event is ``buf``'s new producer).
        ``blocking=True`` is CL_TRUE: wait before returning.
        """
        waits = self._check_wait_events(wait_events)
        if not buf.writable:
            raise ValueError(
                f"enqueue_write_buffer into a read-only buffer "
                f"(flags={buf.flags!r}) — CL_MEM_READ_ONLY violation")
        if isinstance(src, Buffer) and not src.readable:
            raise ValueError(
                f"enqueue_write_buffer from a write-only source "
                f"(flags={src.flags!r}) — CL_MEM_WRITE_ONLY violation")
        if self._capture is not None:
            return self._capture._record_transfer(self, "write", buf, src,
                                                  waits)
        if isinstance(buf, GraphBuffer) or isinstance(src, GraphBuffer):
            raise RuntimeError(
                "cannot write GraphBuffers eagerly; they have no storage "
                "outside their graph's launch")
        src_buf = src if isinstance(src, Buffer) else self.ctx.create_buffer(src)
        self._check_aval_match("enqueue_write_buffer", src_buf.data, buf)
        buf.data = src_buf.data
        ev = self._transfer_event(_WRITE, (buf,), buf.nbytes, waits,
                                  (src_buf, buf), blocking)
        buf._event = ev
        return ev

    def enqueue_read_buffer(self, buf: Buffer,
                            wait_events: Optional[Sequence[Event]] = None,
                            blocking: bool = False) -> Event:
        """clEnqueueReadBuffer: move ``buf`` to the host (D$ -> host).

        Under unified memory the returned event's output *is* the buffer,
        on the context's device (no copy is made), but the command is costed
        as a real transfer over the host bus and takes part in event
        ordering and graph capture — a capture ending in read commands
        returns the read-back values as the graph's outputs.  ``buf`` must
        be readable.  ``blocking=True`` is CL_TRUE: wait before returning.
        """
        waits = self._check_wait_events(wait_events)
        if not buf.readable:
            raise ValueError(
                f"enqueue_read_buffer from a write-only buffer "
                f"(flags={buf.flags!r}) — CL_MEM_WRITE_ONLY violation")
        if self._capture is not None:
            return self._capture._record_transfer(self, "read", buf, None,
                                                  waits)
        if isinstance(buf, GraphBuffer):
            raise RuntimeError(
                "cannot read a GraphBuffer eagerly; launch its graph and "
                "read the outputs instead")
        return self._transfer_event(_READ, (buf,), buf.nbytes, waits, (buf,),
                                    blocking)

    def enqueue_copy_buffer(self, src: Buffer, dst: Buffer,
                            wait_events: Optional[Sequence[Event]] = None
                            ) -> Event:
        """clEnqueueCopyBuffer: device-side copy ``src`` -> ``dst``.

        ``src`` must be readable and ``dst`` writable, with matching
        shape/dtype.  Costed as one bus transfer of ``src.nbytes``; after
        the event, ``dst`` holds ``src``'s value (kernels never write into
        a tensor, so the unified-memory copy is an alias).
        """
        waits = self._check_wait_events(wait_events)
        if not src.readable:
            raise ValueError(
                f"enqueue_copy_buffer from a write-only source "
                f"(flags={src.flags!r})")
        if not dst.writable:
            raise ValueError(
                f"enqueue_copy_buffer into a read-only destination "
                f"(flags={dst.flags!r}) — CL_MEM_READ_ONLY violation")
        self._check_aval_match("enqueue_copy_buffer", src.data, dst)
        if self._capture is not None:
            return self._capture._record_transfer(self, "copy", dst, src,
                                                  waits)
        if isinstance(src, GraphBuffer) or isinstance(dst, GraphBuffer):
            raise RuntimeError(
                "cannot copy GraphBuffers eagerly; they have no storage "
                "outside their graph's launch")
        dst.data = src.data
        ev = self._transfer_event(_COPY, (dst,), src.nbytes, waits,
                                  (src, dst), blocking=False)
        dst._event = ev
        return ev

    # -- synchronization commands ------------------------------------------
    def enqueue_marker(self, wait_events: Optional[Sequence[Event]] = None
                       ) -> Event:
        """clEnqueueMarkerWithWaitList: an event completing once
        ``wait_events`` (default: everything enqueued on this queue so far)
        have completed.  Carries no cost model and no outputs."""
        return self._enqueue_sync(wait_events, barrier=False)

    def enqueue_barrier(self, wait_events: Optional[Sequence[Event]] = None
                        ) -> Event:
        """clEnqueueBarrierWithWaitList: like :meth:`enqueue_marker`, but
        also an ordering point — every *subsequent* command on an
        ``out_of_order`` queue implicitly depends on it (in-order queues
        already chain, so there it only returns the aggregate event)."""
        return self._enqueue_sync(wait_events, barrier=True)

    def _enqueue_sync(self, wait_events: Optional[Sequence[Event]],
                      barrier: bool) -> Event:
        # OpenCL: an empty wait list means "all previously enqueued
        # commands", same as passing none at all.
        waits = self._check_wait_events(wait_events) or None
        if self._capture is not None:
            return self._capture._record_sync(self, waits, barrier)
        if waits:
            # The queue's ordering rules still apply to the marker itself
            # (in-order: chained after the previous command; out-of-order:
            # after the latest barrier).
            deps = waits + self._implicit_deps()
        else:
            # Events before the finish()/drain() watermark are already
            # realized and contribute nothing.
            deps = tuple(e for e in self._events[self._drained:]
                         if not e.released)
        ev = Event(_MARKER, (), None, None, deps=deps)
        self._events.append(ev)
        if self._tracer is not None:
            self._trace_event(ev)
        if barrier:
            self._barrier = ev
        return ev

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

    def flush(self) -> None:
        """clFlush: a no-op.  Every enqueue has already queued its kernel on
        the CUDA stream by the time it returns, so there is nothing left to
        submit."""

    def finish(self) -> None:
        """Block until every enqueued kernel completed (clFinish).

        Only events enqueued since the last ``finish()`` are waited (a
        drained-watermark: repeated drains on a long-lived queue stay O(new
        work), not O(full history)).  On an unprofiled queue the drained
        events are then released outright; with ``max_events`` set, the
        retained history is trimmed to the window (oldest first)."""
        for ev in self._events[self._drained:]:
            if not ev.released:            # user-released mid-history: the
                ev.wait()                  # outputs are gone, nothing to wait
        self._drained = len(self._events)
        if not self.profile:
            self.release_events()
        elif (self.max_events is not None
              and len(self._events) > self.max_events):
            self.release_events(upto=len(self._events) - self.max_events)

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
                self._released_modeled_s = _sum_step(
                    self._released_modeled_s, ev.modeled.total_s)
            if ev.energy_j is not None:
                self._released_energy_j = _sum_step(
                    self._released_energy_j, ev.energy_j)
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
        # accounted via the running totals, whose compensated sum the
        # retained events continue.
        acc = self._released_modeled_s
        for e in self._events:
            if e.modeled is not None:
                acc = _sum_step(acc, e.modeled.total_s)
        return _sum_value(acc)

    def total_energy_j(self) -> float:
        acc = self._released_energy_j
        for e in self._events:
            if e.energy_j is not None:
                acc = _sum_step(acc, e.energy_j)
        return _sum_value(acc)


@dataclasses.dataclass
class GraphNode:
    """One captured command: kernel + wiring + capture-time machine model."""

    kernel: Kernel
    call: Callable[..., Any]            # executor with params pre-bound
    in_slots: Tuple[int, ...]
    out_slots: Tuple[int, ...]
    out_avals: Tuple[torch.Tensor, ...]  # meta tensors: shape + dtype
    modeled: Optional[PhaseBreakdown]
    energy_j: Optional[float]
    n_items: int = 0                    # first input's element count (the
                                        # NDRange sizing the eager path uses)
    #: indices of earlier nodes this one depends on (dataflow slots +
    #: wait_events + the enqueueing queue's ordering rules) — the edges of
    #: the dependency DAG the critical-path model walks
    deps: Tuple[int, ...] = ()
    #: node class: "kernel", "sync" (marker/barrier), or an explicit
    #: transfer command — "write" / "read" / "copy"
    kind: str = "kernel"
    #: bytes moved over the host bus (transfer nodes only)
    nbytes: float = 0.0
    #: the WorkCounts this node was priced with at capture (resident
    #: adjustment applied; ``None`` for sync/transfer nodes)
    counts: Optional[WorkCounts] = None
    #: slots whose logical buffer this (write/copy) node's output rebinds —
    #: the destination's previous value.  Slots are single-assignment, so
    #: without this the overwrite relationship is gone after capture
    overwrites: Tuple[int, ...] = ()

    @property
    def is_transfer(self) -> bool:
        return self.kind in ("write", "read", "copy")


class CommandGraph:
    """A captured command DAG, replayed in order on launch.

    Built by :meth:`CommandQueue.capture`.  While capturing, every command
    appends a :class:`GraphNode`: inputs are resolved to *slots* — either
    graph-external buffers (concrete data seen during capture) or earlier
    nodes' outputs — and output shapes come from the executor run on
    ``meta`` tensors, so nothing executes.  Each node also records its
    dependency edges: dataflow (consuming an earlier node's output slot),
    explicit ``wait_events``, and the enqueueing queue's ordering rules
    (implicit chaining on in-order queues, barrier points on out-of-order
    ones).  Markers and barriers are recorded as zero-cost, output-less
    nodes, so OpenCL's transitive ordering falls out of the DAG structure.
    :meth:`join` records commands from *additional* queues (e.g. the
    host's) into the same capture.

    :meth:`launch` replays all nodes; the graph's outputs are the trailing
    read nodes' outputs, or else the last node with outputs.  Launches bind
    to the *caller's* queue (``launch(..., queue=...)``): events and modeled
    totals land on the queue that launched, not the one that captured.

    Per-node ``modeled`` / ``energy_j`` come from the captured schedule
    (``WorkCounts`` at capture time) on the enqueueing queue's device,
    giving the same per-stage Fig-3/Fig-4 accounting as eager dispatch;
    :meth:`fused_modeled` walks the dependency DAG's critical path, so
    concurrent branches overlap instead of summing.
    """

    def __init__(self, queue: CommandQueue):
        self.queue = queue                     # home queue: default binding
        self.queues: List[CommandQueue] = [queue]
        self.nodes: List[GraphNode] = []
        self._n_slots = 0
        self._ext_slots: List[int] = []        # slot index of each external
        self._ext_values: List[torch.Tensor] = []  # captured concrete externals
        self._ext_avals: List[torch.Tensor] = []   # their meta stand-ins
        self._buf_slot: Dict[int, int] = {}    # id(Buffer) -> slot
        self._bufs_alive: List[Buffer] = []    # keep ids stable during capture
        self._slot_producer: Dict[int, int] = {}   # slot -> producing node
        self._slot_readers: Dict[int, List[int]] = {}  # slot -> consumer nodes
        self._queue_nodes: Dict[int, List[int]] = {}   # id(queue) -> nodes
        self._last_node: Dict[int, int] = {}   # id(queue) -> last node idx
        self._barrier_node: Dict[int, int] = {}  # out-of-order barrier point
        self._sealed = False
        self._fused_memo: Optional[Tuple[Optional[PhaseBreakdown], float]] = None
        #: slot -> CL_MEM-style access flags of the buffer behind it, so
        #: the sanitizer can re-check flag discipline after capture
        self._slot_flags: Dict[int, str] = {}
        #: verify() results per donation tuple (a pure function of the
        #: sealed capture)
        self._verify_memo: Dict[Tuple[int, ...], Tuple[Any, ...]] = {}
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
        for q in self.queues:                  # joined queues too
            if q._capture is self:
                q._capture = None
        # Only a capture body that completed cleanly yields a launchable
        # graph; an exception mid-capture leaves a truncated chain.
        self._sealed = exc_type is None
        # REPRO_VERIFY=1 (repro_torch.analyze): sanitize every capture at
        # seal time, so a whole test or bench run doubles as a sweep.
        if (self._sealed and self.nodes
                and os.environ.get("REPRO_VERIFY") == "1"):
            findings = self.verify()
            if findings:
                from ..analyze.graph import GraphVerifyError
                raise GraphVerifyError(findings)

    def join(self, queue: CommandQueue) -> "_GraphJoin":
        """Record commands on another queue into this capture.

        Use as a context manager *inside* the capture block to build a
        multi-queue graph (host + e-GPU nodes in one capture)::

            with egpu_q.capture() as graph:
                pre = egpu_q.enqueue_nd_range(k_pre, ndr, (a,))
                with graph.join(host_q):
                    post = host_q.enqueue_nd_range(k_post, ndr_h, pre.outputs,
                                                   wait_events=[pre])

        Each node is costed with its *own* queue's device model (the host
        node above uses the scalar-host machine model), and cross-queue
        ``wait_events`` become ordinary DAG edges.
        """
        return _GraphJoin(self, queue)

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
            self._slot_flags[slot] = buf.flags
        return slot

    def _new_slot(self) -> int:
        s = self._n_slots
        self._n_slots += 1
        return s

    def _dep_nodes_of(self, ev: Event) -> frozenset:
        """Node indices an event stands for (capture-time events only)."""
        if ev._graph is not self:
            raise RuntimeError(
                "wait_events during capture must be events returned by this "
                "capture (eager or foreign-graph events have no node "
                "identity here)")
        return ev._dep_nodes

    def _node_event(self, kernel: Kernel, outs: Tuple[Buffer, ...],
                    modeled: Optional[PhaseBreakdown],
                    energy: Optional[float], idx: int) -> Event:
        """The capture-time event standing for node ``idx``."""
        ev = Event(kernel, outs, modeled, energy)
        ev._graph = self
        ev._dep_nodes = frozenset((idx,))
        return ev

    def _record(self, queue: CommandQueue, kernel: Kernel, ndr: NDRange,
                args: Sequence[Buffer], params: Dict[str, Any],
                counts_params: Dict[str, Any], resident: bool,
                wait_events: Tuple[Event, ...] = ()) -> Event:
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
        # Cost the node on the ENQUEUEING queue's device: a multi-queue
        # capture mixes host and e-GPU nodes, each with its own model.
        modeled, energy, counts = queue._model(kernel, ndr, counts_params,
                                               resident)

        # Dependency edges: dataflow + wait_events + queue ordering.
        deps = set()
        for s in in_slots:
            producer = self._slot_producer.get(s)
            if producer is not None:
                deps.add(producer)
        for ev in wait_events:
            deps.update(self._dep_nodes_of(ev))
        deps.update(self._queue_order_deps(queue))
        idx = self._append_node(
            queue, GraphNode(kernel, call, in_slots, out_slots, out_avals,
                             modeled, energy,
                             n_items=int(args[0].data.numel()) if args else 0,
                             deps=tuple(sorted(deps)), counts=counts))
        for s in in_slots:
            self._slot_readers.setdefault(s, []).append(idx)
        for s in out_slots:
            self._slot_producer[s] = idx
            self._slot_flags[s] = "rw"          # kernel outputs: fresh rw slots
        outs = tuple(GraphBuffer(a, s) for a, s in zip(out_avals, out_slots))
        for b in outs:
            self._buf_slot[id(b)] = b.slot
            self._bufs_alive.append(b)
        return self._node_event(kernel, outs, modeled, energy, idx)

    def _queue_order_deps(self, queue: CommandQueue) -> Tuple[int, ...]:
        """The enqueueing queue's implicit ordering edge for the next node:
        its previous command (in-order) or its latest barrier node
        (out-of-order).  One edge — earlier constraints flow transitively
        through the chain / barrier nodes."""
        qid = id(queue)
        if not queue.out_of_order:
            last = self._last_node.get(qid)
            return () if last is None else (last,)
        bar = self._barrier_node.get(qid)
        return () if bar is None else (bar,)

    def _append_node(self, queue: CommandQueue, node: GraphNode) -> int:
        qid = id(queue)
        idx = len(self.nodes)
        self.nodes.append(node)
        self._queue_nodes.setdefault(qid, []).append(idx)
        self._last_node[qid] = idx
        return idx

    def _record_sync(self, queue: CommandQueue,
                     wait_events: Optional[Tuple[Event, ...]],
                     barrier: bool) -> Event:
        """Capture-time marker/barrier: a zero-cost :class:`GraphNode`.

        Recording sync commands as real (modeled-``None``, output-less)
        nodes makes OpenCL's transitivity structural: a later marker's
        default wait list ("all previously enqueued commands") includes
        earlier sync nodes and hence — through *their* edges — cross-queue
        dependencies; a new barrier chains to the previous barrier node, so
        every earlier barrier's constraint keeps reaching later launches
        with O(1) edges per node.  The critical-path model treats them as
        zero-cost pass-throughs."""
        qid = id(queue)
        deps = set(self._queue_order_deps(queue))
        if not wait_events:
            # None or empty: all commands enqueued on this queue so far
            # (sync nodes included — that's what carries transitivity).
            deps.update(self._queue_nodes.get(qid, ()))
        else:
            # _queue_order_deps already chained this command after the
            # queue's latest barrier (out-of-order) or predecessor
            # (in-order), so an earlier barrier's constraint persists
            # alongside the explicit list.
            for e in wait_events:
                deps.update(self._dep_nodes_of(e))
        idx = self._append_node(
            queue, GraphNode(_MARKER, lambda: (), (), (), (), None, None,
                             deps=tuple(sorted(deps)), kind="sync"))
        if barrier:
            self._barrier_node[qid] = idx
        return self._node_event(_MARKER, (), None, None, idx)

    def _record_transfer(self, queue: CommandQueue, kind: str, buf: Buffer,
                         src: Any, wait_events: Tuple[Event, ...]) -> Event:
        """Capture an explicit transfer command as a real :class:`GraphNode`.

        The node's ``call`` is identity (under unified memory the data never
        moves), but it carries the transfer-only machine model and full
        dependency edges, so ``fused_modeled()``'s critical path prices the
        traffic and can overlap it with compute on independent branches.

        Slot wiring per command:

        * ``write``: the host source becomes an input slot (an *external*
          when it is fresh data, moved onto the queue's device first, so a
          launch never mixes devices); the destination buffer is
          **rebound** to the node's output slot, so later consumers of
          ``buf`` depend on the write.  The old binding (if any)
          contributes write-after-read/write ordering edges.
        * ``read``: consumes the buffer's current slot, produces a fresh
          slot holding the host copy; the buffer keeps its binding.
        * ``copy``: consumes the source's slot, rebinds the destination.
        """
        if kind == "write":
            src_buf = (src if isinstance(src, Buffer)
                       else queue.ctx.create_buffer(src))
            CommandQueue._check_aval_match("enqueue_write_buffer",
                                           src_buf.data, buf)
            in_buf, rebind, sentinel = src_buf, buf, _WRITE
        elif kind == "read":
            in_buf, rebind, sentinel = buf, None, _READ
        else:
            in_buf, rebind, sentinel = src, buf, _COPY
        in_slot = self._slot_of(in_buf)
        aval = _meta_like(in_buf.data)
        nbytes = float(aval.numel() * aval.element_size())
        modeled, energy = queue._model_transfer(nbytes)

        deps = set()
        overwrites: Tuple[int, ...] = ()
        producer = self._slot_producer.get(in_slot)
        if producer is not None:
            deps.add(producer)
        if rebind is not None:
            # write-after-write on the destination's old producer, plus
            # write-after-read on every node that consumed the old value —
            # an overwrite must not model as concurrent with readers of the
            # value it replaces
            prev_slot = self._buf_slot.get(id(rebind))
            if prev_slot is not None:
                prev_producer = self._slot_producer.get(prev_slot)
                if prev_producer is not None:
                    deps.add(prev_producer)
                deps.update(self._slot_readers.get(prev_slot, ()))
                overwrites = (prev_slot,)
        for ev in wait_events:
            deps.update(self._dep_nodes_of(ev))
        deps.update(self._queue_order_deps(queue))

        out_slot = self._new_slot()
        idx = self._append_node(
            queue, GraphNode(sentinel, lambda x: (x,), (in_slot,),
                             (out_slot,), (aval,), modeled, energy,
                             n_items=int(aval.numel()),
                             deps=tuple(sorted(deps)), kind=kind,
                             nbytes=nbytes, overwrites=overwrites))
        self._slot_readers.setdefault(in_slot, []).append(idx)
        self._slot_producer[out_slot] = idx
        self._slot_flags[out_slot] = buf.flags
        if rebind is not None:
            self._buf_slot[id(rebind)] = out_slot
            self._bufs_alive.append(rebind)
        out = GraphBuffer(aval, out_slot, flags=buf.flags)
        self._buf_slot[id(out)] = out_slot
        self._bufs_alive.append(out)
        return self._node_event(sentinel, (out,), modeled, energy, idx)

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

    def verify(self, donate: Sequence[int] = ()) -> Tuple[Any, ...]:
        """Statically sanitize the captured DAG (see
        :mod:`repro_torch.analyze`).

        Returns the :class:`~repro_torch.analyze.graph.Finding` tuple —
        empty for a hazard-free capture.  ``donate`` lists donated
        external-input positions (capture order), enabling the
        use-after-donate / double-donation checks.  Results are memoized
        per donation tuple, so a serving path re-verifying before every
        donating launch pays one dict lookup.
        """
        key = tuple(sorted(int(i) for i in donate))
        memo = self._verify_memo.get(key)
        if memo is None:
            from ..analyze.graph import verify_graph
            memo = verify_graph(self, donate=key)
            self._verify_memo[key] = memo
        return memo

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
        """The slots a launch returns.

        Trailing ``read_buffer`` nodes define the outputs (a capture ending
        in explicit reads returns the read-back values, one per read, in
        enqueue order — markers/barriers in between are ignored); otherwise
        the last node with outputs, so a trailing marker/barrier never eats
        them.
        """
        reads: List[GraphNode] = []
        for node in reversed(self.nodes):
            if node.kind == "read":
                reads.append(node)
            elif node.out_slots:
                break
        if reads:
            return tuple(s for n in reversed(reads) for s in n.out_slots)
        return next(n.out_slots for n in reversed(self.nodes) if n.out_slots)

    def launch(self, *inputs: Any, donate: Sequence[int] = (),
               queue_events: bool = True,
               queue: Optional[CommandQueue] = None) -> Tuple[Buffer, ...]:
        """Replay the captured DAG (non-blocking on a CUDA device).

        ``inputs`` replace the graph's external buffers in capture order
        (shapes, dtypes and devices must match); with no inputs the tensors
        captured at record time are reused.  The nodes run in capture order
        on the current stream.  Returns the graph's outputs (the trailing
        reads' values, else the last node with outputs) as fresh buffers.

        ``donate`` lists external-input positions the caller hands over to
        the launch: each is verified (under ``REPRO_VERIFY=1``, the
        donation-aware sanitizer sweep, memoized) and every donated input
        passed as a :class:`Buffer` is marked consumed — reading it or
        passing it to a later command raises.  Kernels still write fresh
        outputs; donation never changes a result.

        **Launch-time queue binding**: per-node modeled events are appended
        to ``queue`` — the *caller's* queue — defaulting to the capture
        queue for one-shot use; ``queue_events=False`` books none.  The
        first node's event carries the replay's host seconds as its
        ``dispatch_s``.
        """
        if any(q._capture is self for q in self.queues):
            raise RuntimeError("cannot launch while still capturing")
        if not self._sealed:
            raise RuntimeError(
                "capture did not complete cleanly; re-capture the chain "
                "before launching")
        if not any(n.out_slots for n in self.nodes):
            raise RuntimeError(
                "cannot launch an empty CommandGraph (no kernel nodes)")
        if donate and not inputs:
            # Donating the graph's own captured tensors would consume what
            # every later zero-argument launch still needs.
            raise ValueError(
                "donate requires explicit launch inputs: the captured "
                "external tensors must stay valid for later launches")
        ext = list(inputs) if inputs else list(self._ext_values)
        if len(ext) != len(self._ext_slots):
            raise ValueError(
                f"graph takes {len(self._ext_slots)} external inputs, "
                f"got {len(ext)}")
        donate_key = tuple(sorted(int(i) for i in donate))
        if any(not 0 <= i < len(ext) for i in donate_key):
            raise ValueError(
                f"donate positions {donate_key} out of range for "
                f"{len(ext)} external inputs")
        for i, x in enumerate(ext):
            if isinstance(x, Buffer):
                x._check_live(f"launch input {i}")
        if donate_key and os.environ.get("REPRO_VERIFY") == "1":
            # donation-aware sweep (memoized): a reader of a donated slot
            # off the ordered path would observe storage handed back
            findings = self.verify(donate=donate_key)
            if findings:
                from ..analyze.graph import GraphVerifyError
                raise GraphVerifyError(findings)
        donated = [ext[i] for i in donate_key if isinstance(ext[i], Buffer)]
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
        t0 = time.perf_counter()
        for node in self.nodes:
            outs = node.call(*[vals[s] for s in node.in_slots])
            for slot, o in zip(node.out_slots, outs):
                vals[slot] = o
        dispatch = time.perf_counter() - t0
        outs = tuple(Buffer(vals[s]) for s in self._output_slots())
        for b in donated:
            b.consumed = True
        if queue_events:
            done = _record_done(outs)
            target = queue if queue is not None else self.queue
            slot_buf = dict(zip(self._output_slots(), outs))
            for i, node in enumerate(self.nodes):
                node_outs = tuple(slot_buf[s] for s in node.out_slots
                                  if s in slot_buf)
                ev = Event(node.kernel, node_outs, node.modeled,
                           node.energy_j, dispatch if i == 0 else 0.0,
                           device_done=done)
                target._events.append(ev)
                if target._tracer is not None:
                    target._trace_event(ev)
                for b in node_outs:      # dataflow edge for later eager
                    b._event = ev        # consumers, same as enqueue
        return outs

    def launch_prefix(self, inputs: Sequence[Any],
                      **launch_kwargs: Any) -> Tuple[Buffer, ...]:
        """Launch with only the first ``len(inputs)`` externals replaced.

        The remaining externals keep the tensors captured at record time —
        for a pipeline graph these are the per-stage constant buffers
        (weights, coefficients), so a serving layer can feed fresh request
        data without re-threading the pipeline's parameters (this is the
        entry point ``repro_torch.serve.GraphCache`` users launch through).
        ``launch_kwargs`` go to :meth:`launch` (``queue=``, ``donate=``,
        ``queue_events=``); only caller-supplied positions may be donated.
        """
        inputs = list(inputs)
        if len(inputs) > len(self._ext_values):
            raise ValueError(
                f"launch_prefix got {len(inputs)} inputs but the graph has "
                f"only {len(self._ext_values)} externals")
        donate = launch_kwargs.get("donate", ())
        if any(int(i) >= len(inputs) for i in donate):
            # Positions beyond the replaced prefix are filled from the
            # graph's own captured tensors — donating one would consume a
            # buffer every later launch still needs.
            raise ValueError(
                "launch_prefix can only donate caller-supplied positions "
                f"(< {len(inputs)}); the rest are captured externals")
        return self.launch(*inputs, *self._ext_values[len(inputs):],
                           **launch_kwargs)


class _GraphJoin:
    """Context manager adding a second queue to an active capture."""

    def __init__(self, graph: CommandGraph, queue: CommandQueue):
        self._graph = graph
        self._queue = queue
        self._attached = False

    def __enter__(self) -> CommandGraph:
        graph, queue = self._graph, self._queue
        if graph.queue._capture is not graph:
            raise RuntimeError("join() is only valid inside an active capture")
        if queue._capture is not None and queue._capture is not graph:
            raise RuntimeError("queue is already capturing another graph")
        # Only detach on exit what THIS join attached: joining a queue that
        # is already capturing the graph (the capture's own queue, or a
        # nested join) must not end its capture when the inner block closes.
        self._attached = queue._capture is None
        queue._capture = graph
        if all(q is not queue for q in graph.queues):
            graph.queues.append(queue)
        return graph

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._attached and self._queue._capture is self._graph:
            self._queue._capture = None


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

    def _holds(self, t: torch.Tensor) -> bool:
        """Whether tensor ``t`` already lives on this context's device."""
        dev = self.torch_device
        if t.device.type != dev.type:
            return False
        if dev.type != "cuda":
            return True
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        return t.device.index == index

    def create_buffer(self, data: Any, flags: str = "rw",
                      copy: Optional[bool] = None,
                      use_host_ptr: bool = False) -> Buffer:
        """clCreateBuffer analogue.

        ``copy=None`` (default) picks the cheap path per input: a tensor
        already on this context's torch device is adopted as-is (it already
        lives in the unified memory); anything else (a numpy array, a Python
        scalar, a tensor elsewhere) is copied onto the device.  ``copy=True``
        forces a fresh tensor (CL_MEM_COPY_HOST_PTR), even from one already
        on the device; ``copy=False`` requires a tensor on the context's
        device and guarantees adoption.  ``use_host_ptr=True`` is the
        CL_MEM_USE_HOST_PTR analogue: the buffer *aliases* the caller's
        tensor (the same object, the same ``data_ptr()``); it implies
        ``copy=False``.

        The one difference from the JAX package: there every ``jax.Array``
        lies in the one unified memory and can be adopted; here a tensor on
        another device (a CPU tensor for a card context) has storage the
        context cannot alias, so ``copy=False`` / ``use_host_ptr=True``
        raise ``TypeError`` for it as they do for a numpy array.
        """
        if use_host_ptr:
            if copy:
                raise ValueError("use_host_ptr=True is incompatible with "
                                 "copy=True (CL_MEM_USE_HOST_PTR aliases "
                                 "the host tensor)")
            copy = False
        on_device = isinstance(data, torch.Tensor) and self._holds(data)
        if copy is None:
            copy = not on_device
        if not copy:
            if not on_device:
                what = (f"a tensor on {data.device}"
                        if isinstance(data, torch.Tensor)
                        else type(data).__name__)
                if use_host_ptr:
                    raise TypeError(
                        f"use_host_ptr requires a torch.Tensor on "
                        f"{self.torch_device}, got {what}")
                raise TypeError(
                    f"copy=False requires a torch.Tensor on "
                    f"{self.torch_device}, got {what} (TinyCL cannot adopt "
                    "foreign storage without a copy)")
            return Buffer(data, flags)
        if isinstance(data, torch.Tensor):
            return Buffer(data.to(self.torch_device, copy=True), flags)
        # torch.tensor copies (torch.as_tensor would alias a numpy array's
        # memory on the CPU, so a later host edit would reach the buffer)
        return Buffer(torch.tensor(data, device=self.torch_device), flags)
