"""Sharded serving — one dispatcher lane spanning a device mesh.

The JAX package's ``serve/sharded.py``.  The paper scales the e-GPU by
replicating compute units behind one Tiny-OpenCL scheduler (§IV, §VI); the
serving analogue is a :class:`ShardedWorker` that owns a mesh *slice*
(:class:`~repro_torch.distributed.sharding.LocalMesh`: positions over local
devices, a device may stand at several) instead of one device.  It is a
drop-in :class:`~repro_torch.serve.dispatch.QueueWorker`: the
:class:`~repro_torch.serve.dispatch.MultiQueueDispatcher` routes
micro-batches across a mix of plain and sharded lanes, and every launch of a
cached :class:`~repro_torch.core.runtime.CommandGraph` is split by specs
derived from the :mod:`repro_torch.distributed.sharding` rule table:

* the micro-batch leading axis (logical ``"batch"``) spans the mesh's
  data-parallel axes — under the default :data:`SERVE_RULES` that is
  ``("pod", "data")``, pruned to the axes the worker's mesh has;
* per-stage constant externals (weights) are replicated unless the worker
  is built with ``const_axes=`` naming their logical axes; such a constant
  is stored split over its axes, a block on each position, and gathered
  whole on the launching position before each launch, so the results stay
  those of the whole constant;
* the divisibility fallback is preserved end to end: a batch capacity not
  divisible by its mesh-axis product drops trailing axes and replicates if
  nothing divides; a replicated launch runs once, on the mesh's first
  position, and reports ``shards == 1``.

How a launch runs.  The JAX lane binds one cached graph to
``in_shardings`` and lets GSPMD split it.  Here each shard is a launch of
its own: the lane derives from the cached graph one graph per (shard
extent, mesh position) with :meth:`CommandGraph.rebind` (memoized weakly
per cached graph, never a ``GraphCache`` miss), launches shard k's rows on
its position's device, on that position's own stream, and concatenates the
rows in shard order on the lane's device.  The launch books one event per
captured node on the lane's queue, as a plain launch does.  On the card the
kernels are reached through their custom ops, once a shard.

Contracts:

* **honest accounting** — a launch that splits the batch ``shards`` ways
  splits the chain's transfer + compute across the shards while startup +
  scheduling are still paid on every slice: :func:`shard_breakdown` of the
  full-batch graph's ``fused_modeled()``, as in the JAX package;
* **bit-identical results** — kernels are pure and batch rows independent,
  so a data-parallel split cannot change functional outputs.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import EGPUConfig
from ..core.machine import PhaseBreakdown
from ..core.runtime import Buffer, CommandGraph, resolve_device
from ..distributed.sharding import (LocalMesh, PartitionSpec, SERVE_RULES,
                                    ShardingRules, mesh_axes, shard_slices,
                                    spec_for)
from ..obs import Tracer
from .batching import MicroBatch
from .dispatch import QueueStats, QueueWorker
from .faults import FaultPlan, apply_spike

P = PartitionSpec

#: logical-axis name of the micro-batch leading dimension
BATCH_AXIS = "batch"


def data_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device: Any = "cuda") -> LocalMesh:
    """A 1-D data-parallel mesh: on the card, over the first ``n_devices``
    local CUDA devices (all of them by default; raises without a card); with
    ``device="cpu"``, ``n_devices`` positions (default 1) of the host's one
    device, as JAX's forced host device count gives."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            if not 1 <= n_devices <= len(devices):
                raise ValueError(f"n_devices must be in 1..{len(devices)}, "
                                 f"got {n_devices}")
            devices = devices[:n_devices]
    else:
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        devices = [dev] * n
    return LocalMesh(devices, (axis,))


def mesh_signature(mesh: LocalMesh) -> Tuple[Any, ...]:
    """Hashable identity of a mesh: axis layout + the concrete devices."""
    return (tuple(mesh.axis_names), tuple(mesh.devices.shape),
            tuple(str(d) for d in mesh.devices.flat))


def shard_breakdown(fused: PhaseBreakdown, shards: int) -> PhaseBreakdown:
    """The fused chain's modeled breakdown under ``shards``-way data
    parallelism: transfer + compute split across the shards (each mesh
    slice runs ``1/shards`` of the batch), startup + scheduling paid in
    full (every slice dispatches its shard of the chain concurrently)."""
    if shards <= 1:
        return fused
    return dataclasses.replace(
        fused, transfer=fused.transfer / shards,
        compute=fused.compute / shards)


@dataclasses.dataclass
class _ShardPlan:
    """What a cached graph launches as on this lane (memoized per graph)."""

    in_specs: Tuple[PartitionSpec, ...]
    out_specs: Tuple[PartitionSpec, ...]
    shards: int
    axis_factor: Dict[str, int]
    #: one (row slice, mesh position, derived graph) per shard, rows in order
    launches: List[Tuple[slice, Tuple[int, ...], CommandGraph]]
    #: per constant external: ({position: its block}, the blocks' slices
    #: (an object array over the mesh), the whole shape), or None when
    #: replicated
    const_parts: List[Optional[Tuple[Dict[Tuple[int, ...], torch.Tensor],
                                     Any, Tuple[int, ...]]]]
    #: per constant external: {device: the whole constant on it}
    const_whole: List[Dict[torch.device, torch.Tensor]]


class ShardedWorker(QueueWorker):
    """One serving lane spanning a device-mesh slice.

    ``mesh`` is the worker's slice of the device fleet (a
    :class:`~repro_torch.distributed.sharding.LocalMesh`, e.g.
    :func:`data_mesh`); ``rules`` the logical-axis table used to derive the
    split (default :data:`SERVE_RULES`).  ``const_axes`` optionally names the
    logical axes of each *constant* external (a tuple per constant, in
    capture order); constants without an entry are replicated.  The lane
    runs on the mesh's first position's device.  Everything else —
    backpressure, event-segment retirement, per-queue accounting — is
    inherited from :class:`QueueWorker`.
    """

    def __init__(self, config: EGPUConfig, mesh: LocalMesh,
                 name: Optional[str] = None, max_in_flight: int = 2,
                 explicit_transfers: bool = True,
                 rules: ShardingRules = SERVE_RULES,
                 const_axes: Optional[Sequence[Optional[Sequence[
                     Optional[str]]]]] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 tracer: Optional[Tracer] = None):
        if not isinstance(mesh, LocalMesh):
            raise TypeError(f"mesh must be a repro_torch LocalMesh, got "
                            f"{type(mesh).__name__}")
        if mesh.devices.size < 1:
            raise ValueError("mesh must hold at least one device")
        self.mesh = mesh
        self.rules = rules
        self.const_axes = (None if const_axes is None else
                           tuple(None if a is None else tuple(a)
                                 for a in const_axes))
        super().__init__(config, name=name, max_in_flight=max_in_flight,
                         explicit_transfers=explicit_transfers,
                         fault_plan=fault_plan, clock=clock, tracer=tracer,
                         device=mesh.devices.flat[0])
        # Cache identity: sharded captures must never collide with plain
        # single-device ones (or with a different mesh / rule table) in a
        # shared GraphCache.
        self.apu.placement = ("sharded", mesh_signature(mesh), rules.name,
                              self.const_axes)
        #: per-graph launch plans, keyed weakly so evicted cache entries do
        #: not pin their derived graphs and constant blocks here
        self._shard_memo: "weakref.WeakKeyDictionary[CommandGraph, _ShardPlan]" = (
            weakref.WeakKeyDictionary())
        #: one side stream per CUDA mesh position
        self._streams: Dict[Tuple[int, ...], Any] = {}
        # per-axis utilization accumulators (sum of per-launch fractions)
        self._axis_util_sum: Dict[str, float] = {
            str(a): 0.0 for a in mesh.axis_names}
        self._util_launches = 0

    # -- sharding derivation -------------------------------------------------
    @property
    def n_devices(self) -> int:
        return int(self.mesh.devices.size)

    def _axis_sizes(self) -> Dict[str, int]:
        return dict(mesh_axes(self.mesh))

    def _spec_factor(self, spec: PartitionSpec) -> Dict[str, int]:
        """Per-mesh-axis split factor a PartitionSpec applies."""
        sizes = self._axis_sizes()
        used: Dict[str, int] = {}
        for entry in spec:
            if entry is None:
                continue
            for a in ((entry,) if isinstance(entry, str) else entry):
                used[str(a)] = sizes.get(str(a), 1)
        return used

    def _batch_spec(self, shape: Tuple[int, ...]) -> PartitionSpec:
        """PartitionSpec for a batch-leading tensor (micro-batch inputs and
        outputs): logical ``"batch"`` on dim 0, with the rule table's
        divisibility fallback against the actual extent."""
        logical = (BATCH_AXIS,) + (None,) * (len(shape) - 1)
        return spec_for(logical, self.rules, self.mesh, tuple(shape))

    def _plan(self, graph: CommandGraph) -> _ShardPlan:
        """The launch plan of ``graph`` on this lane, derived once per graph
        (memoized weakly): request externals (the leading
        ``graph.n_request_inputs``) and every output span the data axes on
        their batch dim, constant externals follow ``const_axes`` or
        replicate.  ``shards`` is the split factor actually applied to the
        batch axis — 1 when the divisibility fallback replicated it;
        ``axis_factor`` the best split any tensor of the launch achieved per
        mesh axis (so a model-parallel constant registers on its axis)."""
        plan = self._shard_memo.get(graph)
        if plan is not None:
            return plan
        avals = graph.ext_avals
        n_req = getattr(graph, "n_request_inputs", len(avals)) or len(avals)
        specs = []
        for i, aval in enumerate(avals):
            if i < n_req:
                spec = self._batch_spec(aval.shape)
            else:
                logical = None
                if self.const_axes is not None:
                    j = i - n_req
                    logical = (self.const_axes[j]
                               if j < len(self.const_axes) else None)
                spec = (spec_for(tuple(logical), self.rules, self.mesh,
                                 tuple(aval.shape))
                        if logical is not None else P())
            specs.append(spec)
        out_specs = [self._batch_spec(aval.shape) for aval in graph.out_avals]
        batch_factor = self._spec_factor(
            specs[0] if n_req else (out_specs[0] if out_specs else P()))
        shards = 1
        for f in batch_factor.values():
            shards *= f
        axis_factor: Dict[str, int] = {}
        for spec in list(specs) + out_specs:
            for a, f in self._spec_factor(spec).items():
                axis_factor[a] = max(axis_factor.get(a, 1), f)

        captured = graph._ext_values
        # constants: a block per position when tagged, else whole on every
        # position's device
        const_parts: List[Any] = []
        const_whole: List[Dict[torch.device, torch.Tensor]] = []
        for i in range(n_req, len(avals)):
            c = captured[i]
            if specs[i] == P():
                const_parts.append(None)
                const_whole.append({d: c.to(d) for d in
                                    set(self.mesh.devices.flat)})
                continue
            blocks = shard_slices(specs[i], self.mesh, tuple(c.shape))
            parts = {pos: c[blocks[pos]].to(self.mesh.devices[pos]).clone()
                     for pos in _positions(self.mesh)}
            const_parts.append((parts, blocks, tuple(c.shape)))
            const_whole.append({})
        # one launch per distinct block of the batch rows, at the first
        # position (mesh order) that holds it
        ext0 = tuple(avals[0].shape) if n_req else ()
        rows_of = (shard_slices(specs[0], self.mesh, ext0) if n_req else None)
        launches = []
        seen = set()
        for pos in _positions(self.mesh):
            rows = rows_of[pos][0] if n_req else slice(None)
            key = (rows.start, rows.stop)
            if key in seen:
                continue
            seen.add(key)
            dev = self.mesh.devices[pos]
            stand_ins = []
            for i, aval in enumerate(avals):
                shape = tuple(aval.shape)
                if i < n_req:
                    shape = (rows.stop - rows.start,) + shape[1:]
                stand_ins.append(torch.zeros((), dtype=aval.dtype,
                                             device=dev).expand(shape))
            launches.append((rows, pos, graph.rebind(stand_ins)))
        launches.sort(key=lambda t: t[0].start or 0)
        plan = _ShardPlan(tuple(specs), tuple(out_specs), max(1, shards),
                          axis_factor, launches, const_parts, const_whole)
        self._shard_memo[graph] = plan
        return plan

    def shardings_for(self, graph: CommandGraph) -> Tuple[
            Tuple[PartitionSpec, ...], Tuple[PartitionSpec, ...], int,
            Dict[str, int]]:
        """(input specs, output specs, batch shard count, axis factors) for
        ``graph`` — the JAX package's ``shardings_for`` with PartitionSpecs
        in place of ``NamedSharding``\\ s."""
        plan = self._plan(graph)
        return plan.in_specs, plan.out_specs, plan.shards, plan.axis_factor

    def _constants(self, plan: _ShardPlan, dev: torch.device
                   ) -> List[torch.Tensor]:
        """Every constant external whole on ``dev``: a replicated one as
        stored there, a split one gathered from its blocks."""
        out = []
        for parts, whole in zip(plan.const_parts, plan.const_whole):
            if parts is None:
                out.append(whole[dev])
                continue
            blocks, slices, shape = parts
            first = next(iter(blocks.values()))
            buf = torch.empty(shape, dtype=first.dtype, device=dev)
            for pos, block in blocks.items():
                buf[slices[pos]] = block.to(dev)
            out.append(buf)
        return out

    # -- power pricing -------------------------------------------------------
    def estimate(self, graph: CommandGraph
                 ) -> Tuple[Optional[PhaseBreakdown], float]:
        """The dispatcher's pricing view of a launch on this mesh lane: the
        shard-scaled breakdown :meth:`_do_launch` would book (energy stays
        total — the same ops run, just spread over more devices)."""
        fused, energy = graph.fused_modeled()
        if fused is not None:
            fused = shard_breakdown(fused, self._plan(graph).shards)
        return fused, energy

    # -- launch --------------------------------------------------------------
    def _stream(self, pos: Tuple[int, ...], dev: torch.device):
        s = self._streams.get(pos)
        if s is None:
            s = self._streams[pos] = torch.cuda.Stream(device=dev)
        return s

    def _run_shards(self, plan: _ShardPlan, inputs: Sequence[Any]
                    ) -> Tuple[torch.Tensor, ...]:
        """Launch every shard on its position and return the outputs with
        the rows in order, on the lane's device."""
        home = self.device
        xs = [x.data if isinstance(x, Buffer) else x for x in inputs]
        per_shard = []
        side = []
        for rows, pos, g in plan.launches:
            dev = self.mesh.devices[pos]
            if dev.type == "cuda":
                s = self._stream(pos, dev)
                s.wait_stream(torch.cuda.current_stream(home))
                s.wait_stream(torch.cuda.current_stream(dev))
                for x in xs:
                    x.record_stream(s)
                with torch.cuda.stream(s):
                    args = [x[rows].to(dev) for x in xs]
                    consts = self._constants(plan, dev)
                    for c in consts:
                        c.record_stream(s)
                    outs = g.launch(*args, *consts, queue_events=False)
                side.append(s)
            else:
                args = [x[rows].to(dev) for x in xs]
                outs = g.launch(*args, *self._constants(plan, dev),
                                queue_events=False)
            per_shard.append(tuple(b.data for b in outs))
        if home.type == "cuda":
            cur = torch.cuda.current_stream(home)
            for s in side:
                cur.wait_stream(s)
            for outs in per_shard:
                for o in outs:
                    o.record_stream(cur)
        if len(per_shard) == 1:
            return tuple(o.to(home) for o in per_shard[0])
        return tuple(torch.cat([outs[j].to(home) for outs in per_shard])
                     for j in range(len(per_shard[0])))

    def _do_launch(self, graph: CommandGraph, batch: MicroBatch
                   ) -> Tuple[Tuple[Buffer, ...],
                              Optional[PhaseBreakdown], float]:
        # fault gate first — an injected failure fires before any real
        # sharded work, exactly like the plain-lane path
        spike_s = self._fault_gate()
        plan = self._plan(graph)
        t0 = time.perf_counter()
        outs = tuple(Buffer(o) for o in self._run_shards(plan, batch.inputs))
        graph.book_events(outs, time.perf_counter() - t0, self.queue)
        fused, energy = graph.fused_modeled()
        if fused is not None:
            # transfer + compute split across the mesh slices; startup +
            # scheduling paid once per launch on every slice concurrently.
            # Energy is total work and stays unscaled.
            fused = shard_breakdown(fused, plan.shards)
        fused = apply_spike(fused, spike_s)
        # utilization: fraction of each mesh axis this launch exploited —
        # any tensor's split counts (batch over data, consts over model);
        # fallback-to-replication reads as 1/size
        for a, size in self._axis_sizes().items():
            self._axis_util_sum[a] += plan.axis_factor.get(a, 1) / size
        self._util_launches += 1
        return outs, fused, energy

    def stats(self) -> QueueStats:
        base = super().stats()
        sizes = self._axis_sizes()
        util = tuple(
            (a, self._axis_util_sum[a] / self._util_launches)
            for a in sizes) if self._util_launches else ()
        return dataclasses.replace(
            base, shards=self.n_devices,
            mesh_axes=tuple(sizes.items()), mesh_utilization=util)


def _positions(mesh: LocalMesh) -> List[Tuple[int, ...]]:
    """Every mesh position (an index tuple), in mesh order."""
    return list(np.ndindex(mesh.devices.shape))
