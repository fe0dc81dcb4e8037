"""APU orchestration (paper §VI): host + e-GPU as one accelerated system.

``APU.offload`` runs a pipeline of kernels on the e-GPU and compares it
against the same pipeline on the scalar host — producing exactly the
speed-up / energy-reduction numbers of the paper's Fig. 4 (TinyBio) while
also returning the functional outputs, so applications get real results and
the evaluation in one call.

Two dispatch modes:

* ``mode="graph"`` (default) captures the whole stage chain into a TinyCL
  :class:`~repro_torch.core.runtime.CommandGraph` and launches it once — the
  paper's §IV-B resident pipeline, with the modeled startup and scheduling
  paid once per chain.  Kernels are pure functions of their inputs, so the
  host comparison is costed analytically from the same captured
  :class:`~repro_torch.core.machine.WorkCounts` instead of re-executing the
  chain.
* ``mode="eager"`` runs both paths kernel by kernel through in-order queues
  (so every kernel launches twice: once for the e-GPU queue, once for the
  host queue); graph and eager produce identical modeled stage reports and
  bit-identical functional outputs.

The torch device the kernels execute on is ``APU(device=...)``, ``"cuda"``
by default; the modeled e-GPU is the :class:`EGPUConfig`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .device import EGPUConfig, EGPU_16T, HOST
from .machine import PhaseBreakdown
from .runtime import Buffer, CommandGraph, CommandQueue, Context, Device, Kernel
from .scheduler import optimal_ndrange


@dataclasses.dataclass
class Stage:
    """One pipeline stage: kernel + its argument/extra-buffer wiring."""

    kernel: Kernel
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    counts_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    consts: Tuple[Any, ...] = ()       # constant tensors appended to inputs
    n_inputs: int = 0                  # 0 = take all previous outputs


@dataclasses.dataclass(frozen=True)
class StageReport:
    """Per-kernel comparison: the paper's Fig 4 bars."""

    name: str
    egpu: Optional[PhaseBreakdown]      # None when the kernel has no counts
    host: Optional[PhaseBreakdown]      # model
    egpu_energy_j: Optional[float]
    host_energy_j: Optional[float]

    @property
    def speedup(self) -> float:
        return self.host.total_s / self.egpu.total_s

    @property
    def energy_reduction(self) -> float:
        return self.host_energy_j / self.egpu_energy_j


@dataclasses.dataclass(frozen=True)
class PipelineReport:
    stages: Tuple[StageReport, ...]
    #: modeled breakdown of the fused (CommandGraph) launch — startup +
    #: scheduling paid once per chain (None for eager mode)
    egpu_fused: Optional[PhaseBreakdown] = None

    def _modeled_stages(self) -> Tuple[StageReport, ...]:
        return tuple(s for s in self.stages
                     if s.host is not None and s.egpu is not None)

    @property
    def overall_speedup(self) -> Optional[float]:
        """None when no stage carries a machine model (counts-less
        kernels) — the functional outputs still exist."""
        modeled = self._modeled_stages()
        if not modeled:
            return None
        h = sum(s.host.total_s for s in modeled)
        e = sum(s.egpu.total_s for s in modeled)
        return h / e

    @property
    def overall_energy_reduction(self) -> Optional[float]:
        modeled = self._modeled_stages()
        if not modeled:
            return None
        h = sum(s.host_energy_j for s in modeled)
        e = sum(s.egpu_energy_j for s in modeled)
        return h / e

    @property
    def fused_speedup(self) -> Optional[float]:
        """Host total vs the fused chain (per-chain dispatch accounting)."""
        if self.egpu_fused is None or not self._modeled_stages():
            return None
        h = sum(s.host.total_s for s in self._modeled_stages())
        return h / self.egpu_fused.total_s


def _kernel_nodes(graph: CommandGraph) -> list:
    """The graph's kernel nodes, one per pipeline stage, in stage order."""
    return [n for n in graph.nodes if n.kind == "kernel"]


class APU:
    """An accelerated processing unit: X-HEEP host + one e-GPU instance.

    ``config`` is the modeled e-GPU; ``device`` is the torch device every
    kernel executes on (``"cuda"`` by default, which raises when no card is
    present; ``"cpu"`` runs the kernels' plain PyTorch versions).
    ``explicit_transfers`` is the default capture shape of
    :meth:`capture_pipeline`.

    ``graph_cache`` (a :class:`repro_torch.serve.GraphCache`, or anything
    with its ``get_or_capture(apu, stages, inputs)`` contract) memoizes
    captured :class:`CommandGraph`\\ s across :meth:`offload` calls: a warm
    cache makes a repeated same-shape offload skip the capture (and the
    plain versions it runs on ``meta`` tensors).  Without one, every
    graph-mode offload captures anew.
    """

    def __init__(self, config: EGPUConfig = EGPU_16T, device: Any = "cuda",
                 explicit_transfers: bool = False,
                 graph_cache: Optional[Any] = None):
        self.egpu = Device(config)
        self.host = Device(HOST)
        self.egpu_ctx = Context(self.egpu, device)
        self.host_ctx = Context(self.host, self.egpu_ctx.torch_device)
        self.device = self.egpu_ctx.torch_device
        #: captures wrap the pipeline in explicit enqueue_write_buffer /
        #: enqueue_read_buffer transfer nodes and mark every kernel resident
        #: (see :meth:`capture_pipeline`)
        self.explicit_transfers = explicit_transfers
        self.graph_cache = graph_cache
        # This APU's own launch queue: graph offloads bind their events and
        # modeled totals here.
        self.queue = CommandQueue(self.egpu_ctx)

    # -- shared stage wiring -----------------------------------------------
    def wire_pipeline(self, q: CommandQueue, stages: Sequence["Stage"],
                      inputs: Sequence[Any],
                      resident_chain: bool = True,
                      resident_first: bool = False
                      ) -> Tuple[Tuple[Buffer, ...], list]:
        """Enqueue the stage chain on ``q`` (works eagerly or under capture).

        ``resident_chain=True`` applies the paper's §IV-B residency: after
        the first kernel, intermediate data stays in the unified memory /
        D$ — only stage 0 pays the host->D$ fill.  ``resident_first=True``
        waives stage 0's fill too — for captures whose input traffic is
        carried by explicit ``enqueue_write_buffer`` nodes instead of the
        per-kernel heuristic.  Returns (final buffers, per-stage events).
        """
        ctx = q.ctx
        bufs = tuple(x if isinstance(x, Buffer) else ctx.create_buffer(x)
                     for x in inputs)
        evs = []
        for i, stage in enumerate(stages):
            ndr = optimal_ndrange(bufs[0].data.numel(), ctx.device.config)
            extra = tuple(ctx.create_buffer(x) for x in stage.consts)
            take = bufs[:stage.n_inputs] if stage.n_inputs else bufs
            self._check_stage_arity(stage, len(take) + len(extra))
            ev = q.enqueue_nd_range(stage.kernel, ndr, take + extra,
                                    params=stage.params,
                                    counts_params=stage.counts_params,
                                    _resident=(resident_first if i == 0
                                               else resident_chain))
            bufs = ev.outputs
            evs.append(ev)
        return bufs, evs

    @staticmethod
    def _check_stage_arity(stage: "Stage", n_bufs: int) -> None:
        """Loud wiring errors via the kernel's clGetKernelArgInfo metadata:
        a stage feeding the wrong number of buffers fails *here*, naming the
        kernel and its declared args, instead of deep inside the kernel."""
        arity = stage.kernel.n_buffer_args
        if arity is None:
            return
        lo, hi = arity
        if n_bufs < lo or (hi is not None and n_bufs > hi):
            info = stage.kernel.arg_info or ()
            names = [a.name for a in info if a.kind == "buffer"]
            accepted = (f"exactly {lo}" if hi == lo else
                        f"{lo} or more" if hi is None else f"{lo}..{hi}")
            raise ValueError(
                f"stage {stage.kernel.name!r} wires {n_bufs} buffers but "
                f"the kernel declares {names} ({accepted} accepted); check "
                "n_inputs / consts")

    def _host_costs(self, stages: Sequence["Stage"],
                    graph: CommandGraph) -> List[Tuple[PhaseBreakdown, float]]:
        """Analytic host-side cost of each stage (no execution needed).

        Per-stage NDRanges are derived from each captured kernel node's
        recorded input size — exactly the sizes the eager host path would
        see — so graph and eager host reports can never diverge.  Transfer
        nodes (explicit-transfer captures) are skipped: the host baseline
        owns the unified memory and pays no bus traffic."""
        hq = CommandQueue(self.host_ctx)
        costs = []
        for stage, node in zip(stages, _kernel_nodes(graph)):
            ndr = optimal_ndrange(node.n_items, self.host.config)
            modeled, energy, _counts = hq._model(
                stage.kernel, ndr, stage.counts_params, resident=False)
            costs.append((modeled, energy))
        return costs

    def offload(self, stages: Sequence["Stage"],
                inputs: Sequence[Any],
                mode: str = "graph",
                ) -> Tuple[Tuple[Buffer, ...], PipelineReport]:
        """Run :class:`Stage`\\ s as a dataflow pipeline.

        Each stage consumes the previous stage's outputs (plus extra
        constant buffers it declares).  Returns the final outputs (computed
        on the e-GPU path) and the host-vs-e-GPU :class:`PipelineReport`.
        ``mode`` selects one CommandGraph launch (``"graph"``, default) or
        per-kernel eager dispatch (``"eager"``).
        """
        if mode not in ("graph", "eager"):
            raise ValueError(f"unknown offload mode {mode!r}")
        if mode == "graph":
            return self._offload_graph(stages, inputs)
        return self._offload_eager(stages, inputs)

    # -- CommandGraph path --------------------------------------------------
    def capture_pipeline(self, stages: Sequence["Stage"],
                         inputs: Sequence[Any],
                         explicit_transfers: Optional[bool] = None
                         ) -> CommandGraph:
        """Capture the stage chain on the e-GPU queue into a reusable
        :class:`~repro_torch.core.runtime.CommandGraph`.

        The pipeline inputs are pinned as the graph's *first* external slots
        in order — even ones no stage ends up consuming — so a graph can be
        re-launched on fresh request data with
        ``graph.launch_prefix(new_inputs)`` while the per-stage constant
        buffers keep their captured values.  ``graph.n_request_inputs``
        records how many leading externals are pipeline inputs.

        ``explicit_transfers`` (default: the APU's flag) is the host API's
        explicit capture shape: every pipeline input flows through an
        ``enqueue_write_buffer`` node, every final output through an
        ``enqueue_read_buffer`` node, and all kernels are marked resident —
        data movement is priced by dedicated transfer nodes on the DAG
        instead of the per-kernel overlap heuristic.
        """
        if explicit_transfers is None:
            explicit_transfers = self.explicit_transfers
        q = CommandQueue(self.egpu_ctx)
        with q.capture() as graph:
            bufs = tuple(self.egpu_ctx.create_buffer(x) for x in inputs)
            for b in bufs:
                graph._slot_of(b)
            if explicit_transfers:
                written = []
                for b in bufs:
                    dev = Buffer(b.data)        # device-resident destination
                    q.enqueue_write_buffer(dev, b)
                    written.append(dev)
                finals, _ = self.wire_pipeline(q, stages, written,
                                               resident_chain=True,
                                               resident_first=True)
                for out in finals:
                    q.enqueue_read_buffer(out)
            else:
                self.wire_pipeline(q, stages, bufs, resident_chain=True)
        graph.n_request_inputs = len(bufs)
        return graph

    def _offload_graph(self, stages, inputs):
        # Launch-time queue binding: events land on THIS APU's queue, not
        # the capture queue a cached graph happens to carry.
        q = self.queue
        if self.graph_cache is not None:
            graph, _hit = self.graph_cache.get_or_capture(self, stages, inputs)
            final = graph.launch_prefix(
                [self.egpu_ctx.create_buffer(x).data for x in inputs], queue=q)
        else:
            graph = self.capture_pipeline(stages, inputs)
            final = graph.launch(queue=q)
        q.finish()
        # The whole report is launch-invariant for a given graph (host
        # costs come from the captured schedule, not the inputs), so a
        # cached graph reuses it instead of re-walking the host model.
        report = getattr(graph, "_pipeline_report", None)
        if report is None:
            host = self._host_costs(stages, graph)
            reports = tuple(
                StageReport(name=stage.kernel.name, egpu=node.modeled,
                            host=h_mod, egpu_energy_j=node.energy_j,
                            host_energy_j=h_en)
                for stage, node, (h_mod, h_en)
                in zip(stages, _kernel_nodes(graph), host))
            # Kernels without a counts model still get their functional
            # outputs — just no fused cost to report.
            fused, _ = graph.fused_modeled()
            report = PipelineReport(reports, egpu_fused=fused)
            graph._pipeline_report = report
        # This APU's launch queue lives as long as the APU: return it to
        # O(1) memory now that the report is assembled (the modeled totals
        # fold into the queue's running counters).
        q.release_events()
        return final, report

    # -- per-kernel eager path ---------------------------------------------
    def _offload_eager(self, stages, inputs):
        final: Tuple[Buffer, ...] = ()
        for which, ctx in (("egpu", self.egpu_ctx), ("host", self.host_ctx)):
            q = CommandQueue(ctx)
            bufs, evs = self.wire_pipeline(q, stages, inputs,
                                           resident_chain=which == "egpu")
            q.finish()
            if which == "egpu":
                final = bufs
                egpu_evs = evs
            else:
                host_evs = evs

        reports = tuple(
            StageReport(name=stage.kernel.name, egpu=e_ev.modeled,
                        host=h_ev.modeled, egpu_energy_j=e_ev.energy_j,
                        host_energy_j=h_ev.energy_j)
            for e_ev, h_ev, stage in zip(egpu_evs, host_evs, stages))
        return final, PipelineReport(reports)

