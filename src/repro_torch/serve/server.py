"""Server — the long-lived serving engine over APU pipelines.

Ties the subsystem together: requests enter :meth:`Server.submit`, the
:class:`~repro_torch.serve.batching.BucketBatcher` pads them to shape buckets and
coalesces full micro-batches, the
:class:`~repro_torch.serve.cache.GraphCache` supplies (or captures, once per
bucket x worker) the batched :class:`CommandGraph`, and the
:class:`~repro_torch.serve.dispatch.MultiQueueDispatcher` load-balances launches
across the configured e-GPU queues under an in-flight bound.  A warm server
on steady-state traffic therefore performs **zero** re-captures / re-jits:
every launch is a cached-graph replay, paying Tiny-OpenCL startup +
scheduling once per micro-batch (paper §IV-B residency, scaled out).

The open-loop front door makes the engine survivable, not just fast:

* **SLO intake** — ``submit(..., deadline=budget_s, priority=...)`` runs
  modeled-capacity admission control: the predicted completion (per-lane
  ``modeled_s_per_request()`` x queue depth, plus the lane's modeled
  backlog) is checked against the deadline budget, and infeasible or
  queue-full requests are shed with a loud :class:`AdmissionError` instead
  of queueing unboundedly.  ``max_pending`` bounds the staged queue; a
  higher-priority request may preempt a lower-priority pending one rather
  than be shed itself.
* **Deadline-aware flushing** — every submit (and the explicit
  :meth:`tick`) pumps :meth:`BucketBatcher.tick`, launching partial
  buckets whose oldest request's budget is at risk, so a lonely
  deadline-carrying request is not held hostage waiting for its bucket to
  fill.
* **Fault-tolerant dispatch** — launches route through
  :meth:`MultiQueueDispatcher.dispatch`: injected/lane failures retry on a
  different lane with capped backoff, repeat offenders are quarantined
  behind circuit breakers, and a batch that exhausts every retry is shed
  loudly (``result()`` on its requests raises :class:`AdmissionError`
  naming the reason — no request is ever silently lost).

:meth:`Server.report` rolls the per-queue machine-model accounting into a
:class:`ServeReport`: measured requests/s, modeled per-request latency
percentiles (each request experiences its batch's fused-chain latency),
modeled energy per request, and the robustness counters — goodput
(in-deadline completions/s, measured and modeled), sheds, deadline
violations, retries and quarantines.

Requests arrive as numpy arrays or tensors and are moved to the server's
torch device (``Server(..., device="cuda")`` by default; ``device="cpu"``
runs the kernels' plain versions).  The decode-engine front of the JAX
package (``engine=``, :meth:`Server.submit_decode`, :meth:`Server.stream`)
is not ported yet: it raises ``NotImplementedError`` naming ``ROADMAP.md``
queue 1 step 2.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import (Any, Callable, Deque, Dict, Iterator, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from ..core.apu import Stage
from ..core.device import EGPUConfig, EGPU_16T, OP_ANCHOR, env_op_point
from ..core.runtime import resolve_device
from ..obs import MetricsRegistry, Tracer
from .batching import BucketBatcher, MicroBatch, batched_stages
from .cache import GraphCache, stages_signature
from .dispatch import (DispatchError, LaunchTicket, MultiQueueDispatcher,
                       PowerBudgetError, QueueStats, QueueWorker)
from .faults import FaultPlan
from .power import PowerBudget

PERCENTILES = (50, 90, 99)

#: per-request latency decomposition phases (flame attribution):
#: ``admission`` (the modeled admission decision — instantaneous today,
#: the column keeps the decomposition summing to end-to-end latency),
#: ``queueing`` (bucket wait: submit -> launch), ``dispatch`` (lane
#: backlog wait + the per-chain Tiny-OpenCL startup+scheduling overhead —
#: the paper's §VII overhead split), ``compute`` and ``transfer`` (the
#: fused chain's kernel and host<->D$ phases)
DECOMP_PHASES = ("admission", "queueing", "dispatch", "compute", "transfer")
DECOMP_PERCENTILES = (50, 99)


class AdmissionError(RuntimeError):
    """A request shed by admission control (or fault-exhausted dispatch).

    Raised from :meth:`Server.submit` when a request is rejected at the
    door, and from :meth:`Server.result` when an *accepted* request was
    shed later (priority preemption, dispatch exhaustion) — shedding is
    always loud, never a silent drop.
    """


@dataclasses.dataclass(frozen=True)
class ServeReport:
    """Aggregate serving metrics (measured throughput, modeled cost)."""

    n_requests: int
    n_batches: int
    wall_s: float
    requests_per_s: float
    #: modeled request latency percentiles, seconds (p50/p90/p99); a request
    #: experiences the fused-chain latency of the micro-batch carrying it
    modeled_latency_s: Dict[int, float]
    #: mean amortized cost per request (batch fused time / live requests) —
    #: the throughput view of the same launches
    modeled_cost_per_request_s: float
    modeled_energy_per_request_j: float
    avg_batch_fill: float              # live requests / batch capacity
    padded_elements: int               # elements added purely by padding
    queues: Tuple[QueueStats, ...]
    cache: Dict[str, int]
    #: mean per-launch utilization of each mesh axis across the sharded
    #: lanes (batch-weighted); empty when no worker owns a mesh
    mesh_utilization: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    #: completed results dropped by the bounded LRU store (not fetched or
    #: ``keep``-refreshed within the last ``metrics_window`` completions)
    results_evicted: int = 0
    # -- robustness counters ------------------------------------------------
    #: requests shed: admission rejects + priority preemptions + batches
    #: that exhausted every dispatch retry
    n_shed: int = 0
    #: completed requests whose modeled completion missed their deadline
    n_deadline_violations: int = 0
    #: in-deadline completions per measured wall second (requests without a
    #: deadline count as in-deadline)
    goodput_per_s: float = 0.0
    #: in-deadline completions per *modeled* second (machine-model
    #: makespan) — deterministic, the overload benchmark's gated number
    goodput_per_s_modeled: float = 0.0
    #: partial buckets launched because a deadline budget was at risk
    deadline_flushes: int = 0
    #: failed launch attempts rerouted to another lane
    n_retries: int = 0
    #: micro-batches that exhausted every dispatch retry (then shed)
    n_dispatch_failures: int = 0
    #: circuit-breaker trips across the fleet (lane quarantines)
    n_quarantines: int = 0
    #: per-request flame attribution: phase -> {percentile ->
    #: seconds}, decomposing modeled end-to-end latency into
    #: admission/queueing/dispatch/compute/transfer (see
    #: :data:`DECOMP_PHASES`); empty before any profiled completion
    latency_decomposition_s: Dict[str, Dict[int, float]] = \
        dataclasses.field(default_factory=dict)
    # -- power & energy accounting ------------------------------------------
    #: modeled average fleet power over the serving makespan:
    #: ``fleet_energy_j / makespan``; 0.0 before any modeled launch
    avg_fleet_power_w: float = 0.0
    #: peak modeled instantaneous fleet draw, sampled at every budgeted
    #: launch (0.0 when serving uncapped — nothing samples it)
    peak_fleet_power_w: float = 0.0
    #: idle-lane leakage integrated over the modeled makespan — each lane
    #: burns its clock-gated floor (§IV SLEEP_REQ) whenever it is not
    #: serving, energy the active-only ledger used to omit
    fleet_idle_energy_j: float = 0.0
    #: honest fleet energy: active launch energy + idle-lane leakage
    fleet_energy_j: float = 0.0
    #: completed requests per modeled second per watt of modeled fleet
    #: draw — algebraically, requests per joule of ``fleet_energy_j``
    requests_per_s_per_watt: float = 0.0
    #: in-deadline completions per modeled second per watt — the
    #: ``bench=power`` gate's goodput-per-watt number
    goodput_per_s_per_watt: float = 0.0
    #: requests shed because no lane could take them on-budget
    n_power_shed: int = 0
    #: candidate lanes skipped during routing for a budget breach
    n_power_throttled: int = 0
    #: launches whose booked window-average power broke the lane cap —
    #: MUST stay 0 while the dispatcher enforces the budget
    n_budget_violations: int = 0
    #: the configured caps (mW), ``None`` when serving uncapped
    power_budget_lane_mw: Optional[float] = None
    power_budget_fleet_mw: Optional[float] = None
    # -- continuous-batching decode engine (not ported yet: always 0) ------
    #: generate steps launched (each ONE cached-graph launch over all slots)
    engine_steps: int = 0
    #: tokens emitted from occupied slots across those steps
    engine_tokens: int = 0
    #: modeled time split: prompt passes vs autoregressive generate steps
    engine_prefill_s_modeled: float = 0.0
    engine_decode_s_modeled: float = 0.0
    #: steady-state decode throughput, tokens per modeled second
    engine_tokens_per_s_modeled: float = 0.0
    #: mean occupied-slot fraction across generate steps
    engine_slot_occupancy: float = 0.0
    #: modeled traffic of ONE captured generate step (bytes, summed off the
    #: captured schedule's per-node WorkCounts — the roofline numerator)
    engine_bytes_per_step: float = 0.0
    #: share of the modeled step the D$-bandwidth floor explains
    engine_mem_bound_fraction: float = 0.0
    # -- capture-time graph sanitizer (repro_torch.analyze) ----------------
    #: fresh captures statically verified at GraphCache miss time (a warm
    #: server replays verified graphs and never re-verifies)
    graphs_verified: int = 0
    #: sanitizer findings across those verifications — MUST stay 0: every
    #: finding is a capture-discipline bug (loud under REPRO_VERIFY=1)
    sanitizer_findings: int = 0

    def publish_metrics(self, registry: MetricsRegistry) -> MetricsRegistry:
        """Publish this report (and its per-queue / cache roll-ups) into a
        :class:`~repro_torch.obs.MetricsRegistry` — snapshot style, idempotent.
        """
        c = registry.counter
        g = registry.gauge
        c("repro_serve_requests_total",
          "completed requests").set_total(self.n_requests)
        c("repro_serve_batches_total",
          "launched micro-batches").set_total(self.n_batches)
        c("repro_serve_shed_total",
          "requests shed (door rejects + preemptions + dispatch "
          "exhaustion)").set_total(self.n_shed)
        c("repro_serve_deadline_violations_total",
          "completions past their deadline").set_total(
            self.n_deadline_violations)
        c("repro_serve_deadline_flushes_total",
          "partial buckets launched for a deadline").set_total(
            self.deadline_flushes)
        c("repro_serve_retries_total",
          "failed launch attempts rerouted").set_total(self.n_retries)
        c("repro_serve_dispatch_failures_total",
          "micro-batches that exhausted every retry").set_total(
            self.n_dispatch_failures)
        c("repro_serve_quarantines_total",
          "circuit-breaker trips").set_total(self.n_quarantines)
        c("repro_serve_results_evicted_total",
          "unread results evicted by the bounded store").set_total(
            self.results_evicted)
        g("repro_serve_requests_per_second",
          "measured request throughput").set(self.requests_per_s)
        g("repro_serve_goodput_per_second_modeled",
          "in-deadline completions per modeled second").set(
            self.goodput_per_s_modeled)
        g("repro_serve_batch_fill_ratio",
          "live requests / batch capacity").set(self.avg_batch_fill)
        g("repro_serve_energy_per_request_joules",
          "modeled energy per request").set(
            self.modeled_energy_per_request_j)
        # power telemetry
        g("repro_fleet_avg_power_watts",
          "modeled average fleet power over the makespan").set(
            self.avg_fleet_power_w)
        g("repro_fleet_peak_power_watts",
          "peak modeled instantaneous fleet draw").set(
            self.peak_fleet_power_w)
        g("repro_fleet_energy_joules",
          "fleet energy incl. idle leakage").set(self.fleet_energy_j)
        g("repro_fleet_idle_energy_joules",
          "idle-lane leakage over the makespan").set(
            self.fleet_idle_energy_j)
        g("repro_serve_requests_per_second_per_watt",
          "completed requests per modeled second per watt").set(
            self.requests_per_s_per_watt)
        g("repro_serve_goodput_per_second_per_watt",
          "in-deadline completions per modeled second per watt").set(
            self.goodput_per_s_per_watt)
        c("repro_serve_power_shed_total",
          "requests shed because no lane had power headroom").set_total(
            self.n_power_shed)
        c("repro_serve_power_throttled_total",
          "lane candidates skipped for a budget breach").set_total(
            self.n_power_throttled)
        c("repro_serve_budget_violations_total",
          "launches booked over the lane power cap").set_total(
            self.n_budget_violations)
        lat = g("repro_serve_modeled_latency_seconds",
                "modeled request latency percentiles")
        for p, v in self.modeled_latency_s.items():
            lat.set(v, quantile=f"p{p}")
        flame = g("repro_serve_latency_phase_seconds",
                  "per-request flame attribution (modeled)")
        for phase, pcts in self.latency_decomposition_s.items():
            for p, v in pcts.items():
                flame.set(v, phase=phase, quantile=f"p{p}")
        # decode-engine telemetry: only published once the engine
        # actually stepped, so pipeline-only servers add no empty series
        if self.engine_steps:
            ec = c("repro_engine_events_total",
                   "decode-engine prefills/inserts/steps/tokens")
            ec.set_total(self.engine_steps, kind="steps")
            ec.set_total(self.engine_tokens, kind="tokens")
            g("repro_engine_occupancy",
              "mean occupied-slot fraction").set(self.engine_slot_occupancy)
            g("repro_engine_tokens_per_s_modeled",
              "modeled steady-state decode throughput").set(
                self.engine_tokens_per_s_modeled)
            g("repro_engine_bytes_per_step",
              "modeled traffic of one generate step").set(
                self.engine_bytes_per_step)
            g("repro_engine_mem_bound_fraction",
              "bandwidth-floor share of the modeled step").set(
                self.engine_mem_bound_fraction)
        # same series GraphCache.publish_metrics writes — set_total is
        # idempotent, so publishing a report over a live cache never skews
        cache = registry.counter("repro_graph_cache_events_total",
                                 "graph cache hits/misses/evictions")
        for kind in ("hits", "misses", "evictions"):
            cache.set_total(self.cache[kind], kind=kind)
        g("repro_graph_cache_entries",
          "resident compiled graphs").set(self.cache["entries"])
        san = registry.counter("repro_graph_sanitizer_total",
                               "capture-time graph sanitizer results")
        san.set_total(self.graphs_verified, kind="verified")
        san.set_total(self.sanitizer_findings, kind="findings")
        for qs in self.queues:
            qs.publish_metrics(registry)
        return registry

    def summary(self) -> str:
        lines = [
            f"requests        {self.n_requests} in {self.n_batches} batches "
            f"(fill {self.avg_batch_fill:.0%}, "
            f"{self.padded_elements} padded elements)",
            f"throughput      {self.requests_per_s:,.0f} req/s measured "
            f"({self.wall_s * 1e3:.1f} ms wall)",
            "modeled latency " + "  ".join(
                f"p{p} {self.modeled_latency_s[p] * 1e3:.3f} ms"
                for p in sorted(self.modeled_latency_s)),
            f"modeled cost    {self.modeled_cost_per_request_s * 1e3:.3f} "
            f"ms/request amortized, "
            f"{self.modeled_energy_per_request_j * 1e6:.2f} uJ/request",
            f"graph cache     {self.cache['hits']} hits / "
            f"{self.cache['misses']} misses / "
            f"{self.cache['evictions']} evictions "
            f"({self.cache['entries']}/{self.cache['capacity']} resident)",
        ]
        if self.graphs_verified:
            lines.append(
                f"sanitizer       {self.graphs_verified} captures verified, "
                f"{self.sanitizer_findings} findings")
        for p in sorted({p for pcts in self.latency_decomposition_s.values()
                         for p in pcts}):
            lines.append(f"flame p{p:<2d}      " + "  ".join(
                f"{phase} {self.latency_decomposition_s[phase][p] * 1e3:.3f}"
                for phase in DECOMP_PHASES
                if phase in self.latency_decomposition_s) + " ms")
        if self.engine_steps:
            lines.append(
                f"engine          {self.engine_tokens} tokens in "
                f"{self.engine_steps} steps "
                f"(occupancy {self.engine_slot_occupancy:.0%})  "
                f"{self.engine_tokens_per_s_modeled:,.0f} tok/s modeled  "
                f"prefill {self.engine_prefill_s_modeled * 1e3:.3f} ms / "
                f"decode {self.engine_decode_s_modeled * 1e3:.3f} ms  "
                f"{self.engine_bytes_per_step:,.0f} B/step "
                f"({self.engine_mem_bound_fraction:.0%} mem-bound)")
        if (self.n_shed or self.n_deadline_violations
                or self.deadline_flushes):
            lines.append(
                f"slo             goodput {self.goodput_per_s_modeled:,.0f} "
                f"req/s modeled ({self.goodput_per_s:,.0f} measured)  "
                f"{self.n_shed} shed  "
                f"{self.n_deadline_violations} deadline misses  "
                f"{self.deadline_flushes} deadline flushes")
        if self.fleet_energy_j > 0.0:
            budget = ""
            if (self.power_budget_lane_mw is not None
                    or self.power_budget_fleet_mw is not None):
                caps = [f"lane<={self.power_budget_lane_mw:g} mW"
                        if self.power_budget_lane_mw is not None else "",
                        f"fleet<={self.power_budget_fleet_mw:g} mW"
                        if self.power_budget_fleet_mw is not None else ""]
                budget = "  budget " + " ".join(cp for cp in caps if cp)
            lines.append(
                f"power           avg {self.avg_fleet_power_w * 1e3:.2f} mW "
                f"(peak {self.peak_fleet_power_w * 1e3:.2f} mW)  "
                f"energy {self.fleet_energy_j * 1e6:.1f} uJ "
                f"(idle {self.fleet_idle_energy_j * 1e6:.1f} uJ)  "
                f"goodput/W {self.goodput_per_s_per_watt:,.0f}" + budget)
        if (self.n_power_shed or self.n_power_throttled
                or self.n_budget_violations):
            lines.append(
                f"power events    {self.n_power_shed} power sheds  "
                f"{self.n_power_throttled} throttles  "
                f"{self.n_budget_violations} budget violations")
        if (self.n_retries or self.n_quarantines
                or self.n_dispatch_failures):
            lines.append(
                f"faults          {self.n_retries} retries  "
                f"{self.n_quarantines} quarantines  "
                f"{self.n_dispatch_failures} dispatch failures")
        if self.mesh_utilization:
            lines.append("mesh util       " + "  ".join(
                f"{axis} {util:.0%}"
                for axis, util in sorted(self.mesh_utilization.items())))
        if self.results_evicted:
            lines.append(f"results         {self.results_evicted} unread "
                         "results evicted (bounded LRU store)")
        for qs in self.queues:
            mesh = ("" if not qs.mesh_axes else "  mesh " + "x".join(
                f"{a}={s}" for a, s in qs.mesh_axes))
            breaker = ("" if qs.breaker_state == "closed"
                       and not qs.launch_failures else
                       f"  faults {qs.launch_failures} "
                       f"(breaker {qs.breaker_state})")
            lines.append(
                f"  queue {qs.name:12s} {qs.batches:4d} batches "
                f"{qs.requests:5d} reqs  modeled {qs.modeled_s * 1e3:8.2f} ms "
                f"{qs.energy_j * 1e6:8.1f} uJ  peak in-flight "
                f"{qs.peak_in_flight} ({qs.backpressure_stalls} stalls)"
                + mesh + breaker)
        return "\n".join(lines)


class Server:
    """A long-lived serving engine for one APU pipeline.

    ``stages`` carry *per-request* semantics (exactly what
    :meth:`APU.offload` takes); the server lifts them over the batch axis
    internally.  ``workers`` are the lanes to dispatch across: each entry
    is either an :class:`EGPUConfig` preset (wrapped into a
    :class:`QueueWorker` on ``device``) or a pre-built worker instance, which
    must run on ``device`` too.  Heterogeneous mixes are fine, each lane
    gets its own cached graphs.  The stages' constants must lie on
    ``device``; they are hashed once, here, for the cache key.

    Robustness knobs:

    * ``max_pending`` — bound on staged (pre-launch) requests; beyond it
      submits shed (or preempt a lower-priority pending request).
      ``None`` keeps the historical unbounded-queue behavior.
    * ``admission`` / ``deadline_flush`` — disable the SLO machinery for
      A/B baselines (the overload benchmark's no-shed FIFO arm).
    * ``fault_plan`` — a :class:`~repro_torch.serve.faults.FaultPlan` installed
      on every lane the server constructs (pre-built workers keep their
      own unless they have none).
    * ``clock`` — time source for the whole engine (workers included);
      the overload benchmark injects a virtual clock to make the entire
      serving timeline machine-model-deterministic.

    Pipeline contract: kernels must be pad-stable along axis 0 of each
    request array (see :mod:`repro_torch.serve.batching`).
    """

    def __init__(self, stages: Sequence[Stage],
                 workers: Sequence[Union[EGPUConfig, QueueWorker]]
                 = (EGPU_16T,),
                 bucket_sizes: Sequence[int] = (64, 256, 1024),
                 max_batch: int = 4, max_in_flight: int = 2,
                 cache_capacity: int = 32, fill: float | int = 0,
                 crop_outputs: bool = True,
                 metrics_window: int = 100_000,
                 max_pending: Optional[int] = None,
                 admission: bool = True, deadline_flush: bool = True,
                 fault_plan: Optional[FaultPlan] = None,
                 breaker_threshold: int = 3, breaker_cooldown: int = 8,
                 clock: Callable[[], float] = time.perf_counter,
                 tracer: Optional[Tracer] = None,
                 power_budget: Optional[PowerBudget] = None,
                 engine: Optional[Any] = None, device: Any = "cuda"):
        if engine is not None:
            raise NotImplementedError(
                "Server(engine=...) needs the DecodeEngine, which is not "
                "ported yet (ROADMAP.md queue 1 step 2)")
        self.stages = tuple(stages)
        self.device = resolve_device(device)
        self.clock = clock
        self.max_pending = max_pending
        self.admission = admission
        self.deadline_flush = deadline_flush
        #: power envelope: when set, the dispatcher prices every
        #: candidate lane and routes for requests-per-joule under the caps
        self.power_budget = power_budget
        self._n_power_shed = 0
        #: opt-in span tracer, installed on the dispatcher and
        #: every lane; ``None`` (the default) keeps the hot dispatch path
        #: free of any obs allocation — every hook guards on it
        self.tracer = tracer
        self.batcher = BucketBatcher(bucket_sizes, max_batch=max_batch,
                                     fill=fill, crop_outputs=crop_outputs,
                                     device=self.device)
        # REPRO_OP_POINT: rebase anchor-point config presets onto
        # the environment's DVFS operating point — outputs must stay
        # bit-identical across op points (CI re-runs the serve suite under
        # it), only modeled time/power move.  Pre-built workers and configs
        # already rebased via ``config.at(point)`` keep their chosen point.
        point = env_op_point()
        lanes = []
        for i, w in enumerate(workers):
            if isinstance(w, QueueWorker):
                if w.device != self.device:
                    raise ValueError(
                        f"worker {w.name!r} runs on {w.device}, the server "
                        f"on {self.device}")
                if fault_plan is not None and w.fault_plan is None:
                    w.fault_plan = fault_plan
                if clock is not time.perf_counter:
                    w.clock = clock
                if tracer is not None and w.tracer is None:
                    w.tracer = tracer
                lanes.append(w)
            else:
                cfg = (w.at(point) if point is not None
                       and w.operating_point is OP_ANCHOR else w)
                lanes.append(QueueWorker(
                    cfg, name=f"{i}:{w.name}", max_in_flight=max_in_flight,
                    fault_plan=fault_plan, clock=clock, tracer=tracer,
                    device=self.device))
        self.dispatcher = MultiQueueDispatcher(
            lanes, failure_threshold=breaker_threshold,
            breaker_cooldown=breaker_cooldown, tracer=tracer,
            budget=power_budget)
        self.cache = GraphCache(cache_capacity)
        # Every micro-batch is padded to max_batch, so ONE batched pipeline
        # covers all traffic; its (const-hashing) signature is computed once
        # here — the constants' one copy to the host — never per submit.
        self._bstages = batched_stages(self.stages, max_batch)
        self._bsig = stages_signature(self._bstages)
        # Completed results in LRU order (completion order, refreshed by
        # keep=True reads).  Bounded to the metrics window: results nobody
        # fetched (or keep-refreshed) within the last `metrics_window`
        # completions are EVICTED, so a long-lived server with
        # fire-and-forget clients keeps O(window) memory instead of
        # leaking every unread output forever.
        self._results: "OrderedDict[int, Tuple[Any, ...]]" = OrderedDict()
        self._results_window = max(1, int(metrics_window))
        self._results_evicted = 0
        self._evicted_upto = -1          # highest rid ever evicted unread
        # Accepted-then-shed requests (priority preemption, dispatch
        # exhaustion): rid -> reason.  Bounded like the results store so a
        # long-lived overloaded server stays O(window); result() raises a
        # loud AdmissionError for these.
        self._shed: "OrderedDict[int, str]" = OrderedDict()
        self.n_shed = 0                  # all sheds, incl. door rejects
        # Bounded metric windows: percentiles/means in report() describe the
        # last `metrics_window` requests, so a long-lived server's metric
        # memory is O(window), matching the O(in-flight) queue contract.
        self._modeled_latency: Deque[float] = deque(maxlen=metrics_window)
        self._modeled_cost: Deque[float] = deque(maxlen=metrics_window)
        self._modeled_energy: Deque[float] = deque(maxlen=metrics_window)
        self._n_done = 0
        self._n_in_deadline = 0
        self._n_deadline_violations = 0
        # Per-request flame attribution: modeled end-to-end
        # latency split into DECOMP_PHASES, windowed like the other
        # metrics.  Computed from timestamps the serve path already
        # carries (no tracer required).
        self._decomp: Dict[str, Deque[float]] = {
            phase: deque(maxlen=metrics_window) for phase in DECOMP_PHASES}
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        self._t_last_modeled: Optional[float] = None

    # -- warm-up ------------------------------------------------------------
    def warmup(self, *example_arrays: Any) -> int:
        """Pre-capture the batched graph for every (bucket, worker) pair.

        ``example_arrays`` is one representative request (its trailing dims
        and dtypes define the bucket shapes; values are irrelevant — capture
        traces abstractly).  After ``warmup`` a server sees zero re-captures
        on any traffic that fits the configured buckets.  Returns the number
        of graphs captured.
        """
        arrs = tuple(torch.as_tensor(a, device=self.device)
                     for a in example_arrays)
        captured = 0
        for size in self.batcher.bucket_sizes:
            inputs = []
            for a in arrs:
                shape = ((self.batcher.max_batch,) if a.ndim == 0 else
                         (self.batcher.max_batch, size) + a.shape[1:])
                inputs.append(torch.zeros(shape, dtype=a.dtype,
                                          device=self.device))
            for worker in self.dispatcher.workers:
                _graph, hit = self.cache.get_or_capture(
                    worker.apu, self._bstages, tuple(inputs),
                    key_prefix=self._bsig)
                captured += 0 if hit else 1
        return captured

    # -- request intake -----------------------------------------------------
    def submit(self, *arrays: Any, deadline: Optional[float] = None,
               priority: int = 0) -> int:
        """Enqueue one request; full (or deadline-at-risk) buckets launch
        immediately.

        ``deadline`` is a *budget* in seconds from now (the request's
        absolute deadline is ``now + deadline`` on the server's clock);
        ``priority`` is its scheduling priority — under overload a
        higher-priority request may preempt a lower-priority pending one
        instead of being shed.  Raises :class:`AdmissionError` when
        admission control sheds the request (queue full, or the modeled
        capacity cannot meet the deadline), without consuming a request
        id.  Returns the request id; fetch its outputs with
        :meth:`result` after a :meth:`flush` (or once enough same-bucket
        traffic flushed it naturally)."""
        now = self.clock()
        if deadline is not None:
            deadline = float(deadline)
            if deadline <= 0.0:
                raise ValueError(
                    f"deadline must be a positive budget in seconds, "
                    f"got {deadline}")
        try:
            self._admit(now, deadline, priority)
        except AdmissionError as e:
            # door rejects never consumed a rid, so they carry no span
            # tree — the shed decision lands as a track-level instant
            if self.tracer is not None:
                self.tracer.instant("server", now, "shed-at-door",
                                    reason=str(e), priority=priority)
            raise
        req = self.batcher.submit(
            *arrays, t_submit=now,
            deadline_s=None if deadline is None else now + deadline,
            priority=priority)
        if self.tracer is not None:
            self.tracer.begin_request(
                req.rid, now, priority=priority,
                deadline_s=None if deadline is None else now + deadline)
            self.tracer.request_event(req.rid, now, "submit",
                                      n_pending=self.batcher.n_pending)
        # Start the wall clock only once a request is actually ACCEPTED:
        # stamping before batcher.submit would charge servers whose first
        # submit was rejected (oversize, shed) for idle time they never
        # served, skewing requests/s.
        if self._t0 is None:
            self._t0 = now
        self._launch(self.batcher.pop_full())
        if self.deadline_flush:
            self._launch(self.batcher.tick(now, slack_s=self._flush_slack()),
                         deadline_flushed=True)
        return req.rid

    def tick(self, now: Optional[float] = None) -> None:
        """Deadline pump for idle periods: launch any partial bucket whose
        oldest request's budget is at risk (callers with open-loop traffic
        should call this between arrivals)."""
        if not self.deadline_flush:
            return
        now = self.clock() if now is None else now
        self._launch(self.batcher.tick(now, slack_s=self._flush_slack()),
                     deadline_flushed=True)

    def flush(self) -> None:
        """Force every pending request through: drain partial buckets, then
        retire all in-flight launches."""
        self._launch(self.batcher.drain())
        self._finalize(self.dispatcher.drain_all())

    # -- admission control --------------------------------------------------
    def _best_spr(self) -> Optional[float]:
        """The fleet's best modeled seconds-per-request across currently
        available (non-quarantined) lanes; ``None`` while unprofiled."""
        sprs = [s for s in (w.modeled_s_per_request()
                            for w in self.dispatcher.available_workers())
                if s is not None]
        return min(sprs) if sprs else None

    def _predicted_completion_s(self, now: float) -> Optional[float]:
        """Modeled seconds until a request submitted *now* would complete:
        the earliest lane's modeled backlog, plus the queue ahead of it
        (staged + in-flight requests, split across the available lanes)
        served at the best lane's modeled seconds-per-request, plus its
        own service.  ``None`` while the fleet is unprofiled (cold servers
        admit everything and bootstrap)."""
        lanes = self.dispatcher.available_workers()
        spr = self._best_spr()
        if spr is None:
            return None
        backlog = min(max(0.0, w.modeled_busy_until - now) for w in lanes)
        depth = (self.batcher.n_pending
                 + sum(w.inflight_requests for w in lanes))
        return backlog + spr * (depth / max(1, len(lanes)) + 1.0)

    def _flush_slack(self) -> float:
        """Remaining-budget threshold at which a partial bucket must
        launch: the modeled backlog ahead of it plus one full batch's
        service — waiting longer would eat time the launch itself needs."""
        spr = self._best_spr()
        if spr is None:
            return 0.0
        now = self.clock()
        backlog = min((max(0.0, w.modeled_busy_until - now)
                       for w in self.dispatcher.available_workers()),
                      default=0.0)
        return backlog + spr * self.batcher.max_batch

    def _admit(self, now: float, deadline: Optional[float],
               priority: int) -> None:
        """Shed (raise :class:`AdmissionError`) instead of queueing
        unboundedly — see class docstring."""
        if not self.admission:
            return
        if (self.max_pending is not None
                and self.batcher.n_pending >= self.max_pending):
            victim = self.batcher.lowest_priority_pending()
            if victim is not None and victim.priority < priority:
                # the new request outranks a staged one: preempt the
                # lowest-priority pending request (loudly) and admit
                self.batcher.remove(victim.rid)
                self._record_shed(
                    victim.rid,
                    f"preempted while pending by a priority-{priority} "
                    f"request (own priority {victim.priority}, queue full "
                    f"at max_pending={self.max_pending})")
            else:
                self.n_shed += 1
                raise AdmissionError(
                    f"admission control shed request: {self.batcher.n_pending}"
                    f" pending >= max_pending={self.max_pending} and "
                    f"priority {priority} outranks no pending request")
        if deadline is not None:
            predicted = self._predicted_completion_s(now)
            if predicted is not None and predicted > deadline:
                self.n_shed += 1
                raise AdmissionError(
                    f"admission control shed request: predicted completion "
                    f"{predicted * 1e3:.3f} ms exceeds the deadline budget "
                    f"{deadline * 1e3:.3f} ms (modeled capacity, "
                    f"{self.batcher.n_pending} staged)")

    def _record_shed(self, rid: int, reason: str) -> None:
        self._shed[rid] = reason
        self.n_shed += 1
        if self.tracer is not None:
            # accepted-then-shed: the rid's tree ends in a named terminal
            self.tracer.finish_request(rid, self.clock(), "shed",
                                       reason=reason)
        while len(self._shed) > self._results_window:
            self._shed.popitem(last=False)

    # -- results ------------------------------------------------------------
    def result(self, rid: int, keep: bool = False) -> Tuple[Any, ...]:
        """Per-request outputs (cropped back to the request's true extent).

        Pops the stored result by default (pass ``keep=True`` to leave it
        readable again).  The store is a bounded LRU: results neither
        fetched nor ``keep``-refreshed within the last ``metrics_window``
        completions are evicted, so a long-lived server stays O(window)
        even when clients never fetch — an evicted read raises
        :class:`KeyError` with an explicit hint.  A request that was
        accepted but later shed (priority preemption, dispatch
        exhaustion) raises :class:`AdmissionError` naming the reason.
        """
        if rid in self._shed:
            raise AdmissionError(
                f"request {rid} was shed after acceptance: {self._shed[rid]}")
        if rid not in self._results:
            evicted = (" (or it was evicted: results not read within the "
                       f"last {self._results_window} completions — "
                       "metrics_window — are dropped)"
                       if rid <= self._evicted_upto else "")
            raise KeyError(
                f"request {rid} has no result (yet, or it was already "
                f"read{evicted}) — flush() the server or submit enough "
                "traffic to fill its bucket")
        if keep:
            # LRU refresh: an actively-polled kept result must not age out
            # behind completions that arrived after its last read
            self._results.move_to_end(rid)
            return self._results[rid]
        return self._results.pop(rid)

    @property
    def n_completed(self) -> int:
        return self._n_done

    # -- decode-engine front ------------------------------------------------
    def submit_decode(self, prompt: Any, max_new: int,
                      deadline: Optional[float] = None,
                      priority: int = 0) -> int:
        """The decode-engine front: not ported yet."""
        raise NotImplementedError(
            "Server.submit_decode needs the DecodeEngine, which is not "
            "ported yet (ROADMAP.md queue 1 step 2)")

    def stream(self, rid: int) -> Iterator[int]:
        """The decode-engine token stream: not ported yet."""
        raise NotImplementedError(
            "Server.stream needs the DecodeEngine, which is not ported yet "
            "(ROADMAP.md queue 1 step 2)")

    # -- internals ----------------------------------------------------------
    def _launch(self, batches: Sequence[MicroBatch],
                deadline_flushed: bool = False) -> None:
        for batch in batches:
            if self.tracer is not None and deadline_flushed:
                t_evt = self.clock()
                for req in batch.requests:
                    self.tracer.request_event(
                        req.rid, t_evt, "deadline-flush",
                        n_requests=batch.n_requests)

            def graph_for(worker: QueueWorker,
                          batch: MicroBatch = batch):
                graph, hit = self.cache.get_or_capture(
                    worker.apu, self._bstages, batch.inputs,
                    key_prefix=self._bsig)
                if self.tracer is not None:
                    t_evt = self.clock()
                    for req in batch.requests:
                        self.tracer.request_event(
                            req.rid, t_evt,
                            "cache-hit" if hit else "cache-miss",
                            lane=worker.name)
                return graph

            # Power routing prices EVERY candidate lane, not just the
            # chosen one — a quiet estimator keeps speculative pricing out
            # of the request trace (graph_for emits cache events per call)
            estimate_for = None
            if self.dispatcher.budget is not None:
                def estimate_for(worker: QueueWorker,
                                 batch: MicroBatch = batch):
                    graph, _hit = self.cache.get_or_capture(
                        worker.apu, self._bstages, batch.inputs,
                        key_prefix=self._bsig)
                    return worker.estimate(graph)
            try:
                _ticket, retired = self.dispatcher.dispatch(
                    batch, graph_for, t_now=self.clock(),
                    estimate_for=estimate_for)
            except DispatchError as e:
                # the batch exhausted every lane/retry (or, under a power
                # budget, no lane could take it on-budget): its launches
                # never happened, so shed every carried request LOUDLY —
                # the backpressure-retired tickets from failed attempts
                # were real launches and still finalize below
                self._finalize(e.retired)
                if isinstance(e, PowerBudgetError):
                    self._n_power_shed += len(batch.requests)
                    reason = f"power budget shed: {e}"
                else:
                    reason = f"dispatch failed: {e}"
                for req in batch.requests:
                    self._record_shed(req.rid, reason)
                continue
            self._finalize(retired)

    def _trace_completion(self, t: LaunchTicket, req: Any,
                          exec_start: float, violated: bool) -> None:
        """Retroactive request-tree spans for one completed request (only
        reached when a tracer is installed).  All timestamps are already
        known — bucket wait, lane schedule, modeled completion — so the
        spans are emitted at finalize time with zero hot-path cost."""
        tr = self.tracer
        rid = req.rid
        t_end = (t.t_done_modeled if t.t_done_modeled is not None
                 else exec_start)
        tr.child(rid, "bucket-wait", req.t_submit, t.t_launch)
        tr.child(rid, "dispatch", t.t_launch, exec_start,
                 lane=t.worker.name)
        tr.child(rid, "execute", exec_start, t_end, lane=t.worker.name,
                 batch_requests=t.batch.n_requests)
        if violated:
            tr.request_event(rid, t_end, "deadline-miss",
                             deadline_s=req.deadline_s)
        tr.finish_request(rid, t_end, "result")

    def _finalize(self, tickets: Sequence[LaunchTicket]) -> None:
        for t in tickets:
            per_request = t.batch.crop(t.outputs)
            n = max(1, t.batch.n_requests)
            # modeled start of the batch's service window on its lane
            # (t_done_modeled already includes any queueing behind the
            # lane's busy timeline)
            fused_s = t.fused.total_s if t.fused is not None else 0.0
            # clamped: an idle lane starts at t_launch exactly, and the
            # subtraction may land an ulp before it
            exec_start = (max(t.t_launch, t.t_done_modeled - fused_s)
                          if t.t_done_modeled is not None else t.t_launch)
            for req, outs in zip(t.batch.requests, per_request):
                self._results[req.rid] = outs
                while len(self._results) > self._results_window:
                    old_rid, _ = self._results.popitem(last=False)
                    self._results_evicted += 1
                    self._evicted_upto = max(self._evicted_upto, old_rid)
                if t.fused is not None:
                    # each request *experiences* the whole batch's fused
                    # latency; its amortized cost share (the throughput
                    # view) and energy split across the live requests
                    self._modeled_latency.append(t.fused.total_s)
                    self._modeled_cost.append(t.fused.scaled(1.0 / n).total_s)
                    self._modeled_energy.append(t.energy_j / n)
                    # flame attribution: the request's end-to-end modeled
                    # latency (submit -> t_done_modeled) split by phase —
                    # the five deques always sum to it (see DECOMP_PHASES)
                    freq = t.fused.freq_hz
                    self._decomp["admission"].append(0.0)
                    self._decomp["queueing"].append(
                        t.t_launch - req.t_submit)
                    self._decomp["dispatch"].append(
                        (exec_start - t.t_launch)
                        + (t.fused.startup + t.fused.scheduling) / freq)
                    self._decomp["compute"].append(t.fused.compute / freq)
                    self._decomp["transfer"].append(t.fused.transfer / freq)
                # deadline accounting against the deterministic modeled
                # completion time (requests without a deadline are always
                # "in deadline" for goodput purposes)
                violated = (req.deadline_s is not None
                            and t.t_done_modeled is not None
                            and t.t_done_modeled > req.deadline_s)
                if violated:
                    self._n_deadline_violations += 1
                else:
                    self._n_in_deadline += 1
                self._n_done += 1
                if self.tracer is not None:
                    self._trace_completion(t, req, exec_start, violated)
            if t.t_done is not None:
                self._t_last = (t.t_done if self._t_last is None
                                else max(self._t_last, t.t_done))
            if t.t_done_modeled is not None:
                self._t_last_modeled = (
                    t.t_done_modeled if self._t_last_modeled is None
                    else max(self._t_last_modeled, t.t_done_modeled))

    # -- reporting ----------------------------------------------------------
    def report(self) -> ServeReport:
        wall = ((self._t_last - self._t0)
                if self._t0 is not None and self._t_last is not None else 0.0)
        modeled_span = ((self._t_last_modeled - self._t0)
                        if self._t0 is not None
                        and self._t_last_modeled is not None else 0.0)
        lat = np.asarray(self._modeled_latency, np.float64)
        pct = {p: (float(np.percentile(lat, p)) if lat.size else 0.0)
               for p in PERCENTILES}
        cost = (float(np.mean(self._modeled_cost))
                if self._modeled_cost else 0.0)
        energy = (float(np.mean(self._modeled_energy))
                  if self._modeled_energy else 0.0)
        n_batches = self.batcher.n_batches
        fill = (self._n_done / (n_batches * self.batcher.max_batch)
                if n_batches else 0.0)
        queues = self.dispatcher.stats()
        # batch-weighted mean utilization per mesh axis across sharded lanes
        # (none in this package yet: the mapping stays empty)
        axis_sum: Dict[str, float] = {}
        axis_n: Dict[str, int] = {}
        for qs in queues:
            for axis, util in qs.mesh_utilization:
                axis_sum[axis] = axis_sum.get(axis, 0.0) + util * qs.batches
                axis_n[axis] = axis_n.get(axis, 0) + qs.batches
        mesh_util = {a: axis_sum[a] / axis_n[a]
                     for a in axis_sum if axis_n[a]}
        decomp = {}
        if any(self._decomp[p] for p in DECOMP_PHASES):
            decomp = {
                phase: {p: float(np.percentile(
                            np.asarray(self._decomp[phase], np.float64), p))
                        for p in DECOMP_PERCENTILES}
                for phase in DECOMP_PHASES}
        # -- power & energy: honest fleet energy over the modeled
        # makespan — active launch energy per lane, plus each lane's
        # clock-gated leakage floor (§IV SLEEP_REQ) for every modeled second
        # it was NOT serving.  All derived efficiency numbers divide by the
        # honest total, never the active-only ledger.
        active_energy = sum(qs.energy_j for qs in queues)
        idle_energy = (sum(max(0.0, modeled_span - qs.modeled_s)
                           * qs.idle_power_w for qs in queues)
                       if modeled_span > 0 else 0.0)
        fleet_energy = active_energy + idle_energy
        return ServeReport(
            n_requests=self._n_done,
            n_batches=n_batches,
            wall_s=wall,
            requests_per_s=(self._n_done / wall if wall > 0 else 0.0),
            modeled_latency_s=pct,
            modeled_cost_per_request_s=cost,
            modeled_energy_per_request_j=energy,
            avg_batch_fill=fill,
            padded_elements=self.batcher.padded_elements,
            queues=queues,
            cache=self.cache.stats(),
            graphs_verified=self.cache.verified,
            sanitizer_findings=self.cache.findings,
            mesh_utilization=mesh_util,
            results_evicted=self._results_evicted,
            n_shed=self.n_shed,
            n_deadline_violations=self._n_deadline_violations,
            goodput_per_s=(self._n_in_deadline / wall if wall > 0 else 0.0),
            goodput_per_s_modeled=(self._n_in_deadline / modeled_span
                                   if modeled_span > 0 else 0.0),
            deadline_flushes=self.batcher.deadline_flushes,
            n_retries=self.dispatcher.retries,
            n_dispatch_failures=self.dispatcher.dispatch_failures,
            n_quarantines=self.dispatcher.quarantines(),
            latency_decomposition_s=decomp,
            avg_fleet_power_w=(fleet_energy / modeled_span
                               if modeled_span > 0 else 0.0),
            peak_fleet_power_w=self.dispatcher.peak_fleet_power_w,
            fleet_idle_energy_j=idle_energy,
            fleet_energy_j=fleet_energy,
            requests_per_s_per_watt=(self._n_done / fleet_energy
                                     if fleet_energy > 0 else 0.0),
            goodput_per_s_per_watt=(self._n_in_deadline / fleet_energy
                                    if fleet_energy > 0 else 0.0),
            n_power_shed=self._n_power_shed,
            n_power_throttled=self.dispatcher.power_throttles,
            n_budget_violations=sum(qs.budget_violations for qs in queues),
            power_budget_lane_mw=(None if self.power_budget is None
                                  else self.power_budget.lane_mw),
            power_budget_fleet_mw=(None if self.power_budget is None
                                   else self.power_budget.fleet_mw),
        )

    def publish_metrics(self, registry: Optional[MetricsRegistry] = None
                        ) -> MetricsRegistry:
        """Publish the whole stack's telemetry into a registry (snapshot
        style, idempotent): the :meth:`report` roll-up, per-queue stats,
        cache counters, and any installed fault plans' injection totals.
        """
        registry = MetricsRegistry() if registry is None else registry
        self.report().publish_metrics(registry)
        self.cache.publish_metrics(registry)
        plans = {id(w.fault_plan): w.fault_plan
                 for w in self.dispatcher.workers
                 if w.fault_plan is not None}
        for plan in plans.values():
            plan.publish_metrics(registry)
        return registry
