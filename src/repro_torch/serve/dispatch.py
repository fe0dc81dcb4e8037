"""Multi-queue dispatch — load balancing, backpressure, fault-tolerant
routing, per-queue accounting.

One e-GPU instance is one in-order queue; a serving deployment runs several
(possibly heterogeneous — different ``EGPUConfig`` presets, mirroring the
paper's configurability story).  The dispatcher routes each micro-batch to
the least-loaded :class:`QueueWorker`, bounds every worker's in-flight depth
(launch beyond ``max_in_flight`` first retires the oldest ticket — classic
credit-based backpressure, keeping queue memory and latency bounded), and
rolls per-queue machine-model totals up for the
:class:`~repro_torch.serve.server.ServeReport`.

Every worker owns its :class:`~repro_torch.core.runtime.CommandQueue` (the APU's)
and launches cached graphs with launch-time queue binding
(``graph.launch_prefix(..., queue=worker.queue)``), so a
:class:`~repro_torch.serve.cache.GraphCache` entry shared by several same-config
workers books each launch's events and modeled totals on the launching
worker's queue only — per-queue accounting is exact by construction, not by
coincidence.  Workers retire tickets through the Event-lifecycle API:
``queue.drain(n)`` waits on the launch's own ``torch.cuda.Event`` (never a
device-wide synchronize, so ``max_in_flight`` launches really overlap the
host) and ``queue.release_events(upto=n)`` returns the worker's queue to
O(in-flight) memory while the released events' modeled time/energy stay in
the queue's running totals.

Fault tolerance: a worker built with a
:class:`~repro_torch.serve.faults.FaultPlan` gates every ``_do_launch`` through
the plan — injected failures raise :class:`InjectedFault` *before* any real
work.  :meth:`MultiQueueDispatcher.dispatch` retries a failed micro-batch
with capped exponential backoff, preferring a *different* lane each
attempt; per-lane :class:`CircuitBreaker`\\ s quarantine repeat offenders
(skipped by routing while OPEN) and re-admit them through half-open probe
launches, so a blacked-out lane neither absorbs traffic nor stays banned
after it recovers.  Because injected faults fire pre-launch and kernels are
pure, a retried micro-batch is bit-identical to the fault-free path.

Modeled virtual time: every launch also advances the lane's
``modeled_busy_until`` on the server's clock timeline —
``start = max(now, busy_until)``, ``done = start + fused.total_s`` — giving
each ticket a deterministic machine-model completion time
(``t_done_modeled``) that deadline checks and the overload benchmark's
goodput gate use instead of wall-clock noise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence, Set, Tuple

from ..core.apu import APU
from ..core.device import EGPUConfig
from ..core.machine import PhaseBreakdown
from ..core.power import egpu_idle_power_mw
from ..core.runtime import Buffer, CommandGraph
from ..obs import Tracer
from .batching import MicroBatch
from .faults import FaultPlan, InjectedFault, apply_spike
from .power import LanePrice, PowerBudget


class DispatchError(RuntimeError):
    """A micro-batch exhausted every retry across the fleet.

    ``retired`` carries tickets retired for backpressure during the failed
    attempts — those launches were real and must still be finalized.
    """

    def __init__(self, msg: str, retired: Sequence["LaunchTicket"] = ()):
        super().__init__(msg)
        self.retired = tuple(retired)


class PowerBudgetError(DispatchError):
    """No lane can take the micro-batch within the :class:`PowerBudget`.

    A :class:`DispatchError` subclass so the server's existing loud-shed
    machinery applies unchanged: the batch's requests surface an
    :class:`~repro_torch.serve.server.AdmissionError` naming the budget — an
    over-budget fleet throttles and sheds, it never quietly overdraws.
    """


@dataclasses.dataclass
class LaunchTicket:
    """One in-flight micro-batch launch and its modeled cost."""

    batch: MicroBatch
    outputs: Tuple[Buffer, ...]
    worker: "QueueWorker"
    #: fused breakdown of the whole batched chain (startup+scheduling paid
    #: once per launch — every request in the batch experiences this latency)
    fused: Optional[PhaseBreakdown]
    energy_j: float
    t_launch: float
    t_done: Optional[float] = None
    #: events this launch appended to the launching worker's queue (one per
    #: node — launch-time binding, never the graph's capture queue)
    n_events: int = 0
    #: machine-model completion time on the server's clock timeline:
    #: ``max(t_launch, lane busy_until) + fused.total_s`` — deterministic,
    #: used for deadline-violation checks and modeled goodput
    t_done_modeled: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.t_done is not None

    @property
    def modeled_latency_s(self) -> Optional[float]:
        return None if self.fused is None else self.fused.total_s


class QueueWorker:
    """One serving lane: an :class:`APU` + bounded in-flight window.

    ``max_in_flight`` is the backpressure credit count: a launch that would
    exceed it first retires the oldest outstanding ticket (waiting on its
    launch's own device event and releasing its queue events), so a worker
    can never accumulate unbounded speculative work.

    ``device`` is the torch device the lane's kernels run on (``"cuda"`` by
    default; ``"cpu"`` runs the plain versions).  ``fault_plan`` hooks
    deterministic fault injection into :meth:`_do_launch`; ``clock`` is the
    time source every timestamp on this lane uses — the overload benchmark
    injects a virtual clock so the whole serving timeline becomes
    machine-model-deterministic.
    """

    def __init__(self, config: EGPUConfig, name: Optional[str] = None,
                 max_in_flight: int = 2, explicit_transfers: bool = True,
                 fault_plan: Optional[FaultPlan] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 tracer: Optional[Tracer] = None, device: Any = "cuda"):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        # The worker's captures move each micro-batch through explicit
        # enqueue_write_buffer / enqueue_read_buffer nodes at the batch
        # boundaries, so the queue's modeled totals price the real request
        # traffic as dedicated transfer events instead of the per-kernel
        # overlap heuristic.
        self.apu = APU(config, device=device,
                       explicit_transfers=explicit_transfers)
        #: the torch device this lane's launches run on
        self.device = self.apu.device
        #: this worker's own command queue — every launch binds its events
        #: and modeled totals here, never to a cached graph's capture queue
        self.queue = self.apu.queue
        self.name = name or config.name
        self.max_in_flight = max_in_flight
        self.fault_plan = fault_plan
        self.clock = clock
        #: opt-in span tracer: every hook guards on ``is not
        #: None`` so an untraced worker allocates no obs object on the
        #: hot dispatch path
        self.tracer = tracer
        self._inflight: List[LaunchTicket] = []
        self._launch_seq = 0             # fault-plan launch index (attempts)
        #: machine-model time this lane is busy until (server clock
        #: timeline); launches queue behind it, giving deterministic
        #: per-ticket modeled completion times
        self.modeled_busy_until = 0.0
        #: clock-gated leakage floor of this lane, watts (§IV SLEEP_REQ):
        #: what the lane draws between launches; scales with the config's
        #: DVFS operating point through the power model
        self.idle_power_w = egpu_idle_power_mw(config) * 1e-3
        #: the fleet's :class:`PowerBudget` (installed by the dispatcher);
        #: when set, every launch re-audits its own window-average power
        self.power_budget: Optional[PowerBudget] = None
        # accounting
        self.n_batches = 0
        self.n_requests = 0
        self.modeled_s = 0.0
        self.energy_j = 0.0
        self.peak_in_flight = 0
        self.backpressure_stalls = 0
        self.launch_failures = 0         # injected faults this lane absorbed
        self.budget_violations = 0       # launches that broke the lane cap

    @property
    def depth(self) -> int:
        return len(self._inflight)

    @property
    def inflight_requests(self) -> int:
        """Live requests across this lane's in-flight tickets (admission
        control counts them as queue depth)."""
        return sum(t.batch.n_requests for t in self._inflight)

    # -- power pricing ------------------------------------------------------
    def estimate(self, graph: CommandGraph
                 ) -> Tuple[Optional[PhaseBreakdown], float]:
        """Modeled (fused breakdown, energy) a launch of ``graph`` would
        book on this lane — the dispatcher's pricing view, matching
        :meth:`_do_launch`'s accounting exactly minus injected latency
        spikes (which only *lengthen* the window, so the price is an upper
        bound on the booked window-average power)."""
        return graph.fused_modeled()

    def pending_energy_j(self, t_now: float) -> float:
        """Energy this lane's in-flight tickets still deliver after
        ``t_now``: each ticket's launch energy, scaled by the unelapsed
        fraction of its modeled service window."""
        e = 0.0
        for t in self._inflight:
            if t.fused is None or t.t_done_modeled is None:
                continue
            dur = t.fused.total_s
            if dur <= 0.0:
                continue
            remaining = min(dur, max(0.0, t.t_done_modeled - t_now))
            e += t.energy_j * (remaining / dur)
        return e

    def price(self, fused: Optional[PhaseBreakdown], energy_j: float,
              t_now: float, n_requests: int = 1) -> LanePrice:
        """Price a candidate launch: modeled latency (backlog + service on
        this lane's timeline) and the window-average power committing to
        it implies.  Pure read — books nothing."""
        modeled_s = fused.total_s if fused is not None else 0.0
        backlog_s = max(0.0, self.modeled_busy_until - t_now)
        window_s = backlog_s + modeled_s
        total_e = self.pending_energy_j(t_now) + energy_j
        avg_power_w = total_e / window_s if window_s > 0.0 else 0.0
        rpj = (n_requests / total_e) if total_e > 0.0 else float("inf")
        return LanePrice(lane=self.name, modeled_s=modeled_s,
                         window_s=window_s, avg_power_w=avg_power_w,
                         energy_j=energy_j, requests_per_joule=rpj)

    def current_power_w(self, t_now: float) -> float:
        """This lane's modeled draw right now: remaining in-flight energy
        over the remaining busy window, floored at the clock-gated leakage
        the silicon burns regardless; an idle lane sits exactly on that
        floor (§IV — SLEEP_REQ gates the clocks, leakage stays)."""
        backlog_s = max(0.0, self.modeled_busy_until - t_now)
        if backlog_s <= 0.0:
            return self.idle_power_w
        return max(self.idle_power_w,
                   self.pending_energy_j(t_now) / backlog_s)

    # -- launch / retire ----------------------------------------------------
    def _fault_gate(self) -> float:
        """The :class:`FaultPlan` hook at the top of every ``_do_launch``.

        Draws this lane's fate for the current launch index: raises
        :class:`InjectedFault` (launch failure / blackout) *before* any
        real work, or returns the latency spike to fold into the modeled
        breakdown (0.0 for a clean launch or no plan).
        """
        idx = self._launch_seq
        self._launch_seq += 1
        if self.fault_plan is None:
            return 0.0
        decision = self.fault_plan.draw(self.name, idx)
        if decision.fail:
            self.launch_failures += 1
            raise InjectedFault(
                f"injected fault on lane {self.name!r} launch {idx}: "
                f"{decision.reason}",
                lane=self.name, launch_idx=idx, reason=decision.reason)
        return decision.spike_s

    def _do_launch(self, graph: CommandGraph, batch: MicroBatch
                   ) -> Tuple[Tuple[Buffer, ...],
                              Optional[PhaseBreakdown], float]:
        """Fire one launch and return (outputs, fused breakdown, energy).

        Gated by :meth:`_fault_gate` — an injected failure raises before
        the graph runs, so retries replay identical pure code."""
        spike_s = self._fault_gate()
        # `batch.donate` hands those input positions over to the launch
        # (they are verified and marked consumed); the empty default is the
        # plain non-donating launch.
        outs = graph.launch_prefix(batch.inputs, queue=self.queue,
                                   donate=batch.donate)
        fused, energy = graph.fused_modeled()   # memoized: launch-invariant
        return outs, apply_spike(fused, spike_s), energy

    def launch(self, graph: CommandGraph, batch: MicroBatch,
               t_now: Optional[float] = None
               ) -> Tuple[LaunchTicket, List[LaunchTicket]]:
        """Launch ``batch`` through ``graph``; returns the new ticket plus
        any tickets retired to stay under the in-flight bound.

        On an :class:`InjectedFault` the already-retired tickets ride out
        on the exception's ``retired`` attribute — their launches were
        real and the caller must still finalize them."""
        retired = []
        while len(self._inflight) >= self.max_in_flight:
            self.backpressure_stalls += 1
            retired.append(self._retire_oldest())
        try:
            outs, fused, energy = self._do_launch(graph, batch)
        except InjectedFault as e:
            e.retired = tuple(retired)
            raise
        t_now = self.clock() if t_now is None else t_now
        if (self.power_budget is not None
                and self.power_budget.lane_mw is not None):
            # the enforcement invariant's audit hook: re-price the
            # launch actually being booked — post-backpressure, spike
            # included — against the lane cap.  The dispatcher's pre-launch
            # pricing upper-bounds this, so the counter stays 0 whenever
            # routing enforced the budget; a non-zero count means a request
            # executed over budget (gated to zero by the hypothesis sweep).
            booked = self.price(fused, energy, t_now,
                                n_requests=batch.n_requests)
            if not self.power_budget.lane_ok(booked.avg_power_w):
                self.budget_violations += 1
        start = max(t_now, self.modeled_busy_until)
        t_done_modeled = start + (fused.total_s if fused is not None else 0.0)
        self.modeled_busy_until = t_done_modeled
        ticket = LaunchTicket(batch=batch, outputs=outs, worker=self,
                              fused=fused, energy_j=energy,
                              t_launch=t_now,
                              n_events=len(graph.nodes),
                              t_done_modeled=t_done_modeled)
        self._inflight.append(ticket)
        self.peak_in_flight = max(self.peak_in_flight, len(self._inflight))
        self.n_batches += 1
        self.n_requests += batch.n_requests
        if fused is not None:
            self.modeled_s += fused.total_s
        self.energy_j += energy
        if self.tracer is not None:
            self._trace_launch(graph, batch, start, t_done_modeled, fused)
        return ticket, retired

    def _trace_launch(self, graph: CommandGraph, batch: MicroBatch,
                      start: float, t_done: float,
                      fused: Optional[PhaseBreakdown]) -> None:
        """Lane-track slices for one launch (only reached when a tracer is
        installed): a ``launch`` span over the modeled service window, one
        ``startup+scheduling`` slice for the per-chain Tiny-OpenCL
        overhead, then one slice per graph node sized by its captured
        :class:`PhaseBreakdown` and laid out along the node DAG's
        critical-path schedule — concurrent branches visibly overlap.
        Purely observational: reads the already-computed modeled schedule,
        never feeds back into it."""
        tr = self.tracer
        track = f"lane:{self.name}"
        parent = tr.span("launch", start, t_done, track=track,
                         n_requests=batch.n_requests,
                         rids=[r.rid for r in batch.requests])
        if fused is None:
            return
        overhead_s = (fused.startup + fused.scheduling) / fused.freq_hz
        if overhead_s > 0.0:
            tr.span("startup+scheduling", start, start + overhead_s,
                    track=track, parent=parent)
        base = start + overhead_s
        finish: dict = {}
        for i, node in enumerate(graph.nodes):
            t0 = max((finish[d] for d in node.deps if d in finish),
                     default=base)
            b = node.modeled
            dur = (0.0 if b is None
                   else (b.transfer + b.compute) / b.freq_hz)
            finish[i] = t0 + dur
            if node.kind == "sync" or b is None:
                continue                 # zero-cost markers: no slice
            tr.span(node.kernel.name, t0, t0 + dur, track=track,
                    parent=parent, kind=node.kind)

    def _retire_oldest(self) -> LaunchTicket:
        ticket = self._inflight.pop(0)
        try:
            # Wait on exactly this launch: its events share the
            # torch.cuda.Event recorded behind its last kernel, so the
            # drain synchronizes that event alone (never the whole device)
            # and later tickets' launches keep running.
            self.queue.drain(ticket.n_events)
        finally:
            # Release exactly this launch's event segment.  Every launch
            # binds to THIS worker's queue and tickets retire oldest-first,
            # so the segment at the queue head is this ticket's own — even
            # when the graph itself is a cached entry shared with sibling
            # workers.  The release MUST run even when the wait raises — the
            # ticket is already popped, and skipping the segment release
            # would permanently skew this lane's per-queue accounting.
            self.queue.release_events(upto=ticket.n_events)
            ticket.t_done = self.clock()
            if self.tracer is not None:
                self.tracer.instant(
                    f"lane:{self.name}", ticket.t_done, "retire",
                    n_requests=ticket.batch.n_requests,
                    n_events=ticket.n_events)
        return ticket

    def drain(self) -> List[LaunchTicket]:
        """Retire every outstanding ticket (oldest first)."""
        out = []
        while self._inflight:
            out.append(self._retire_oldest())
        return out

    def modeled_s_per_request(self) -> Optional[float]:
        """Modeled seconds per served request, or ``None`` before any
        modeled launch completed (unprofiled queues, cold workers)."""
        if self.n_requests <= 0 or self.modeled_s <= 0.0:
            return None
        return self.modeled_s / self.n_requests

    def stats(self) -> "QueueStats":
        return QueueStats(
            name=self.name, config=self.apu.egpu.config.name,
            batches=self.n_batches, requests=self.n_requests,
            modeled_s=self.modeled_s, energy_j=self.energy_j,
            peak_in_flight=self.peak_in_flight,
            backpressure_stalls=self.backpressure_stalls,
            launch_failures=self.launch_failures,
            idle_power_w=self.idle_power_w,
            budget_violations=self.budget_violations)


@dataclasses.dataclass(frozen=True)
class QueueStats:
    """Per-queue roll-up surfaced in the :class:`ServeReport`."""

    name: str
    config: str
    batches: int
    requests: int
    modeled_s: float
    energy_j: float
    peak_in_flight: int
    backpressure_stalls: int
    #: mesh lane width: total devices this worker's launches span (1 for a
    #: single-device QueueWorker, the only kind this package has yet)
    shards: int = 1
    #: the worker's mesh layout as ((axis, size), ...); () when unsharded
    mesh_axes: Tuple[Tuple[str, int], ...] = ()
    #: mean per-launch utilization of each mesh axis; () when unsharded
    mesh_utilization: Tuple[Tuple[str, float], ...] = ()
    #: injected faults this lane absorbed (fault plans)
    launch_failures: int = 0
    #: this lane's circuit-breaker state at report time
    breaker_state: str = "closed"
    #: times this lane's breaker tripped OPEN (quarantines)
    breaker_trips: int = 0
    #: clock-gated leakage floor of this lane, watts — the serve
    #: report integrates it over the lane's idle modeled time
    idle_power_w: float = 0.0
    #: launches whose booked window-average power broke the lane cap
    #: (stays 0 while the dispatcher enforces the budget)
    budget_violations: int = 0

    def publish_metrics(self, registry) -> None:
        """Publish this lane's totals into a
        :class:`~repro_torch.obs.MetricsRegistry` under ``lane=<name>``
        labels (snapshot style, idempotent — see
        :mod:`repro_torch.obs.metrics`)."""
        labels = dict(lane=self.name, config=self.config)
        c = registry.counter
        c("repro_lane_batches_total",
          "micro-batches launched per lane").set_total(self.batches, **labels)
        c("repro_lane_requests_total",
          "requests served per lane").set_total(self.requests, **labels)
        c("repro_lane_launch_failures_total",
          "injected faults absorbed per lane").set_total(
            self.launch_failures, **labels)
        c("repro_lane_breaker_trips_total",
          "circuit-breaker trips per lane").set_total(
            self.breaker_trips, **labels)
        c("repro_lane_backpressure_stalls_total",
          "launches that first retired a ticket").set_total(
            self.backpressure_stalls, **labels)
        g = registry.gauge
        g("repro_lane_modeled_seconds",
          "modeled seconds served per lane").set(self.modeled_s, **labels)
        g("repro_lane_energy_joules",
          "modeled energy per lane").set(self.energy_j, **labels)
        g("repro_lane_peak_in_flight",
          "peak in-flight depth per lane").set(self.peak_in_flight, **labels)
        g("repro_lane_breaker_open",
          "1 when the lane's breaker is OPEN").set(
            1.0 if self.breaker_state == "open" else 0.0, **labels)
        g("repro_lane_idle_power_watts",
          "clock-gated leakage floor per lane").set(
            self.idle_power_w, **labels)
        c("repro_lane_budget_violations_total",
          "launches booked over the lane power cap").set_total(
            self.budget_violations, **labels)


class CircuitBreaker:
    """Per-lane quarantine with half-open recovery probes.

    CLOSED lanes route normally.  ``failure_threshold`` *consecutive*
    failures trip the breaker OPEN: routing skips the lane for ``cooldown``
    dispatcher ticks (dispatch calls, not wall time — deterministic under
    virtual clocks).  After the cooldown the breaker goes HALF-OPEN and
    admits exactly one probe launch: success closes it, failure re-opens
    it for another cooldown.  A failure while half-open always re-trips
    (one strike), the classic breaker asymmetry.
    """

    def __init__(self, failure_threshold: int = 3, cooldown: int = 8):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if cooldown < 1:
            raise ValueError("cooldown must be >= 1")
        self.failure_threshold = failure_threshold
        self.cooldown = cooldown
        self.state = "closed"
        self.consecutive_failures = 0
        self.opened_at_tick = 0
        self.trips = 0
        self._probe_in_flight = False

    def available(self, tick: int) -> bool:
        """May this lane take traffic at dispatcher tick ``tick``?  (Also
        performs the OPEN -> HALF-OPEN transition once the cooldown
        elapses.)"""
        if self.state == "open" and \
                tick - self.opened_at_tick >= self.cooldown:
            self.state = "half-open"
            self._probe_in_flight = False
        if self.state == "closed":
            return True
        return self.state == "half-open" and not self._probe_in_flight

    def on_attempt(self) -> None:
        if self.state == "half-open":
            self._probe_in_flight = True

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self.state = "closed"
        self._probe_in_flight = False

    def record_failure(self, tick: int) -> None:
        self.consecutive_failures += 1
        if (self.state == "half-open"
                or self.consecutive_failures >= self.failure_threshold):
            self.state = "open"
            self.opened_at_tick = tick
            self.trips += 1
            self.consecutive_failures = 0
            self._probe_in_flight = False


class MultiQueueDispatcher:
    """Route micro-batches to the least-loaded *available* worker.

    "Least loaded" is in-flight depth first; depth ties break on **modeled
    seconds per request** — the machine model's view of each lane's speed —
    so a faster / wider lane (a 16-thread config) genuinely attracts more
    traffic.  Tie-breaking on raw requests served would permanently bias
    heterogeneous mixes: a fast worker that served one extra warmup batch
    would lose every subsequent tie to a slower sibling at equal depth.
    Workers with no model data yet (cold) fall back to requests served, and
    are preferred at equal depth so every lane bootstraps its model quickly.

    Fault tolerance: :meth:`dispatch` is the retrying front —
    an :class:`InjectedFault` reroutes the micro-batch to a different lane
    under capped exponential backoff; per-lane :class:`CircuitBreaker`\\ s
    quarantine lanes that fail ``failure_threshold`` times in a row and
    re-admit them via half-open probes after ``breaker_cooldown`` dispatch
    ticks.  A batch that exhausts every retry raises
    :class:`DispatchError` so the server can shed it loudly.

    Power budgets: built with ``budget=``\\
    :class:`~repro_torch.serve.power.PowerBudget`, routing switches to
    :meth:`_pick_powered` — every candidate lane is priced (modeled
    latency, window-average power over the launch window), over-cap lanes
    are throttled, budget-eligible ones compete on requests-per-joule, and
    a batch no lane can take on-budget raises :class:`PowerBudgetError`
    (a :class:`DispatchError`, so the server's loud-shed path applies).
    All pricing is on the modeled virtual timeline — deterministic, never
    wall clock.
    """

    def __init__(self, workers: Sequence[QueueWorker],
                 failure_threshold: int = 3, breaker_cooldown: int = 8,
                 max_attempts: Optional[int] = None,
                 backoff_base_s: float = 0.001,
                 backoff_cap_s: float = 0.05,
                 tracer: Optional[Tracer] = None,
                 budget: Optional[PowerBudget] = None):
        if not workers:
            raise ValueError("need at least one QueueWorker")
        names = [w.name for w in workers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate worker names: {names}")
        if max_attempts is not None and max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.workers = list(workers)
        self.breakers = {w.name: CircuitBreaker(failure_threshold,
                                                breaker_cooldown)
                         for w in workers}
        self.max_attempts = max_attempts
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        #: opt-in span tracer; guarded at every hook
        self.tracer = tracer
        #: fleet power budget; ``None`` keeps the latency-greedy routing
        #: with zero pricing overhead
        self.budget = budget
        if budget is not None:
            for w in self.workers:
                w.power_budget = budget
        self._tick = 0                   # dispatch calls (breaker clock)
        self.retries = 0                 # failed attempts that were rerouted
        self.dispatch_failures = 0       # batches that exhausted every retry
        self.power_throttles = 0         # lane candidates skipped for power
        self.power_sheds = 0             # batches no lane could take on-budget
        self.peak_fleet_power_w = 0.0    # max modeled fleet draw sampled

    @staticmethod
    def _route_key(w: QueueWorker) -> Tuple[float, int, float, int]:
        spr = w.modeled_s_per_request()
        if spr is None:                  # no model data yet: fall back to
            return (w.depth, 0, float(w.n_requests), w.n_requests)
        # final n_requests entry keeps equal-speed (homogeneous) lanes
        # alternating instead of resolving every exact spr tie to the
        # first worker in declaration order
        return (w.depth, 1, spr, w.n_requests)

    def available_workers(self) -> List[QueueWorker]:
        """Lanes routing may use right now: breaker CLOSED, or HALF-OPEN
        with a free probe slot.  Falls back to the whole fleet when every
        breaker is open — the dispatcher degrades to forced probes rather
        than refusing service outright."""
        avail = [w for w in self.workers
                 if self.breakers[w.name].available(self._tick)]
        return avail or list(self.workers)

    def pick(self, exclude: Sequence[str] = ()) -> QueueWorker:
        """The worker the next micro-batch should go to (see class doc).
        ``exclude`` names lanes that already failed this batch — they are
        only reconsidered when no other lane is left."""
        excluded: Set[str] = set(exclude)
        candidates = [w for w in self.available_workers()
                      if w.name not in excluded]
        if not candidates:
            candidates = [w for w in self.workers if w.name not in excluded]
        if not candidates:
            candidates = self.workers
        return min(candidates, key=self._route_key)

    # -- power-aware routing -------------------------------------------------
    def fleet_power_w(self, t_now: float) -> float:
        """Modeled instantaneous fleet draw: busy lanes at their remaining
        window-average power, idle lanes at their clock-gated leakage
        floor."""
        return sum(w.current_power_w(t_now) for w in self.workers)

    def _pick_powered(self, batch: MicroBatch,
                      estimator: Callable[[QueueWorker],
                                          Tuple[Optional[PhaseBreakdown],
                                                float]],
                      t_now: float,
                      exclude: Sequence[str]) -> Optional[QueueWorker]:
        """Budget-aware routing: price every candidate lane — (modeled
        latency, window-average power) — and return the best
        requests-per-joule among budget-eligible ones, breaking ties on
        the shorter window and then the classic depth route key.  Lanes
        whose window price breaks the lane cap, or would push the modeled
        fleet draw over the fleet cap, are throttled (skipped and
        counted).  Returns ``None`` when no candidate can take the batch
        on-budget — the caller sheds loudly."""
        excluded: Set[str] = set(exclude)
        candidates = [w for w in self.available_workers()
                      if w.name not in excluded]
        if not candidates:
            candidates = [w for w in self.workers if w.name not in excluded]
        if not candidates:
            candidates = self.workers
        fleet_now = self.fleet_power_w(t_now)
        best, best_key = None, None
        for w in candidates:
            fused, energy = estimator(w)
            price = w.price(fused, energy, t_now,
                            n_requests=batch.n_requests)
            fleet_with = (fleet_now - w.current_power_w(t_now)
                          + price.avg_power_w)
            if not (self.budget.lane_ok(price.avg_power_w)
                    and self.budget.fleet_ok(fleet_with)):
                self.power_throttles += 1
                if self.tracer is not None:
                    self.tracer.instant(
                        f"lane:{w.name}", t_now, "power-throttle",
                        avg_power_w=price.avg_power_w,
                        fleet_power_w=fleet_with)
                continue
            key = (-price.requests_per_joule, price.window_s,
                   self._route_key(w))
            if best is None or key < best_key:
                best, best_key = w, key
        return best

    def dispatch(self, batch: MicroBatch,
                 graph_for: Callable[[QueueWorker], CommandGraph],
                 t_now: Optional[float] = None,
                 estimate_for: Optional[
                     Callable[[QueueWorker],
                              Tuple[Optional[PhaseBreakdown], float]]] = None
                 ) -> Tuple[LaunchTicket, List[LaunchTicket]]:
        """Launch ``batch`` with retry + quarantine (the fault-tolerant
        front the server uses).

        ``graph_for(worker)`` supplies the worker's cached graph (graphs
        are per config and device, so the cache lookup happens per attempt).
        With a :class:`PowerBudget` installed, ``estimate_for(worker)``
        (defaulting to ``worker.estimate(graph_for(worker))``) supplies
        the pricing view and routing goes through :meth:`_pick_powered`;
        a batch no lane can take on-budget raises
        :class:`PowerBudgetError`.  Returns the successful ticket plus
        every ticket retired for backpressure along the way — including
        by failed attempts.  Raises :class:`DispatchError` (carrying
        those retired tickets) when the attempt budget is exhausted.
        """
        self._tick += 1
        cap = (self.max_attempts if self.max_attempts is not None
               else 2 * len(self.workers))
        retired_all: List[LaunchTicket] = []
        tried: Set[str] = set()
        last: Optional[InjectedFault] = None
        for attempt in range(cap):
            if self.budget is None:
                worker = self.pick(exclude=tried)
            else:
                t_ref = (t_now if t_now is not None
                         else self.workers[0].clock())
                est = (estimate_for if estimate_for is not None
                       else lambda w: w.estimate(graph_for(w)))
                picked = self._pick_powered(batch, est, t_ref, tried)
                if picked is None:
                    self.power_sheds += 1
                    fleet_mw = self.fleet_power_w(t_ref) * 1e3
                    if self.tracer is not None:
                        for req in batch.requests:
                            self.tracer.request_event(
                                req.rid, t_ref, "power-shed",
                                fleet_power_mw=fleet_mw)
                    raise PowerBudgetError(
                        f"power budget (lane {self.budget.lane_mw} mW, "
                        f"fleet {self.budget.fleet_mw} mW) leaves no lane "
                        f"for a micro-batch of {batch.n_requests} "
                        f"request(s): modeled fleet draw {fleet_mw:.2f} mW",
                        retired=retired_all)
                worker = picked
            breaker = self.breakers[worker.name]
            breaker.on_attempt()
            if self.tracer is not None:
                t_evt = t_now if t_now is not None else worker.clock()
                for req in batch.requests:
                    self.tracer.request_event(
                        req.rid, t_evt, "dispatch-pick", lane=worker.name,
                        attempt=attempt)
            try:
                ticket, retired = worker.launch(graph_for(worker), batch,
                                                t_now=t_now)
            except InjectedFault as e:
                retired_all.extend(e.retired)
                trips_before = breaker.trips
                breaker.record_failure(self._tick)
                tried.add(worker.name)
                if len(tried) >= len(self.workers):
                    tried.clear()        # second pass over the fleet
                last = e
                will_retry = attempt + 1 < cap
                if self.tracer is not None:
                    t_evt = t_now if t_now is not None else worker.clock()
                    if breaker.trips > trips_before:
                        self.tracer.instant(f"lane:{worker.name}", t_evt,
                                            "breaker-trip",
                                            cooldown=breaker.cooldown)
                    for req in batch.requests:
                        self.tracer.request_event(
                            req.rid, t_evt, "fault", lane=worker.name,
                            launch_idx=e.launch_idx, reason=e.reason)
                        if breaker.trips > trips_before:
                            self.tracer.request_event(
                                req.rid, t_evt, "breaker-trip",
                                lane=worker.name)
                        if will_retry:
                            self.tracer.request_event(
                                req.rid, t_evt, "retry", attempt=attempt)
                if will_retry:
                    self.retries += 1
                    if self.backoff_base_s > 0.0:
                        backoff_s = min(self.backoff_cap_s,
                                        self.backoff_base_s * (2 ** attempt))
                        if self.tracer is not None:
                            for req in batch.requests:
                                self.tracer.request_event(
                                    req.rid, t_evt, "backoff",
                                    backoff_s=backoff_s)
                        time.sleep(backoff_s)
                continue
            breaker.record_success()
            retired_all.extend(retired)
            if self.budget is not None:
                # sample the modeled fleet draw with the new launch booked
                t_ref = t_now if t_now is not None else worker.clock()
                self.peak_fleet_power_w = max(self.peak_fleet_power_w,
                                              self.fleet_power_w(t_ref))
            return ticket, retired_all
        self.dispatch_failures += 1
        raise DispatchError(
            f"micro-batch of {batch.n_requests} request(s) failed all "
            f"{cap} dispatch attempts (last: {last})",
            retired=retired_all) from last

    def quarantines(self) -> int:
        """Total circuit-breaker trips across the fleet."""
        return sum(b.trips for b in self.breakers.values())

    def drain_all(self) -> List[LaunchTicket]:
        out: List[LaunchTicket] = []
        for w in self.workers:
            out.extend(w.drain())
        return out

    def stats(self) -> Tuple[QueueStats, ...]:
        out = []
        for w in self.workers:
            b = self.breakers[w.name]
            out.append(dataclasses.replace(
                w.stats(), breaker_state=b.state, breaker_trips=b.trips))
        return tuple(out)
