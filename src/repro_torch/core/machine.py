"""Analytic machine model of the e-GPU and its X-HEEP host (paper §VII-C).

The paper evaluates post-synthesis netlists we do not have; what we *can*
reproduce faithfully is the structural performance model implied by the
microarchitecture description (§IV) and calibrate its handful of free
constants against the subset of published numbers, then validate against the
rest.  Structure:

* an e-GPU executes ``ops`` over ``lanes = CUs x threads`` processing
  elements; ``warps`` hide the 4-cycle D$ latency (4 warps -> 1 access/cycle,
  §VII-A), fewer warps stall the pipeline;
* the shared D$ supplies ``banks x 4`` bytes/cycle; kernels are
  ``max(compute, memory)``-bound;
* SIMT divergence serializes masked paths (delineation);
* inter-stage barriers drain the warp pipeline (Stockham FFT);
* host<->D$ traffic moves at 4 B/cycle over the OBI port (§VIII-B), partially
  overlapped with compute via line prefetch (longer lines -> more overlap);
* the Tiny-OpenCL startup+scheduling overhead comes from `core.scheduler`;
* the host is a single-issue scalar RISC-V with DSP extensions (RI5CY) and
  single-cycle SRAM.

All calibration constants live in :data:`CAL` and are documented there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from .device import EGPUConfig, HOST
from .ndrange import NDRange
from .scheduler import schedule

# ---------------------------------------------------------------------------
# Calibration constants (fitted once against paper Figs 3/4; the JAX
# package's paper-validation tests pin the ranges they must reproduce).
# ---------------------------------------------------------------------------
CAL: Dict[str, float] = {
    "HOST_CPI": 1.05,          # RI5CY w/ DSP ext: ~1 op/cycle incl. post-inc loads
    "EGPU_CPI": 1.0,           # per-lane issue rate with full warp occupancy
    "DIV_PENALTY": 0.25,       # serialization cost multiplier for divergent ops
    "BARRIER_BASE": 28.0,      # cycles: barrier entry + warp re-activation
    "CAPACITY_FACTOR": 2.7,    # host-traffic inflation when WS > D$ (fits Fig 3)
    "OVERLAP_PER_LINE_B": 0.009,  # transfer/compute overlap gained per line byte
    "OVERLAP_MAX": 0.45,       # cap on hidden transfer fraction
    "HOST_MEM_BPC": 4.0,       # host SRAM bytes/cycle
}


@dataclasses.dataclass(frozen=True)
class WorkCounts:
    """Structural work of one kernel execution (derived analytically from the
    problem size by each kernel's ``counts()`` in ``repro_torch.kernels.*.ref``)."""

    ops: float                 # scalar ALU/MAC operations (MAC = 1 op)
    dcache_bytes: float        # core <-> D$ traffic (loads + stores)
    host_bytes: float          # compulsory unique bytes moved host <-> D$
    working_set: float         # bytes that must stay resident for full reuse
    barriers: int = 0          # pipeline-wide synchronization points
    divergence: float = 0.0    # fraction of ops under divergent control flow

    def scaled(self, k: float) -> "WorkCounts":
        return dataclasses.replace(
            self, ops=self.ops * k, dcache_bytes=self.dcache_bytes * k,
            host_bytes=self.host_bytes * k, working_set=self.working_set * k)


@dataclasses.dataclass(frozen=True)
class PhaseBreakdown:
    """Cycles per execution phase (the paper's Fig 3 decomposition)."""

    startup: float
    scheduling: float
    transfer: float            # exposed (non-overlapped) host<->D$ transfer
    compute: float             # max(compute, D$-bandwidth) + divergence + barriers
    freq_hz: float

    @property
    def total_cycles(self) -> float:
        return self.startup + self.scheduling + self.transfer + self.compute

    @property
    def total_s(self) -> float:
        return self.total_cycles / self.freq_hz

    def scaled(self, k: float) -> "PhaseBreakdown":
        """Uniformly scale every phase by ``k`` (same frequency).

        The serving layer uses ``scaled(1 / batch)`` for a request's share
        of a batched fused launch: the batch pays startup + scheduling once,
        and each of its ``batch`` requests owns an equal slice of the chain
        (energy-per-request and amortized-latency accounting).
        """
        return dataclasses.replace(
            self, startup=self.startup * k, scheduling=self.scheduling * k,
            transfer=self.transfer * k, compute=self.compute * k)

    @property
    def transfer_fraction(self) -> float:
        return self.transfer / self.total_cycles

    @property
    def scheduling_fraction(self) -> float:
        return (self.startup + self.scheduling) / self.total_cycles

    def as_dict(self) -> Dict[str, float]:
        return {
            "startup_cycles": self.startup,
            "scheduling_cycles": self.scheduling,
            "transfer_cycles": self.transfer,
            "compute_cycles": self.compute,
            "total_cycles": self.total_cycles,
            "total_s": self.total_s,
        }


def egpu_time(config: EGPUConfig, counts: WorkCounts, ndr: NDRange) -> PhaseBreakdown:
    """Execution-time model for one kernel launch on an e-GPU config."""
    sched = schedule(ndr, config)
    lanes = config.parallel_lanes

    # --- core: compute vs D$ bandwidth, whichever binds -------------------
    warp_stall = max(1.0, config.dcache_latency_cycles / config.warps_per_cu)
    # Divergent regions execute both sides of each branch under a thread mask
    # (§VIII-C): the serialization multiplier is width-independent because the
    # masked path runs on every lane either way.
    div = 1.0 + counts.divergence * CAL["DIV_PENALTY"]
    compute = counts.ops / lanes * CAL["EGPU_CPI"] * warp_stall * div
    compute /= max(sched.occupancy, 1e-9)
    # line-interleaved multi-bank D$: one full line per CU per cycle when
    # threads access sequential words (§VII-A "a single cache line fetch
    # suffices"); line = T x 4B, so bandwidth scales with the thread knob.
    dcache_bpc = config.dcache_line_bytes * config.compute_units
    mem = counts.dcache_bytes / dcache_bpc
    core = max(compute, mem)

    # --- barriers: drain the warp pipeline, re-fill after ------------------
    barrier = counts.barriers * (
        CAL["BARRIER_BASE"]
        + config.warps_per_cu * config.dcache_latency_cycles)

    # --- host <-> D$ transfer ----------------------------------------------
    traffic = counts.host_bytes
    if counts.working_set > config.dcache_bytes:
        traffic *= CAL["CAPACITY_FACTOR"]
    raw_transfer = traffic / config.host_bus_bytes_per_cycle
    overlap = min(CAL["OVERLAP_MAX"],
                  CAL["OVERLAP_PER_LINE_B"] * config.dcache_line_bytes)
    transfer = raw_transfer * (1.0 - overlap)

    return PhaseBreakdown(
        startup=float(sched.startup_cycles),
        scheduling=float(sched.scheduling_cycles),
        transfer=transfer,
        compute=core + barrier,
        freq_hz=config.freq_hz,
    )


def transfer_time(config: EGPUConfig, nbytes: float) -> PhaseBreakdown:
    """Transfer-only breakdown of an *explicit* buffer command (host API v2).

    ``clEnqueueWriteBuffer`` / ``ReadBuffer`` / ``CopyBuffer`` analogues move
    ``nbytes`` over the host<->D$ bus at ``host_bus_bytes_per_cycle`` (the
    32-bit OBI port, paper §VIII-B).  Unlike the per-kernel ``host_bytes``
    heuristic in :func:`egpu_time`, an explicit transfer gets **no** prefetch
    overlap discount — it *is* the traffic, and hiding it behind compute is
    now the scheduler's job: transfer nodes are ordinary DAG nodes, so
    :func:`fuse_breakdowns`' critical-path mode overlaps them with compute
    on independent branches instead of baking a fixed overlap fraction into
    every kernel.  Startup/scheduling are zero: a DMA-style copy never
    enters the Tiny-OpenCL kernel scheduler.
    """
    if nbytes < 0:
        raise ValueError(f"transfer of negative size: {nbytes}")
    return PhaseBreakdown(
        startup=0.0, scheduling=0.0,
        transfer=float(nbytes) / config.host_bus_bytes_per_cycle,
        compute=0.0, freq_hz=config.freq_hz)


def host_time(counts: WorkCounts, config: EGPUConfig = HOST) -> PhaseBreakdown:
    """Execution-time model for the scalar X-HEEP host baseline.

    The host owns the unified memory, so there is no transfer phase; its
    SRAM is single-cycle so memory time folds into CPI except for streaming
    misses beyond its small D$.
    """
    compute = counts.ops * CAL["HOST_CPI"]
    mem = counts.host_bytes / CAL["HOST_MEM_BPC"]
    return PhaseBreakdown(
        startup=0.0, scheduling=0.0, transfer=0.0,
        compute=compute + mem, freq_hz=config.freq_hz)


def speedup(host: PhaseBreakdown, egpu: PhaseBreakdown) -> float:
    return host.total_s / egpu.total_s


def fuse_breakdowns(stages: "Sequence[PhaseBreakdown]",
                    deps: "Optional[Sequence[Sequence[int]]]" = None
                    ) -> PhaseBreakdown:
    """Model a fused (CommandGraph) launch of an already-costed kernel chain.

    The paper's §IV-B resident pipeline pays the Tiny-OpenCL startup +
    scheduling once per *chain*, not once per kernel: after the first launch
    the warps are active and the kernel-args region is hot, so subsequent
    stages chain without re-entering the scheduler.  Transfer and compute
    phases are work, not overhead.  This mirrors the TinyCL
    ``CommandGraph.launch`` path, which dispatches the whole chain as one
    launch.

    Two modes:

    * ``deps=None`` (chain): every stage is serially dependent — transfer
      and compute sum unchanged.
    * ``deps`` given (DAG critical path): ``deps[i]`` lists the indices of
      the stages node ``i`` waits on (an out-of-order queue's
      ``wait_events`` + dataflow edges, as captured by
      :class:`~repro_torch.core.runtime.CommandGraph`).  Fused latency is the
      longest dependency path — concurrent branches overlap instead of
      summing.  A ``None`` entry in ``stages`` (a node with no machine
      model) is a zero-cost pass-through on the path.

    In both modes stages may sit on devices with different clocks — host +
    e-GPU nodes in one capture, or e-GPU stages priced at different DVFS
    :class:`~repro_torch.core.device.OperatingPoint`\\ s: every phase is
    normalized per stage by *its own* ``freq_hz`` onto the fastest clock, so
    wall time is preserved exactly.  (Chain mode used to assume one
    config-default frequency and reject mixes — latent breakage once
    op-points landed; pinned by the mixed-op-point regression tests.)
    Startup + scheduling are paid once (the normalized max across stages);
    for a linear chain the two modes agree exactly.
    """
    if deps is None:
        stages = [s for s in stages if s is not None]
        if not stages:
            raise ValueError("fuse_breakdowns needs at least one PhaseBreakdown")
        freq = max(s.freq_hz for s in stages)
        # per-stage normalization onto the fastest clock; for a uniform-
        # frequency chain every scale is exactly 1.0, keeping the historical
        # numbers bit-identical
        return PhaseBreakdown(
            startup=max(s.startup * (freq / s.freq_hz) for s in stages),
            scheduling=max(s.scheduling * (freq / s.freq_hz) for s in stages),
            transfer=sum(s.transfer * (freq / s.freq_hz) for s in stages),
            compute=sum(s.compute * (freq / s.freq_hz) for s in stages),
            freq_hz=freq,
        )

    # --- DAG critical-path mode -------------------------------------------
    stages = list(stages)
    if len(deps) != len(stages):
        raise ValueError(
            f"deps must align with stages: {len(deps)} vs {len(stages)}")
    modeled = [s for s in stages if s is not None]
    if not modeled:
        raise ValueError("fuse_breakdowns needs at least one PhaseBreakdown")
    freq = max(s.freq_hz for s in modeled)
    n = len(stages)
    finish = [0.0] * n                    # seconds: node ready time
    path = [(0.0, 0.0)] * n               # (transfer, compute) ref-freq
                                          # cycles along the best path
    for i, (s, ds) in enumerate(zip(stages, deps)):
        best_s, best_path = 0.0, (0.0, 0.0)
        for d in ds:
            if not 0 <= d < i:
                raise ValueError(
                    f"node {i} depends on node {d}: deps must reference "
                    "earlier nodes (topological capture order)")
            if finish[d] > best_s:
                best_s, best_path = finish[d], path[d]
        if s is None:
            finish[i], path[i] = best_s, best_path
            continue
        scale = freq / s.freq_hz
        t, c = s.transfer * scale, s.compute * scale
        finish[i] = best_s + (t + c) / freq
        path[i] = (best_path[0] + t, best_path[1] + c)
    end = max(range(n), key=lambda i: finish[i])
    return PhaseBreakdown(
        startup=max(s.startup * freq / s.freq_hz for s in modeled),
        scheduling=max(s.scheduling * freq / s.freq_hz for s in modeled),
        transfer=path[end][0],
        compute=path[end][1],
        freq_hz=freq,
    )
