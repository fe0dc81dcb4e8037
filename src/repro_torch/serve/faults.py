"""Deterministic fault injection for the serving stack.

The robustness claim of the front door — bounded queues, bit-identical
retries, lanes that quarantine and recover — is only testable if failures
are *reproducible*.  A :class:`FaultPlan` is a pure function from
``(seed, lane name, launch index)`` to a :class:`FaultDecision`: the same
plan injects the same launch failures, latency spikes and lane blackouts
on every run, independent of dispatch order, Python hash salting or which
worker draws first.  Plans hook into
:meth:`repro_torch.serve.dispatch.QueueWorker._do_launch` via the worker's
``fault_plan`` and fire *before* the real launch, so an injected failure
can never corrupt outputs — a retried micro-batch replays the same pure
cached graph and stays bit-identical to the fault-free path.

Three fault classes (the three classes):

* **launch failures** — with probability ``p_launch_fail`` a launch raises
  :class:`InjectedFault` instead of running (a flaky lane);
* **latency spikes** — with probability ``p_latency_spike`` the launch
  succeeds but its modeled breakdown gains ``latency_spike_s`` of extra
  scheduling time (a contended lane; outputs untouched, energy untouched —
  a stall burns time, not work);
* **lane blackouts** — a :class:`Blackout` kills *every* launch of one
  lane over a contiguous launch-index window (a dead lane), independent of
  the seed, so recovery tests stay deterministic under the CI matrix leg's
  varying ``REPRO_FAULT_SEED``.

The CI fault leg sets ``REPRO_FAULT_SEED``; tests build their plans with
:func:`env_seed` so every PR exercises the injection machinery under a
fresh seed while local runs stay pinned to the default.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.machine import PhaseBreakdown

#: environment variable the CI fault-injection matrix leg sets; tests seed
#: their FaultPlans through :func:`env_seed` so the leg varies the draws
ENV_SEED = "REPRO_FAULT_SEED"


def env_seed(default: int = 0) -> int:
    """The fault seed from ``REPRO_FAULT_SEED``, else ``default``."""
    raw = os.environ.get(ENV_SEED)
    return default if raw in (None, "") else int(raw)


class InjectedFault(RuntimeError):
    """A launch killed by the active :class:`FaultPlan`.

    Raised from the worker's fault gate *before* any real work, so the
    dispatcher can retry the micro-batch on another lane with nothing to
    roll back.  ``retired`` carries any tickets the failing worker retired
    for backpressure before the fault fired — those launches were real and
    their results must still be finalized by the caller.
    """

    def __init__(self, msg: str, lane: Optional[str] = None,
                 launch_idx: Optional[int] = None, reason: str = ""):
        super().__init__(msg)
        self.lane = lane
        self.launch_idx = launch_idx
        self.reason = reason
        self.retired: Tuple = ()


@dataclasses.dataclass(frozen=True)
class FaultDecision:
    """What the plan does to one (lane, launch index) pair."""

    fail: bool = False
    reason: str = ""
    spike_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class Blackout:
    """Lane ``lane`` refuses every launch with index in
    ``[start, start + length)`` — a deterministic dead-lane window."""

    lane: str
    start: int
    length: int

    def covers(self, lane: str, launch_idx: int) -> bool:
        return (lane == self.lane
                and self.start <= launch_idx < self.start + self.length)


class FaultPlan:
    """A seeded, deterministic schedule of injected failures.

    ``draw(lane, launch_idx)`` is pure: the decision depends only on
    ``(seed, lane, launch_idx)`` (lane names hashed with CRC-32, never
    Python's salted ``hash``), so two runs of the same traffic see the
    same faults regardless of dispatch interleaving — the property the
    bit-identical-retry tests rely on.  Blackout windows are
    seed-independent by design: a recovery test that kills lane 2 for five
    launches stays meaningful when CI rotates ``REPRO_FAULT_SEED``.
    """

    def __init__(self, seed: int = 0, p_launch_fail: float = 0.0,
                 p_latency_spike: float = 0.0, latency_spike_s: float = 0.0,
                 blackouts: Sequence[Blackout] = ()):
        for name, p in (("p_launch_fail", p_launch_fail),
                        ("p_latency_spike", p_latency_spike)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if latency_spike_s < 0.0:
            raise ValueError(f"latency_spike_s must be >= 0, "
                             f"got {latency_spike_s}")
        self.seed = int(seed)
        self.p_launch_fail = float(p_launch_fail)
        self.p_latency_spike = float(p_latency_spike)
        self.latency_spike_s = float(latency_spike_s)
        self.blackouts = tuple(blackouts)
        # observability counters (shared across every worker on the plan)
        self.injected_failures = 0
        self.injected_spikes = 0

    def publish_metrics(self, registry) -> None:
        """Publish the plan's injection totals into a
        :class:`~repro_torch.obs.MetricsRegistry` (snapshot style, idempotent)."""
        c = registry.counter("repro_fault_injections_total",
                             "faults injected by the active FaultPlan")
        c.set_total(self.injected_failures, kind="failure",
                    seed=str(self.seed))
        c.set_total(self.injected_spikes, kind="spike", seed=str(self.seed))

    def draw(self, lane: str, launch_idx: int) -> FaultDecision:
        """The (deterministic) fate of launch ``launch_idx`` on ``lane``."""
        for b in self.blackouts:
            if b.covers(lane, launch_idx):
                self.injected_failures += 1
                return FaultDecision(
                    fail=True,
                    reason=f"lane blackout over launches "
                           f"[{b.start}, {b.start + b.length})")
        rng = np.random.default_rng(
            (self.seed, zlib.crc32(lane.encode()), launch_idx))
        u_fail, u_spike = rng.random(2)
        if u_fail < self.p_launch_fail:
            self.injected_failures += 1
            return FaultDecision(
                fail=True, reason=f"launch failure (p={self.p_launch_fail})")
        if self.latency_spike_s > 0.0 and u_spike < self.p_latency_spike:
            self.injected_spikes += 1
            return FaultDecision(spike_s=self.latency_spike_s)
        return FaultDecision()


def apply_spike(fused: Optional[PhaseBreakdown],
                spike_s: float) -> Optional[PhaseBreakdown]:
    """Fold an injected latency spike into a modeled breakdown.

    The spike is a scheduler stall: extra *scheduling* cycles at the
    chain's clock, no extra work — so modeled time (and hence deadline
    checks and latency percentiles) grow while modeled energy, which is
    total-work, stays put.
    """
    if fused is None or spike_s <= 0.0:
        return fused
    return dataclasses.replace(
        fused, scheduling=fused.scheduling + spike_s * fused.freq_hz)
