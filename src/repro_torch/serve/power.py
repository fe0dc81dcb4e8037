"""Power budgets for the serving fleet — power as a scheduling input.

The paper's headline is performance *inside an envelope*: 15.1x speed-up and
3.1x energy reduction within a <= 28 mW power budget (abstract, §VII-VIII),
with a power controller that clock-gates idle CUs (§IV).  This module makes
that envelope a first-class dispatch constraint: a
:class:`PowerBudget` caps the modeled **window-average power** of every lane
and of the whole fleet, the
:class:`~repro_torch.serve.dispatch.MultiQueueDispatcher` prices each candidate
lane (modeled latency, average power over the launch window) before routing,
prefers the best requests-per-joule among budget-eligible lanes, and a batch
no lane can carry under budget is shed *loudly* through the existing
:class:`~repro_torch.serve.server.AdmissionError` machinery — never silently
queued into a thermal lie.

Everything is priced on the machine model, never wall clock: a lane's window
for a candidate launch is ``backlog + service`` on its modeled timeline, its
average power is ``(remaining in-flight energy + launch energy) / window``,
and idle lanes draw their clock-gated leakage floor
(:func:`repro_torch.core.power.egpu_idle_power_mw`).  Budgets therefore compose
with DVFS operating points: re-basing a lane's config via
``config.at(point)`` changes both its modeled time and its modeled power, and
the dispatcher re-prices automatically.

Worked example — a 28 mW fleet (the paper's envelope):

    >>> from repro_torch.core import EGPU_16T, EGPU_8T
    >>> from repro_torch.core.power import egpu_active_power_mw
    >>> from repro_torch.serve import PowerBudget, Server
    >>> round(egpu_active_power_mw(EGPU_16T), 1)   # ~27 mW flat out
    27.1
    >>> budget = PowerBudget(lane_mw=28.0, fleet_mw=28.0)
    >>> srv = Server(stages, workers=(EGPU_16T, EGPU_8T),
    ...              power_budget=budget, clock=vclock)    # doctest: +SKIP

    With ``fleet_mw=28.0`` the two lanes *together* may never model more
    than 28 mW over their launch windows: the dispatcher fills the 16T lane
    (best requests-per-joule) until its window draw plus the 8T lane's
    leakage floor approaches the cap, throttles the second lane rather than
    exceed it, and sheds — with an :class:`AdmissionError` naming the budget
    — once no lane has headroom.  ``ServeReport`` then shows
    ``avg_fleet_power_w <= 0.028`` with zero ``n_budget_violations``: the
    envelope held by construction, not by luck.

Enforcement invariant: **no accepted request ever executes on a
lane whose window-average power exceeds its budget** — every
:meth:`~repro_torch.serve.dispatch.QueueWorker.launch` re-audits the window price
it actually booked, and the audit counter must stay 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class PowerBudget:
    """Power caps for the serving fleet, in milliwatts (the paper's unit).

    ``lane_mw`` bounds each lane's window-average power per launch;
    ``fleet_mw`` bounds the modeled instantaneous draw summed across all
    lanes (busy lanes at their window-average, idle lanes at their
    clock-gated leakage floor).  ``None`` leaves a dimension uncapped.
    """

    lane_mw: Optional[float] = None
    fleet_mw: Optional[float] = None

    def __post_init__(self) -> None:
        for field in ("lane_mw", "fleet_mw"):
            v = getattr(self, field)
            if v is not None and v <= 0.0:
                raise ValueError(f"{field} must be positive, got {v}")
        if self.lane_mw is None and self.fleet_mw is None:
            raise ValueError(
                "PowerBudget needs at least one of lane_mw / fleet_mw")

    @property
    def lane_w(self) -> Optional[float]:
        return None if self.lane_mw is None else self.lane_mw * 1e-3

    @property
    def fleet_w(self) -> Optional[float]:
        return None if self.fleet_mw is None else self.fleet_mw * 1e-3

    def lane_ok(self, avg_power_w: float) -> bool:
        """Is a lane window-average draw within the per-lane cap?"""
        return self.lane_w is None or avg_power_w <= self.lane_w

    def fleet_ok(self, fleet_power_w: float) -> bool:
        """Is a modeled fleet draw within the fleet-wide cap?"""
        return self.fleet_w is None or fleet_power_w <= self.fleet_w


@dataclasses.dataclass(frozen=True)
class LanePrice:
    """One candidate lane's price for one micro-batch launch.

    The dispatcher's routing currency: ``window_s`` is modeled
    latency including the lane's backlog, ``avg_power_w`` the window-average
    draw the launch would commit the lane to, and ``requests_per_joule`` the
    efficiency score budget-eligible lanes compete on.
    """

    lane: str
    #: modeled service time of the candidate launch alone (fused chain)
    modeled_s: float
    #: backlog + service on the lane's modeled timeline — what the batch
    #: would actually wait+run for
    window_s: float
    #: (remaining in-flight energy + launch energy) / window
    avg_power_w: float
    #: active energy of the candidate launch
    energy_j: float
    #: live requests per joule of total window energy — higher is better
    requests_per_joule: float
