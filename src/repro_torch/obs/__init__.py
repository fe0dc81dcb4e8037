"""repro_torch.obs — end-to-end observability: spans, traces, metrics.

The machine model already knows where every modeled nanosecond of a
request goes; this package makes that knowledge inspectable.  Three
pieces:

* :class:`Tracer` / :class:`Span` — per-request span trees with explicit
  parent links, recorded on the *modeled virtual clock* (the same injected
  clock + per-lane ``modeled_busy_until`` discipline as the goodput
  gates), so traces are deterministic and assertable;
* :meth:`Tracer.to_chrome_json` — a Perfetto/Chrome-trace exporter:
  request trees and per-lane launch slices (sized by each node's captured
  :class:`~repro_torch.core.machine.PhaseBreakdown`, laid out along the DAG
  critical path so concurrent branches visibly overlap);
* :class:`MetricsRegistry` with :class:`Counter` / :class:`Gauge` /
  :class:`Histogram` — the unified telemetry registry the serving
  counters publish into, dumping as :meth:`MetricsRegistry.snapshot` or
  Prometheus text.

Tracing is opt-in and zero-overhead-when-off: ``Server(tracer=...)`` and
``CommandQueue(tracer=...)`` take a tracer explicitly, every hook guards
on ``tracer is not None``, and telemetry never perturbs modeled totals,
goodput, or outputs (the traced benchmark arms assert bit-identity).

Worked example — tracing one request from submit to result::

    import torch
    from repro_torch.core import EGPU_16T, Kernel, Stage
    from repro_torch.obs import Tracer
    from repro_torch.serve import Server

    class VClock:                      # the bench-style virtual clock
        t = 0.0
        def __call__(self):
            return self.t

    k = Kernel("scale", executor=lambda x: (x * 2.0,))
    clk, tracer = VClock(), Tracer()
    srv = Server([Stage(k, n_inputs=1)], workers=(EGPU_16T,),
                 bucket_sizes=(8,), max_batch=1, clock=clk, tracer=tracer,
                 device="cpu")
    rid = srv.submit(torch.ones(4, 4))          # max_batch=1: launches now
    srv.flush()
    (out,) = srv.result(rid)

    root = tracer.request_root(rid)             # the rid's span tree:
    for s in tracer.children(root):             #   admission   [t0, t0]
        print(s.name, s.t0, s.t1)               #   bucket-wait [t0, t_launch]
                                                #   dispatch    [t_launch, t_x]
                                                #   execute     [t_x, t_done]
                                                #   result      [t_done, t_done]
    assert tracer.validate_request_trees() == []
    tracer.to_chrome_json("trace.json")         # open in ui.perfetto.dev

The serving stack emits spans at every hop — submit, admission,
bucket-wait, deadline-flush, dispatch-pick, retry/backoff, launch,
per-stage kernel+transfer execution, retire, result — with fault
injections, breaker trips, shed decisions, and cache hits/misses attached
as span events.  :meth:`Tracer.validate_request_trees` pins the
completeness contract: every accepted rid's tree closes with exactly one
terminal span (``result`` or a named ``shed``).

Power telemetry: serving under a
:class:`~repro_torch.serve.PowerBudget` lands in the same channels — the
dispatcher emits a ``power-throttle`` track instant for every candidate
lane skipped over a budget breach and a ``power-shed`` request event on
every rid shed because no lane had headroom, while
``ServeReport.publish_metrics`` adds the fleet power series
(``repro_fleet_avg_power_watts``, ``repro_fleet_peak_power_watts``,
``repro_fleet_energy_joules`` / ``repro_fleet_idle_energy_joules``,
``repro_serve_requests_per_second_per_watt``,
``repro_serve_goodput_per_second_per_watt``) and the enforcement
counters (``repro_serve_power_shed_total``,
``repro_serve_power_throttled_total``,
``repro_serve_budget_violations_total`` — the last must read 0) plus
per-lane ``repro_lane_idle_power_watts`` /
``repro_lane_budget_violations_total``.
"""

from .metrics import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .trace import (TERMINAL_SPANS, Span, Tracer, validate_chrome_trace)

__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "TERMINAL_SPANS",
    "Tracer",
    "validate_chrome_trace",
]
