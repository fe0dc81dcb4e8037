"""Unified telemetry registry: Counter / Gauge / Histogram with label sets.

Every layer of the serving stack keeps counters (``GraphCache`` hit/miss,
``QueueStats`` per-lane totals, ``FaultPlan`` injections, the
``ServeReport`` roll-up).  The registry gives them one place to publish:
metrics are named, typed, carry label sets (``lane="0:e-gpu-16t"``), and
dump as either a nested :meth:`MetricsRegistry.snapshot` dict or a
Prometheus text exposition (:meth:`MetricsRegistry.to_prometheus_text`).

Two publishing styles coexist:

* **live instruments** — call :meth:`Counter.inc` / :meth:`Gauge.set` /
  :meth:`Histogram.observe` at the event site;
* **snapshot publishers** — sources that already keep their own monotonic
  totals (the serving counters) write them with :meth:`Counter.set_total`,
  which is idempotent: re-publishing the same totals never double-counts.
  ``GraphCache.publish_metrics``, ``FaultPlan.publish_metrics``,
  ``QueueStats.publish_metrics`` and ``ServeReport.publish_metrics`` all
  use this style, and ``Server.publish_metrics(registry)`` drives the
  whole stack in one call.

Telemetry is observational only: publishing reads totals the stack already
keeps and never perturbs modeled time, energy, or outputs.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default histogram buckets (seconds-flavored, microseconds to seconds)
DEFAULT_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: LabelKey) -> str:
    if not key:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + body + "}"


class _Metric:
    """Shared naming/label plumbing for the three instrument types."""

    type_name = "untyped"

    def __init__(self, name: str, help: str = ""):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self._series: Dict[LabelKey, Any] = {}

    def labels(self) -> List[LabelKey]:
        return sorted(self._series)


class Counter(_Metric):
    """Monotonically non-decreasing count (per label set)."""

    type_name = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (inc by {amount})")
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + amount

    def set_total(self, total: float, **labels: Any) -> None:
        """Publish an externally-kept monotonic total (idempotent — the
        snapshot-publisher style).  Decreasing an already-published total
        is loud: that is a broken source, not a restart we can infer."""
        key = _label_key(labels)
        if total < self._series.get(key, 0.0):
            raise ValueError(
                f"counter {self.name}{_fmt_labels(key)} cannot decrease "
                f"from {self._series[key]} to {total}")
        self._series[key] = float(total)

    def value(self, **labels: Any) -> float:
        return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    """A value that can go anywhere (per label set)."""

    type_name = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        self._series[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        return float(self._series.get(_label_key(labels), 0.0))


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics) per label set."""

    type_name = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        ordered = tuple(sorted(float(b) for b in buckets))
        if not ordered or any(not math.isfinite(b) for b in ordered):
            raise ValueError(f"buckets must be finite and non-empty, "
                             f"got {buckets}")
        self.buckets = ordered

    def _cell(self, key: LabelKey) -> Dict[str, Any]:
        cell = self._series.get(key)
        if cell is None:
            cell = {"bucket_counts": [0] * len(self.buckets),
                    "count": 0, "sum": 0.0, "max": float("-inf")}
            self._series[key] = cell
        return cell

    def observe(self, value: float, **labels: Any) -> None:
        cell = self._cell(_label_key(labels))
        for i, le in enumerate(self.buckets):
            if value <= le:
                cell["bucket_counts"][i] += 1
        cell["count"] += 1
        cell["sum"] += float(value)
        cell["max"] = max(cell["max"], float(value))

    def value(self, **labels: Any) -> Dict[str, Any]:
        cell = self._cell(_label_key(labels))
        return {"count": cell["count"], "sum": cell["sum"],
                "buckets": dict(zip(self.buckets, cell["bucket_counts"]))}

    def quantile(self, q: float, **labels: Any) -> float:
        """Bucket-resolution quantile estimate (upper bound of the first
        bucket covering the target rank, clamped to the observed max)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        cell = self._cell(_label_key(labels))
        if cell["count"] == 0:
            return 0.0
        target = q * cell["count"]
        for le, cum in zip(self.buckets, cell["bucket_counts"]):
            if cum >= target:
                return min(le, cell["max"])
        return cell["max"]


class MetricsRegistry:
    """Named, typed metrics with get-or-create registration.

    Re-registering a name returns the existing instrument (so independent
    publishers can share a series); re-registering under a *different*
    type is loud.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       **kwargs: Any) -> _Metric:
        existing = self._metrics.get(name)
        if existing is not None:
            if not isinstance(existing, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{existing.type_name}, not {cls.type_name}")
            return existing
        metric = cls(name, help, **kwargs)
        self._metrics[name] = metric
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def __iter__(self) -> Iterable[_Metric]:
        return iter(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dump: name -> {type, help, samples: [{labels, value}]}."""
        out: Dict[str, Any] = {}
        for name, m in sorted(self._metrics.items()):
            samples = []
            for key in m.labels():
                value = (m.value(**dict(key)) if not isinstance(m, Histogram)
                         else m.value(**dict(key)))
                samples.append({"labels": dict(key), "value": value})
            out[name] = {"type": m.type_name, "help": m.help,
                         "samples": samples}
        return out

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.type_name}")
            if isinstance(m, Histogram):
                for key in m.labels():
                    cell = m._series[key]
                    cum_pairs = list(zip(m.buckets, cell["bucket_counts"]))
                    for le, cum in cum_pairs:
                        k = key + (("le", repr(le)),)
                        lines.append(
                            f"{name}_bucket{_fmt_labels(k)} {cum}")
                    k = key + (("le", "+Inf"),)
                    lines.append(
                        f"{name}_bucket{_fmt_labels(k)} {cell['count']}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(key)} {cell['sum']}")
                    lines.append(
                        f"{name}_count{_fmt_labels(key)} {cell['count']}")
            else:
                for key in m.labels():
                    lines.append(
                        f"{name}{_fmt_labels(key)} {m._series[key]}")
        return "\n".join(lines) + ("\n" if lines else "")
