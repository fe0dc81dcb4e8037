"""Span tracing on the modeled virtual clock.

A :class:`Tracer` records :class:`Span`\\ s — named intervals with explicit
parent links — on whatever clock the caller timestamps them with.  The
serving stack timestamps every span with the *modeled* virtual timeline
(the injected server clock plus each lane's ``modeled_busy_until``
machine-model schedule), so a trace is deterministic: two runs of the same
traffic produce byte-identical span trees, and CI can gate on their shape.

Tracing is strictly observational.  The tracer never touches modeled
totals, goodput, or outputs — it only *reads* timestamps the serving stack
already computes — and every integration point guards with
``if tracer is not None``, so a server built without a tracer allocates no
object from this module on its hot dispatch path.

Request trees
-------------

The serving layer (``Server(tracer=...)``) grows one span tree per accepted
request id, on the track ``rid:<rid>``::

    request                    [t_submit ........................ t_done]
      admission                [t_submit, t_submit]
      bucket-wait              [t_submit ......... t_launch]
      dispatch                 [t_launch ... exec_start]
      execute                  [exec_start ......... t_done]
      result | shed            [t_end, t_end]        <- exactly one terminal

with the mid-flight happenings — deadline flushes, dispatch picks, injected
faults, retries/backoff, breaker trips, cache hits/misses — attached to the
root as timestamped span *events*.  :meth:`Tracer.validate_request_trees`
checks the completeness contract: every accepted rid's tree is closed and
ends in exactly one terminal span named ``result`` or ``shed``.

Each dispatcher lane additionally gets a ``lane:<name>`` track holding one
``launch`` slice per micro-batch, decomposed into per-node kernel/transfer
slices sized by the captured :class:`~repro_torch.core.machine.PhaseBreakdown`
and laid out along the node DAG's critical-path schedule — concurrent
branches visibly overlap in the exported trace.

Export
------

:meth:`Tracer.to_chrome_json` writes the Chrome trace event format (the
``chrome://tracing`` / Perfetto JSON): spans become ``"ph": "X"`` complete
events (``ts``/``dur`` in microseconds of virtual time), span events become
``"ph": "i"`` instants, and tracks map to pid/tid pairs named via metadata
events.  :func:`validate_chrome_trace` is the schema gate CI runs on the
artifact: required keys, non-negative durations, monotonic timestamps per
track, and no orphan parent ids.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: span names that terminate a request tree (exactly one per accepted rid)
TERMINAL_SPANS = ("result", "shed")


@dataclasses.dataclass
class Span:
    """One named interval on a track, with an explicit parent link.

    ``t0``/``t1`` are seconds on the caller's (virtual) clock; ``t1`` is
    ``None`` while the span is open.  ``events`` are timestamped point
    annotations inside the span (fault injected, retry, breaker trip...).
    """

    span_id: int
    name: str
    track: str
    t0: float
    t1: Optional[float] = None
    parent_id: Optional[int] = None
    rid: Optional[int] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    events: List[Tuple[float, str, Dict[str, Any]]] = \
        dataclasses.field(default_factory=list)

    @property
    def open(self) -> bool:
        return self.t1 is None

    @property
    def duration_s(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0


class Tracer:
    """Collects spans; knows nothing about time except what callers stamp.

    The low-level API (:meth:`begin`/:meth:`end`/:meth:`span`/
    :meth:`event`/:meth:`instant`) records arbitrary spans.  The
    request-tree helpers (:meth:`begin_request` /
    :meth:`request_event` / :meth:`child` / :meth:`finish_request`)
    maintain the per-rid trees the serving stack emits and
    :meth:`validate_request_trees` checks.
    """

    def __init__(self) -> None:
        self._ids = itertools.count()
        self.spans: List[Span] = []
        #: track-level point annotations outside any span:
        #: (track, t, name, attrs)
        self.instants: List[Tuple[str, float, str, Dict[str, Any]]] = []
        self._by_id: Dict[int, Span] = {}
        self._roots: Dict[int, Span] = {}        # rid -> root span
        self._open_rids: Dict[int, Span] = {}    # rid -> still-open root

    # -- low-level spans -----------------------------------------------------
    def begin(self, name: str, t: float, track: str = "server",
              parent: Optional[Span] = None, rid: Optional[int] = None,
              **attrs: Any) -> Span:
        span = Span(span_id=next(self._ids), name=name, track=track,
                    t0=float(t),
                    parent_id=None if parent is None else parent.span_id,
                    rid=rid, attrs=attrs)
        self.spans.append(span)
        self._by_id[span.span_id] = span
        return span

    def end(self, span: Span, t: float) -> Span:
        if not span.open:
            raise RuntimeError(f"span {span.name!r} already ended")
        if float(t) < span.t0:
            raise ValueError(
                f"span {span.name!r} cannot end at {t} before start {span.t0}")
        span.t1 = float(t)
        return span

    def span(self, name: str, t0: float, t1: float, track: str = "server",
             parent: Optional[Span] = None, rid: Optional[int] = None,
             **attrs: Any) -> Span:
        """Record an already-closed span (the retroactive form the serving
        layer uses once a launch's modeled schedule is known)."""
        return self.end(self.begin(name, t0, track=track, parent=parent,
                                   rid=rid, **attrs), t1)

    def event(self, span: Span, t: float, name: str, **attrs: Any) -> None:
        span.events.append((float(t), name, attrs))

    def instant(self, track: str, t: float, name: str, **attrs: Any) -> None:
        """A track-level point annotation outside any span (e.g. a request
        shed at the door before it ever got a rid)."""
        self.instants.append((track, float(t), name, attrs))

    def children(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent_id == span.span_id]

    # -- request trees -------------------------------------------------------
    @staticmethod
    def request_track(rid: int) -> str:
        return f"rid:{rid}"

    def begin_request(self, rid: int, t: float, **attrs: Any) -> Span:
        """Open rid's root span (``request``) plus its zero-width
        ``admission`` child marking the accepted admission decision."""
        if rid in self._roots:
            raise RuntimeError(f"request {rid} already has a root span")
        root = self.begin("request", t, track=self.request_track(rid),
                          rid=rid, **attrs)
        self._roots[rid] = root
        self._open_rids[rid] = root
        self.span("admission", t, t, track=root.track, parent=root, rid=rid)
        return root

    def request_root(self, rid: int) -> Optional[Span]:
        return self._roots.get(rid)

    def request_rids(self) -> List[int]:
        return sorted(self._roots)

    def request_event(self, rid: int, t: float, name: str,
                      **attrs: Any) -> None:
        """Attach a point event to rid's open root (no-op for unknown or
        already-finished rids, so late bookkeeping can't corrupt a tree)."""
        root = self._open_rids.get(rid)
        if root is not None:
            self.event(root, t, name, **attrs)

    def child(self, rid: int, name: str, t0: float, t1: float,
              **attrs: Any) -> Optional[Span]:
        """A closed child span under rid's root, on the rid's track."""
        root = self._roots.get(rid)
        if root is None:
            return None
        return self.span(name, t0, t1, track=root.track, parent=root,
                         rid=rid, **attrs)

    def finish_request(self, rid: int, t: float, terminal: str,
                       **attrs: Any) -> Optional[Span]:
        """Close rid's tree with its terminal span (``result`` or ``shed``).

        Idempotent-safe: a rid whose tree is already closed (or that was
        never opened — tracer installed mid-run) is left untouched.
        """
        if terminal not in TERMINAL_SPANS:
            raise ValueError(f"terminal must be one of {TERMINAL_SPANS}, "
                             f"got {terminal!r}")
        root = self._open_rids.pop(rid, None)
        if root is None:
            return None
        term = self.span(terminal, t, t, track=root.track, parent=root,
                         rid=rid, **attrs)
        self.end(root, t)
        return term

    def validate_request_trees(self, rids: Optional[Sequence[int]] = None
                               ) -> List[str]:
        """The completeness contract, as a list of violations (empty = OK).

        For every rid (default: all rids ever opened): the root exists and
        is closed, every span in its tree is closed, and the tree ends in
        *exactly one* terminal span (``result`` or a named ``shed``) —
        never a dangling request.
        """
        errors = []
        for rid in (self.request_rids() if rids is None else rids):
            root = self._roots.get(rid)
            if root is None:
                errors.append(f"rid {rid}: no root span")
                continue
            if root.open:
                errors.append(f"rid {rid}: root span never closed (dangling)")
            kids = self.children(root)
            for s in kids:
                if s.open:
                    errors.append(f"rid {rid}: child span {s.name!r} "
                                  "never closed (dangling)")
            terminals = [s for s in kids if s.name in TERMINAL_SPANS]
            if len(terminals) != 1:
                errors.append(
                    f"rid {rid}: expected exactly one terminal span, got "
                    f"{[s.name for s in terminals]}")
            elif root.t1 is not None and terminals[0].t0 != root.t1:
                errors.append(
                    f"rid {rid}: terminal {terminals[0].name!r} at "
                    f"{terminals[0].t0} != root end {root.t1}")
        return errors

    # -- Chrome trace export -------------------------------------------------
    def _track_ids(self) -> Dict[str, Tuple[int, int]]:
        """Stable (pid, tid) per track: requests under one process, lanes
        under another, queues a third, everything else under ``server``."""
        groups = {"rid": 1, "lane": 2, "queue": 3}
        tracks = sorted({s.track for s in self.spans}
                        | {t for (t, _, _, _) in self.instants})
        out: Dict[str, Tuple[int, int]] = {}
        next_tid = {pid: itertools.count(1) for pid in (1, 2, 3, 4)}
        for track in tracks:
            prefix = track.split(":", 1)[0]
            pid = groups.get(prefix, 4)
            if pid == 1:
                try:                      # rid tracks keep their rid as tid
                    out[track] = (1, int(track.split(":", 1)[1]))
                    continue
                except ValueError:
                    pass
            out[track] = (pid, next(next_tid[pid]))
        return out

    def to_chrome_json(self, path: Optional[Any] = None) -> Dict[str, Any]:
        """The trace in Chrome trace-event JSON (Perfetto-loadable).

        Virtual-clock seconds map to microsecond ``ts``/``dur``.  When
        ``path`` is given the document is also written there.
        """
        track_ids = self._track_ids()
        pid_names = {1: "requests", 2: "lanes", 3: "queues", 4: "server"}
        events: List[Dict[str, Any]] = []
        for pid in sorted({p for (p, _) in track_ids.values()}):
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": pid_names[pid]}})
        for track, (pid, tid) in sorted(track_ids.items()):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": track}})

        timed: List[Dict[str, Any]] = []
        for s in self.spans:
            pid, tid = track_ids[s.track]
            t1 = s.t0 if s.t1 is None else s.t1
            args = {"span_id": s.span_id, **s.attrs}
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            if s.rid is not None:
                args["rid"] = s.rid
            timed.append({"ph": "X", "name": s.name, "cat": s.track,
                          "ts": s.t0 * 1e6, "dur": (t1 - s.t0) * 1e6,
                          "pid": pid, "tid": tid, "args": args})
            for (t, name, attrs) in s.events:
                timed.append({"ph": "i", "name": name, "cat": s.track,
                              "ts": t * 1e6, "s": "t", "pid": pid,
                              "tid": tid,
                              "args": {"span_id": s.span_id, **attrs}})
        for (track, t, name, attrs) in self.instants:
            pid, tid = track_ids[track]
            timed.append({"ph": "i", "name": name, "cat": track,
                          "ts": t * 1e6, "s": "t", "pid": pid, "tid": tid,
                          "args": dict(attrs)})
        # monotonic per track by construction of the sort (validated by
        # validate_chrome_trace; ties keep emission order — Python's sort
        # is stable)
        timed.sort(key=lambda e: (e["pid"], e["tid"], e["ts"]))
        events.extend(timed)
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"clock": "modeled-virtual",
                             "n_spans": len(self.spans)}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1, default=str)
        return doc


def validate_chrome_trace(doc: Any) -> List[str]:
    """Schema-validate a Chrome trace document (the CI artifact gate).

    Checks the required top-level/per-event keys, non-negative durations,
    *monotonic* timestamps per (pid, tid) track, and that every
    ``args.parent_id`` references a ``span_id`` present in the document —
    no orphan parents.  Returns a list of violations (empty = valid).
    """
    errors: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["missing required top-level key 'traceEvents'"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' is not a list"]
    span_ids = set()
    last_ts: Dict[Tuple[int, int], float] = {}
    for i, ev in enumerate(events):
        for key in ("ph", "name", "pid", "tid"):
            if key not in ev:
                errors.append(f"event {i}: missing required key {key!r}")
        ph = ev.get("ph")
        if ph == "M":
            continue
        if "ts" not in ev:
            errors.append(f"event {i}: timed event missing 'ts'")
            continue
        if ph == "X":
            if "dur" not in ev:
                errors.append(f"event {i}: complete event missing 'dur'")
            elif ev["dur"] < 0:
                errors.append(f"event {i}: negative dur {ev['dur']}")
            sid = ev.get("args", {}).get("span_id")
            if sid is not None:
                span_ids.add(sid)
        track = (ev.get("pid"), ev.get("tid"))
        if ev["ts"] < last_ts.get(track, float("-inf")):
            errors.append(
                f"event {i}: ts {ev['ts']} not monotonic on track {track} "
                f"(last {last_ts[track]})")
        last_ts[track] = ev["ts"]
    for i, ev in enumerate(events):
        parent = ev.get("args", {}).get("parent_id")
        if parent is not None and parent not in span_ids:
            errors.append(f"event {i}: orphan parent_id {parent}")
    return errors
