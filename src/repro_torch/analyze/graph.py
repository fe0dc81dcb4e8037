"""Capture-time CommandGraph sanitizer.

A captured :class:`~repro_torch.core.runtime.CommandGraph` is the runtime's whole
correctness surface: once sealed it replays node by node without
re-checking its wiring, so a capture-discipline bug (a missing ordering edge on an
out-of-order queue, a transfer writing a read-only buffer, a donated input
read off the ordered path) produces no crash — just silently wrong modeled
accounting or, under donation, wrong *data* on a later launch.  Real OpenCL
stacks meet this with host-side validation layers; this module is ours.

:func:`verify_graph` is a pure static pass over the captured node list.  It
re-derives every hazard the capture machinery is supposed to have ordered
and reports each violation as a :class:`Finding` with a stable ``code`` and
a node-naming message:

=====================  ====================================================
``raw-race``           a node reads a slot with no dependency path from the
                       slot's producer (read-after-write unordered)
``war-race``           a transfer overwrites a logical buffer without being
                       ordered after every reader of the old value
``waw-race``           two producers of one slot, or an overwrite unordered
                       against the previous producer
``use-after-donate``   a reader of a donated external slot whose work never
                       reaches the launch boundary (the graph outputs) — it
                       is unordered against the realize-then-drain point,
                       so a later launch may have reused its buffer
``double-donation``    one external position donated twice, or two donated
                       externals aliasing the same captured array
``flag-violation``     a kernel/read consuming a write-only slot, or a
                       write/copy landing in a read-only buffer
``dependency-cycle``   the dependency edges do not form a DAG
``dead-node``          a costed node whose outputs are never read/returned
                       and whose only ordering dead-ends in a sync sink
                       (modeled work that cannot matter)
=====================  ====================================================

The pass is duck-typed: it needs ``graph.nodes`` (each node carrying
``kernel.name`` / ``in_slots`` / ``out_slots`` / ``deps`` / ``kind`` /
``overwrites``) and optionally ``_ext_slots`` / ``_ext_values`` /
``_slot_flags`` / ``_output_slots()``, so tests can feed hand-built hazard
graphs without touching the runtime.  Entry points:

* ``CommandGraph.verify(donate=())`` — memoized per (graph, donation), so
  warm serving pays a dict lookup at most;
* ``REPRO_VERIFY=1`` — every capture is verified at seal time and every
  :class:`~repro_torch.serve.cache.GraphCache` miss raises
  :class:`GraphVerifyError` on findings, turning a whole test/bench run
  into a sanitizer sweep.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

__all__ = ["Finding", "GraphVerifyError", "verify_graph"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One sanitizer diagnostic: a stable code, the offending node indices,
    and a human message naming them."""

    code: str
    message: str
    nodes: Tuple[int, ...] = ()

    def __str__(self) -> str:
        return f"[{self.code}] {self.message}"


class GraphVerifyError(RuntimeError):
    """Raised (under ``REPRO_VERIFY=1``) when a capture carries findings."""

    def __init__(self, findings: Sequence[Finding]):
        self.findings = tuple(findings)
        lines = "\n".join(f"  {f}" for f in self.findings)
        super().__init__(
            f"graph sanitizer: {len(self.findings)} finding(s)\n{lines}")


def _name(nodes: Sequence[Any], i: int) -> str:
    n = nodes[i]
    kind = getattr(n, "kind", "kernel")
    return f"#{i}:{n.kernel.name}" + (f"({kind})" if kind != "kernel" else "")


def _find_cycle(nodes: Sequence[Any]) -> Tuple[int, ...]:
    """A node sequence forming a dependency cycle, or () when acyclic."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = [WHITE] * len(nodes)
    for root in range(len(nodes)):
        if color[root] != WHITE:
            continue
        stack: List[Tuple[int, int]] = [(root, 0)]
        path: List[int] = []
        while stack:
            i, di = stack.pop()
            if di == 0:
                color[i] = GRAY
                path.append(i)
            deps = nodes[i].deps
            if di < len(deps):
                stack.append((i, di + 1))
                d = deps[di]
                if not 0 <= d < len(nodes):
                    continue            # dangling edge; reported separately
                if color[d] == GRAY:
                    return tuple(path[path.index(d):]) + (d,)
                if color[d] == WHITE:
                    stack.append((d, 0))
            else:
                color[i] = BLACK
                path.pop()
    return ()


def _derived_output_slots(nodes: Sequence[Any]) -> Tuple[int, ...]:
    """Mirror of ``CommandGraph._output_slots`` for duck-typed graphs."""
    reads: List[Any] = []
    for node in reversed(nodes):
        if getattr(node, "kind", "kernel") == "read":
            reads.append(node)
        elif node.out_slots:
            break
    if reads:
        return tuple(s for n in reversed(reads) for s in n.out_slots)
    for node in reversed(nodes):
        if node.out_slots:
            return tuple(node.out_slots)
    return ()


def verify_graph(graph: Any, donate: Sequence[int] = ()) -> Tuple[Finding, ...]:
    """Statically verify one captured graph; returns all findings, () when
    clean.  ``donate`` lists donated external-input positions (capture
    order), enabling the use-after-donate / double-donation checks — the
    same tuple a ``launch(..., donate=...)`` would receive.

    Pure and read-only: no node executes, nothing on the graph mutates, so
    running it at every capture under ``REPRO_VERIFY=1`` cannot perturb
    modeled accounting or functional results.
    """
    nodes = list(graph.nodes)
    n = len(nodes)
    findings: List[Finding] = []
    if not n:
        return ()

    # -- structural maps, re-derived from scratch (never trust the capture's
    #    own indices: they are exactly what is under test) ------------------
    producers: Dict[int, List[int]] = {}
    readers: Dict[int, List[int]] = {}
    for i, node in enumerate(nodes):
        for s in node.in_slots:
            readers.setdefault(s, []).append(i)
        for s in node.out_slots:
            producers.setdefault(s, []).append(i)

    ext_slots = getattr(graph, "_ext_slots", None)
    if ext_slots is None:               # duck-typed graph: externals are the
        ext_slots = sorted(             # slots nobody produces
            s for s in readers if s not in producers)
    slot_flags: Dict[int, str] = getattr(graph, "_slot_flags", None) or {}

    def flags_of(slot: int) -> str:
        return slot_flags.get(slot, "rw")

    out_getter = getattr(graph, "_output_slots", None)
    if callable(out_getter):
        try:
            out_slots = tuple(out_getter())
        except StopIteration:       # sync-only capture: nothing to return
            out_slots = ()
    else:
        out_slots = tuple(_derived_output_slots(nodes))

    # -- dependency cycles (everything else needs a DAG) --------------------
    cycle = _find_cycle(nodes)
    if cycle:
        chain = " -> ".join(_name(nodes, i) for i in cycle)
        findings.append(Finding(
            "dependency-cycle",
            f"dependency edges form a cycle: {chain}",
            tuple(dict.fromkeys(cycle))))

    # -- ancestor sets (bitmasks); only meaningful on a DAG -----------------
    anc: List[int] = [0] * n
    if not cycle:
        # deps may point anywhere in hand-built graphs; process in topo
        # order (Kahn) — acyclicity was just proven.
        indeg = [0] * n
        dependents: Dict[int, List[int]] = {}
        for i, node in enumerate(nodes):
            for d in node.deps:
                if 0 <= d < n:
                    indeg[i] += 1
                    dependents.setdefault(d, []).append(i)
        ready = [i for i in range(n) if indeg[i] == 0]
        while ready:
            i = ready.pop()
            mask = 0
            for d in nodes[i].deps:
                if 0 <= d < n:
                    mask |= anc[d] | (1 << d)
            anc[i] = mask
            for j in dependents.get(i, ()):
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.append(j)

        def ordered_before(a: int, b: int) -> bool:
            return bool(anc[b] >> a & 1)

        # -- RAW: every read must be ordered after its slot's producer ------
        for i, node in enumerate(nodes):
            for s in node.in_slots:
                for p in producers.get(s, ()):
                    if p != i and not ordered_before(p, i):
                        findings.append(Finding(
                            "raw-race",
                            f"{_name(nodes, i)} reads slot {s} with no "
                            f"dependency path from its producer "
                            f"{_name(nodes, p)} (read-after-write "
                            "unordered)", (p, i)))

        # -- WAW part 1: one producer per slot (capture SSA discipline) -----
        for s, ps in producers.items():
            if len(ps) > 1:
                names = ", ".join(_name(nodes, p) for p in ps)
                findings.append(Finding(
                    "waw-race",
                    f"slot {s} has {len(ps)} producers ({names}); captured "
                    "slots are written exactly once", tuple(ps)))

        # -- overwrite hazards: a write/copy that REBINDS a logical buffer
        #    must be ordered after the old value's producer (WAW) and after
        #    every reader of the old value (WAR) --------------------------
        for i, node in enumerate(nodes):
            for s_old in getattr(node, "overwrites", ()):
                for p in producers.get(s_old, ()):
                    if not ordered_before(p, i):
                        findings.append(Finding(
                            "waw-race",
                            f"{_name(nodes, i)} overwrites slot {s_old} "
                            f"without ordering after its producer "
                            f"{_name(nodes, p)}", (p, i)))
                for r in readers.get(s_old, ()):
                    if r != i and not ordered_before(r, i):
                        findings.append(Finding(
                            "war-race",
                            f"{_name(nodes, i)} overwrites slot {s_old} "
                            f"still being read by {_name(nodes, r)} "
                            "(write-after-read unordered)", (r, i)))

        # The launch boundary: nodes producing returned slots plus every
        # ancestor reachable through dep edges (sync nodes included).  This
        # strict frontier is what use-after-donate measures against — it is
        # the realize-then-drain point.  Dead-node uses a wider notion:
        # on a concurrent queue the "last node's slots" return rule is an
        # arbitrary tiebreak, so every dependent-free sink still carrying
        # outputs is the legitimate tail of an independent stream and all
        # its ancestors count as live.
        frontier = [i for i, node in enumerate(nodes)
                    if any(s in out_slots for s in node.out_slots)]
        reach_out = 0
        for o in frontier:
            reach_out |= anc[o] | (1 << o)
        reach_live = reach_out
        for i, node in enumerate(nodes):
            if node.out_slots and i not in dependents:
                reach_live |= anc[i] | (1 << i)

        # -- use-after-donate: a donated external's storage may be reused
        #    the moment the launch completes; a reader whose work never
        #    reaches the launch boundary (the output frontier) is unordered
        #    against the engine's realize-then-drain point ----------------
        donate = tuple(int(i) for i in donate)
        if donate:
            seen: Dict[int, int] = {}
            for pos in donate:
                if pos in seen:
                    findings.append(Finding(
                        "double-donation",
                        f"external input {pos} donated more than once", ()))
                seen[pos] = pos
            ext_values = getattr(graph, "_ext_values", None) or []
            for ai in range(len(donate)):
                for bi in range(ai + 1, len(donate)):
                    a, b = donate[ai], donate[bi]
                    if (a != b and a < len(ext_values) and b < len(ext_values)
                            and ext_values[a] is ext_values[b]):
                        findings.append(Finding(
                            "double-donation",
                            f"external inputs {a} and {b} are aliases of "
                            "one captured array; donating both would hand "
                            "the same storage over twice", ()))
            donated_slots = {ext_slots[p] for p in donate
                             if 0 <= p < len(ext_slots)}
            for i, node in enumerate(nodes):
                if not (reach_out >> i & 1) and any(
                        s in donated_slots for s in node.in_slots):
                    s = next(x for x in node.in_slots if x in donated_slots)
                    findings.append(Finding(
                        "use-after-donate",
                        f"{_name(nodes, i)} reads donated external slot "
                        f"{s} but has no path to the launch outputs; it is "
                        "unordered against the realize-then-drain boundary "
                        "and may observe reused storage", (i,)))

        # -- dead nodes: costed work whose outputs nobody consumes ---------
        # A node is live when some output is read/returned OR when it is an
        # ancestor of the live frontier (returned slots + concurrent sinks):
        # barrier-/marker-ordered side work and independent out-of-order
        # streams are deliberate, so their modeled cost is intentional even
        # though only the final node's slots are returned.  What remains —
        # a node ordered only into a sync sink nobody else consumes, with
        # unread outputs — is genuinely dropped work.
        for i, node in enumerate(nodes):
            if getattr(node, "kind", "kernel") == "sync" or not node.out_slots:
                continue
            live = (bool(reach_live >> i & 1) or any(
                s in out_slots or readers.get(s) for s in node.out_slots))
            if not live:
                findings.append(Finding(
                    "dead-node",
                    f"{_name(nodes, i)} outputs (slots "
                    f"{tuple(node.out_slots)}) are never read nor returned, "
                    "and its only ordering leads into a sync dead end; its "
                    "modeled cost is booked for work that cannot "
                    "matter", (i,)))

    # -- buffer-flag violations (order-independent) -------------------------
    for i, node in enumerate(nodes):
        kind = getattr(node, "kind", "kernel")
        if kind == "sync":
            continue
        for s in node.in_slots:
            if "r" not in flags_of(s):
                what = ("kernel" if kind == "kernel"
                        else f"{kind} transfer")
                findings.append(Finding(
                    "flag-violation",
                    f"{_name(nodes, i)}: {what} reads slot {s} whose "
                    f"buffer is write-only (flags="
                    f"{flags_of(s)!r})", (i,)))
        if kind in ("write", "copy"):
            for s in node.out_slots:
                if "w" not in flags_of(s):
                    findings.append(Finding(
                        "flag-violation",
                        f"{_name(nodes, i)}: {kind} lands in slot {s} "
                        f"whose buffer is read-only (flags="
                        f"{flags_of(s)!r})", (i,)))

    return tuple(findings)
