"""repro_torch.analyze — static analysis of captured graphs and repo
invariants.

Two passes, one package, as in the JAX package:

* :mod:`repro_torch.analyze.graph` — a capture-time **graph sanitizer**:
  :func:`verify_graph` statically proves a captured
  :class:`~repro_torch.core.runtime.CommandGraph` free of RAW/WAR/WAW
  races, use-after-donate hazards, buffer-flag violations, dependency
  cycles and dead nodes, with node-naming :class:`Finding` diagnostics.
  It is reached as ``CommandGraph.verify()`` (memoized per graph and
  donation tuple), automatically at every
  :class:`~repro_torch.serve.cache.GraphCache` miss, and — loudly, raising
  :class:`GraphVerifyError` — at every capture under ``REPRO_VERIFY=1``.

* :mod:`repro_torch.analyze.lint` — an AST **invariant linter** enforcing
  the ROADMAP's structural rules over ``src/repro_torch`` (no builtin
  ``hash()``, no wall clocks in modeled accounting, tracer guards on hot
  paths, registry-only kernel construction, history-only bench writes).
  CLI: ``PYTHONPATH=src python -m repro_torch.analyze [path ...]``
  (default ``src/repro_torch``; non-zero exit on findings).

Worked example — the sanitizer catching a seeded race::

    import dataclasses
    import torch
    from repro_torch import tinycl

    ctx = tinycl.Context(tinycl.Device(), "cpu")
    q = tinycl.CommandQueue(ctx, out_of_order=True)
    k = tinycl.Kernel("scale", executor=lambda x: (x * 2.0,))
    buf = ctx.create_buffer(torch.ones(8))
    ndr = tinycl.NDRange((8,))

    with q.capture() as graph:
        ev = q.enqueue_nd_range(k, ndr, (buf,))          # producer
        q.enqueue_nd_range(k, ndr, ev.outputs)           # reader (edge 0->1)
    assert graph.verify() == ()                          # capture is clean

    graph.nodes[1] = dataclasses.replace(graph.nodes[1], deps=())
    graph._verify_memo.clear()
    (f,) = graph.verify()
    assert f.code == "raw-race"
"""

from .graph import Finding, GraphVerifyError, verify_graph
from .lint import (KERNEL_CTOR_MODULES, MODELED_ACCOUNTING, LintFinding,
                   lint_file, lint_paths, lint_source)

__all__ = [
    "Finding", "GraphVerifyError", "verify_graph",
    "LintFinding", "lint_source", "lint_file", "lint_paths",
    "MODELED_ACCOUNTING", "KERNEL_CTOR_MODULES",
]
