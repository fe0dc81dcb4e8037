"""The port's invariant linter (``repro_torch.analyze.lint``) against the
JAX package's, on the CPU.

The reference's linter cases, with their paths under ``src/repro_torch``;
every seeded bad source fires the same rule at the same line in both
linters (each given its own package's path); the port's lint is clean over
``src/repro_torch`` and its CLI exits 0.
"""

import os
import pathlib
import subprocess
import sys

import pytest

from repro.analyze import lint_source as j_lint_source
from repro_torch.analyze import (KERNEL_CTOR_MODULES, MODELED_ACCOUNTING,
                                 lint_paths, lint_source)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_linter_flags_the_old_params_hash_form():
    src = ("import torch\n"
           "def init(gen, name):\n"
           "    return gen.manual_seed(hash(name) % (2 ** 31))\n")
    (f,) = lint_source(src, "src/repro_torch/models/params.py")
    assert f.rule == "no-builtin-hash" and f.line == 3


def test_linter_wall_clock_rule():
    assert [f.rule for f in lint_source(
        "import time\nt = time.time()\n", "src/repro_torch/train/x.py")] \
        == ["wall-clock"]
    # perf_counter: banned in modeled-accounting modules only
    assert [f.rule for f in lint_source(
        "import time\nt = time.perf_counter()\n",
        "src/repro_torch/core/machine.py")] == ["wall-clock"]
    assert lint_source("import time\nt = time.perf_counter()\n",
                       "src/repro_torch/serve/x.py") == []
    # referencing (not calling) perf_counter is the injected-clock idiom
    assert lint_source(
        "import time\ndef f(clock=time.perf_counter):\n    return clock()\n",
        "src/repro_torch/core/machine.py") == []


def test_linter_tracer_guard_rule():
    bad = "class A:\n    def f(self):\n        self.tracer.instant('x')\n"
    (f,) = lint_source(bad, "src/repro_torch/serve/x.py")
    assert f.rule == "tracer-guard"
    good = ("class A:\n"
            "    def f(self, rid):\n"
            "        if self.tracer is not None and rid is not None:\n"
            "            self.tracer.instant('x')\n"
            "    def _trace_launch(self):\n"
            "        self._tracer.span('y')\n")
    assert lint_source(good, "src/repro_torch/serve/x.py") == []


def test_linter_registry_kernel_rule():
    bad = "k = Kernel('adhoc', executor=f)\n"
    (f,) = lint_source(bad, "src/repro_torch/serve/x.py")
    assert f.rule == "registry-kernels"
    assert "repro_torch.core.program" in f.message
    good = ("@kernel_family('g')\n"
            "def build_kernel(cfg):\n"
            "    return Kernel('g', executor=f)\n")
    assert lint_source(good, "src/repro_torch/kernels/g/ops.py") == []
    # the batching adapter re-wraps an existing kernel: allowlisted
    assert lint_source(bad, "src/repro_torch/serve/batching.py") == []
    # the JAX package's allowlist does not reach the port
    assert [f.rule for f in lint_source(bad, "src/repro/serve/batching.py")] \
        == ["registry-kernels"]


def test_linter_bench_history_rule():
    bad = ("import json\n"
           "OUT = 'BENCH_serve.json'\n"
           "json.dump({}, open(OUT, 'w'))\n")
    fs = lint_source(bad, "benchmarks_torch/bench_x.py")
    assert fs and all(f.rule == "bench-history" for f in fs)
    assert lint_source(bad, "benchmarks/history.py") == []


def test_allowlists_name_the_port():
    assert all(m.startswith("repro_torch/") for m in MODELED_ACCOUNTING)
    assert all(m.startswith("repro_torch/") for m in KERNEL_CTOR_MODULES)


# -- each of the reference's seeded bad sources, in both linters ----------------------
SEEDED = {
    "hash": ("import jax\n"
             "def init(key, name):\n"
             "    return jax.random.fold_in(key, hash(name) % (2 ** 31))\n",
             "models/params.py"),
    "time.time": ("import time\nt = time.time()\n", "launch/x.py"),
    "perf_counter in machine": ("import time\nt = time.perf_counter()\n",
                                "core/machine.py"),
    "perf_counter in power": ("import time\n\n\ndef f():\n"
                              "    return time.perf_counter()\n",
                              "core/power.py"),
    "perf_counter in faults": ("import time\nx = 1\nt = time.perf_counter()\n",
                               "serve/faults.py"),
    "perf_counter in obs": ("import time\nt = time.perf_counter()\n",
                            "obs/trace.py"),
    "tracer": ("class A:\n    def f(self):\n        self.tracer.instant('x')\n",
               "serve/x.py"),
    "_tracer": ("class A:\n    def g(self, x):\n        y = x\n"
                "        self._tracer.span('y')\n", "core/runtime.py"),
    "kernel": ("k = Kernel('adhoc', executor=f)\n", "serve/x.py"),
    "kernel in a non-family builder": (
        "def build_kernel(cfg):\n    return Kernel('g', executor=f)\n",
        "kernels/g/ops.py"),
    "bench write": ("import json\nOUT = 'BENCH_serve.json'\n"
                    "json.dump({}, open(OUT, 'w'))\n", "serve/bench.py"),
    "bench write_text": ("import pathlib\nP = pathlib.Path('BENCH_x.json')\n"
                         "P.write_text('[]')\n", "obs/x.py"),
    "syntax": ("def f(:\n", "serve/x.py"),
}


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_bad_source_fires_the_same_rule_at_the_same_line(name):
    src, rel = SEEDED[name]
    got = [(f.line, f.rule) for f in lint_source(src, f"src/repro_torch/{rel}")]
    want = [(f.line, f.rule) for f in j_lint_source(src, f"src/repro/{rel}")]
    assert got == want and got


def test_linter_is_clean_over_src_repro_torch():
    findings = lint_paths([ROOT / "src" / "repro_torch"])
    assert findings == [], "\n".join(str(f) for f in findings)


def test_cli_exits_clean_over_src_repro_torch():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analyze"],
        cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": "src"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "repro_torch.analyze: clean (src/repro_torch)"


def test_cli_exits_non_zero_on_a_finding(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import time\nt = time.time()\n")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analyze", str(bad)],
        cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": "src"})
    assert proc.returncode == 1
    assert "[wall-clock]" in proc.stdout and "1 finding(s)" in proc.stderr
