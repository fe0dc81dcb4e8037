"""The port's static, dispatch, overload and power benches
(``benchmarks_torch``) against the JAX package's, on the CPU.

Modeled rows are the machine model's and the serving stack's plain Python
over the same counts, arrivals and payloads, so they compare with ``==``
(every row of ``bench_static``; every key of ``bench_overload`` and
``bench_power``'s results: goodputs, shed and late counts, backlog,
retries, quarantines, lane energies, throttles).  ``bench_dispatch``
measures the host's clock, so only its keys and the signs of its figures
are compared.  The JAX benches append to ``BENCH_*.json`` at the repo root;
here their ``OUT_PATH`` points into a temporary directory, and the port's
benches write no file at all.
"""

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmarks.bench_dispatch as j_dispatch  # noqa: E402
import benchmarks.bench_overload as j_overload  # noqa: E402
import benchmarks.bench_power as j_power  # noqa: E402
import benchmarks.bench_static as j_static  # noqa: E402
from benchmarks_torch import (bench_dispatch, bench_overload,  # noqa: E402
                              bench_power, bench_static)
from repro_torch.obs import validate_chrome_trace  # noqa: E402

HISTORY = ("timestamp",)


def _jax_run(module, tmp_path_factory, **kw):
    """The JAX bench's result, its history file kept out of the repo."""
    out = tmp_path_factory.mktemp(module.__name__.rsplit(".", 1)[-1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "OUT_PATH", out / "BENCH.json")
        result = module.run(**kw)
    assert (out / "BENCH.json").exists()
    return {k: v for k, v in result.items() if k not in HISTORY}


def _repo_bench_files():
    return {p.name: p.read_bytes() for p in ROOT.glob("BENCH_*.json")}


@pytest.fixture(scope="module")
def bench_files():
    before = _repo_bench_files()
    yield before
    assert _repo_bench_files() == before, "a bench wrote a BENCH_*.json"


def test_bench_static_rows_equal_jax(bench_files):
    rows = bench_static.run()
    assert rows == j_static.run()
    assert [r["name"] for r in rows] == [
        "x-heep-host", "e-gpu-4t", "e-gpu-8t", "e-gpu-16t"]


def test_bench_dispatch_has_the_jax_keys(bench_files, tmp_path_factory):
    got = bench_dispatch.run("cpu")
    want = _jax_run(j_dispatch, tmp_path_factory)
    assert set(got) == set(want)
    assert set(got["per_launch_us"]) == set(want["per_launch_us"]) == {
        "eager-sync", "async", "graph"}
    assert all(v > 0.0 for v in got["per_launch_us"].values())
    assert got["graph_vs_eager_sync_speedup"] == (
        got["per_launch_us"]["eager-sync"] / got["per_launch_us"]["graph"])
    for key in ("bench", "size", "chain_len", "reps", "trials"):
        assert got[key] == want[key]


@pytest.fixture(scope="module")
def overload_runs(tmp_path_factory):
    trace = tmp_path_factory.mktemp("trace") / "overload.json"
    got = bench_overload.run("cpu", trace_path=trace)
    want = _jax_run(j_overload, tmp_path_factory)
    return got, want, trace


def test_bench_overload_rows_equal_jax(bench_files, overload_runs):
    got, want, trace = overload_runs
    assert got["trace"].pop("path") == str(trace)
    assert want["trace"].pop("path") is None
    assert got == want
    # both gates held, and every served request of the faulted arms was
    # checked bit for bit against the eager path inside run()
    assert got["goodput_vs_fifo_speedup"] >= bench_overload.GATE_X
    assert got["goodput_faulted_vs_fifo_speedup"] >= bench_overload.GATE_X
    assert got["n_bit_identity_checked"] > 0
    assert got["trace"]["n_traced_served"] > 0


def test_bench_overload_trace_is_written_only_when_asked(overload_runs,
                                                         tmp_path, monkeypatch):
    _, _, trace = overload_runs
    doc = json.loads(trace.read_text())
    assert validate_chrome_trace(doc) == []
    monkeypatch.chdir(tmp_path)
    assert bench_overload.run("cpu")["trace"]["path"] is None
    assert list(tmp_path.iterdir()) == []


def test_bench_power_rows_equal_jax(bench_files, tmp_path_factory):
    got = bench_power.run("cpu")
    want = _jax_run(j_power, tmp_path_factory)
    assert got == want
    assert got["goodput_per_watt_speedup"] >= bench_power.GATE_X
    assert got["n_power_throttled"] > 0 and got["n_budget_violations"] == 0


def test_port_benches_name_no_history_file():
    for module in (bench_static, bench_dispatch, bench_overload, bench_power):
        src = pathlib.Path(module.__file__).read_text()
        assert "BENCH_" not in src and "OUT_PATH" not in src
