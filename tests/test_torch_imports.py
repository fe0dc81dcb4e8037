"""The port stands alone: no JAX, no JAX package, the card by default.

A fresh interpreter imports every ``repro_torch`` and ``benchmarks_torch``
module and ``chip_smoke`` and must end with neither ``jax`` nor ``repro``
in ``sys.modules``; the port's examples import neither either.  Without
a card, the entry points refuse to fall back to the CPU unless asked, and
``chip_smoke.py`` exits non-zero without printing a result.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
if str(ROOT) not in sys.path:              # the benchmark package
    sys.path.insert(0, str(ROOT))

_PROBE = r"""
import importlib, json, pkgutil, sys
import benchmarks_torch, repro_torch
mods = []
for pkg in (repro_torch, benchmarks_torch):
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(info.name)
        mods.append(info.name)
import chip_smoke
from repro_torch.core import Program, EGPU_16T
Program.build(EGPU_16T).create_kernels()
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": mods, "leaked": leaked}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(ROOT)])
    return env


def test_port_imports_neither_jax_nor_the_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    expected = {"repro_torch.core.runtime", "repro_torch.core.apu",
                "repro_torch.apps.tinybio", "repro_torch.tinycl",
                "repro_torch.kernels.fir.ops", "repro_torch.kernels.svm.ops",
                "repro_torch.kernels.delineate.ops",
                "repro_torch.kernels.stockham_fft.ops",
                "repro_torch.kernels.gemm.ops", "repro_torch.kernels.gemm.gemm",
                "benchmarks_torch.bench_gemm_overhead",
                "benchmarks_torch.bench_transfer",
                "benchmarks_torch.bench_multiqueue",
                "benchmarks_torch.bench_tinybio",
                "repro_torch.configs", "repro_torch.configs.qwen2_5_3b",
                "repro_torch.models.config", "repro_torch.models.params",
                "repro_torch.models.layers", "repro_torch.models.attention",
                "repro_torch.models.transformer", "repro_torch.models.convert",
                "repro_torch.train.serve",
                "repro_torch.kernels.flash_attention.ops",
                "repro_torch.kernels.flash_attention.ref",
                "repro_torch.kernels.flash_attention.flash_attention",
                "repro_torch.obs.metrics", "repro_torch.obs.trace",
                "repro_torch.analyze.graph", "repro_torch.serve.batching",
                "repro_torch.serve.cache", "repro_torch.serve.dispatch",
                "repro_torch.serve.server", "repro_torch.serve.faults",
                "repro_torch.serve.power", "benchmarks_torch.bench_serve",
                "repro_torch.serve.engine", "repro_torch.serve.http",
                "benchmarks_torch.bench_decode",
                "repro_torch.data.pipeline", "repro_torch.optim.adamw",
                "repro_torch.optim.schedule", "repro_torch.checkpoint.store",
                "repro_torch.train.step", "repro_torch.launch.train"}
    assert expected <= set(report["modules"])


def test_no_source_line_names_jax():
    paths = (list((SRC / "repro_torch").rglob("*.py"))
             + list((ROOT / "benchmarks_torch").rglob("*.py"))
             + list((ROOT / "examples").glob("*_torch.py"))
             + [ROOT / "chip_smoke.py"])
    assert len([p for p in paths if p.parent.name == "examples"]) == 4
    for path in paths:
        for line in path.read_text().splitlines():
            code = line.split("#")[0].strip()
            if code.startswith(("import ", "from ")):
                assert "jax" not in code, f"{path}: {line}"
                assert not code.startswith(("import repro.", "from repro ",
                                            "from repro.", "import repro ")), \
                    f"{path}: {line}"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default is usable")
    from repro_torch.apps.tinybio import run_tinybio, tinybio_stages
    from repro_torch.core import APU
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        APU()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_tinybio()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinybio_stages()
    from benchmarks_torch import bench_gemm_overhead, bench_transfer
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_gemm_overhead.run()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_transfer.run()
    from repro_torch.configs import get
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import model_spec
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(model_spec(get("qwen2.5-3b").reduced()), 0)
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "minicpm-2b", "--smoke", "--steps", "1"])


def _no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and ("ok" in obj or "kernels" in obj):
            return False
    return True


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert _no_result(out.stdout)


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert _no_result(out.stdout)
