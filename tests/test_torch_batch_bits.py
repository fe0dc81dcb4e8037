"""``benchmarks_torch/batch_bits.py`` on the CPU, at the reduced widths.

The script names the op of the LM path whose bits for a row depend on the
batch the row runs in.  Here a batch-dependent version of each hand-written
kernel's wrapper is planted, and the report must name it: first in layer 0
of the chain, and among the ops that differ on their own.  Unplanted, the
plain versions of the two kernels are batch-free on the CPU.  An op planted
in the batch-6 run only must be listed among the unpaired ops.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:              # the benchmark package
    sys.path.insert(0, str(ROOT))

from benchmarks_torch import batch_bits  # noqa: E402
from repro_torch.models import attention as attention_mod  # noqa: E402
from repro_torch.models import rwkv as rwkv_mod  # noqa: E402
from repro_torch.models import transformer as transformer_mod  # noqa: E402

SMALL = dict(reduced=True, prompt_len=8, new=4, max_len=32)
LABELS = [f"B=1 rows [{i}]" for i in range(batch_bits.BATCH)] + [
    "B=4 rows [0, 1, 2, 3]", "B=2 rows [4, 5]"]


def _isolated_ops(entry):
    return {o["op"] for ops in entry["isolated"].values() for o in ops}


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-3b",
                                  "moonshot-v1-16b-a3b", "deepseek-v2-236b",
                                  "jamba-1.5-large-398b"])
def test_report_covers_every_row_and_batch(arch):
    rep = batch_bits.run(arch, "cpu", **SMALL)
    assert rep["batch"] == batch_bits.BATCH
    assert sorted(rep["tokens"]) == ["in_batches_of_1_1_1_1_1_1",
                                     "in_batches_of_4_2"]
    for first in rep["tokens"].values():
        assert len(first) == batch_bits.BATCH
        assert all(-1 <= t < SMALL["new"] for t in first)
    kernel = {"rwkv6-3b": "rwkv6_scan",
              "jamba-1.5-large-398b": "mamba_scan"}.get(arch, "flash_attention")
    for phase in ("prefill", "step"):
        assert sorted(rep[phase]) == sorted(f"{phase} {lab}" for lab in LABELS)
        for entry in rep[phase].values():
            assert entry["replayed"] > 0
            assert sum(entry["differing"].values()) == sum(
                len(ops) for ops in entry["isolated"].values())
            # the kernel's plain version gives a row the bits of the row alone
            assert kernel not in _isolated_ops(entry)
    assert batch_bits.summary(rep)[0].startswith(rep["arch"])


@pytest.mark.parametrize("arch,module,name,phases", [
    ("qwen2.5-3b", attention_mod, "flash_attention", ("prefill",)),
    ("rwkv6-3b", rwkv_mod, "rwkv6_scan", ("prefill", "step")),
])
def test_a_planted_batch_dependent_kernel_is_named(monkeypatch, arch, module,
                                                   name, phases):
    real = getattr(module, name)

    def planted(*args, **kwargs):
        out = real(*args, **kwargs)
        y = out[0] if isinstance(out, tuple) else out
        y = y + torch.tensor(1e-2 * args[0].shape[0], dtype=y.dtype)
        return (y,) + tuple(out[1:]) if isinstance(out, tuple) else y

    monkeypatch.setattr(module, name, planted)
    rep = batch_bits.run(arch, "cpu", **SMALL)
    assert getattr(module, name) is planted         # put back as it was
    for entry in rep["prefill"].values():
        # the planted sum runs inside the wrapper: named as within it
        assert entry["first"]["layer"] == 0
        assert entry["first"]["op"].startswith(name + "/")
    # (in the step a product of one row parts first on the CPU)
    for phase in phases:
        for entry in rep[phase].values():
            assert name in _isolated_ops(entry)


def test_an_op_only_the_batch_runs_is_listed_not_dropped(monkeypatch):
    """An op that runs at batch 6 only (as a copy at B = 6 that is a view
    at B = 1 would) pairs with no op of the smaller run, so no pair
    compares it: the report lists it among the unpaired ops before the
    first paired op that differs, and counts it among those no replay
    reaches."""
    real = transformer_mod.apply_norm

    def planted(p, x, cfg):
        y = real(p, x, cfg)
        return y * 1.5 if x.shape[0] == batch_bits.BATCH else y

    monkeypatch.setattr(transformer_mod, "apply_norm", planted)
    rep = batch_bits.run("qwen2.5-3b", "cpu", **SMALL)
    for entry in rep["prefill"].values():
        first = entry["first"]
        assert first["layer"] == 0 and first["unmatched"]
        assert any(o["run"] == "batch" and o["op"] == "aten.mul.Tensor"
                   for o in first["unpaired_before"])
        assert entry["unpaired"].get("aten.mul.Tensor", 0) > 0
    assert "unpaired ops that compute before it: ['aten.mul.Tensor'" in (
        "\n".join(batch_bits.summary(rep)))
