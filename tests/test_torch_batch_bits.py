"""``benchmarks_torch/batch_bits.py`` on the CPU, at the reduced widths.

The script names the op of the LM path whose bits for a row depend on the
batch the row runs in.  Here a batch-dependent version of each hand-written
kernel's wrapper is planted, and the report must name it: first in layer 0
of the chain, and among the ops that differ on their own.  Unplanted, the
plain versions of the two kernels are batch-free on the CPU.
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

SMALL = dict(reduced=True, prompt_len=8, new=4, max_len=32)
LABELS = [f"B=1 rows [{i}]" for i in range(batch_bits.BATCH)] + [
    "B=4 rows [0, 1, 2, 3]", "B=2 rows [4, 5]"]


def _isolated_ops(entry):
    return {o["op"] for ops in entry["isolated"].values() for o in ops}


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-3b"])
def test_report_covers_every_row_and_batch(arch):
    rep = batch_bits.run(arch, "cpu", **SMALL)
    assert rep["batch"] == batch_bits.BATCH
    assert sorted(rep["tokens"]) == ["in_batches_of_1_1_1_1_1_1",
                                     "in_batches_of_4_2"]
    for first in rep["tokens"].values():
        assert len(first) == batch_bits.BATCH
        assert all(-1 <= t < SMALL["new"] for t in first)
    kernel = "flash_attention" if arch == "qwen2.5-3b" else "rwkv6_scan"
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
