"""Sharded execution through the port's models on 8 gloo ranks: the
counterpart of ``tests/test_mini_mesh.py`` (the JAX package's 8-device
check), on a (data=2, model=4) ``DeviceMesh``.

* **Train**: reduced qwen2.5-3b, deepseek-v2-236b (MoE capacity 8) and
  rwkv6-3b (and, on a (data=2, model=2) mesh of 4 ranks,
  jamba-1.5-large-398b, whose Mamba block the JAX test does not reach),
  f32, batch 8 x 32, each take one step under
  ``TRAIN_FSDP_RULES`` (state placed as the JAX test's ``state_sh``, the
  FSDP weight gather in every layer) and must equal the port's own
  unsharded step: loss and gradient norm rtol 5e-5, every parameter rtol
  and atol 5e-4, and both AdamW moments of every parameter within one
  bf16 ulp (rtol 2^-7; they are kept in bf16) and 1e-5 of the leaf's
  largest entry.  The first step moves a parameter by about lr times the
  gradient's sign, which no scale of the gradient changes; the moments
  are 0.1 g and 0.001 g^2, so a gradient summed over too many ranks (a
  wrong ``Partial``) shows there.
* **Serve**: reduced qwen prefills (max_len 20) and takes one decode step
  under ``SERVE_RULES``, within rtol and atol 2e-4, with the cache split on
  T over ``model`` (the decode step's max and partial passes).

* **A strided shard**: the qwen step again on a (pod=2, data=2, model=2)
  mesh, where ``TRAIN_FSDP_RULES``' batch ``("data", "model", "pod")`` is
  laid out data-major and takes a ``_StridedShard`` on ``pod``: DTensor's
  redistributes and the step's ops must accept it.

The JAX test fails in every run of the suite, so the oracle is the port's
unsharded path, which ``tests/test_torch_train*.py`` and
``tests/test_torch_models.py`` hold against the JAX package.  The four
worlds start side by side (``torch_ranks.start_groups``).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ranks  # noqa: E402
from torch_ranks import one_thread  # noqa: E402,F401

#: the JAX test's three families on (data=2, model=4), and jamba's (the
#: Mamba block: the selective scan on each rank's blocks) on a (data=2,
#: model=2) mesh of 4 ranks, which keeps the suite's time
ARCHS = ("qwen2.5-3b", "deepseek-v2-236b", "rwkv6-3b", "jamba-1.5-large-398b")
MESH = {"jamba-1.5-large-398b": (4, (2, 2))}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Rank 0's report of each world, started together: the three train
    worlds, then the serving one."""
    groups = [(MESH.get(arch, (8,))[0], "sharded_train",
               (arch,) + MESH.get(arch, (8,))[1:]) for arch in ARCHS]
    groups.append((8, "sharded_serve", ("qwen2.5-3b",)))
    groups.append((8, "sharded_train", ("qwen2.5-3b", (2, 2, 2),
                                        ("pod", "data", "model"))))
    out = torch_ranks.run_groups(tmp_path_factory.mktemp("mini_mesh"),
                                 groups, timeout=240)
    return {name: results[0] for name, results in
            zip(list(ARCHS) + ["serve", "strided"], out)}


def _same_step(got):
    """The sharded step's loss, gradient norm, parameters and moments
    against the unsharded step's (the moments, kept in bf16, may part by
    the one ulp where the two gradients round to either side)."""
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], got["ref_" + key], rtol=5e-5,
                                   err_msg=key)
    for path, (a, b) in got["params"].items():
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4,
                                   err_msg=path)
    for part in ("m", "v"):
        for path, (a, b) in got[part].items():
            np.testing.assert_allclose(a, b, rtol=2 ** -7,
                                       atol=1e-5 * np.abs(b).max(),
                                       err_msg=f"{part} {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_unsharded_on_8_ranks(worlds, arch):
    got = worlds[arch]
    assert got["sharded"], "no leaf of the placed state was sharded"
    _same_step(got)


def test_sharded_serving_equals_unsharded_on_8_ranks(worlds):
    got = worlds["serve"]
    assert got["t_split"] and got["local_t"] == 20 // 4
    for key in ("logits", "step"):
        a, b = got[key]
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4, err_msg=key)


def test_a_strided_batch_shard_steps_as_unsharded(worlds):
    got = worlds["strided"]
    assert got["batch"] == ["_StridedShard", "Shard", "Shard"], got["batch"]
    _same_step(got)
