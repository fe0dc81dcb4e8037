"""The port's data pipeline draws the JAX package's batches bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMData as JSyntheticLMData
from repro.data import make_batch_struct as j_make_batch_struct
from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticLMData, make_batch_struct


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "paligemma-3b",
                                  "hubert-xlarge"])
@pytest.mark.parametrize("seed", [0, 7])
def test_batches_equal_the_reference(arch, seed):
    """tokens (a text model), + patches (vision), frames for tokens
    (audio); every step's arrays equal, dtype included."""
    cfg, jcfg = configs.get(arch).reduced(), jconfigs.ARCHS[arch].reduced()
    ours = SyntheticLMData(DataConfig(4, 16, cfg.vocab, seed=seed), cfg)
    ref = JSyntheticLMData(JDataConfig(4, 16, cfg.vocab, seed=seed), jcfg)
    for step, got in zip((0, 1, 5), (ours.batch_at(0), ours.batch_at(1),
                                     ours.batch_at(5))):
        want = ref.batch_at(step)
        assert got.keys() == want.keys()
        for name in want:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name])
    it = iter(ours)
    np.testing.assert_array_equal(next(it)["labels"], ref.batch_at(0)["labels"])
    np.testing.assert_array_equal(next(it)["labels"], ref.batch_at(1)["labels"])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "paligemma-3b",
                                  "hubert-xlarge"])
def test_batch_struct_matches_the_reference(arch):
    cfg = dataclasses.replace(configs.get(arch), dtype="float32")
    got = make_batch_struct(DataConfig(8, 128, cfg.vocab), cfg)
    want = j_make_batch_struct(JDataConfig(8, 128, cfg.vocab),
                               jconfigs.ARCHS[arch])
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[name].shape)
        assert str(t.dtype).replace("torch.", "") == str(want[name].dtype)
    assert make_batch_struct(DataConfig(2, 4, 10)).keys() == {"tokens",
                                                              "labels"}
    assert isinstance(got["labels"], torch.Tensor)
