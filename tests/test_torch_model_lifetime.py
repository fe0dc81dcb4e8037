"""A model, and a train step's state, are freed when dropped, without the
cycle collector.

``Transformer.__init__`` builds its parameter dicts with a recursive
closure; a recursive closure is a reference cycle, and one that reaches
the trainable model's parameter list keeps every parameter (and with it
the f32 master tree's storage) alive until the cycle collector runs.  On
the card that held a full-depth train loop's previous model beside the
next (peak device memory 40.084 GiB against 27.673 GiB).  These tests run
with the collector off, so a cycle shows as a parameter still alive.
"""

import dataclasses
import gc
import weakref

import pytest
import torch

from repro_torch import configs
from repro_torch.models.params import init_params
from repro_torch.models.transformer import Transformer, model_spec
from repro_torch.optim import wsd_schedule
from repro_torch.train import step as step_mod
from repro_torch.train.step import TrainConfig, init_train_state

CFG = dataclasses.replace(configs.get("stablelm-1.6b").reduced(), n_layers=2)


@pytest.fixture
def no_collector():
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _refs(model):
    return [weakref.ref(model)] + [weakref.ref(p) for p in model.parameters()]


@pytest.mark.parametrize("trainable", [True, False])
def test_a_dropped_model_frees_its_parameters(no_collector, trainable):
    tree = init_params(model_spec(CFG), 0, device="cpu")
    model = Transformer(CFG, tree, trainable=trainable)
    refs = _refs(model)
    assert len(refs) > 10
    del model, tree
    assert all(r() is None for r in refs)


def test_a_dropped_train_state_frees_its_model(no_collector, monkeypatch):
    made = []

    class Recorded(Transformer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(_refs(self))

    monkeypatch.setattr(step_mod, "Transformer", Recorded)
    tcfg = TrainConfig(remat="none")
    state = init_train_state(CFG, tcfg, 0, device="cpu")
    step = step_mod.make_train_step(CFG, tcfg, wsd_schedule(1e-3, 10))
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    state, metrics = step(state, {"tokens": tokens, "labels": tokens})
    assert torch.isfinite(metrics["loss"])
    assert len(made) == 1
    del state, step, metrics
    assert all(r() is None for r in made[0])
