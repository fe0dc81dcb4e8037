"""Straggler mitigation of the port (``repro_torch.launch.straggler``): the
JAX package's ``tests/test_straggler.py`` case by case, plus the port's own
hazard — its train step updates the state in place, so a backup raced on a
snapshot must leave the winner's parameters equal to one unraced step bit
for bit, and the losing primary must not touch them.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.launch.straggler import BackupStepRunner as JRunner
from repro_torch.configs import get
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.launch.straggler import BackupStepRunner
from repro_torch.models.params import leaves_with_path
from repro_torch.optim import wsd_schedule
from repro_torch.train.step import (TrainConfig, clone_train_state,
                                    init_train_state, make_train_step)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ranks import one_thread  # noqa: E402,F401


def _step(x, w):
    return x @ w + 1.0


def test_no_backups_when_healthy():
    runner = BackupStepRunner(_step, threshold=50.0)
    x, w = torch.ones(32, 32), torch.eye(32)
    for _ in range(5):
        out = runner(x, w)
    assert torch.equal(out, x @ w + 1.0)
    assert runner.stats.steps == 5
    assert runner.stats.backups_fired == 0
    runner.close()


def test_backup_fires_and_result_is_identical():
    """Step 3's primary dispatch straggles for 2 s; the backup wins with
    the same bits, and the counters read as the JAX runner's on the same
    schedule."""
    delays = {3: 2.0}
    x = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    gold = _step(xt, wt)
    runner = BackupStepRunner(_step, threshold=3.0, warmup_steps=2,
                              delay_hook=lambda s: delays.get(s, 0.0))
    outs = [runner(xt, wt) for _ in range(5)]
    for o in outs:
        assert torch.equal(o, gold)
    np.testing.assert_allclose(gold.numpy(), np.asarray(_step(
        jnp.asarray(x), jnp.asarray(w))), rtol=1e-5, atol=1e-4)
    assert runner.stats.backups_fired >= 1
    assert runner.stats.backups_won >= 1       # backup beats a 2 s straggle
    runner.close(wait=True)
    jrunner = JRunner(jax.jit(lambda a, b: a @ b + 1.0), threshold=3.0,
                      warmup_steps=2, delay_hook=lambda s: delays.get(s, 0.0))
    for _ in range(5):
        jrunner(jnp.asarray(x), jnp.asarray(w))
    assert (runner.stats.steps, runner.stats.backups_fired,
            runner.stats.backups_won) == (jrunner.stats.steps,
                                          jrunner.stats.backups_fired,
                                          jrunner.stats.backups_won)
    jrunner.close()


def _train_setup(n_layers):
    cfg = dataclasses.replace(get("minicpm-2b").reduced(), n_layers=n_layers)
    tcfg = TrainConfig(total_steps=10)
    step = make_train_step(cfg, tcfg, wsd_schedule(1e-2, 10))
    state = init_train_state(cfg, tcfg, 0, device="cpu")
    batch = SyntheticLMData(DataConfig(2, 16, cfg.vocab, seed=0),
                            cfg).batch_at(0)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    return step, state, batch


def _bits(state):
    return {p: t.detach().clone() for p, t in leaves_with_path(state)}


def _assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for p in a:
        assert a[p].dtype == b[p].dtype and torch.equal(
            a[p].view(torch.uint8) if a[p].dim() else a[p],
            b[p].view(torch.uint8) if b[p].dim() else b[p]), p


def test_clone_train_state_shares_no_tensor():
    _step_fn, state, _batch = _train_setup(n_layers=1)
    copy = clone_train_state(state)
    _assert_same_bits(_bits(copy), _bits(state))
    ptrs = {t.data_ptr() for _, t in leaves_with_path(state)}
    assert not ptrs & {t.data_ptr() for _, t in leaves_with_path(copy)}
    for _, t in leaves_with_path(copy):
        t.add_(1)
    _assert_same_bits(_bits(state), _bits(clone_train_state(state)))


def test_raced_in_place_train_step_equals_one_unraced_step():
    """The primary straggles 1.5 s; the backup runs the step on the
    snapshot taken before the primary's dispatch and wins.  The returned
    state equals one unraced step of the same state bit for bit, and stays
    so after the losing primary has finished its own in-place update of
    the caller's original state (which then equals it too: one step, not
    two)."""
    step, state, batch = _train_setup(n_layers=1)
    ref, ref_metrics = step(clone_train_state(state), batch)
    want = _bits(ref)
    runner = BackupStepRunner(step, warmup_steps=0, threshold=1.0,
                              delay_hook=lambda s: 1.5 if s == 0 else 0.0)
    won, metrics = runner(state, batch)
    assert runner.stats.backups_fired == 1 and runner.stats.backups_won == 1
    assert won is not state
    _assert_same_bits(_bits(won), want)
    assert torch.equal(metrics["loss"], ref_metrics["loss"])
    runner.close(wait=True)                      # the primary has finished
    _assert_same_bits(_bits(won), want)
    _assert_same_bits(_bits(state), want)


def test_concurrent_steps_on_separate_states_each_step_once():
    """The step's model binding is shared by every caller of one step
    function: four threads (more than a raced pair) step four copies of
    one state twice each, at once, with a short switch interval, so the
    binding is replaced at nearly every call; each copy must equal two
    unraced steps bit for bit (a torn binding would train one thread's
    model on another's state, updating one copy twice and another never)."""
    import sys
    import threading
    STEPS = 2
    step, state, batch = _train_setup(n_layers=1)
    copies = [clone_train_state(state) for _ in range(4)]
    errors = []

    def work(s):
        try:
            for _ in range(STEPS):
                step(s, batch)
        except Exception as e:                  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(c,)) for c in copies]
    old_interval, old_threads = sys.getswitchinterval(), torch.get_num_threads()
    sys.setswitchinterval(1e-6)
    torch.set_num_threads(1)
    try:
        ref = clone_train_state(state)
        for _ in range(STEPS):
            step(ref, batch)
        want = _bits(ref)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old_interval)
        torch.set_num_threads(old_threads)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for c in copies:
        _assert_same_bits(_bits(c), want)
