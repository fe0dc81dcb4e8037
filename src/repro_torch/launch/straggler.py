"""Straggler mitigation: timeout-and-backup dispatch for train steps.

The JAX package's ``launch/straggler.py``.  At scale the slowest
participant sets the step time; hosts also stall on preemption, page faults
or flaky NICs.  The data pipeline is a pure function of (seed, step), so a
straggling dispatch can be RACED by a backup dispatch of the same step —
whichever completes first wins, and determinism makes them equal.

:class:`BackupStepRunner` wraps a step:

* per-step wall time keeps an EMA;
* a dispatch exceeding ``threshold x EMA`` (or ``hard_timeout_s``) gets a
  backup dispatch; the first completion wins;
* stragglers are counted for the ops dashboard.

A dispatch ends with a synchronize of the device its outputs lie on (JAX's
``block_until_ready``).

**In-place steps.**  The JAX step is pure; the port's train step updates
the parameters and moments in place (``optim/adamw.py``).  A backup raced
against the primary on the same state would update it twice, or tear it.
So the two never share mutable state: before every primary dispatch the
runner copies the step's first argument (the state) with
:func:`~repro_torch.train.step.clone_train_state`, which clones every
tensor of a tree and leaves the rest alone; the primary runs on the
caller's objects and a backup on the copy, and the winner's outputs are
returned.  The caller goes on with the
returned state (``state, metrics = runner(state, batch)``), never the one
it passed in: a losing primary may still be writing to it.  The price is a
second copy of the state a step.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from ..train.step import clone_train_state


@dataclasses.dataclass
class StragglerStats:
    steps: int = 0
    backups_fired: int = 0
    backups_won: int = 0
    ema_s: float = 0.0


def _sync(out: Any) -> None:
    """Wait for the device work behind ``out`` (any tensors in nested
    tuples, lists and dicts): a synchronize of the first CUDA device found;
    CPU results are already computed."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)


class BackupStepRunner:
    """Races a backup dispatch when the primary step straggles."""

    def __init__(self, step_fn: Callable[..., Any], *,
                 threshold: float = 3.0, warmup_steps: int = 2,
                 hard_timeout_s: float = 120.0,
                 delay_hook: Optional[Callable[[int], float]] = None):
        """``delay_hook(step) -> seconds`` injects artificial straggle into
        the PRIMARY dispatch (test/simulation only)."""
        self.step_fn = step_fn
        self.threshold = threshold
        self.warmup = warmup_steps
        self.hard_timeout_s = hard_timeout_s
        self.delay_hook = delay_hook
        self.stats = StragglerStats()
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)

    def _dispatch(self, args, kwargs, delay: float = 0.0):
        if delay:
            time.sleep(delay)
        out = self.step_fn(*args, **kwargs)
        _sync(out)
        return out

    def __call__(self, *args, **kwargs):
        st = self.stats
        step_idx = st.steps
        delay = self.delay_hook(step_idx) if self.delay_hook else 0.0
        # the backup's own copy of the state, taken before the primary can
        # touch it (the module docstring)
        backup_args = ((clone_train_state(args[0]),) + tuple(args[1:])
                       if args else args)
        t0 = time.perf_counter()
        primary = self._pool.submit(self._dispatch, args, kwargs, delay)

        budget = (self.hard_timeout_s if st.steps < self.warmup
                  else min(self.hard_timeout_s,
                           max(self.threshold * st.ema_s, 1e-3)))
        try:
            out = primary.result(timeout=budget)
        except concurrent.futures.TimeoutError:
            st.backups_fired += 1
            backup = self._pool.submit(self._dispatch, backup_args, kwargs,
                                       0.0)
            done, _ = concurrent.futures.wait(
                (primary, backup),
                return_when=concurrent.futures.FIRST_COMPLETED)
            winner = done.pop()
            if winner is backup:
                st.backups_won += 1
            out = winner.result()
        dt = time.perf_counter() - t0
        st.ema_s = dt if st.steps == 0 else 0.8 * st.ema_s + 0.2 * dt
        st.steps += 1
        return out

    def close(self, wait: bool = False):
        """Shut the pool down; ``wait=True`` joins a losing dispatch that is
        still running."""
        self._pool.shutdown(wait=wait, cancel_futures=True)
