"""The trainer: data pipeline → train step → async checkpoints.

The JAX package's ``launch/train.py`` for one device, on the card unless
``--device cpu`` is given::

    python -m repro_torch.launch.train [--arch stablelm-1.6b] [--smoke]
        [--steps 100] [--batch 8] [--seq 128] [--device cuda] ...

* ``--arch <id> --smoke`` — the reduced config (f32, one group of layers),
  which runs on the CPU too; without it, the arch at full width and depth;
* fault tolerance: deterministic (seed, step)-keyed data, async rotating
  checkpoints every ``--ckpt-every`` steps, restore-on-start from the latest
  checkpoint; ``--simulate-failure k`` exits with code 42 after step k, so
  tests exercise the restart path.

The distribution layer (``repro_torch.distributed``: sharding rules as
DTensor placements, the int8 compressed all-reduce; elastic restore through
``checkpoint.restore_sharded``; ``launch.mesh``, ``launch.straggler``) is
ported, and so is sharded execution through the models: a step made by
``make_train_step`` and run under ``distributed.sharding.activate(rules,
mesh)`` on a state placed by ``param_shardings`` / ``distribute_tree``
trains with the models' ``constrain`` hooks, the FSDP weight gather and
the context-parallel attention (``tests/test_torch_mini_mesh.py`` runs it
on 8 gloo ranks).  This launcher itself runs one process on one device.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import ARCHS
from ..core.runtime import resolve_device
from ..data import DataConfig, SyntheticLMData
from ..models.params import map_tree
from ..models.transformer import model_spec
from ..optim import wsd_schedule
from ..train.step import TrainConfig, init_train_state, make_train_step


def build_host_trainer(cfg, tcfg: TrainConfig, seed: int = 0, *,
                       device=None):
    """One-device trainer: (step_fn, state, spec), the state's parameters
    drawn from ``seed`` on ``device`` (default: the card) in
    ``tcfg.param_dtype``; the learning rate follows the WSD schedule over
    ``tcfg.total_steps``."""
    step_fn = make_train_step(cfg, tcfg, wsd_schedule(tcfg.peak_lr,
                                                      tcfg.total_steps))
    state = init_train_state(cfg, tcfg, seed, device=device)
    return step_fn, state, model_spec(cfg)


def _to_state_devices(restored, like):
    """A restored tree (CPU tensors) moved leaf by leaf to where ``like``'s
    leaves live (the step counter stays on the host)."""
    if isinstance(restored, dict):
        return {k: _to_state_devices(v, like[k]) for k, v in restored.items()}
    return restored.to(like.device)


def train_loop(cfg, tcfg: TrainConfig, *, steps: int, global_batch: int,
               seq_len: int, seed: int = 0, ckpt_dir: str | None = None,
               ckpt_every: int = 50, log_every: int = 10,
               simulate_failure: int = 0, device=None):
    """Train ``steps`` steps on ``device`` (default: the card); -> (state,
    per-step losses as floats).  With ``ckpt_dir``, restores the latest
    checkpoint first and saves every ``ckpt_every`` steps (tagged step + 1:
    the saved state has that step applied) and at the end."""
    dev = resolve_device("cuda" if device is None else device)
    step_fn, state, _spec = build_host_trainer(cfg, tcfg, seed, device=dev)
    data = SyntheticLMData(
        DataConfig(global_batch, seq_len, cfg.vocab, seed=seed), cfg)

    start = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3)
        latest = mgr.latest_step()
        if latest is not None:
            restored, manifest = mgr.restore_latest(like=state)
            state = _to_state_devices(restored, state)
            start = manifest["step"]
            print(f"[train] restored step {start} from {ckpt_dir}")

    losses = []
    t0 = time.perf_counter()
    for step in range(start, steps):
        batch = map_tree(lambda a: torch.from_numpy(a).to(dev),
                         data.batch_at(step))
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if step % log_every == 0 or step == steps - 1:
            dt = time.perf_counter() - t0
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} ({dt:.1f}s)",
                  flush=True)
        if mgr and step > start and step % ckpt_every == 0:
            # tag with step+1: the saved state has THIS step applied, so a
            # restore resumes at the next step (no double-apply)
            mgr.save_async(state, step + 1,
                           meta={"arch": cfg.name, "seed": seed})
        if simulate_failure and step == simulate_failure:
            print(f"[train] simulating failure at step {step}", flush=True)
            if mgr:
                mgr.wait()
            sys.exit(42)
    if mgr:
        mgr.save_async(state, steps, meta={"arch": cfg.name, "seed": seed})
        mgr.wait()
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--simulate-failure", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = cfg.reduced()
    tcfg = TrainConfig(peak_lr=args.lr, total_steps=args.steps,
                       remat=args.remat, microbatches=args.microbatches)
    _, losses = train_loop(
        cfg, tcfg, steps=args.steps, global_batch=args.batch,
        seq_len=args.seq, seed=args.seed, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, simulate_failure=args.simulate_failure,
        device=args.device)
    print(f"[train] done: first loss {losses[0]:.4f} "
          f"last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
