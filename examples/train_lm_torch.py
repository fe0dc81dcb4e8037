"""End to end on the port: train a ~86M LM for a few hundred steps.

``examples/train_lm.py`` on the port's training path — the model configs,
the synthetic data pipeline, AdamW (bf16 moments) + WSD schedule, async
rotating checkpoints — with a reduced-but-not-tiny qwen2.5 config (12
layers of width 768, ~86M parameters).  Runs on the card by default
(``--device cpu`` for the CPU); the loss drops from ~log(V) toward the
noisy-bigram entropy floor of the synthetic stream, and must fall by 0.5.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 150]
      [--device cpu] [--ckpt-dir DIR]
"""

import argparse
import math

from repro_torch.configs import example_config
from repro_torch.launch.train import train_loop
from repro_torch.models.params import param_bytes
from repro_torch.models.transformer import model_spec
from repro_torch.train.step import TrainConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint every 100 steps there, and resume from "
                         "its latest checkpoint")
    args = ap.parse_args()

    cfg = example_config()
    print(f"model: {cfg.name} — "
          f"{param_bytes(model_spec(cfg)) // 4 / 1e6:.0f}M params")
    tcfg = TrainConfig(peak_lr=3e-3, total_steps=args.steps, remat="none")
    _, losses = train_loop(cfg, tcfg, steps=args.steps,
                           global_batch=args.batch, seq_len=args.seq,
                           ckpt_dir=args.ckpt_dir, ckpt_every=100,
                           log_every=20, device=args.device)
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(uniform = {math.log(cfg.vocab):.2f})")
    assert losses[-1] < losses[0] - 0.5, "training did not learn"
    print("train_lm OK")


if __name__ == "__main__":
    main()
