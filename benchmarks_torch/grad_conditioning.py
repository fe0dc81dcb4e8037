"""How far a relative change of 1e-7 in the parameters moves a model's own
f32 gradients, on the CPU.

The training rule holds each leaf's gradient to 1e-4 of that leaf's largest
magnitude, against the JAX package on the CPU and against the CPU on the
card.  Two correct f32 computations that sum in another order differ by
about what a last-bit change of the inputs does to the result; where that
is more than 1e-4, the rule cannot tell them apart, and a cut that small
changes move so far is no yardstick.  This script measures it for a cut of
one arch: the parameters drawn from ``init_params(seed 0)`` (at full
width, as ``chip_smoke.py``'s f32 cuts draw them; ``--reduced`` for the
arch's ``reduced()`` config, as the CPU tests run it), the batch the
shared pipeline makes (``--batch`` x ``--seq`` tokens, step 0), each leaf
multiplied by ``1 + eps * N(0, 1)`` (torch seed 1), and the gradients of
the two runs compared leaf by leaf::

    PYTHONPATH=src python -m benchmarks_torch.grad_conditioning --arch rwkv6-3b --layers 2
    PYTHONPATH=src python -m benchmarks_torch.grad_conditioning --arch jamba-1.5-large-398b --layers 8 --reduced

``--layers`` keeps the first layers of the arch's block and mlp patterns
(jamba's first four are mamba + dense, mamba + MoE, mamba + dense, attn +
MoE).  Prints the worst leaves, change / largest |g| of the unperturbed
run.  Runs the port's plain versions only (CPU tensors), no card.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Tuple

import torch


def cut_config(arch: str, layers: int, reduced: bool):
    """``arch``'s first ``layers`` layers in f32, at full width unless
    ``reduced``."""
    from repro_torch.configs import get
    cfg = get(arch).reduced() if reduced else get(arch)
    return dataclasses.replace(
        cfg, n_layers=layers, block_pattern=cfg.block_pattern[:layers],
        mlp_pattern=cfg.mlp_pattern[:layers], dtype="float32")


def gradients(cfg, tree, batch) -> Dict[str, torch.Tensor]:
    from repro_torch.models.params import leaves_with_path, map_tree
    from repro_torch.models.transformer import Transformer, bind_grads
    from repro_torch.train.step import value_and_grad
    params = map_tree(torch.clone, tree)
    model = Transformer(cfg, params, trainable=True)
    grads = map_tree(torch.zeros_like, params)
    bind_grads(model, grads)
    value_and_grad(model, grads, map_tree(torch.from_numpy, batch), cfg)
    return dict(leaves_with_path(grads))


def run(arch: str, layers: int, *, reduced: bool = False, batch: int = 2,
        seq: int = 128, eps: float = 1e-7) -> List[Tuple[float, str]]:
    """[(change / max |g|, leaf path)] for every leaf, worst first."""
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models.params import init_params, map_tree
    from repro_torch.models.transformer import model_spec
    cfg = cut_config(arch, layers, reduced)
    tree = init_params(model_spec(cfg), 0, device="cpu")
    data = SyntheticLMData(DataConfig(batch, seq, cfg.vocab), cfg).batch_at(0)
    base = gradients(cfg, tree, data)
    gen = torch.Generator().manual_seed(1)
    moved = map_tree(lambda t: t * (1 + eps * torch.randn(t.shape,
                                                          generator=gen)),
                     tree)
    other = gradients(cfg, moved, data)
    rows = []
    for path, g in base.items():
        scale = float(g.abs().max())
        change = float((other[path] - g).abs().max())
        rows.append((change / scale if scale else change, path))
    return sorted(rows, reverse=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--eps", type=float, default=1e-7)
    args = ap.parse_args()
    rows = run(args.arch, args.layers, reduced=args.reduced,
               batch=args.batch, seq=args.seq, eps=args.eps)
    width = "reduced" if args.reduced else "full width"
    print(f"{args.arch}, first {args.layers} layers at {width}, "
          f"{args.batch} x {args.seq} tokens, parameters x (1 + "
          f"{args.eps:g} N(0, 1)): gradient change / max |g|, worst leaves:")
    for rel, path in rows[:5]:
        print(f"  {rel:.3g} {path}")


if __name__ == "__main__":
    main()
