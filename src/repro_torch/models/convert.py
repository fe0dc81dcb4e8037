"""Carry parameters between the JAX package's tree and the port's model.

:func:`params_from_jax` takes the JAX parameter tree with ``np.asarray``
applied to every leaf (fp32 masters, ``blocks.pos{i}`` stacked over
``n_groups``) and builds a :class:`~repro_torch.models.transformer.
Transformer` from it; :func:`params_to_numpy` gives the tree back, in the
same layout, from a model.  The two round-trip exactly for a float32
config (a bfloat16 model holds its matmul weights rounded to bfloat16).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.runtime import resolve_device
from .config import ModelConfig
from .params import map_tree
from .transformer import Transformer


def tree_from_jax(tree: Dict[str, Any], *, device: Any = None
                  ) -> Dict[str, Any]:
    """A JAX parameter tree of numpy arrays as the same tree of tensors, in
    the arrays' dtypes, on ``device`` (default: the card) — what
    :class:`Transformer` and the decode engine take."""
    dev = resolve_device("cuda" if device is None else device)
    return map_tree(lambda a: torch.tensor(np.asarray(a), device=dev), tree)


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any], *,
                    device: Any = None) -> Transformer:
    """The port's model from a JAX parameter tree of numpy arrays, on
    ``device`` (default: the card).  Raises ``ValueError`` on any leaf the
    model does not consume, any leaf it lacks and any shape that differs
    from the spec."""
    return Transformer(cfg, tree_from_jax(tree, device=device))


def params_to_numpy(model: Transformer) -> Dict[str, Any]:
    """The model's parameters as the JAX package's tree of float32 numpy
    arrays (block leaves restacked over ``n_groups``)."""
    cfg = model.cfg

    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().to(torch.float32).cpu().numpy()

    blocks: Dict[str, Any] = {}
    for i in range(cfg.period):
        layers = [model.layers[layer]
                  for layer in range(i, cfg.n_layers, cfg.period)]
        blocks[f"pos{i}"] = {
            name: {leaf: np.stack([arr(lay[name][leaf]) for lay in layers])
                   for leaf in sub.keys()}
            for name, sub in layers[0].items()}
    return {"embed": {k: arr(v) for k, v in model.embed.items()},
            "final_norm": {k: arr(v) for k, v in model.final_norm.items()},
            "blocks": blocks}
