"""Carry parameters between the JAX package's tree and the port's model.

:func:`params_from_jax` takes the JAX parameter tree with ``np.asarray``
applied to every leaf (fp32 masters, ``blocks.pos{i}`` stacked over
``n_groups``) and builds a :class:`~repro_torch.models.transformer.
Transformer` from it; :func:`params_to_numpy` gives the tree back, in the
same layout, from a model: the stacked block leaves (the MoE's expert
leaves are 4-D, (n_groups, E, in, out)), deepseek's unstacked ``layer0``
and paligemma's ``frontend``.  The two round-trip exactly for a float32
config (a bfloat16 model holds its matmul weights rounded to bfloat16).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.runtime import resolve_device
from .config import ModelConfig
from .params import map_tree
from .transformer import Transformer, n_scanned


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

    def stacked(nodes) -> Any:
        """The same leaf of every group's layer, stacked (nested dicts of
        the layers, such as the MoE's shared experts, recurse)."""
        if isinstance(nodes[0], torch.Tensor):
            return np.stack([arr(t) for t in nodes])
        return {k: stacked([n[k] for n in nodes]) for k in nodes[0].keys()}

    def plain(node) -> Any:
        if isinstance(node, torch.Tensor):
            return arr(node)
        return {k: plain(node[k]) for k in node.keys()}

    blocks = {f"pos{i}": stacked([model.layers[layer] for layer in
                                  range(i, n_scanned(cfg), cfg.period)])
              for i in range(cfg.period)}
    tree = {"embed": plain(model.embed), "final_norm": plain(model.final_norm),
            "blocks": blocks}
    if model.layer0 is not None:
        tree["layer0"] = plain(model.layer0)
    if model.frontend is not None:
        tree["frontend"] = plain(model.frontend)
    return tree
