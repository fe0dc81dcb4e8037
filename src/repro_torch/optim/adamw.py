"""AdamW with bf16 moments and global-norm clipping.

The JAX package's ``optim/adamw.py``, with the same f32 update math term by
term: the clip scale ``min(1, clip / max(|g|, 1e-9))``, bias corrections
``1 - b ** step`` in f32 (on the host, as the JAX code's 0-d ops give
them), decay on leaves of two or more dimensions only (a stacked norm scale
or bias, (n_groups, d), is decayed, as in the JAX tree), moments stored in
``moment_dtype`` (bf16 by default, rounded to nearest even).  f32 masters
with bf16 moments take 12 bytes a parameter with their f32 gradient.

Unlike the JAX functions, which return new trees, :func:`adamw_update`
writes parameters and moments **in place** (a moment leaf whose dtype is not
``moment_dtype``, such as :func:`adamw_init`'s bf16 zeros under an f32
``moment_dtype``, is replaced in the tree instead): the trainer never holds
two copies of the state.  The update runs as ``torch._foreach_*`` ops over
groups of leaves of at most :data:`GROUP_ELEMENTS` elements, which bounds
the f32 temporaries; plain PyTorch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from ..models.params import leaves_with_path

#: elements of the leaves one group of foreach ops updates at a time (a
#: larger leaf makes a group of its own)
GROUP_ELEMENTS = 2 ** 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Any = torch.bfloat16


def _zeros_like_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v, dtype) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=dtype, device=tree.device)


def adamw_init(params) -> Dict[str, Any]:
    """(m, v, step): moments bf16 zeros on each parameter's device (as the
    JAX package makes them, whatever ``moment_dtype``), step a 0-d int32 on
    the host."""
    return {"m": _zeros_like_tree(params, torch.bfloat16),
            "v": _zeros_like_tree(params, torch.bfloat16),
            "step": torch.zeros((), dtype=torch.int32)}


def _groups(leaves: List[torch.Tensor]) -> List[List[int]]:
    """Consecutive leaf indices in groups of at most GROUP_ELEMENTS
    elements."""
    out: List[List[int]] = []
    size = 0
    for i, t in enumerate(leaves):
        if not out or size + t.numel() > GROUP_ELEMENTS:
            out.append([])
            size = 0
        out[-1].append(i)
        size += t.numel()
    return out


def _f32(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    return [t.float() for t in ts]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a 0-d tensor on the
    leaves' device)."""
    leaves = [t for _, t in leaves_with_path(tree)]
    norms = []
    for idx in _groups(leaves):
        norms += torch._foreach_norm(_f32([leaves[i] for i in idx]))
    return torch.sqrt(torch.stack(norms).square().sum())


def _set(tree: Dict[str, Any], path: str, value: torch.Tensor) -> None:
    """Rebind the leaf at ``path`` (``leaves_with_path``'s format)."""
    keys = path[2:-2].split("']['")
    for key in keys[:-1]:
        tree = tree[key]
    tree[keys[-1]] = value


def adamw_update(params, grads, state, lr, cfg: AdamWConfig = AdamWConfig()
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  ``lr`` is a float or a 0-d tensor (a
    schedule's value).  Returns (params, state, metrics), the trees
    themselves, with ``state["step"]`` advanced; metrics are ``grad_norm``
    and ``clip_scale`` (0-d f32 on the parameters' device)."""
    paths, ps = zip(*leaves_with_path(params))
    gs = [t for _, t in leaves_with_path(grads)]
    ms = [t for _, t in leaves_with_path(state["m"])]
    vs = [t for _, t in leaves_with_path(state["v"])]
    gnorm = global_norm(grads)
    clip = torch.full_like(gnorm, cfg.clip_norm)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"] + 1
    c1 = float(1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32),
                               step.float()))
    c2 = float(1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32),
                               step.float()))
    lr = float(lr)
    for idx in _groups(list(ps)):
        p32 = _f32([ps[i] for i in idx])
        g = torch._foreach_mul(_f32([gs[i] for i in idx]), scale)
        m32 = torch._foreach_mul(_f32([ms[i] for i in idx]), cfg.b1)
        torch._foreach_add_(m32, torch._foreach_mul(g, 1 - cfg.b1))
        v32 = torch._foreach_mul(_f32([vs[i] for i in idx]), cfg.b2)
        gg = torch._foreach_mul(g, 1 - cfg.b2)
        torch._foreach_mul_(gg, g)
        torch._foreach_add_(v32, gg)
        del g, gg
        den = torch._foreach_sqrt(torch._foreach_div(v32, c2))
        torch._foreach_add_(den, cfg.eps)
        delta = torch._foreach_div(torch._foreach_div(m32, c1), den)
        del den
        mats = [k for k, i in enumerate(idx) if ps[i].dim() >= 2]
        if mats:                             # decay matrices, not norms/bias
            torch._foreach_add_([delta[k] for k in mats], torch._foreach_mul(
                [p32[k] for k in mats], cfg.weight_decay))
        new_p = torch._foreach_sub(p32, torch._foreach_mul(delta, lr))
        del delta, p32
        for k, i in enumerate(idx):
            ps[i].copy_(new_p[k])
            for tree, leaf, new in ((state["m"], ms[i], m32[k]),
                                    (state["v"], vs[i], v32[k])):
                if leaf.dtype == cfg.moment_dtype:
                    leaf.copy_(new)
                else:
                    _set(tree, paths[i], new.to(cfg.moment_dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "clip_scale": scale}
