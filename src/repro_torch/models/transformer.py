"""The model stack: embed → one module per layer → norm → logits.

The JAX package's ``models/transformer.py`` in PyTorch, for the serving
path of dense decoder stacks: blocks of kind ``attn`` with a ``dense`` MLP
and no modality frontend (qwen2.5-3b, stablelm-1.6b, minicpm-2b,
mistral-large-123b).  Other block kinds, MoE MLPs and frontends raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports them.

The JAX package stacks each block position's weights over ``n_groups`` and
scans them; here :class:`Transformer` unstacks them into one
``nn.ModuleDict`` per layer and runs a Python loop.  Its parameter names
follow the JAX tree (``embed.embedding``, ``layers[i].block.wq``, ...), so
the functions of ``layers`` and ``attention`` read a layer exactly as they
read a dict of the JAX package's tensors.

Entry points (``torch.no_grad``): :func:`prefill` and :func:`decode_step`.
``forward`` and ``train_loss`` come with the training slice.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from .attention import (attend_decode, attend_full, attn_spec,
                        cache_from_prefill)
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, cdtype, embed_spec, embed_tokens,
                     logits_from_hidden, mlp_spec, mul_scalar, norm_spec,
                     residual_scale)
from .params import leaves_with_path

#: what the port does not build yet, and the ROADMAP.md item that ports it
UNPORTED = {
    "mla": "ROADMAP.md queue 1, next step 4 (MLA + MoE, deepseek)",
    "moe": "ROADMAP.md queue 1, next step 4 (MLA + MoE, deepseek)",
    "mamba": "ROADMAP.md queue 1, next step 5 (mamba_scan, jamba)",
    "rwkv": "ROADMAP.md queue 1, next step 6 (rwkv6_scan, rwkv6-3b)",
    "vision": "ROADMAP.md queue 1, next step 8 (frontends)",
    "audio": "ROADMAP.md queue 1, next step 8 (frontends)",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for an arch this slice does not build."""
    kinds = [("block", k) for k in cfg.block_pattern if k != "attn"]
    kinds += [("mlp", k) for k in cfg.mlp_pattern if k != "dense"]
    if cfg.frontend != "none":
        kinds.append(("frontend", cfg.frontend))
    if cfg.first_layer_dense:
        kinds.append(("first layer", cfg.block_pattern[0]))
    if kinds:
        what, kind = kinds[0]
        raise NotImplementedError(
            f"{cfg.name}: {what} {kind!r} is not ported to PyTorch yet; "
            f"{UNPORTED.get(kind, 'ROADMAP.md queue 1')} ports it")


# ---------------------------------------------------------------------------
# Parameter tree
# ---------------------------------------------------------------------------
def _position_spec(cfg: ModelConfig, stacked: int):
    return {"norm1": norm_spec(cfg, stacked),
            "block": attn_spec(cfg, stacked),
            "norm2": norm_spec(cfg, stacked),
            "mlp": mlp_spec(cfg, cfg.d_ff, stacked)}


def model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX package's parameter tree (``blocks.pos{i}`` stacked over
    ``n_groups``) for an arch this slice builds."""
    check_supported(cfg)
    return {
        "embed": embed_spec(cfg),
        "final_norm": norm_spec(cfg),
        "blocks": {f"pos{i}": _position_spec(cfg, cfg.n_groups)
                   for i in range(cfg.period)},
    }


def _is_norm(path: str) -> bool:
    """True for a leaf of a norm (kept in float32): its parent key names one."""
    return "norm" in re.findall(r"\['([^']*)'\]", path)[-2]


class Transformer(nn.Module):
    """A dense decoder stack built from a parameter tree in the JAX layout
    (:func:`model_spec`; :func:`~repro_torch.models.params.init_params`
    makes one, :func:`~repro_torch.models.convert.params_from_jax` carries
    the JAX package's across).

    The tree's ``(n_groups, ...)`` block leaves are unstacked into
    ``layers[l]`` (group ``l // period``, position ``l % period``).
    Matmul weights, biases and the embedding are cast once to the compute
    dtype ``cfg.dtype``; norm parameters are kept in float32.  Raises
    ``ValueError`` on a missing leaf, a leaf it did not consume, or a
    shape that differs from the spec.  The module lives on the tree's
    device and holds no gradients.
    """

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        spec = model_spec(cfg)
        self.cfg = cfg
        got = dict(leaves_with_path(params))
        want = dict(leaves_with_path(spec))
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        if missing or extra:
            raise ValueError(f"{cfg.name}: parameter tree does not fit the "
                             f"spec: missing {missing}, not consumed {extra}")
        for path, s in want.items():
            if tuple(got[path].shape) != tuple(s.shape):
                raise ValueError(f"{cfg.name}: {path} has shape "
                                 f"{tuple(got[path].shape)}, spec {s.shape}")
        dt = cdtype(cfg)

        def param(path: str, t: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(t.to(torch.float32 if _is_norm(path) else dt),
                                requires_grad=False)

        def pdict(prefix: str, tree: Dict[str, Any], pick=lambda t: t):
            return nn.ParameterDict({
                name: param(f"{prefix}['{name}']", pick(t))
                for name, t in tree.items()})

        self.embed = pdict("['embed']", params["embed"])
        self.final_norm = pdict("['final_norm']", params["final_norm"])
        self.layers = nn.ModuleList()
        for layer in range(cfg.n_layers):
            g, i = divmod(layer, cfg.period)
            pos = params["blocks"][f"pos{i}"]
            self.layers.append(nn.ModuleDict({
                name: pdict(f"['blocks']['pos{i}']['{name}']", sub,
                            lambda t, g=g: t[g])
                for name, sub in pos.items()}))

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device


# ---------------------------------------------------------------------------
# Embedding of model inputs
# ---------------------------------------------------------------------------
def embed_inputs(model: Transformer, inputs: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """inputs: {"tokens": (B, S)} (token inputs only; the frontends'
    "patches" / "frames" come with the frontends)."""
    if set(inputs) != {"tokens"}:
        raise NotImplementedError(
            f"only token inputs are ported; got {sorted(inputs)} "
            f"({UNPORTED['vision']} ports the frontends)")
    return embed_tokens(model.embed, inputs["tokens"], model.cfg)


# ---------------------------------------------------------------------------
# One layer (shared by the prefill and decode bodies)
# ---------------------------------------------------------------------------
def _apply_position(p, x: torch.Tensor, cfg: ModelConfig, *,
                    mode: str = "prefill", cache=None, pos=None):
    """One ``attn`` + ``dense`` layer. Returns (x, new_cache): the prefill's
    (k, v), or the decode step's cache (written in place)."""
    rs = residual_scale(cfg)
    h = apply_norm(p["norm1"], x, cfg)
    if mode == "decode":
        out, new_cache = attend_decode(p["block"], h, cache, pos, cfg)
    elif mode == "prefill":
        out, new_cache = attend_full(p["block"], h, cfg, return_kv=True)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + mul_scalar(out, rs)
    h2 = apply_norm(p["norm2"], x, cfg)
    x = x + mul_scalar(apply_mlp(p["mlp"], h2, cfg), rs)
    return x, new_cache


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Cache tree in the JAX layout: {"pos{i}": {"k", "v"}}, each (n_groups,
    B, KVH, max_len, hd)."""
    check_supported(cfg)
    shape = (cfg.n_groups, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {f"pos{i}": {name: torch.zeros(shape, dtype=dtype, device=device)
                        for name in ("k", "v")}
            for i in range(cfg.period)}


def cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16) -> Dict[str, Any]:
    """The cache's shapes and dtypes as storage-less ``meta`` tensors."""
    return init_cache(cfg, batch, max_len, dtype, device="meta")


def cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes of every cache leaf, matching :func:`cache_struct`."""
    check_supported(cfg)
    axes = ("layers", "batch", "kv_heads", "kv_seq", None)
    return {f"pos{i}": {"k": axes, "v": axes} for i in range(cfg.period)}


def _layer_cache(cache: Dict[str, Any], cfg: ModelConfig, layer: int
                 ) -> Dict[str, torch.Tensor]:
    g, i = divmod(layer, cfg.period)
    return {name: t[g] for name, t in cache[f"pos{i}"].items()}


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(model: Transformer, inputs: Dict[str, torch.Tensor], max_len: int,
            cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process the prompt; -> (last-token logits (B, Vp) f32, cache at S)."""
    cfg = model.cfg
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name} is encoder-only: no prefill/decode")
    x = embed_inputs(model, inputs)
    per_pos: List[List[Dict[str, torch.Tensor]]] = [[] for _ in range(cfg.period)]
    for layer, p in enumerate(model.layers):
        x, (k, v) = _apply_position(p, x, cfg, mode="prefill")
        per_pos[layer % cfg.period].append(
            cache_from_prefill(cfg, k, v, max_len, cache_dtype))
    cache = {f"pos{i}": {name: torch.stack([c[name] for c in caches])
                         for name in ("k", "v")}
             for i, caches in enumerate(per_pos)}
    x = apply_norm(model.final_norm, x, cfg)
    logits = logits_from_hidden(model.embed, x[:, -1:], cfg)[:, 0]
    return logits, cache


@torch.no_grad()
def decode_step(model: Transformer, cache: Dict[str, Any],
                tokens: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token for every sequence.  tokens (B,) ids, pos an int.

    Returns (logits (B, Vp) f32, cache).  The cache is updated **in place**
    and returned (the JAX package returns a new one).
    """
    cfg = model.cfg
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    x = embed_tokens(model.embed, tokens[:, None], cfg)
    for layer, p in enumerate(model.layers):
        x, _ = _apply_position(p, x, cfg, mode="decode",
                               cache=_layer_cache(cache, cfg, layer), pos=pos)
    x = apply_norm(model.final_norm, x, cfg)
    logits = logits_from_hidden(model.embed, x, cfg)[:, 0]
    return logits, cache
