"""The model stack: embed → one module per layer → norm → logits.

The JAX package's ``models/transformer.py`` in PyTorch, for the serving
path of decoder stacks with no modality frontend whose blocks are ``attn``
with a ``dense`` MLP (qwen2.5-3b, stablelm-1.6b, minicpm-2b,
mistral-large-123b) or ``rwkv`` carrying its own channel-mix (rwkv6-3b).
Other block kinds, MoE MLPs and frontends raise ``NotImplementedError``
naming the ``ROADMAP.md`` item that ports them.

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
from .params import leaves_with_path, state_device
from .rwkv import (F32_LEAVES, init_rwkv_state, rwkv_channel_mix, rwkv_spec,
                   rwkv_time_mix)

#: what the port does not build yet, and the ROADMAP.md item that ports it
UNPORTED = {
    "mla": "ROADMAP.md queue 1, next step 4 (MLA + MoE, deepseek)",
    "moe": "ROADMAP.md queue 1, next step 4 (MLA + MoE, deepseek)",
    "mamba": "ROADMAP.md queue 1, next step 5 (mamba_scan, jamba)",
    "vision": "ROADMAP.md queue 1, next step 8 (frontends)",
    "audio": "ROADMAP.md queue 1, next step 8 (frontends)",
}


#: (block kind, mlp kind) pairs the port builds
PORTED = {("attn", "dense"), ("rwkv", "none")}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for an arch this slice does not build."""
    blocks = {kind for kind, _ in PORTED}
    pairs = list(zip(cfg.block_pattern, cfg.mlp_pattern))
    kinds = [("block", k) for k, _ in pairs if k not in blocks]
    kinds += [("mlp", m) for k, m in pairs
              if k in blocks and (k, m) not in PORTED]
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
def _position_spec(cfg: ModelConfig, kind: str, stacked: int):
    if kind == "rwkv":
        return {"norm1": norm_spec(cfg, stacked),
                "block": rwkv_spec(cfg, stacked),
                "norm2": norm_spec(cfg, stacked)}   # channel-mix pre-norm
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
        "blocks": {f"pos{i}": _position_spec(cfg, kind, cfg.n_groups)
                   for i, kind in enumerate(cfg.block_pattern)},
    }


def _keeps_f32(path: str) -> bool:
    """True for a leaf kept in float32: a norm's (its parent key names one)
    or one the rwkv block widens to f32 (``rwkv.F32_LEAVES``)."""
    keys = re.findall(r"\['([^']*)'\]", path)
    return "norm" in keys[-2] or keys[-1] in F32_LEAVES


class Transformer(nn.Module):
    """A dense decoder stack built from a parameter tree in the JAX layout
    (:func:`model_spec`; :func:`~repro_torch.models.params.init_params`
    makes one, :func:`~repro_torch.models.convert.params_from_jax` carries
    the JAX package's across).

    The tree's ``(n_groups, ...)`` block leaves are unstacked into
    ``layers[l]`` (group ``l // period``, position ``l % period``).
    Matmul weights, biases, the embedding and the rwkv mixing coefficients
    are cast once to the compute dtype ``cfg.dtype``; norm parameters and
    the rwkv leaves the JAX block widens (``w0``, ``u_bonus``, ``ln_x``)
    are kept in float32.  Raises
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
            return nn.Parameter(t.to(torch.float32 if _keeps_f32(path) else dt),
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
def _apply_position(p, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                    mode: str = "prefill", cache=None, pos=None):
    """One layer of block ``kind``.  Returns (x, new_cache): for ``attn``
    the prefill's (k, v) or the decode step's cache (written in place); for
    ``rwkv`` the state (tlast, wkv, clast) after the prefill, or the decode
    step's cache (written in place)."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    rs = residual_scale(cfg)
    h = apply_norm(p["norm1"], x, cfg)
    if kind == "rwkv":
        # the JAX prefill seeds every layer with init_rwkv_state's zeros;
        # None is the same state (the kernel starts from zeros)
        tlast, wkv, clast = cache if mode == "decode" else (None, None, None)
        out, (tlast2, wkv2) = rwkv_time_mix(
            p["block"], h, cfg, state=(tlast, wkv), return_state=True)
        x = x + mul_scalar(out, rs)
        h2 = apply_norm(p["norm2"], x, cfg)
        out2, clast2 = rwkv_channel_mix(p["block"], h2, cfg, last_x=clast,
                                        return_state=True)
        x = x + mul_scalar(out2, rs)
        if mode == "prefill":
            return x, (tlast2, wkv2, clast2)
        # written in place where the leaf holds the step's dtype; a leaf of
        # another dtype (a token shift seeded at the cache dtype under
        # another compute dtype) comes back as the step computed it
        out = []
        for leaf, new in zip(cache, (tlast2, wkv2, clast2)):
            if leaf.dtype == new.dtype:
                leaf.copy_(new)
                new = leaf
            out.append(new)
        return x, tuple(out)
    if mode == "decode":
        out, new_cache = attend_decode(p["block"], h, cache, pos, cfg)
    else:
        out, new_cache = attend_full(p["block"], h, cfg, return_kv=True)
    x = x + mul_scalar(out, rs)
    h2 = apply_norm(p["norm2"], x, cfg)
    x = x + mul_scalar(apply_mlp(p["mlp"], h2, cfg), rs)
    return x, new_cache


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Cache tree in the JAX layout, on ``device`` (default: the card):
    ``{"pos{i}": ...}`` stacked over ``n_groups``, ``{"k", "v"}`` each
    (G, B, KVH, max_len, hd) for an ``attn`` position, ``(tlast (G, B, D)
    dtype, wkv (G, B, H, hd, hd) f32, clast (G, B, D) dtype)`` for an
    ``rwkv`` one (whose state ``max_len`` does not size)."""
    check_supported(cfg)
    dev = state_device(device)
    g = cfg.n_groups
    cache: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "rwkv":
            cache[f"pos{i}"] = tuple(
                t.expand((g,) + t.shape).contiguous()
                for t in init_rwkv_state(cfg, batch, dtype, dev))
        else:
            shape = (g, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
            cache[f"pos{i}"] = {
                name: torch.zeros(shape, dtype=dtype, device=dev)
                for name in ("k", "v")}
    return cache


def cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16) -> Dict[str, Any]:
    """The cache's shapes and dtypes as storage-less ``meta`` tensors."""
    return init_cache(cfg, batch, max_len, dtype, device="meta")


#: logical axes of each cache leaf kind (mirrors init_cache, before the
#: leading "layers" axis)
_CACHE_AXES = {
    "attn": {"k": ("batch", "kv_heads", "kv_seq", None),
             "v": ("batch", "kv_heads", "kv_seq", None)},
    "rwkv": (("batch", None), ("batch", "heads", None, None),
             ("batch", None)),
}


def cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes of every cache leaf, matching :func:`cache_struct`."""
    check_supported(cfg)
    out: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.block_pattern):
        axes = _CACHE_AXES[kind]
        out[f"pos{i}"] = ({k: ("layers",) + a for k, a in axes.items()}
                          if isinstance(axes, dict)
                          else tuple(("layers",) + a for a in axes))
    return out


def _layer_cache(cache: Dict[str, Any], cfg: ModelConfig, layer: int):
    """Layer ``layer``'s slice of every leaf of its position's cache (views,
    so writes reach the cache)."""
    g, i = divmod(layer, cfg.period)
    leaves = cache[f"pos{i}"]
    if isinstance(leaves, dict):
        return {name: t[g] for name, t in leaves.items()}
    return tuple(t[g] for t in leaves)


def _stack(caches: List[Any]) -> Any:
    """Per-layer caches of one position stacked over the groups."""
    if isinstance(caches[0], dict):
        return {name: torch.stack([c[name] for c in caches])
                for name in caches[0]}
    return tuple(torch.stack(leaves) for leaves in zip(*caches))


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(model: Transformer, inputs: Dict[str, torch.Tensor], max_len: int,
            cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process the prompt; -> (last-token logits (B, Vp) f32, cache at S).
    An ``attn`` position's cache is (k, v) padded to ``max_len`` in
    ``cache_dtype``; an ``rwkv`` position's is its state as the block
    leaves it (the shifts in the compute dtype, wkv in f32), as in the
    JAX package."""
    cfg = model.cfg
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name} is encoder-only: no prefill/decode")
    x = embed_inputs(model, inputs)
    per_pos: List[List[Any]] = [[] for _ in range(cfg.period)]
    for layer, p in enumerate(model.layers):
        kind = cfg.block_pattern[layer % cfg.period]
        x, c = _apply_position(p, x, cfg, kind, mode="prefill")
        if kind == "attn":
            c = cache_from_prefill(cfg, c[0], c[1], max_len, cache_dtype)
        per_pos[layer % cfg.period].append(c)
    cache = {f"pos{i}": _stack(caches) for i, caches in enumerate(per_pos)}
    x = apply_norm(model.final_norm, x, cfg)
    logits = logits_from_hidden(model.embed, x[:, -1:], cfg)[:, 0]
    return logits, cache


@torch.no_grad()
def decode_step(model: Transformer, cache: Dict[str, Any],
                tokens: torch.Tensor, pos
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token for every sequence.  tokens (B,) ids; ``pos`` an ``int``
    for the whole batch or a (B,) int tensor, one position per row (rwkv
    reads none).  No position is read on the host, so the step runs on
    ``meta`` tensors.

    Returns (logits (B, Vp) f32, cache).  The cache is updated **in place**
    and returned (the JAX package returns a new one), except an rwkv
    token-shift leaf whose dtype is not the compute dtype: the step returns
    a new leaf at the compute dtype there, as the JAX step does.
    """
    cfg = model.cfg
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    x = embed_tokens(model.embed, tokens[:, None], cfg)
    per_pos: List[List[Any]] = [[] for _ in range(cfg.period)]
    for layer, p in enumerate(model.layers):
        x, c = _apply_position(p, x, cfg, cfg.block_pattern[layer % cfg.period],
                               mode="decode",
                               cache=_layer_cache(cache, cfg, layer), pos=pos)
        per_pos[layer % cfg.period].append(c)
    x = apply_norm(model.final_norm, x, cfg)
    logits = logits_from_hidden(model.embed, x, cfg)[:, 0]
    return logits, {f"pos{i}": _restacked(cache[f"pos{i}"], caches)
                    for i, caches in enumerate(per_pos)}


def _restacked(leaves: Any, per_layer: List[Any]) -> Any:
    """A position's cache after a decode step: a stacked leaf of the
    dtype its layers returned was written in place and is kept; another is
    stacked anew from the layers' new tensors."""
    if isinstance(leaves, dict):
        return leaves
    return tuple(leaf if per_layer[0][j].dtype == leaf.dtype
                 else torch.stack([c[j] for c in per_layer])
                 for j, leaf in enumerate(leaves))
