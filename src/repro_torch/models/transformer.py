"""The model stack: embed → one module per layer → norm → logits.

The JAX package's ``models/transformer.py`` in PyTorch, for the serving
path of decoder stacks whose blocks are ``attn`` with a ``dense`` MLP
(qwen2.5-3b, stablelm-1.6b, minicpm-2b, mistral-large-123b; paligemma-3b
behind its vision frontend), ``attn`` with an MoE MLP
(moonshot-v1-16b-a3b), ``mla`` with an MoE MLP behind a dense first layer
(deepseek-v2-236b), ``rwkv`` carrying its own channel-mix (rwkv6-3b), or
``mamba`` and ``attn`` with dense and MoE MLPs interleaved
(jamba-1.5-large-398b); hubert-xlarge's encoder behind its audio
frontend.

The JAX package stacks each block position's weights over ``n_groups`` and
scans them; here :class:`Transformer` unstacks them into one
``nn.ModuleDict`` per layer and runs a Python loop (deepseek's dense first
layer, ``layer0``, runs before it).  Its parameter names
follow the JAX tree (``embed.embedding``, ``layers[i].block.wq``, ...), so
the functions of ``layers`` and ``attention`` read a layer exactly as they
read a dict of the JAX package's tensors.

Entry points: :func:`prefill` and :func:`decode_step` (``torch.no_grad``),
:func:`forward` (hidden states of a whole sequence: hubert's encode, and the
training loss) and :func:`train_loss`.  Training takes a model built with
``trainable=True``: its parameters are the tree's own tensors (f32 masters,
the block leaves viewed per layer, so an in-place optimizer step writes the
tree), cast to the compute dtype inside the graph at every use, as the JAX
layers cast them; :func:`bind_grads` points their gradients at a tree of
the same layout.  The port trains every stack it builds (:data:`PORTED`):
``attn`` blocks with a dense or MoE MLP, ``mla`` blocks with an MoE MLP,
``rwkv`` blocks (the WKV scan's gradient a kernel of its own on the card)
and ``mamba`` blocks with a dense or MoE MLP (likewise the selective
scan's), behind deepseek's dense first layer, paligemma's vision frontend
(its image prefix takes no loss) and hubert's audio frontend too; an MoE
layer's load-balance and router-z losses enter the loss as in the JAX
package.
"""

from __future__ import annotations

import functools
import re
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .attention import (attend_decode, attend_full, attn_spec,
                        cache_from_prefill, init_kv_cache)
from .config import ModelConfig
from .frontends import F32_LEAVES as FRONTEND_F32_LEAVES
from .frontends import embed_audio, embed_vision, frontend_spec
from .layers import (apply_mlp, apply_norm, cdtype, cross_entropy, embed_spec,
                     embed_tokens, logits_from_hidden, mlp_spec, mul_scalar,
                     norm_spec, residual_scale)
from .mamba import F32_LEAVES as MAMBA_F32_LEAVES
from .mamba import init_mamba_state, mamba_decode, mamba_full, mamba_spec
from .mla import F32_LEAVES as MLA_F32_LEAVES
from .mla import (init_mla_cache, mla_cache_from_prefill, mla_decode,
                  mla_full, mla_spec)
from .moe import apply_moe, moe_spec
from .params import leaves_with_path, state_device
from .rwkv import F32_LEAVES as RWKV_F32_LEAVES
from .rwkv import (init_rwkv_state, rwkv_channel_mix, rwkv_spec,
                   rwkv_time_mix)

#: (block kind, mlp kind) pairs the port builds
PORTED = {("attn", "dense"), ("attn", "moe"), ("mla", "moe"),
          ("rwkv", "none"), ("mamba", "dense"), ("mamba", "moe")}
#: block kinds of a dense first layer (``first_layer_dense``) it builds
FIRST_LAYER_KINDS = {"attn", "mla"}
#: modality frontends it builds
FRONTENDS = {"none", "vision", "audio"}
_BLOCK_SPECS = {"attn": attn_spec, "mla": mla_spec, "mamba": mamba_spec,
                "rwkv": rwkv_spec}
#: leaves the model keeps in float32 besides the norms (the JAX blocks read
#: them with ``.astype(float32)``)
F32_LEAVES = (RWKV_F32_LEAVES | MLA_F32_LEAVES | MAMBA_F32_LEAVES
              | FRONTEND_F32_LEAVES)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for an arch this slice does not build."""
    blocks = {kind for kind, _ in PORTED}
    pairs = list(zip(cfg.block_pattern, cfg.mlp_pattern))
    kinds = [("block", k) for k, _ in pairs if k not in blocks]
    kinds += [("mlp", m) for k, m in pairs
              if k in blocks and (k, m) not in PORTED]
    if cfg.frontend not in FRONTENDS:
        kinds.append(("frontend", cfg.frontend))
    if (cfg.first_layer_dense
            and cfg.block_pattern[0] not in FIRST_LAYER_KINDS):
        kinds.append(("first layer", cfg.block_pattern[0]))
    if kinds:
        what, kind = kinds[0]
        raise NotImplementedError(
            f"{cfg.name}: {what} {kind!r} is not ported to PyTorch yet; "
            "ROADMAP.md queue 1 ports it")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for an arch :func:`train_loss` does not
    train: one the port does not build (:func:`check_supported`).  Every
    (block, mlp) pair of :data:`PORTED` trains, and so do a dense first
    layer and both frontends (paligemma's image prefix, hubert's frames)
    with the stack behind them."""
    check_supported(cfg)


# ---------------------------------------------------------------------------
# Parameter tree
# ---------------------------------------------------------------------------
def n_scanned(cfg: ModelConfig) -> int:
    """Layers of the stacked ``blocks`` (all but a dense first layer)."""
    return cfg.n_groups * cfg.period


def _position_spec(cfg: ModelConfig, kind: str, mlp_kind: str,
                   stacked: int):
    out = {"norm1": norm_spec(cfg, stacked),
           "block": _BLOCK_SPECS[kind](cfg, stacked)}
    if mlp_kind == "dense":
        out["norm2"] = norm_spec(cfg, stacked)
        out["mlp"] = mlp_spec(cfg, cfg.d_ff, stacked)
    elif mlp_kind == "moe":
        out["norm2"] = norm_spec(cfg, stacked)
        out["mlp"] = moe_spec(cfg, stacked)
    elif kind == "rwkv":
        out["norm2"] = norm_spec(cfg, stacked)   # channel-mix pre-norm
    return out


def model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX package's parameter tree (``blocks.pos{i}`` stacked over
    ``n_groups``, plus deepseek's unstacked ``layer0`` and paligemma's
    ``frontend``) for an arch this slice builds.  A config with no stacked
    group (deepseek cut to its dense first layer, ``n_layers`` 1) has empty
    ``blocks``."""
    check_supported(cfg)
    spec: Dict[str, Any] = {
        "embed": embed_spec(cfg),
        "final_norm": norm_spec(cfg),
        "blocks": {f"pos{i}": _position_spec(cfg, kind, mlp_kind,
                                              cfg.n_groups)
                   for i, (kind, mlp_kind) in enumerate(
                       zip(cfg.block_pattern, cfg.mlp_pattern))
                   if cfg.n_groups},
    }
    if cfg.first_layer_dense:
        spec["layer0"] = {
            "norm1": norm_spec(cfg),
            "block": _BLOCK_SPECS[cfg.block_pattern[0]](cfg, 0),
            "norm2": norm_spec(cfg),
            "mlp": mlp_spec(cfg, cfg.d_ff_dense or cfg.d_ff, 0),
        }
    fe = frontend_spec(cfg)
    if fe:
        spec["frontend"] = fe
    return spec


def _keeps_f32(path: str) -> bool:
    """True for a leaf kept in float32: a norm's (its parent key names one)
    or one a block reads in f32 (:data:`F32_LEAVES`: rwkv's ``w0``,
    ``u_bonus``, ``ln_x``; MLA's ``q_norm``, ``kv_norm``, ``wk_b``,
    ``wv_b``; mamba's ``dt_bias``, ``a_log``, ``d_skip``; the audio
    frontend's ``ln_scale``, ``ln_bias``)."""
    keys = re.findall(r"\['([^']*)'\]", path)
    return "norm" in keys[-2] or keys[-1] in F32_LEAVES


class Transformer(nn.Module):
    """A dense decoder stack built from a parameter tree in the JAX layout
    (:func:`model_spec`; :func:`~repro_torch.models.params.init_params`
    makes one, :func:`~repro_torch.models.convert.params_from_jax` carries
    the JAX package's across).

    The tree's ``(n_groups, ...)`` block leaves are unstacked into
    ``layers[l]`` (group ``l // period``, position ``l % period``); a
    dense first layer's leaves go to ``layer0`` (None without one).
    Matmul weights, biases, the embedding, the frontend's adapter, the MoE
    experts, the rwkv mixing coefficients and mamba's conv are cast once to
    the compute dtype ``cfg.dtype`` (a tree already in that dtype is viewed,
    not copied); norm parameters
    and the leaves a block reads in f32 (:data:`F32_LEAVES`) are kept in
    float32.  Raises
    ``ValueError`` on a missing leaf, a leaf it did not consume, or a
    shape that differs from the spec.  The module lives on the tree's
    device and holds no gradients.

    ``trainable=True`` builds the training model instead: every parameter
    is the tree's own tensor (a block leaf's group ``g`` viewed as
    ``leaf[g]``), not cast, requiring grad, so the layers cast it to the
    compute dtype inside the graph and an in-place update of the tree is
    the model's update (:func:`bind_grads` gives it gradient buffers).
    """

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any], *,
                 trainable: bool = False):
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
        tree_params: List[Tuple[nn.Parameter, str, Optional[int]]] = []

        def param(path: str, t: torch.Tensor, g: Optional[int]) -> nn.Parameter:
            if not trainable:
                return nn.Parameter(
                    t.to(torch.float32 if _keeps_f32(path) else dt),
                    requires_grad=False)
            out = nn.Parameter(t, requires_grad=True)      # aliases the tree
            tree_params.append((out, path, g))
            return out

        def pdict(prefix: str, tree: Dict[str, Any], g: Optional[int] = None):
            # a nested dict (the MoE's shared experts) nests a ParameterDict
            return nn.ParameterDict({
                name: (pdict(f"{prefix}['{name}']", t, g)
                       if isinstance(t, dict)
                       else param(f"{prefix}['{name}']",
                                  t if g is None else t[g], g))
                for name, t in tree.items()})

        def layer_dict(prefix: str, tree: Dict[str, Any],
                       g: Optional[int] = None):
            return nn.ModuleDict({
                name: pdict(f"{prefix}['{name}']", sub, g)
                for name, sub in tree.items()})

        self.embed = pdict("['embed']", params["embed"])
        self.final_norm = pdict("['final_norm']", params["final_norm"])
        self.layer0 = (layer_dict("['layer0']", params["layer0"])
                       if cfg.first_layer_dense else None)
        self.frontend = (pdict("['frontend']", params["frontend"])
                         if "frontend" in spec else None)
        self.layers = nn.ModuleList()
        for layer in range(n_scanned(cfg)):
            g, i = divmod(layer, cfg.period)
            self.layers.append(layer_dict(
                f"['blocks']['pos{i}']", params["blocks"][f"pos{i}"], g))
        #: (parameter, its leaf's path, its group or None), for bind_grads
        self.tree_params = tree_params
        # pdict's recursion makes its closure a reference cycle: drop it, so
        # these closures are freed with this frame and keep no parameter
        # (or, through them, the model) alive until the cycle collector
        # runs
        del pdict

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device


# ---------------------------------------------------------------------------
# Embedding of model inputs
# ---------------------------------------------------------------------------
def embed_inputs(model: Transformer, inputs: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """inputs: {"tokens": (B, S)} [+ "patches" (B, P, F) for a vision
    frontend, whose embeddings are prepended: (B, P + S, D)], or an audio
    model's {"frames": (B, S, F)} (other keys, such as a batch's labels,
    are not read)."""
    cfg = model.cfg
    if cfg.frontend == "audio":
        return embed_audio(model.frontend, inputs["frames"], cfg)
    if "frames" in inputs:
        raise ValueError(f"{cfg.name} has no audio frontend; got frames")
    x = embed_tokens(model.embed, inputs["tokens"], cfg)
    if "patches" in inputs:
        if cfg.frontend != "vision":
            raise ValueError(f"{cfg.name} has no vision frontend; got "
                             "patches")
        prefix = embed_vision(model.frontend, inputs["patches"], cfg)
        x = torch.cat([prefix, x], dim=1)
    return x


# ---------------------------------------------------------------------------
# One layer (shared by the prefill and decode bodies)
# ---------------------------------------------------------------------------
def moe_group(mode: str, b: int, s: int) -> int:
    """The JAX stack's MoE routing group: a whole sequence in a prefill,
    ``max(1, B·S // 16)`` tokens in a decode step."""
    return s if mode != "decode" else max(1, (b * s) // 16)


def _apply_position(p, x: torch.Tensor, cfg: ModelConfig, kind: str,
                    mlp_kind: str, *, mode: str = "prefill", cache=None,
                    pos=None, moe_group_size: Optional[int] = None):
    """One layer of block ``kind`` with feed-forward ``mlp_kind``.  Returns
    (x, new_cache): for ``attn`` the prefill's (k, v) or the decode step's
    cache (written in place); for ``mla`` the prefill's latents (c_kv,
    k_rope) or the decode step's cache (written in place); for ``rwkv`` the
    state (tlast, wkv, clast) and for ``mamba`` the state (conv window, ssm)
    after the prefill, or the decode step's cache (written in place).  In
    ``mode="train"`` (any block over the whole sequence from a zero state,
    keeping no cache or state) it returns (x, aux) instead: the layer's (2,)
    f32 [load_balance, router_z], an MoE layer's mean over its routing
    groups (one a sequence, the JAX stack's rule) and zeros for a dense MLP
    or an rwkv block.  An MoE layer routes groups of ``moe_group_size``
    tokens (None: :func:`moe_group`); only the train mode computes its aux
    losses."""
    if mode not in ("prefill", "decode", "train"):
        raise ValueError(f"unknown mode {mode!r}")
    rs = residual_scale(cfg)
    h = apply_norm(p["norm1"], x, cfg)
    if kind == "rwkv" and mode == "train":
        # the JAX train branch: the time mix from a zero state and the
        # channel mix with no last token, keeping neither
        x = x + mul_scalar(rwkv_time_mix(p["block"], h, cfg), rs)
        h2 = apply_norm(p["norm2"], x, cfg)
        x = x + mul_scalar(rwkv_channel_mix(p["block"], h2, cfg), rs)
        return x, torch.zeros(2, dtype=torch.float32, device=x.device)
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
        return x, _write_state(cache, (tlast2, wkv2, clast2))
    if kind == "mamba":
        if mode == "decode":
            out, new_cache = mamba_decode(p["block"], h, cache, cfg)
            new_cache = _write_state(cache, new_cache)
        elif mode == "train":
            out, new_cache = mamba_full(p["block"], h, cfg), None
        else:
            out, new_cache = mamba_full(p["block"], h, cfg, return_state=True)
    elif kind == "mla":
        if mode == "decode":
            out, new_cache = mla_decode(p["block"], h, cache, pos, cfg)
        elif mode == "train":
            out, new_cache = mla_full(p["block"], h, cfg), None
        else:
            out, new_cache = mla_full(p["block"], h, cfg, return_cache=True)
    elif mode == "decode":
        out, new_cache = attend_decode(p["block"], h, cache, pos, cfg)
    elif mode == "train":
        out, new_cache = attend_full(p["block"], h, cfg), None
    else:
        out, new_cache = attend_full(p["block"], h, cfg, return_kv=True)
    x = x + mul_scalar(out, rs)
    h2 = apply_norm(p["norm2"], x, cfg)
    train = mode == "train"
    if mlp_kind == "moe":
        b, s, _ = h2.shape
        gs = moe_group_size or moe_group(mode, b, s)
        m_out, aux = apply_moe(p["mlp"], h2, cfg, group_size=gs,
                               with_aux=train)
    else:
        m_out = apply_mlp(p["mlp"], h2, cfg)
        aux = (torch.zeros(2, dtype=torch.float32, device=x.device)
               if train else None)
    x = x + mul_scalar(m_out, rs)
    return x, (aux if train else new_cache)


def _write_state(cache: Tuple[torch.Tensor, ...],
                 new: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """A recurrent state after a decode step: written in place where the
    leaf holds the step's dtype; a leaf of another dtype (an rwkv token
    shift or a mamba conv window seeded at the cache dtype under another
    compute dtype) comes back as the step computed it."""
    out = []
    for leaf, t in zip(cache, new):
        if leaf.dtype == t.dtype:
            leaf.copy_(t)
            t = leaf
        out.append(t)
    return tuple(out)


def _layer_kinds(cfg: ModelConfig, layer: int) -> Tuple[str, str]:
    """(block kind, mlp kind) of scanned layer ``layer``."""
    i = layer % cfg.period
    return cfg.block_pattern[i], cfg.mlp_pattern[i]


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 dtype, dev) -> Any:
    """One layer's cache for block ``kind`` (unstacked)."""
    if kind == "rwkv":
        return init_rwkv_state(cfg, batch, dtype, dev)
    if kind == "mamba":
        return init_mamba_state(cfg, batch, dtype, dev)
    if kind == "mla":
        return init_mla_cache(cfg, batch, max_len, dtype, dev)
    return init_kv_cache(cfg, batch, max_len, dtype, dev)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Cache tree in the JAX layout, on ``device`` (default: the card):
    ``{"pos{i}": ...}`` stacked over ``n_groups``, ``{"k", "v"}`` each
    (G, B, KVH, max_len, hd) for an ``attn`` position, ``{"c_kv" (G, B,
    max_len, kvl), "k_rope" (G, B, max_len, rope)}`` for an ``mla`` one,
    ``(tlast (G, B, D) dtype, wkv (G, B, H, hd, hd) f32, clast (G, B, D)
    dtype)`` for an ``rwkv`` one and ``(conv (G, B, d_conv - 1, Di) dtype,
    ssm (G, B, Di, N) f32)`` for a ``mamba`` one (states that ``max_len``
    does not size);
    plus deepseek's ``"layer0"``, the same leaves unstacked (batch at axis
    0)."""
    check_supported(cfg)
    dev = state_device(device)
    g = cfg.n_groups
    cache: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.block_pattern):
        per = _block_cache(cfg, kind, batch, max_len, dtype, dev)
        stacked = [t.expand((g,) + t.shape).contiguous()
                   for t in (per.values() if isinstance(per, dict) else per)]
        cache[f"pos{i}"] = (dict(zip(per, stacked)) if isinstance(per, dict)
                            else tuple(stacked))
    if cfg.first_layer_dense:
        cache["layer0"] = _block_cache(cfg, cfg.block_pattern[0], batch,
                                       max_len, dtype, dev)
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
    "mla": {"c_kv": ("batch", "kv_seq", None),
            "k_rope": ("batch", "kv_seq", None)},
    "mamba": (("batch", None, "mlp"), ("batch", "mlp", None)),
    "rwkv": (("batch", None), ("batch", "heads", None, None),
             ("batch", None)),
}


def cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes of every cache leaf, matching :func:`cache_struct`
    (stacked positions gain a leading "layers" axis; ``layer0`` does
    not)."""
    check_supported(cfg)
    out: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.block_pattern):
        axes = _CACHE_AXES[kind]
        out[f"pos{i}"] = ({k: ("layers",) + a for k, a in axes.items()}
                          if isinstance(axes, dict)
                          else tuple(("layers",) + a for a in axes))
    if cfg.first_layer_dense:
        out["layer0"] = _CACHE_AXES[cfg.block_pattern[0]]
    return out


def _layer_cache(cache: Dict[str, Any], cfg: ModelConfig, layer: int):
    """Scanned layer ``layer``'s slice of every leaf of its position's cache
    (views, so writes reach the cache)."""
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


def _pad_prefill(cfg: ModelConfig, kind: str, c, max_len: int, dtype):
    """A prefill's per-layer cache padded out to ``max_len`` rows in
    ``dtype`` (an rwkv or mamba state is O(1): kept as the block leaves
    it)."""
    if kind == "attn":
        return cache_from_prefill(cfg, c[0], c[1], max_len, dtype)
    if kind == "mla":
        return mla_cache_from_prefill(cfg, c[0], c[1], max_len, dtype)
    return c


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(model: Transformer, inputs: Dict[str, torch.Tensor], max_len: int,
            cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process the prompt; -> (last-token logits (B, Vp) f32, cache at S).
    ``inputs`` are {"tokens" (B, S)} [+ "patches" (B, P, F) for a vision
    frontend: the cache then holds P + S positions, and the first decode
    position is P + S].  An ``attn`` position's cache is (k, v) and an
    ``mla`` one's (c_kv, k_rope), padded to ``max_len`` in ``cache_dtype``;
    an ``rwkv`` or ``mamba`` position's is its state as the block leaves it
    (rwkv's shifts and mamba's conv window in the compute dtype, the wkv and
    ssm states in f32), as in the JAX package.  A dense first layer runs
    first and keeps its cache under ``"layer0"``."""
    cfg = model.cfg
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name} is encoder-only: no prefill/decode")
    x = embed_inputs(model, inputs)
    cache: Dict[str, Any] = {}
    if cfg.first_layer_dense:
        kind0 = cfg.block_pattern[0]
        x, c0 = _apply_position(model.layer0, x, cfg, kind0, "dense",
                                mode="prefill")
        cache["layer0"] = _pad_prefill(cfg, kind0, c0, max_len, cache_dtype)
    per_pos: List[List[Any]] = [[] for _ in range(cfg.period)]
    for layer, p in enumerate(model.layers):
        kind, mlp_kind = _layer_kinds(cfg, layer)
        x, c = _apply_position(p, x, cfg, kind, mlp_kind, mode="prefill")
        per_pos[layer % cfg.period].append(
            _pad_prefill(cfg, kind, c, max_len, cache_dtype))
    for i, caches in enumerate(per_pos):
        cache[f"pos{i}"] = _stack(caches)
    x = apply_norm(model.final_norm, x, cfg)
    logits = logits_from_hidden(model.embed, x[:, -1:], cfg)[:, 0]
    return logits, cache


@torch.no_grad()
def decode_step(model: Transformer, cache: Dict[str, Any],
                tokens: torch.Tensor, pos, *,
                moe_group_size: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token for every sequence.  tokens (B,) ids; ``pos`` an ``int``
    for the whole batch or a (B,) int tensor, one position per row (rwkv
    reads none).  No position is read on the host, so the step runs on
    ``meta`` tensors.  ``moe_group_size`` is the MoE layers' routing group
    (None: the JAX stack's rule, :func:`moe_group`; the decode engine
    passes 1, one group per slot, as the JAX engine's per-slot vmap
    routes).

    Returns (logits (B, Vp) f32, cache).  The cache is updated **in place**
    and returned (the JAX package returns a new one), except an rwkv
    token-shift or mamba conv-window leaf whose dtype is not the compute
    dtype: the step returns a new leaf at the dtype it computed there, as
    the JAX step does.
    """
    cfg = model.cfg
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    x = embed_tokens(model.embed, tokens[:, None], cfg)
    new_cache: Dict[str, Any] = {}
    if cfg.first_layer_dense:
        x, new_cache["layer0"] = _apply_position(
            model.layer0, x, cfg, cfg.block_pattern[0], "dense",
            mode="decode", cache=cache["layer0"], pos=pos)
    per_pos: List[List[Any]] = [[] for _ in range(cfg.period)]
    for layer, p in enumerate(model.layers):
        kind, mlp_kind = _layer_kinds(cfg, layer)
        x, c = _apply_position(p, x, cfg, kind, mlp_kind, mode="decode",
                               cache=_layer_cache(cache, cfg, layer), pos=pos,
                               moe_group_size=moe_group_size)
        per_pos[layer % cfg.period].append(c)
    for i, caches in enumerate(per_pos):
        new_cache[f"pos{i}"] = _restacked(cache[f"pos{i}"], caches)
    x = apply_norm(model.final_norm, x, cfg)
    logits = logits_from_hidden(model.embed, x, cfg)[:, 0]
    return logits, new_cache


def _restacked(leaves: Any, per_layer: List[Any]) -> Any:
    """A position's cache after a decode step: a stacked leaf of the
    dtype its layers returned was written in place and is kept; another is
    stacked anew from the layers' new tensors."""
    if isinstance(leaves, dict):
        return leaves
    return tuple(leaf if per_layer[0][j].dtype == leaf.dtype
                 else torch.stack([c[j] for c in per_layer])
                 for j, leaf in enumerate(leaves))


# ---------------------------------------------------------------------------
# Full-sequence forward (train / encode)
# ---------------------------------------------------------------------------
#: the products "dots" remat keeps (PyTorch's counterpart of JAX's
#: ``dots_with_no_batch_dims_saveable``: the 2-D matmuls, not the batched
#: ones)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _layer(p, x: torch.Tensor, cfg: ModelConfig, kind: str, mlp_kind: str
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _apply_position(p, x, cfg, kind, mlp_kind, mode="train")


def _remat_layer(p, x: torch.Tensor, cfg: ModelConfig, kind: str,
                 mlp_kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer under ``cfg.remat``, as the JAX scan body's
    ``jax.checkpoint``: ``"none"`` keeps every activation for the backward,
    ``"full"`` keeps only the layer's input and recomputes the rest,
    ``"dots"`` keeps the matmul outputs as well (selective checkpointing).
    -> (x, the layer's aux losses).  The recomputation is the same
    arithmetic (an MoE layer routes its tokens to the same slots again), so
    neither the gradients' bits nor the aux depend on the policy."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return _layer(p, x, cfg, kind, mlp_kind)
    if cfg.remat not in ("dots", "full"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    context = {} if cfg.remat == "full" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)}
    return checkpoint(_layer, p, x, cfg, kind, mlp_kind, use_reentrant=False,
                      **context)


def _as_model(model_or_tree, cfg: ModelConfig) -> Transformer:
    if isinstance(model_or_tree, Transformer):
        if model_or_tree.cfg.name != cfg.name:
            raise ValueError(f"the model is {model_or_tree.cfg.name}, the "
                             f"config {cfg.name}")
        return model_or_tree
    return Transformer(cfg, model_or_tree)


def forward(model_or_tree, inputs: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (hidden (B, S, D) after the final norm, aux losses (2,) f32).

    ``model_or_tree`` is a :class:`Transformer` (``trainable=True`` to
    train it) or a parameter tree in the JAX layout (a serving model is
    built from it).  ``inputs`` as :func:`embed_inputs` takes them.  Runs
    every stack of :data:`PORTED` (behind a vision or audio frontend too):
    a dense first layer (``layer0``, deepseek's) first, as the JAX
    ``_apply_layer0``, outside the remat policy and with no aux; then each
    scanned layer under ``cfg.remat``.  The aux losses are the layers'
    [load_balance, router_z] summed in layer order from zero, as the JAX
    scan carries them: zeros for a stack without an MoE layer.  The JAX
    package's FSDP weight gathers (``cfg.fsdp_gather_weights``) are the
    distribution slice's; on one device there is nothing to gather, and the
    flag is not read."""
    check_trainable(cfg)
    model = _as_model(model_or_tree, cfg)
    x = embed_inputs(model, inputs)
    if cfg.first_layer_dense:
        x, _ = _apply_position(model.layer0, x, cfg, cfg.block_pattern[0],
                               "dense", mode="train")
    aux = torch.zeros(2, dtype=torch.float32, device=x.device)
    for layer, p in enumerate(model.layers):
        x, a = _remat_layer(p, x, cfg, *_layer_kinds(cfg, layer))
        aux = aux + a
    x = apply_norm(model.final_norm, x, cfg)
    return x, aux


#: the JAX package's aux-loss coefficients (``models/transformer.py``)
AUX_LB_COEF = 0.01
AUX_Z_COEF = 0.001


def train_loss(model_or_tree, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: {"tokens" (or an audio model's "frames" (B, S, F)),
    "labels" (B, S), optional "mask" (B, S)} -> (loss, metrics ``ce``,
    ``load_balance``, ``router_z``, ``loss``), each a 0-d f32 tensor: the
    cross-entropy plus 0.01 load balance plus 0.001 router z, as the JAX
    package's (an rwkv or a dense stack adds zeros).  Raises
    ``NotImplementedError`` for an arch the port does not build
    (:func:`check_trainable`)."""
    check_trainable(cfg)
    model = _as_model(model_or_tree, cfg)
    hidden, aux = forward(model, batch, cfg)
    logits = logits_from_hidden(model.embed, hidden, cfg)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:        # vision prefix: no loss
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    ce = cross_entropy(logits, labels, batch.get("mask"))
    loss = ce + AUX_LB_COEF * aux[0] + AUX_Z_COEF * aux[1]
    metrics = {"ce": ce, "load_balance": aux[0], "router_z": aux[1],
               "loss": loss}
    return loss, metrics


def bind_grads(model: Transformer, grads: Dict[str, Any]) -> None:
    """Point every parameter's ``.grad`` of a ``trainable`` model at its
    leaf of ``grads``, a tree in the JAX layout (a block parameter at
    ``leaf[g]``).  Autograd then adds each backward's gradient into the
    tree in place: zero the tree before a step, and microbatches
    accumulate."""
    leaves = dict(leaves_with_path(grads))
    if not model.tree_params:
        raise ValueError("bind_grads takes a model built with trainable=True")
    for prm, path, g in model.tree_params:
        prm.grad = leaves[path] if g is None else leaves[path][g]
