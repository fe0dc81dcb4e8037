"""The train step: remat + microbatch gradient accumulation + AdamW.

The JAX package's ``train/step.py`` for one device:

* **remat** — the per-layer activation checkpointing policy ("none" |
  "dots" | "full"), set on the model config by :meth:`TrainConfig.apply_to`
  (see :func:`~repro_torch.models.transformer.forward`);
* **microbatching** — the global batch is split into ``microbatches`` equal
  slices run one after another; their gradients add up in a buffer of the
  parameter dtype (f32 normally; bf16 for the 398B cell, where an f32
  buffer alone would not fit), divided by k at the end, and the metrics are
  the mean over the slices;
* **AdamW** with bf16 moments (:mod:`repro_torch.optim`).

The train state keeps the JAX package's layout, ``{"params": tree, "opt":
{"m", "v", "step"}}`` with the block leaves stacked over ``n_groups``, so a
checkpoint of either package restores into the other.  The returned step
``step(state, batch) -> (state, metrics)`` updates the state **in place**
and returns it (the JAX step is pure and returns a new one): it keeps a
training model whose parameters are views of the state's leaves and a
gradient tree of the same layout that autograd writes into, so a step
allocates neither parameters nor gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..models.config import ModelConfig
from ..models.params import init_params, leaves_with_path, map_tree
from ..models.transformer import (Transformer, bind_grads, check_trainable,
                                  model_spec, train_loss)
from ..optim import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    total_steps: int = 1000
    remat: str = "dots"              # "none" | "dots" | "full", per layer
    microbatches: int = 1
    param_dtype: str = "float32"     # "bfloat16" for the 398B cell
    adamw: AdamWConfig = AdamWConfig()

    def apply_to(self, cfg: ModelConfig) -> ModelConfig:
        """Model-level execution knobs (remat) live on the ModelConfig."""
        return dataclasses.replace(cfg, remat=self.remat)


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, seed: int, *,
                     device: Any = None) -> Dict[str, Any]:
    """Parameters from ``init_params(model_spec(cfg), seed)`` in
    ``tcfg.param_dtype`` on ``device`` (default: the card), and AdamW's
    state."""
    check_trainable(cfg)
    params = init_params(model_spec(cfg), seed,
                         dtype=getattr(torch, tcfg.param_dtype), device=device)
    return {"params": params, "opt": adamw_init(params)}


def value_and_grad(model: Transformer, grads: Dict[str, Any],
                   batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   microbatches: int = 1) -> Dict[str, torch.Tensor]:
    """The loss's gradient into ``grads`` (a tree bound to the trainable
    ``model`` by :func:`bind_grads`, zeroed here first), averaged over
    ``microbatches`` equal slices of the batch; -> the metrics of
    :func:`train_loss`, averaged likewise."""
    k = microbatches
    for name, x in batch.items():
        if x.shape[0] % k:
            raise ValueError(f"batch {name!r} of {x.shape[0]} rows does not "
                             f"split into {k} equal microbatches")
    leaves = [t for _, t in leaves_with_path(grads)]
    torch._foreach_zero_(leaves)
    per = []
    for i in range(k):
        mb = {name: x[i * (x.shape[0] // k):(i + 1) * (x.shape[0] // k)]
              for name, x in batch.items()}
        loss, metrics = train_loss(model, mb, cfg)
        loss.backward()
        per.append({name: v.detach() for name, v in metrics.items()})
    if k <= 1:
        return per[0]
    torch._foreach_div_(leaves, k)
    return {name: torch.stack([m[name] for m in per]).mean() for name in per[0]}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    lr_schedule: Callable) -> Callable:
    """``step(state, batch) -> (state, metrics)``: metrics ``ce``,
    ``load_balance``, ``router_z``, ``loss``, ``grad_norm``, ``clip_scale``
    (0-d tensors on the state's device) and ``lr`` (0-d f32 on the host).
    ``batch`` holds tensors on the state's device."""
    cfg = tcfg.apply_to(cfg)
    check_trainable(cfg)
    bound: Dict[str, Any] = {}

    def bind(params) -> Tuple[Transformer, Dict[str, Any]]:
        """The training model and gradient tree of these exact leaves
        (built again when the state's tensors change, as after a restore).
        The binding is read and replaced as one tuple, so two threads
        stepping two states (a raced backup on a snapshot) each get their
        own state's model."""
        key = tuple((id(t), t.data_ptr()) for _, t in leaves_with_path(params))
        entry = bound.get("entry")
        if entry is None or entry[0] != key:
            model = Transformer(cfg, params, trainable=True)
            grads = map_tree(torch.zeros_like, params)
            bind_grads(model, grads)
            entry = (key, model, grads)
            bound["entry"] = entry
        return entry[1], entry[2]

    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
             ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        params, opt = state["params"], state["opt"]
        model, grads = bind(params)
        metrics = value_and_grad(model, grads, batch, cfg, tcfg.microbatches)
        lr = lr_schedule(opt["step"])
        with torch.no_grad():
            _, opt, opt_metrics = adamw_update(params, grads, opt, lr,
                                               tcfg.adamw)
        metrics = dict(metrics, **opt_metrics, lr=lr)
        state["opt"] = opt
        return state, metrics

    return step


def clone_train_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of a train state (``{"params", "opt"}``, or any tree of
    nested dicts) that shares no tensor with it, other leaves kept as they
    are: what the step, which updates its state in place, may run on beside
    the original (:class:`~repro_torch.launch.straggler.BackupStepRunner`'s
    backup)."""
    return map_tree(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                    state)
