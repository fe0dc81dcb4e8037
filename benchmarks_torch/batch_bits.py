"""Which op of the LM path gives a row of a batch other bits than the row alone.

The decode engine prefills one prompt at a time (batch 1) and steps its
slots together; ``greedy_generate`` prefills and steps a whole batch.  Where
one op gives a row of a batch other bits than the same row run in a smaller
batch, the two can pick different tokens.  This script finds that op for
one model at full width and depth (random weights from seed 0, six prompts
of 256 tokens from numpy seed 2, as ``chip_smoke.py`` phase 8 serves them):

* ``tokens``: the first token where ``greedy_generate`` of each prompt
  alone (batch 1), and of the prompts in a batch of four and one of two,
  differs from the six prompts as one batch (-1: none);
* ``chain``: the prefill of the six prompts and one decode step from its
  cache (positions as a ``(B,)`` tensor, as the engine passes them), layer
  by layer at batch 6 and at batch ``n`` (each row alone, rows 0-3, and
  rows 4-5), each run on its own activations; in the first layer whose
  output differs on the shared rows, the first op (in the order the ops
  ran, every earlier one equal) whose output differs, with its operand
  shapes: the op that parts the two, given the same inputs;
* ``isolated``: every op of every layer and of the final norm and logits
  product, replayed on the shared rows of the batch-6 run's own operands
  against the same op replayed on the whole batch: each op whose rows
  differ is batch-dependent on its own (``replayed`` counts the replays,
  ``differing`` those that differ by op).

Ops are caught at the ATen dispatcher (``TorchDispatchMode``); the two
hand-written kernels on the path (``flash_attention``, ``rwkv6_scan``)
launch outside it and are caught at their wrappers.

Run on the card (prints a summary and, last, the report as one JSON line)::

    PYTHONPATH=src python3 -m benchmarks_torch.batch_bits [--arch rwkv6-3b]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch import configs
from repro_torch.core.runtime import resolve_device
from repro_torch.models import attention as attention_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import apply_norm, embed_tokens, logits_from_hidden
from repro_torch.models.params import init_params
from repro_torch.models.transformer import (Transformer, _apply_position,
                                            _layer_cache, model_spec, prefill)
from repro_torch.train.serve import greedy_generate

BATCH, PROMPT, NEW, MAX_LEN = 6, 256, 16, 512
#: the smaller batches the six rows run in (consecutive rows): each row
#: alone, and 4 + 2
ALONE = tuple((i,) for i in range(BATCH))
FOURS = ((0, 1, 2, 3), (4, 5))


@dataclasses.dataclass
class _Op:
    name: str
    func: Any
    args: Any
    kwargs: Any
    out: Any


def _same_view(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with its strides and offset (a copy of its whole
    storage viewed the same way), so that a replayed op sees the layout the
    run gave it."""
    t = t.detach()
    out = t.new_empty(0)
    out.set_(t.untyped_storage().clone(), t.storage_offset(), t.size(),
             t.stride())
    return out


class _Recorder(TorchDispatchMode):
    """Records every op's operands and outputs (copies, so later in-place
    writes do not reach them; the model's parameters are kept by
    reference)."""

    def __init__(self, keep: set):
        super().__init__()
        self.keep = keep
        self.ops: List[_Op] = []
        self.inside = ""             # "name/" within a caught kernel wrapper

    def _copy(self, tree):
        return tree_map(lambda t: t if not isinstance(t, torch.Tensor)
                        or t.data_ptr() in self.keep else _same_view(t), tree)

    def add(self, name, func, args, kwargs, out):
        self.ops.append(_Op(name, func, self._copy(args), self._copy(kwargs),
                            self._copy(out)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.add(self.inside + str(func), func, args, kwargs, out)
        return out


_ACTIVE: List[_Recorder] = []


def _caught(name: str, fn):
    """``fn`` (a kernel wrapper), recorded as one op while a recorder runs;
    the ATen ops it runs itself are named ``name/op``."""
    def wrapper(*args, **kwargs):
        if not _ACTIVE:
            return fn(*args, **kwargs)
        rec = _ACTIVE[-1]
        rec.inside = name + "/"
        try:
            out = fn(*args, **kwargs)
        finally:
            rec.inside = ""
        rec.add(name, fn, args, kwargs, out)
        return out
    return wrapper


def _rows(big, small, sel: Sequence[int]):
    """The consecutive rows ``sel`` of a batch-6 tensor (a view with its
    strides), shaped as the batch-n one; the tensor itself where both
    shapes agree (a weight); None where the batch axis is not the leading
    one."""
    if not isinstance(big, torch.Tensor) or not isinstance(small, torch.Tensor):
        return None
    if big.shape == small.shape:
        return big
    if (big.dim() == 0 or big.shape[1:] != small.shape[1:]
            or big.shape[0] % BATCH or small.shape[0] % len(sel)
            or big.shape[0] // BATCH != small.shape[0] // len(sel)):
        return None
    r = small.shape[0] // len(sel)
    return big[sel[0] * r:(sel[-1] + 1) * r]


def _floats(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def _comparable(op: _Op) -> bool:
    return bool(_floats(op.out)) and "empty" not in op.name


def _differs(big_out, small_out, sel) -> Optional[float]:
    """Max abs difference of the shared rows where they differ, else None
    (also where the rows cannot be told apart)."""
    worst = None
    for b, s in zip(_floats(big_out), _floats(small_out)):
        rb = _rows(b, s, sel)
        if rb is None or rb.shape != s.shape or torch.equal(rb, s):
            continue
        d = float((rb.double() - s.double()).abs().max())
        worst = d if worst is None else max(worst, d)
    return worst


def _shapes(tree) -> List[List[int]]:
    return [list(t.shape) for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


def _first_op(big: List[_Op], small: List[_Op], sel) -> Dict[str, Any]:
    """The first op, in run order, whose output differs on the shared rows."""
    for j, (ob, os_) in enumerate(zip(big, small)):
        if ob.name != os_.name:
            return {"index": j, "op": f"{ob.name} vs {os_.name}",
                    "note": "the two runs' op sequences part here"}
        if not _comparable(ob):
            continue
        d = _differs(ob.out, os_.out, sel)
        if d is not None:
            return {"index": j, "op": ob.name, "shapes": _shapes(os_.args),
                    "batch_shapes": _shapes(ob.args), "max_abs": d}
    return {"index": None, "op": None}


def _isolated(big: List[_Op], small: List[_Op], sel):
    """Each op replayed on the shared rows of the batch run's operands
    against the same op replayed on the whole batch; -> (those that
    differ, the number replayed)."""
    found, n = [], 0
    for ob, os_ in zip(big, small):
        if (ob.name != os_.name or not _comparable(ob)
                or ob.name.rsplit(".", 1)[0].endswith("_")):   # in place
            continue
        pairs = zip(tree_flatten((ob.args, ob.kwargs))[0],
                    tree_flatten((os_.args, os_.kwargs))[0])
        leaves = []
        for b, s in pairs:
            if isinstance(b, torch.Tensor):
                b = _rows(b, s, sel)
                if b is None:
                    break
                leaves.append(b)
            else:
                leaves.append(s)
        else:
            spec = tree_flatten((os_.args, os_.kwargs))[1]
            args, kwargs = spec.unflatten(leaves)
            with torch.no_grad():
                part = os_.func(*args, **kwargs)
                whole = ob.func(*ob.args, **ob.kwargs)
            n += 1
            d = _differs(whole, part, sel)
            if d is not None:
                found.append({"op": ob.name, "shapes": _shapes(os_.args),
                              "batch_shapes": _shapes(ob.args), "max_abs": d})
    return found, n


def _recorded(keep, fn):
    rec = _Recorder(keep)
    _ACTIVE.append(rec)
    try:
        with rec, torch.no_grad():
            out = fn()
    finally:
        _ACTIVE.pop()
    return out, rec.ops


def _first_diff(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.argmax(a != b)) if (a != b).any() else -1


def _chain(model, keep, sel_sets, big_x, small_x, layer_fn, head_fn, kind):
    """Run the layers and the head at batch 6 and at each batch of
    ``sel_sets`` in lockstep; -> per batch the first layer (or "head")
    whose output differs on the shared rows and its first differing op,
    and every op of every layer and of the head replayed on its own: those
    that differ by layer, and counts."""
    found: Dict[int, Dict[str, Any]] = {}
    isolated: Dict[int, Dict[str, Any]] = {k: {} for k in range(len(sel_sets))}
    counts = {k: {"replayed": 0, "differing": {}} for k in range(len(sel_sets))}
    x6, xs = big_x, dict(small_x)
    for layer in list(range(model.cfg.n_layers)) + ["head"]:
        fn = head_fn if layer == "head" else (lambda x, k, L=layer: layer_fn(x, k, L))
        x6_next, ops6 = _recorded(keep, lambda: fn(x6, None))
        for k, sel in enumerate(sel_sets):
            xk_next, opsk = _recorded(keep, lambda: fn(xs[k], k))
            if k not in found and _differs(x6_next, xk_next, sel) is not None:
                found[k] = {"layer": layer, **_first_op(ops6, opsk, sel)}
            ops, n = _isolated(ops6, opsk, sel)
            counts[k]["replayed"] += n
            for o in ops:
                c = counts[k]["differing"]
                c[o["op"]] = c.get(o["op"], 0) + 1
            if ops:
                isolated[k][str(layer)] = ops
            xs[k] = xk_next
        x6 = x6_next
    out = {}
    for k, sel in enumerate(sel_sets):
        label = f"{kind} B={len(sel)} rows {list(sel)}"
        out[label] = {"first": found.get(k, {"layer": None, "op": None}),
                      "isolated": isolated[k], **counts[k]}
    return out


def run(arch: str = "qwen2.5-3b", device: Any = "cuda", *,
        reduced: bool = False, prompt_len: int = PROMPT, new: int = NEW,
        max_len: int = MAX_LEN) -> Dict[str, Any]:
    """The batch-dependence report of ``arch`` (see the module docstring)."""
    dev = resolve_device(device)
    cfg = configs.get(arch)
    if reduced:
        cfg = cfg.reduced()
    model = Transformer(cfg, init_params(model_spec(cfg), 0, device=dev))
    keep = {p.data_ptr() for p in model.parameters()}
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, (BATCH, prompt_len)).astype(np.int32)

    # tokens: the six prompts in batches of 1, and of 4 and 2, against
    # the six as one batch
    def greedy_in(sets):
        return np.concatenate([greedy_generate(
            model, prompts[list(sel)], new, max_len).cpu().numpy()
            for sel in sets])

    whole = greedy_in([range(BATCH)])
    report: Dict[str, Any] = {
        "arch": cfg.name, "device": str(dev), "batch": BATCH,
        "prompt": prompt_len, "new": new, "tokens": {
            f"in_batches_of_{'_'.join(str(len(s_)) for s_ in sets)}":
            [_first_diff(a, w) for a, w in zip(greedy_in(sets), whole)]
            for sets in (ALONE, FOURS)}}
    sel_sets = list(ALONE) + list(FOURS)
    pick = lambda t, sel: t[list(sel)].contiguous()   # noqa: E731

    saved = attention_mod.flash_attention, rwkv_mod.rwkv6_scan
    attention_mod.flash_attention = _caught("flash_attention", saved[0])
    rwkv_mod.rwkv6_scan = _caught("rwkv6_scan", saved[1])
    try:
        tok = torch.as_tensor(prompts, device=dev).long()
        kinds = [cfg.block_pattern[i % cfg.period] for i in range(cfg.n_layers)]

        # the prefill, layer by layer
        def pre_layer(x, k, layer):
            return _apply_position(model.layers[layer], x, cfg, kinds[layer],
                                   mode="prefill")[0]

        def pre_head(x, k):
            h = apply_norm(model.final_norm, x, cfg)
            return logits_from_hidden(model.embed, h[:, -1:], cfg)[:, 0]

        with torch.no_grad():
            x6 = embed_tokens(model.embed, tok, cfg)
        xs = {k: pick(x6, sel) for k, sel in enumerate(sel_sets)}
        report["prefill"] = _chain(model, keep, sel_sets, x6, xs, pre_layer,
                                   pre_head, "prefill")

        # one decode step from the six prompts' cache; each smaller batch
        # steps its own copy of its rows of that cache
        with torch.no_grad():
            logits, cache6 = prefill(model, {"tokens": tok}, max_len)
        step_tok = torch.argmax(logits, dim=-1)
        caches = {None: cache6}
        for k, sel in enumerate(sel_sets):
            caches[k] = tree_map(lambda t, s=sel: t[:, list(s)].clone(), cache6)

        def step_layer(x, k, layer):
            b = x.shape[0]
            pos = torch.full((b,), prompt_len, dtype=torch.int64, device=dev)
            return _apply_position(model.layers[layer], x, cfg, kinds[layer],
                                   mode="decode", pos=pos,
                                   cache=_layer_cache(caches[k], cfg, layer))[0]

        def step_head(x, k):
            h = apply_norm(model.final_norm, x, cfg)
            return logits_from_hidden(model.embed, h, cfg)[:, 0]

        with torch.no_grad():
            x6 = embed_tokens(model.embed, step_tok[:, None], cfg)
        xs = {k: pick(x6, sel) for k, sel in enumerate(sel_sets)}
        report["step"] = _chain(model, keep, sel_sets, x6, xs, step_layer,
                                step_head, "step")
    finally:
        attention_mod.flash_attention, rwkv_mod.rwkv6_scan = saved
    return report


def summary(report: Dict[str, Any]) -> List[str]:
    lines = [f"{report['arch']} on {report['device']}: the first token where "
             f"greedy_generate parts from the batch of {report['batch']} "
             f"(-1: never): " + json.dumps(report["tokens"])]
    for phase in ("prefill", "step"):
        for label, r in report[phase].items():
            f = r["first"]
            where = ("no layer's output differs" if f["layer"] is None else
                     f"first differs at layer {f['layer']}, op {f['op']} "
                     f"{f.get('shapes', '')} (batch {f.get('batch_shapes', '')}, "
                     f"max abs {f.get('max_abs')})")
            iso = sorted({(o["op"], json.dumps(o["shapes"]))
                          for ops in r["isolated"].values() for o in ops})
            lines.append(f"  {label}: {where}; of {r['replayed']} ops replayed "
                         f"alone, differing: {r['differing'] or 'none'} "
                         f"{iso if iso else ''}")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    rep = run(args.arch, args.device)
    for line in summary(rep):
        print(line)
    print(json.dumps(rep))
