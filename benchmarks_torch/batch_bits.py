"""Which op of the LM path gives a row of a batch other bits than the row alone.

The decode engine prefills one prompt at a time (batch 1) and steps its
slots together; ``greedy_generate`` prefills and steps a whole batch.  Where
one op gives a row of a batch other bits than the same row run in a smaller
batch, the two can pick different tokens.  This script finds that op for
one model at full width and depth (random weights from seed 0, six prompts
of 256 tokens from numpy seed 2, as ``chip_smoke.py`` phases 8 and 9 serve
them).  The two MoE families draw their weights in bf16 (an f32
moonshot-v1-16b-a3b tree, 112 GB, fits no card), and deepseek-v2-236b runs
the depth cut phase 9 serves (:data:`DEPTH`: its dense first layer and
three MLA + MoE layers), jamba-1.5-large-398b the cut phase 10a serves
(its first four layers, the block and mlp patterns cut with them, a bf16
tree); the others keep the f32 draw cast to bf16.  The
batch axis of an op's operand is the one axis whose length differs between
the batch-6 run and the smaller one (an MoE's expert products carry the
routing groups, one a sequence in a prefill and one a token in a step, on
axis 1 of (E, groups * capacity, D)):

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
  ``differing`` those that differ by op, ``unpaired`` the ops that
  compute bits in one run and pair with no op of the other, which no
  replay reaches).  Ops are paired by name with difflib; ``first`` also
  lists the unpaired ops that ran before its op (``unpaired_before``) and
  the unpaired ranges of that layer (``unmatched``).

Ops are caught at the ATen dispatcher (``TorchDispatchMode``); the
hand-written kernels on the path (``flash_attention``, ``decode_attention``,
``rwkv6_scan``, ``mamba_scan`` and the norms ``rms_norm``, ``layer_norm``,
``group_norm``) launch outside it and are caught at their wrappers, and so
is ``rows_matmul`` (the products on fixed chunks of token rows), whose
chunks hold the rows of several sequences: it is compared at its output,
never by the ops within it.

Run on the card (prints a summary and, last, the report as one JSON line)::

    PYTHONPATH=src python3 -m benchmarks_torch.batch_bits [--arch ARCH]

with ARCH one of qwen2.5-3b (the default), rwkv6-3b, moonshot-v1-16b-a3b,
deepseek-v2-236b and jamba-1.5-large-398b (whose recorded operands at 256
tokens outgrow the 34 GB its 46 GB tree leaves on an 80 GB card: call
``run(arch, prompt_len=...)`` with a shorter prompt).
"""

from __future__ import annotations

import argparse
import dataclasses
import difflib
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch import configs
from repro_torch.core.runtime import resolve_device
from repro_torch.models import attention as attention_mod
from repro_torch.models import layers as layers_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import (apply_norm, cdtype, embed_tokens,
                                       logits_from_hidden)
from repro_torch.models.params import init_params
from repro_torch.models.transformer import (Transformer, _apply_position,
                                            _layer_cache, _layer_kinds,
                                            cache_axes, model_spec,
                                            n_scanned, prefill)
from repro_torch.train.serve import greedy_generate

BATCH, PROMPT, NEW, MAX_LEN = 6, 256, 16, 512
#: layers kept where the whole model fits no card (chip_smoke.py phases 9
#: and 10a; a pattern longer than the cut is cut with it)
DEPTH = {"deepseek-v2-236b": 4, "jamba-1.5-large-398b": 4}
#: archs whose weights are drawn in bf16 rather than f32 then cast
BF16_TREE = ("moonshot-v1-16b-a3b", "deepseek-v2-236b",
             "jamba-1.5-large-398b")
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
    """A copy of ``t`` with its strides (a copy of the span of its storage
    that it covers, viewed the same way), so that a replayed op sees the
    layout the run gave it.  Only the span is copied: a layer's cache is a
    view of the cache stacked over all layers, and a copy of the whole
    storage at every layer outgrew the card."""
    t = t.detach()
    if t.numel() == 0 or any(st < 0 for st in t.stride()):
        return t.clone()
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    flat = torch.as_strided(t, (span,), (1,), t.storage_offset()).clone()
    out = t.new_empty(0)
    out.set_(flat.untyped_storage(), 0, t.size(), t.stride())
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
    strides), shaped as the batch-n one, along the one axis whose length
    differs (the batch axis, or the routing groups of an MoE's expert
    rows, each ``r`` long); the tensor itself where both shapes agree (a
    weight); None where no single axis tells the batch apart."""
    if not isinstance(big, torch.Tensor) or not isinstance(small, torch.Tensor):
        return None
    if big.shape == small.shape:
        return big
    axes = [i for i, (a, b) in enumerate(zip(big.shape, small.shape))
            if a != b]
    if big.dim() != small.dim() or len(axes) != 1:
        return None
    ax = axes[0]
    if (big.shape[ax] % BATCH or small.shape[ax] % len(sel)
            or big.shape[ax] // BATCH != small.shape[ax] // len(sel)):
        return None
    r = small.shape[ax] // len(sel)
    return big.narrow(ax, sel[0] * r, len(sel) * r)


def _floats(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def _is_view(op: _Op) -> bool:
    """Whether the op returns a view of an input (split, slice, reshape):
    it computes no bits of its own."""
    schema = getattr(op.func, "_schema", None)
    return schema is not None and any(r.alias_info is not None
                                      for r in schema.returns)


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


def _alignment(big: List[_Op], small: List[_Op]):
    """difflib's opcodes over the two runs' op names: an ``equal`` range
    pairs op for op; the others hold ops of one run that pair with none of
    the other's (a batch can change the op sequence: a reshape that copies
    at B = 6 is a view at B = 1)."""
    return difflib.SequenceMatcher(None, [o.name for o in big],
                                   [o.name for o in small],
                                   autojunk=False).get_opcodes()


def _computes(op: _Op) -> bool:
    """Whether the op computes bits of its own (floats out, not a view)."""
    return _comparable(op) and not _is_view(op)


def _unpaired(big: List[_Op], small: List[_Op], tag, i1, i2, j1, j2):
    """The ops of an unpaired range that compute bits, with their run
    ("batch": the batch-6 run, "rows": the smaller one) and index."""
    return ([{"run": "batch", "index": i, "op": big[i].name}
             for i in range(i1, i2) if _computes(big[i])]
            + [{"run": "rows", "index": j, "op": small[j].name}
               for j in range(j1, j2) if _computes(small[j])])


def _paired(big: List[_Op], small: List[_Op]):
    """(index in ``big``, big op, small op) for the ops the two runs share,
    in run order, and the ops that compute bits in the ranges that pair
    with nothing (:func:`_unpaired`)."""
    pairs, lone = [], []
    for tag, i1, i2, j1, j2 in _alignment(big, small):
        if tag == "equal":
            pairs += [(i1 + t, big[i1 + t], small[j1 + t])
                      for t in range(i2 - i1)]
        else:
            lone += _unpaired(big, small, tag, i1, i2, j1, j2)
    return pairs, lone


def _first_op(big: List[_Op], small: List[_Op], sel) -> Dict[str, Any]:
    """The first paired op, in run order, whose output differs on the
    shared rows; before it, the unpaired ops that compute bits
    (``unpaired_before``: a first difference may arise in one of them,
    which no pair compares), and every unpaired range (``unmatched``:
    difflib's [tag, i1, i2, j1, j2], i in the batch run, j in the other)."""
    lone: List[Dict[str, Any]] = []
    unmatched = []
    for tag, i1, i2, j1, j2 in _alignment(big, small):
        if tag != "equal":
            lone += _unpaired(big, small, tag, i1, i2, j1, j2)
            unmatched.append([tag, i1, i2, j1, j2])
            continue
        for t in range(i2 - i1):
            ob, os_ = big[i1 + t], small[j1 + t]
            if not _comparable(ob) or ob.name.startswith("rows_matmul/"):
                continue
            d = _differs(ob.out, os_.out, sel)
            if d is not None:
                return {"index": i1 + t, "op": ob.name,
                        "shapes": _shapes(os_.args),
                        "batch_shapes": _shapes(ob.args), "max_abs": d,
                        "unpaired_before": lone, "unmatched": unmatched}
    return {"index": None, "op": None, "unpaired_before": lone,
            "unmatched": unmatched}


def _isolated(big: List[_Op], small: List[_Op], sel):
    """Each op replayed on the shared rows of the batch run's operands
    against the same op replayed on the whole batch; -> (those that
    differ, the number replayed, the unpaired ops that compute bits,
    which no replay reaches).  A caught kernel is replayed whole: the
    ATen ops its plain version runs within it (``name/op``) are left out,
    since their sequence may differ with the batch (an einsum decomposes
    otherwise around a length-1 axis), and views and ops whose operands
    differ in structure are skipped."""
    found, n = [], 0
    big = [o for o in big if "/" not in o.name]
    small = [o for o in small if "/" not in o.name]
    pairs, lone = _paired(big, small)
    for _, ob, os_ in pairs:
        if (not _comparable(ob) or _is_view(ob)
                or ob.name.rsplit(".", 1)[0].endswith("_")):   # in place
            continue
        flat_b, spec_b = tree_flatten((ob.args, ob.kwargs))
        flat_s, spec_s = tree_flatten((os_.args, os_.kwargs))
        if spec_b != spec_s:
            continue
        pairs = zip(flat_b, flat_s)
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
            args, kwargs = spec_s.unflatten(leaves)
            with torch.no_grad():
                part = os_.func(*args, **kwargs)
                whole = ob.func(*ob.args, **ob.kwargs)
            n += 1
            d = _differs(whole, part, sel)
            if d is not None:
                found.append({"op": ob.name, "shapes": _shapes(os_.args),
                              "batch_shapes": _shapes(ob.args), "max_abs": d})
    return found, n, lone


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
    counts = {k: {"replayed": 0, "differing": {}, "unpaired": {}}
              for k in range(len(sel_sets))}
    x6, xs = big_x, dict(small_x)
    first = ["layer0"] if model.layer0 is not None else []
    for layer in first + list(range(n_scanned(model.cfg))) + ["head"]:
        fn = head_fn if layer == "head" else (lambda x, k, L=layer: layer_fn(x, k, L))
        x6_next, ops6 = _recorded(keep, lambda: fn(x6, None))
        for k, sel in enumerate(sel_sets):
            xk_next, opsk = _recorded(keep, lambda: fn(xs[k], k))
            if k not in found and _differs(x6_next, xk_next, sel) is not None:
                found[k] = {"layer": layer, **_first_op(ops6, opsk, sel)}
            ops, n, lone = _isolated(ops6, opsk, sel)
            counts[k]["replayed"] += n
            for key, found_ops in (("differing", ops), ("unpaired", lone)):
                c = counts[k][key]
                for o in found_ops:
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
    elif arch in DEPTH:
        n = DEPTH[arch]
        cfg = dataclasses.replace(cfg, n_layers=n,
                                  block_pattern=cfg.block_pattern[:n],
                                  mlp_pattern=cfg.mlp_pattern[:n])
    tree_dtype = cdtype(cfg) if arch in BF16_TREE else torch.float32
    model = Transformer(cfg, init_params(model_spec(cfg), 0, dtype=tree_dtype,
                                         device=dev))
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
        "layers": cfg.n_layers, "tree_dtype": str(tree_dtype),
        "prompt": prompt_len, "new": new, "tokens": {
            f"in_batches_of_{'_'.join(str(len(s_)) for s_ in sets)}":
            [_first_diff(a, w) for a, w in zip(greedy_in(sets), whole)]
            for sets in (ALONE, FOURS)}}
    sel_sets = list(ALONE) + list(FOURS)
    pick = lambda t, sel: t[list(sel)].contiguous()   # noqa: E731

    caught = ((attention_mod, "flash_attention"), (mla_mod, "flash_attention"),
              (attention_mod, "decode_attention"), (layers_mod, "rms_norm"),
              (layers_mod, "layer_norm"), (rwkv_mod, "group_norm"),
              (rwkv_mod, "rwkv6_scan"), (mamba_mod, "mamba_scan"),
              (attention_mod, "rows_matmul"), (mamba_mod, "rows_matmul"),
              (moe_mod, "rows_matmul"))
    saved = [getattr(mod, name) for mod, name in caught]
    for (mod, name), fn in zip(caught, saved):
        setattr(mod, name, _caught(name, fn))
    try:
        tok = torch.as_tensor(prompts, device=dev).long()

        def layer_of(layer):
            """(parameters, block kind, mlp kind) of a chain's layer."""
            if layer == "layer0":
                return model.layer0, cfg.block_pattern[0], "dense"
            return (model.layers[layer],) + _layer_kinds(cfg, layer)

        # the prefill, layer by layer
        def pre_layer(x, k, layer):
            p, kind, mlp_kind = layer_of(layer)
            return _apply_position(p, x, cfg, kind, mlp_kind,
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
        # each leaf's batch axis (1 behind the stacked layers, 0 in layer0)
        bax = tree_map(lambda ax: ax.index("batch"), cache_axes(cfg),
                       is_leaf=lambda ax: isinstance(ax, tuple)
                       and all(a is None or isinstance(a, str) for a in ax))
        for k, sel in enumerate(sel_sets):
            caches[k] = tree_map(
                lambda t, ax, s=sel: t.index_select(
                    ax, torch.tensor(list(s), device=t.device)), cache6, bax)

        def step_layer(x, k, layer):
            b = x.shape[0]
            pos = torch.full((b,), prompt_len, dtype=torch.int64, device=dev)
            p, kind, mlp_kind = layer_of(layer)
            cache = (caches[k]["layer0"] if layer == "layer0"
                     else _layer_cache(caches[k], cfg, layer))
            return _apply_position(p, x, cfg, kind, mlp_kind, mode="decode",
                                   pos=pos, cache=cache)[0]

        def step_head(x, k):
            h = apply_norm(model.final_norm, x, cfg)
            return logits_from_hidden(model.embed, h, cfg)[:, 0]

        with torch.no_grad():
            x6 = embed_tokens(model.embed, step_tok[:, None], cfg)
        xs = {k: pick(x6, sel) for k, sel in enumerate(sel_sets)}
        report["step"] = _chain(model, keep, sel_sets, x6, xs, step_layer,
                                step_head, "step")
    finally:
        for (mod, name), fn in zip(caught, saved):
            setattr(mod, name, fn)
    return report


def summary(report: Dict[str, Any]) -> List[str]:
    lines = [f"{report['arch']} ({report['layers']} layers, weights drawn in "
             f"{report['tree_dtype']}) on {report['device']}: the first token where "
             f"greedy_generate parts from the batch of {report['batch']} "
             f"(-1: never): " + json.dumps(report["tokens"])]
    for phase in ("prefill", "step"):
        for label, r in report[phase].items():
            f = r["first"]
            where = ("no layer's output differs" if f["layer"] is None else
                     f"first differs at layer {f['layer']}, op {f['op']} "
                     f"{f.get('shapes', '')} (batch {f.get('batch_shapes', '')}, "
                     f"max abs {f.get('max_abs')}); unpaired ops that compute "
                     f"before it: "
                     f"{[o['op'] for o in f.get('unpaired_before', [])] or 'none'}")
            iso = sorted({(o["op"], json.dumps(o["shapes"]))
                          for ops in r["isolated"].values() for o in ops})
            lines.append(f"  {label}: {where}; of {r['replayed']} ops replayed "
                         f"alone, differing: {r['differing'] or 'none'} "
                         f"{iso if iso else ''}; unpaired (not replayed): "
                         f"{r['unpaired'] or 'none'}")
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
