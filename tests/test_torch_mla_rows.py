"""MLA's absorbed decode products at a fixed shape per row, on the CPU.

The library picks a batched product's kernel, and with it the order of its
sums, by the batch count, so on the card a row of a batched absorbed
product could get other bits than the row alone.  ``mla_decode`` runs its
absorbed attention one row at a time: caught at the ATen dispatcher, every
product (``q_lat``, ``s_lat``, ``s_rope``, ``o_lat``, ``o``) and every
reduction of the softmax after the cache write has one shape at B = 1, 2
and 6, each B times.  The step's rows stay those of the batched step on
the CPU within 1e-5 of the largest magnitude (the same f32 products), and
the reduced deepseek stack's greedy tokens stay ``==`` the JAX package's
(``tests/test_torch_moe_models.py``).
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.models import mla
from repro_torch.models.params import init_params

ARCH = "deepseek-v2-236b"
PRODUCTS = {"mm", "bmm"}
REDUCTIONS = {"amax", "sum"}
T = 40


class _Record(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        shapes = tuple(tuple(a.shape) for a in args
                       if isinstance(a, torch.Tensor))
        self.ops.append((func.overloadpacket.__name__, shapes))
        return func(*args, **(kwargs or {}))


def _absorbed(b):
    """(name, operand shapes) of the products and reductions after the
    cache write of one decode step at batch ``b``, the output projection
    (the last product, rows of the whole batch) left out; and the output."""
    cfg = configs.get(ARCH).reduced()
    p = init_params(mla.mla_spec(cfg), 0, device="cpu")
    cache = mla.init_mla_cache(cfg, 6, T, device="cpu")
    rng = np.random.default_rng(1)
    for name in ("c_kv", "k_rope"):
        cache[name] = torch.from_numpy(rng.standard_normal(
            cache[name].shape).astype(np.float32))[:b].contiguous()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (6, 1, cfg.d_model)).astype(np.float32))[:b]
    pos = torch.tensor([3, 17, 39, 0, 25, 8])[:b]
    rec = _Record()
    with rec, torch.no_grad():
        y, _ = mla.mla_decode(p, x, cache, pos, cfg)
    last_write = max(i for i, (name, _) in enumerate(rec.ops)
                     if name.startswith("index_put"))
    ops = [o for o in rec.ops[last_write + 1:]
           if o[0] in PRODUCTS | REDUCTIONS]
    assert ops[-1][0] == "mm"                 # the output projection
    return ops[:-1], y


def test_absorbed_products_keep_one_shape_at_every_batch():
    one, _ = _absorbed(1)
    assert {name for name, _ in one} == PRODUCTS | REDUCTIONS
    per_row = collections.Counter(one)
    for b in (2, 6):
        ops, _ = _absorbed(b)
        assert collections.Counter(ops) == collections.Counter(
            {op: n * b for op, n in per_row.items()})


@pytest.mark.parametrize("b", [1, 2, 6])
def test_rows_are_the_batched_steps(b):
    _, y6 = _absorbed(6)
    _, yb = _absorbed(b)
    want = y6[:b].numpy()
    np.testing.assert_allclose(yb.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_the_engine_step_shape_on_meta():
    cfg = dataclasses.replace(configs.get(ARCH).reduced(), dtype="bfloat16")
    p = {k: torch.empty(s.shape, device="meta")
         for k, s in mla.mla_spec(cfg).items()}
    cache = mla.mla_cache_struct(cfg, 4, T)
    y, _ = mla.mla_decode(p, torch.empty((4, 1, cfg.d_model), device="meta",
                                         dtype=torch.bfloat16), cache,
                          torch.empty(4, dtype=torch.int64, device="meta"),
                          cfg)
    assert y.is_meta and y.shape == (4, 1, cfg.d_model)
