"""The port's sharding rules (``repro_torch.distributed.sharding``) held
against the JAX package's on the CPU.

* **Specs**: ``spec_for`` / ``param_specs`` / ``batch_spec`` /
  ``train_rules_for`` ``==`` JAX's as tuples, for every arch in ``configs``
  at full size under the four rule tables, on duck-typed meshes (16, 16),
  (2, 16, 16), (2, 4), (4,) and (1, 1) and on the port's ``LocalMesh``.
* **Layout**: each position's block under the port's placements equals the
  slice JAX's ``NamedSharding.devices_indices_map`` gives that device: the
  index maps come from one JAX subprocess with 8 forced host devices; the
  port's blocks from ``shard_slices`` and, for the DTensor placements of
  ``placements_for``, from the local shard of each of 8 gloo ranks.
* ``constrain`` is a no-op with no rules active and a redistribute under
  ``activate``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import repro.configs as jconfigs
import repro.distributed.sharding as jsh
import repro.models.transformer as jtransformer
import repro_torch.configs as tconfigs
import repro_torch.distributed.sharding as tsh
import repro_torch.models.transformer as ttransformer
from repro_torch.models.params import leaves_with_path

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ranks  # noqa: E402
from torch_ranks import one_thread  # noqa: E402,F401


class FakeMesh:
    """Duck-typed mesh for spec logic (axis sizes only), as the JAX
    package's tests use."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty(tuple(axes.values()), object)


MESHES = {
    "16x16": dict(data=16, model=16),
    "2x16x16": dict(pod=2, data=16, model=16),
    "2x4": dict(data=2, model=4),
    "4": dict(data=4),
    "1x1": dict(data=1, model=1),
}
RULES = {
    "train": ("TRAIN_RULES", None),
    "train-fsdp": ("TRAIN_FSDP_RULES", None),
    "serve": ("SERVE_RULES", None),
    "serve+sp": ("SERVE_RULES", True),
}


def _rules(pkg, key):
    name, sp = RULES[key]
    r = getattr(pkg, name)
    return r.with_seq_sharding(True) if sp else r


def _local_mesh(axes):
    shape = tuple(axes.values())
    devs = np.empty(shape, object)
    devs[...] = "cpu"
    return tsh.LocalMesh(devs, tuple(axes))


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {jax.tree_util.keystr(p): tuple(v) for p, v in flat}


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("rules_key", list(RULES))
def test_param_specs_equal_jax_for_every_arch(mesh_key, rules_key):
    axes = MESHES[mesh_key]
    jr, tr = _rules(jsh, rules_key), _rules(tsh, rules_key)
    for arch in jconfigs.ARCHS:
        jtree = jsh.param_specs(jtransformer.model_spec(jconfigs.ARCHS[arch]),
                                jr, FakeMesh(**axes))
        want = _jax_leaves(jtree)
        tspec = ttransformer.model_spec(tconfigs.ARCHS[arch])
        for mesh in (FakeMesh(**axes), _local_mesh(axes)):
            got = {p: tuple(v) for p, v in
                   leaves_with_path(tsh.param_specs(tspec, tr, mesh))}
            assert got == want, (arch, mesh_key, rules_key)
        assert all(isinstance(v, tsh.PartitionSpec) for _, v in
                   leaves_with_path(tsh.param_specs(tspec, tr,
                                                    FakeMesh(**axes))))


#: activation-like tensors: (logical axes, shape) pairs the models and the
#: serving lanes tag, at the production cells' sizes
ACTIVATIONS = [
    (("batch", "seq", None), (256, 4096, 2048)),
    (("batch", "seq", None), (128, 4096, 2048)),
    (("batch", "seq", None), (7, 4096, 2048)),
    (("batch", None, "kv_seq", None), (128, 8, 32768, 128)),
    (("batch", "kv_heads", None, None), (256, 36, 4096, 64)),
    (("batch", "heads", None), (32, 4096, 64)),
    (("batch", "vocab"), (256, 102400)),
    (("batch",), (512,)),
    (("batch",), (3,)),
    ((None, "mlp"), (8, 12)),
    (("expert", "embed", "mlp"), (160, 5120, 1536)),
]


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_spec_for_batch_spec_and_rule_selection_equal_jax(mesh_key):
    axes = MESHES[mesh_key]
    jm, tm = FakeMesh(**axes), FakeMesh(**axes)
    for key in RULES:
        jr, tr = _rules(jsh, key), _rules(tsh, key)
        for logical, shape in ACTIVATIONS:
            want = tuple(jsh.spec_for(logical, jr, jm, shape))
            assert tuple(tsh.spec_for(logical, tr, tm, shape)) == want
            assert tuple(tsh.spec_for(logical, tr, _local_mesh(axes),
                                      shape)) == want
            # without a shape: no divisibility fallback
            assert (tuple(tsh.spec_for(logical, tr, tm))
                    == tuple(jsh.spec_for(logical, jr, jm)))
        for ndim in (1, 2, 3, 4):
            assert (tuple(tsh.batch_spec(tr, tm, ndim))
                    == tuple(jsh.batch_spec(jr, jm, ndim)))
    # no rules active: the empty spec
    assert tsh.spec_for(("batch",)) == tsh.P() == ()
    for arch, cfg in jconfigs.ARCHS.items():
        count = cfg.param_count()
        assert tconfigs.ARCHS[arch].param_count() == count
        assert (tsh.train_rules_for(count).name
                == jsh.train_rules_for(count).name)
    for big in (int(1e9), int(2e10), int(1e11)):
        assert tsh.train_rules_for(big).name == jsh.train_rules_for(big).name
    assert tsh.TP_PARAM_THRESHOLD == jsh.TP_PARAM_THRESHOLD
    for key in RULES:
        jr, tr = _rules(jsh, key), _rules(tsh, key)
        assert (tr.name, tr.table, tr.seq_sharded) == (jr.name, jr.table,
                                                       jr.seq_sharded)


def test_active_rules_context_matches_jax():
    mesh = FakeMesh(pod=2, data=16, model=16)
    assert tsh.active_rules() is None and tsh.active_mesh() is None
    assert tsh.active_axis_size("data") == 1
    with tsh.activate(tsh.TRAIN_FSDP_RULES, mesh):
        assert tsh.active_rules() is tsh.TRAIN_FSDP_RULES
        assert tsh.active_mesh() is mesh
        assert tsh.active_axis_size("model") == 16
        assert tsh.active_axis_size("pod") == 2
        assert tsh.active_axis_size("expert") == 1
        got = tuple(tsh.spec_for(("batch", "vocab"), shape=(256, 102400)))
        with jsh.activate(jsh.TRAIN_FSDP_RULES, mesh):
            assert got == tuple(jsh.spec_for(("batch", "vocab"),
                                             shape=(256, 102400)))
    assert tsh.active_rules() is None
    # the pruning helper, as JAX's
    for axes in (None, "pod", "data", ("pod", "data"), ("pod",)):
        for m in (FakeMesh(data=2, model=2), mesh):
            assert tsh._prune(m, axes) == jsh._prune(m, axes)


def test_partition_spec_is_a_tuple_normalised_as_jax():
    assert tsh.P(("data",)) == ("data",) == tuple(JP(("data",)))
    assert tsh.P("data", None) == ("data", None) == tuple(JP("data", None))
    assert tsh.P(("data", "model"), None) == tuple(JP(("data", "model"), None))
    assert repr(tsh.P("data")) == "PartitionSpec('data',)"


# ---------------------------------------------------------------------------
# Layout: each position's block against JAX's index map
# ---------------------------------------------------------------------------
#: (mesh shape, axis names, spec entries, tensor shape); the first is
#: TRAIN_FSDP_RULES' batch on the multi-pod mesh's axis order
LAYOUTS = [
    ((2, 2, 2), ("pod", "data", "model"), [["data", "model", "pod"]], (16, 3)),
    ((2, 2, 2), ("pod", "data", "model"), [["data", "model", "pod"]], (8, 6)),
    ((2, 2, 2), ("pod", "data", "model"), [["pod", "data"], "model"], (8, 6)),
    ((2, 2, 2), ("pod", "data", "model"), [None, ["model", "pod"]], (5, 8)),
    ((2, 4), ("data", "model"), ["data", "model"], (6, 8)),
    ((2, 4), ("data", "model"), [["model", "data"]], (16, 2)),
    ((2, 4), ("data", "model"), [None, "data"], (3, 4)),
    ((8,), ("data",), ["data", None], (8, 2)),
    ((4, 2), ("data", "model"), [], (4, 4)),
]

_JAX_MAPS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.loads(sys.argv[1])
out = []
for shape, names, spec, tshape in cases:
    mesh = Mesh(np.array(jax.devices()).reshape(shape), tuple(names))
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    imap = NamedSharding(mesh, spec).devices_indices_map(tuple(tshape))
    out.append({str(d.id): [[s.start or 0, n if s.stop is None else s.stop]
                            for s, n in zip(sl, tshape)]
                for d, sl in imap.items()})
print(json.dumps(out))
"""


def _spec_entries(spec):
    return [tuple(e) if isinstance(e, list) else e for e in spec]


@pytest.fixture(scope="module")
def both_sides(tmp_path_factory):
    """JAX's index maps (one subprocess, 8 forced host devices) and one
    start of 8 gloo ranks for the layout cases and ``constrain``, side by
    side."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _JAX_MAPS,
                             json.dumps(LAYOUTS)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        cases = [(s, n, _spec_entries(sp), t) for s, n, sp, t in LAYOUTS]
        ranks = torch_ranks.run(8, tmp_path_factory.mktemp("ranks8"),
                                "layout", cases)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), ranks


@pytest.fixture(scope="module")
def jax_maps(both_sides):
    return both_sides[0]


@pytest.fixture(scope="module")
def ranks8(both_sides):
    return both_sides[1]


def test_shard_slices_equal_jax_index_maps(jax_maps):
    for (shape, names, spec, tshape), imap in zip(LAYOUTS, jax_maps):
        mesh = _local_mesh(dict(zip(names, shape)))
        blocks = tsh.shard_slices(tsh.P(*_spec_entries(spec)), mesh, tshape)
        for rank, pos in enumerate(np.ndindex(tuple(shape))):
            got = [[s.start, s.stop] for s in blocks[pos]]
            assert got == imap[str(rank)], (shape, names, spec, rank)


def test_each_rank_holds_jax_block_under_placements(jax_maps, ranks8):
    """8 gloo ranks, rank r at flat mesh position r as JAX's device r: each
    rank's local shard under ``placements_for`` is the block JAX's index map
    gives device r, and gathers back whole."""
    for rank, results in enumerate(ranks8):
        for (shape, names, spec, tshape), imap, (local, whole) in zip(
                LAYOUTS, jax_maps, results["layout"]):
            x = np.arange(int(np.prod(tshape)), dtype=np.float32).reshape(
                tshape)
            want = x[tuple(slice(a, b) for a, b in imap[str(rank)])]
            np.testing.assert_array_equal(local, want)
            assert whole, (shape, names, spec, rank)


def test_placements_follow_the_spec_order(jax_maps):
    """The multi-axis batch on the (pod, data, model) mesh needs a strided
    shard on "pod" (split after data x model); in mesh order it is plain.
    ``spec_of`` gives every layout case's spec back from its placements."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    mesh = _local_mesh(dict(pod=2, data=2, model=2))
    got = tsh.placements_for(tsh.P(("data", "model", "pod")), mesh)
    assert isinstance(got[0], _StridedShard) and got[0].dim == 0
    assert got[0].split_factor == 4
    assert got[1:] == (Shard(0), Shard(0))
    assert tsh.placements_for(tsh.P(("pod", "data", "model")), mesh) == (
        Shard(0), Shard(0), Shard(0))
    assert tsh.placements_for(tsh.P(None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))
    # spec_of, which distribute_tree cuts blocks by, inverts placements_for
    for shape, names, spec, _t in LAYOUTS:
        lm = _local_mesh(dict(zip(names, shape)))
        want = _spec_entries(spec)
        while want and want[-1] is None:        # spec_for's trimmed form
            want.pop()
        assert tsh.spec_of(tsh.placements_for(tsh.P(*want), lm),
                           lm) == tsh.P(*want)


def test_constrain_is_a_noop_unless_active_then_redistributes(jax_maps,
                                                              ranks8):
    """No rules or no DeviceMesh: ``constrain`` returns its argument.  On
    the 8 ranks' (pod, data, model) mesh under ``TRAIN_FSDP_RULES``, a
    replicated batch is redistributed to the rule's spec (JAX's
    ``("data", "model", "pod")`` batch), each rank holding JAX's block."""
    import torch
    x = torch.ones(4, 2)
    assert tsh.constrain(x, "batch", None) is x
    with tsh.activate(tsh.TRAIN_RULES, FakeMesh(data=2, model=2)):
        assert tsh.constrain(x, "batch", None) is x   # no DeviceMesh
    mesh = FakeMesh(pod=2, data=2, model=2)
    want_spec = tuple(jsh.spec_for(("batch", None), jsh.TRAIN_FSDP_RULES,
                                   mesh, (8, 6)))
    assert want_spec == (("data", "model", "pod"),)
    imap = jax_maps[LAYOUTS.index(((2, 2, 2), ("pod", "data", "model"),
                                   [["data", "model", "pod"]], (8, 6)))]
    x = np.arange(48, dtype=np.float32).reshape(8, 6)
    for rank, r in enumerate(ranks8):
        got = r["constrain"]
        local = got.pop("local")
        assert got == {"plain": True, "local_x": True, "spec": want_spec,
                       "placements": True, "whole": True}
        np.testing.assert_array_equal(
            local, x[tuple(slice(a, b) for a, b in imap[str(rank)])])
