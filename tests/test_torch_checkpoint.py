"""The port's checkpoint store: roundtrip, atomic overwrite, rotation, and
checkpoints that cross between the port and the JAX package bit for bit
(bf16 leaves included: the port writes and reads them as raw bytes under
the dtype name "bfloat16", without ml_dtypes)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.models.params import leaves_with_path


def _state(seed):
    """A train state's layout: f32 params (stacked blocks), bf16 moments,
    an int32 step."""
    g = torch.Generator().manual_seed(seed)
    params = {"blocks": {"pos0": {"wq": torch.randn(2, 4, 3, generator=g)}},
              "embed": {"embedding": torch.randn(5, 4, generator=g)}}
    bf16 = {"blocks": {"pos0": {"wq": torch.randn(2, 4, 3, generator=g).to(
        torch.bfloat16)}},
        "embed": {"embedding": torch.randn(5, 4, generator=g).to(torch.bfloat16)}}
    return {"params": params, "opt": {"m": bf16, "v": bf16,
                                      "step": torch.tensor(7, dtype=torch.int32)}}


def _equal_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    assert torch.equal(a, b)


def test_roundtrip_with_and_without_like(tmp_path):
    state = _state(0)
    save_checkpoint(str(tmp_path / "ck"), state, step=3, meta={"arch": "x"})
    back, manifest = load_checkpoint(str(tmp_path / "ck"), like=state)
    assert manifest["step"] == 3 and manifest["meta"] == {"arch": "x"}
    for (path, a), (path2, b) in zip(leaves_with_path(state),
                                     leaves_with_path(back)):
        assert path == path2
        _equal_bits(a, b)
    flat, _ = load_checkpoint(str(tmp_path / "ck"))
    assert sorted(flat) == [p for p, _ in leaves_with_path(state)]
    assert manifest["leaves"]["['opt']['m']['embed']['embedding']"][
        "dtype"] == "bfloat16"


def test_atomic_overwrite_leaves_no_tmp(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, _state(0), step=1)
    os.makedirs(path + ".tmp")                 # a crash's leftover
    save_checkpoint(path, _state(1), step=2)
    assert not os.path.exists(path + ".tmp")
    back, manifest = load_checkpoint(path, like=_state(1))
    assert manifest["step"] == 2
    _equal_bits(back["params"]["embed"]["embedding"],
                _state(1)["params"]["embed"]["embedding"])


def test_manager_rotates_and_restores_the_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest_step() is None
    assert mgr.restore_latest(like=_state(0)) == (None, None)
    for step in (4, 8, 12):
        mgr.save_async(_state(step), step)
    mgr.wait()
    assert mgr.all_steps() == [8, 12] and mgr.latest_step() == 12
    back, manifest = mgr.restore_latest(like=_state(0))
    assert manifest["step"] == 12
    _equal_bits(back["opt"]["v"]["blocks"]["pos0"]["wq"],
                _state(12)["opt"]["v"]["blocks"]["pos0"]["wq"])
    # under a mesh: the elastic path places the latest checkpoint's leaves
    # under the mesh's placements (a world-1 gloo group of this process,
    # destroyed at the end; N -> M ranks in tests/test_torch_elastic.py)
    import torch.distributed as dist
    from repro_torch.distributed.sharding import TRAIN_FSDP_RULES
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import ParamSpec, map_tree
    state = _state(0)
    spec = map_tree(lambda t: ParamSpec(tuple(t.shape),
                                        (None,) * t.dim()), state)
    try:
        mesh = make_host_mesh(device_type="cpu")
        placed, manifest = mgr.restore_latest(
            like=state, spec_tree=spec, rules=TRAIN_FSDP_RULES, mesh=mesh)
        assert manifest["step"] == 12
        _equal_bits(placed["opt"]["v"]["blocks"]["pos0"]["wq"].full_tensor(),
                    _state(12)["opt"]["v"]["blocks"]["pos0"]["wq"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_save_async_snapshots_before_an_in_place_update(tmp_path):
    """The train step updates params and moments in place right after
    ``save_async`` returns; the checkpoint holds the bits from before."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _state(3)
    before = {path: t.clone() for path, t in leaves_with_path(state)}
    mgr.save_async(state, 5)
    for _, t in leaves_with_path(state):
        t.add_(1)
    mgr.wait()
    back, _ = mgr.restore_latest(like=state)
    for path, b in leaves_with_path(back):
        _equal_bits(b, before[path])


def _jax_tree(state):
    import ml_dtypes

    def conv(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy().view(
                ml_dtypes.bfloat16))
        return jnp.asarray(t.numpy())
    return jax.tree_util.tree_map(conv, state)


def test_a_jax_checkpoint_restores_into_the_port(tmp_path):
    state = _state(3)
    j_save_checkpoint(str(tmp_path / "ck"), _jax_tree(state), step=5,
                      meta={"seed": 1})
    back, manifest = load_checkpoint(str(tmp_path / "ck"), like=state)
    assert manifest["step"] == 5
    for (_, a), (_, b) in zip(leaves_with_path(state), leaves_with_path(back)):
        _equal_bits(a, b)
    # the JAX manager's directory layout, read by the port's manager
    jm = JCheckpointManager(str(tmp_path / "mgr"))
    jm.save_async(_jax_tree(state), 9)
    jm.wait()
    back, manifest = CheckpointManager(str(tmp_path / "mgr")).restore_latest(
        like=state)
    assert manifest["step"] == 9
    _equal_bits(back["opt"]["m"]["embed"]["embedding"],
                state["opt"]["m"]["embed"]["embedding"])


def test_a_port_checkpoint_restores_into_jax(tmp_path):
    state = _state(4)
    save_checkpoint(str(tmp_path / "ck"), state, step=6)
    like = _jax_tree(state)
    back, manifest = j_load_checkpoint(str(tmp_path / "ck"), like=like)
    assert manifest["step"] == 6
    with open(tmp_path / "ck" / "manifest.json") as f:
        assert json.load(f)["leaves"].keys() == {
            jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(like)[0]}
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(like)[0],
                              jax.tree_util.tree_flatten_with_path(back)[0]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
