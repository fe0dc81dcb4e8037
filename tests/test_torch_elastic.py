"""Elastic restore and cross-mesh resharding of the port
(``repro_torch.distributed.elastic``, ``repro_torch.checkpoint.
restore_sharded``) on gloo ranks.

A small ParamSpec tree (f32 and bf16 leaves, every logical axis the rules
shard) is distributed under ``TRAIN_FSDP_RULES`` on a (data, model) mesh of
2 ranks, gathered and written by rank 0; 4 ranks (a world of their own,
running beside) restore it through ``restore_sharded`` and
``CheckpointManager.restore_latest(mesh=)`` — each rank's block is the
slice the spec gives its position (JAX's layout, see
``tests/test_torch_sharding.py``), only that block is moved to the device
(as JAX's ``device_put`` moves each device its shard), and the gathered
leaves keep the bits —
and write it again, which the 2 ranks restore.  Each world also moves the
tree between a (world,) mesh and its (2, world / 2) one with
``reshard_arrays``.
On one process, ``replicate`` and the mesh-less paths work as the JAX
package's 1-device tests.
"""

import os
import sys

import numpy as np
import pytest
import torch

import repro.distributed.elastic as jel
from repro_torch.checkpoint import CheckpointManager, save_checkpoint
from repro_torch.distributed.elastic import gather_tree

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ranks  # noqa: E402
from torch_ranks import one_thread  # noqa: E402,F401


def test_checkpoint_n_to_m_restores_keep_the_bits(tmp_path):
    c2 = str(tmp_path / "c2" / "step_00000002")
    c4 = str(tmp_path / "c4" / "step_00000004")
    # two worlds side by side: 2 ranks write c2 and then restore c4; 4
    # ranks restore c2 and then write c4
    two, four = torch_ranks.run_groups(tmp_path, [
        (2, "elastic", ((2, 1), c4, c2, True)),
        (4, "elastic", ((2, 2), c2, c4, False))])
    for reports, step in ((four, 2), (two, 4)):
        for r in reports:
            assert r == {"step": step, "local": True, "whole": True,
                         "sharded": True, "blocks_moved": True,
                         "reshard": True}
    # the written checkpoints hold the seed's tree, in the JAX format
    spec, tree = torch_ranks._elastic_tree()
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.models.params import leaves_with_path
    for path in (c2, c4):
        back, _ = load_checkpoint(path, like=tree)
        for (_, a), (_, b) in zip(leaves_with_path(back),
                                  leaves_with_path(tree)):
            assert torch_ranks._bits(a) == torch_ranks._bits(b)


def test_single_process_paths_match_the_jax_package(tmp_path):
    """One process: ``reshard_arrays`` / ``replicate`` on
    ``make_host_mesh`` (a world-1 gloo group of this process, destroyed at
    the end) give the values JAX's do on its 1-device host mesh;
    ``gather_tree`` passes plain tensors through, ``restore_latest`` without
    a mesh loads CPU tensors, and the writer refuses a DTensor leaf, naming
    the way out."""
    import jax.numpy as jnp
    import torch.distributed as dist
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from repro.launch.mesh import make_host_mesh as j_host_mesh
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.distributed import reshard_arrays
    from repro_torch.distributed.elastic import replicate
    from repro_torch.launch.mesh import make_host_mesh

    x = np.arange(16.0, dtype=np.float32).reshape(4, 4)
    jmesh = j_host_mesh()
    jt = {"w": jnp.asarray(x)}
    j_out = jel.reshard_arrays(jt, {"w": NamedSharding(jmesh, JP("data"))})
    j_rep = jel.replicate(jt, jmesh)
    tree = {"w": torch.from_numpy(x.copy()), "b": torch.ones(3)}
    assert gather_tree(tree)["w"] is tree["w"]
    try:
        mesh = make_host_mesh(device_type="cpu")
        out = reshard_arrays({"w": tree["w"]},
                             {"w": (Shard(0), Shard(1))}, mesh)
        assert isinstance(out["w"], DTensor)
        np.testing.assert_array_equal(out["w"].full_tensor().numpy(),
                                      np.asarray(j_out["w"]))
        rep = replicate(out, mesh)
        np.testing.assert_array_equal(rep["w"].to_local().numpy(),
                                      np.asarray(j_rep["w"]))
        with pytest.raises(TypeError, match="gather_tree"):
            save_checkpoint(str(tmp_path / "bad"), out)
        save_checkpoint(str(tmp_path / "good"), gather_tree(out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save_async(tree, 3)
    mgr.wait()
    back, manifest = mgr.restore_latest(like=tree)
    assert manifest["step"] == 3 and torch.equal(back["w"], tree["w"])
