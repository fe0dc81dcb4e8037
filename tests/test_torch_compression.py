"""The port's int8 gradient codec and compressed all-reduce
(``repro_torch.distributed.compression``) held against the JAX package's.

* ``compress_int8`` / ``decompress_int8``: ``q``, ``scale`` and the new
  error equal JAX's bit for bit over several steps of error feedback (the
  same numpy inputs; ties at .5 round half to even in both).
* ``compressed_psum`` over 2 and 4 gloo ranks (one start of 4: a 4-rank
  "data" axis, and two 2-rank ones on a (pod, data) mesh): each rank's
  mean equals JAX's ``compressed_psum`` under ``jax.vmap(...,
  axis_name="data")`` over its group's stacked gradients (the exact JAX
  function for N participants on one CPU device) within 1e-6 of max |g|,
  and its new error bit for bit; the gathered payload is int8 (the
  collective is wrapped and its dtype read).
* ``make_host_mesh`` (a world-1 gloo group in this process, destroyed at
  the end) reduces exactly, as the JAX package's 1-device test.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jc
from repro_torch.distributed import compression as tc

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ranks  # noqa: E402
from torch_ranks import one_thread  # noqa: E402,F401


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8))


CASES = {
    "normal": lambda rng: rng.standard_normal((64, 33)).astype(np.float32),
    "scaled": lambda rng: (rng.standard_normal(1000) * 1e-3).astype(np.float32),
    "zeros": lambda rng: np.zeros((4, 5), np.float32),
    "ties": lambda rng: (np.arange(-254, 255, dtype=np.float32) / 2.0),
    "bf16": lambda rng: rng.standard_normal((16, 16)).astype(np.float32),
}


@pytest.mark.parametrize("case", list(CASES))
def test_codec_bit_equal_to_jax_with_error_feedback(case):
    rng = np.random.default_rng(7)
    err_j, err_t = None, None
    for _ in range(4):
        g = CASES[case](rng)
        gj, gt = jnp.asarray(g), torch.from_numpy(g.copy())
        if case == "bf16":
            gj, gt = gj.astype(jnp.bfloat16), gt.to(torch.bfloat16)
        qj, sj, ej = jc.compress_int8(gj, err_j)
        qt, st, et = tc.compress_int8(gt, err_t)
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        _bits_equal(qt.numpy(), qj)
        _bits_equal(st.numpy(), sj)
        _bits_equal(et.numpy(), ej)
        _bits_equal(tc.decompress_int8(qt, st).numpy(),
                    jc.decompress_int8(qj, sj))
        err_j, err_t = ej, et
        # new error always fed back
        rng = np.random.default_rng(int(rng.integers(1 << 30)))
    assert tc.INT8_MAX == jc.INT8_MAX
    zero = tc.init_error_state({"a": torch.ones(3, 2, dtype=torch.bfloat16)})
    assert zero["a"].dtype == torch.float32 and not zero["a"].any()


def _stacked(world, seed):
    rng = np.random.default_rng(seed)
    grads = {"w": rng.standard_normal((world, 24, 16)).astype(np.float32),
             "b": (rng.standard_normal((world, 40)) * 3).astype(np.float32)}
    errs = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
            for k, v in grads.items()}
    return grads, errs


def _jax_psum(grads, errs, steps):
    # eager, as the JAX package's own tests run it (jit fuses the codec
    # into other bits)
    fn = jax.vmap(lambda g, e: jc.compressed_psum(g, e, "data"),
                  axis_name="data")
    g = {k: jnp.asarray(v) for k, v in grads.items()}
    e = {k: jnp.asarray(v) for k, v in errs.items()}
    means = []
    for _ in range(steps):
        m, e = fn(g, e)
        means.append({k: np.asarray(v) for k, v in m.items()})
    return means, {k: np.asarray(v) for k, v in e.items()}


#: N participants -> the 4 ranks' mesh whose last axis ("data") has N
MESHES = {2: ((2, 2), ("pod", "data")), 4: ((4,), ("data",))}
STEPS = 2


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One start of 4 gloo ranks reducing over a 4-rank "data" axis and,
    on a (pod, data) = (2, 2) mesh, over two 2-rank ones; JAX's
    references (each group of N ranks: ``compressed_psum`` vmapped over
    the same N stacked gradients) are computed while the ranks run."""
    cases = [MESHES[n] + _stacked(4, seed=n) for n in sorted(MESHES)]
    collect = torch_ranks.start_groups(tmp_path_factory.mktemp("psum"),
                                       [(4, "psum", (cases, STEPS))])
    try:
        jax_of = {}                 # (N, the group's first rank) -> JAX's
        for n in sorted(MESHES):
            grads, errs = _stacked(4, seed=n)
            for first in range(0, 4, n):
                group = slice(first, first + n)
                jax_of[n, first] = _jax_psum(
                    {k: v[group] for k, v in grads.items()},
                    {k: v[group] for k, v in errs.items()}, STEPS)
    finally:
        (res,) = collect()
    return {n: ([r[i] for r in res], jax_of)
            for i, n in enumerate(sorted(MESHES))}


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_on_gloo_ranks_matches_jax(world, four_ranks):
    """N = ``world`` participants: each group of N ranks (the 4 ranks'
    "data" axis) against JAX's ``compressed_psum`` vmapped over the same
    N stacked gradients."""
    grads, errs = _stacked(4, seed=world)
    per_rank, jax_of = four_ranks[world]
    for rank, res in enumerate(per_rank):
        first = rank - rank % world              # the group's first rank
        group = slice(first, first + world)
        j_means, j_errs = jax_of[world, first]
        for step in range(STEPS):
            for k, g in grads.items():
                tol = 1e-6 * float(np.max(np.abs(g[group])))
                np.testing.assert_allclose(res["means"][step][k],
                                           j_means[step][k][rank - first],
                                           rtol=0, atol=tol)
        for k in grads:
            _bits_equal(res["errs"][k], j_errs[k][rank - first])
        # the wire: every leaf's payload int8, its scale one f32, per step
        assert res["dtypes"] == [
            (dt, shape) for _ in range(STEPS) for k in sorted(grads)
            for dt, shape in (("torch.int8", (grads[k][0].size,)),
                              ("torch.float32", (1,)))]
        # every rank of a group holds the same mean
        for a, b in zip(res["means"], per_rank[first]["means"]):
            for k in a:
                _bits_equal(a[k], b[k])


def test_host_mesh_single_participant_exact():
    """N = 1 on ``make_host_mesh``: the mean is the dequantized local grad
    (within 1 LSB), as the JAX package's 1-device test; the group is this
    process's own and is destroyed before the test ends."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_production_mesh()
    assert not dist.is_initialized()
    try:
        mesh = make_host_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.mesh.shape) == (1, 1)
        assert make_host_mesh(device_type="cpu").mesh_dim_names == (
            "data", "model")
        g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
            (8, 128)).astype(np.float32))}
        e = {"w": torch.zeros(8, 128)}
        out, err = tc.compressed_psum(g, e, "data", mesh)
        np.testing.assert_allclose((out["w"] + err["w"]).numpy(),
                                   g["w"].numpy(), rtol=1e-5, atol=1e-5)
        q, s, _ = tc.compress_int8(g["w"], e["w"])
        _bits_equal(out["w"].numpy(), tc.decompress_int8(q, s).numpy())
        from repro_torch.distributed.sharding import TRAIN_RULES, activate
        with activate(TRAIN_RULES, mesh):
            out2, _ = tc.compressed_psum(g, e, "model")
        _bits_equal(out2["w"].numpy(), out["w"].numpy())
        with pytest.raises(ValueError, match="DeviceMesh"):
            tc.compressed_psum(g, e, "data")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not dist.is_initialized()
