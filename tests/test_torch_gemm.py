"""The GeMM path of the port against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX ``gemm`` (its
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and
through the port's wrapper on CPU tensors, which runs the kernel's plain
PyTorch version.  int32 must match exactly, wraparound included; float32
within ``rtol=atol=2e-4``, the tolerance ``tests/test_kernels.py`` states
for the same shapes.  Work counts, the Hopper tiling of every preset, the
quickstart's GeMM offload (reports field for field, graph and eager, with
and without explicit transfers) and the Fig-3 bench's rows are held
against the JAX package too.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as jcore
from repro.kernels.gemm.ops import gemm as j_gemm
from repro.kernels.gemm.ref import counts as j_counts
from repro.kernels.gemm.ref import gemm_ref as j_gemm_ref
import repro_torch.core as tcore
from repro_torch.core.device import KernelKnobs, check_smem_budget
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.gemm.gemm import (BK, COMPILED_STAGES, COMPILED_TILES,
                                           ITEMSIZE, MIN_K_TILES_PER_SPLIT,
                                           GemmTiling, plan_split_k,
                                           tiles_from_knobs)
from repro_torch.kernels.gemm.ops import gemm
from repro_torch.kernels.gemm.ref import counts as t_counts
from repro_torch.kernels.gemm.ref import gemm_ref

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:              # the benchmark packages
    sys.path.insert(0, str(ROOT))

CONFIGS = ("EGPU_4T", "EGPU_8T", "EGPU_16T")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the plain version against the JAX op ----------------------------------
@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (100, 70, 50), (128, 128, 128),
                                   (257, 129, 65)])
def test_gemm_f32_matches_reference(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(j_gemm(jnp.asarray(a), jnp.asarray(b)))
    got = gemm(_t(a), _t(b)).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("lo,hi", [(-64, 64), (-2 ** 31, 2 ** 31),
                                   (2 ** 20 - 64, 2 ** 20 + 64)])
@pytest.mark.parametrize("m,k,n", [(64, 32, 48), (257, 129, 65)])
def test_gemm_int32_exact_with_wraparound(m, k, n, lo, hi):
    rng = np.random.default_rng(7)
    a = rng.integers(lo, hi, (m, k), dtype=np.int64).astype(np.int32)
    b = rng.integers(lo, hi, (k, n), dtype=np.int64).astype(np.int32)
    want = np.asarray(j_gemm(jnp.asarray(a), jnp.asarray(b)))
    got = gemm(_t(a), _t(b)).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gemm_ref(_t(a), _t(b)).numpy(),
                                  np.asarray(j_gemm_ref(jnp.asarray(a),
                                                        jnp.asarray(b))))
    if lo >= 2 ** 20 - 64:                 # these sums do wrap
        exact = a.astype(np.int64) @ b.astype(np.int64)
        assert (np.abs(exact) >= 2 ** 31).any()


def test_int8_dtype_rules_match_reference():
    """``gemm`` widens int8 to an int32 result; ``gemm_ref`` keeps the JAX
    oracle's rule and narrows back to the input dtype."""
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, (40, 33)).astype(np.int8)
    b = rng.integers(-128, 128, (33, 21)).astype(np.int8)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for port, ref in ((gemm, j_gemm), (gemm_ref, j_gemm_ref)):
        want = np.asarray(ref(ja, jb))
        got = port(_t(a), _t(b)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert gemm(_t(a), _t(b)).dtype == torch.int32
    assert gemm_ref(_t(a), _t(b)).dtype == torch.int8


def test_gemm_checks_and_meta_shapes():
    a = torch.zeros(4, 3, dtype=torch.int16, device="meta")
    b = torch.zeros(3, 5, dtype=torch.int16, device="meta")
    before = dict(LAUNCHES)
    out = gemm(a, b)
    assert out.device.type == "meta" and out.shape == (4, 5)
    assert out.dtype == torch.int32
    assert gemm(a.float(), b.float()).dtype == torch.float32
    assert gemm(torch.ones(2, 3), torch.ones(3, 4)).sum() == 24
    assert LAUNCHES == before              # plain versions never count
    with pytest.raises(ValueError, match="gemm takes"):
        gemm(torch.ones(2, 3), torch.ones(4, 2))
    with pytest.raises(TypeError, match="share a dtype"):
        gemm(torch.ones(2, 3), torch.ones(3, 2, dtype=torch.float16))
    with pytest.raises(TypeError, match="must be one of"):
        gemm(torch.ones(2, 3, dtype=torch.int64),
             torch.ones(3, 2, dtype=torch.int64))


# -- machine model and tiling ---------------------------------------------
@pytest.mark.parametrize("s", [32, 64, 128, 256])
def test_counts_equal_reference(s):
    for m, n, k, itemsize in ((s, s, s, 4), (s, s // 2, s + 3, 1)):
        assert dataclasses.asdict(t_counts(m, n, k, itemsize)) == \
            dataclasses.asdict(j_counts(m, n, k, itemsize))


@pytest.mark.parametrize("preset", CONFIGS + ("HOST",))
def test_preset_tilings_fit_the_budget(preset):
    cfg = getattr(tcore, preset)
    knobs = cfg.cuda_knobs()
    tiling = tiles_from_knobs(knobs)
    assert (tiling.bm, tiling.bn) in COMPILED_TILES
    assert tiling.stages in COMPILED_STAGES and tiling.bk == BK
    assert tiling.bm <= knobs.tile_m and tiling.bn <= knobs.tile_n
    check_smem_budget(knobs, tiling.bm * BK * ITEMSIZE, BK * tiling.bn * ITEMSIZE)
    # powers of two, and the TPU projection's ratios between presets
    for v in (knobs.tile_m, knobs.tile_n):
        assert v & (v - 1) == 0
    jk = getattr(jcore, preset).tpu_knobs()
    assert knobs.tile_n * 128 == jk.lane_tile * 32
    assert knobs.tile_m * 8 == jk.sublane_tile * 16
    assert knobs.pipeline_depth == jk.pipeline_depth


def test_presets_map_onto_the_three_compiled_tiles():
    tiles = [tiles_from_knobs(getattr(tcore, p).cuda_knobs())[:2]
             for p in CONFIGS]
    assert tiles == list(COMPILED_TILES)
    # the knob projection is a method only: fields, equality, hash unchanged
    assert tcore.EGPU_16T == dataclasses.replace(tcore.EGPU_16T)
    assert hash(tcore.EGPU_16T) == hash(dataclasses.replace(tcore.EGPU_16T))


def test_oversized_tiling_raises():
    knobs = tcore.EGPU_16T.cuda_knobs()
    with pytest.raises(ValueError, match="exceeds budget"):
        check_smem_budget(knobs, 64 * 1024, 64 * 1024)
    small = KernelKnobs(tile_m=64, tile_n=128, pipeline_depth=4,
                        smem_budget_bytes=24 * 1024)
    assert tiles_from_knobs(small)[:2] == (32, 64)    # shrinks to fit
    with pytest.raises(ValueError, match="no compiled GeMM tiling"):
        tiles_from_knobs(dataclasses.replace(small, smem_budget_bytes=1024))


# -- the kernel's split-K plan -----------------------------------------------
@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("bm,bn", COMPILED_TILES)
@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (257, 129, 65),
                                   (96, 200, 80), (2048, 2048, 2048),
                                   (8, 8, 8), (64, 4096, 64), (5, 0, 7)])
def test_split_k_plan_covers_k_with_whole_tiles(m, k, n, bm, bn, sm_count):
    tiling = GemmTiling(bm, bn, BK, 4)
    k_tiles = -(-k // BK)
    splits, per = plan_split_k(m, n, k, tiling, sm_count, torch.int32)
    assert splits >= 1 and per >= 1
    if k_tiles:
        assert (splits - 1) * per < k_tiles <= splits * per   # none empty
    if splits > 1:
        assert per >= MIN_K_TILES_PER_SPLIT
        blocks = -(-m // bm) * -(-n // bn)
        assert 2 * blocks <= sm_count and splits * blocks <= sm_count
    # float32 never splits: one in-order chain per output
    assert plan_split_k(m, n, k, tiling, sm_count, torch.float32) == \
        (1, max(1, k_tiles))
    assert plan_split_k(m, n, k, tiling, sm_count, torch.int32) == (splits, per)


def test_split_k_engages_where_the_tiling_leaves_the_card_idle():
    tiles = {knobs: GemmTiling(*t, BK, 4) for knobs, t in
             zip(CONFIGS, COMPILED_TILES)}
    plans = {c: plan_split_k(256, 256, 256, t, 132, torch.int32)
             for c, t in tiles.items()}
    assert plans["EGPU_4T"] == (1, 16)        # 128 blocks fill the card
    assert plans["EGPU_8T"] == (4, 4)         # 32 blocks
    assert plans["EGPU_16T"] == (8, 2)        # 8 blocks
    assert plan_split_k(2048, 2048, 2048, tiles["EGPU_16T"], 132,
                        torch.int32) == (1, 128)


# -- the quickstart's GeMM offload ----------------------------------------
def _report_dict(rep):
    return dataclasses.asdict(rep)


@pytest.mark.parametrize("preset", CONFIGS)
def test_quickstart_gemm_offload_matches_reference(preset):
    rng = np.random.default_rng(0)
    a = rng.integers(-64, 64, (256, 256)).astype(np.int32)
    b = rng.integers(-64, 64, (256, 256)).astype(np.int32)
    cp = {"m": 256, "n": 256, "k": 256}
    jcfg, tcfg = getattr(jcore, preset), getattr(tcore, preset)
    jstage = jcore.Stage(jcore.Program.build(jcfg).create_kernel("gemm"),
                         counts_params=cp)
    tstage = tcore.Stage(tcore.Program.build(tcfg).create_kernel("gemm"),
                         counts_params=cp)
    for mode, explicit in (("graph", False), ("graph", True),
                           ("eager", False)):
        (jout,), jrep = jcore.APU(jcfg, explicit_transfers=explicit).offload(
            [jstage], (jnp.asarray(a), jnp.asarray(b)), mode=mode)
        apu = tcore.APU(tcfg, device="cpu", explicit_transfers=explicit)
        (tout,), trep = apu.offload([tstage], (a, b), mode=mode)
        np.testing.assert_array_equal(tout.data.numpy(), a @ b)
        np.testing.assert_array_equal(tout.data.numpy(), np.asarray(jout.data))
        assert _report_dict(trep) == _report_dict(jrep), (mode, explicit)
    graph = tcore.APU(tcfg, device="cpu").capture_pipeline(
        [tstage], (a, b), explicit_transfers=True)
    assert [n.kind for n in graph.nodes] == ["write", "write", "kernel", "read"]
    assert graph.nodes[2].modeled.transfer == 0.0      # kernel is resident


def test_bench_gemm_overhead_rows_equal_reference():
    from benchmarks import bench_gemm_overhead as jbench
    from benchmarks_torch import bench_gemm_overhead as tbench
    assert tbench.run("cpu") == jbench.run()
