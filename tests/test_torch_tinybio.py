"""TinyBio through the port against the JAX package, on the CPU.

The modeled ``PipelineReport`` must equal the reference's field for field
(``==`` on every float, ``egpu_fused`` included).  Functional outputs are
held stage by stage: each port stage is fed the reference's previous-stage
output, so flags must match exactly and the fp32 outputs within stated
tolerances.  The final decisions alone prove little — every one of them
equals the bias b = 0.1 to within 1e-7, because the RBF kernel underflows
for standard-normal support vectors against features in [-1, 1].
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as jcore
import repro_torch.core as tcore
from repro.apps import tinybio as jt
from repro_torch.apps import tinybio as tt

CONFIGS = ("EGPU_4T", "EGPU_8T", "EGPU_16T")


@pytest.fixture(scope="module")
def reference_16t():
    return jt.run_tinybio(jcore.EGPU_16T)


@pytest.mark.parametrize("config", CONFIGS)
def test_pipeline_report_equals_reference(config, reference_16t):
    jd, jr = (reference_16t if config == "EGPU_16T"
              else jt.run_tinybio(getattr(jcore, config)))
    td, tr = tt.run_tinybio(getattr(tcore, config), device="cpu")
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert tr.egpu_fused is not None
    assert (tr.overall_speedup, tr.fused_speedup,
            tr.overall_energy_reduction) == (
        jr.overall_speedup, jr.fused_speedup, jr.overall_energy_reduction)
    assert td.shape == (128,) and td.dtype == torch.float32
    # decisions ~ b: agree to fp32 rounding of 0.1
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def test_eager_report_equals_reference():
    _, jr = jt.run_tinybio(jcore.EGPU_8T, mode="eager")
    _, tr = tt.run_tinybio(tcore.EGPU_8T, mode="eager", device="cpu")
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert tr.egpu_fused is None


def test_inputs_and_constants_are_bit_identical():
    js, ji = jt.tinybio_stages(jcore.EGPU_16T, seed=3)
    ts, ti = tt.tinybio_stages(tcore.EGPU_16T, seed=3, device="cpu")
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji[0]))
    for sj, st in zip(js, ts):
        assert st.kernel.name == sj.kernel.name
        assert st.params == sj.params and st.counts_params == sj.counts_params
        for cj, ct in zip(sj.consts, st.consts):
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
            assert ct.shape == tuple(np.shape(cj))


def test_each_stage_matches_reference_on_reference_inputs():
    js, ji = jt.tinybio_stages(jcore.EGPU_16T, seed=0)
    ts, _ = tt.tinybio_stages(tcore.EGPU_16T, seed=0, device="cpu")
    cur = tuple(ji)
    outs = []
    for sj, st in zip(js, ts):
        want = sj.kernel.executor(*cur, *[jnp.asarray(c) for c in sj.consts],
                                  **sj.params)
        want = want if isinstance(want, tuple) else (want,)
        got = st.kernel.executor(
            *[torch.from_numpy(np.array(a)) for a in cur], *st.consts,
            **st.params)
        got = got if isinstance(got, tuple) else (got,)
        outs.append([(np.asarray(w), g.numpy()) for w, g in zip(want, got)])
        cur = want
    (fir_j, fir_t), = outs[0]
    # 128 fp32 products summed in the same order; XLA may fuse a
    # multiply-add, so a few ulps of |y| <= 1.5
    np.testing.assert_allclose(fir_t, fir_j, rtol=0, atol=1e-6)
    (sig_j, sig_t), (flags_j, flags_t) = outs[1]
    np.testing.assert_array_equal(sig_t, sig_j)            # pass-through
    np.testing.assert_array_equal(flags_t, flags_j)        # exact
    assert np.count_nonzero(flags_j) > 500
    (feat_j, feat_t), = outs[2]
    # features are normalized to [-1, 1]; their spectral bands inherit the
    # FFT's fp32 error (twiddles from two cos/sin libraries)
    assert feat_t.shape == (128, 36)
    np.testing.assert_allclose(feat_t, feat_j, rtol=1e-4, atol=5e-5)
    (dec_j, dec_t), = outs[3]
    np.testing.assert_allclose(dec_t, dec_j, rtol=0, atol=1e-6)


def test_fft_stage_matches_reference_on_tinybio_windows():
    from repro.kernels.stockham_fft.ops import power_spectrum as j_ps
    from repro_torch.kernels.stockham_fft.ops import power_spectrum as t_ps
    import jax
    w = tt.synth_signal(65_536, 0).reshape(128, 512)
    want = np.asarray(jax.vmap(j_ps)(jnp.asarray(w)))
    got = t_ps(torch.from_numpy(w)).numpy()
    # |X|^2 peaks near 4e4 here; absolute error is relative to the peak
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * want.max())


def test_end_to_end_flags_within_bound():
    # Independent FIRs differ in the last ulps, and a sample whose
    # neighbours are that close can flip.  A conv1d FIR flipped 4 of 1,026
    # flags; the port adds the taps in the reference kernel's order, so
    # allow at most 8 flips.
    js, ji = jt.tinybio_stages(jcore.EGPU_16T, seed=0)
    ts, ti = tt.tinybio_stages(tcore.EGPU_16T, seed=0, device="cpu")
    y_j = js[0].kernel.executor(ji[0], jnp.asarray(js[0].consts[0]))
    f_j = np.asarray(js[1].kernel.executor(y_j)[1])
    y_t = ts[0].kernel.executor(ti[0], ts[0].consts[0])
    f_t = ts[1].kernel.executor(y_t)[1].numpy()
    assert np.count_nonzero(f_j) > 1000
    assert int((f_j != f_t).sum()) <= 8
