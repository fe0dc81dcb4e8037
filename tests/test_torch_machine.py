"""The port's machine model equals the JAX package's, float for float.

``device``, ``scheduler``, ``machine`` and ``power`` are plain Python in both
packages, so every modeled number must be identical (``==``, no tolerance):
for the 4T/8T/16T presets and the host, at every DVFS operating point, for
the work counts of every ported kernel family.
"""

import dataclasses

import pytest

from repro.core import device as jdev
from repro.core import machine as jm
from repro.core import ndrange as jnd
from repro.core import power as jp
from repro.core import scheduler as js
from repro.kernels.delineate.ref import counts as j_delineate_counts
from repro.kernels.fir.ref import counts as j_fir_counts
from repro.kernels.stockham_fft.ref import counts as j_fft_counts
from repro.kernels.svm.ref import counts as j_svm_counts
from repro_torch.core import device as tdev
from repro_torch.core import machine as tm
from repro_torch.core import ndrange as tnd
from repro_torch.core import power as tp
from repro_torch.core import scheduler as ts
from repro_torch.kernels.delineate.ref import counts as t_delineate_counts
from repro_torch.kernels.fir.ref import counts as t_fir_counts
from repro_torch.kernels.stockham_fft.ref import counts as t_fft_counts
from repro_torch.kernels.svm.ref import counts as t_svm_counts

PRESETS = ("EGPU_4T", "EGPU_8T", "EGPU_16T", "HOST")
POINTS = tuple(jdev.OPERATING_POINTS)

#: each family's counts() at TinyBio's sizes and at an odd size
FAMILIES = {
    "fir": (j_fir_counts, t_fir_counts,
            [dict(n=65_536, taps=128, itemsize=2), dict(n=1000, taps=17)]),
    "delineate": (j_delineate_counts, t_delineate_counts,
                  [dict(n=65_536), dict(n=999, itemsize=2)]),
    "stockham_fft": (j_fft_counts, t_fft_counts,
                     [dict(n=512), dict(n=64, itemsize=2)]),
    "svm": (j_svm_counts, t_svm_counts,
            [dict(q=128, m=256, d=36), dict(q=10, m=300, d=7, rbf=False)]),
    # TinyBio's stage 3 prices one FFT counts() scaled by the window count
    "tinybio.fft_features": (
        lambda **kw: j_fft_counts(**kw).scaled(128),
        lambda **kw: t_fft_counts(**kw).scaled(128),
        [dict(n=512)]),
}


def _configs(preset, point):
    j = getattr(jdev, preset).at(jdev.OPERATING_POINTS[point])
    t = getattr(tdev, preset).at(tdev.OPERATING_POINTS[point])
    return j, t


def _d(x):
    return dataclasses.asdict(x)


def test_config_fields_and_presets_match():
    assert [f.name for f in dataclasses.fields(jdev.EGPUConfig)] == \
        [f.name for f in dataclasses.fields(tdev.EGPUConfig)]
    for name in PRESETS:
        assert _d(getattr(jdev, name)) == _d(getattr(tdev, name))
    assert {k: _d(v) for k, v in jdev.OPERATING_POINTS.items()} == \
        {k: _d(v) for k, v in tdev.OPERATING_POINTS.items()}
    assert _d(jdev.OP_ANCHOR) == _d(tdev.OP_ANCHOR)
    assert jm.CAL == tm.CAL
    for raw in ("", "low", "turbo", "200e6:0.7"):
        j, t = jdev.env_op_point(raw), tdev.env_op_point(raw)
        assert (j is None and t is None) or _d(j) == _d(t)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("point", POINTS)
@pytest.mark.parametrize("preset", PRESETS)
def test_times_and_energies_equal_reference(preset, point, family):
    jcfg, tcfg = _configs(preset, point)
    j_counts_fn, t_counts_fn, sizes = FAMILIES[family]
    j_bds, t_bds = [], []
    for kw in sizes:
        jc, tc = j_counts_fn(**kw), t_counts_fn(**kw)
        assert _d(jc) == _d(tc)
        n_items = kw.get("n", kw.get("q", 1))
        ndrs = [((n_items,), (jcfg.threads_per_cu,)), ((1000,), (16,)),
                ((64, 48), (8, 8))]
        for g, l in ndrs:
            jt = jm.egpu_time(jcfg, jc, jnd.NDRange(g, l))
            tt = tm.egpu_time(tcfg, tc, tnd.NDRange(g, l))
            assert _d(jt) == _d(tt)
            assert jp.egpu_energy_j(jcfg, jt) == tp.egpu_energy_j(tcfg, tt)
        jo = js.optimal_ndrange(n_items, jcfg)
        to = ts.optimal_ndrange(n_items, tcfg)
        assert (jo.global_size, jo.local_size) == (to.global_size, to.local_size)
        jt = jm.egpu_time(jcfg, jc, jo)
        tt = tm.egpu_time(tcfg, tc, to)
        jh = jm.host_time(jc, jcfg)
        th = tm.host_time(tc, tcfg)
        assert _d(jt) == _d(tt) and _d(jh) == _d(th)
        assert jt.as_dict() == tt.as_dict()
        assert jp.host_energy_j(jh) == tp.host_energy_j(th)
        assert jp.energy_reduction(jh, jcfg, jt) == \
            tp.energy_reduction(th, tcfg, tt)
        assert jm.speedup(jh, jt) == tm.speedup(th, tt)
        j_bds.append(jt)
        t_bds.append(tt)
        j_bds.append(jm.transfer_time(jcfg, jc.host_bytes))
        t_bds.append(tm.transfer_time(tcfg, tc.host_bytes))
    # chain and DAG fusion over everything priced above
    assert _d(jm.fuse_breakdowns(j_bds)) == _d(tm.fuse_breakdowns(t_bds))
    deps = [()] + [(i - 1,) if i % 2 else (0,) for i in range(1, len(j_bds))]
    assert _d(jm.fuse_breakdowns(j_bds, deps=deps)) == \
        _d(tm.fuse_breakdowns(t_bds, deps=deps))
    # static power model
    assert _d(jp.characterize(jcfg)) == _d(tp.characterize(tcfg))
    assert jp.characterize(jcfg).as_dict() == tp.characterize(tcfg).as_dict()
    for fn in ("dynamic_scale", "leakage_scale", "egpu_active_power_mw",
               "egpu_idle_power_mw"):
        assert getattr(jp, fn)(jcfg) == getattr(tp, fn)(tcfg), fn
    assert jp.host_active_power_mw() == tp.host_active_power_mw()


@pytest.mark.parametrize("preset", PRESETS)
def test_schedule_matches_reference(preset):
    jcfg, tcfg = getattr(jdev, preset), getattr(tdev, preset)
    for g, l in (((7,), (4,)), ((512,), (8,)), ((65_536,), (16,)),
                 ((30, 40), (8, 8))):
        jsch = js.schedule(jnd.NDRange(g, l), jcfg)
        tsch = ts.schedule(tnd.NDRange(g, l), tcfg)
        assert (jsch.iterations, jsch.groups_per_cu, jsch.occupancy,
                jsch.startup_cycles, jsch.scheduling_cycles,
                jsch.overhead_s) == (
            tsch.iterations, tsch.groups_per_cu, tsch.occupancy,
            tsch.startup_cycles, tsch.scheduling_cycles, tsch.overhead_s)
