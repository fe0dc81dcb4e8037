"""Fig 2 — static characterization: area & leakage breakdown per config.

The port of ``benchmarks/bench_static.py``: the analytic area, leakage and
active-power models of ``repro_torch.core.power``, one row per config.  No
device runs anything, so ``run()`` takes no device; its rows equal the JAX
bench's float for float.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_static
"""

from repro_torch.core import EGPU_4T, EGPU_8T, EGPU_16T, HOST, characterize
from repro_torch.core.power import egpu_active_power_mw, host_active_power_mw

PAPER = {
    "x-heep-host": dict(area=0.15, leak=29.50),
    "e-gpu-4t": dict(area=0.24, leak=130.13),
    "e-gpu-16t": dict(area=0.38, leak=305.32),
}


def run():
    print("=" * 76)
    print("Fig 2 — area / leakage breakdown (TSMC16 @ 300 MHz / 0.8 V)")
    print("=" * 76)
    header = (f"{'system':14s} {'area mm2':>9s} {'(x host)':>9s} "
              f"{'leak uW':>9s} {'(x host)':>9s} {'P mW':>7s} "
              f"{'paper area/leak':>17s}")
    print(header)
    rows = []
    for cfg in (HOST, EGPU_4T, EGPU_8T, EGPU_16T):
        ch = characterize(cfg)
        power = (host_active_power_mw() if cfg.name == HOST.name
                 else egpu_active_power_mw(cfg))
        p = PAPER.get(cfg.name)
        ref = f"{p['area']:.2f}/{p['leak']:.1f}" if p else "—"
        print(f"{cfg.name:14s} {ch.total_area_mm2:9.3f} "
              f"{ch.area_overhead:8.2f}x {ch.total_leak_uw:9.2f} "
              f"{ch.leak_overhead:8.1f}x {power:7.1f} {ref:>17s}")
        rows.append({"name": cfg.name, "area_mm2": ch.total_area_mm2,
                     "leak_uw": ch.total_leak_uw, "power_mw": power,
                     "area_overhead": ch.area_overhead,
                     "leak_overhead": ch.leak_overhead})
    print("breakdown (16T): ", end="")
    ch = characterize(EGPU_16T)
    print(f"host {ch.host_area_mm2:.3f} | I$ {ch.icache_area_mm2:.3f} | "
          f"D$ {ch.dcache_area_mm2:.3f} | CUs {ch.cu_area_mm2:.3f} mm2")
    return rows


if __name__ == "__main__":
    run()
