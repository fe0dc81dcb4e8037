"""repro_torch.apps — end-to-end applications built on the TinyCL runtime."""

from .tinybio import TINYBIO_WORKLOAD, run_tinybio, synth_signal, tinybio_stages

__all__ = ["TINYBIO_WORKLOAD", "run_tinybio", "synth_signal", "tinybio_stages"]
