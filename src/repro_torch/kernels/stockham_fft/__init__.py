"""The stockham_fft kernel family."""
