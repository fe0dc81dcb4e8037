"""The gemm kernel family."""
