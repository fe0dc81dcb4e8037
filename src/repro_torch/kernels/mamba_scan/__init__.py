"""The mamba_scan kernel family."""
