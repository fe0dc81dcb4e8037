"""The norm kernel family (no TPU counterpart: the JAX package leaves its
norms to XLA)."""
