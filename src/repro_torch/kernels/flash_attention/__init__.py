"""The flash_attention kernel family."""
