"""The decode_attention kernel family."""
