"""The rwkv6_scan kernel family."""
