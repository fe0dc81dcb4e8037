"""Serving entry points of the port: prefill, greedy decode."""
