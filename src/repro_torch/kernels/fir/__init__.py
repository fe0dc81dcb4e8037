"""The fir kernel family."""
