"""The delineate kernel family."""
