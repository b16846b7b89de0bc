"""Measurement tools for the port's kernels (run on a GPU)."""
