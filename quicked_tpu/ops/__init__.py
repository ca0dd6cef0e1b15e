"""Compute ops: exact semantic model (myers_np), plain XLA kernels and the
Pallas-Triton GPU kernel."""
