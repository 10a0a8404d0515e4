"""Wrappers of the hand-written CUDA kernels and their plain versions."""
