"""Nearest-neighbor indexes: brute_force and ivf_flat."""
