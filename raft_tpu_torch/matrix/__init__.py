"""Batched top-k selection (kernel K1)."""
