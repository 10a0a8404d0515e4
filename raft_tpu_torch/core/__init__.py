"""Core types of the PyTorch port: errors and the sample-filter bitset."""
