"""Development tools, run on the card: ``kernel_ab`` (K5 / K6 source
variants timed in one process), ``scan_ab`` (K4's grouped form likewise,
at the IVF-PQ graph pass's batch) and ``nnd_sweep`` (NN-descent's edge
recall by exposure rule and round cap)."""
