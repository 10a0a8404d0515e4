"""Development tools, run on the card: ``kernel_ab`` (kernel source
variants timed in one process) and ``nnd_sweep`` (NN-descent's edge
recall by exposure rule and round cap)."""
