"""Core types of the PyTorch port: errors, the sample-filter bitset,
deadlines and cancellation between query chunks (``deadline``,
``interruptible``) and the chunks' workspace budget (``resources``)."""
