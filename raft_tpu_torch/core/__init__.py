"""Core types of the PyTorch port: errors, the sample-filter bitset,
deadlines and cancellation between query chunks (``deadline``,
``interruptible``), the chunks' workspace budget (``resources``), the
index file format (``serialize``) and RAFT-native index files
(``raft_format``)."""
