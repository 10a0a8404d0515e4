"""Core types of the PyTorch port: errors, the sample-filter bitset,
deadlines and cancellation between query chunks (``deadline``,
``interruptible``), the chunks' workspace budget (``resources``), the
index file format (``serialize``), RAFT-native index files
(``raft_format``), the fault probes and the write-ahead log (``faults``,
``wal``), and the telemetry core: the flight recorder (``events``),
trace ranges, IDs and spans (``tracing``) and the logger
(``logging``)."""
