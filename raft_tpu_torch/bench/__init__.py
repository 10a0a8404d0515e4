"""ANN benchmark harness: counterpart of ``raft_tpu/bench/``
(``python/raft-ann-bench`` + ``cpp/bench/ann`` in the reference).

One in-process harness: datasets (synthetic generators made on the
device, big-ann fbin/ibin and ann-benchmarks HDF5 readers), exact ground
truth by the port's brute force, the parameter-sweep runner writing the
reference's Google-Benchmark JSON counters, CAGRA's kNN-graph builder
race (``race_graph_build``), CSV export with the Pareto points marked,
and QPS-vs-recall plots.

CLI: ``python -m raft_tpu_torch.bench run --dataset blobs-100000x128``
(on the card; ``--device cpu`` for the CPU).
"""
from .datasets import (generate_groundtruth, load_dataset, read_fbin,
                       read_ibin, write_fbin, write_ibin)
from .runner import (BenchResult, byte_grid, default_configs,
                     graph_race_winner, race_graph_build, run_benchmarks)

__all__ = [
    "read_fbin", "write_fbin", "read_ibin", "write_ibin", "load_dataset",
    "generate_groundtruth", "run_benchmarks", "default_configs",
    "byte_grid", "BenchResult", "race_graph_build", "graph_race_winner",
]
