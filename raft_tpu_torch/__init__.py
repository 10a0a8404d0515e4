"""raft_tpu_torch — the PyTorch/CUDA port of raft_tpu for NVIDIA Hopper.

A second package beside ``raft_tpu`` (the JAX reference, which it never
imports). Module names mirror the JAX package so each file's counterpart
is found by its path. It holds brute-force, IVF-Flat, IVF-PQ and CAGRA
build and search (squared L2, L2, cosine and inner product; CAGRA L2 and
inner product), ``refine``, sharded brute-force / IVF-Flat / IVF-PQ
search over a mesh of shards, and the primitives they call:

- ``core``      errors, the sample-filter bitset, deadlines and
                cancellation between query chunks, the chunks'
                workspace budget, the index file format (``serialize``,
                the families' ``save`` / ``load``) and RAFT-native
                index files (``raft_format``)
- ``distance``  metric types, fused L2 + argmin
- ``matrix``    select_k (kernel K1)
- ``ops``       the hand-written CUDA kernels' wrappers: fused_knn (K2),
                ivf_scan (K3), ivf_pq_scan (K4), graph_expand (K5),
                cagra_fused (K6), ring_topk (the cross-shard merge: K7
                and K8); the row codecs (``quant``); NN-descent's
                batched builder (plain PyTorch around K1); the verdict
                file and timer of measured engine races
                (``autotune``); and the kernels' build/load helper
                ``_cuda``
- ``comms``     the mesh of shards and the collectives between them
- ``cluster``   k-means and balanced hierarchical k-means
- ``neighbors`` brute_force, ivf_flat, ivf_pq, refine, cagra (with its
                exact, NN-descent and IVF-PQ graph builders and the
                measured engine race ``tune_search``), nn_descent, the
                inverted-list layout
- ``parallel``  sharded_knn, sharded_ann (IVF-Flat, IVF-PQ)
- ``random``    RngState (a ``torch.Generator`` on a device), the
                distributions, make_blobs / make_regression / rmat
- ``bench``     the ANN benchmark harness (``python -m
                raft_tpu_torch.bench``): datasets, ground truth, the
                QPS-at-recall sweeps in Google-Benchmark JSON, CAGRA's
                kNN-graph builder race
- ``serve``     the serving runtime: the micro-batcher over the
                families' ``make_searcher`` closures, admission,
                warmup, SLOs and brownout, the recall sentinel, the
                multi-tenant fabric and its query cache, debugz
- ``stats``     neighborhood recall
- ``convert``   indexes carried over from the JAX package as numpy arrays

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no ``device`` and no card they raise. A CUDA
tensor always goes to its kernel (a failure raises); the plain PyTorch
version of a kernel runs only for CPU tensors or when a caller asks for
the plain engine by name. Kernel sources live in ``csrc/`` and are built
by ``nvcc`` at first use into ``build/kernels/``.
"""

__version__ = "0.1.0"
