#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``raft_tpu_torch``) on one NVIDIA card.

Usage, from the root of a checkout, on a machine with a card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA::

    python3 chip_smoke.py

It builds the eight CUDA kernels from ``raft_tpu_torch/csrc`` (one
``nvcc`` per source, all at once, into ``build/kernels/``; K2 and K3 are
one library a store: f32, bf16, int8, uint8 and, for K2, int4; K5 one a
store mode: dense, int4, pq; K6 dense and int4), then:

1. path: the paths through the public entry points at SIFT-1M's shape —
   1,000,000 x 128 float32 rows and 10,000 queries in 1,000 overlapping
   Gaussian clusters (unit-normal centers, per-cluster spread 1.0-1.6:
   the clusters overlap, so true neighbors cross list boundaries and
   recall stays below 1), made from a seed with numpy (SIFT-1M itself is
   not in the repository):
   - brute force: build and search (k = 10);
   - IVF-Flat: build (n_lists = 1024) and search (n_probes = 20);
   - IVF-PQ: build (n_lists = 1024, pq_dim = 64, pq_bits = 8,
     per-subspace codebooks), search (n_probes = 20, bf16 LUT, k0 = 20
     candidates) and refine against the float32 rows to k = 10;
   - CAGRA: build with the reference's defaults (exact kNN graph of
     intermediate degree 128 through K2 + K1, optimize to graph degree
     64, covering seed set), the int8 edge store, and search (itopk 64,
     width 1, 80 hops) with the edge engine (K5 per hop) and the fused
     engine (K6); the plain gather engine is timed as a reference line.
   - sharded search over 4 shards on the one card (the cross-card links
     a multi-card deployment would use are replaced by the card's own
     memory): brute force (250,000 rows a shard), IVF-Flat and IVF-PQ
     with the single-card path's per-shard parameters, each searched
     with the allgather (K1), ring (K7 a hop) and ring_pallas (K8)
     merges, which must return the same ids and distances on every
     shard; the ring must launch K7 p·(p−1) times a merge and
     ring_pallas K8 once.
   Each path runs with every launch counter set to 0 just before it, and
   fails if a kernel of the path did not launch. Checks: IVF-Flat
   recall@10 against the brute-force answer >= 0.90, IVF-PQ refined
   recall@10 >= 0.85, CAGRA recall@10 >= 0.90 with the edge and fused
   engines equal in ids and distances, sharded IVF-Flat and IVF-PQ
   (raw) recall@10 >= 0.93 and >= 0.80, the sharded brute-force answer
   against the single card's (recall >= 0.99; the share of equal rows is
   printed), the brute-force answer and the refined distances against
   numpy on a few queries;
   Each path prints its launches per kernel and, for K1, K3 and K4, per
   form (K1: the warp select for k <= 512, the radix select above; K3 and K4:
   the grouped form for k <= 512, the per-pair form above); the IVF paths
   must launch K3 or K4 once a search (a shard), in the grouped form.
2. determinism: the path's IVF-Flat and IVF-PQ indexes, built once more
   from the same rows in the same process, must be bit-equal to the
   path's (centers, lists, rotation, codebooks, codes).
   Then the IVF and brute-force remainders, each path with the counters
   reset before it: IVF-Flat and IVF-PQ streamed by
   ``build_from_batches`` in 8 batches of 131,072 rows (a multiple of
   the builds' GEMM row chunks, so every assignment and encode product
   takes the one-shot build's row blocks) with the whole corpus as
   ``trainset``: quantizers, list sizes and each list's rows (in order)
   bit-equal to the path's one-shot indexes, and each search bit-equal
   through K3 and K4 (one grouped launch); IVF-PQ with per-cluster
   codebooks at the path's parameters, built and searched (K4's
   per-cluster form, two launches), its recall@10 raw and refined beside
   the per-subspace index's, then K4's per-cluster form against its
   plain version (the path's bf16 LUT on all queries, launched twice
   bit-equal; integer codebooks, centers and queries at both LUTs and
   metrics, equal), timed with its bound (the row
   ``ivf_pq_scan.per_cluster``); brute force's scan engine (``auto`` for
   these metrics) at L1, Linf, Lp (p = 3), Canberra and correlation on
   1,000 queries, K1 launched twice a tile and K2 never, every returned
   value against float64 numpy at its row and two queries' k best
   against float64 over all rows (rtol 1e-5; Canberra 1e-4 and
   correlation atol 1e-5, ``SCAN_TOL`` says why); the phase's seconds
   and peak device memory.
   Then the filters phase: the adaptive filter policy
   (``ops/filter_policy``) on the path's four indexes with four filters
   made from the seed — Bernoulli keep 0.5, 0.05 and 0.009 (CAGRA's
   widest level, 8, with more than 8,192 survivors) and a tenant slice
   (whole IVF-Flat lists from list 0 on, at most 8,192 rows: the
   crossover on every family). For each filter and family: the
   decision (selectivity, level, n_probes or itopk, lists pruned, the
   crossover), recall@10 with the policy and under ``suspended()``
   against the exact filtered answer (K2 with the penalty row under
   ``suspended()``), the search's ms and its launches by kernel and form,
   counters reset before it. Checks: the policy's recall at least
   ``suspended()``'s minus 0.01; the crossovers of brute force, IVF-Flat
   and CAGRA equal to the exact answer (ids on >= 0.999 of rows, values
   to rtol 1e-5; bit-equality printed); IVF-PQ's crossover recall@10 at
   least the path's unfiltered raw recall; a widened IVF search one
   grouped K3 or K4 launch; CAGRA at level 8 (itopk 512, past K6's 256)
   K5 and no K6. Then ``filter_policy.tune_crossover`` for CAGRA at the
   keep-0.009 filter and the search that follows its verdict (a "brute"
   verdict must cross over: K2, the exact answer's ids), then
   ``brute_force.tune_search`` at the path's shape
   (K2 against the scan engine), ``bench.roofline.probe(quick=True)``
   (each peak at most the data sheet's) and the select_k sweep (K1
   against ``torch.topk`` at the JAX sweep's eight shapes, its document
   in ``build/``), each printed with the card's name and power limit.
3. graph routes, on the path's data, each with the counters reset before
   it and read after: CAGRA's NN-descent graph at the path's parameters
   (degree 128 → 64: ``build``'s stages one by one, so that the kNN
   graph can be read; the descent at ``IndexParams``' default round
   cap, as users and the bench build), its build seconds by stage
   beside the exact graph's, its edge recall against the exact
   neighbors of 10,000 sampled rows (>= 0.80), and the fused search's
   recall at itopk 64 beside the exact graph's index; the IVF-PQ graph
   route the same way on all 1,000,000 rows (K4 at k = 257 in its grouped
   form, once a batch: 31 grouped launches and no per-pair one), its
   build seconds by stage, the pass's own stages (the IVF-PQ build, K4,
   K1's merge, refine) timed call by call on the card, K1's 31 merges at
   k = 257 all in the warp form (no radix launch on the route), the
   pass run again with its merges forced to the radix form and its
   graph bit-equal to the route's, edge
   recall (>= 0.80), the fused search's recall beside the exact graph's and
   NN-descent's, and the route's own peak device memory; ``tune_search``
   on the path's index (which engine wins, and why not the fused one
   if it does not).
4. bench: the harness (``raft_tpu_torch.bench``) on blobs-1000000x128
   (64 blobs of std 3.0, centers in ±10) with 10,000 queries and ground
   truth from the port's brute force (k = 100): the four families at
   the JAX harness's default sweeps (IVF n_probes 1-100 at 2,000 lists,
   IVF-PQ pq_dim 64, CAGRA degree 32 on the graph of the kNN-graph
   builders' race, with the engines raced at each itopk 32-256), the
   Google-Benchmark JSON written to ``build/bench/``; each point's QPS,
   recall@10 and build seconds (CAGRA: the engine chosen and the race's
   times), each family's best QPS at recall@10 >= 0.95 (or the highest
   recall reached). The CAGRA case first races the exact, IVF-PQ and
   NN-descent builders at its own shape (1M rows, intermediate degree
   64; ``bench.race_graph_build``, untimed in the build's seconds): each
   builder's seconds and edge recall over all rows and the verdict are
   printed, the verdict must be the rule's (the fastest builder at edge
   recall >= 0.9, the exact graph always eligible) and the cell's build
   must run it (``knn_graph_algo="auto"``). Checks:
   brute-force recall 1.0, IVF-Flat and IVF-PQ recall non-decreasing in
   n_probes (within 0.005), each CAGRA point's engine the fastest of
   its own race, and its timed searches launching the kernel of that
   engine and no other (K6 for fused, K5 for edge, neither for gather).
   Then brute force and IVF-Flat again with ``--dtype int8`` on the same
   data (``build/bench/blobs-1000000x128.int8.bench.json``), launching
   only K2's and K3's int8 forms.
   Then the entry points that share the chunk loop, on the path's
   indexes: ``cagra.health`` (its unreachable nodes equal to a count on
   the graph); a CAGRA search at ``query_chunk`` = 1,024 (recall@10
   within 0.01 of the unchunked search's, one K6 launch a chunk); brute
   force and IVF-Flat at ``query_chunk`` = 2,500 under a ``Deadline``
   whose injected clock expires after two chunks (``DeadlineExceeded``,
   its partial results the unchunked search's first 5,000 rows bit for
   bit, two launches); an expired deadline on each family raising with
   no partial result and no launch; each family's ``make_searcher``
   equal to ``search`` bit for bit; and a child ``python -c`` process
   that reads the run's verdict file (``build/autotune.json``, deleted
   at the start of the run, so no earlier run's verdict steers this one)
   and finds and follows the bench cell's graph verdict and engine
   verdicts.
   Then serialize, on the path's four indexes: each saved with its
   family's ``save`` into a temporary directory under ``build/`` (MiB
   and save seconds printed) and loaded onto the card by a child
   ``python -c`` process (load seconds printed, the files warm in the
   page cache), which searches them with explicit engines — brute force
   at k = 10, IVF-Flat and IVF-PQ at 20 probes, IVF-PQ refined to k = 10
   against the loaded brute-force rows, CAGRA with the edge and the
   fused engine on the edge store rebuilt from the loaded graph — and
   must launch each of K1-K6; its ids and distances must equal the
   parent's searches on the in-memory indexes bit for bit. The IVF-Flat,
   IVF-PQ and CAGRA indexes are also written as RAFT-native files
   (``core.raft_format``), loaded back and searched bit-equal to the
   in-memory ones (CAGRA without its seed set, which a RAFT file does
   not keep). One byte flipped inside the IVF-PQ file's ``codes``
   section must make ``load`` raise ``CorruptIndexError`` naming
   ``codes``.
5. stores: the low-precision stores through the entry points, each path
   with the counters reset before it, no plain version of K2 or K3
   allowed to run, and every K2 or K3 launch the store's form: brute
   force at bf16, int8 and int4 on the path's data (QPS, recall@10
   against the f32 index's ids; bf16 >= 0.95), uint8 on the bench's
   byte-grid remap of the path's rows and queries (ids equal to the f32
   index's on the same byte rows; whether the values are bit-equal is
   printed), IVF-Flat (n_lists 1024, n_probes 20) at bf16 and int8 and
   uint8 on the remapped rows (recall@10 against f32 brute force on the
   same rows; >= 0.90 but for int8, whose quantization sets it).
6. kernels: each kernel against its plain PyTorch version on the card at
   the path's shapes (K1 at every (rows, n, k) the paths hand it — the
   coarse probe, the brute-force split merge (the CAGRA build's k = 129
   is K2's wide form, which merges its splits itself), the
   IVF-Flat and IVF-PQ probe merges, refine, the edge engine's parent
   pick and buffer merge, the allgather merge at k = 100, NN-descent's
   merge at k = 64 (the bench's build) and 128 (the graph route) and the
   IVF-PQ graph pass's merge (32,768 x 64·257) at k = 257, the last
   three taken from the paths as they ran — each form on
   the path's values and on integer-valued rows, the two forms timed in
   turn, and bit for bit on the path's values with NaN, -NaN, ±inf and
   -0.0 cells mixed in; K2 on integer inputs at k = 10, 129 and 256 and
   on the path's data at k = 10 and at the CAGRA build's k = 129; K3 and
   K4 in both forms (grouped, per-pair), each launched twice and
   bit-equal, both timed, with the grouped form's tiles and the bytes
   they read (K3's FP32 bound beside its 3xTF32 one); K3 also at k = 257
   and 512 (both forms, and on integer-valued lists and queries, with
   the grouped plan the library makes); K4 in the bf16,
   f32 and int8 LUT modes and on an integer-valued copy of the IVF-PQ
   index, and at the IVF-PQ graph pass's first batch (4-bit codes, int8
   LUT, k = 257, both forms; at k = 512 on its first 8,192 queries;
   values slot by slot, ids as sets, since near ties reorder ids past
   128 slots; equal on an integer-valued copy), K5 and K6 on the path's data,
   where they must be equal, and on
   integer-valued copies; K5 also on a bf16 store; K6 launched twice,
   bit-equal, and timed cut to 8, 32 and 80 hops (the cost of a hop),
   and equal to its plain version at itopk 256 on the bench's index;
   K5's and K6's registers, spills, resident warps an SM, warps a block
   and K5's shared memory an SM (as the card reports them for the path's
   shape); K7 and K8, which must
   be equal, on the path's candidates and on integer-valued lists (K8:
   cross-shard ties and a dead shard; K7: unsorted, ties, NaN, ±inf and
   -0.0, bit for bit), at the path's k = 10 and at k = 100, K7 also at
   k = 300, K8 also at p = 8, at p = 16 (k = 10) and with fewer rows
   than ring blocks (m = 1 and 100)), with the kernel's time (median of
   CUDA-event timed calls after a warm-up, L2 flushed before each), the
   plain version's time, one PyTorch library call's time where one
   computes the same function, and the least time the card could take:
   the larger of the bytes over 3.35 TB/s (each input counted once: K5
   and K6 read each distinct parent's tile once; K5 is timed on the
   parents of a mid-traversal hop) and the operations' time, with
   FP32 FLOPs at 67 TFLOP/s (an FMA counts 2) and single adds or
   compares at half that, 33.5 T/s (H100 SXM data sheet); K2's bound is
   its f32-accurate product on the tensor cores, three TF32 products at
   495 TFLOP/s (3xTF32), printed beside the FP32 pipe's and each one's
   share, also at the CAGRA build's shape (one full batch) and for
   the whole kNN-graph stage; K1's bound
   reads its input once and writes k (value, column) pairs a row; K7's bound
   counts one compare a cell in, K8's reads each shard's input and
   writes its output once and counts a merge's p·k·log2(p) compares a
   row. The sharded merge alone is timed per engine at k = 10 and 100.
   K1 (each form, at every shape), K5 (each store), K7 and K8 also report
   the card's time alone (``device_ms``: calls queued back to back while
   the card is still busy with flush writes, so the host work between
   them is hidden): an event time includes the wrapper's host work wherever
   that outlasts the L2 flush, which a loaded host makes happen for
   these short kernels. K1's forms are timed with 9 calls a turn, K8
   with 15. The store forms (rows ``fused_knn.<store>``,
   ``ivf_flat_scan.<store>``): K2's equal to the plain version on
   integer-valued stores (k = 10 and 129) and close on the path's
   stores (512 queries; int4 also at d = 100, half_p 64; uint8 with its
   tolerance scaled to the norms, as the expanded L2 formula's rounding
   is, and bit-equal to the f32 form on the same byte rows), timed at
   the path's shape beside the bf16 GEMM + ``torch.topk`` (bf16) or
   dequantize + the f32 GEMM + ``torch.topk`` (the others), bound by
   one product at 989 TFLOP/s bf16 (bf16) or two TF32 products (the
   others), with each form's registers and spills from the build (a
   spill fails); K3's in both forms on the path's store indexes, each
   launched twice, bit-equal, equal to the plain version on integer
   stores, bound by two TF32 products a (pair, row), timed beside K3's
   f32 form of the same run.

7. edge stores, after the kernel phases of K5 and K6 and on the path's
   CAGRA index, its int8 store dropped first: the int4 store (split-half
   nibbles, ~4.1 GB of codes) and the pq store (``default_pq_dim(128)`` =
   16 codes a row over 256-word codebooks, int8 LUT, ~1.0 GB), each
   built at the path's width (bytes and seconds printed) and searched
   through the entry point with the counters reset before each engine's
   run: int4 with the edge and the fused engine, which must be equal in
   ids and distances and launch only K5's or K6's int4 form besides K1;
   pq with the edge engine, only K5's pq form, and an explicit fused
   search must raise. Each store's raw recall@10 against brute force and
   JAX's serving recipe (search at k = itopk, refine to 10): int4's at
   least 0.95 of the int8 store's (JAX's contract), pq's share printed
   (gated once its first card run met the contract: ``PQ_MIN_RATIO``).
   ``tune_search`` at each store (pq's race has no fused lane). Then K5's
   int4 and pq forms on the path's hop-32 parents and K6's int4 form on
   the path's seeded buffer against their plain versions, bit for bit:
   on the path's store, with a penalty at the ip metric, on
   integer-valued copies (int4: nibbles with unit scales; pq: integer
   codebooks of per-subspace absmax 127, so the int8 LUT's scale is 1,
   in both LUT modes) at both metrics, K5's pq form also at pq_dim 64
   (pq_len 2) and on a real f32 LUT; K6 launched twice, bit-equal. Each
   is timed beside its plain version and its bound: the bytes of the
   distinct parents' tiles and aux rows (pq: plus its codebook once;
   K6: the int4 traversal's own parents), with registers, spills,
   resident warps and K5's shared memory an SM, K5's forms also beside
   the dense form's times of the same run.

8. wide k, after the K2–K4 phases and on the path's data and indexes,
   each path with the counters reset before it: brute force at k = 24,
   257 and 1,024 (K2's wide form past the k-lists' 24, which selects
   each query's k from its splits itself: no K1 merge), its int8 store
   at 24 and 1,024, 4 shards at 1,024 with each merge engine (equal on every
   shard, and to the single card's ids); IVF-Flat and IVF-PQ (20 probes,
   bf16 LUT) at k = 512, 1,025 and 2,048 (the grouped forms' wide plans,
   one grouped launch a search, no per-pair one); each search's first
   columns bit for bit the search at the smaller k. CAGRA built on
   ``WIDE_CAGRA_ROWS`` rows at intermediate degree 256 by the exact
   route (K2 at k = 257) and by the IVF-PQ pass at 256 and 512 (K4 at
   k = 513 and 1,025, ``cagra.pass_batch``'s batches), graph degree 64:
   the kNN graph's seconds and its stages' (K2, K4, K1's merges, refine
   and refine's K1 merges), its edge recall (the exact route's must be
   1) and the fused search's recall@10 at itopk 64. Then the new forms
   against their plain versions: K2's on integer inputs at k = 32, 65,
   129, 257, 1,024 and 2,048 (equal) and on the path's data at 1,024
   (values slot by slot, ids as sets), timed at each of those k,
   its scratch held to the library's statement; K3's and K4's at k = 1,025 on 1,000 queries of
   the path (the same), on integer-valued copies (equal; at k = 1,024
   equal to the per-pair form bit for bit), each pair's first 512
   columns the plan at 512's; K4 at the pass's batches past 256, its
   grouped form at k = 513 faster than the per-pair form, each batch
   beside its bound (``scan_bound``). Each is timed
   beside its plain version and bound (K2 also beside ``addmm`` +
   ``torch.topk`` at k = 1,024) in the rows ``fused_knn.wide``,
   ``ivf_flat_scan.wide`` and ``ivf_pq_scan.wide`` (launches: the
   phase's paths'). K1's radix select at the merges these paths hand it
   past k = 512 (the IVF-Flat search at k = 2,048, the IVF-PQ pass's at
   intermediate degree 256 and 512: k = 513 and 1,025, and the degree-512
   pass's refine at k = 513), as captured: bit for bit against its plain
   version, its time alone, its launches on the paths, its bytes bound
   and ``torch.topk``'s time on the same input, whose values it must
   equal (the K1 row's ``radix_wide``).

Prints progress lines, then a ``{"kernels": [...]}`` line, the card's name
and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is not 0. With no CUDA device it exits non-zero before printing any
result. Every matrix product runs in full float32 (TF32 off). Before its
first allocation on the card it waits, a bounded time, until the card has
room for the run's peak (memory another process holds there would fail it).
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from raft_tpu_torch import bench
from raft_tpu_torch.bench import roofline, select_k_sweep
from raft_tpu_torch.comms import Mesh
from raft_tpu_torch.core import raft_format
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import CorruptIndexError, RaftError
from raft_tpu_torch.matrix import select_k as sk
from raft_tpu_torch.neighbors import (brute_force, cagra, ivf_flat, ivf_pq,
                                      refine)
from raft_tpu_torch.neighbors._list_layout import gather_dense
from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.ops import cagra_fused as cf
from raft_tpu_torch.ops import filter_policy
from raft_tpu_torch.ops import nn_descent as nnd
from raft_tpu_torch.ops import fused_knn as fk
from raft_tpu_torch.ops import graph_expand as ge
from raft_tpu_torch.ops import ivf_pq_scan as ipq
from raft_tpu_torch.ops import ivf_scan as iscan
from raft_tpu_torch.ops import quant
from raft_tpu_torch.ops import ring_topk as rt
from raft_tpu_torch.parallel import sharded_ann, sharded_knn
from raft_tpu_torch.stats.metrics import neighborhood_recall
from raft_tpu_torch.tools import kernel_ab, scan_ab
from raft_tpu_torch.utils import cdiv, round_up_to

SEED = 0
N, D, M, K = 1_000_000, 128, 10_000, 10
N_LISTS, N_PROBES = 1024, 20
N_BLOBS = 1000
PQ_DIM, PQ_BITS, K0 = 64, 8, 20   # raft-ann-bench's IVF-PQ setting, d = 128
# CAGRA: cagra_types.hpp's index and search defaults
CAGRA_D0, CAGRA_DEG, ITOPK = 128, 64, 64
CAGRA_SP = cagra.SearchParams(itopk_size=ITOPK, search_width=1)
CAGRA_MIN_RECALL = 0.90
K5_HOP = 32        # K5 is timed on the parents of this hop (of up to 80)
# the query rows of one K2 launch of the CAGRA build: build_knn_graph's own
CAGRA_BATCH = inspect.signature(
    cagra.build_knn_graph).parameters["batch"].default
P_SHARDS = 4       # the sharded paths: 4 shards on the one card
# sharded recall@10 floors, set under the first reading on the card
# (H100, 700 W): IVF-Flat 0.9475, IVF-PQ (raw, no refine) 0.8208
SHARD_MIN_RECALL = {"ivf_flat": 0.93, "ivf_pq": 0.80}
RING_K = 100       # K7 and K8 are also timed at this k (the path's is K)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, FP32 outside the tensor cores
FP32_INSTR_PER_S = 33.5e12     # one add, compare or FMA per lane per clock
TF32_FLOPS_PER_S = 495e12      # H100 SXM, dense TF32 on the tensor cores
RTOL = 1e-5                    # float32 sums in another order
K7_KS = (K, RING_K, 300)       # K7's k: the path's, RING_K, past K8's forms
# the graph routes: NN-descent and the IVF-PQ pass at the path's
# parameters on all its rows; edge recall on EDGE_SAMPLE rows
EDGE_SAMPLE, EDGE_MIN_RECALL = 10_000, 0.80
# the IVF-PQ pass asks K4 for 2·128 + 1 candidates a row; K3 and K4 are
# also held there and at their grouped forms' widest k, K4 at 512 on the
# first WIDE_QUERIES queries of the pass's first batch (and on an
# integer-valued copy of that batch)
PASS_K = 2 * CAGRA_D0 + 1
SPLIT_DIR = "build/split"      # K4's split builds (tools/scan_ab.py)
# the IVF-PQ route's kNN graph seconds on an H100 80GB HBM3 (700 W) with
# K4's streaming selection past k = 256, before its own plan (PERF.md §5)
ROUTE_KNN_STREAMING_S = 7.80
WIDE_KS = (PASS_K, iscan.GROUP_MAX_K)
WIDE_QUERIES = 8192
# the wide-k phase, past the kernels' old limits (K2's k-lists end at 256,
# the grouped K3/K4 k-lists at 512, the per-pair forms at 1,024): brute
# force at these k (f32; int8 and 4 shards at the last), IVF-Flat and
# IVF-PQ at these, CAGRA built at these (intermediate degree, kNN-graph
# route) on the first WIDE_CAGRA_ROWS rows, the kernels held to their
# plain versions on WIDE_CHECK_QUERIES queries
WIDE_BF_KS = (257, 1024)
WIDE_IVF_KS = (1025, 2048)
WIDE_CAGRA = ((256, "brute"), (256, "ivf_pq"), (512, "ivf_pq"))
WIDE_CAGRA_ROWS = N
WIDE_CHECK_QUERIES = 1000
# the bench phase: the harness's synthetic spec (64 blobs of std 3.0,
# centers in ±10), 10,000 queries, the CLI's ground-truth depth
BENCH_SPEC, BENCH_QUERIES, BENCH_GT_K, BENCH_REPS = (
    "blobs-1000000x128", 10_000, 100, 5)
BENCH_TARGET = 0.95            # the north star: QPS at recall@10 >= 0.95
BENCH_OUT = "build/bench"      # its Google-Benchmark JSON goes here
BENCH_STORE = "int8"           # the bench's low-precision run (--dtype)
# the run's autotune verdict file (RAFT_TPU_TORCH_AUTOTUNE_CACHE), deleted
# at the start
VERDICT_FILE = "build/autotune.json"

# the run's peak device memory is 58.41 GiB allocated (in the wide-k
# phase; 57.60 before it), 72.44 GiB held by the allocator (NVIDIA H100
# 80GB HBM3, 700.00 W); before its first allocation it waits up to
# CARD_WAIT_S for this much to be free
CARD_NEED = 64 * 2**30
CARD_WAIT_S = 420

# kernel name -> (wrapper module, its launch counter)
STORE_NAMES = ("bfloat16", "int8", "uint8", "int4")
_COUNTERS = {"select_k": (sk, "launches"),
             "select_k.warp": (sk, "warp_launches"),
             "select_k.radix": (sk, "radix_launches"),
             "fused_knn": (fk, "launches"),
             "fused_knn.wide": (fk, "wide_launches"),
             **{f"fused_knn.{s}": (fk, f"launches_{s}")
                for s in STORE_NAMES},
             "ivf_flat_scan": (iscan, "launches"),
             "ivf_flat_scan.group": (iscan, "group_launches"),
             "ivf_flat_scan.pair": (iscan, "pair_launches"),
             "ivf_flat_scan.wide": (iscan, "wide_launches"),
             **{f"ivf_flat_scan.{s}": (iscan, f"launches_{s}")
                for s in STORE_NAMES[:3]},
             "ivf_pq_scan": (ipq, "launches"),
             "ivf_pq_scan.group": (ipq, "group_launches"),
             "ivf_pq_scan.pair": (ipq, "pair_launches"),
             "ivf_pq_scan.wide": (ipq, "wide_launches"),
             "ivf_pq_scan.per_cluster": (ipq, "per_cluster_launches"),
             "graph_expand": (ge, "launches"),
             **{f"graph_expand.{m}": (ge, f"launches_{m}")
                for m in ("dense", "int4", "pq")},
             "cagra_fused": (cf, "launches"),
             **{f"cagra_fused.{m}": (cf, f"launches_{m}")
                for m in ("dense", "int4")},
             "merge_step": (rt, "merge_step_launches"),
             "ring_topk": (rt, "ring_launches")}
# the kernels each sharded merge engine launches on one card
_MERGE_KERNELS = {"allgather": ("select_k",), "ring": ("merge_step",),
                  "ring_pallas": ("ring_topk",)}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


def counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in
            _COUNTERS.items()}


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_memory() -> str:
    """The card's free and total memory, what this process's allocator
    holds, and the compute processes ``nvidia-smi`` lists on the card (in
    a container it may list none, or only this one)."""
    free, total = torch.cuda.mem_get_info()
    apps = subprocess.run(["nvidia-smi",
                           "--query-compute-apps=pid,used_memory",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    listed = "; ".join(apps.stdout.strip().splitlines()) or "none listed"
    return (f"{free / 2**30:.2f} GiB free of {total / 2**30:.2f}, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB held by this "
            f"process's allocator; compute processes: {listed}")


def await_card(need: int, budget_s: float) -> None:
    """Wait, up to ``budget_s`` seconds, until ``need`` bytes of the card
    are free. Memory that another process holds there (one still ending,
    or another job on the card) would fail the run at its first large
    allocation. Past the budget the run goes on with what is free."""
    log(f"card memory at the start: {card_memory()}")
    t0 = time.perf_counter()
    last = t0
    while torch.cuda.mem_get_info()[0] < need:
        now = time.perf_counter()
        if now - t0 >= budget_s:
            log(f"card memory: below {need / 2**30:.0f} GiB free after "
                f"{now - t0:.0f} s, the run goes on: {card_memory()}")
            return
        if now - last >= 30:
            log(f"card memory: waiting for {need / 2**30:.0f} GiB free "
                f"({now - t0:.0f} s): {card_memory()}")
            last = now
        time.sleep(2)
    if time.perf_counter() > t0 + 1:
        log(f"card memory: {need / 2**30:.0f} GiB free after waiting "
            f"{time.perf_counter() - t0:.1f} s: {card_memory()}")


def mark(t0: float, phase: str) -> None:
    """One line after a phase: the seconds since ``t0``, the peak device
    memory allocated since the last reset of the peak (the IVF-PQ route and
    the edge-store phase reset it), what the allocator holds, and the
    card's free memory."""
    log(f"memory after the {phase} ({time.perf_counter() - t0:.1f} s): "
        f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB, reserved peak {torch.cuda.max_memory_reserved() / 2**30:.2f}"
        f" GiB, card free {torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB")


def clustered(rng, n: int, centers: np.ndarray, scales: np.ndarray):
    lab = rng.integers(0, len(centers), n)
    x = rng.standard_normal((n, centers.shape[1]), dtype=np.float32)
    x *= scales[lab, None]
    x += centers[lab]
    return x


def host_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class Timer:
    """Median CUDA-event time of ``fn`` in ms; the L2 cache is flushed
    (a 256 MB write) before each timed call."""

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, reps: int = 5, warmup: int = 1) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def device_ms(fn, reps: int = 10) -> float:
    """The card's time in ms for one call of ``fn``, without the host
    work around its launches: ``reps`` calls queued back to back behind
    L2-flush writes that keep the card busy until the host has queued
    them all, timed by events between the calls (L2 warm after the
    first). If the card finished the writes before the host finished
    queueing, it may have waited on the host: the lead is doubled and
    the calls timed again."""
    fn()
    torch.cuda.synchronize()
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    lead = 16
    for _ in range(6):
        for _ in range(lead):
            flush.zero_()
        ahead = torch.cuda.Event()
        ahead.record()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        caught_up = ahead.query()
        end.synchronize()
        if not caught_up:
            return start.elapsed_time(end) / reps
        lead *= 2
    raise AssertionError("the host could not queue the calls ahead of the "
                         "card")


def bound(n_bytes: float, n_flops: float, n_single: float = 0.0):
    """(least ms, what bounds it): the bytes over the memory rate against
    ``n_flops`` FP32 FLOPs (an FMA counts 2) at the FP32 peak plus
    ``n_single`` lone adds or compares, which issue at half that rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_flops / FP32_FLOPS_PER_S
             + n_single / FP32_INSTR_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_bound(n_bytes: float, scanned: float, d: int, products: int,
               lut=None):
    """(least ms, what bounds it) of an IVF scan of ``scanned`` (pair, row)
    dot products of ``d`` dimensions: the bytes over the memory rate
    against the products on the tensor cores, ``products`` TF32 products
    a multiply (3xTF32 over f32 rows; 2 where the row side is exact in
    TF32: byte and bf16 rows, a TF32-exact PQ codebook) at the TF32 peak,
    or for PQ codes the cheaper of that and the LUT route, ``lut`` =
    (FP32 FLOPs of the LUTs, one lone add a (pair, row, subspace))."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = products * 2.0 * d * scanned / TF32_FLOPS_PER_S * 1e3
    if lut is not None:
        t_ops = min(t_ops, (lut[0] / FP32_FLOPS_PER_S
                            + lut[1] / FP32_INSTR_PER_S) * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tf32_products(cb: torch.Tensor) -> int:
    """TF32 products a multiply by the PQ codebook ``cb`` as K4 makes them:
    2 where every value is exact in TF32 (it skips the zero lo parts),
    else 3."""
    return 2 if bool(((cb.view(torch.int32) & ipq._TF32_LOW) == 0).all()) \
        else 3


def check_close(ref_v, ref_i, v, i, what: str, min_rows: float = 0.99,
                scale=None) -> float:
    """Values to rtol=1e-5, atol=1e-5·``scale`` (max|d| unless given;
    float32 sums in another order); ids equal on >= ``min_rows`` of the
    rows (99%). Returns max |v - ref_v|."""
    fin = torch.isfinite(ref_v)
    if not torch.equal(torch.isfinite(v), fin):
        raise AssertionError(f"{what}: +inf slots differ")
    err = float((v[fin] - ref_v[fin]).abs().max()) if fin.any() else 0.0
    atol = RTOL * (float(ref_v[fin].abs().max()) if scale is None
                   else scale)
    if not torch.allclose(v[fin], ref_v[fin], rtol=RTOL, atol=atol):
        raise AssertionError(f"{what}: values differ by up to {err}")
    rows_eq = float((i == ref_i).all(dim=1).float().mean())
    if rows_eq < min_rows:
        raise AssertionError(f"{what}: ids equal on {rows_eq:.4f} of rows")
    log(f"  {what}: max_abs_err={err:.3g} ids equal on {rows_eq:.4f} of "
        "rows")
    return err


def check_equal(ref, got, what: str) -> float:
    """Fail unless every tensor of ``got`` equals ``ref``'s; returns the
    measured max |value - plain value| over the finite values (0.0)."""
    for a, b in zip(ref, got):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: kernel and plain version differ")
    fin = torch.isfinite(ref[0])
    err = float((got[0][fin] - ref[0][fin]).abs().max()) if fin.any() \
        else 0.0
    log(f"  {what}: values and ids equal")
    return err


def check_bits(ref, got, what: str) -> None:
    """Fail unless the values of ``got`` equal ``ref``'s bit for bit (NaN
    payloads and -0.0 included) and the other tensors are equal."""
    if not (torch.equal(ref[0].view(torch.int32), got[0].view(torch.int32))
            and all(torch.equal(a, b) for a, b in zip(ref[1:], got[1:]))):
        raise AssertionError(f"{what}: not equal bit for bit")
    log(f"  {what}: equal bit for bit")


def odd_cells(x, seed):
    """A copy of ``x`` with NaN, -NaN, +inf, -inf and -0.0 cells mixed
    in."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    x = x.clone()
    for v, share in ((float("nan"), 0.05), (-float("nan"), 0.01),
                     (float("inf"), 0.02), (-float("inf"), 0.02),
                     (-0.0, 0.02)):
        x[torch.rand(x.shape, generator=g, device=x.device) < share] = v
    return x


def run_path(name: str, kernels, fn, totals: dict):
    """Drive one path with every launch counter set to 0 just before it;
    read the counters just after, add them to ``totals``, and fail if a
    kernel of the path was not launched."""
    reset_counts()
    out = fn()
    moved = counts()
    log(f"{name} path launches: {json.dumps(moved)}")
    for kern in kernels:
        if moved[kern] == 0:
            raise AssertionError(f"kernel {kern} was not launched on the "
                                 f"{name} path")
    for kern, n in moved.items():
        totals[kern] += n
    return out


def by_form(moved: dict, kern: str) -> dict:
    """A kernel's launches by form, out of the counts ``moved`` (its
    stores' counts left out)."""
    return {name.split(".")[1]: n for name, n in moved.items()
            if name.startswith(f"{kern}.")
            and name.split(".")[1] not in STORE_NAMES}


def check_scan_forms(name: str, scan: str, searches: int) -> None:
    """The path just run launched the IVF scan kernel ``scan`` once a
    search (one search a shard), each time in its grouped form."""
    moved = counts()
    got = (moved[scan], moved[f"{scan}.group"], moved[f"{scan}.pair"])
    if got != (searches, searches, 0):
        raise AssertionError(f"{name}: {scan} launches (all, grouped, "
                             f"per-pair) {got}, expected ({searches}, "
                             f"{searches}, 0)")


def check_knn(what: str, v, i, k: int) -> None:
    if v.shape != (M, k) or i.shape != (M, k):
        raise AssertionError(f"{what}: shapes {tuple(v.shape)}")
    if not bool(torch.isfinite(v).all()) or not bool(
            ((i >= 0) & (i < N)).all()):
        raise AssertionError(f"{what}: non-finite values or bad ids")


def numpy_l2(x, q, ids):
    """float64 squared L2 distances of the queries ``q`` to rows ``ids``
    (per query) of ``x``, on the host."""
    xs = x[ids.reshape(-1).long()].cpu().double().numpy()
    xs = xs.reshape(ids.shape[0], ids.shape[1], -1)
    qs = q.cpu().double().numpy()
    return ((xs - qs[:, None, :]) ** 2).sum(-1)


def path_phase(x, q):
    """The slice's main paths through the public entry points."""
    totals = dict.fromkeys(_COUNTERS, 0)

    def bf_path():
        bidx, t_build = host_time(lambda: brute_force.build(x))
        (bv, bi), t_first = host_time(lambda: brute_force.search(bidx, q,
                                                                 K))
        (bv, bi), t = host_time(lambda: brute_force.search(bidx, q, K))
        return bidx, bv, bi, t_build, t_first, t

    bidx, bv, bi, t_bf_build, t_bf_first, t_bf = run_path(
        "brute_force", ("fused_knn", "select_k"), bf_path, totals)
    log(f"brute_force: build {t_bf_build:.3f} s, search(k={K}) first "
        f"{t_bf_first * 1e3:.1f} ms, steady {t_bf * 1e3:.1f} ms, "
        f"{M / t_bf:.0f} QPS")
    check_knn("brute_force", bv, bi, K)

    def ivf_path():
        params = ivf_flat.IndexParams(n_lists=N_LISTS, seed=SEED)
        iidx, t_build = host_time(lambda: ivf_flat.build(x, params))
        sp = ivf_flat.SearchParams(n_probes=N_PROBES)
        (iv, ii), t_first = host_time(lambda: ivf_flat.search(iidx, q, K,
                                                              sp))
        (iv, ii), t = host_time(lambda: ivf_flat.search(iidx, q, K, sp))
        return iidx, iv, ii, t_build, t_first, t

    iidx, iv, ii, t_ivf_build, t_ivf_first, t_ivf = run_path(
        "ivf_flat", ("ivf_flat_scan", "ivf_flat_scan.group", "select_k"),
        ivf_path, totals)
    check_scan_forms("ivf_flat", "ivf_flat_scan", 2)
    sizes = iidx.list_sizes
    log(f"ivf_flat: build {t_ivf_build:.3f} s (list sizes min "
        f"{sizes.min()} median {int(np.median(sizes))} max {sizes.max()}), "
        f"search(n_probes={N_PROBES}, k={K}) first "
        f"{t_ivf_first * 1e3:.1f} ms, steady {t_ivf * 1e3:.1f} ms, "
        f"{M / t_ivf:.0f} QPS")
    check_knn("ivf_flat", iv, ii, K)
    recall = neighborhood_recall(ii, bi)
    log(f"ivf_flat recall@{K} vs brute force: {recall:.4f}")
    if recall < 0.90:
        raise AssertionError(f"ivf_flat recall {recall:.4f} < 0.90")

    def pq_path():
        params = ivf_pq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM,
                                    pq_bits=PQ_BITS, seed=SEED)
        pidx, t_build = host_time(lambda: ivf_pq.build(x, params))
        sp = ivf_pq.SearchParams(n_probes=N_PROBES)      # bf16 LUT
        (pv, pi), t_first = host_time(lambda: ivf_pq.search(pidx, q, K0,
                                                            sp))
        (pv, pi), t_search = host_time(lambda: ivf_pq.search(pidx, q, K0,
                                                             sp))
        (rv, ri), t_ref_first = host_time(lambda: refine.refine(x, q, pi,
                                                                K))
        (rv, ri), t_ref = host_time(lambda: refine.refine(x, q, pi, K))
        return (pidx, pv, pi, rv, ri, t_build, t_first, t_search,
                t_ref_first, t_ref)

    (pidx, pv, pi, rv, ri, t_pq_build, t_pq_first, t_pq, t_ref_first,
     t_ref) = run_path("ivf_pq", ("ivf_pq_scan", "ivf_pq_scan.group",
                                  "select_k"), pq_path, totals)
    check_scan_forms("ivf_pq", "ivf_pq_scan", 2)
    split = ", ".join(f"{k} {v:.3f} s" for k, v in
                      pidx.build_seconds.items())
    log(f"ivf_pq: build {t_pq_build:.3f} s ({split}; pq_dim={PQ_DIM}, "
        f"pq_bits={PQ_BITS}, {pidx.codes.numel() / 2**20:.1f} MiB of "
        f"codes), search(n_probes={N_PROBES}, k0={K0}, bf16 LUT) first "
        f"{t_pq_first * 1e3:.1f} ms, steady {t_pq * 1e3:.1f} ms; refine "
        f"to k={K} first {t_ref_first * 1e3:.1f} ms, steady "
        f"{t_ref * 1e3:.1f} ms; search + refine {M / (t_pq + t_ref):.0f} "
        "QPS")
    check_knn("ivf_pq", pv, pi, K0)
    check_knn("ivf_pq + refine", rv, ri, K)
    raw = neighborhood_recall(pi[:, :K], bi)
    refined = neighborhood_recall(ri, bi)
    log(f"ivf_pq recall@{K} vs brute force: raw (first {K} of {K0}) "
        f"{raw:.4f}, refined {refined:.4f}")
    if refined < 0.85:
        raise AssertionError(f"ivf_pq refined recall {refined:.4f} < 0.85")
    cidx = cagra_path(x, q, bi, totals)
    sidx = sharded_paths(x, q, bv, bi, totals)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")

    # brute force against numpy (float64) on a few queries
    xs, qs = x.cpu().double().numpy(), q[:16].cpu().double().numpy()
    d = (qs ** 2).sum(1)[:, None] + (xs ** 2).sum(1)[None, :] - 2 * qs @ xs.T
    ref_i = torch.from_numpy(np.argsort(d, axis=1, kind="stable")[:, :K])
    ref_v = torch.from_numpy(np.take_along_axis(d, ref_i.numpy(), axis=1))
    check_close(ref_v.float(), ref_i.int(), bv[:16].cpu(), bi[:16].cpu(),
                "brute_force vs numpy float64 (16 queries)")
    # refine against numpy (float64) over the same candidates
    dc = numpy_l2(x, q[:16], pi[:16])
    order = np.argsort(dc, axis=1, kind="stable")[:, :K]
    check_close(torch.from_numpy(np.take_along_axis(dc, order, 1)).float(),
                torch.gather(pi[:16].cpu(), 1, torch.from_numpy(order)),
                rv[:16].cpu(), ri[:16].cpu(),
                "refine vs numpy float64 (16 queries)")
    return bidx, iidx, pidx, cidx, sidx, totals


def determinism_phase(x, iidx, pidx):
    """The path's IVF-Flat and IVF-PQ indexes built once more from the same
    rows in this process, compared bit for bit with the path's: centers,
    list contents and order, rotation, codebooks and codes (the k-means
    and codebook sums take a fixed order, ``cluster.kmeans.segment_sum``,
    and ``adjust_centers`` draws through integer sums)."""
    bits = lambda a, b: torch.equal(a.view(torch.int32),  # noqa: E731
                                    b.view(torch.int32))
    a, t = host_time(lambda: ivf_flat.build(
        x, ivf_flat.IndexParams(n_lists=N_LISTS, seed=SEED)))
    if not (bits(a.centers, iidx.centers) and bits(a.data, iidx.data)
            and torch.equal(a.source_ids, iidx.source_ids)
            and np.array_equal(a.list_sizes, iidx.list_sizes)):
        raise AssertionError("two IVF-Flat builds of one tree differ")
    log(f"determinism: IVF-Flat built again ({t:.3f} s) is bit-equal to "
        "the path's: centers, lists")
    del a
    b, t = host_time(lambda: ivf_pq.build(x, ivf_pq.IndexParams(
        n_lists=N_LISTS, pq_dim=PQ_DIM, pq_bits=PQ_BITS, seed=SEED)))
    if not (bits(b.centers_rot, pidx.centers_rot)
            and bits(b.codebooks, pidx.codebooks)
            and bits(b.rotation, pidx.rotation)
            and torch.equal(b.codes, pidx.codes)
            and torch.equal(b.source_ids, pidx.source_ids)
            and np.array_equal(b.list_sizes, pidx.list_sizes)):
        raise AssertionError("two IVF-PQ builds of one tree differ")
    split = ", ".join(f"{k} {v:.3f} s" for k, v in b.build_seconds.items())
    log(f"determinism: IVF-PQ built again ({t:.3f} s: {split}) is "
        "bit-equal to the path's: centers, rotation, codebooks, codes, "
        "lists")


def cagra_path(x, q, bi, totals):
    """The CAGRA path: build, edge store, search with the edge and fused
    engines (counters reset before, read after); then the plain gather
    engine as a reference line."""
    def path():
        params = cagra.IndexParams(intermediate_graph_degree=CAGRA_D0,
                                   graph_degree=CAGRA_DEG,
                                   knn_graph_algo="brute", seed=SEED)
        cidx, t_build = host_time(lambda: cagra.build(x, params))
        _, t_store = host_time(lambda: cagra.prepare_traversal(cidx))
        runs = {}
        for eng in ("edge", "fused"):
            (d, i), t_first = host_time(lambda: cagra.search(
                cidx, q, K, CAGRA_SP, engine=eng))
            (d, i), t = host_time(lambda: cagra.search(cidx, q, K, CAGRA_SP,
                                                       engine=eng))
            runs[eng] = (d, i, t_first, t)
        return cidx, t_build, t_store, runs

    cidx, t_build, t_store, runs = run_path(
        "cagra", ("fused_knn", "select_k", "graph_expand", "cagra_fused"),
        path, totals)
    st, bs = cidx.edge_store, cidx.build_stats
    store_gb = (st.vecs.numel() * st.vecs.element_size()
                + (st.aux.numel() + st.gp.numel()) * 4) / 1e9
    log(f"cagra: build {t_build:.3f} s (knn_graph {bs['knn_graph_s']:.3f} s "
        f"{bs['knn_algo']}, optimize {bs['optimize_s']:.3f} s, seeds "
        f"{bs['seeds_s']:.3f} s: {cidx.seed_nodes.numel()} rows; degree "
        f"{CAGRA_D0} -> {cidx.graph_degree}); {st.mode} edge store "
        f"{store_gb:.2f} GB built in {t_store:.3f} s")
    for eng, (d, i, t_first, t) in runs.items():
        check_knn(f"cagra {eng}", d, i, K)
        log(f"cagra {eng}: search(itopk={ITOPK}, width=1, k={K}) first "
            f"{t_first * 1e3:.1f} ms, steady {t * 1e3:.1f} ms, "
            f"{M / t:.0f} QPS")
    (ed, ei, _, _), (fd, fi, _, _) = runs["edge"], runs["fused"]
    if not (torch.equal(ei, fi) and torch.equal(ed, fd)):
        raise AssertionError("cagra: the edge and fused engines differ")
    recall = neighborhood_recall(ei, bi)
    log(f"cagra recall@{K} vs brute force: {recall:.4f} (edge and fused "
        "engines equal in ids and distances)")
    if recall < CAGRA_MIN_RECALL:
        raise AssertionError(f"cagra recall {recall:.4f} < "
                             f"{CAGRA_MIN_RECALL}")
    # what sets that recall: a wider buffer and a longer walk on the same
    # graph; and its spread over other covering seed sets and random seed
    # rows (the seed set's k-means is the build's one part that is not
    # deterministic on the card)
    for what, sp in (("itopk 128", dataclasses.replace(CAGRA_SP,
                                                       itopk_size=128)),
                     ("160 hops", dataclasses.replace(CAGRA_SP,
                                                      max_iterations=160))):
        _, i = cagra.search(cidx, q, K, sp, engine="fused")
        log(f"cagra fused, {what}: recall@{K} "
            f"{neighborhood_recall(i, bi):.4f}")
    base, spread = cidx.seed_nodes, []
    for s in range(1, 5):
        cidx.seed_nodes = cagra.build_covering_seeds(
            x, cagra.IndexParams(seed=s))
        _, i = cagra.search(cidx, q, K, dataclasses.replace(CAGRA_SP, seed=s),
                            engine="fused")
        spread.append(neighborhood_recall(i, bi))
    cidx.seed_nodes = base
    log(f"cagra fused recall@{K} with seed sets and seed rows from seeds "
        f"1-4: {', '.join(f'{r:.4f}' for r in spread)}")
    # the plain gather engine (bf16 rows): a reference line, no kernel of
    # its own
    sp = dataclasses.replace(CAGRA_SP, engine="gather")
    (gd, gi), t_first = host_time(lambda: cagra.search(cidx, q, K, sp))
    (gd, gi), t = host_time(lambda: cagra.search(cidx, q, K, sp))
    check_knn("cagra gather", gd, gi, K)
    log(f"cagra gather (plain, reference): first {t_first * 1e3:.1f} ms, "
        f"steady {t * 1e3:.1f} ms, {M / t:.0f} QPS, recall@{K} "
        f"{neighborhood_recall(gi, bi):.4f}")
    return cidx


def sharded_run(name: str, eng: str, kernels, fn, totals: dict, merges: int):
    """One sharded path with one merge engine (:func:`run_path`), then the
    merge kernels' counts: K7 p·(p−1) times a ``ring`` merge, K8 once a
    ``ring_pallas`` merge, neither under ``allgather``."""
    out = run_path(f"{name} ({eng})", tuple(kernels) + _MERGE_KERNELS[eng],
                   fn, totals)
    moved = counts()
    want = {"merge_step": merges * P_SHARDS * (P_SHARDS - 1)
            if eng == "ring" else 0,
            "ring_topk": merges if eng == "ring_pallas" else 0}
    got = {kern: moved[kern] for kern in want}
    if got != want:
        raise AssertionError(f"{name} ({eng}): merge launches {got}, "
                             f"expected {want}")
    return out


def merged_copies(fn):
    """Run ``fn`` with ``ring_topk.merge`` recording what it returns → the
    last merge's copies, one per shard: (distances per shard, ids per
    shard). A sharded search returns the first shard's copy only."""
    seen, merge = [], rt.merge

    def tap(*args, **kwargs):
        seen.append(merge(*args, **kwargs))
        return seen[-1]

    rt.merge = tap
    try:
        fn()
    finally:
        rt.merge = merge
    return seen[-1]


def check_engines(name: str, results: dict):
    """Every engine's merged copies, on every shard, equal → (d, ids)."""
    ref_d, ref_i = results["allgather"][0][0], results["allgather"][1][0]
    for eng, (ds, gs) in results.items():
        for d, g in zip(ds, gs):
            if not (torch.equal(d, ref_d) and torch.equal(g, ref_i)):
                raise AssertionError(f"{name}: the {eng} merge differs")
    log(f"{name}: the {len(results)} merge engines equal, and every "
        f"shard's copy")
    return ref_d, ref_i


def sharded_paths(x, q, bv, bi, totals):
    """The sharded paths over 4 shards on the first card, each merge
    engine in turn: brute force (250,000 rows a shard), IVF-Flat and
    IVF-PQ with the single-card path's per-shard parameters."""
    mesh = Mesh([torch.device("cuda", 0)] * P_SHARDS)
    sidx, t_build = host_time(lambda: sharded_knn.build(x, mesh))
    log(f"sharded brute force: {P_SHARDS} shards of {sidx.shard_rows} rows "
        f"on one card, build {t_build:.3f} s")
    res = {}
    for eng in rt.ENGINES:
        def bf():
            run = lambda: merged_copies(  # noqa: E731
                lambda: sharded_knn.search(sidx, q, K, merge_engine=eng))
            r, t_first = host_time(run)
            r, t = host_time(run)
            log(f"sharded brute force ({eng}): search(k={K}) first "
                f"{t_first * 1e3:.1f} ms, steady {t * 1e3:.1f} ms, "
                f"{M / t:.0f} QPS")
            return r
        res[eng] = sharded_run("sharded brute force", eng,
                               ("fused_knn", "select_k"), bf, totals, 2)
    sd, si = check_engines("sharded brute force", res)
    check_knn("sharded brute force", sd, si, K)
    rows_eq = float((si == bi).all(dim=1).float().mean())
    err = float((sd - bv).abs().max())
    recall = neighborhood_recall(si, bi)
    log(f"sharded brute force vs the single card: ids equal on "
        f"{rows_eq:.6f} of rows, recall@{K} {recall:.6f}, max |d - d_1| "
        f"{err:.3g}")
    if recall < 0.99:
        raise AssertionError(f"sharded brute force recall {recall:.4f}")
    timer = Timer()
    for k in (K, RING_K):
        ds, gs = sharded_knn.shard_candidates(sidx, q, k)
        for eng in rt.ENGINES:
            ms = timer(lambda: rt.merge(ds, gs, k, True, mesh, engine=eng))
            log(f"sharded merge alone ({eng}, {P_SHARDS} x ({M}, {k})): "
                f"{ms:.3f} ms")
    del timer

    fams = (
        ("ivf_flat", lambda: sharded_ann.build_ivf_flat(
            x, mesh, ivf_flat.IndexParams(n_lists=N_LISTS, seed=SEED)),
         lambda idx, eng: sharded_ann.search_ivf_flat(
             idx, q, K, ivf_flat.SearchParams(n_probes=N_PROBES),
             merge_engine=eng), "ivf_flat_scan"),
        ("ivf_pq", lambda: sharded_ann.build_ivf_pq(
            x, mesh, ivf_pq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM,
                                        pq_bits=PQ_BITS, seed=SEED)),
         lambda idx, eng: sharded_ann.search_ivf_pq(
             idx, q, K, ivf_pq.SearchParams(n_probes=N_PROBES),
             merge_engine=eng), "ivf_pq_scan"))
    for fam, build, search, scan in fams:
        res, idx = {}, None
        for eng in rt.ENGINES:
            def path():
                nonlocal idx
                if idx is None:                # built in the first run
                    idx, t_b = host_time(build)
                    sizes = np.concatenate([s.list_sizes
                                            for s in idx.shards])
                    log(f"sharded {fam}: build {t_b:.3f} s over "
                        f"{P_SHARDS} shards (list sizes min {sizes.min()} "
                        f"median {int(np.median(sizes))} max "
                        f"{sizes.max()})")
                run = lambda: merged_copies(  # noqa: E731
                    lambda: search(idx, eng))
                r, t_first = host_time(run)
                r, t = host_time(run)
                log(f"sharded {fam} ({eng}): search(n_probes={N_PROBES}, "
                    f"k={K}{', bf16 LUT' if fam == 'ivf_pq' else ''}) "
                    f"first {t_first * 1e3:.1f} ms, steady "
                    f"{t * 1e3:.1f} ms, {M / t:.0f} QPS")
                return r
            res[eng] = sharded_run(f"sharded {fam}", eng,
                                   (scan, f"{scan}.group", "select_k"),
                                   path, totals, 2)
            check_scan_forms(f"sharded {fam} ({eng})", scan, 2 * P_SHARDS)
        del idx
        fd, fi = check_engines(f"sharded {fam}", res)
        check_knn(f"sharded {fam}", fd, fi, K)
        recall = neighborhood_recall(fi, bi)
        log(f"sharded {fam} recall@{K} vs brute force: {recall:.4f}")
        if recall < SHARD_MIN_RECALL[fam]:
            raise AssertionError(f"sharded {fam} recall {recall:.4f} < "
                                 f"{SHARD_MIN_RECALL[fam]}")
    return sidx


class captured:
    """Wrap ``mod.<name>`` for the duration of a ``with`` block: every call
    passes through, and the first whose (args, kwargs) satisfy ``keep`` is
    recorded in ``self.call`` (how a kernel's inputs at a path's own
    shape are taken from the path itself; ``to_host``: its tensors copied
    to the host, so that the path's peak holds none of them); ``self.n``
    counts the calls that satisfy it, and ``self.launches`` the growth of
    the launch counter ``counter`` (a key of ``_COUNTERS``) across them."""

    def __init__(self, mod, name: str, keep, to_host: bool = False,
                 counter: str | None = None):
        self.mod, self.name, self.keep, self.call = mod, name, keep, None
        self.n, self.to_host, self.counter = 0, to_host, counter
        self.launches = 0

    def __enter__(self):
        self.orig = getattr(self.mod, self.name)

        def tap(*args, **kwargs):
            if self.keep(*args, **kwargs):
                self.n += 1
                if self.call is None:
                    self.call = (tuple(a.cpu() if self.to_host and
                                       isinstance(a, torch.Tensor) else a
                                       for a in args), kwargs)
                before = counts().get(self.counter, 0)
                out = self.orig(*args, **kwargs)
                self.launches += counts().get(self.counter, 0) - before
                return out
            return self.orig(*args, **kwargs)

        setattr(self.mod, self.name, tap)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


class call_events:
    """Bracket every call of ``mod.<name>`` with CUDA events on the current
    stream for the duration of a ``with`` block (no synchronisation), so a
    stage's device time can be read call by call after the path:
    :meth:`ms` synchronises and returns each call's milliseconds."""

    def __init__(self, mod, name: str):
        self.mod, self.name, self.marks = mod, name, []

    def __enter__(self):
        self.orig = getattr(self.mod, self.name)

        def tap(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.orig(*args, **kwargs)
            end.record()
            self.marks.append((start, end))
            return out

        setattr(self.mod, self.name, tap)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)

    def ms(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.marks]


class outputs:
    """Wrap ``mod.<name>`` for the duration of a ``with`` block and keep
    ``keep(out)`` of each call's output in ``self.kept`` (a digest, so
    that no large output outlives the call)."""

    def __init__(self, mod, name: str, keep):
        self.mod, self.name, self.keep, self.kept = mod, name, keep, []

    def __enter__(self):
        self.orig = getattr(self.mod, self.name)

        def tap(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            self.kept.append(self.keep(out))
            return out

        setattr(self.mod, self.name, tap)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


class engine_runs:
    """Wrap ``cagra.search`` for the duration of a ``with`` block and
    record, for each call that leaves the engine to ``auto`` (the bench's
    timed searches; ``tune_search`` names each engine it races), its
    itopk and the K6 and K5 launches it made: ``self.runs[itopk]`` is a
    list of (K6 launches, K5 launches), one a call."""

    def __enter__(self):
        self.orig, self.runs = cagra.search, {}
        fused, expand = _COUNTERS["cagra_fused"], _COUNTERS["graph_expand"]

        def tap(index, queries, k, params=None, *args, **kwargs):
            if args or kwargs.get("engine") is not None:
                return self.orig(index, queries, k, params, *args, **kwargs)
            f0, e0 = getattr(*fused), getattr(*expand)
            out = self.orig(index, queries, k, params, **kwargs)
            self.runs.setdefault(params.itopk_size, []).append(
                (getattr(*fused) - f0, getattr(*expand) - e0))
            return out

        cagra.search = tap
        return self

    def __exit__(self, *exc):
        cagra.search = self.orig


def nnd_merge_shape(n: int, k: int):
    """The (rows, width) of CAGRA's NN-descent merge (K1) in a round: a
    batch of rows, each row's k list entries then its candidates: 2s
    joined nodes, each offering ``join`` sampled neighbors and its s-wide
    reverse sample (``exposure="sampled"``)."""
    s, join = min(nnd.SAMPLE, k), min(nnd.JOIN, k)
    return min(nnd.BATCH, n), k + 2 * s * (1 + join + s)


def exact_graph_rows(x, rows, k: int):
    """The exact k nearest other rows of ``x[rows]`` (brute force, K2 + K1,
    self dropped as ``cagra.build_knn_graph`` drops it)."""
    idx = brute_force.build(x)
    _, ids = brute_force.search(idx, x[rows], k + 1)
    return cagra._drop_self_pad(ids.long(), rows, k, x.shape[0])


def edge_recall(graph, x, k: int, seed: int) -> float:
    """Recall of ``graph``'s rows against the exact neighbors, on
    :data:`EDGE_SAMPLE` rows drawn without repeats."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    rows = torch.randperm(x.shape[0], generator=g,
                          device=x.device)[:EDGE_SAMPLE]
    return neighborhood_recall(graph[rows], exact_graph_rows(x, rows, k))


def ivf_pq_route(x, q, bi, cidx, p, recalls, totals, peak_floor):
    """CAGRA's IVF-PQ graph pass on all of ``x`` at the path's parameters
    ``p``, as the NN-descent route: ``cagra.build``'s stages one by one
    (the pass's own stages — the IVF-PQ build, K4, the K1 merge, refine —
    timed call by call on the card), the int8 edge store and the fused
    search, its recall beside ``recalls`` (the exact graph's and
    NN-descent's), K4's launches (grouped, once a batch) and the route's
    own peak device memory. → (K1's merge input, K4's input, as the pass
    handed them; the run's peak device memory before the route, which
    resets it: the peak since the last reset, or ``peak_floor``, the
    peak before that reset, when it is higher)."""
    n = x.shape[0]
    exact_s = cidx.build_stats["knn_graph_s"]
    n_lists = max(16, min(1024, int(np.sqrt(n) * 2)))    # build_knn_graph's
    merge_w = max(16, min(64, n_lists // 8)) * PASS_K
    batches = -(-n // CAGRA_BATCH)
    run_peak = max(peak_floor, torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()

    def pq_path():
        info = {}
        with call_events(ivf_pq, "build") as ev_build, \
                call_events(ipq, "ivf_pq_scan_candidates") as ev_k4, \
                call_events(ipq, "kpass_select_k") as ev_k1, \
                call_events(refine, "refine") as ev_refine:
            knn, t_knn = host_time(lambda: cagra.build_knn_graph(
                x, CAGRA_D0, p.metric, p.seed, algo="ivf_pq", info=info))
            stages = {"ivf_pq build": ev_build.ms(), "K4": ev_k4.ms(),
                      "K1 merge": ev_k1.ms(), "refine": ev_refine.ms()}
        graph, t_opt = host_time(lambda: cagra.optimize(knn, CAGRA_DEG))
        seeds, t_seeds = host_time(lambda: cagra.build_covering_seeds(x, p))
        gidx = cagra.Index(x, graph, cidx.metric, seeds)
        _, t_store = host_time(lambda: cagra.prepare_traversal(gidx))
        (_, i), t_first = host_time(lambda: cagra.search(
            gidx, q, K, CAGRA_SP, engine="fused"))
        (d, i), t = host_time(lambda: cagra.search(gidx, q, K, CAGRA_SP,
                                                   engine="fused"))
        return (knn, info, stages, (t_knn, t_opt, t_seeds, t_store, t_first,
                                    t), d, i)

    with captured(ivf_pq, "ivf_pq_scan",
                  lambda *a, **kw: a[8] == PASS_K) as k4_cap, \
            captured(ipq, "kpass_select_k", lambda v, k, *a, **kw: (
                tuple(v.shape) == (CAGRA_BATCH, merge_w)
                and k == PASS_K)) as k1_pass_cap:
        knn, info, stages, ts, pd, pi = run_path(
            "cagra ivf_pq build + fused search",
            ("select_k", "ivf_pq_scan", "ivf_pq_scan.group", "cagra_fused"),
            pq_path, totals)
    phase_peak = torch.cuda.max_memory_allocated()
    moved = counts()
    t_knn, t_opt, t_seeds, t_store, t_first, t = ts
    check_knn("cagra ivf_pq fused", pd, pi, K)
    if (moved["ivf_pq_scan.pair"], moved["ivf_pq_scan.group"]) != (
            0, batches):
        raise AssertionError(f"ivf_pq graph pass: K4 per-pair / grouped "
                             f"launches {moved['ivf_pq_scan.pair']} / "
                             f"{moved['ivf_pq_scan.group']}, expected "
                             f"0 / {batches}")
    if info.get("algo") != "ivf_pq" or len(stages["K4"]) != batches:
        raise AssertionError(f"ivf_pq graph pass: {info}, "
                             f"{len(stages['K4'])} K4 calls")
    if k4_cap.call is None or k1_pass_cap.call is None:
        raise AssertionError(f"ivf_pq graph pass: no K4 call at k={PASS_K} "
                             f"or no K1 merge at {(CAGRA_BATCH, merge_w)}")
    # K1's merges at k = 257 take the warp form (none the radix select)
    if len(stages["K1 merge"]) != batches or moved["select_k.radix"]:
        raise AssertionError(f"ivf_pq graph pass: {len(stages['K1 merge'])} "
                             f"K1 merges, {moved['select_k.radix']} radix "
                             f"launches, expected {batches} and 0")
    # K1 is exact in both forms: the pass gives the same graph with its
    # merges in the radix form (and so the same edge and search recall)
    merge = ipq.kpass_select_k
    ipq.kpass_select_k = lambda v, k, *a, **kw: merge(
        v, k, *a, **{**kw, "form": "radix"})
    try:
        knn_rx, t_rx = host_time(lambda: cagra.build_knn_graph(
            x, CAGRA_D0, p.metric, p.seed, algo="ivf_pq"))
    finally:
        ipq.kpass_select_k = merge
    if not torch.equal(knn, knn_rx):
        raise AssertionError("ivf_pq graph pass: the warp form's graph "
                             "differs from the radix form's")
    del knn_rx
    log(f"cagra ivf_pq graph pass: {batches} K1 merges at k={PASS_K}, all "
        f"in the warp form (select_k.warp {moved['select_k.warp']}, "
        f"select_k.radix 0 on the route); the pass again with its merges "
        f"in the radix form: the same graph, bit for bit "
        f"({t_rx:.3f} s)")
    rec = edge_recall(knn, x, CAGRA_D0, SEED + 1)
    recall = neighborhood_recall(pi, bi)
    per = {name: (statistics.median(v), sum(v)) for name, v in
           stages.items()}
    log(f"cagra ivf_pq build on {n} rows ({n_lists} lists, K4 at k={PASS_K} "
        f"in its grouped form, {batches} batches of {CAGRA_BATCH}): "
        f"knn_graph {t_knn:.3f} s (the exact graph's {exact_s:.3f} s; "
        f"{ROUTE_KNN_STREAMING_S:.2f} s with K4's streaming selection), "
        f"optimize {t_opt:.3f} s, seeds {t_seeds:.3f} s, total "
        f"{t_knn + t_opt + t_seeds:.3f} s; edge store {t_store:.3f} s")
    log("cagra ivf_pq graph pass, the card's time by stage (median a call, "
        "sum): " + ", ".join(f"{name} {med:.2f} ms, {tot / 1e3:.3f} s"
                             for name, (med, tot) in per.items())
        + f"; a batch's K4 candidate buffer ({CAGRA_BATCH}, {merge_w}) "
        f"{CAGRA_BATCH * merge_w * 8 / 1e9:.2f} GB")
    log(f"cagra ivf_pq kNN graph edge recall (k={CAGRA_D0}, {EDGE_SAMPLE} "
        f"sampled rows vs exact): {rec:.4f}")
    log(f"cagra ivf_pq fused search(itopk={ITOPK}): first "
        f"{t_first * 1e3:.1f} ms, steady {t * 1e3:.1f} ms, {M / t:.0f} QPS, "
        f"recall@{K} {recall:.4f} (the exact graph's index: "
        f"{recalls[0]:.4f}, NN-descent's: {recalls[1]:.4f})")
    log(f"cagra ivf_pq route: the phase's own peak device memory "
        f"{phase_peak / 2**30:.2f} GiB (the run's before it "
        f"{run_peak / 2**30:.2f} GiB)")
    if rec < EDGE_MIN_RECALL:
        raise AssertionError(f"ivf_pq graph pass edge recall {rec:.4f} < "
                             f"{EDGE_MIN_RECALL}")
    del knn, pd, pi
    return k1_pass_cap.call, k4_cap.call, run_peak


def graph_route_phase(x, q, bidx, cidx, totals, peak_floor):
    """CAGRA's other graph builders on the path's data. NN-descent at the
    path's parameters (degree 128 → 64): the stages of ``cagra.build``
    one by one (kNN graph, optimize, covering seeds) so the kNN graph's
    edge recall can be read, then the int8 edge store and the fused
    search at itopk 64 beside the exact graph's index. The IVF-PQ pass
    the same way on all the rows (K4 at k = 257 in its grouped form once a
    batch, its stages timed call by call on the card), with the phase's
    own peak device memory. Then ``tune_search`` on the path's index.
    Returns K1's NN-descent and graph-pass merge inputs and K4's
    graph-pass input, each as the path handed it to the kernel, and the
    run's peak device memory before the IVF-PQ route (which resets it;
    ``peak_floor``: the run's peak before an earlier reset)."""
    n = x.shape[0]
    _, bi = brute_force.search(bidx, q, K)
    _, ei = cagra.search(cidx, q, K, CAGRA_SP, engine="fused")
    exact_recall = neighborhood_recall(ei, bi)
    exact_s = cidx.build_stats["knn_graph_s"]
    p = cagra.IndexParams(intermediate_graph_degree=CAGRA_D0,
                          graph_degree=CAGRA_DEG, knn_graph_algo="nn_descent",
                          seed=SEED)
    merge = nnd_merge_shape(n, CAGRA_D0)

    def nnd_path():
        info = {}
        knn, t_knn = host_time(lambda: cagra.build_knn_graph(
            x, CAGRA_D0, p.metric, p.seed, algo=p.knn_graph_algo,
            nnd_rounds=p.nn_descent_niter, info=info))
        graph, t_opt = host_time(lambda: cagra.optimize(knn, CAGRA_DEG))
        seeds, t_seeds = host_time(lambda: cagra.build_covering_seeds(x, p))
        nidx = cagra.Index(x, graph, cidx.metric, seeds)
        _, t_store = host_time(lambda: cagra.prepare_traversal(nidx))
        (_, i), t_first = host_time(lambda: cagra.search(
            nidx, q, K, CAGRA_SP, engine="fused"))
        (d, i), t = host_time(lambda: cagra.search(nidx, q, K, CAGRA_SP,
                                                   engine="fused"))
        return knn, info, (t_knn, t_opt, t_seeds, t_store, t_first, t), d, i

    with captured(nnd, "select_k", lambda v, k, *a, **kw: (
            tuple(v.shape) == merge and k == CAGRA_D0)) as k1_cap:
        knn, info, ts, nd, ni = run_path(
            "cagra nn_descent build + fused search",
            ("select_k", "fused_knn", "cagra_fused"), nnd_path, totals)
    t_knn, t_opt, t_seeds, t_store, t_first, t = ts
    check_knn("cagra nn_descent fused", nd, ni, K)
    rec = edge_recall(knn, x, CAGRA_D0, SEED)
    recall = nnd_recall = neighborhood_recall(ni, bi)
    log(f"cagra nn_descent build: knn_graph {t_knn:.3f} s "
        f"({info['nnd_rounds']} rounds, last update rate "
        f"{info['nnd_update_rate']:.4f}; the exact graph's {exact_s:.3f} s), "
        f"optimize {t_opt:.3f} s, seeds {t_seeds:.3f} s, total "
        f"{t_knn + t_opt + t_seeds:.3f} s; edge store {t_store:.3f} s")
    log(f"cagra nn_descent kNN graph edge recall (k={CAGRA_D0}, "
        f"{EDGE_SAMPLE} sampled rows vs exact): {rec:.4f}")
    log(f"cagra nn_descent fused search(itopk={ITOPK}): first "
        f"{t_first * 1e3:.1f} ms, steady {t * 1e3:.1f} ms, {M / t:.0f} QPS, "
        f"recall@{K} {recall:.4f} (the exact graph's index: "
        f"{exact_recall:.4f})")
    if rec < EDGE_MIN_RECALL:
        raise AssertionError(f"nn_descent edge recall {rec:.4f} < "
                             f"{EDGE_MIN_RECALL}")
    if k1_cap.call is None:
        raise AssertionError(f"nn_descent: no K1 merge at {merge}")
    del knn, nd, ni

    k1_pass, k4_call, run_peak = ivf_pq_route(
        x, q, bi, cidx, p, (exact_recall, nnd_recall), totals, peak_floor)

    # the race on the path's index (a copy of its handle: a gather win
    # drops the copy's store, and the kernel phases read the path's)
    tidx = dataclasses.replace(cidx)
    (winner, times), t_race = run_path(
        "cagra tune_search", ("graph_expand", "cagra_fused", "select_k"),
        lambda: host_time(lambda: cagra.tune_search(tidx, q, K, CAGRA_SP)),
        totals)
    race = ", ".join(f"{e} {v * 1e3:.2f} ms" for e, v in times.items())
    log(f"cagra tune_search (itopk={ITOPK}, {M} queries, {t_race:.2f} s): "
        f"{winner} wins ({race})")
    if winner != "fused":
        log(f"cagra tune_search: the fused engine did not win: its median "
            f"{times.get('fused', float('nan')) * 1e3:.2f} ms against "
            f"{winner}'s {times[winner] * 1e3:.2f} ms")
    if cagra.resolve_engine(tidx, M, K, CAGRA_SP) != winner:
        raise AssertionError("cagra: engine='auto' does not follow the "
                             "race")
    del tidx
    return k1_cap.call, k1_pass, k4_call, run_peak


def bench_phase(totals, dev):
    """The bench harness at 1M x 128 (``BENCH_SPEC``): data and ground
    truth (k = 100, the port's brute force) made on the card, then
    ``bench.run_benchmarks`` over the four families at the JAX harness's
    default sweeps, its Google-Benchmark JSON written under
    ``BENCH_OUT``. Prints each point and each family's best QPS at
    recall@10 >= BENCH_TARGET. The CAGRA case races the kNN-graph
    builders first (``race_graph_build``, all three at the build's own
    shape; K1's NN-descent merge is taken from the race's NN-descent
    build) and builds on the verdict: each builder's seconds and edge
    recall, the verdict and the cell's build are printed, the verdict
    held to the race's rule and the build to the verdict. Returns K1's
    NN-descent merge input and K6's input at itopk 256, as the path
    handed them to the kernels, and the CAGRA cell's shape and verdicts
    (for :func:`entry_phase`'s child process)."""
    (base, queries, _, metric), t_data = host_time(
        lambda: bench.load_dataset(BENCH_SPEC, n_queries=BENCH_QUERIES,
                                   device=dev))
    (_, gt), t_gt = host_time(lambda: bench.generate_groundtruth(
        base, queries, BENCH_GT_K, metric, device=dev))
    log(f"bench: {BENCH_SPEC} + {BENCH_QUERIES} queries made in "
        f"{t_data:.2f} s, ground truth (k={BENCH_GT_K}) in {t_gt:.2f} s")
    deg = inspect.signature(bench.default_configs).parameters[
        "cagra_degree"].default
    merge = nnd_merge_shape(base.shape[0], 2 * deg)
    with captured(nnd, "select_k", lambda v, k, *a, **kw: (
            tuple(v.shape) == merge and k == 2 * deg)) as k1_cap, \
            captured(cagra, "fused_traverse",
                     lambda *a, **kw: kw["itopk"] == 256) as k6_cap, \
            outputs(cagra, "build",
                    lambda idx: dict(idx.build_stats)) as built, \
            engine_runs() as timed:
        results = run_path(
            "bench", ("select_k", "fused_knn", "ivf_flat_scan",
                      "ivf_pq_scan", "graph_expand", "cagra_fused"),
            lambda: bench.run_benchmarks(base, queries, gt, k=K,
                                         metric=metric, reps=BENCH_REPS,
                                         verbose=False, device=dev), totals)
    from raft_tpu_torch.bench.runner import to_gbench_json

    out = f"{BENCH_OUT}/{BENCH_SPEC}.bench.json"
    os.makedirs(BENCH_OUT, exist_ok=True)
    with open(out, "w") as f:
        f.write(to_gbench_json(results, {
            "dataset": BENCH_SPEC, "executable": "chip_smoke.py",
            "device_name": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi_line()}))
    by_algo = {}
    for r in results:
        by_algo.setdefault(r.algo, []).append(r)
        race = "".join(f", race {e[5:-3]} {v:.2f} ms"
                       for e, v in r.extra.items()
                       if e.startswith("race_") and e.endswith("_ms"))
        eng = f", engine {r.extra['engine']}" if "engine" in r.extra else ""
        log(f"bench {r.name}: {r.qps:.0f} QPS, recall@{K} {r.recall:.4f}, "
            f"build {r.build_time:.2f} s{eng}{race}")
    for algo, rs in by_algo.items():
        hit = [r for r in rs if r.recall >= BENCH_TARGET]
        if hit:
            b = max(hit, key=lambda r: r.qps)
            log(f"bench {algo}: best QPS at recall@{K} >= {BENCH_TARGET}: "
                f"{b.qps:.0f} ({b.name}, recall {b.recall:.4f})")
        else:
            b = max(rs, key=lambda r: r.recall)
            log(f"bench {algo}: no point reached recall@{K} {BENCH_TARGET}; "
                f"highest {b.recall:.4f} at {b.qps:.0f} QPS ({b.name})")
    # what holds by construction: exact search is exact, wider probes
    # find no fewer neighbors, auto runs the race's fastest engine, and
    # the timed searches ran that engine's kernel
    bf = by_algo["raft_brute_force"][0]
    if bf.recall != 1.0:
        raise AssertionError(f"bench brute force recall {bf.recall}")
    for algo in ("raft_ivf_flat", "raft_ivf_pq"):
        rs = sorted(by_algo[algo], key=lambda r: r.search_params["n_probes"])
        for a, b in zip(rs, rs[1:]):
            if b.recall < a.recall - 0.005:
                raise AssertionError(f"bench {algo}: recall falls from "
                                     f"{a.name} to {b.name}")
    want = {"fused": (True, False), "edge": (False, True),
            "gather": (False, False)}
    cell = graph_race_check(by_algo["raft_cagra"], built.kept)
    for r in by_algo["raft_cagra"]:
        race = {e[5:-3]: v for e, v in r.extra.items()
                if e.startswith("race_") and e.endswith("_ms")}
        if r.extra["engine"] != min(race, key=race.get):
            raise AssertionError(f"bench {r.name}: engine "
                                 f"{r.extra['engine']} is not the race's "
                                 f"fastest {race}")
        runs = timed.runs.get(r.search_params["itopk"], [])
        ran = {(f > 0, e > 0) for f, e in runs}
        log(f"bench {r.name}: {len(runs)} searches with engine auto, "
            f"(K6, K5) launches {sorted(set(runs))}")
        if not runs or ran != {want[r.extra["engine"]]}:
            raise AssertionError(f"bench {r.name}: the race chose "
                                 f"{r.extra['engine']}, but the timed "
                                 f"searches launched (K6, K5) {runs}")
    if k1_cap.call is None or k6_cap.call is None:
        raise AssertionError("bench: the CAGRA case's K1 merge or K6 at "
                             "itopk 256 was not reached")
    log(f"bench: wrote {out}")
    bench_store_run(base, queries, gt, metric, totals, dev)
    cell.update(n=base.shape[0], d=base.shape[1], metric=metric, k=K,
                m=queries.shape[0], degree=deg, k0=2 * deg)
    return k1_cap.call, k6_cap.call, cell


def graph_race_check(results, builds) -> dict:
    """The bench CAGRA cell's graph race, from its entries: each builder's
    seconds and edge recall and the verdict, printed; the verdict must be
    the race's rule applied to the race's own readings, and the cell's
    build (``builds``: its ``build_stats``) must have run the verdict's
    builder. Then the cell's build seconds without the race and its best
    QPS at recall@10 >= BENCH_TARGET (or its highest recall). → the
    verdict and each itopk point's engine."""
    extra = results[0].extra
    secs = {e[5:-2]: v for e, v in extra.items()
            if e.startswith("race_") and e.endswith("_s")}
    recalls = {b: extra[f"edge_recall_{b}"] for b in secs}
    verdict = extra["graph_algo"]
    log("bench raft_cagra graph race: " + ", ".join(
            f"{b} {t:.3f} s, edge recall {recalls[b]:.4f}"
            for b, t in secs.items()) + f" -> {verdict}")
    rule = bench.graph_race_winner(secs, recalls)
    if verdict != rule or set(secs) != {"brute", "ivf_pq", "nn_descent"}:
        raise AssertionError(f"bench graph race: verdict {verdict}, the "
                             f"rule gives {rule} ({secs}, {recalls})")
    if len(builds) != 1 or builds[0]["knn_algo"] != verdict:
        raise AssertionError(f"bench raft_cagra: the cell's builds ran "
                             f"{builds}, the race chose {verdict}")
    hit = [r for r in results if r.recall >= BENCH_TARGET]
    best = (f"best QPS at recall@{K} >= {BENCH_TARGET}: "
            f"{max(hit, key=lambda r: r.qps).qps:.0f}" if hit else
            f"no point at recall@{K} {BENCH_TARGET}, highest "
            f"{max(r.recall for r in results):.4f}")
    log(f"bench raft_cagra on the {verdict} graph: build "
        f"{results[0].build_time:.2f} s without the race (kNN graph "
        f"{builds[0]['knn_graph_s']:.2f} s, optimize "
        f"{builds[0]['optimize_s']:.2f} s, seeds "
        f"{builds[0]['seeds_s']:.2f} s); {best}")
    return dict(graph_algo=verdict, engines={
        r.search_params["itopk"]: r.extra["engine"] for r in results})


def bench_store_run(base, queries, gt, metric, totals, dev) -> None:
    """The bench with ``--dtype`` BENCH_STORE for brute force and IVF-Flat
    on the same data and ground truth: each point's QPS and recall@10, the
    best QPS at recall@10 >= BENCH_TARGET a family; IVF recall
    non-decreasing in n_probes (0.005); no
    plain version runs, and every K2 / K3 launch is the store's form (the
    store's recall is printed, not held: its quantization, not the port,
    sets it)."""
    algos = ("raft_brute_force", "raft_ivf_flat")
    with no_plain():
        results = run_path(
            f"bench.{BENCH_STORE}",
            ("fused_knn", f"fused_knn.{BENCH_STORE}", "ivf_flat_scan",
             f"ivf_flat_scan.{BENCH_STORE}"),
            lambda: bench.run_benchmarks(base, queries, gt, k=K,
                                         metric=metric, algos=algos,
                                         reps=BENCH_REPS, verbose=False,
                                         dtype=BENCH_STORE, device=dev),
            totals)
    moved = counts()
    for kern in ("fused_knn", "ivf_flat_scan"):
        if moved[kern] != moved[f"{kern}.{BENCH_STORE}"]:
            raise AssertionError(f"bench.{BENCH_STORE}: {kern} launched "
                                 "other forms than the store's")
    from raft_tpu_torch.bench.runner import to_gbench_json

    out = f"{BENCH_OUT}/{BENCH_SPEC}.{BENCH_STORE}.bench.json"
    with open(out, "w") as f:
        f.write(to_gbench_json(results, {
            "dataset": BENCH_SPEC, "dtype": BENCH_STORE,
            "executable": "chip_smoke.py",
            "device_name": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi_line()}))
    by_algo = {}
    for r in results:
        by_algo.setdefault(r.algo, []).append(r)
        log(f"bench {r.name}: {r.qps:.0f} QPS, recall@{K} {r.recall:.4f}, "
            f"build {r.build_time:.2f} s")
    for algo, rs in by_algo.items():
        hit = [r for r in rs if r.recall >= BENCH_TARGET]
        if hit:
            b = max(hit, key=lambda r: r.qps)
            log(f"bench {algo} ({BENCH_STORE}): best QPS at recall@{K} >= "
                f"{BENCH_TARGET}: {b.qps:.0f} ({b.name}, recall "
                f"{b.recall:.4f})")
        else:
            b = max(rs, key=lambda r: r.recall)
            log(f"bench {algo} ({BENCH_STORE}): no point reached recall@{K} "
                f"{BENCH_TARGET}; highest {b.recall:.4f} at {b.qps:.0f} QPS")
    rs = sorted(by_algo["raft_ivf_flat"],
                key=lambda r: r.search_params["n_probes"])
    for a, b in zip(rs, rs[1:]):
        if b.recall < a.recall - 0.005:
            raise AssertionError(f"bench: recall falls from {a.name} to "
                                 f"{b.name}")
    log(f"bench: wrote {out}")


# the entry-point phase: chunked and deadline searches, health,
# make_searcher, and the verdict file read by a fresh process
CAGRA_CHUNK = 1024           # CAGRA's deadline chunk (cagra.DEADLINE_CHUNK)
DEADLINE_CHUNK_ROWS = 2500   # brute force and IVF-Flat under a deadline
DEADLINE_CHUNKS_DONE = 2     # the deadline expires after this many chunks
CHUNK_RECALL_GAP = 0.01


class StepClock:
    """A clock for ``Deadline``: it reads 0 for its first ``reads`` reads
    and 1e9 after them. A Deadline reads it once when it is made and once
    a checkpoint, so ``reads`` = chunks + 1 expires it at the checkpoint
    before chunk ``chunks``."""

    def __init__(self, reads: int):
        self.left = reads

    def __call__(self) -> float:
        self.left -= 1
        return 0.0 if self.left >= 0 else 1e9


# the child process: the verdict file read afresh, the race's graph
# verdict and the bench cell's engine verdicts found in it and followed
VERDICT_CHILD = r"""
import json, sys
import torch
from raft_tpu_torch.distance.distance_types import canonical_metric
from raft_tpu_torch.neighbors import cagra
from raft_tpu_torch.ops import autotune
want = json.loads(sys.argv[1])
with open(autotune.cache_path()) as f:
    disk = json.load(f)
dev = torch.device("cuda", 0)
mt = canonical_metric(want["metric"])
n, d, deg = want["n"], want["d"], want["degree"]
gkey = cagra._graph_algo_key(n, d, want["k0"], mt, dev)
auto = cagra._resolve_graph_algo(n, d, want["k0"], "auto", mt, dev)
assert disk.get(gkey) == auto == want["graph_algo"], (gkey, disk.get(gkey),
                                                      auto)
# an index of the cell's shape (rows expanded from one: no memory) with an
# int8 edge store attached, as the cell's searches had
row = torch.zeros((1, d), device=dev)
idx = cagra.Index(row.expand(n, d), torch.zeros(
    (1, deg), dtype=torch.int32, device=dev).expand(n, deg), mt)
one = torch.zeros((1, 1, 1), device=dev)
idx.edge_store = cagra.EdgeStore("int8", deg, deg, d, one.to(torch.int8),
                                 one, one.to(torch.int32))
got = {}
for itopk, eng in want["engines"].items():
    sp = cagra.SearchParams(itopk_size=int(itopk))
    key = cagra._tune_key(idx, want["m"], want["k"], sp, idx.edge_store)
    got[itopk] = cagra.resolve_engine(idx, want["m"], want["k"], sp)
    assert disk.get(key) == got[itopk] == eng, (key, disk.get(key), eng)
print(json.dumps({"verdicts": len(disk), "graph_algo": auto,
                  "engines": got}))
"""


def entry_phase(x, q, bidx, iidx, pidx, cidx, cell, totals):
    """The entry points that share the chunk loop, on the path's indexes:
    ``cagra.health`` (its unreachable nodes against a count taken on the
    graph); a CAGRA search at ``query_chunk`` = :data:`CAGRA_CHUNK`
    (recall within :data:`CHUNK_RECALL_GAP` of the unchunked search);
    brute force and IVF-Flat at ``query_chunk`` =
    :data:`DEADLINE_CHUNK_ROWS` under a Deadline whose clock expires after
    :data:`DEADLINE_CHUNKS_DONE` chunks (``DeadlineExceeded``, its partial
    results the unchunked search's rows bit for bit); an expired deadline
    on each family (no partial result, no kernel launched);
    ``make_searcher`` of each family equal to ``search`` bit for bit; and
    a child process that reads the verdict file afresh and follows the
    bench cell's graph race and engine races (``cell``)."""
    from raft_tpu_torch.core.deadline import Deadline, DeadlineExceeded

    # health: connectivity against a count taken on the graph itself
    rep, t = host_time(lambda: cagra.health(cidx))
    indeg = torch.bincount(cidx.graph.reshape(-1).long(), minlength=N)
    direct = int((indeg == 0).sum())
    log(f"cagra health ({t:.3f} s): {json.dumps(rep)}")
    if rep["unreachable_nodes"] != direct or rep["n"] != N:
        raise AssertionError(f"cagra health: unreachable "
                             f"{rep['unreachable_nodes']}, the graph's "
                             f"in-degrees give {direct}")
    del indeg

    # CAGRA in chunks: its own seed rows a chunk, recall as one batch's
    _, bi = brute_force.search(bidx, q, K)
    (_, ui), t_one = host_time(lambda: cagra.search(
        cidx, q, K, CAGRA_SP, engine="fused"))
    (_, ci), t_chunk = run_path(
        f"cagra fused search, query_chunk={CAGRA_CHUNK}",
        ("cagra_fused", "select_k"), lambda: host_time(lambda: cagra.search(
            cidx, q, K, CAGRA_SP, engine="fused", query_chunk=CAGRA_CHUNK)),
        totals)
    chunks = -(-M // CAGRA_CHUNK)
    r_one, r_chunk = (neighborhood_recall(ui, bi),
                      neighborhood_recall(ci, bi))
    log(f"cagra fused search in {chunks} chunks of {CAGRA_CHUNK}: "
        f"{t_chunk * 1e3:.1f} ms, recall@{K} {r_chunk:.4f} (one batch "
        f"{t_one * 1e3:.1f} ms, {r_one:.4f}); K6 launches "
        f"{counts()['cagra_fused']}")
    if abs(r_chunk - r_one) > CHUNK_RECALL_GAP or \
            counts()["cagra_fused"] != chunks:
        raise AssertionError(f"cagra chunked: recall {r_chunk:.4f} against "
                             f"{r_one:.4f}, {counts()['cagra_fused']} K6 "
                             f"launches for {chunks} chunks")
    del ui, ci

    # deadlines that expire after two chunks: the partial results are the
    # unchunked search's rows of those chunks, bit for bit
    sp_flat = ivf_flat.SearchParams(n_probes=N_PROBES)
    done = DEADLINE_CHUNKS_DONE * DEADLINE_CHUNK_ROWS
    for name, kern, search in (
            ("brute force", "fused_knn",
             lambda **kw: brute_force.search(bidx, q, K, **kw)),
            ("ivf_flat", "ivf_flat_scan",
             lambda **kw: ivf_flat.search(iidx, q, K, sp_flat, **kw))):
        whole = search()
        dl = Deadline(1.0, clock=StepClock(DEADLINE_CHUNKS_DONE + 1))

        def timed():
            try:
                search(query_chunk=DEADLINE_CHUNK_ROWS, res=dl)
            except DeadlineExceeded as e:
                return e
            raise AssertionError(f"{name}: the deadline did not fire")

        err = run_path(f"{name} under a deadline", (kern,), timed, totals)
        launched = counts()[kern]
        log(f"{name} under a deadline (chunks of {DEADLINE_CHUNK_ROWS}, "
            f"expired after {DEADLINE_CHUNKS_DONE}): {err}; {kern} "
            f"launches {launched}")
        if err.partial is None or launched != DEADLINE_CHUNKS_DONE:
            raise AssertionError(f"{name}: partial {err.partial}, "
                                 f"{launched} launches")
        check_bits((whole[0][:done], whole[1][:done]), err.partial,
                   f"{name}: the partial results against the unchunked "
                   f"search's first {done} rows")
        del whole, err

    # an expired deadline: nothing launched, nothing attached
    sp_pq = ivf_pq.SearchParams(n_probes=N_PROBES)
    searches = {
        "brute_force": (lambda **kw: brute_force.search(bidx, q, K, **kw),
                        brute_force.make_searcher(bidx)),
        "ivf_flat": (lambda **kw: ivf_flat.search(iidx, q, K, sp_flat, **kw),
                     ivf_flat.make_searcher(iidx, sp_flat)),
        "ivf_pq": (lambda **kw: ivf_pq.search(pidx, q, K, sp_pq, **kw),
                   ivf_pq.make_searcher(pidx, sp_pq)),
        "cagra": (lambda **kw: cagra.search(cidx, q, K, CAGRA_SP,
                                            engine="fused", **kw),
                  cagra.make_searcher(cidx, CAGRA_SP, engine="fused"))}
    for name, (search, _) in searches.items():
        reset_counts()
        try:
            search(res=Deadline(0.0))
            raise AssertionError(f"{name}: an expired deadline did not "
                                 "raise")
        except DeadlineExceeded as e:
            moved = {kk: v for kk, v in counts().items() if v}
            if e.partial is not None or moved:
                raise AssertionError(f"{name}: an expired deadline gave "
                                     f"{e.partial}, launches {moved}")
    log("expired deadlines: brute force, IVF-Flat, IVF-PQ and CAGRA raise "
        "before any launch, no partial result")

    # make_searcher: its fn is search with the options frozen
    for name, (search, fn) in searches.items():
        check_bits(search(), fn(q, K), f"{name} make_searcher's fn "
                   "against search")

    # a fresh process follows the verdicts this run recorded
    child = subprocess.run(
        [sys.executable, "-c", VERDICT_CHILD, json.dumps(cell)],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if child.returncode != 0:
        raise AssertionError(f"verdict child process failed: "
                             f"{child.stderr[-4000:]}")
    log(f"verdict file {os.environ['RAFT_TPU_TORCH_AUTOTUNE_CACHE']} read "
        f"by a fresh process: {child.stdout.strip()}")


# the serialize phase's child: the four files loaded onto the card in a
# fresh process and searched with explicit engines, every launch counter
# of K1-K6 read after
SERIAL_CHILD = r"""
import json, os, sys, time
import numpy as np
import torch
from raft_tpu_torch.matrix import select_k as sk
from raft_tpu_torch.neighbors import (brute_force, cagra, ivf_flat, ivf_pq,
                                      refine)
from raft_tpu_torch.ops import cagra_fused as cf
from raft_tpu_torch.ops import filter_policy
from raft_tpu_torch.ops import fused_knn as fk
from raft_tpu_torch.ops import graph_expand as ge
from raft_tpu_torch.ops import ivf_pq_scan as ipq
from raft_tpu_torch.ops import ivf_scan as iscan
d, spec = sys.argv[1], json.loads(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
counters = {"select_k": sk, "fused_knn": fk, "ivf_flat_scan": iscan,
            "ivf_pq_scan": ipq, "graph_expand": ge, "cagra_fused": cf}
for mod in counters.values():
    mod.launches = 0
dev = torch.device("cuda", 0)
q = torch.from_numpy(np.load(os.path.join(d, "queries.npy"))).to(dev)
load_s, idx = {}, {}
for name, mod in (("brute_force", brute_force), ("ivf_flat", ivf_flat),
                  ("ivf_pq", ivf_pq), ("cagra", cagra)):
    t0 = time.perf_counter()
    idx[name] = mod.load(os.path.join(d, name + ".idx"))
    torch.cuda.synchronize()
    load_s[name] = time.perf_counter() - t0
k, k0, probes = spec["k"], spec["k0"], spec["n_probes"]
out = {"brute_force": brute_force.search(idx["brute_force"], q, k),
       "ivf_flat": ivf_flat.search(idx["ivf_flat"], q, k,
                                   ivf_flat.SearchParams(n_probes=probes))}
pv, pi = ivf_pq.search(idx["ivf_pq"], q, k0,
                       ivf_pq.SearchParams(n_probes=probes))
out["ivf_pq"] = (pv, pi)
out["ivf_pq_refined"] = refine.refine(idx["brute_force"].dataset, q, pi, k)
sp = cagra.SearchParams(itopk_size=spec["itopk"], search_width=1)
for eng in ("edge", "fused"):
    out["cagra_" + eng] = cagra.search(idx["cagra"], q, k, sp, engine=eng)
torch.cuda.synchronize()
for name, (v, i) in out.items():
    np.save(os.path.join(d, name + ".values.npy"), v.cpu().numpy())
    np.save(os.path.join(d, name + ".ids.npy"), i.cpu().numpy())
print(json.dumps({"load_s": load_s, "launches": {
    name: mod.launches for name, mod in counters.items()}}))
"""


def flip_in_section(path: str, name: str, at: int) -> None:
    """Flip one byte ``at`` bytes into the npy frame of array ``name`` of
    a RAFTTPU2 file (past its name frame and 8-byte length)."""
    with open(path, "rb") as f:
        blob = f.read()
    frame = len(name).to_bytes(2, "little") + name.encode()
    pos = blob.find(frame)
    if pos < 0 or blob.find(frame, pos + 1) >= 0:
        raise AssertionError(f"{path}: no single {name!r} section")
    pos += len(frame) + 8 + at
    with open(path, "r+b") as f:
        f.seek(pos)
        f.write(bytes([blob[pos] ^ 0x5A]))


def serialize_phase(bidx, iidx, pidx, cidx, q) -> None:
    """The path's four indexes saved and loaded in a fresh process, which
    searches them through K1-K6, bit-equal to the in-memory searches; the
    IVF-Flat, IVF-PQ and CAGRA indexes through RAFT-native files, the
    same; a flipped byte in the IVF-PQ file's codes caught."""
    sp_flat = ivf_flat.SearchParams(n_probes=N_PROBES)
    sp_pq = ivf_pq.SearchParams(n_probes=N_PROBES)
    pv, pi = ivf_pq.search(pidx, q, K0, sp_pq)
    want = {"brute_force": brute_force.search(bidx, q, K),
            "ivf_flat": ivf_flat.search(iidx, q, K, sp_flat),
            "ivf_pq": (pv, pi),
            "ivf_pq_refined": refine.refine(bidx.dataset, q, pi, K),
            **{f"cagra_{eng}": cagra.search(cidx, q, K, CAGRA_SP,
                                            engine=eng)
               for eng in ("edge", "fused")}}
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="serialize-",
                                     dir=os.path.abspath("build")) as d:
        np.save(os.path.join(d, "queries.npy"), q.cpu().numpy())
        for name, mod, idx in (("brute_force", brute_force, bidx),
                               ("ivf_flat", ivf_flat, iidx),
                               ("ivf_pq", ivf_pq, pidx),
                               ("cagra", cagra, cidx)):
            path = os.path.join(d, f"{name}.idx")
            _, t = host_time(lambda: mod.save(idx, path))
            log(f"serialize: {name} saved, {os.path.getsize(path) / 2**20:.1f}"
                f" MiB in {t:.3f} s")
        torch.cuda.empty_cache()
        log(f"serialize: card memory before the child: {card_memory()}")
        spec = {"k": K, "k0": K0, "n_probes": N_PROBES, "itopk": ITOPK}
        child, t_child = host_time(lambda: subprocess.run(
            [sys.executable, "-c", SERIAL_CHILD, d, json.dumps(spec)],
            capture_output=True, text=True, timeout=900,
            cwd=os.path.dirname(os.path.abspath(__file__))))
        if child.returncode != 0:
            raise AssertionError(f"serialize child process failed: "
                                 f"{child.stderr[-4000:]}")
        got = json.loads(child.stdout.strip().splitlines()[-1])
        log(f"serialize: a fresh process ({t_child:.1f} s in all) loaded "
            "the files (warm in the page cache) in "
            + ", ".join(f"{n} {s:.3f} s" for n, s in got["load_s"].items())
            + f"; launches {json.dumps(got['launches'])}")
        missed = [n for n, c in got["launches"].items() if c == 0]
        if missed:
            raise AssertionError(f"serialize child: {missed} not launched")
        dev = q.device
        for name, ref in want.items():
            back = tuple(torch.from_numpy(np.load(os.path.join(
                d, f"{name}.{part}.npy"))).to(dev)
                for part in ("values", "ids"))
            check_bits(ref, back, f"serialize: {name} loaded in a fresh "
                       "process against the in-memory index")

        # RAFT-native files: IVF-Flat, IVF-PQ, CAGRA (which keeps no seeds)
        noseed = dataclasses.replace(cidx, seed_nodes=None, health_conn=None)
        for name, idx, save, load, search in (
                ("ivf_flat", iidx, raft_format.save_raft_ivf_flat,
                 raft_format.load_raft_ivf_flat,
                 lambda i: ivf_flat.search(i, q, K, sp_flat)),
                ("ivf_pq", pidx, raft_format.save_raft_ivf_pq,
                 raft_format.load_raft_ivf_pq,
                 lambda i: ivf_pq.search(i, q, K0, sp_pq)),
                ("cagra", noseed, raft_format.save_raft_cagra,
                 raft_format.load_raft_cagra,
                 lambda i: cagra.search(i, q, K, CAGRA_SP,
                                        engine="fused"))):
            path = os.path.join(d, f"{name}.raft")
            _, t_save = host_time(lambda: save(idx, path))
            loaded, t_load = host_time(lambda: load(path))
            log(f"serialize: {name} RAFT file "
                f"{os.path.getsize(path) / 2**20:.1f} MiB, saved in "
                f"{t_save:.3f} s, loaded in {t_load:.3f} s")
            check_bits(search(idx), search(loaded),
                       f"serialize: {name} from a RAFT file against the "
                       "in-memory index")
            del loaded
            os.remove(path)

        path = os.path.join(d, "ivf_pq.idx")
        flip_in_section(path, "codes", 4096)
        try:
            ivf_pq.load(path)
        except CorruptIndexError as e:
            if e.section != "codes":
                raise AssertionError(f"serialize: a flipped codes byte "
                                     f"reported as section {e.section!r}")
            log(f"serialize: a flipped byte in the codes section: {e}")
        else:
            raise AssertionError("serialize: a flipped codes byte loaded")


def int_lists(p, k, seed):
    """p >= 3 shards' (M, k) integer-valued lists on the card: sorted rows,
    shard 1 a copy of shard 0's values (cross-shard ties), shard 2 dead
    (+inf, -1)."""
    rng = np.random.default_rng(seed)
    d = np.sort(rng.integers(0, 40, (p, M, k)), axis=-1).astype(np.float32)
    d[1] = d[0]
    gid = rng.integers(0, N, (p, M, k)).astype(np.int32)
    d[2], gid[2] = np.inf, -1
    return ([torch.from_numpy(d[r]).cuda() for r in range(p)],
            [torch.from_numpy(gid[r]).cuda() for r in range(p)])


K7_LIST_K = 256   # K7's inputs: the shards' lists up to it


def k7_lists(x, sidx, q, k):
    """Shard 0's hop-0 fold at k on the path's data: its own list, then
    shard p−1's block at positions (p−1)·k + j. Up to :data:`K7_LIST_K`
    the shards' candidate lists; above it each shard's exact distances to
    its first k rows (the path's data, unsorted)."""
    p = sidx.n_shards
    slot = torch.arange(k, dtype=torch.int32, device=q.device).repeat(M, 1)
    if k <= K7_LIST_K:
        ds, gs = sharded_knn.shard_candidates(sidx, q, k)
        d0, g0, d1, g1 = ds[0], gs[0], ds[-1], gs[-1]
    else:
        qn = (q * q).sum(1)

        def rows(r):
            ids = torch.arange(r * sidx.shard_rows, r * sidx.shard_rows + k,
                               device=q.device)
            xr = x[ids]
            d = (qn[:, None] + (xr * xr).sum(1)[None, :]
                 - 2.0 * (q @ xr.T)).contiguous()
            return d, ids.int().repeat(M, 1)

        (d0, g0), (d1, g1) = rows(0), rows(p - 1)
    return (d0, slot, g0, d1, (p - 1) * k + slot, g1)


def odd_int_lists(k, seed):
    """Two unsorted (M, k) integer-valued lists with ties inside and across
    them, -0.0 against 0.0, NaN and ±inf cells; the ring's positions."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 40, (2, M, k)).astype(np.float32)
    d[d == 0] = np.where(rng.random(int((d == 0).sum())) < 0.5, 0.0, -0.0)
    for v, share in ((np.nan, 0.05), (np.inf, 0.03), (-np.inf, 0.02)):
        d[rng.random(d.shape) < share] = v
    gid = rng.integers(0, N, (2, M, k)).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    slot = torch.arange(k, dtype=torch.int32, device="cuda").repeat(M, 1)
    return (t(d[0]), slot, t(gid[0]), t(d[1]), k + slot, t(gid[1]))


def k7_phase(timer, x, sidx, q, launches):
    """K7 on shard 0's hop-0 fold of the path's data (:func:`k7_lists`) at
    the path's k, at RING_K and at k = 300 (past K8's register forms),
    and on unsorted integer-valued lists with ties, NaN, ±inf and -0.0,
    both directions, against merge_step_plain bit for bit; timed beside
    the plain version and torch.topk of the concatenation."""
    out = {}
    for k in K7_KS:
        args = k7_lists(x, sidx, q, k)
        err = check_equal(rt.merge_step_plain(*args, k),
                          rt.merge_step(*args, k),
                          f"K7 merge_step ({M}, {k}) + ({M}, {k}) -> k={k}, "
                          "the path's data")
        odd = odd_int_lists(k, SEED + 7 + k)
        for sel in (True, False):
            a = odd if sel else (-odd[0],) + odd[1:3] + (-odd[3],) + odd[4:]
            check_bits(rt.merge_step_plain(*a, k, sel),
                       rt.merge_step(*a, k, sel),
                       f"K7 merge_step integer-valued, unsorted, ties, NaN, "
                       f"±inf, -0.0, select_min={sel} (k={k})")
        del odd
        cat = torch.cat([args[0], args[3]], dim=1)
        ms = timer(lambda: rt.merge_step(*args, k))
        dev = device_ms(lambda: rt.merge_step(*args, k))
        plain = timer(lambda: rt.merge_step_plain(*args, k))
        lib = timer(lambda: torch.topk(cat, k, dim=1, largest=False))
        w = 2 * k
        # 12 B a cell in and out; at least one compare a cell in
        b, by = bound(M * w * 12 + M * k * 12, 0.0, float(M) * w)
        out[k] = dict(err=err, ms=ms, dev=dev, plain=plain, lib=lib, bound=b,
                      by=by)
        log(f"  K7 at k={k}: {ms:.4f} ms (the kernel alone {dev:.4f}; plain "
            f"{plain:.3f}, torch.topk {lib:.4f}, bound {b:.4f} by {by})")
    r = out[K]
    return dict(name="merge_step", route="cuda",
                source="raft_tpu_torch/csrc/ring_topk.cu",
                replaces="raft_tpu/ops/ring_topk.py:320", launches=launches,
                max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain"],
                bound_ms=r["bound"], bound_by=r["by"], library_ms=r["lib"],
                device_ms=r["dev"],
                **{f"k{k}_{key}": out[k][key2] for k in K7_KS if k != K
                   for key, key2 in (("ms", "ms"), ("device_ms", "dev"),
                                     ("plain_ms", "plain"),
                                     ("library_ms", "lib"),
                                     ("bound_ms", "bound"))},
                shape=f"({M}, {K}) + ({M}, {K}) -> k={K}")


def k8_phase(timer, x, sidx, q, launches):
    """K8 over the path's candidates at p = 4 and over 8- and 16-shard
    splits of the same corpus, at the path's k and at k = RING_K (p = 16:
    the path's k); on integer-valued lists with ties and a dead shard; and
    at m = 1 and 100, fewer rows than the ring has blocks."""
    out = {}
    for p, ks in ((P_SHARDS, (K, RING_K)), (8, (K, RING_K)), (16, (K,))):
        idx = sidx if p == P_SHARDS else sharded_knn.build(
            x, Mesh([torch.device("cuda", 0)] * p))
        mesh = idx.mesh
        for k in ks:
            ds, gs = sharded_knn.shard_candidates(idx, q, k)
            err = k8_check(ds, gs, k, mesh, f"p={p} ({M}, {k}), the path's "
                           "candidates")
            di, gi = int_lists(p, k, SEED + 8)
            for sel in (True, False):
                k8_check(di if sel else [-d for d in di], gi, k, mesh,
                         f"p={p} integer-valued, ties and a dead shard, "
                         f"select_min={sel} (k={k})", sel)
            del di, gi
            out[p, k] = k8_time(timer, ds, gs, k, mesh)
            out[p, k]["err"] = err
            log(f"  K8 at p={p}, k={k}: {out[p, k]['ms']:.4f} ms (the kernel "
                f"alone {out[p, k]['dev']:.4f}; plain "
                f"{out[p, k]['plain']:.3f}, torch.topk {out[p, k]['lib']:.4f}"
                f", bound {out[p, k]['bound']:.4f} by {out[p, k]['by']})")
            if p == P_SHARDS and k == K:
                # fewer rows than ring blocks: one row a block, or one
                # block a shard
                for m in (1, 100):
                    dm = [d[:m].contiguous() for d in ds]
                    gm = [g[:m].contiguous() for g in gs]
                    k8_check(dm, gm, k, mesh, f"p={p} ({m}, {k}), the "
                             "path's first rows")
                    out[p, k, m] = k8_time(timer, dm, gm, k, mesh)
                    log(f"  K8 at p={p}, k={k}, m={m}: "
                        f"{out[p, k, m]['ms']:.4f} ms (the kernel alone "
                        f"{out[p, k, m]['dev']:.4f})")
        del idx
    r = out[P_SHARDS, K]
    extra = {"p{}_k{}{}_{}".format(key[0], key[1],
                                   f"_m{key[2]}" if len(key) > 2 else "",
                                   name): v[name2]
             for key, v in out.items() if key != (P_SHARDS, K)
             for name, name2 in (("ms", "ms"), ("device_ms", "dev"),
                                 ("plain_ms", "plain"),
                                 ("library_ms", "lib"),
                                 ("bound_ms", "bound"))}
    return dict(name="ring_topk", route="cuda",
                source="raft_tpu_torch/csrc/ring_topk.cu",
                replaces="raft_tpu/ops/ring_topk.py:416", launches=launches,
                max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain"],
                bound_ms=r["bound"], bound_by=r["by"], library_ms=r["lib"],
                device_ms=r["dev"],
                shape=f"p={P_SHARDS} shards on one card x ({M}, {K})",
                **extra)


def k8_check(ds, gs, k, mesh, what, sel=True) -> float:
    """K8 against its plain version and knn_merge_parts on every shard;
    the measured max |value - plain value| (0.0)."""
    got = rt.ring_topk(ds, gs, k, sel, mesh)
    err = check_equal(
        [torch.cat(t) for t in rt.ring_topk_plain(ds, gs, k, sel, mesh)],
        [torch.cat(t) for t in got], f"K8 ring_topk {what}")
    ref = brute_force.knn_merge_parts(torch.stack(ds), torch.stack(gs), sel)
    if not all(torch.equal(a, ref[0]) for a in got[0]) or not all(
            torch.equal(a, ref[1]) for a in got[1]):
        raise AssertionError(f"K8 differs from knn_merge_parts: {what}")
    return err


def k8_time(timer, ds, gs, k, mesh) -> dict:
    """K8's time (the wrapper's launch, status read after all runs), its
    plain version's and torch.topk's over the concatenation, and the
    bound: each shard's input read once and its output written once, and
    a merge of p lists comparing each of the p·k cells of a row log2(p)
    times (the slots a hop, the sort and the rank searches are K8's
    design, not the merge's)."""
    p, m = len(ds), ds[0].shape[0]
    status = []
    ms = timer(lambda: status.extend(
        rt.ring_topk_kernel(ds, gs, k, True, mesh)[1]), reps=15)
    if any(int(s.item()) for s in status):
        raise AssertionError("K8: a ring wait timed out")
    dev = device_ms(lambda: rt.ring_topk_kernel(ds, gs, k, True, mesh))
    plain = timer(lambda: rt.ring_topk_plain(ds, gs, k, True, mesh), reps=3)
    cat = torch.stack(ds, dim=1).reshape(m, p * k)
    lib = timer(lambda: torch.topk(cat, k, dim=1, largest=False))
    b, by = bound(2 * p * m * k * 8, 0.0, float(p) * m * k * np.log2(p))
    return dict(ms=ms, dev=dev, plain=plain, lib=lib, bound=b, by=by)


def seeded_buffer(cidx, q):
    """The path's seeded itopk buffer (bf16 seed scoring, the covering
    set plus 16 random rows per query), as ``cagra.search`` builds it."""
    cagra.prepare_search(cidx, CAGRA_SP.candidate_dtype)
    return cagra._seed_buffer(cidx, cidx.score_bf16, None, q, None,
                              min(ITOPK, 16), ITOPK, CAGRA_SP.seed)


def walk(cidx, q, buf_d, buf_i):
    """The path's traversal from the seeded buffer over the index's edge
    store, hop by hop on the plain K5 and select, for what the K5 and K6
    bounds need: the parents that hop :data:`K5_HOP` hands K5 (a query
    whose frontier has closed hands it node 0), the finite parents
    expanded over all hops and the distinct nodes among them."""
    st = cidx.edge_store
    itopk, width, max_iter = cagra._plan_dims(CAGRA_SP, K)
    explored = torch.zeros(buf_d.shape, dtype=torch.bool, device=q.device)
    seen = torch.zeros(cidx.size, dtype=torch.bool, device=q.device)
    n_ok, hop_parents = 0, None
    for h in range(max_iter):
        psafe, ok, _ = cf.pick_parents(buf_d, buf_i, explored, width,
                                       sk.select_k_plain)
        if h == K5_HOP:
            hop_parents = psafe.int().contiguous()
        seen[psafe[ok]] = True
        n_ok += int(ok.sum())
        buf_d, buf_i, explored = cf.edge_hop(
            q, buf_d, buf_i, explored, st.vecs, st.aux, st.gp, width=width,
            kprime=min(cidx.graph_degree, itopk), degree=st.degree,
            select=sk.select_k_plain, expand=ge.graph_expand_plain,
            mode=st.kernel_mode, cb=st.cb, cb_scale=st.cb_scale)
    return hop_parents, n_ok, int(seen.sum())


def k5_phase(timer, cidx, q, parents, launches):
    st = cidx.edge_store
    kp = min(cidx.graph_degree, ITOPK)
    path = (parents, q, st.vecs, st.aux, kp, "l2", st.degree)
    err = check_equal(ge.graph_expand_plain(*path), ge.graph_expand(*path),
                      f"K5 graph_expand int8 store ({M} parents of hop "
                      f"{K5_HOP} x {st.degree} edges x {D}) k'={kp}, the "
                      "path's data")
    # the parents' own nodes as a small store: bf16 rows, and an
    # integer-valued copy (int8 codes with unit scales, rounded queries)
    sub, remap = torch.unique(parents.long(), return_inverse=True)
    nbr = cidx.graph[sub].long()                          # (s, degree)
    bf = torch.zeros((len(sub), st.deg_p, st.dim_p), dtype=torch.bfloat16,
                     device=q.device)
    bf[:, :st.degree, :D] = cidx.dataset[nbr].to(torch.bfloat16)
    ones = torch.ones((len(sub), st.deg_p), device=q.device)
    bf_aux = torch.stack([ones, bf.float().square().sum(-1)],
                         dim=1).contiguous()
    codes = st.vecs[sub].contiguous()
    int_aux = torch.stack([ones, codes.float().square().sum(-1)],
                          dim=1).contiguous()
    pen = torch.where(torch.rand(ones.shape, device=q.device) < 0.25,
                      float("inf"), 0.0).contiguous()
    qi = torch.round(q)
    rp = remap.int().contiguous()
    for name, vecs, aux, qq, metric, pn in (
            ("bf16 store", bf, bf_aux, q, "l2", None),
            ("bf16 store, penalty", bf, bf_aux, q, "ip", pen),
            ("integer-valued int8", codes, int_aux, qi, "l2", pen),
            ("integer-valued int8", codes, int_aux, qi, "ip", None)):
        a = (rp, qq, vecs, aux, kp, metric, st.degree, pn)
        check_equal(ge.graph_expand_plain(*a), ge.graph_expand(*a),
                    f"K5 graph_expand {name} {metric} ({M} parents)")
    ms = timer(lambda: ge.graph_expand_kernel(*path))
    alone = device_ms(lambda: ge.graph_expand_kernel(*path))
    plain = timer(lambda: ge.graph_expand_plain(*path), reps=3, warmup=0)
    deg_p, dim_p = st.deg_p, st.dim_p
    info = ge.kernel_info(deg_p, dim_p, st.mode)
    log(f"  K5 at tiles {deg_p} x {dim_p}: {info['registers']} registers, "
        f"{info['local_bytes']} bytes of local memory (spills) a thread, "
        f"{info['warps_per_sm']} warps resident an SM "
        f"({info['warps_per_block']} a block), {info['smem_per_sm']} bytes "
        "of shared memory an SM")
    # each distinct parent's tile and aux row once; per pair its query,
    # parent id and k' outputs
    b, by = bound(len(sub) * (deg_p * dim_p + 2 * deg_p * 4)
                  + M * (dim_p * 4 + 4 + kp * 8), 2.0 * M * st.degree * D)
    log(f"  K5 at hop {K5_HOP}: {M} pairs over {len(sub)} distinct "
        f"parents; {ms:.4f} ms, alone {alone:.4f} ms")
    return dict(name="graph_expand", route="cuda",
                source="raft_tpu_torch/csrc/graph_expand.cu",
                replaces="raft_tpu/ops/graph_expand.py:261",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=None, device_ms=alone,
                distinct_parents=len(sub), **info,
                shape=f"{M} (query, parent) pairs of hop {K5_HOP}, int8 "
                      f"tiles {deg_p} x {dim_p}, k'={kp}")


def k6_phase(timer, cidx, q, buf_d, buf_i, walked, launches):
    st = cidx.edge_store
    itopk, width, max_iter = cagra._plan_dims(CAGRA_SP, K)
    kw = dict(itopk=itopk, width=width, max_iter=max_iter,
              kprime=min(cidx.graph_degree, itopk), degree=st.degree,
              metric="l2")
    path = (q, buf_d, buf_i, st.vecs, st.aux, st.gp, None)
    kd, ki, hops, parents = cf.fused_traverse_kernel(*path, **kw)
    err = check_equal(cf.fused_traverse_plain(*path, **kw), (kd, ki),
                      f"K6 cagra_fused int8 store ({M} queries, {max_iter} "
                      "hops), the path's data")
    # a query's result does not depend on which persistent warp takes it
    check_bits((kd, ki, hops, parents),
               cf.fused_traverse_kernel(*path, **kw),
               "K6 cagra_fused launched twice")
    # the seed in any order: K6 sorts each buffer as it loads it
    g = torch.Generator(device=q.device).manual_seed(3)
    perm = torch.argsort(torch.rand(buf_d.shape, device=q.device,
                                    generator=g), dim=1)
    shuffled = (q, buf_d.gather(1, perm), buf_i.gather(1, perm), st.vecs,
                st.aux, st.gp, None)
    check_equal(cf.fused_traverse_plain(*shuffled, **kw),
                cf.fused_traverse_kernel(*shuffled, **kw)[:2],
                f"K6 cagra_fused on the path's buffer shuffled ({M} "
                "queries)")
    # an integer-valued copy: the int8 codes with unit scales, rounded
    # queries, and a buffer of their exact integer distances
    codes, _ = cidx.score_i8
    norms = codes.float().square().sum(1)
    int_aux = torch.zeros_like(st.aux)
    int_aux[:, 0, :st.degree] = 1.0
    int_aux[:, 1, :st.degree] = norms[cidx.graph.long()]
    qi = torch.round(q)
    d = (qi[:, None, :] - codes[buf_i.long()].float()).square().sum(-1)
    bd, order = torch.sort(d, dim=1, stable=True)
    bi = torch.gather(buf_i, 1, order)
    for metric in ("l2", "ip"):
        a = (qi, bd, bi, st.vecs, int_aux, st.gp, None)
        kwm = dict(kw, metric=metric)
        check_equal(cf.fused_traverse_plain(*a, **kwm),
                    cf.fused_traverse_kernel(*a, **kwm)[:2],
                    f"K6 cagra_fused integer-valued int8 {metric} ({M} "
                    "queries)")
    del int_aux
    ms = timer(lambda: cf.fused_traverse_kernel(*path, **kw))
    plain = timer(lambda: cf.fused_traverse_plain(*path, **kw), reps=1,
                  warmup=0)
    # the cost of a hop: K6 cut to 8, 32 and max_iter hops
    by_iter = {}
    for it in sorted({8, 32, max_iter}):
        kwi = dict(kw, max_iter=it)
        h = cf.fused_traverse_kernel(*path, **kwi)[2]
        by_iter[it] = (timer(lambda: cf.fused_traverse_kernel(*path, **kwi)),
                       float(h.float().mean()))
    (t0, h0), (t1, h1) = by_iter[8], by_iter[max_iter]
    slope = (t1 - t0) / (h1 - h0)
    log("  K6 by max_iter: " + ", ".join(
        f"{it}: {t:.3f} ms ({h:.2f} hops)" for it, (t, h) in by_iter.items())
        + f"; a hop of all {M} queries {slope * 1e3:.1f} us, "
        f"{slope * 1e6 / M:.2f} ns a query")
    info = cf.kernel_info(itopk, width, kw["kprime"], st.deg_p, st.dim_p,
                          st.mode)
    log(f"  K6 at the path's shape: {info['registers']} registers, "
        f"{info['local_bytes']} bytes of local memory (spills) a thread, "
        f"{info['warps_per_sm']} warps resident an SM")
    n_par = int(parents.sum())
    n_ok, distinct = walked
    if n_ok != n_par:
        raise AssertionError(f"K6 expanded {n_par} parents, the plain hop "
                             f"loop {n_ok}")
    mean_hops = float(hops.float().mean())
    deg_p, dim_p = st.deg_p, st.dim_p
    # each distinct expanded node's tile, aux row and graph row once (a
    # node that several queries expand is read once); the queries and the
    # buffers in and out; the scoring of every (query, parent) pair
    b, by = bound(distinct * (deg_p * dim_p + 2 * deg_p * 4 + deg_p * 4)
                  + M * dim_p * 4 + 2 * M * itopk * 8,
                  2.0 * n_par * st.degree * D)
    log(f"  K6 took {mean_hops:.2f} hops per query on average (max "
        f"{int(hops.max())} of {max_iter}), {n_par} parents expanded, "
        f"{distinct} distinct")
    return dict(name="cagra_fused", route="cuda",
                source="raft_tpu_torch/csrc/cagra_fused.cu",
                replaces="raft_tpu/ops/cagra_fused.py:285",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=None,
                mean_hops=mean_hops, parents=n_par, distinct_parents=distinct,
                ms_by_max_iter={it: t for it, (t, _) in by_iter.items()},
                hop_ms=slope, **info,
                shape=f"{M} queries, itopk {itopk}, width {width}, "
                      f"{max_iter} hops max, int8 tiles {deg_p} x {dim_p}")


def cagra_batches() -> dict:
    """The CAGRA build's kNN-graph batches by size → {rows: first row}:
    ``CAGRA_BATCH`` rows each and, where N is not a multiple, the last,
    shorter one (each size has a K2 plan of its own)."""
    return {min(CAGRA_BATCH, N - b0): b0 for b0 in range(0, N, CAGRA_BATCH)}


def k1_inputs(x, q, bidx, iidx, pidx, cidx, sidx):
    """K1's inputs at every (rows, n, k) shape the paths hand it, made the
    way each path makes them → [(what, values (rows, n), k)]."""
    st = cidx.edge_store
    # coarse probe: ranking scores of the queries against the 1,024 centers
    coarse = (iidx.center_norms[None, :] - 2.0 * (q @ iidx.centers.T))
    # K2's corpus splits: brute force at k, the CAGRA build's kNN graph at
    # intermediate degree + 1 over each size of batch it runs
    qn = fk.prepare_norms("l2", q)
    dn = fk.prepare_norms("l2", x, bidx.norms)
    bf_cand = fk.fused_knn_candidates(q, qn, x, dn, None, K, "l2")[0]
    build = []     # the batches whose K2 plan splits the corpus
    for rows, b0 in cagra_batches().items():
        xb = x[b0:b0 + rows]
        cand, _, splits = fk.fused_knn_candidates(
            xb, fk.prepare_norms("l2", xb), x, dn, None, CAGRA_D0 + 1, "l2")
        if splits > 1:
            build.append((f"CAGRA build split merge, a batch of {rows}",
                          cand, CAGRA_D0 + 1))
    # K3 and K4: each query's probes' candidates side by side
    probed = iscan.coarse_probe(q, iidx.centers, N_PROBES, "l2",
                                iidx.center_norms)
    k3_cand = iscan.ivf_flat_scan_candidates(
        iidx.data, iidx.data_norms, None, q, qn, probed.int(),
        iidx.offsets_dev, iidx.sizes_dev, K, "l2")[0]
    q_rot = (q @ pidx.rotation.T).contiguous()
    pprobed = iscan.coarse_probe(q_rot, pidx.centers_rot, N_PROBES, "l2",
                                 pidx.center_norms)
    k4_cand = ipq.ivf_pq_scan_candidates(
        pidx.codes, pidx.row_norms, None,
        ipq.lut_codebook(pidx.codebooks, "bf16"), pidx.centers_rot, q_rot,
        pprobed, pidx.offsets_dev, pidx.sizes_dev, K0, "l2")[0]
    # refine: exact distances to the IVF-PQ search's k0 candidates
    _, pi = ivf_pq.search(pidx, q, K0, ivf_pq.SearchParams(n_probes=N_PROBES))
    ref = (x[pi.long()] - q[:, None, :]).square().sum(-1).contiguous()
    # the edge engine's hop 0: the parent pick over the seeded buffer, then
    # the buffer ++ the parent's k' candidates (before duplicate masking)
    buf_d, buf_i = seeded_buffer(cidx, q)
    kp = min(cidx.graph_degree, ITOPK)
    psafe, _, _ = cf.pick_parents(buf_d, buf_i, torch.zeros_like(
        buf_d, dtype=torch.bool), 1, sk.select_k_plain)
    pv, _ = ge.graph_expand(psafe, q, st.vecs, st.aux, kp, "l2", st.degree)
    edge_cat = torch.cat([buf_d, pv.reshape(M, kp)], dim=1).contiguous()
    # the allgather merge of the 4 shards' lists at RING_K
    ds, _ = sharded_knn.shard_candidates(sidx, q, RING_K)
    gathered = torch.stack(ds, dim=1).reshape(M, -1).contiguous()
    return [("coarse probe", coarse.contiguous(), N_PROBES),
            ("brute-force split merge", bf_cand, K), *build,
            ("IVF-Flat probe merge", k3_cand, K),
            ("IVF-PQ probe merge", k4_cand, K0),
            ("refine", ref, K),
            ("edge engine parent pick", buf_d.contiguous(), 1),
            ("edge engine buffer merge", edge_cat, ITOPK),
            (f"allgather merge, p={P_SHARDS}", gathered, RING_K)]


def k1_phase(timer, inputs, launches, by_form):
    """K1 at every path shape, each form against the plain version on the
    path's values, on integer-valued rows of the same shape (ties, +inf
    cells, both selection directions) and, bit for bit, on the path's
    values with NaN, -NaN, ±inf and -0.0 cells mixed in (both
    directions: the select_k order of matrix/select_k.py), both forms
    timed in turn
    beside the plain version and ``torch.topk``; the entry reports the
    coarse probe's shape in the form the path takes there."""
    rng = np.random.default_rng(SEED + 1)
    shapes, err = [], 0.0
    for what, v, k in inputs:
        rows, n = v.shape
        ints = rng.integers(0, 64, (rows, n)).astype(np.float32)
        ints[rng.random((rows, n)) < 0.02] = np.inf
        vi = torch.from_numpy(ints).cuda()
        odd = odd_cells(v, SEED + rows + n)
        forms = ("warp", "radix") if k <= sk.WARP_MAX_K else ("radix",)
        for form in forms:
            e = check_equal(sk.select_k_plain(v, k),
                            sk.kpass_select_k(v, k, form=form),
                            f"K1 {form} {what} ({rows}, {n}) k={k}, the "
                            "path's values")
            err = max(err, e)
            for sel in (True, False):
                a = vi if sel else -vi
                check_equal(sk.select_k_plain(a, k, sel),
                            sk.kpass_select_k(a, k, sel, form=form),
                            f"K1 {form} {what} ({rows}, {n}) k={k}, integer "
                            f"rows, select_min={sel}")
                check_bits(sk.select_k_plain(odd, k, sel),
                           sk.kpass_select_k(odd, k, sel, form=form),
                           f"K1 {form} {what} ({rows}, {n}) k={k}, the "
                           f"path's values with NaN, ±inf and -0.0, "
                           f"select_min={sel}")
        del vi, odd
        # forms in turn: warp, radix, radix, warp; the median of each.
        # A wrapper call's event time includes its host work where that
        # outlasts the L2 flush, so each form's kernel is also timed alone
        ms = {f: [] for f in forms}
        for f in forms + forms[::-1]:
            ms[f].append(timer(lambda: sk.kpass_select_k(v, k, form=f),
                               reps=9))
        dev = {f: device_ms(lambda: sk.kpass_select_k(v, k, form=f))
               for f in forms}
        plain = timer(lambda: sk.select_k_plain(v, k))
        lib = timer(lambda: torch.topk(v, k, dim=1, largest=False))
        b, by = bound(rows * n * 4 + rows * k * 8, 0.0, float(rows) * n)
        row = dict(what=what, shape=f"({rows}, {n}) k={k}",
                   form=sk.select_form(k), plain_ms=plain, library_ms=lib,
                   bound_ms=b, bound_by=by,
                   **{f"{f}_ms": statistics.median(t) for f, t in ms.items()},
                   **{f"{f}_device_ms": t for f, t in dev.items()})
        shapes.append(row)
        log(f"  K1 {what} ({rows}, {n}) k={k}: "
            + ", ".join(f"{f} {row[f + '_ms']:.4f} ms (alone "
                        f"{row[f + '_device_ms']:.4f})" for f in forms)
            + f"; plain {plain:.3f}, torch.topk {lib:.4f}, bound {b:.4f} "
            f"by {by}")
    main = shapes[0]
    return dict(name="select_k", route="cuda",
                source="raft_tpu_torch/csrc/select_k.cu",
                replaces="raft_tpu/matrix/select_k.py:127",
                launches=launches, max_abs_err=err,
                ms=main[main["form"] + "_ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], shape=main["shape"],
                form=main["form"],
                device_ms=main[main["form"] + "_device_ms"],
                launches_by_form=by_form, shapes=shapes)


def k2_phase(timer, bidx, q, launches, knn_graph_s):
    """K2 equal to its plain version on integer inputs (k = 10, the
    k-lists' widest LIST_MAX_K, and the CAGRA build's 129: the wide form),
    close to it on the path's data at k = 10 (l2, ip) and at k = 129;
    timed at the brute-force path's shape and at the CAGRA build's (one
    full batch against the corpus at k = 129, the wide form),
    each against two bounds: the FP32 pipe's and the 3xTF32 product's on
    the tensor cores (three TF32 products, the least an f32-accurate
    product costs there), which is the row's bound."""
    x, norms = bidx.dataset, bidx.norms
    rng = np.random.default_rng(SEED + 2)
    qi = torch.from_numpy(rng.integers(-3, 4, (256, 32)).astype(
        np.float32)).cuda()
    xi = torch.from_numpy(rng.integers(-3, 4, (50_000, 32)).astype(
        np.float32)).cuda()
    for metric in ("l2", "ip"):
        for k in (K, CAGRA_D0 + 1, fk.LIST_MAX_K):
            check_equal(fk.fused_knn_plain(qi, xi, k, metric),
                        fk.fused_knn(qi, xi, k, metric),
                        f"K2 fused_knn {metric} (256, 50000, 32) k={k}, "
                        "integer inputs")
    sub = q[:512]
    qn = fk.prepare_norms("l2", q)
    out = {}
    for metric, k in (("l2", K), ("ip", K), ("l2", CAGRA_D0 + 1)):
        pv, pi = fk.fused_knn_plain(sub, x, k, metric, norms)
        kv, ki = fk.fused_knn(sub, x, k, metric, norms)
        err = check_close(pv, pi, kv, ki,
                          f"K2 fused_knn {metric} (512 of {M} queries, "
                          f"{N}, {D}) k={k}")
        out[metric, k] = err
    dn = fk.prepare_norms("l2", x, norms)
    times = {}
    for metric in ("l2", "ip"):
        qm = qn if metric == "l2" else None
        dm = dn if metric == "l2" else None
        times[metric] = timer(lambda: fk.fused_knn_candidates(
            q, qm, x, dm, None, K, metric))
    xb = x[:CAGRA_BATCH]
    xbn = fk.prepare_norms("l2", xb)
    t129 = timer(lambda: fk.fused_knn_candidates(xb, xbn, x, dn, None,
                                                 CAGRA_D0 + 1, "l2"),
                 reps=3)
    plain = timer(lambda: fk.fused_knn_plain(q, x, K, "l2", norms), reps=3,
                  warmup=0)

    def library():
        for s0 in range(0, M, 1000):
            dist = torch.addmm(norms[None, :], q[s0:s0 + 1000], x.T,
                               alpha=-2.0)
            torch.topk(dist, K, dim=1, largest=False)

    lib = timer(library, reps=3)
    splits, _ = fk._split_plan(M, N, K, D, "l2", x.device)
    build_splits = {rows: fk._split_plan(rows, N, CAGRA_D0 + 1, D, "l2",
                                         x.device)[0]
                    for rows in cagra_batches()}
    full = max(build_splits)            # CAGRA_BATCH rows, or N if fewer
    splits129 = build_splits[full]

    def bounds(m, k, sp):
        """(3xTF32 bound, FP32 bound, bytes bound) in ms."""
        n_bytes = (m * D + N * D + N + m) * 4 + m * sp * k * 8
        b_bytes, _ = bound(n_bytes, 0.0)
        flops = 2.0 * m * N * D
        return (3 * flops / TF32_FLOPS_PER_S * 1e3,
                flops / FP32_FLOPS_PER_S * 1e3, b_bytes)

    tf, fp, by = bounds(M, K, splits)
    tf129, fp129, _ = bounds(full, CAGRA_D0 + 1, splits129)
    graph_tf = 3 * 2.0 * N * N * D / TF32_FLOPS_PER_S
    ms = times["l2"]
    log(f"  K2 l2 at ({M}, {N}, {D}) k={K}: {ms:.2f} ms ({splits} splits), "
        f"ip {times['ip']:.2f} ms; 3xTF32 bound {tf:.2f} ms "
        f"({tf / ms:.1%} of it), FP32 bound {fp:.2f} ms ({fp / ms:.1%}), "
        f"bytes {by:.3f} ms")
    log(f"  K2 l2 at the CAGRA build's ({full}, {N}, {D}) k="
        f"{CAGRA_D0 + 1}: {t129:.2f} ms ({splits129} splits); 3xTF32 bound "
        f"{tf129:.2f} ms ({tf129 / t129:.1%}), FP32 bound {fp129:.2f} ms "
        f"({fp129 / t129:.1%}); corpus splits by batch size "
        f"{build_splits}")
    log(f"  CAGRA kNN-graph stage {knn_graph_s:.3f} s; its 3xTF32 bound "
        f"{graph_tf:.3f} s ({graph_tf / knn_graph_s:.1%})")
    return dict(name="fused_knn", route="cuda",
                source="raft_tpu_torch/csrc/fused_knn.cu",
                replaces="raft_tpu/ops/fused_knn.py:336",
                launches=launches, max_abs_err=out["l2", K],
                ms=ms, plain_ms=plain, bound_ms=tf, bound_by="operations",
                bound_kind="3xTF32", library_ms=lib, fp32_bound_ms=fp,
                bytes_bound_ms=by, ip_ms=times["ip"],
                k129_ms=t129, k129_bound_ms=tf129, k129_fp32_bound_ms=fp129,
                k129_max_abs_err=out["l2", CAGRA_D0 + 1],
                k129_splits_by_batch=build_splits,
                knn_graph_s=knn_graph_s, knn_graph_bound_s=graph_tf,
                shape=f"({M}, {N}, {D}) k={K} l2, {splits} corpus splits")


SCAN_FORMS = ("group", "pair")
TILE_ROWS = 128    # the grouped scans' row tile (csrc/tf32_tile.cuh, BN)


def group_tiles(probed, sizes, k: int):
    """The grouped form's tiles at k over the lists of ``sizes``: (live
    tiles, rows they read, queries they gather) of
    ``ivf_scan.pack_pairs``."""
    glist, _, gcount, _ = iscan.pack_pairs(probed.int(), sizes.shape[0],
                                           iscan.group_queries(k))
    live = gcount > 0
    return (int(live.sum()), int(sizes.long()[glist[live].long()].sum()),
            int(gcount.sum()))


def k3_phase(timer, iidx, q, launches, by_form):
    """K3 in both forms against the plain version on the path's data (and
    each launched twice, bit-equal), both timed at the path's shape; the
    row's bound is :func:`scan_bound`'s (the (pair, row) products in
    3xTF32), printed beside the same products on the FP32 pipe and the
    grouped form's tiles and bytes."""
    probed = iscan.coarse_probe(q, iidx.centers, N_PROBES, "l2",
                                iidx.center_norms)
    args = (iidx.data, iidx.data_norms, probed, iidx.offsets_dev,
            iidx.sizes_dev, q, K, "l2")
    pv, pi = iscan.ivf_flat_scan_plain(*args)
    errs = {}
    for form in SCAN_FORMS:
        kv, ki = iscan.ivf_flat_scan(*args, form=form)
        what = f"K3 ivf_flat_scan {form} form ({M} queries, " \
               f"n_probes={N_PROBES}) k={K}"
        errs[form] = check_close(pv, pi, kv, ki, what)
        check_bits((kv, ki), iscan.ivf_flat_scan(*args, form=form),
                   f"{what}, launched twice")
    qn = fk.prepare_norms("l2", q)

    def launch(form, sizes):
        return iscan.ivf_flat_scan_candidates(
            iidx.data, iidx.data_norms, None, q, qn, probed.int(),
            iidx.offsets_dev, sizes, K, "l2", form)

    times = {form: timer(lambda: launch(form, iidx.sizes_dev))
             for form in SCAN_FORMS}
    # every list cut to one tile: the grouped form's cost a group beside
    # its tiles (the query gather, the first tile's selection into empty
    # k-lists, the output)
    one_tile = timer(lambda: launch("group", torch.clamp_max(
        iidx.sizes_dev, TILE_ROWS)))
    plain = timer(lambda: iscan.ivf_flat_scan_plain(*args), reps=3,
                  warmup=0)
    sizes = iidx.sizes_dev.long()
    scanned = int(sizes[probed.long()].sum())          # (pair, row) count
    lists = torch.unique(probed)
    distinct_rows = int(sizes[lists].sum())
    n_bytes = (distinct_rows * (D + 1) * 4 + M * D * 4
               + M * N_PROBES * (4 + K * 8))
    b, by = scan_bound(n_bytes, scanned, D, 3)
    fp, _ = bound(n_bytes, 2.0 * D * scanned)
    tf = 3 * 2.0 * D * scanned / TF32_FLOPS_PER_S * 1e3
    tiles, tile_rows, gathered = group_tiles(probed, sizes, K)
    tile_bytes = tile_rows * (D + 1) * 4 + gathered * D * 4
    log(f"  K3 scans {scanned} (pair, row) products over {distinct_rows} "
        f"distinct rows; grouped form {times['group']:.3f} ms, per-pair "
        f"form {times['pair']:.3f} ms; bound {b:.4f} ms ({by}; 3xTF32 "
        f"products {tf:.4f} ms, on the FP32 pipe {fp:.4f} ms); {tiles} "
        f"group tiles read "
        f"{tile_bytes / 1e9:.3f} GB (rows, norms, gathered queries); with "
        f"every list cut to one tile {one_tile:.3f} ms")
    return dict(name="ivf_flat_scan", route="cuda",
                source="raft_tpu_torch/csrc/ivf_flat_scan.cu",
                replaces="raft_tpu/ops/ivf_scan.py:284", launches=launches,
                max_abs_err=errs["group"], ms=times["group"],
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
                form="group", pair_ms=times["pair"],
                pair_max_abs_err=errs["pair"], tf32x3_bound_ms=tf,
                fp32_bound_ms=fp, one_tile_ms=one_tile, group_tiles=tiles,
                group_bytes=tile_bytes,
                launches_by_form=by_form,
                shape=f"{M} queries x {N_PROBES} probes, k={K}")


def k4_phase(timer, pidx, q, launches, by_form):
    """K4 in both forms against the plain version on the path's data (bf16
    and f32 LUT modes on all queries, int8 on 1,000; each launched twice,
    bit-equal) and on an integer-valued copy of the index (equal), both
    timed at the path's shape (bf16 LUT); the row's bound is the least
    work of the function (one LUT a query, one add a (pair, row,
    subspace)), printed beside the grouped form's tiles and bytes."""
    q_rot = (q @ pidx.rotation.T).contiguous()
    probed = iscan.coarse_probe(q_rot, pidx.centers_rot, N_PROBES, "l2",
                                pidx.center_norms)

    def args(idx, mode, qr, pr):
        return (idx.codes, idx.row_norms, idx.centers_rot,
                ipq.lut_codebook(idx.codebooks, mode), pr, idx.offsets_dev,
                idx.sizes_dev, qr)

    shape = f"{M} queries x {N_PROBES} probes, pq_dim={PQ_DIM}, k={K0}"
    path = args(pidx, "bf16", q_rot, probed)
    errs = {}
    for mode, a, what in (
            ("bf16", path, shape), ("f32", args(pidx, "f32", q_rot, probed),
                                    shape),
            ("int8", args(pidx, "int8", q_rot[:1000], probed[:1000]),
             f"1000 of {M} queries")):
        ref = ipq.ivf_pq_scan_plain(*a, K0, "l2")
        for form in SCAN_FORMS:
            got = ipq.ivf_pq_scan(*a, K0, "l2", form=form)
            name = f"K4 ivf_pq_scan {form} form, {mode} LUT ({what})"
            err = check_close(*ref, *got, name)
            check_bits(got, ipq.ivf_pq_scan(*a, K0, "l2", form=form),
                       f"{name}, launched twice")
            if mode == "bf16":
                errs[form] = err
    # the path's index with a small-integer codebook and centers: every
    # product and sum is exact, so kernel and plain version are equal
    rng = np.random.default_rng(SEED + 4)
    ints = lambda shape_: torch.from_numpy(rng.integers(  # noqa: E731
        -3, 4, shape_).astype(np.float32)).cuda()
    iidx = dataclasses.replace(pidx, codebooks=ints(pidx.codebooks.shape),
                               centers_rot=ints(pidx.centers_rot.shape))
    qi = ints((1000, pidx.rot_dim))
    pri = iscan.coarse_probe(qi, iidx.centers_rot, N_PROBES, "l2",
                             iidx.center_norms)
    for mode in ("f32", "bf16"):
        a = args(iidx, mode, qi, pri)
        for metric in ("l2", "ip"):
            ref = ipq.ivf_pq_scan_plain(*a, K0, metric)
            for form in SCAN_FORMS:
                check_equal(ref, ipq.ivf_pq_scan(*a, K0, metric, form=form),
                            f"K4 ivf_pq_scan {form} form, {mode} LUT "
                            f"{metric}, integer codebook/centers/queries "
                            "(1000 queries)")
    # time in the path's LUT mode (bf16)
    def launch(form, sizes):
        return ipq.ivf_pq_scan_candidates(
            pidx.codes, pidx.row_norms, None, path[3], pidx.centers_rot,
            q_rot, probed, pidx.offsets_dev, sizes, K0, "l2", form)

    times = {form: timer(lambda: launch(form, pidx.sizes_dev))
             for form in SCAN_FORMS}
    # every list cut to one tile, as for K3 (and q·c_l, ||q||²)
    one_tile = timer(lambda: launch("group", torch.clamp_max(
        pidx.sizes_dev, TILE_ROWS)))
    plain = timer(lambda: ipq.ivf_pq_scan_plain(*path, K0, "l2"), reps=3,
                  warmup=0)
    sizes = pidx.sizes_dev.long()
    scanned = int(sizes[probed.long()].sum())          # (pair, row) count
    distinct_rows = int(sizes[torch.unique(probed)].sum())
    pairs = M * N_PROBES
    book, pq_len = pidx.pq_book_size, pidx.pq_len
    # the cheaper of two routes: the LUT (its FMAs once per query, then
    # one add per (pair, row, subspace)) or the decoded rows' products
    b, by = scan_bound(distinct_rows * (PQ_DIM + 4) + q_rot.numel() * 4
                       + pidx.centers_rot.numel() * 4
                       + pidx.codebooks.numel() * 4 + pairs * (4 + K0 * 8),
                       scanned, pidx.rot_dim, tf32_products(path[3]),
                       (M * 2 * PQ_DIM * book * pq_len, scanned * PQ_DIM))
    tiles, tile_rows, gathered = group_tiles(probed, sizes, K0)
    tile_bytes = tile_rows * (PQ_DIM + 4) + gathered * pidx.rot_dim * 4
    log(f"  K4 scans {scanned} (pair, row) products over {distinct_rows} "
        f"distinct rows; grouped form {times['group']:.3f} ms, per-pair "
        f"form {times['pair']:.3f} ms; bound {b:.4f} ms ({by}); {tiles} "
        f"group tiles read {tile_bytes / 1e9:.3f} GB (codes, norms, "
        f"gathered queries); with every list cut to one tile "
        f"{one_tile:.3f} ms")
    return dict(name="ivf_pq_scan", route="cuda",
                source="raft_tpu_torch/csrc/ivf_pq_scan.cu",
                replaces="raft_tpu/ops/ivf_pq_scan.py:290",
                launches=launches, max_abs_err=errs["group"],
                ms=times["group"], plain_ms=plain, bound_ms=b, bound_by=by,
                library_ms=None, form="group", pair_ms=times["pair"],
                pair_max_abs_err=errs["pair"], one_tile_ms=one_tile,
                group_tiles=tiles,
                group_bytes=tile_bytes, launches_by_form=by_form,
                shape=f"{shape}, bf16 LUT")


def check_wide_k(ref_v, ref_i, v, i, what: str) -> float:
    """Past 128 slots a row, near ties reorder ids between two summation
    orders on more than 1% of rows (the card tests' note), so the ids
    are held as sets: values slot by slot to rtol=1e-5 (atol 1e-5·max|d|),
    and at least 99.9% of each row's ids shared on average. Returns max
    |v - ref_v|."""
    fin = torch.isfinite(ref_v)
    if not torch.equal(torch.isfinite(v), fin):
        raise AssertionError(f"{what}: +inf slots differ")
    err = float((v[fin] - ref_v[fin]).abs().max()) if fin.any() else 0.0
    atol = RTOL * float(ref_v[fin].abs().max())
    if not torch.allclose(v[fin], ref_v[fin], rtol=RTOL, atol=atol):
        raise AssertionError(f"{what}: values differ by up to {err}")
    shared = neighborhood_recall(i, ref_i)
    if shared < 0.999:
        raise AssertionError(f"{what}: ids shared {shared:.5f}")
    log(f"  {what}: max_abs_err={err:.3g}, ids shared {shared:.6f}, rows "
        f"equal {float((i == ref_i).all(dim=1).float().mean()):.4f}")
    return err


def k3_wide(timer, iidx, q) -> dict:
    """K3 past K2's k = 256 on the path's IVF-Flat index (10,000 queries x
    20 probes) at :data:`WIDE_KS`, the grouped form's widest and the IVF-PQ
    pass's k: both forms against the plain version (values slot by slot,
    ids as sets: :func:`check_wide_k`), each launched twice and
    bit-equal, and equal to it on an integer-valued copy of the lists and
    queries; both timed beside the FP32 bound of the (pair, row)
    products, the grouped form with its plan (queries a group, query-tile
    layout, ring stages, shared memory) as the card's library makes it."""
    probed = iscan.coarse_probe(q, iidx.centers, N_PROBES, "l2",
                                iidx.center_norms)
    rng = np.random.default_rng(SEED + 5)
    ints = lambda shape: torch.from_numpy(rng.integers(  # noqa: E731
        -3, 4, shape).astype(np.float32)).cuda()
    xi, qi = ints(tuple(iidx.data.shape)), ints((M, D))
    ni = (xi * xi).sum(1)
    qn = fk.prepare_norms("l2", q)
    sizes = iidx.sizes_dev.long()
    scanned = int(sizes[probed.long()].sum())
    distinct = int(sizes[torch.unique(probed)].sum())
    wide = {}
    for k in WIDE_KS:
        lists = (probed, iidx.offsets_dev, iidx.sizes_dev)
        args = (iidx.data, iidx.data_norms, *lists, q, k, "l2")
        iargs = (xi, ni, *lists, qi, k, "l2")
        ref, iref = (iscan.ivf_flat_scan_plain(*args),
                     iscan.ivf_flat_scan_plain(*iargs))
        row = {}
        for form in SCAN_FORMS:
            what = (f"K3 ivf_flat_scan {form} form at k={k} ({M} queries, "
                    f"n_probes={N_PROBES})")
            got = iscan.ivf_flat_scan(*args, form=form)
            row[f"{form}_max_abs_err"] = check_wide_k(*ref, *got, what)
            check_bits(got, iscan.ivf_flat_scan(*args, form=form),
                       f"{what}, launched twice")
            check_equal(iref, iscan.ivf_flat_scan(*iargs, form=form),
                        f"{what}, integer-valued lists and queries")
            row[f"{form}_ms"] = timer(
                lambda: iscan.ivf_flat_scan_candidates(
                    iidx.data, iidx.data_norms, None, q, qn, probed.int(),
                    *lists[1:], k, "l2", form))
        del ref, iref
        b, by = scan_bound(distinct * (D + 1) * 4 + M * D * 4
                           + M * N_PROBES * (4 + k * 8), scanned, D, 3)
        plan = iscan.group_plan_on_card("ivf_flat_scan", k, D)
        row.update(bound_ms=b, bound_by=by, plan=plan)
        log(f"  K3 at k={k}: grouped form {row['group_ms']:.3f} ms, per-pair "
            f"{row['pair_ms']:.3f} ms, bound {b:.4f} ms ({by}); plan "
            f"(queries a group, query tile, stages, bytes) {plan}")
        wide[k] = row
    return dict(wide_k=wide)


def k4_graph_pass(timer, call, split_libs) -> dict:
    """K4 at the IVF-PQ graph pass's shape (the pass's first batch, as the
    path handed it: 4-bit codes, int8 LUT, k = 2·128 + 1) in both forms
    against its plain version (values slot by slot, ids as sets), each
    launched twice and bit-equal, equal to it on an integer-valued copy
    (integer codebook with an entry of 127 a subspace, so the int8 LUT's
    scale is 1; integer centers and queries; the first
    :data:`WIDE_QUERIES` queries) at both metrics; the same at the
    grouped form's widest k (512) on those queries. The grouped form past
    256 (its own plan: distances kept, one radix select a pair) against
    the plan at k = 256, whose streaming selection it replaced: each
    pair's first 256 slots bit for bit, at k = 257 and 512 on those
    queries. Both forms timed beside the bound, the grouped form with its
    plan, its persistent blocks and scratch, and its split (whole, no
    selection, products alone: ``split_libs``, tools/scan_ab.py's
    builds)."""
    args, kwargs = call
    m, p = args[4].shape
    k = args[8]
    pq_dim, book, pq_len = args[3].shape
    shape = (f"{m} queries x {p} probes, pq_dim={pq_dim} x 4 bits, int8 "
             f"LUT, k={k}")
    ref, plain_s = host_time(lambda: ipq.ivf_pq_scan_plain(*args, **kwargs))
    errs = {}
    for form in SCAN_FORMS:
        what = f"K4 ivf_pq_scan {form} form at the graph pass ({shape})"
        got = ipq.ivf_pq_scan(*args, **kwargs, form=form)
        errs[form] = check_wide_k(*ref, *got, what)
        check_bits(got, ipq.ivf_pq_scan(*args, **kwargs, form=form),
                   f"{what}, launched twice")
        del got
    del ref
    # the grouped form's widest k on the batch's first WIDE_QUERIES queries
    sub = list(args)
    sub[4], sub[7], sub[8] = args[4][:WIDE_QUERIES], args[7][:WIDE_QUERIES], \
        iscan.GROUP_MAX_K
    ref = ipq.ivf_pq_scan_plain(*sub, **kwargs)
    for form in SCAN_FORMS:
        what = (f"K4 ivf_pq_scan {form} form at k={iscan.GROUP_MAX_K} (the "
                f"graph pass's first {WIDE_QUERIES} queries)")
        got = ipq.ivf_pq_scan(*sub, **kwargs, form=form)
        errs[f"{form}_{iscan.GROUP_MAX_K}"] = check_wide_k(*ref, *got, what)
        check_bits(got, ipq.ivf_pq_scan(*sub, **kwargs, form=form),
                   f"{what}, launched twice")
    del ref, got
    # an integer-valued copy: every product and sum exact in either order
    rng = np.random.default_rng(SEED + 6)
    ints = lambda shape_: torch.from_numpy(rng.integers(  # noqa: E731
        -3, 4, shape_).astype(np.float32)).cuda()
    cb = ints((pq_dim, book, pq_len))
    cb[:, 0, 0] = 127.0
    centers = ints(tuple(args[2].shape))
    # each list's rows lie in [its start, the next list's start)
    dn = ipq.decoded_row_norms(args[0], centers, cb, np.append(
        args[5].cpu().numpy(), args[0].shape[0]))
    qi = ints((WIDE_QUERIES, args[7].shape[1]))
    for kk in WIDE_KS:
        for metric in ("l2", "ip"):
            ia = (args[0], dn, centers, ipq.lut_codebook(cb, "int8"),
                  args[4][:WIDE_QUERIES], args[5], args[6], qi, kk, metric)
            iref = ipq.ivf_pq_scan_plain(*ia)
            for form in SCAN_FORMS:
                check_equal(iref, ipq.ivf_pq_scan(*ia, form=form),
                            f"K4 ivf_pq_scan {form} form at k={kk}, {metric}"
                            f", integer codebook/centers/queries (the graph "
                            f"pass's codes and probes, {WIDE_QUERIES} "
                            "queries)")
    del iref, dn, cb, centers, qi

    def cand(form, a=args):
        return (a[0], a[1], a[10], a[3], a[2], a[7], a[4], a[5], a[6], a[8],
                a[9], form)

    # past 256 against the streaming selection of the plan at 256, on the
    # same distances: each pair's first 256 slots bit for bit
    mw, pw = sub[4].shape
    c = list(cand("group", sub))
    c[9] = 256
    sv, si = ipq.ivf_pq_scan_candidates(*c)
    for kk in WIDE_KS:
        c[9] = kk
        wv, wi = ipq.ivf_pq_scan_candidates(*c)
        check_bits((wv.view(mw, pw, kk)[:, :, :256].contiguous(),
                    wi.view(mw, pw, kk)[:, :, :256].contiguous()),
                   (sv.view(mw, pw, 256), si.view(mw, pw, 256)),
                   f"K4 grouped at k={kk} against the plan at k=256 (each "
                   f"pair's first 256 slots, {mw} queries of the graph "
                   "pass)")
        del wv, wi
    del sv, si
    lmax = ipq.largest_list(args[6])
    scratch, blocks, per_sm = iscan.wide_scratch_on_card(
        "ivf_pq_scan", k, pq_dim * pq_len, lmax)
    # the split at the pass batch: the library whole, without its
    # selection, its products alone
    b = dict(codes=args[0], dn=args[1], cb=args[3], centers=args[2],
             q=args[7], probed=args[4], offsets=args[5],
             n_lists=args[5].shape[0])
    runs = {"whole": scan_ab.launcher(_cuda.library("ivf_pq_scan"), b,
                                      args[6], k)[0]}
    for mode, name in scan_ab.SPLITS.items():
        lib = split_libs[f"{SPLIT_DIR}/split{mode}"]["k4"]
        runs[name] = scan_ab.launcher(lib, b, args[6], k)[0]
    split = scan_ab.split_times(runs)
    del runs
    log(f"  K4 past k=256 at the graph pass: {blocks} persistent blocks "
        f"({per_sm} an SM), scratch {scratch / 1e6:.1f} MB for lists up "
        f"to {lmax} rows; split (the card's time alone, L2 cold): "
        + ", ".join(f"{name} {t:.3f} ms" for name, t in split.items()))

    # the per-pair form (seconds a call at this shape) once, after the
    # calls above
    reps = {"group": dict(reps=5), "pair": dict(reps=1, warmup=0)}
    ms = {form: timer(lambda: ipq.ivf_pq_scan_candidates(*cand(form)),
                      **reps[form]) for form in SCAN_FORMS}
    ms_wide = {form: timer(lambda: ipq.ivf_pq_scan_candidates(
        *cand(form, sub)), **reps[form]) for form in SCAN_FORMS}
    whole = timer(lambda: ipq.ivf_pq_scan(*args, **kwargs), reps=3)
    # the function's least work, as in k4_phase: each probed list's codes
    # and norms read once, the cheaper of the LUT route and the decoded
    # rows' products, k (value, row) pairs a pair out
    sizes = args[6].long()
    probed = args[4].long()
    scanned = int(sizes[probed].sum())
    b, by = scan_bound(int(sizes[torch.unique(probed)].sum()) * (pq_dim + 4)
                       + args[7].numel() * 4 + args[2].numel() * 4
                       + args[3].numel() * 4 + probed.numel() * (4 + k * 8),
                       scanned, pq_dim * pq_len, tf32_products(args[3]),
                       (m * 2 * pq_dim * book * pq_len, scanned * pq_dim))
    plan = iscan.group_plan_on_card("ivf_pq_scan", k, pq_dim * pq_len)
    tiles, tile_rows, gathered = group_tiles(probed, sizes, k)
    log(f"  K4 at the graph pass ({shape}): grouped scan {ms['group']:.3f} "
        f"ms ({tiles} group tiles, plan (queries a group, query tile, "
        f"stages, bytes) {plan}), per-pair {ms['pair']:.3f} ms, the "
        f"default form with the K1 merge {whole:.3f} ms, plain "
        f"{plain_s * 1e3:.1f} ms, bound {b:.4f} ms ({by}); at k="
        f"{iscan.GROUP_MAX_K} on {WIDE_QUERIES} queries grouped "
        f"{ms_wide['group']:.3f} ms, per-pair {ms_wide['pair']:.3f} ms")
    return dict(graph_pass_ms=ms["group"], graph_pass_pair_ms=ms["pair"],
                graph_pass_merged_ms=whole,
                graph_pass_plain_ms=plain_s * 1e3, graph_pass_bound_ms=b,
                graph_pass_bound_by=by, graph_pass_max_abs_err=errs,
                graph_pass_shape=shape, graph_pass_plan=plan,
                graph_pass_group_tiles=tiles,
                graph_pass_blocks=blocks, graph_pass_blocks_per_sm=per_sm,
                graph_pass_scratch_bytes=scratch, graph_pass_split_ms=split,
                wide_k={iscan.GROUP_MAX_K: dict(
                    group_ms=ms_wide["group"], pair_ms=ms_wide["pair"],
                    queries=WIDE_QUERIES)})


def wide_prefix(short, long, what: str) -> None:
    """The first columns of a search at a larger k are the search at the
    smaller k, values bit for bit (one order, exact at every k)."""
    k = short[0].shape[1]
    check_bits(short, (long[0][:, :k].contiguous(),
                       long[1][:, :k].contiguous()), what)


def wide_paths(x, q, bidx, iidx, pidx, sidx, bi, totals) -> dict:
    """The paths past the old limits through the entry points, each with
    the counters reset before it: brute force (K2's wide form + K1) at
    :data:`WIDE_BF_KS` beside k = 256, and its int8 store and 4 shards at
    the last; IVF-Flat and IVF-PQ (20 probes, bf16 LUT) at
    :data:`WIDE_IVF_KS` beside k = 512. Each search's first columns are
    the search at the smaller k, bit for bit. → each path's steady search
    ms by k."""
    ms = {}

    def searches(fn, ks):
        out = {}
        for k in ks:
            fn(k)
            r, t = host_time(lambda: fn(k))
            out[k] = (*r, t)
            log(f"  k={k}: {t * 1e3:.1f} ms ({M / t:.0f} QPS)")
        return out

    bf_ks = (fk.LIST_MAX_K,) + WIDE_BF_KS
    res = run_path("brute force past the k-lists",
                   ("fused_knn", "fused_knn.wide", "select_k"),
                   lambda: searches(lambda k: brute_force.search(bidx, q, k),
                                    bf_ks), totals)
    for a, b in zip(bf_ks, bf_ks[1:]):
        wide_prefix(res[a][:2], res[b][:2], f"brute force k={b}'s first {a} "
                    f"columns against k={a}")
    ms["brute_force"] = {k: r[2] * 1e3 for k, r in res.items()}
    big = WIDE_BF_KS[-1]
    single = res[big][:2]
    check_knn(f"brute force k={big}", *single, big)
    del res
    i8 = brute_force.build(x, dtype="int8")
    res = run_path("brute force int8 past the k-lists",
                   ("fused_knn", "fused_knn.int8", "fused_knn.wide",
                    "select_k"),
                   lambda: searches(lambda k: brute_force.search(i8, q, k),
                                    (fk.LIST_MAX_K, big)), totals)
    wide_prefix(res[fk.LIST_MAX_K][:2], res[big][:2],
                f"brute force int8 k={big}'s first {fk.LIST_MAX_K} columns "
                f"against k={fk.LIST_MAX_K}")
    recall = neighborhood_recall(res[big][1][:, :K], bi)
    log(f"  brute force int8 k={big}: recall@{K} against f32 {recall:.4f}")
    ms["brute_force_int8"] = {k: r[2] * 1e3 for k, r in res.items()}
    del res, i8

    shard = {}
    for eng in rt.ENGINES:
        def run(eng=eng):
            r, t = host_time(lambda: merged_copies(
                lambda: sharded_knn.search(sidx, q, big, merge_engine=eng)))
            log(f"  sharded brute force ({eng}) k={big}: {t * 1e3:.1f} ms")
            return r
        shard[eng] = sharded_run(f"sharded brute force k={big}", eng,
                                 ("fused_knn", "fused_knn.wide"), run,
                                 totals, 1)
    sd, si = check_engines(f"sharded brute force k={big}", shard)
    del shard
    rows_eq = float((si == single[1]).all(dim=1).float().mean())
    recall = neighborhood_recall(si, single[1])
    log(f"  sharded brute force k={big} against the single card's: ids "
        f"equal on {rows_eq:.4f} of rows, shared {recall:.6f}, max |d - "
        f"d_1| {float((sd - single[0]).abs().max()):.3g}")
    if recall < 0.99:
        raise AssertionError(f"sharded brute force k={big}: {recall:.4f}")
    del sd, si, single

    ivf_ks = (iscan.GROUP_MAX_K,) + WIDE_IVF_KS
    for name, idx, mod, scan, sp in (
            ("ivf_flat", iidx, ivf_flat, "ivf_flat_scan",
             ivf_flat.SearchParams(n_probes=N_PROBES)),
            ("ivf_pq", pidx, ivf_pq, "ivf_pq_scan",
             ivf_pq.SearchParams(n_probes=N_PROBES))):
        res = run_path(f"{name} past k=1024", (scan, f"{scan}.group",
                                               f"{scan}.wide", "select_k"),
                       lambda: searches(lambda k: mod.search(idx, q, k, sp),
                                        ivf_ks), totals)
        if counts()[f"{scan}.pair"]:
            raise AssertionError(f"{name}: a per-pair launch past k=512")
        for a, b in zip(ivf_ks, ivf_ks[1:]):
            wide_prefix(res[a][:2], res[b][:2], f"{name} k={b}'s first {a} "
                        f"columns against k={a}")
        for k, (v, i, _) in res.items():
            if v.shape != (M, k) or not bool(((i >= -1) & (i < N)).all()):
                raise AssertionError(f"{name} k={k}: bad shape or ids")
        v, i, _ = res[WIDE_IVF_KS[0]]
        log(f"  {name} k={WIDE_IVF_KS[0]}: recall@{K} against brute force "
            f"{neighborhood_recall(i[:, :K], bi):.4f}; empty slots "
            f"{float((i < 0).float().mean()):.4f}")
        ms[name] = {k: r[2] * 1e3 for k, r in res.items()}
        del res, v, i
    return ms


def wide_cagra(x, q, bi, totals) -> dict:
    """CAGRA built at :data:`WIDE_CAGRA`'s intermediate degrees and routes
    (graph degree 64) on the first :data:`WIDE_CAGRA_ROWS` rows, each with
    the counters reset before it: ``cagra.build``'s stages one by one (the
    kNN graph's own stages timed call by call on the card: K2 and its K1
    merge; the IVF-PQ build, K4, K1's merge and refine), the kNN graph's
    edge recall against the exact neighbors (the exact route's must be 1
    up to ties: its rows are the same brute force), the fused search's
    recall@10 at itopk 64 against brute force on those rows."""
    xc = x[:WIDE_CAGRA_ROWS]
    if WIDE_CAGRA_ROWS < N:
        _, bi = brute_force.search(brute_force.build(xc), q, K)
    out = {}
    for d0, route in WIDE_CAGRA:
        p = cagra.IndexParams(intermediate_graph_degree=d0,
                              graph_degree=CAGRA_DEG, knn_graph_algo=route,
                              seed=SEED)
        kk = d0 + 1 if route == "brute" else 2 * d0 + 1
        if route == "brute":
            taps = {"K2": (fk, "fused_knn_candidates"),
                    "K1 merge": (fk, "kpass_select_k")}
        else:
            taps = {"ivf_pq build": (ivf_pq, "build"),
                    "K4": (ipq, "ivf_pq_scan_candidates"),
                    "K1 merge": (ipq, "kpass_select_k"),
                    "refine": (refine, "refine"),
                    "refine's K1": (refine, "select_k")}
        stages = {}

        def build():
            info = {}
            with contextlib.ExitStack() as stack:
                evs = {name: stack.enter_context(call_events(*tap))
                       for name, tap in taps.items()}
                knn, t_knn = host_time(lambda: cagra.build_knn_graph(
                    xc, d0, p.metric, p.seed, algo=route, info=info))
            stages.update({name: (len(ev.ms()), sum(ev.ms()) / 1e3)
                           for name, ev in evs.items()})
            graph, t_opt = host_time(lambda: cagra.optimize(knn, CAGRA_DEG))
            seeds, t_seeds = host_time(lambda: cagra.build_covering_seeds(
                xc, p))
            gidx = cagra.Index(xc, graph, p.metric, seeds)
            _, t_store = host_time(lambda: cagra.prepare_traversal(gidx))
            cagra.search(gidx, q, K, CAGRA_SP, engine="fused")
            (d, i), t = host_time(lambda: cagra.search(gidx, q, K, CAGRA_SP,
                                                       engine="fused"))
            return knn, info, (t_knn, t_opt, t_seeds, t_store, t), i

        if route == "brute":   # past the k-lists K2 merges its splits
            kernels = ("fused_knn",) + (
                ("fused_knn.wide",) if kk > fk.LIST_MAX_K else ("select_k",))
        else:
            kernels = ("ivf_pq_scan", "ivf_pq_scan.group", "select_k") + (
                ("ivf_pq_scan.wide",) if kk > iscan.GROUP_MAX_K else ())
        knn, info, ts, i = run_path(
            f"cagra {route} build at intermediate degree {d0} (k={kk})",
            kernels + ("cagra_fused",), build, totals)
        moved = counts()
        if info.get("algo") != route or moved["ivf_pq_scan.pair"]:
            raise AssertionError(f"cagra {route} at {d0}: {info}, "
                                 f"{moved['ivf_pq_scan.pair']} per-pair")
        rec = edge_recall(knn, xc, d0, SEED + 2)
        recall = neighborhood_recall(i, bi)
        t_knn, t_opt, t_seeds, t_store, t = ts
        log(f"cagra {route} at intermediate degree {d0} on "
            f"{WIDE_CAGRA_ROWS} rows: knn_graph {t_knn:.3f} s, optimize "
            f"{t_opt:.3f} s, seeds {t_seeds:.3f} s, edge store "
            f"{t_store:.3f} s; kNN graph edge recall {rec:.6f}; fused "
            f"search(itopk={ITOPK}) {t * 1e3:.1f} ms, recall@{K} "
            f"{recall:.4f}; the kNN graph's stages on the card (calls, "
            "seconds): " + ", ".join(f"{name} {n}, {sec:.3f} s" for name,
                                     (n, sec) in stages.items()))
        if route == "brute" and rec < 0.9999:
            raise AssertionError(f"exact graph at {d0}: edge recall {rec}")
        if rec < EDGE_MIN_RECALL:
            raise AssertionError(f"{route} graph at {d0}: edge recall "
                                 f"{rec:.4f} < {EDGE_MIN_RECALL}")
        out[f"{route}_{d0}"] = dict(knn_graph_s=t_knn, optimize_s=t_opt,
                                    edge_recall=rec, fused_recall=recall,
                                    stages_s={name: sec for name, (_, sec)
                                              in stages.items()})
        del knn, i
        torch.cuda.empty_cache()
    return out


K2_WIDE_KS = (32, 65, 129, 257, 1024, 2048)   # K2's wide form: checked, timed


def k2_wide(timer, bidx, q, launches) -> dict:
    """K2's wide form (k past the k-lists' LIST_MAX_K = 24): equal to its
    plain version on integer inputs at each of :data:`K2_WIDE_KS` (l2,
    ip), close to it on the path's data (values slot by slot, ids as sets)
    at k = 1,024 on :data:`WIDE_CHECK_QUERIES` queries; its scratch as the
    library states it against ``fused_knn.wide_scratch_bytes``; timed at
    the brute-force path's shape at each of :data:`K2_WIDE_KS` (a launch:
    the form's splits, their shared bound and its selection, no K1 merge
    after it) beside the plain version, ``addmm`` + ``torch.topk`` at
    k = 1,024 and the bound at each k: the larger of the 3xTF32 products
    and the bytes (queries, rows and norms read once, k (value, id) pairs
    a query written)."""
    x, norms = bidx.dataset, bidx.norms
    rng = np.random.default_rng(SEED + 7)
    qi = torch.from_numpy(rng.integers(-3, 4, (256, 32)).astype(
        np.float32)).cuda()
    xi = torch.from_numpy(rng.integers(-3, 4, (50_000, 32)).astype(
        np.float32)).cuda()
    for metric in ("l2", "ip"):
        for k in K2_WIDE_KS:
            check_equal(fk.fused_knn_plain(qi, xi, k, metric),
                        fk.fused_knn(qi, xi, k, metric),
                        f"K2 wide {metric} (256, 50000, 32) k={k}, integer "
                        "inputs")
    big = WIDE_BF_KS[-1]
    sub = q[:WIDE_CHECK_QUERIES]
    err = check_wide_k(*fk.fused_knn_plain(sub, x, big, "l2", norms),
                       *fk.fused_knn(sub, x, big, "l2", norms),
                       f"K2 wide l2 ({WIDE_CHECK_QUERIES} of {M} queries, "
                       f"{N}, {D}) k={big}")
    qn = fk.prepare_norms("l2", q)
    dn = fk.prepare_norms("l2", x, norms)
    splits = {k: fk._split_plan(M, N, k, D, "l2", x.device)[0]
              for k in K2_WIDE_KS}
    lib_f32 = _cuda.library(_cuda.STORE_SOURCES["fused_knn"]["float32"])
    for k in K2_WIDE_KS:
        on_card = lib_f32.raft_fused_knn_wide_scratch(M, splits[k],
                                                      fk.wide_cap(k))
        if on_card != fk.wide_scratch_bytes(M, splits[k], k):
            raise AssertionError(f"K2 wide k={k}: the library's scratch "
                                 f"{on_card} differs from "
                                 "wide_scratch_bytes'")
    times = {k: timer(lambda: fk.fused_knn_candidates(q, qn, x, dn, None, k,
                                                      "l2"), reps=3)
             for k in K2_WIDE_KS}
    plain = timer(lambda: fk.fused_knn_plain(q, x, big, "l2", norms),
                  reps=1, warmup=0)

    def library():
        for s0 in range(0, M, 1000):
            dist = torch.addmm(norms[None, :], q[s0:s0 + 1000], x.T,
                               alpha=-2.0)
            torch.topk(dist, big, dim=1, largest=False)

    lib = timer(library, reps=3)
    tf = 3 * 2.0 * M * N * D / TF32_FLOPS_PER_S * 1e3
    bounds = {}
    for k in K2_WIDE_KS:
        t_bytes, _ = bound(M * D * 4 + N * (D + 1) * 4 + M * k * 8, 0.0)
        bounds[k] = (t_bytes, "bytes") if t_bytes >= tf else (
            tf, "operations")
    b, by = bounds[big]
    log(f"  K2 wide at ({M}, {N}, {D}): " + ", ".join(
        f"k={k} {t:.2f} ms ({splits[k]} splits, buffers "
        f"{fk.wide_scratch_bytes(M, splits[k], k) / 1e9:.2f} GB)"
        for k, t in times.items())
        + f"; bound at k={big} {b:.2f} ms ({by}; 3xTF32 products {tf:.2f}); "
        f"plain {plain:.1f} ms; addmm + topk(k={big}) {lib:.1f} ms")
    return dict(name="fused_knn.wide", route="cuda",
                source="raft_tpu_torch/csrc/fused_knn.cuh",
                replaces="raft_tpu/ops/fused_knn.py:336", launches=launches,
                max_abs_err=err, ms=times[big], plain_ms=plain, bound_ms=b,
                bound_by=by, bound_kind="3xTF32", library_ms=lib,
                ms_by_k=times, bound_ms_by_k={k: v[0] for k, v in
                                              bounds.items()},
                splits_by_k=splits,
                shape=f"({M}, {N}, {D}) k={big} l2, {splits[big]} corpus "
                f"splits")


def int_tensor(shape, seed):
    """Integers in [-3, 3] of ``shape`` from ``seed``, float32 on the
    card."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-3, 4, shape).astype(
        np.float32)).cuda()


def k3_wide_form(timer, iidx, q, launches) -> dict:
    """The grouped K3 past k = 512 (its wide plan) on the path's IVF-Flat
    index: against the plain version on :data:`WIDE_CHECK_QUERIES` queries
    (values slot by slot, ids as sets) and, on an integer-valued copy of
    the lists and queries, equal to it and, at k = 1,024, to the per-pair
    form bit for bit; each pair's first 512 columns those of the plan at
    512 on the path's data; timed at :data:`WIDE_IVF_KS` on all queries
    beside the plain version and the bound (:func:`scan_bound`, 3xTF32)."""
    probed = iscan.coarse_probe(q, iidx.centers, N_PROBES, "l2",
                                iidx.center_norms).int()
    lists = (iidx.offsets_dev, iidx.sizes_dev)
    mq = WIDE_CHECK_QUERIES
    qn = fk.prepare_norms("l2", q)
    k = WIDE_IVF_KS[0]
    args = (iidx.data, iidx.data_norms, probed[:mq], *lists, q[:mq], k, "l2")
    err = check_wide_k(*iscan.ivf_flat_scan_plain(*args),
                       *iscan.ivf_flat_scan(*args),
                       f"K3 wide at k={k} ({mq} queries, n_probes="
                       f"{N_PROBES})")
    xi, qi = int_tensor(tuple(iidx.data.shape), SEED + 8), int_tensor(
        (mq, D), SEED + 9)
    ni = (xi * xi).sum(1)
    iargs = (xi, ni, probed[:mq], *lists, qi)
    check_equal(iscan.ivf_flat_scan_plain(*iargs, k, "l2"),
                iscan.ivf_flat_scan(*iargs, k, "l2"),
                f"K3 wide at k={k}, integer-valued lists and queries")

    def cand(kk, form=None, a=(iidx.data, iidx.data_norms, q[:mq],
                               qn[:mq])):
        return iscan.ivf_flat_scan_candidates(
            a[0], a[1], None, a[2], a[3], probed[:mq], *lists, kk, "l2",
            form)

    pk = iscan.PAIR_MAX_K
    ia = (xi, ni, qi, fk.prepare_norms("l2", qi))
    check_bits(cand(pk, "pair", ia), cand(pk, None, ia),
               f"K3 wide at k={pk} against the per-pair form, integer-valued "
               "lists (each pair's k columns)")
    del xi, ni, qi, ia
    wv, wi = cand(k)
    sv, si = cand(iscan.GROUP_MAX_K)
    p = probed.shape[1]
    g = iscan.GROUP_MAX_K
    check_bits((wv.view(mq, p, k)[:, :, :g].contiguous(),
                wi.view(mq, p, k)[:, :, :g].contiguous()),
               (sv.view(mq, p, g), si.view(mq, p, g)),
               f"K3 wide at k={k}: each pair's first {g} columns against "
               f"the plan at {g} ({mq} queries)")
    del wv, wi, sv, si
    times = {kk: timer(lambda: iscan.ivf_flat_scan_candidates(
        iidx.data, iidx.data_norms, None, q, qn, probed, *lists, kk, "l2"),
        reps=3) for kk in WIDE_IVF_KS}
    plain = timer(lambda: iscan.ivf_flat_scan_plain(
        iidx.data, iidx.data_norms, probed, *lists, q, k, "l2"), reps=1,
        warmup=0)
    sizes = iidx.sizes_dev.long()
    scanned = int(sizes[probed.long()].sum())
    distinct = int(sizes[torch.unique(probed)].sum())
    b, by = scan_bound(distinct * (D + 1) * 4 + M * D * 4
                       + M * N_PROBES * (4 + k * 8), scanned, D, 3)
    # the library's plan and scratch against their Python statement
    plan = iscan.group_plan_on_card("ivf_flat_scan", k, D)
    lmax = iscan.largest_list(iidx.sizes_dev)
    scratch = iscan.wide_scratch_on_card("ivf_flat_scan", k, D, lmax)
    smem, a_res, ns = iscan.group_smem("ivf_flat_scan", k, D)
    if (plan != (iscan.group_queries(k), a_res, ns, smem)
            or scratch[0] != iscan.wide_scratch_bytes(scratch[1], lmax)):
        raise AssertionError(f"K3 wide: the library's plan {plan} / "
                             f"scratch {scratch} differ from group_smem's "
                             "and wide_scratch_bytes'")
    log(f"  K3 wide ({M} queries x {N_PROBES} probes): " + ", ".join(
        f"k={kk} {t:.3f} ms" for kk, t in times.items())
        + f"; plain at k={k} {plain:.1f} ms; bound {b:.4f} ms ({by}); plan "
        f"(queries a group, query tile, stages, bytes) {plan}; scratch "
        f"{scratch[0] / 1e6:.1f} MB, {scratch[1]} persistent blocks "
        f"({scratch[2]} an SM)")
    return dict(name="ivf_flat_scan.wide", route="cuda",
                source="raft_tpu_torch/csrc/ivf_flat_scan.cuh",
                replaces="raft_tpu/ops/ivf_scan.py:284", launches=launches,
                max_abs_err=err, ms=times[k], plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None, ms_by_k=times, plan=plan,
                scratch=scratch,
                shape=f"{M} queries x {N_PROBES} probes, k={k}")


def k4_wide_form(timer, pidx, q, pass_call, launches) -> dict:
    """The grouped K4 past k = 512 (its wide plan selecting in rounds): on
    the path's index (bf16 LUT) against the plain version on
    :data:`WIDE_CHECK_QUERIES` queries and, each pair's first 512 columns,
    the plan at 512; on an integer-valued copy of the graph pass's batch
    equal to the plain version at k = 1,025 and to the per-pair form at
    1,024; at the pass batches of intermediate degree 256 (k = 513,
    ``cagra.pass_batch``'s rows) and 512 (k = 1,025) timed, the first in
    both forms (the grouped must be faster); at the path's shape timed at
    :data:`WIDE_IVF_KS` beside the plain version and the bound."""
    q_rot = (q @ pidx.rotation.T).contiguous()
    probed = iscan.coarse_probe(q_rot, pidx.centers_rot, N_PROBES, "l2",
                                pidx.center_norms).int()
    cb = ipq.lut_codebook(pidx.codebooks, "bf16").contiguous()
    mq = WIDE_CHECK_QUERIES
    k = WIDE_IVF_KS[0]

    def args(m):
        return (pidx.codes, pidx.row_norms, pidx.centers_rot, cb,
                probed[:m], pidx.offsets_dev, pidx.sizes_dev, q_rot[:m])

    err = check_wide_k(*ipq.ivf_pq_scan_plain(*args(mq), k),
                       *ipq.ivf_pq_scan(*args(mq), k),
                       f"K4 wide at k={k} ({mq} queries, bf16 LUT)")

    def cand(a, kk, form=None, metric="l2"):
        return ipq.ivf_pq_scan_candidates(
            a[0], a[1].float().contiguous() if metric == "l2" else None,
            None, a[3], a[2].float().contiguous(), a[7], a[4], a[5], a[6],
            kk, metric, form)

    g = iscan.GROUP_MAX_K
    wv, wi = cand(args(mq), k)
    sv, si = cand(args(mq), g)
    check_bits((wv.view(mq, N_PROBES, k)[:, :, :g].contiguous(),
                wi.view(mq, N_PROBES, k)[:, :, :g].contiguous()),
               (sv.view(mq, N_PROBES, g), si.view(mq, N_PROBES, g)),
               f"K4 wide at k={k}: each pair's first {g} columns against "
               f"the plan at {g} ({mq} queries)")
    del wv, wi, sv, si
    # an integer-valued copy of the graph pass's batch (its codes, lists
    # and probes; integer codebook with an entry of 127 a subspace, so the
    # int8 LUT's scale is 1; integer centers and queries)
    pa, _ = pass_call
    pq_dim, book, pq_len = pa[3].shape
    icb = int_tensor((pq_dim, book, pq_len), SEED + 10)
    icb[:, 0, 0] = 127.0
    centers = int_tensor(tuple(pa[2].shape), SEED + 11)
    dn = ipq.decoded_row_norms(pa[0], centers, icb, np.append(
        pa[5].cpu().numpy(), pa[0].shape[0]))
    qi = int_tensor((mq, pa[7].shape[1]), SEED + 12)
    ia = (pa[0], dn, centers, ipq.lut_codebook(icb, "int8"), pa[4][:mq],
          pa[5], pa[6], qi)
    for metric in ("l2", "ip"):
        check_equal(ipq.ivf_pq_scan_plain(*ia, k, metric),
                    ipq.ivf_pq_scan(*ia, k, metric),
                    f"K4 wide at k={k}, {metric}, integer codebook/centers/"
                    f"queries (the graph pass's codes and probes, {mq} "
                    "queries)")
        pk = iscan.PAIR_MAX_K
        check_bits(cand(ia, pk, "pair", metric), cand(ia, pk, None, metric),
                   f"K4 wide at k={pk} against the per-pair form, {metric}, "
                   "integer copy (each pair's k columns)")
    del dn, icb, centers, qi, ia
    # the graph pass's batches past 256: its rows at degree 256 and 512
    n_probes = pa[4].shape[1]
    rows = {kk: cagra.pass_batch(CAGRA_BATCH, n_probes, kk)
            for kk in (2 * 256 + 1, 2 * 512 + 1)}
    pass_ms, pass_bound = {}, {}
    sizes = pa[6].long()
    for kk, m in rows.items():
        sub = list(pa)
        sub[4], sub[7] = pa[4][:m], pa[7][:m]
        pass_ms[kk] = timer(lambda: cand(sub, kk), reps=3)
        # as the graph pass's bound (k4_graph_pass): each probed list's
        # codes and norms read once, the cheaper of the LUT route and the
        # decoded rows' products, k (value, row) pairs a pair out
        pl = sub[4].long()
        scanned = int(sizes[pl].sum())
        pass_bound[kk] = scan_bound(
            int(sizes[torch.unique(pl)].sum()) * (pq_dim + 4)
            + sub[7].numel() * 4 + pa[2].numel() * 4 + pa[3].numel() * 4
            + pl.numel() * (4 + kk * 8),
            scanned, pq_dim * pq_len, tf32_products(pa[3]),
            (m * 2 * pq_dim * book * pq_len, scanned * pq_dim))
    kk, m = next(iter(rows.items()))
    sub = list(pa)
    sub[4], sub[7] = pa[4][:m], pa[7][:m]
    pass_pair = timer(lambda: cand(sub, kk, "pair"), reps=1, warmup=1)
    log(f"  K4 at the graph pass's batches past k=256: " + ", ".join(
        f"k={kk} on {m} rows grouped {pass_ms[kk]:.3f} ms, bound "
        f"{pass_bound[kk][0]:.3f} ms ({pass_bound[kk][1]})" for kk, m in
        rows.items()) + f"; per-pair at k={kk} on {m} rows {pass_pair:.3f} "
        "ms")
    if pass_ms[kk] >= pass_pair:
        raise AssertionError(f"K4 at the pass's k={kk}: grouped "
                             f"{pass_ms[kk]:.3f} ms not below per-pair "
                             f"{pass_pair:.3f} ms")
    times = {kk: timer(lambda: cand(args(M), kk), reps=3)
             for kk in WIDE_IVF_KS}
    plain = timer(lambda: ipq.ivf_pq_scan_plain(*args(M), k), reps=1,
                  warmup=0)
    # the library's scratch at the path against its Python statement
    lmax = iscan.largest_list(pidx.sizes_dev)
    scratch = iscan.wide_scratch_on_card("ivf_pq_scan", k, q_rot.shape[1],
                                         lmax)
    if scratch[0] != iscan.wide_scratch_bytes(scratch[1], lmax):
        raise AssertionError(f"K4 wide: the library's scratch {scratch} "
                             "differs from wide_scratch_bytes'")
    sizes = pidx.sizes_dev.long()
    pl = probed.long()
    pq_d, bk, pq_l = cb.shape
    scanned = int(sizes[pl].sum())
    b, by = scan_bound(int(sizes[torch.unique(pl)].sum()) * (pq_d + 4)
                       + q_rot.numel() * 4 + pidx.centers_rot.numel() * 4
                       + cb.numel() * 4 + pl.numel() * (4 + k * 8),
                       scanned, pq_d * pq_l, tf32_products(cb),
                       (M * 2 * pq_d * bk * pq_l, scanned * pq_d))
    log(f"  K4 wide ({M} queries x {N_PROBES} probes, bf16 LUT): "
        + ", ".join(f"k={kk} {t:.3f} ms" for kk, t in times.items())
        + f"; plain at k={k} {plain:.1f} ms; bound {b:.4f} ms ({by}); "
        f"scratch {scratch[0] / 1e6:.1f} MB, {scratch[1]} persistent "
        f"blocks ({scratch[2]} an SM)")
    return dict(name="ivf_pq_scan.wide", route="cuda",
                source="raft_tpu_torch/csrc/ivf_pq_scan.cu",
                replaces="raft_tpu/ops/ivf_pq_scan.py:290",
                launches=launches, max_abs_err=err, ms=times[k],
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
                ms_by_k=times, pass_ms=pass_ms, pass_rows=rows,
                pass_bound_ms={kk: v[0] for kk, v in pass_bound.items()},
                pass_bound_by={kk: v[1] for kk, v in pass_bound.items()},
                pass_pair_ms=pass_pair,
                shape=f"{M} queries x {N_PROBES} probes, pq_dim={PQ_DIM}, "
                f"bf16 LUT, k={k}")


def wide_k_phase(timer, x, q, bidx, iidx, pidx, sidx, pass_call, totals):
    """The paths past the kernels' old limits (:func:`wide_paths`,
    :func:`wide_cagra`), then the new forms against their plain versions
    and timed (:func:`k2_wide`, :func:`k3_wide_form`,
    :func:`k4_wide_form`) → their kernel rows, launches from the paths,
    and K1's radix select past k = 512 at the paths' merges
    (:func:`k1_radix_wide`)."""
    _, bi = brute_force.search(bidx, q, K)
    before = {kern: totals[kern] for kern in ("fused_knn.wide",
                                              "ivf_flat_scan.wide",
                                              "ivf_pq_scan.wide")}
    # K1's radix select past k = 512 at the merges these paths hand it: the
    # IVF-Flat search's at the widest k, the IVF-PQ pass's at intermediate
    # degrees 256 and 512 and the degree-512 pass's refine (brute force's
    # wide form merges its splits itself)
    big_ivf = WIDE_IVF_KS[-1]
    pass_d0 = [d0 for d0, route in WIDE_CAGRA if route == "ivf_pq"]
    with captured(iscan, "kpass_select_k",
                  lambda v, k, *a, **kw: k == big_ivf,
                  counter="select_k.radix") as cap_ivf:
        paths = wide_paths(x, q, bidx, iidx, pidx, sidx, bi, totals)
    k1_rows = [k1_radix_wide(timer, f"IVF-Flat search merge, k={big_ivf}",
                             cap_ivf)]
    del cap_ivf
    with contextlib.ExitStack() as stack:
        caps = [stack.enter_context(captured(
            ipq, "kpass_select_k",
            lambda v, k, *a, kk=2 * d0 + 1, **kw: k == kk, to_host=True,
            counter="select_k.radix")) for d0 in pass_d0]
        # the refine that follows the widest pass selects d0 + 1 of its
        # 2·d0 + 1 candidates a row
        caps.append(stack.enter_context(captured(
            refine, "select_k", lambda v, k, *a, kk=pass_d0[-1] + 1,
            **kw: k == kk and v.shape[1] == 2 * kk - 1, to_host=True,
            counter="select_k.radix")))
        routes = wide_cagra(x, q, bi, totals)
    for d0, cap in zip(pass_d0, caps):
        k1_rows.append(k1_radix_wide(
            timer, f"IVF-PQ pass merge at intermediate degree {d0}, "
            f"k={2 * d0 + 1}", cap))
    k1_rows.append(k1_radix_wide(
        timer, f"IVF-PQ pass refine at intermediate degree {pass_d0[-1]}, "
        f"k={pass_d0[-1] + 1}", caps[-1]))
    del caps
    launches = {kern: totals[kern] - n for kern, n in before.items()}
    # the wide form's launches on every path so far (the CAGRA builds at
    # k = 129, the bench's, this phase's)
    rows = [k2_wide(timer, bidx, q, totals["fused_knn.wide"]),
            k3_wide_form(timer, iidx, q, launches["ivf_flat_scan.wide"]),
            k4_wide_form(timer, pidx, q, pass_call,
                         launches["ivf_pq_scan.wide"])]
    rows[0].update(search_ms=paths["brute_force"],
                   int8_search_ms=paths["brute_force_int8"],
                   cagra_routes=routes,
                   cagra_exact_knn_graph_s=routes["brute_256"]["knn_graph_s"],
                   wide_k_phase_launches=launches["fused_knn.wide"])
    rows[1].update(search_ms=paths["ivf_flat"])
    rows[2].update(search_ms=paths["ivf_pq"])
    return rows, k1_rows


def k1_radix_wide(timer, what: str, cap) -> dict:
    """K1's radix select on a merge input past k = 512 as the path handed
    it (``cap``: the first of the calls that matched, and their count):
    bit for bit against its plain version, values equal to
    ``torch.topk``'s; the card's time alone (``device_ms``) beside
    ``torch.topk``'s event time on the same input and the bytes bound (the
    input read once, k (value, column) pairs a row written); launches:
    the growth of ``select_k.radix`` across the paths' calls at this k,
    one a call."""
    if cap.call is None:
        raise AssertionError(f"K1 {what}: the path made no such merge")
    if cap.launches != cap.n:
        raise AssertionError(f"K1 {what}: {cap.n} merges on the paths "
                             f"launched the radix form {cap.launches} "
                             "times")
    v, k = cap.call[0][0].cuda(), cap.call[0][1]
    rows, n = v.shape
    got = sk.kpass_select_k(v, k, form="radix")
    check_bits(sk.select_k_plain(v, k), got,
               f"K1 radix {what} ({rows}, {n}), the path's values")
    tv, _ = torch.topk(v, k, dim=1, largest=False)
    if not torch.equal(got[0], tv):
        raise AssertionError(f"K1 {what}: values differ from torch.topk's")
    del got, tv
    ms = device_ms(lambda: sk.kpass_select_k(v, k, form="radix"))
    lib = timer(lambda: torch.topk(v, k, dim=1, largest=False), reps=3)
    b, by = bound(rows * n * 4 + rows * k * 8, 0.0, float(rows) * n)
    log(f"  K1 radix {what} ({rows}, {n}): alone {ms:.3f} ms, torch.topk "
        f"{lib:.3f} ms, bound {b:.4f} ms by {by}; {cap.launches} launches "
        "on the paths")
    return dict(what=what, shape=f"({rows}, {n}) k={k}", form="radix",
                launches=cap.launches, radix_device_ms=ms, library_ms=lib,
                bound_ms=b, bound_by=by)


def k6_itopk256(timer, call) -> dict:
    """K6 at the bench sweep's widest buffer (itopk 256 over the bench
    index's degree-32 store), as the path handed it, against its plain
    version; both timed."""
    args, kwargs = call
    kd, ki, hops, _ = cf.fused_traverse_kernel(*args, **kwargs)
    (pd, pi), plain_s = host_time(lambda: cf.fused_traverse_plain(*args,
                                                                  **kwargs))
    err = check_equal((pd, pi), (kd, ki), "K6 cagra_fused at itopk 256 "
                      f"(the bench index, {args[0].shape[0]} queries, "
                      f"{kwargs['max_iter']} hops max)")
    ms = timer(lambda: cf.fused_traverse_kernel(*args, **kwargs), reps=3)
    st = args[3]
    log(f"  K6 at itopk 256, tiles {st.shape[1]} x {st.shape[2]}: "
        f"{ms:.3f} ms ({float(hops.float().mean()):.2f} hops a query), "
        f"plain {plain_s * 1e3:.1f} ms")
    return dict(itopk256_ms=ms, itopk256_plain_ms=plain_s * 1e3,
                itopk256_max_abs_err=err,
                itopk256_mean_hops=float(hops.float().mean()))


# ---- the stores phase: brute force and IVF-Flat in low-precision stores ----

BF_STORES = ("bfloat16", "int8", "int4")    # brute force on the path's data
IVF_STORES = ("bfloat16", "int8")           # IVF-Flat on the path's data
BF16_MIN_RECALL = 0.95      # tests/test_brute_force.py's floor for bf16
# uint8 on the byte grid: its distances (~1e5) are what is left of
# ||q||² + ||x||² - 2·q·x at ~1e7 each, so the float32 rounding of the two
# orders of summation (a few units) is held relative to the norms
# (``uint8_scale``), and ids on >= 95% of the rows (near ties are dense
# there); the form is also held bit for bit to the f32 form on the same
# byte rows
STORE_ROWS_EQUAL = {"uint8": 0.95}


def uint8_scale(qq, norms) -> float:
    """The magnitude the expanded L2 formula's rounding scales with."""
    return float((qq * qq).sum(1).max() + norms.max())
INT4_ODD_DIM, INT4_ODD_ROWS = 100, 200_000   # int4 at half_p 64 < d / 2
BF16_FLOPS_PER_S = 989e12      # H100 SXM, dense bf16 on the tensor cores


class no_plain:
    """Fail if a plain version of K2 or K3 runs inside the ``with`` block
    (the store paths must go through the kernels)."""

    SITES = ((fk, "fused_knn_plain"), (brute_force, "fused_knn_plain"),
             (iscan, "ivf_flat_scan_plain"),
             (ivf_flat, "ivf_flat_scan_plain"))

    def __enter__(self):
        self.orig = [getattr(m, n) for m, n in self.SITES]

        def refuse(*args, **kwargs):
            raise AssertionError("a plain version ran on a store path")

        for m, n in self.SITES:
            setattr(m, n, refuse)
        return self

    def __exit__(self, *exc):
        for (m, n), f in zip(self.SITES, self.orig):
            setattr(m, n, f)


def store_path(name: str, kern: str, store: str, fn, totals: dict,
               extra=()):
    """:func:`run_path` for a store path, with no plain version allowed:
    every launch of ``kern`` (K2 or K3) on it must be the store's form."""
    with no_plain():
        out = run_path(name, (kern, f"{kern}.{store}", "select_k", *extra),
                       fn, totals)
    moved = counts()
    if moved[kern] != moved[f"{kern}.{store}"]:
        raise AssertionError(f"{name}: {moved[kern]} launches of {kern}, "
                             f"{moved[f'{kern}.{store}']} of its {store} form")
    return out


def int_store(store: str, n: int, d: int, m: int, seed: int):
    """Integer-valued rows a store holds exactly at a scale of 1 (bf16 in
    [-8, 8]; int8 in [-127, 127] and int4 in [-7, 7], each row reaching the
    bound in its first column; uint8 bytes) and integer queries, so every
    dot and distance is exact in float32 → (f32 rows, queries) on the
    card."""
    rng = np.random.default_rng(seed)
    if store == "uint8":
        x = rng.integers(0, 256, (n, d))
        q = rng.integers(0, 256, (m, d))
    else:
        lim = {"bfloat16": 8, "int8": 127, "int4": 7}[store]
        x = rng.integers(-lim, lim + 1, (n, d))
        if store != "bfloat16":
            x[:, 0] = np.where(rng.random(n) < 0.5, -lim, lim)
        q = rng.integers(-3, 4, (m, d))
    return (torch.from_numpy(x.astype(np.float32)).cuda(),
            torch.from_numpy(q.astype(np.float32)).cuda())


def stores_phase(x, q, totals):
    """The stores through the public entry points, each path with the
    counters reset before it, no plain version allowed, and every K2 or
    K3 launch the store's form: brute force at bf16, int8 and int4 on the
    path's data (QPS, recall@10 against the f32 index's ids; bf16 held at
    >= BF16_MIN_RECALL), uint8 on the bench's byte-grid remap of the
    path's data (ids equal to the f32 index's on the same byte rows;
    whether the values are bit-equal is printed), IVF-Flat at bf16 and
    int8 (n_lists 1024, n_probes 20) and uint8 on the remapped data.
    → the indexes and queries the kernel checks take."""
    (_, ref_i), _ = host_time(lambda: brute_force.search(
        brute_force.build(x), q, K))
    out = {"x": x, "q": q}
    for store in BF_STORES:
        def path(store=store):
            idx, t_build = host_time(lambda: brute_force.build(x,
                                                               dtype=store))
            _, t_first = host_time(lambda: brute_force.search(idx, q, K))
            (v, i), t = host_time(lambda: brute_force.search(idx, q, K))
            return idx, v, i, t_build, t_first, t

        idx, v, i, tb, tf, t = store_path(f"brute_force.{store}",
                                          "fused_knn", store, path, totals)
        check_knn(f"brute_force.{store}", v, i, K)
        recall = neighborhood_recall(i, ref_i)
        mib = (idx.dataset.numel() * idx.dataset.element_size()
               + (0 if idx.scales is None else idx.scales.numel() * 4)) / 2**20
        log(f"brute_force.{store}: build {tb:.3f} s ({mib:.1f} MiB stored), "
            f"search(k={K}) first {tf * 1e3:.1f} ms, steady {t * 1e3:.1f} "
            f"ms, {M / t:.0f} QPS, recall@{K} vs the f32 index {recall:.4f}")
        if store == "bfloat16" and recall < BF16_MIN_RECALL:
            raise AssertionError(f"bf16 brute-force recall {recall:.4f} < "
                                 f"{BF16_MIN_RECALL}")
        out[f"bf.{store}"] = idx

    # uint8: the bench's byte-grid remap of the path's rows and queries
    xb, qb = bench.byte_grid(x, q, "sqeuclidean",
                             ("raft_brute_force", "raft_ivf_flat"))
    f32b = brute_force.build(xb)
    fv, fi = brute_force.search(f32b, qb, K)
    del f32b

    def u8_path():
        idx, t_build = host_time(lambda: brute_force.build(xb,
                                                           dtype="uint8"))
        _, t_first = host_time(lambda: brute_force.search(idx, qb, K))
        (v, i), t = host_time(lambda: brute_force.search(idx, qb, K))
        return idx, v, i, t_build, t_first, t

    idx, v, i, tb, tf, t = store_path("brute_force.uint8", "fused_knn",
                                      "uint8", u8_path, totals)
    if not torch.equal(i, fi):
        raise AssertionError("uint8 brute force: ids differ from the f32 "
                             "index's on the same byte rows")
    same_bits = torch.equal(v.view(torch.int32), fv.view(torch.int32))
    log(f"brute_force.uint8 (byte grid): build {tb:.3f} s, search first "
        f"{tf * 1e3:.1f} ms, steady {t * 1e3:.1f} ms, {M / t:.0f} QPS; ids "
        f"equal to the f32 index's on the same rows; values bit-equal: "
        f"{same_bits}")
    out.update({"bf.uint8": idx, "xb": xb, "qb": qb})

    for store in IVF_STORES + ("uint8",):
        rows, qq, ref = (xb, qb, fi) if store == "uint8" else (x, q, ref_i)

        def ivf_path(store=store, rows=rows, qq=qq):
            params = ivf_flat.IndexParams(n_lists=N_LISTS, seed=SEED,
                                          dtype=store)
            idx, t_build = host_time(lambda: ivf_flat.build(rows, params))
            sp = ivf_flat.SearchParams(n_probes=N_PROBES)
            _, t_first = host_time(lambda: ivf_flat.search(idx, qq, K, sp))
            (v, i), t = host_time(lambda: ivf_flat.search(idx, qq, K, sp))
            return idx, v, i, t_build, t_first, t

        name = f"ivf_flat.{store}"
        idx, v, i, tb, tf, t = store_path(name, "ivf_flat_scan", store,
                                          ivf_path, totals,
                                          ("ivf_flat_scan.group",))
        check_scan_forms(name, "ivf_flat_scan", 2)
        check_knn(name, v, i, K)
        recall = neighborhood_recall(i, ref)
        log(f"{name}{' (byte grid)' if store == 'uint8' else ''}: build "
            f"{tb:.3f} s, search(n_probes={N_PROBES}, k={K}) first "
            f"{tf * 1e3:.1f} ms, steady {t * 1e3:.1f} ms, {M / t:.0f} QPS, "
            f"recall@{K} vs f32 brute force on the same rows {recall:.4f}")
        if store != "int8" and recall < 0.90:
            raise AssertionError(f"{name} recall {recall:.4f} < 0.90")
        out[f"ivf.{store}"] = idx
    return out


def ptxas_usage(text: str):
    """(most registers, most spill-store bytes) over the kernels of one
    library's ``nvcc -Xptxas -v`` output."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                         text)]
    return max(regs, default=0), max(spills, default=0)


def k2_store_phase(timer, st, moved, logs) -> list:
    """K2's store forms: equal to the plain version on integer-valued
    stores (k = 10 and 129), close to it on the path's stores (512
    queries; int4 also at d = 100, half_p 64, on 200,000 rows), each timed
    at the path's shape (10,000 queries, 1M rows, k = 10) beside its plain
    version and one library call: the bf16 GEMM + ``torch.topk``
    (bfloat16), dequantize + the f32 GEMM + ``torch.topk`` (the others).
    The bound is the product's least time: one pass at the bf16 rate for
    bf16 (its products exact), two TF32 passes (2xTF32) for the byte and
    int4 stores, the bytes read once being far less. Each form's
    registers and spills come from this run's build (``logs``, ptxas -v;
    "cached" when the libraries were built before), and a spill fails
    the phase."""
    rows = []
    for store in ("bfloat16", "int8", "uint8", "int4"):
        lib_name = _cuda.STORE_SOURCES["fused_knn"][store]
        if lib_name in logs:
            regs, spill = ptxas_usage(logs[lib_name])
            usage = f"{regs} registers at most, {spill} bytes of spill"
            if spill:
                raise AssertionError(f"K2.{store}: {usage}")
        else:
            regs = spill = None
            usage = "registers not read (cached build)"
        idx = st[f"bf.{store}"]
        qq = st["qb"] if store == "uint8" else st["q"]
        xs, sc, dim4, norms = (idx.dataset, idx.scales, idx.logical_dim,
                               idx.norms)
        xi, qi = int_store(store, 50_000, 32, 256, SEED + 11)
        si, ssc = quant.quantize_rows(xi, store)
        d4i = 32 if store == "int4" else None
        for k in (K, CAGRA_D0 + 1):
            check_equal(fk.fused_knn_plain(qi, si, k, "l2", scales=ssc,
                                           int4_dim=d4i),
                        fk.fused_knn(qi, si, k, "l2", scales=ssc,
                                     int4_dim=d4i),
                        f"K2.{store} l2 (256, 50000, 32) k={k}, integer "
                        "store")
        sub = qq[:512]
        pv, pi = fk.fused_knn_plain(sub, xs, K, "l2", norms, None, sc, dim4)
        kv, ki = fk.fused_knn(sub, xs, K, "l2", norms, None, sc, dim4)
        err = check_close(pv, pi, kv, ki, f"K2.{store} l2 (512 of {M} "
                          f"queries, {N}, {D}) k={K}",
                          STORE_ROWS_EQUAL.get(store, 0.99),
                          uint8_scale(sub, norms) if store == "uint8"
                          else None)
        extra = {}
        if store == "uint8":
            check_bits(fk.fused_knn(sub, st["xb"], K, "l2", norms), (kv, ki),
                       "K2.uint8 against the f32 form on the same byte rows "
                       "(512 queries)")
        if store == "int4":
            xo = st["x"][:INT4_ODD_ROWS, :INT4_ODD_DIM]
            po = brute_force.build(xo, dtype="int4")
            qo = sub[:, :INT4_ODD_DIM]
            pv, pi = fk.fused_knn_plain(qo, po.dataset, K, "l2", po.norms,
                                        None, po.scales, INT4_ODD_DIM)
            kv, ki = fk.fused_knn(qo, po.dataset, K, "l2", po.norms, None,
                                  po.scales, INT4_ODD_DIM)
            extra["d100_max_abs_err"] = check_close(
                pv, pi, kv, ki, f"K2.int4 l2 (512, {INT4_ODD_ROWS}, "
                f"{INT4_ODD_DIM}: half_p {po.dataset.shape[1]}) k={K}")
            del po
        qk = fk.kernel_queries(qq, store, xs.shape[1]).contiguous()
        qn = fk.prepare_norms("l2", qq)
        dn = fk.prepare_norms("l2", None, norms)
        ms = timer(lambda: fk.fused_knn_candidates(qk, qn, xs, dn, None, K,
                                                   "l2", sc, store))
        splits, _ = fk._split_plan(M, N, K, qk.shape[1], "l2", xs.device,
                                   store)
        plain = timer(lambda: fk.fused_knn_plain(qq, xs, K, "l2", norms,
                                                 None, sc, dim4),
                      reps=1, warmup=0)

        def library():
            if store == "bfloat16":
                a, b = qq.to(torch.bfloat16), xs
                nb = norms.to(torch.bfloat16)
            else:
                a, b, nb = qq, quant.dequantize_store(xs, sc, dim4), norms
            for s0 in range(0, M, 1000):
                dist = torch.addmm(nb[None, :], a[s0:s0 + 1000], b.T,
                                   alpha=-2.0)
                torch.topk(dist, K, dim=1, largest=False)

        lib = timer(library, reps=3)
        flops = 2.0 * M * N * D
        if store == "bfloat16":
            t_ops, kind = flops / BF16_FLOPS_PER_S * 1e3, "bf16"
        else:
            t_ops, kind = 2 * flops / TF32_FLOPS_PER_S * 1e3, "2xTF32"
        n_bytes = (xs.numel() * xs.element_size() + M * D * 4 + N * 4
                   + (0 if sc is None else N * 4) + M * splits * K * 8)
        t_bytes, _ = bound(n_bytes, 0.0)
        by = "operations" if t_ops >= t_bytes else "bytes"
        launches = moved[f"fused_knn.{store}"]
        log(f"  K2.{store} at ({M}, {N}, {D}) k={K}: {ms:.2f} ms ({splits} "
            f"splits); {kind} bound {t_ops:.2f} ms ({t_ops / ms:.1%} of it), "
            f"bytes {t_bytes:.3f} ms; plain {plain:.1f} ms, library "
            f"{lib:.2f} ms; launches {launches}; {usage}")
        rows.append(dict(
            name=f"fused_knn.{store}", route="cuda",
            source=f"raft_tpu_torch/csrc/fused_knn_{store}.cu",
            replaces="raft_tpu/ops/fused_knn.py:336", launches=launches,
            max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=max(t_ops, t_bytes), bound_by=by, bound_kind=kind,
            library_ms=lib, bytes_bound_ms=t_bytes, splits=splits,
            registers=regs, spill_bytes=spill,
            shape=f"({M}, {N}, {D}) k={K} l2, {store} corpus"
                  + (" (byte grid)" if store == "uint8" else ""),
            **extra))
    return rows


def k3_store_phase(timer, st, moved, f32_ms: float) -> list:
    """K3's store forms in both forms on the path's store indexes
    (uint8 on the byte grid) against the plain version, each launched
    twice, bit-equal; equal to it on integer-valued stores (a 50,000-row
    index of each store, and the uint8 path index with its queries
    rounded to bytes); both forms timed at the path's shape, beside the
    f32 form's grouped time of this run (``f32_ms``). The bound is 2xTF32
    over the (pair, row) products, the bytes read once being less."""
    rows = []
    for store in ("bfloat16", "int8", "uint8"):
        idx = st[f"ivf.{store}"]
        qq = st["qb"] if store == "uint8" else st["q"]
        sc = idx.scales
        probed = iscan.coarse_probe(qq, idx.centers, N_PROBES, "l2",
                                    idx.center_norms)
        args = (idx.data, idx.data_norms, probed, idx.offsets_dev,
                idx.sizes_dev, qq, K, "l2")
        pv, pi = iscan.ivf_flat_scan_plain(*args, scales=sc)
        errs = {}
        for form in SCAN_FORMS:
            kv, ki = iscan.ivf_flat_scan(*args, form=form, scales=sc)
            what = (f"K3.{store} {form} form ({M} queries, n_probes="
                    f"{N_PROBES}) k={K}")
            errs[form] = check_close(pv, pi, kv, ki, what,
                                     STORE_ROWS_EQUAL.get(store, 0.99),
                                     uint8_scale(qq, idx.data_norms)
                                     if store == "uint8" else None)
            check_bits((kv, ki), iscan.ivf_flat_scan(*args, form=form,
                                                     scales=sc),
                       f"{what}, launched twice")
        # integer-valued: a small index of the store (uint8: the path's
        # index with its queries rounded to bytes)
        if store == "uint8":
            qi = torch.round(qq[:2000])
            ia = (idx.data, idx.data_norms,
                  iscan.coarse_probe(qi, idx.centers, N_PROBES, "l2",
                                     idx.center_norms),
                  idx.offsets_dev, idx.sizes_dev, qi, K, "l2")
            isc = sc
        else:
            xi, qi = int_store(store, 50_000, 32, 2000, SEED + 12)
            small = ivf_flat.build(xi, ivf_flat.IndexParams(
                n_lists=64, seed=SEED, dtype=store))
            ia = (small.data, small.data_norms,
                  iscan.coarse_probe(qi, small.centers, 8, "l2",
                                     small.center_norms),
                  small.offsets_dev, small.sizes_dev, qi, K, "l2")
            isc = small.scales
        ref = iscan.ivf_flat_scan_plain(*ia, scales=isc)
        for form in SCAN_FORMS:
            check_equal(ref, iscan.ivf_flat_scan(*ia, form=form,
                                                 scales=isc),
                        f"K3.{store} {form} form, integer store")
        qn = fk.prepare_norms("l2", qq)

        def launch(form):
            return iscan.ivf_flat_scan_candidates(
                idx.data, idx.data_norms, None, qq, qn, probed.int(),
                idx.offsets_dev, idx.sizes_dev, K, "l2", form, sc)

        times = {form: timer(lambda: launch(form)) for form in SCAN_FORMS}
        plain = timer(lambda: iscan.ivf_flat_scan_plain(*args, scales=sc),
                      reps=1, warmup=0)
        sizes = idx.sizes_dev.long()
        scanned = int(sizes[probed.long()].sum())
        distinct = int(sizes[torch.unique(probed)].sum())
        t_ops = 2 * 2.0 * D * scanned / TF32_FLOPS_PER_S * 1e3
        elem = idx.data.element_size()
        t_bytes, _ = bound(distinct * (D * elem + 4 + (4 if sc is not None
                                                       else 0))
                           + M * D * 4 + M * N_PROBES * (4 + K * 8), 0.0)
        by = "operations" if t_ops >= t_bytes else "bytes"
        launches = moved[f"ivf_flat_scan.{store}"]
        log(f"  K3.{store}: grouped {times['group']:.3f} ms (the f32 "
            f"form's {f32_ms:.3f} ms), per-pair {times['pair']:.3f} ms over "
            f"{scanned} (pair, row) products; 2xTF32 bound {t_ops:.4f} ms, "
            f"bytes {t_bytes:.4f} ms; plain {plain:.1f} ms; launches "
            f"{launches}")
        rows.append(dict(
            name=f"ivf_flat_scan.{store}", route="cuda",
            source=f"raft_tpu_torch/csrc/ivf_flat_scan_{store}.cu",
            replaces="raft_tpu/ops/ivf_scan.py:284", launches=launches,
            max_abs_err=errs["group"], ms=times["group"], plain_ms=plain,
            bound_ms=max(t_ops, t_bytes), bound_by=by, bound_kind="2xTF32",
            library_ms=None, form="group", pair_ms=times["pair"],
            pair_max_abs_err=errs["pair"], f32_form_ms=f32_ms,
            shape=f"{M} queries x {N_PROBES} probes, k={K}, {store} lists"
                  + (" (byte grid)" if store == "uint8" else "")))
    return rows


# the edge-store phase: CAGRA's packed stores on the path's index, JAX's
# pq_dim for d = 128 and int8 LUT; int4's refined recall at least this
# share of the int8 store's (JAX's test_quant_ladder contract); pq's share
# is printed, and gated only where its first card run met the contract
EDGE_STORES = ("int4", "pq")
PQ_DIM_WIDE = 64           # K5·pq also at pq_len 2
INT4_MIN_RATIO = 0.95
PQ_MIN_RATIO = None


def only_launched(name: str, allowed) -> None:
    """The path just run launched no kernel but ``allowed`` and K1."""
    moved = counts()
    other = {k: n for k, n in moved.items()
             if n and k not in allowed and not k.startswith("select_k")}
    if other:
        raise AssertionError(f"{name}: launched {other} beside {allowed}")


def recipe_recall(cidx, q, bi, engine: str) -> float:
    """JAX's serving recipe for the low stores: search at k = itopk, then
    refine the itopk candidates exactly to K."""
    _, cand = cagra.search(cidx, q, ITOPK, CAGRA_SP, engine=engine)
    _, ids = refine.refine(cidx.dataset, q, cand, K)
    return neighborhood_recall(ids, bi)


def edge_store_phase(timer, q, cidx, bidx, buf_d, buf_i, hop_parents,
                     totals, dense: dict) -> list:
    """CAGRA's int4 and pq edge stores on the path's index (the int8 store
    dropped first): each built at the path's width (bytes, seconds),
    searched through the entry point with the counters reset before each
    engine's run (int4: edge and fused, bit-equal, launching only K5's and
    K6's int4 forms besides K1; pq: edge, only K5's pq form; an explicit
    fused search raises), raw recall@K and JAX's recipe (search at
    k = itopk, refine to K) against the int8 store's, ``tune_search`` at
    the store; then each new kernel form against its plain version and
    timed (K5's beside the dense form's row of this run, ``dense``);
    the phase's own peak device memory. Returns the kernel rows."""
    torch.cuda.reset_peak_memory_stats()
    _, bi = brute_force.search(bidx, q, K)
    base = recipe_recall(cidx, q, bi, "fused")
    log(f"edge stores: the int8 store's recipe recall@{K} (search at k = "
        f"{ITOPK}, refine to {K}): {base:.4f}")
    cidx.edge_store = None
    torch.cuda.empty_cache()
    rows = []
    for store in EDGE_STORES:
        _, t_build = host_time(lambda: cagra.prepare_traversal(cidx, store))
        st = cidx.edge_store
        log(f"edge store {store}: vecs {tuple(st.vecs.shape)} "
            f"{st.vecs.dtype} {st.vecs.numel() / 1e9:.3f} GB, with aux, "
            f"graph rows and codebook {st.nbytes / 1e9:.3f} GB; built in "
            f"{t_build:.2f} s")
        runs = {}
        for eng in ("edge", "fused") if store == "int4" else ("edge",):
            kern = "graph_expand" if eng == "edge" else "cagra_fused"

            def path():
                _, t_first = host_time(lambda: cagra.search(
                    cidx, q, K, CAGRA_SP, engine=eng))
                out, t = host_time(lambda: cagra.search(
                    cidx, q, K, CAGRA_SP, engine=eng))
                return out, t_first, t

            (d, i), t_first, t = run_path(
                f"cagra {store} {eng}", (kern, f"{kern}.{store}", "select_k"),
                path, totals)
            only_launched(f"cagra {store} {eng}", (kern, f"{kern}.{store}"))
            check_knn(f"cagra {store} {eng}", d, i, K)
            runs[eng] = (d, i)
            log(f"cagra {store} {eng}: search(itopk={ITOPK}, width=1, "
                f"k={K}) first {t_first * 1e3:.1f} ms, steady "
                f"{t * 1e3:.1f} ms, {M / t:.0f} QPS, raw recall@{K} "
                f"{neighborhood_recall(i, bi):.4f}")
        if store == "int4":
            (ed, ei), (fd, fi) = runs["edge"], runs["fused"]
            if not (torch.equal(ei, fi) and torch.equal(ed, fd)):
                raise AssertionError("cagra int4: the edge and fused "
                                     "engines differ")
            log("cagra int4: edge and fused engines equal in ids and "
                "distances")
        else:
            try:
                cagra.search(cidx, q[:16], K, CAGRA_SP, engine="fused")
            except RaftError as e:
                log(f"cagra pq fused: raises ({e})")
            else:
                raise AssertionError("cagra pq: a fused search ran")
        rr = recipe_recall(cidx, q, bi, "fused" if store == "int4"
                           else "edge")
        ratio = rr / base
        log(f"cagra {store} recipe recall@{K}: {rr:.4f}, {ratio:.4f} of "
            "the int8 store's")
        gate = INT4_MIN_RATIO if store == "int4" else PQ_MIN_RATIO
        if gate is not None and ratio < gate:
            raise AssertionError(f"cagra {store}: recipe recall {ratio:.4f} "
                                 f"of int8's, below {gate}")
        # the race on a copy of the index (a gather win drops its store)
        tidx = dataclasses.replace(cidx)
        race = ("graph_expand", "select_k") + (
            ("cagra_fused",) if store == "int4" else ())
        (winner, times), t_race = run_path(
            f"cagra {store} tune_search", race,
            lambda: host_time(lambda: cagra.tune_search(
                tidx, q, K, CAGRA_SP, store_dtype=store)), totals)
        if store == "pq" and "fused" in times:
            raise AssertionError("cagra pq: the fused engine ran in the race")
        log(f"cagra {store} tune_search (itopk={ITOPK}, {M} queries, "
            f"{t_race:.2f} s): {winner} wins (" + ", ".join(
                f"{e} {v * 1e3:.2f} ms" for e, v in times.items()) + ")")
        rows.append(k5_store_phase(timer, cidx, q, hop_parents,
                                   totals[f"graph_expand.{store}"], store,
                                   dense))
        if store == "int4":
            rows.append(k6_int4_phase(timer, cidx, q, buf_d, buf_i,
                                      totals["cagra_fused.int4"]))
        cidx.edge_store = None
        torch.cuda.empty_cache()
    log(f"edge stores: peak device memory of the phase "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return rows


def int_pq_codebook(pq_dim, book, pq_len, seed, device):
    """An integer codebook whose every subspace reaches |127|: its int8
    form has scale 1 and holds it exactly."""
    g = torch.Generator(device=device).manual_seed(seed)
    cb = torch.randint(-40, 41, (pq_dim, book, pq_len), generator=g,
                       device=device, dtype=torch.int32)
    cb[:, 0, 0] = 127
    return cb.to(torch.int8)


def k5_store_phase(timer, cidx, q, parents, launches, store,
                   dense: dict) -> dict:
    """K5's int4 or pq form on the path's hop-K5_HOP parents, against its
    plain version: the path's store; the parents' tiles with a penalty
    and the ip metric; integer-valued copies of them (int4: the nibbles
    with unit scales; pq: integer codebooks with per-subspace absmax 127,
    so the int8 LUT's scale is 1, in both LUT modes) with rounded queries
    at both metrics; pq also at pq_dim 64 (pq_len 2). Then timed, also
    alone (the host's work hidden), beside the dense (int8) form's row of
    this run (``dense``)."""
    st = cidx.edge_store
    kp = min(cidx.graph_degree, ITOPK)
    mode = st.kernel_mode
    path = (parents, q, st.vecs, st.aux, kp, "l2", st.degree, None, mode,
            st.cb, st.cb_scale)
    err = check_equal(ge.graph_expand_plain(*path), ge.graph_expand(*path),
                      f"K5 graph_expand {store} store ({M} parents of hop "
                      f"{K5_HOP} x {st.degree} edges x {D}) k'={kp}, the "
                      "path's data")
    sub, remap = torch.unique(parents.long(), return_inverse=True)
    rp = remap.int().contiguous()
    codes = st.vecs[sub].contiguous()
    ones = torch.ones((len(sub), st.deg_p), device=q.device)
    pen = torch.where(torch.rand(ones.shape, device=q.device) < 0.25,
                      float("inf"), 0.0).contiguous()
    qi = torch.round(q)
    aux = st.aux[sub].contiguous()

    def int_aux(vecs, cb=None, scale=None):
        dec = ge.widen_tile(vecs, mode, cb, scale)
        return torch.stack([ones, dec.square().sum(-1)], dim=1).contiguous()

    cases = [(f"{store} store, penalty", codes, aux, q, "ip", pen, st.cb,
              st.cb_scale)]
    if store == "int4":
        ia = int_aux(codes)
        cases += [("integer-valued int4", codes, ia, qi, m, pn, None, None)
                  for m, pn in (("l2", pen), ("ip", None))]
    else:
        pq_dim, book, pq_len = st.cb.shape
        f32 = st.cb.float() * st.cb_scale[:, None, None]
        cases.append(("pq store, f32 LUT", codes, aux, q, "l2", None, f32,
                      None))
        for pd in (pq_dim, PQ_DIM_WIDE):
            cbi = int_pq_codebook(pd, book, st.dim_p // pd, SEED + pd,
                                  q.device)
            unit = torch.ones(pd, device=q.device)
            cc = codes
            if pd != pq_dim:
                g = torch.Generator(device=q.device).manual_seed(SEED + 3)
                cc = torch.randint(0, book, (len(sub), st.deg_p, pd),
                                   generator=g, device=q.device,
                                   dtype=torch.int32).to(torch.uint8)
                real = torch.randn((pd, book, st.dim_p // pd), generator=g,
                                   device=q.device) * 0.3
                cases.append((f"pq_dim {pd}, real f32 LUT", cc,
                              int_aux(cc, real), q, "l2", pen, real, None))
            ia = int_aux(cc, cbi, unit)
            for lut, cb, sc in (("int8", cbi, unit), ("f32", cbi.float(),
                                                      None)):
                cases += [(f"integer-valued pq_dim {pd} {lut} LUT", cc, ia,
                           qi, m, pn, cb, sc)
                          for m, pn in (("l2", pen), ("ip", None))]
    for name, vecs, ax, qq, metric, pn, cb, sc in cases:
        a = (rp, qq, vecs, ax, kp, metric, st.degree, pn, mode, cb, sc)
        check_equal(ge.graph_expand_plain(*a), ge.graph_expand(*a),
                    f"K5 graph_expand {name} {metric} ({M} parents)")
    ms = timer(lambda: ge.graph_expand_kernel(*path))
    alone = device_ms(lambda: ge.graph_expand_kernel(*path))
    plain = timer(lambda: ge.graph_expand_plain(*path), reps=3, warmup=0)
    deg_p, dim_p, w = st.deg_p, st.dim_p, st.vecs.shape[2]
    if store == "pq":
        info = ge.kernel_info(deg_p, dim_p, "pq", w, st.cb.shape[1], True)
    else:
        info = ge.kernel_info(deg_p, dim_p, store)
    log(f"  K5.{store} at tiles {deg_p} x {w}: {info['registers']} "
        f"registers, {info['local_bytes']} bytes of local memory (spills) "
        f"a thread, {info['warps_per_sm']} warps resident an SM "
        f"({info['warps_per_block']} a block), {info['smem_per_sm']} bytes "
        "of shared memory an SM")
    # each distinct parent's tile and aux row once, per pair its query,
    # parent id and k' outputs; pq also its codebook (and scales) once:
    # the kernel's copy a block is its own design, served by L2
    extra, n_bytes = {}, (len(sub) * (deg_p * w + 2 * deg_p * 4)
                          + M * (dim_p * 4 + 4 + kp * 8))
    if store == "pq":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        wpb = info["warps_per_block"]
        blocks = min(-(-M // wpb), info["warps_per_sm"] // wpb * sms)
        cb_bytes = st.cb.numel() * st.cb.element_size() + (
            0 if st.cb_scale is None else st.cb_scale.numel() * 4)
        n_bytes += cb_bytes
        extra = dict(blocks=blocks, codebook_bytes=cb_bytes)
    b, by = bound(n_bytes, 2.0 * M * st.degree * D)
    log(f"  K5.{store} at hop {K5_HOP}: {ms:.4f} ms, alone {alone:.4f} ms "
        f"(the dense form's {dense['ms']:.4f} ms, alone "
        f"{dense['device_ms']:.4f}), plain {plain:.2f} ms, bound {b:.4f} ms "
        f"({by}); launches {launches}")
    return dict(name=f"graph_expand.{store}", route="cuda",
                source=f"raft_tpu_torch/csrc/graph_expand_{store}.cu",
                replaces="raft_tpu/ops/graph_expand.py:261",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=None, device_ms=alone,
                dense_form_ms=dense["ms"],
                dense_form_device_ms=dense["device_ms"],
                distinct_parents=len(sub), **info, **extra,
                shape=f"{M} (query, parent) pairs of hop {K5_HOP}, {store} "
                      f"tiles {deg_p} x {w}, k'={kp}")


def k6_int4_phase(timer, cidx, q, buf_d, buf_i, launches) -> dict:
    """K6's int4 form on the path's seeded buffer against its plain
    version: the path's store (launched twice, bit-equal), with a penalty
    at the ip metric, and an integer-valued copy (the nibbles with unit
    scales, rounded queries, a buffer of their exact distances) at both
    metrics. Then timed, with its bound from the int4 traversal's own
    parents."""
    st = cidx.edge_store
    itopk, width, max_iter = cagra._plan_dims(CAGRA_SP, K)
    kw = dict(itopk=itopk, width=width, max_iter=max_iter,
              kprime=min(cidx.graph_degree, itopk), degree=st.degree,
              metric="l2", mode="int4")
    path = (q, buf_d, buf_i, st.vecs, st.aux, st.gp, None)
    kd, ki, hops, parents = cf.fused_traverse_kernel(*path, **kw)
    err = check_equal(cf.fused_traverse_plain(*path, **kw), (kd, ki),
                      f"K6 cagra_fused int4 store ({M} queries, {max_iter} "
                      "hops), the path's data")
    check_bits((kd, ki, hops, parents),
               cf.fused_traverse_kernel(*path, **kw),
               "K6 cagra_fused int4 launched twice")
    pen = torch.where(torch.rand(st.gp.shape, device=q.device) < 0.25,
                      float("inf"), 0.0)
    a = (q, buf_d, buf_i, st.vecs, st.aux, st.gp, pen)
    check_equal(cf.fused_traverse_plain(*a, **dict(kw, metric="ip")),
                cf.fused_traverse_kernel(*a, **dict(kw, metric="ip"))[:2],
                f"K6 cagra_fused int4 store, penalty ip ({M} queries)")
    del pen, a
    codes, _ = quant.quantize_int4(cidx.dataset)
    dec = ge.widen_tile(codes, "int4")
    int_aux = torch.zeros_like(st.aux)
    int_aux[:, 0, :st.degree] = 1.0
    int_aux[:, 1, :st.degree] = dec.square().sum(1)[cidx.graph.long()]
    qi = torch.round(q)
    d = (qi[:, None, :] - dec[buf_i.long()]).square().sum(-1)
    bd, order = torch.sort(d, dim=1, stable=True)
    bi = torch.gather(buf_i, 1, order)
    del d, dec, codes
    for metric in ("l2", "ip"):
        a = (qi, bd, bi, st.vecs, int_aux, st.gp, None)
        kwm = dict(kw, metric=metric)
        check_equal(cf.fused_traverse_plain(*a, **kwm),
                    cf.fused_traverse_kernel(*a, **kwm)[:2],
                    f"K6 cagra_fused integer-valued int4 {metric} ({M} "
                    "queries)")
    del int_aux
    ms = timer(lambda: cf.fused_traverse_kernel(*path, **kw))
    plain = timer(lambda: cf.fused_traverse_plain(*path, **kw), reps=1,
                  warmup=0)
    # the cost of a hop: cut to 8, 32 and max_iter hops, as K6's
    by_iter = {}
    for it in sorted({8, 32, max_iter}):
        kwi = dict(kw, max_iter=it)
        h = cf.fused_traverse_kernel(*path, **kwi)[2]
        by_iter[it] = (timer(lambda: cf.fused_traverse_kernel(*path, **kwi)),
                       float(h.float().mean()))
    (t0, h0), (t1, h1) = by_iter[8], by_iter[max_iter]
    slope = (t1 - t0) / (h1 - h0)
    info = cf.kernel_info(itopk, width, kw["kprime"], st.deg_p, st.dim_p,
                          "int4")
    log("  K6.int4 by max_iter: " + ", ".join(
        f"{it}: {t:.3f} ms ({h:.2f} hops)" for it, (t, h) in by_iter.items())
        + f"; a hop of all {M} queries {slope * 1e3:.1f} us")
    log(f"  K6.int4 at the path's shape: {info['registers']} registers, "
        f"{info['local_bytes']} bytes of local memory (spills) a thread, "
        f"{info['warps_per_sm']} warps resident an SM")
    _, n_ok, distinct = walk(cidx, q, buf_d, buf_i)
    n_par = int(parents.sum())
    if n_ok != n_par:
        raise AssertionError(f"K6.int4 expanded {n_par} parents, the plain "
                             f"hop loop {n_ok}")
    mean_hops = float(hops.float().mean())
    deg_p, w = st.deg_p, st.vecs.shape[2]
    b, by = bound(distinct * (deg_p * w + 2 * deg_p * 4 + deg_p * 4)
                  + M * st.dim_p * 4 + 2 * M * itopk * 8,
                  2.0 * n_par * st.degree * D)
    log(f"  K6.int4: {ms:.3f} ms, plain {plain:.1f} ms, bound {b:.4f} ms "
        f"({by}); {mean_hops:.2f} hops per query, {n_par} parents, "
        f"{distinct} distinct; launches {launches}")
    return dict(name="cagra_fused.int4", route="cuda",
                source="raft_tpu_torch/csrc/cagra_fused_int4.cu",
                replaces="raft_tpu/ops/cagra_fused.py:285",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=None,
                mean_hops=mean_hops, parents=n_par,
                distinct_parents=distinct,
                ms_by_max_iter={it: t for it, (t, _) in by_iter.items()},
                hop_ms=slope, **info,
                shape=f"{M} queries, itopk {itopk}, width {width}, "
                      f"{max_iter} hops max, int4 tiles {deg_p} x {w}")


# ------------------------------------------------ the IVF and brute-force
# remainders: streamed builds, per-cluster codebooks, the scan engine

STREAM_BATCHES = 8
# the IVF builds' GEMM row chunks: kmeans_balanced.predict at 1,024 lists
# (fused_l2_nn's 256 MiB block / 4 KiB a row); IVF-PQ's encode batch
# (ops.ivf_pq_scan.pq_chunk_rows(64, 256) = 32,768) divides it
STREAM_ALIGN = 65_536
SCAN_QUERIES = 1000
SCAN_METRICS = (("l1", 2.0), ("linf", 2.0), ("lp", 3.0), ("canberra", 2.0),
                ("correlation", 2.0))
SCAN_SAMPLE = (0, SCAN_QUERIES - 1)   # queries held against the whole corpus
# (rtol, atol) against float64. Canberra: 128 quotients, each rounded on
# its own, and a term whose denominator |x| + |y| is tiny carries its
# numerator's rounding at full weight. Correlation: 1 - cos of the
# centered rows, whose float32 dot cancels to an absolute error of ~1e-6
# of the norms' product, whatever the distance.
SCAN_TOL = {"canberra": (1e-4, 0.0), "correlation": (1e-5, 1e-5)}


def stream_batches(x):
    """``STREAM_BATCHES`` batches over the rows, each a multiple of
    ``STREAM_ALIGN`` rows but the last, so that every assignment and
    encode product of a streamed build takes the same row blocks as the
    one-shot build's (the blocks of one GEMM shape give the same bits)."""
    b = round_up_to(cdiv(N, STREAM_BATCHES), STREAM_ALIGN)
    out = [x[i : i + b] for i in range(0, N, b)]
    if len(out) != STREAM_BATCHES:
        raise AssertionError(f"{len(out)} batches of {b} rows")
    return out


def same_lists(a, b, arrays, what: str) -> None:
    """The two indexes hold the same lists: sizes, and each list's rows
    (``arrays``, bit for bit) in the same order."""
    if not np.array_equal(a.list_sizes, b.list_sizes):
        raise AssertionError(f"{what}: list sizes differ")
    da = gather_dense([getattr(a, n) for n in arrays], a.list_offsets,
                      a.list_sizes)
    db = gather_dense([getattr(b, n) for n in arrays], b.list_offsets,
                      b.list_sizes)
    for name, u, v in zip(arrays, da, db):
        if u.is_floating_point():
            u, v = u.view(torch.int32), v.view(torch.int32)
        if not torch.equal(u, v):
            raise AssertionError(f"{what}: lists differ in {name}")
    log(f"  {what}: the same lists, rows in the same order "
        f"({', '.join(arrays)} bit for bit); capacity "
        f"{int(a.list_offsets[-1])} rows against {int(b.list_offsets[-1])}")


def streamed_builds(x, q, iidx, pidx, totals):
    """IVF-Flat and IVF-PQ streamed by ``build_from_batches`` in
    ``STREAM_BATCHES`` batches with the whole corpus as ``trainset`` (the
    quantizers the one-shot build trains): the same lists as the path's
    one-shot indexes, each list's rows in the same order, and each search
    bit-equal through K3 and K4. → the build seconds."""
    batches = stream_batches(x)
    secs = {}
    for name, mod, one, params, sp, k, rows in (
            ("ivf_flat", ivf_flat, iidx,
             ivf_flat.IndexParams(n_lists=N_LISTS, seed=SEED),
             ivf_flat.SearchParams(n_probes=N_PROBES), K,
             ("data", "data_norms", "source_ids")),
            ("ivf_pq", ivf_pq, pidx,
             ivf_pq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM,
                                pq_bits=PQ_BITS, seed=SEED),
             ivf_pq.SearchParams(n_probes=N_PROBES), K0,
             ("codes", "source_ids", "row_norms"))):
        idx, t = host_time(lambda: mod.build_from_batches(batches, params,
                                                          trainset=x))
        secs[name] = t
        log(f"{name} streamed in {len(batches)} batches of "
            f"{batches[0].shape[0]} rows: {t:.3f} s (list_growth "
            f"{idx.list_growth})")
        centers = ("centers",) if name == "ivf_flat" else (
            "centers_rot", "rotation", "codebooks")
        for c in centers:
            check_bits((getattr(idx, c),), (getattr(one, c),),
                       f"{name} streamed {c} against the one-shot build's")
        same_lists(idx, one, rows, f"{name} streamed against one-shot")
        scan = f"{name}_scan"
        got = run_path(f"{name} streamed", (scan, f"{scan}.group",
                                            "select_k"),
                       lambda: mod.search(idx, q, k, sp), totals)
        check_scan_forms(f"{name} streamed", scan, 1)
        check_bits(mod.search(one, q, k, sp), got,
                   f"{name} streamed search ({M} queries, k={k}) against "
                   "the one-shot build's")
        del idx
    return secs


def per_cluster_row(timer, cidx, pidx, q, launches) -> dict:
    """K4's per-cluster form against its plain version on the per-cluster
    index (bf16 LUT, the path's search: all queries; launched twice,
    bit-equal), on an integer-valued copy (equal, f32 and bf16 LUTs, both
    metrics, 1,000 queries), timed beside the plain version, with
    :func:`scan_bound` at its LUT mode (the per-cluster LUT route: a
    table a (query, probe) pair)."""
    q_rot = (q @ cidx.rotation.T).contiguous()
    probed = iscan.coarse_probe(q_rot, cidx.centers_rot, N_PROBES, "l2",
                                cidx.center_norms)

    def args(idx, mode, qr, pr):
        return (idx.codes, idx.row_norms, idx.centers_rot,
                ipq.lut_codebook(idx.codebooks, mode), pr, idx.offsets_dev,
                idx.sizes_dev, qr)

    path = args(cidx, "bf16", q_rot, probed)
    kw = dict(per_cluster=True)
    out = {}
    plain = timer(lambda: out.setdefault("ref", ipq.ivf_pq_scan_plain(
        *path, K0, "l2", **kw)), reps=1, warmup=0)
    got = ipq.ivf_pq_scan(*path, K0, "l2", **kw)
    err = check_close(*out["ref"], *got, f"K4 ivf_pq_scan per-cluster form, "
                      f"bf16 LUT ({M} queries, n_probes={N_PROBES})")
    check_bits(got, ipq.ivf_pq_scan(*path, K0, "l2", **kw),
               "K4 ivf_pq_scan per-cluster form, launched twice")
    rng = np.random.default_rng(SEED + 21)
    ints = lambda shape_: torch.from_numpy(rng.integers(  # noqa: E731
        -3, 4, shape_).astype(np.float32)).cuda()
    iidx = dataclasses.replace(cidx, codebooks=ints(cidx.codebooks.shape),
                               centers_rot=ints(cidx.centers_rot.shape))
    qi = ints((1000, cidx.rot_dim))
    pri = iscan.coarse_probe(qi, iidx.centers_rot, N_PROBES, "l2",
                             iidx.center_norms)
    for mode in ("f32", "bf16"):
        a = args(iidx, mode, qi, pri)
        for metric in ("l2", "ip"):
            check_equal(ipq.ivf_pq_scan_plain(*a, K0, metric, **kw),
                        ipq.ivf_pq_scan(*a, K0, metric, **kw),
                        f"K4 ivf_pq_scan per-cluster form, {mode} LUT "
                        f"{metric}, integer codebooks/centers/queries "
                        "(1000 queries)")
    del iidx
    ms = timer(lambda: ipq.ivf_pq_scan_candidates(
        cidx.codes, cidx.row_norms, None, path[3], cidx.centers_rot, q_rot,
        probed, cidx.offsets_dev, cidx.sizes_dev, K0, "l2", "group", True))
    sizes = cidx.sizes_dev.long()
    scanned = int(sizes[probed.long()].sum())
    distinct_rows = int(sizes[torch.unique(probed)].sum())
    pairs = M * N_PROBES
    book, pq_len = cidx.pq_book_size, cidx.pq_len
    b, by = scan_bound(distinct_rows * (PQ_DIM + 4) + q_rot.numel() * 4
                       + cidx.centers_rot.numel() * 4
                       + cidx.codebooks.numel() * 4 + pairs * (4 + K0 * 8),
                       scanned, cidx.rot_dim, tf32_products(path[3]),
                       (pairs * 2 * PQ_DIM * book * pq_len,
                        scanned * PQ_DIM))
    log(f"  K4.per_cluster scans {scanned} (pair, row) products over "
        f"{distinct_rows} distinct rows: {ms:.3f} ms, plain {plain:.1f} ms, "
        f"bound {b:.4f} ms ({by}); launches {launches}")
    return dict(name="ivf_pq_scan.per_cluster", route="cuda",
                source="raft_tpu_torch/csrc/ivf_pq_scan.cu",
                replaces="raft_tpu/ops/ivf_pq_scan.py:290",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=None, form="group",
                shape=f"{M} queries x {N_PROBES} probes, pq_dim={PQ_DIM}, "
                      f"per-cluster codebooks ({N_LISTS} x {book} x "
                      f"{pq_len}), k={K0}, bf16 LUT")


def per_cluster_path(x, q, bi, pidx, totals, timer) -> dict:
    """An IVF-PQ index with per-cluster codebooks built and searched
    through the entry points at the path's parameters, its recall@10 (raw
    and refined) beside the per-subspace index's at the same n_probes,
    then K4's per-cluster form against its plain version."""
    params = ivf_pq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM,
                                pq_bits=PQ_BITS, seed=SEED,
                                codebook_kind=ivf_pq.CodebookGen.PER_CLUSTER)
    cidx, t_build = host_time(lambda: ivf_pq.build(x, params))
    sp = ivf_pq.SearchParams(n_probes=N_PROBES)

    def search():
        (v, i), t_first = host_time(lambda: ivf_pq.search(cidx, q, K0, sp))
        (v, i), t = host_time(lambda: ivf_pq.search(cidx, q, K0, sp))
        return v, i, t_first, t

    v, i, t_first, t = run_path(
        "ivf_pq per-cluster", ("ivf_pq_scan", "ivf_pq_scan.group",
                               "ivf_pq_scan.per_cluster", "select_k"),
        search, totals)
    check_scan_forms("ivf_pq per-cluster", "ivf_pq_scan", 2)
    launches = counts()["ivf_pq_scan.per_cluster"]
    check_knn("ivf_pq per-cluster", v, i, K0)
    recalls = {}
    for kind, ids in (("per-cluster", i),
                      ("per-subspace", ivf_pq.search(pidx, q, K0, sp)[1])):
        _, ri = refine.refine(x, q, ids, K)
        recalls[kind] = (neighborhood_recall(ids[:, :K], bi),
                         neighborhood_recall(ri, bi))
    split = ", ".join(f"{k} {s:.3f} s" for k, s in
                      cidx.build_seconds.items())
    log(f"ivf_pq per-cluster: build {t_build:.3f} s ({split}; codebooks "
        f"{tuple(cidx.codebooks.shape)}), search(n_probes={N_PROBES}, "
        f"k0={K0}, bf16 LUT) first {t_first * 1e3:.1f} ms, steady "
        f"{t * 1e3:.1f} ms; recall@{K} raw / refined: per-cluster "
        f"{recalls['per-cluster'][0]:.4f} / {recalls['per-cluster'][1]:.4f}"
        f", per-subspace {recalls['per-subspace'][0]:.4f} / "
        f"{recalls['per-subspace'][1]:.4f}")
    row = per_cluster_row(timer, cidx, pidx, q, launches)
    row.update(build_s=t_build, search_ms=t * 1e3,
               recall_raw=recalls["per-cluster"][0],
               recall_refined=recalls["per-cluster"][1],
               per_subspace_recall_raw=recalls["per-subspace"][0],
               per_subspace_recall_refined=recalls["per-subspace"][1])
    return row


def numpy_metric(rows, qv, metric: str, arg: float):
    """float64 distances of the rows (n, d) to one query (d,), the
    metric's formula in numpy."""
    if metric == "correlation":
        rc = rows - rows.mean(axis=1, keepdims=True)
        qc = qv - qv.mean()
        den = np.sqrt((rc * rc).sum(1)) * np.sqrt((qc * qc).sum())
        return 1.0 - (rc @ qc) / np.maximum(den, 1e-30)
    diff = np.abs(rows - qv)
    if metric == "l1":
        return diff.sum(1)
    if metric == "linf":
        return diff.max(1)
    if metric == "lp":
        return (diff ** arg).sum(1) ** (1.0 / arg)
    den = np.abs(rows) + np.abs(qv)
    return np.where(den == 0, 0.0, diff / np.where(den == 0, 1.0, den)).sum(1)


def scan_engine_path(x, q, totals) -> dict:
    """Brute force's scan engine at L1, Linf, Lp (p = 3), Canberra and
    correlation on ``SCAN_QUERIES`` queries over the path's rows through
    the entry points (``auto`` takes the scan for these metrics): K1 must
    select each tile and merge it with the best so far (two launches a
    tile, no K2 launch); every returned value held against float64 numpy
    at its row, and the queries of ``SCAN_SAMPLE`` against the whole
    corpus in float64 (their k best values, slot by slot). → ms a
    metric."""
    qs = q[:SCAN_QUERIES].contiguous()
    x64 = x.cpu().double().numpy()
    q64 = qs.cpu().double().numpy()
    tiles = -(-N // 8192)
    ms = {}
    for metric, arg in SCAN_METRICS:
        idx = brute_force.build(x, metric, metric_arg=arg)
        (v, i), t = run_path(f"brute_force scan {metric}", ("select_k",),
                             lambda: host_time(lambda: brute_force.search(
                                 idx, qs, K)), totals)
        moved = counts()
        if moved["select_k"] != 2 * tiles or moved["fused_knn"]:
            raise AssertionError(f"scan {metric}: K1 {moved['select_k']} "
                                 f"launches (expected {2 * tiles}), K2 "
                                 f"{moved['fused_knn']}")
        del idx
        ms[metric] = t * 1e3
        rtol, atol = SCAN_TOL.get(metric, (1e-5, 0.0))
        vh, ih = v.cpu().double().numpy(), i.cpu().long().numpy()
        got = np.stack([numpy_metric(x64[ih[r]], q64[r], metric, arg)
                        for r in range(SCAN_QUERIES)])
        np.testing.assert_allclose(vh, got, rtol=rtol, atol=atol,
                                   err_msg=f"scan {metric}: values at ids")
        err = float(np.abs(vh - got).max())
        for r in SCAN_SAMPLE:
            best = np.sort(numpy_metric(x64, q64[r], metric, arg))[:K]
            np.testing.assert_allclose(
                vh[r], best, rtol=rtol, atol=atol,
                err_msg=f"scan {metric}: query {r}'s k best")
        log(f"  brute_force scan {metric} (metric_arg {arg}): "
            f"{SCAN_QUERIES} queries, k={K}, {t * 1e3:.1f} ms "
            f"({SCAN_QUERIES / t:.0f} QPS), K1 {moved['select_k']} launches "
            f"({tiles} tiles); against float64 numpy: max |err| {err:.3g} "
            f"(rtol {rtol}, atol {atol}), queries {list(SCAN_SAMPLE)} equal "
            "to their k best over all rows")
    return ms


def remainders_phase(x, q, bidx, iidx, pidx, totals):
    """The IVF and brute-force remainders at the path's width: streamed
    IVF builds against the one-shot ones, per-cluster IVF-PQ through K4,
    the scan engine's metrics; the phase's seconds and peak device
    memory. → (K4's per-cluster kernel row, the run's peak device memory
    before the phase, which resets it)."""
    t0 = time.perf_counter()
    before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bi = brute_force.search(bidx, q, K)[1]
    secs = streamed_builds(x, q, iidx, pidx, totals)
    row = per_cluster_path(x, q, bi, pidx, totals, Timer())
    scan_ms = scan_engine_path(x, q, totals)
    row.update(streamed_build_s=secs, scan_engine_ms=scan_ms)
    log(f"remainders phase: {time.perf_counter() - t0:.1f} s, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the "
        f"run's before it {before / 2**30:.2f} GiB)")
    return row, before


# the filters phase: Bernoulli filters at these keep rates, made from
# the seed, and a tenant slice (the first IVF-Flat lists, by label, whose
# rows number at most FILTER_TENANT_MAX: the crossover's default threshold)
FILTER_KEEPS = (0.5, 0.05, 0.009)
FILTER_TENANT_MAX = 8192
FILTER_RECALL_GAP = 0.01        # the policy's recall >= suspended()'s - this
CROSSOVER_MIN_ROWS = 0.999      # crossover ids equal to the exact answer's
# the card's data sheet (H100 SXM): a probe reading above it is a fault
DATASHEET = {"matmul_bf16_tflops": 989.0, "matmul_f32_tflops": 67.0,
             "hbm_stream_gbps": 3350.0}


def filter_masks(iidx) -> dict:
    """name -> (N,) bool keep mask: the Bernoulli filters and the tenant
    slice (whole IVF-Flat lists from list 0 on while their rows number at
    most FILTER_TENANT_MAX)."""
    rng = np.random.default_rng(SEED + 22)
    masks = {f"keep {p}": rng.random(N) < p for p in FILTER_KEEPS}
    sizes = np.asarray(iidx.list_sizes)
    lists = int(np.searchsorted(np.cumsum(sizes), FILTER_TENANT_MAX,
                                side="right"))
    sid = iidx.source_ids[:int(iidx.list_offsets[lists])].cpu().numpy()
    tenant = np.zeros(N, bool)
    tenant[sid[sid >= 0]] = True
    masks[f"tenant ({lists} lists)"] = tenant
    return masks


def launched(moved: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in moved.items() if v)


def crossover_race(cidx, q, sp, exact, fd, smi: str) -> None:
    """``filter_policy.tune_crossover`` for CAGRA at the keep-0.009 filter
    (above the survivor threshold, so the widened walk serves it): the
    widened walk against the compacted brute pass, the verdict, and the
    search that follows it (a "brute" verdict crosses over: K2, no K5 or
    K6, the exact answer's ids)."""
    filt, ei = exact
    key, winner, times = filter_policy.tune_crossover(
        "cagra", N, D, K, fd.selectivity,
        lambda qq: cagra.search(cidx, qq, K, sp, filter=filt),
        lambda qq: filter_policy.survivor_brute_dense(
            cidx.dataset, cidx.metric, qq, K, filt), q)
    reset_counts()
    (_, i), t = host_time(lambda: cagra.search(cidx, q, K, sp, filter=filt))
    moved = counts()
    raced = ", ".join(f"{e} {s * 1e3:.1f} ms" for e, s in times.items())
    log(f"filter_policy.tune_crossover (cagra, {fd.survivors} survivors, "
        f"{key}): {winner} ({raced}); the search after it {t * 1e3:.1f} "
        f"ms, recall@{K} {neighborhood_recall(i, ei):.4f}, launches: "
        f"{launched(moved)} [{smi}]")
    if winner == "brute" and (moved["fused_knn"] != 1 or moved[
            "graph_expand"] or moved["cagra_fused"] or float(
                (i == ei).all(dim=1).float().mean()) < CROSSOVER_MIN_ROWS):
        raise AssertionError("cagra: a brute crossover verdict was not "
                             "followed")


def filters_phase(x, q, bidx, iidx, pidx, cidx, totals):
    """The adaptive filter policy on the path's four indexes: for each
    filter and family the decision, recall@10 with the policy and under
    ``suspended()`` against the exact filtered answer (K2 with the
    penalty row under ``suspended()``), the search's ms and its launches
    (counters reset before it); the crossovers held to the exact answer;
    then brute force's engine race (and ``auto`` on K2 after its
    verdict), the roofline probe and the select_k sweep."""
    t0 = time.perf_counter()
    dev = x.device
    sp_flat = ivf_flat.SearchParams(n_probes=N_PROBES)
    sp_pq = ivf_pq.SearchParams(n_probes=N_PROBES)
    sp_cagra = dataclasses.replace(CAGRA_SP, engine="fused")
    bi = brute_force.search(bidx, q, K)[1]
    raw_pq = neighborhood_recall(ivf_pq.search(pidx, q, K0, sp_pq)[1][:, :K],
                                 bi)
    searches = {
        "brute_force": lambda f: brute_force.search(bidx, q, K, filter=f),
        "ivf_flat": lambda f: ivf_flat.search(iidx, q, K, sp_flat, filter=f),
        "ivf_pq": lambda f: tuple(t[:, :K] for t in ivf_pq.search(
            pidx, q, K0, sp_pq, filter=f)),
        "cagra": lambda f: cagra.search(cidx, q, K, sp_cagra, filter=f),
    }
    decide = {
        "brute_force": lambda f: filter_policy.decide_graph(
            f, N, D, K, "brute_force", dev),
        "ivf_flat": lambda f: filter_policy.decide_ivf(
            iidx, f, N_PROBES, K, "ivf_flat"),
        "ivf_pq": lambda f: filter_policy.decide_ivf(
            pidx, f, N_PROBES, K0, "ivf_pq"),
        "cagra": lambda f: filter_policy.decide_graph(f, N, D, K, "cagra",
                                                      dev),
    }
    decisions, exact = {}, {}
    for name, mask in filter_masks(iidx).items():
        filt = Bitset.from_mask(torch.from_numpy(mask).to(dev))
        with filter_policy.suspended():
            (ev, ei), t_exact = host_time(lambda: brute_force.search(
                bidx, q, K, filter=filt))
        exact[name] = (filt, ei)
        log(f"filter {name}: {int(mask.sum())} of {N} rows survive; exact "
            f"answer (K2 + penalty, suspended) {t_exact * 1e3:.1f} ms")
        for fam, search in searches.items():
            fd = decide[fam](filt)
            search(filt)                                  # warm
            reset_counts()
            (v, i), t = host_time(lambda: search(filt))
            moved = counts()
            for kern, n in moved.items():
                totals[kern] += n
            with filter_policy.suspended():
                _, si = search(filt)
            rec, rec_s = neighborhood_recall(i, ei), neighborhood_recall(
                si, ei)
            width = (f"n_probes {fd.n_probes}, lists pruned "
                     f"{fd.lists_pruned}" if fam.startswith("ivf") else
                     f"itopk {min(max(ITOPK, K) * fd.level, N)}"
                     if fam == "cagra" else "no width")
            log(f"  {fam}: selectivity {fd.selectivity:.6f}, level "
                f"{fd.level}, {width}, use_brute {fd.use_brute}; recall@{K} "
                f"{rec:.4f} (suspended {rec_s:.4f}); {t * 1e3:.1f} ms; "
                f"launches: {launched(moved)}")
            if rec < rec_s - FILTER_RECALL_GAP:
                raise AssertionError(f"filters {name} {fam}: recall {rec:.4f}"
                                     f" below suspended()'s {rec_s:.4f}")
            if fd.use_brute and fam != "ivf_pq":
                check_close(ev, ei, v, i, f"{fam} crossover vs exact",
                            CROSSOVER_MIN_ROWS)
                bits = bool(torch.equal(v.view(torch.int32),
                                        ev.view(torch.int32))
                            and torch.equal(i, ei))
                log(f"  {fam} crossover bit-equal to the exact answer: "
                    f"{bits}")
            elif fd.use_brute and rec < raw_pq:
                raise AssertionError(f"ivf_pq crossover recall {rec:.4f} "
                                     f"below the path's raw {raw_pq:.4f}")
            scan = f"{fam}_scan"
            if fam.startswith("ivf") and fd.level > 1 and not fd.use_brute \
                    and (moved[scan], moved[f"{scan}.group"],
                         moved[f"{scan}.pair"]) != (1, 1, 0):
                raise AssertionError(f"filters {name} {fam}: {scan} "
                                     f"launches {launched(moved)}, expected "
                                     "one, grouped")
            if (fam == "cagra" and fd.level == 8 and not fd.use_brute
                    and fd.survivors and (moved["graph_expand"] == 0
                                          or moved["cagra_fused"])):
                raise AssertionError(f"filters {name}: widened CAGRA "
                                     f"launched K5 {moved['graph_expand']},"
                                     f" K6 {moved['cagra_fused']} times")
            decisions[name, fam] = fd
    if not any(fd.level == 8 and not fd.use_brute
               for (_, fam), fd in decisions.items() if fam == "cagra"):
        raise AssertionError("filters: no CAGRA search widened to level 8")
    if not all(fd.use_brute for (name, _), fd in decisions.items()
               if name.startswith("tenant")):
        raise AssertionError("filters: the tenant slice did not cross over")
    log(f"filters: IVF-PQ raw recall@{K} of the path, unfiltered, "
        f"{raw_pq:.4f}")
    smi = smi_line()
    crossover_race(cidx, q, sp_cagra, exact[f"keep {FILTER_KEEPS[-1]}"],
                   decisions[f"keep {FILTER_KEEPS[-1]}", "cagra"], smi)
    winner, times = brute_force.tune_search(bidx, q, K, reps=3)
    raced = ", ".join(f"{e} {t * 1e3:.1f} ms" for e, t in times.items())
    log(f"brute_force.tune_search at ({N}, {D}), {M} queries, k={K}: "
        f"{winner} ({raced}) [{smi}]")
    reset_counts()
    brute_force.search(bidx, q, K)
    moved = counts()
    for kern, n in moved.items():
        totals[kern] += n
    if moved["fused_knn"] == 0:
        raise AssertionError(f"brute force auto after a {winner!r} verdict "
                             f"did not launch K2: {launched(moved)}")
    log(f"brute force auto after the {winner!r} verdict: "
        f"{launched(moved)}")
    peaks = roofline.probe(quick=True)
    log(f"roofline.probe(quick=True): {json.dumps(peaks)} [{smi}]")
    for key, limit in DATASHEET.items():
        if peaks[key] > limit:
            raise AssertionError(f"roofline {key} {peaks[key]:.1f} above the "
                                 f"data sheet's {limit}: a fault of the probe")
    sweep = select_k_sweep.run()
    for r in sweep["results"]:
        log(f"select_k sweep ({r['rows']}, {r['n']}), k={r['k']}: K1 "
            f"{r['ms']['kpass']:.4f} ms, torch.topk {r['ms']['topk']:.4f} ms"
            f" -> {r['winner']} [{sweep['device']}, {sweep['power_limit']}]")
    log(f"filters phase: {time.perf_counter() - t0:.1f} s")


def row_of(kernels, name: str) -> dict:
    """The kernel row named ``name``."""
    return next(k for k in kernels if k["name"] == name)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; it runs only on an NVIDIA "
              "card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # the run's own verdict file: no verdict of an earlier run steers it
    verdicts = os.path.abspath(VERDICT_FILE)
    os.makedirs(os.path.dirname(verdicts), exist_ok=True)
    if os.path.exists(verdicts):
        os.remove(verdicts)
    os.environ["RAFT_TPU_TORCH_AUTOTUNE_CACHE"] = verdicts
    smi = smi_line()
    log(f"device: {smi} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    # K4's split builds (scan_ab: no selection, products only) beside them
    split_src = {"k4": ("ivf_pq_scan", None)}
    split_builds = kernel_ab.start_build(list(scan_ab.split_dirs(
        [str(_cuda._CSRC)], SPLIT_DIR).values()), split_src)
    logs = _cuda.build(verbose=True)
    split_libs, _ = kernel_ab.finish_build(split_builds, split_src)
    log(f"kernels built in {time.perf_counter() - t_start:.1f} s "
        f"({', '.join(logs) or 'cached'}; K4's split builds too)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    await_card(CARD_NEED, CARD_WAIT_S)

    rng = np.random.default_rng(SEED)
    centers = rng.standard_normal((N_BLOBS, D), dtype=np.float32)
    scales = rng.uniform(1.0, 1.6, N_BLOBS).astype(np.float32)
    (x, q), t_data = host_time(lambda: (
        torch.from_numpy(clustered(rng, N, centers, scales)).cuda(),
        torch.from_numpy(clustered(rng, M, centers, scales)).cuda()))
    log(f"data: {N} x {D} rows, {M} queries in {N_BLOBS} Gaussian clusters, "
        f"made in {t_data:.1f} s")

    bidx, iidx, pidx, cidx, sidx, moved = path_phase(x, q)
    mark(t_start, "path phase")
    determinism_phase(x, iidx, pidx)
    k4_cluster, pre_peak = remainders_phase(x, q, bidx, iidx, pidx, moved)
    mark(t_start, "remainders phase")
    filters_phase(x, q, bidx, iidx, pidx, cidx, moved)
    mark(t_start, "filters phase")
    k1_route, k1_pass, k4_route, route_peak = graph_route_phase(
        x, q, bidx, cidx, moved, pre_peak)
    mark(t_start, "graph-route phase")
    k1_bench, k6_bench, cell = bench_phase(moved, torch.device("cuda", 0))
    mark(t_start, "bench phase")
    entry_phase(x, q, bidx, iidx, pidx, cidx, cell, moved)
    mark(t_start, "entry-point phase")
    serialize_phase(bidx, iidx, pidx, cidx, q)
    mark(t_start, "serialize phase")
    stores = stores_phase(x, q, moved)
    mark(t_start, "store paths")
    # the f32 forms' launches: every store's form counts under K2 and K3 too
    f32 = {kern: moved[kern] - sum(moved.get(f"{kern}.{st}", 0)
                                   for st in STORE_NAMES)
           for kern in ("fused_knn", "ivf_flat_scan")}

    timer = Timer()
    k1_in = k1_inputs(x, q, bidx, iidx, pidx, cidx, sidx) + [
        (f"NN-descent merge, {what}", call[0][0].contiguous(), call[0][1])
        for what, call in (("the bench CAGRA graph race", k1_bench),
                           ("the graph route", k1_route))] + [
        ("IVF-PQ graph pass merge", k1_pass[0][0].contiguous(),
         k1_pass[0][1])]
    del k1_route, k1_bench, k1_pass
    kernels = [k1_phase(timer, k1_in, moved["select_k"],
                        by_form(moved, "select_k"))]
    del k1_in
    mark(t_start, "K1 phase")
    # K2's k-list plans' launches (its wide form has its own row); K4's
    # per-subspace launches (its per-cluster form, grouped, has its own)
    k4_forms = by_form(moved, "ivf_pq_scan")
    k4_cluster_n = k4_forms.pop("per_cluster")
    k4_forms["group"] -= k4_cluster_n
    kernels += [k2_phase(timer, bidx, q,
                         f32["fused_knn"] - moved["fused_knn.wide"],
                         cidx.build_stats["knn_graph_s"]),
               {**k3_phase(timer, iidx, q, f32["ivf_flat_scan"],
                           by_form(moved, "ivf_flat_scan")),
                **k3_wide(timer, iidx, q)},
               {**k4_phase(timer, pidx, q,
                           moved["ivf_pq_scan"] - k4_cluster_n, k4_forms),
                **k4_graph_pass(timer, k4_route, split_libs)}, k4_cluster]
    mark(t_start, "K2, K3 and K4 phases")
    wide_rows, k1_wide = wide_k_phase(timer, x, q, bidx, iidx, pidx, sidx,
                                      k4_route, moved)
    kernels += wide_rows
    row_of(kernels, "select_k")["radix_wide"] = k1_wide
    del k4_route
    del iidx, pidx
    mark(t_start, "wide-k phase")
    kernels += (k2_store_phase(timer, stores, moved, logs)
                + k3_store_phase(timer, stores, moved,
                                 row_of(kernels, "ivf_flat_scan")["ms"]))
    del stores
    mark(t_start, "K2 and K3 store phases")
    buf_d, buf_i = seeded_buffer(cidx, q)
    hop_parents, *walked = walk(cidx, q, buf_d, buf_i)
    kernels += [k5_phase(timer, cidx, q, hop_parents, moved["graph_expand"]),
                {**k6_phase(timer, cidx, q, buf_d, buf_i, walked,
                            moved["cagra_fused"]),
                 **k6_itopk256(timer, k6_bench)}]
    del k6_bench
    mark(t_start, "K5 and K6 phases")
    # the edge-store phase's own peak device memory, beside the rest's
    # (the IVF-PQ route reset the peak: the run's before it counts too)
    peaks = [max(route_peak, torch.cuda.max_memory_allocated())]
    log(f"peak device memory before the edge-store phase "
        f"{peaks[0] / 2**30:.2f} GiB")
    kernels += edge_store_phase(timer, q, cidx, bidx, buf_d, buf_i,
                                hop_parents, moved,
                                row_of(kernels, "graph_expand"))
    peaks.append(torch.cuda.max_memory_allocated())
    del cidx, buf_d, buf_i
    torch.cuda.reset_peak_memory_stats()
    kernels += [k7_phase(timer, x, sidx, q, moved["merge_step"]),
                k8_phase(timer, x, sidx, q, moved["ring_topk"])]
    peaks.append(torch.cuda.max_memory_allocated())
    mark(t_start, "K7 and K8 phases")
    log("peak device memory of the whole run "
        f"{max(peaks) / 2**30:.2f} GiB (before the edge-store phase, the "
        "phase, after it: " + ", ".join(f"{p / 2**30:.2f}" for p in peaks)
        + " GiB)")
    for kern in kernels:
        lib = kern["library_ms"]
        log(f"{kern['name']} [{kern['shape']}]: kernel_ms={kern['ms']:.3f} "
            f"plain_ms={kern['plain_ms']:.3f} library_ms="
            f"{'null' if lib is None else f'{lib:.3f}'} "
            f"bound_ms={kern['bound_ms']:.4f} ({kern['bound_by']}) "
            f"launches={kern['launches']}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except torch.OutOfMemoryError:
        # the card's state last, where the end of the error output shows it
        traceback.print_exc()
        print(f"chip_smoke.py: out of device memory; {card_memory()}",
              file=sys.stderr, flush=True)
        sys.exit(1)
