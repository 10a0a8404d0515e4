#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``raft_tpu_torch``) on one NVIDIA card.

Usage, from the root of a checkout, on a machine with a card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA::

    python3 chip_smoke.py

It builds the eight CUDA kernels from ``raft_tpu_torch/csrc`` (one
``nvcc`` per source, all at once, into ``build/kernels/``), then:

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
   form (K1: the warp select for k <= 256, the k passes above; K3 and K4:
   the grouped form for k <= 256, the per-pair form above); the IVF paths
   must launch K3 or K4 once a search (a shard), in the grouped form.
2. determinism: the path's IVF-Flat and IVF-PQ indexes, built once more
   from the same rows in the same process, must be bit-equal to the
   path's (centers, lists, rotation, codebooks, codes).
3. kernels: each kernel against its plain PyTorch version on the card at
   the path's shapes (K1 at every (rows, n, k) the paths hand it — the
   coarse probe, the brute-force split merge, the CAGRA build's at each
   size of batch (full and last) whose K2 plan splits the corpus, the
   IVF-Flat and IVF-PQ probe merges, refine, the edge engine's parent
   pick and buffer merge, the allgather merge at k = 100 — each form on
   the path's values and on integer-valued rows, the two forms timed in
   turn, and bit for bit on the path's values with NaN, -NaN, ±inf and
   -0.0 cells mixed in; K2 on integer inputs at k = 10, 129 and 256 and
   on the path's data at k = 10 and at the CAGRA build's k = 129; K3 and
   K4 in both forms (grouped, per-pair), each launched twice and
   bit-equal, both timed, with the grouped form's tiles and the bytes
   they read (K3's FP32 bound beside its 3xTF32 one); K4 in the bf16,
   f32 and int8 LUT modes and on an integer-valued copy of the IVF-PQ
   index, K5 and K6 on the path's data, where they must be equal, and on
   integer-valued copies; K5 also on a bf16 store; K6 launched twice,
   bit-equal, and timed cut to 8, 32 and 80 hops (the cost of a hop);
   K5's and K6's registers, spills and resident warps an SM (as the card
   reports them for the path's shape); K7 and K8, which must
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
   K1 (each form, at every shape), K7 and K8 also report the card's time
   alone (``device_ms``: calls queued back to back while the card is
   still busy with flush writes, so the host work between them is
   hidden): an event time includes the wrapper's host work wherever
   that outlasts the L2 flush, which a loaded host makes happen for
   these short kernels. K1's forms are timed with 9 calls a turn, K8
   with 15.

Prints progress lines, then a ``{"kernels": [...]}`` line, the card's name
and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is not 0. With no CUDA device it exits non-zero before printing any
result. Every matrix product runs in full float32 (TF32 off).
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from raft_tpu_torch.comms import Mesh
from raft_tpu_torch.matrix import select_k as sk
from raft_tpu_torch.neighbors import (brute_force, cagra, ivf_flat, ivf_pq,
                                      refine)
from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.ops import cagra_fused as cf
from raft_tpu_torch.ops import fused_knn as fk
from raft_tpu_torch.ops import graph_expand as ge
from raft_tpu_torch.ops import ivf_pq_scan as ipq
from raft_tpu_torch.ops import ivf_scan as iscan
from raft_tpu_torch.ops import ring_topk as rt
from raft_tpu_torch.parallel import sharded_ann, sharded_knn
from raft_tpu_torch.stats.metrics import neighborhood_recall

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

# kernel name -> (wrapper module, its launch counter)
_COUNTERS = {"select_k": (sk, "launches"),
             "select_k.warp": (sk, "warp_launches"),
             "select_k.kpass": (sk, "kpass_launches"),
             "fused_knn": (fk, "launches"),
             "ivf_flat_scan": (iscan, "launches"),
             "ivf_flat_scan.group": (iscan, "group_launches"),
             "ivf_flat_scan.pair": (iscan, "pair_launches"),
             "ivf_pq_scan": (ipq, "launches"),
             "ivf_pq_scan.group": (ipq, "group_launches"),
             "ivf_pq_scan.pair": (ipq, "pair_launches"),
             "graph_expand": (ge, "launches"),
             "cagra_fused": (cf, "launches"),
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


def check_close(ref_v, ref_i, v, i, what: str) -> float:
    """Values to rtol=1e-5, atol=1e-5·max|d| (float32 sums in another
    order); ids equal on >= 99% of rows. Returns max |v - ref_v|."""
    fin = torch.isfinite(ref_v)
    if not torch.equal(torch.isfinite(v), fin):
        raise AssertionError(f"{what}: +inf slots differ")
    err = float((v[fin] - ref_v[fin]).abs().max()) if fin.any() else 0.0
    atol = RTOL * float(ref_v[fin].abs().max())
    if not torch.allclose(v[fin], ref_v[fin], rtol=RTOL, atol=atol):
        raise AssertionError(f"{what}: values differ by up to {err}")
    rows_eq = float((i == ref_i).all(dim=1).float().mean())
    if rows_eq < 0.99:
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
        raise AssertionError(f"{what}: kernel and plain version differ")
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
    """A kernel's launches by form, out of the counts ``moved``."""
    return {name.split(".")[1]: n for name, n in moved.items()
            if name.startswith(f"{kern}.")}


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


def k7_lists(x, sidx, q, k):
    """Shard 0's hop-0 fold at k on the path's data: its own list, then
    shard p−1's block at positions (p−1)·k + j. Up to K2's MAX_K the
    shards' candidate lists; above it each shard's exact distances to its
    first k rows (the path's data, unsorted)."""
    p = sidx.n_shards
    slot = torch.arange(k, dtype=torch.int32, device=q.device).repeat(M, 1)
    if k <= fk.MAX_K:
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
    """The path's traversal from the seeded buffer, hop by hop on the
    plain K5 and select, for what the K5 and K6 bounds need: the parents
    that hop :data:`K5_HOP` hands K5 (a query whose frontier has closed
    hands it node 0), the finite parents expanded over all hops and the
    distinct nodes among them."""
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
            select=sk.select_k_plain, expand=ge.graph_expand_plain)
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
    plain = timer(lambda: ge.graph_expand_plain(*path), reps=3, warmup=0)
    deg_p, dim_p = st.deg_p, st.dim_p
    info = ge.kernel_info(deg_p, dim_p, st.vecs.dtype)
    log(f"  K5 at tiles {deg_p} x {dim_p}: {info['registers']} registers, "
        f"{info['local_bytes']} bytes of local memory (spills) a thread, "
        f"{info['warps_per_sm']} warps resident an SM")
    # each distinct parent's tile and aux row once; per pair its query,
    # parent id and k' outputs
    b, by = bound(len(sub) * (deg_p * dim_p + 2 * deg_p * 4)
                  + M * (dim_p * 4 + 4 + kp * 8), 2.0 * M * st.degree * D)
    log(f"  K5 at hop {K5_HOP}: {M} pairs over {len(sub)} distinct parents")
    return dict(name="graph_expand", route="cuda",
                source="raft_tpu_torch/csrc/graph_expand.cu",
                replaces="raft_tpu/ops/graph_expand.py:261",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=None,
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
                          st.vecs.dtype)
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
        forms = ("warp", "kpass") if k <= sk.WARP_MAX_K else ("kpass",)
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
        # forms in turn: warp, k-pass, k-pass, warp; the median of each.
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
    """K2 equal to its plain version on integer inputs (k = 10, 129, 256),
    close to it on the path's data at k = 10 (l2, ip) and at the CAGRA
    build's k = 129; timed at the brute-force path's shape and at the
    CAGRA build's (one full batch against the corpus at k = 129),
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
        for k in (K, CAGRA_D0 + 1, fk.MAX_K):
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
    """The grouped form's tiles at k: (live tiles, rows they read, queries
    they gather) of ``ivf_scan.pack_pairs``."""
    glist, _, gcount, _ = iscan.pack_pairs(probed.int(), N_LISTS,
                                           fk.block_queries(k))
    live = gcount > 0
    return (int(live.sum()), int(sizes.long()[glist[live].long()].sum()),
            int(gcount.sum()))


def k3_phase(timer, iidx, q, launches, by_form):
    """K3 in both forms against the plain version on the path's data (and
    each launched twice, bit-equal), both timed at the path's shape; the
    FP32 bound of the (pair, row) products is the row's, printed beside
    their 3xTF32 bound and the grouped form's tiles and bytes."""
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
    b, by = bound(distinct_rows * (D + 1) * 4 + M * D * 4
                  + M * N_PROBES * (4 + K * 8), 2.0 * D * scanned)
    tf = 3 * 2.0 * D * scanned / TF32_FLOPS_PER_S * 1e3
    tiles, tile_rows, gathered = group_tiles(probed, sizes, K)
    tile_bytes = tile_rows * (D + 1) * 4 + gathered * D * 4
    log(f"  K3 scans {scanned} (pair, row) products over {distinct_rows} "
        f"distinct rows; grouped form {times['group']:.3f} ms, per-pair "
        f"form {times['pair']:.3f} ms; FP32 bound {b:.4f} ms ({by}), "
        f"3xTF32 bound {tf:.4f} ms; {tiles} group tiles read "
        f"{tile_bytes / 1e9:.3f} GB (rows, norms, gathered queries); with "
        f"every list cut to one tile {one_tile:.3f} ms")
    return dict(name="ivf_flat_scan", route="cuda",
                source="raft_tpu_torch/csrc/ivf_flat_scan.cu",
                replaces="raft_tpu/ops/ivf_scan.py:284", launches=launches,
                max_abs_err=errs["group"], ms=times["group"],
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
                form="group", pair_ms=times["pair"],
                pair_max_abs_err=errs["pair"], tf32x3_bound_ms=tf,
                one_tile_ms=one_tile, group_tiles=tiles,
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
    # the LUT depends on the query alone: its FMAs once per query; then
    # one add per (pair, row, subspace)
    b, by = bound(distinct_rows * (PQ_DIM + 4) + q_rot.numel() * 4
                  + pidx.centers_rot.numel() * 4 + pidx.codebooks.numel() * 4
                  + pairs * (4 + K0 * 8),
                  M * 2 * PQ_DIM * book * pq_len, scanned * PQ_DIM)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; it runs only on an NVIDIA "
              "card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = smi_line()
    log(f"device: {smi} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = _cuda.build(verbose=True)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(logs) or 'cached'})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    centers = rng.standard_normal((N_BLOBS, D), dtype=np.float32)
    scales = rng.uniform(1.0, 1.6, N_BLOBS).astype(np.float32)
    (x, q), t_data = host_time(lambda: (
        torch.from_numpy(clustered(rng, N, centers, scales)).cuda(),
        torch.from_numpy(clustered(rng, M, centers, scales)).cuda()))
    log(f"data: {N} x {D} rows, {M} queries in {N_BLOBS} Gaussian clusters, "
        f"made in {t_data:.1f} s")

    bidx, iidx, pidx, cidx, sidx, moved = path_phase(x, q)
    determinism_phase(x, iidx, pidx)

    timer = Timer()
    k1_in = k1_inputs(x, q, bidx, iidx, pidx, cidx, sidx)
    kernels = [k1_phase(timer, k1_in, moved["select_k"],
                        by_form(moved, "select_k"))]
    del k1_in
    kernels += [k2_phase(timer, bidx, q, moved["fused_knn"],
                         cidx.build_stats["knn_graph_s"]),
               k3_phase(timer, iidx, q, moved["ivf_flat_scan"],
                        by_form(moved, "ivf_flat_scan")),
               k4_phase(timer, pidx, q, moved["ivf_pq_scan"],
                        by_form(moved, "ivf_pq_scan"))]
    del iidx, pidx
    buf_d, buf_i = seeded_buffer(cidx, q)
    hop_parents, *walked = walk(cidx, q, buf_d, buf_i)
    kernels += [k5_phase(timer, cidx, q, hop_parents, moved["graph_expand"]),
                k6_phase(timer, cidx, q, buf_d, buf_i, walked,
                         moved["cagra_fused"])]
    del cidx, buf_d, buf_i
    kernels += [k7_phase(timer, x, sidx, q, moved["merge_step"]),
                k8_phase(timer, x, sidx, q, moved["ring_topk"])]
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
    sys.exit(main())
