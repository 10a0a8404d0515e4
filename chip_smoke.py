#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``raft_tpu_torch``) on one NVIDIA card.

Usage, from the root of a checkout, on a machine with a card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA::

    python3 chip_smoke.py

It builds the four CUDA kernels from ``raft_tpu_torch/csrc`` (one
``nvcc`` per source, all at once, into ``build/kernels/``), then:

1. path: three paths through the public entry points at SIFT-1M's shape —
   1,000,000 x 128 float32 rows and 10,000 queries in 1,000 overlapping
   Gaussian clusters (unit-normal centers, per-cluster spread 1.0-1.6:
   the clusters overlap, so true neighbors cross list boundaries and
   recall stays below 1), made from a seed with numpy (SIFT-1M itself is
   not in the repository):
   - brute force: build and search (k = 10);
   - IVF-Flat: build (n_lists = 1024) and search (n_probes = 20);
   - IVF-PQ: build (n_lists = 1024, pq_dim = 64, pq_bits = 8,
     per-subspace codebooks), search (n_probes = 20, bf16 LUT, k0 = 20
     candidates) and refine against the float32 rows to k = 10.
   Each path runs with every launch counter set to 0 just before it, and
   fails if a kernel of the path did not launch. Checks: IVF-Flat
   recall@10 against the brute-force answer >= 0.90, IVF-PQ refined
   recall@10 >= 0.85, the brute-force answer and the refined distances
   against numpy on a few queries;
2. kernels: each kernel against its plain PyTorch version on the card at
   the path's shapes (K4 also on an integer-valued copy of the IVF-PQ
   index, where they must be equal), with the kernel's time (median of
   CUDA-event timed calls after a warm-up, L2 flushed before each), the
   plain version's time, one PyTorch library call's time where one
   computes the same function, and the least time the card could take:
   the larger of the bytes over 3.35 TB/s and the operations' time, with
   FP32 FLOPs at 67 TFLOP/s (an FMA counts 2) and single adds or
   compares at half that, 33.5 T/s (H100 SXM data sheet).

Prints progress lines, then a ``{"kernels": [...]}`` line, the card's name
and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is not 0. With no CUDA device it exits non-zero before printing any
result. Every matrix product runs in full float32 (TF32 off).
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from raft_tpu_torch.matrix import select_k as sk
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq, refine
from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.ops import fused_knn as fk
from raft_tpu_torch.ops import ivf_pq_scan as ipq
from raft_tpu_torch.ops import ivf_scan as iscan
from raft_tpu_torch.stats.metrics import neighborhood_recall

SEED = 0
N, D, M, K = 1_000_000, 128, 10_000, 10
N_LISTS, N_PROBES = 1024, 20
N_BLOBS = 1000
PQ_DIM, PQ_BITS, K0 = 64, 8, 20   # raft-ann-bench's IVF-PQ setting, d = 128
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, FP32 outside the tensor cores
FP32_INSTR_PER_S = 33.5e12     # one add, compare or FMA per lane per clock
RTOL = 1e-5                    # float32 sums in another order

_COUNTERS = {"select_k": sk, "fused_knn": fk, "ivf_flat_scan": iscan,
             "ivf_pq_scan": ipq}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for mod in _COUNTERS.values():
        mod.launches = 0


def counts() -> dict:
    return {name: mod.launches for name, mod in _COUNTERS.items()}


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


def check_equal(ref, got, what: str) -> None:
    for a, b in zip(ref, got):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: kernel and plain version differ")
    log(f"  {what}: values and ids equal")


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
        "ivf_flat", ("ivf_flat_scan", "select_k"), ivf_path, totals)
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
     t_ref) = run_path("ivf_pq", ("ivf_pq_scan", "select_k"), pq_path,
                       totals)
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
    return bidx, iidx, pidx, totals


def k1_phase(timer, launches):
    rng = np.random.default_rng(SEED + 1)
    vals = rng.integers(0, 64, (M, N_LISTS)).astype(np.float32)
    vals[rng.random((M, N_LISTS)) < 0.02] = np.inf
    v = torch.from_numpy(vals).cuda()
    k = N_PROBES
    check_equal(sk.select_k_plain(v, k), sk.kpass_select_k(v, k),
                f"K1 select_k ({M}, {N_LISTS}) k={k}, integer rows")
    ms = timer(lambda: sk.kpass_select_k(v, k))
    plain = timer(lambda: sk.select_k_plain(v, k))
    lib = timer(lambda: torch.topk(v, k, dim=1, largest=False))
    b, by = bound(v.numel() * 4 + M * k * 8, 0.0, v.numel())
    return dict(name="select_k", route="cuda",
                source="raft_tpu_torch/csrc/select_k.cu",
                replaces="raft_tpu/matrix/select_k.py:127",
                launches=launches, max_abs_err=0.0, ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=lib,
                shape=f"({M}, {N_LISTS}) k={k}")


def k2_phase(timer, bidx, q, launches):
    x, norms = bidx.dataset, bidx.norms
    rng = np.random.default_rng(SEED + 2)
    qi = torch.from_numpy(rng.integers(-3, 4, (256, 32)).astype(
        np.float32)).cuda()
    xi = torch.from_numpy(rng.integers(-3, 4, (50_000, 32)).astype(
        np.float32)).cuda()
    for metric in ("l2", "ip"):
        check_equal(fk.fused_knn_plain(qi, xi, K, metric),
                    fk.fused_knn(qi, xi, K, metric),
                    f"K2 fused_knn {metric} (256, 50000, 32) k={K}, "
                    "integer inputs")
    sub = q[:512]
    qn = fk.prepare_norms("l2", q)
    out = {}
    for metric in ("l2", "ip"):
        pv, pi = fk.fused_knn_plain(sub, x, K, metric, norms)
        kv, ki = fk.fused_knn(sub, x, K, metric, norms)
        err = check_close(pv, pi, kv, ki,
                          f"K2 fused_knn {metric} (512 of {M} queries, "
                          f"{N}, {D}) k={K}")
        dn = fk.prepare_norms(metric, x, norms)
        qm = qn if metric == "l2" else None
        ms = timer(lambda: fk.fused_knn_candidates(q, qm, x, dn, None, K,
                                                   metric))
        log(f"  K2 {metric} at ({M}, {N}, {D}) k={K}: {ms:.2f} ms")
        out[metric] = (err, ms)
    plain = timer(lambda: fk.fused_knn_plain(q, x, K, "l2", norms), reps=3,
                  warmup=0)

    def library():
        for s in range(0, M, 1000):
            dist = torch.addmm(norms[None, :], q[s:s + 1000], x.T,
                               alpha=-2.0)
            torch.topk(dist, K, dim=1, largest=False)

    lib = timer(library, reps=3)
    splits, _ = fk._split_plan(M, N, x.device)
    b, by = bound((M * D + N * D + N + M) * 4 + M * splits * K * 8,
                  2.0 * M * N * D)
    return dict(name="fused_knn", route="cuda",
                source="raft_tpu_torch/csrc/fused_knn.cu",
                replaces="raft_tpu/ops/fused_knn.py:336",
                launches=launches, max_abs_err=out["l2"][0],
                ms=out["l2"][1], plain_ms=plain, bound_ms=b, bound_by=by,
                library_ms=lib, ip_ms=out["ip"][1],
                shape=f"({M}, {N}, {D}) k={K} l2, {splits} corpus splits")


def k3_phase(timer, iidx, q, launches):
    probed = iscan.coarse_probe(q, iidx.centers, N_PROBES, "l2",
                                iidx.center_norms)
    args = (iidx.data, iidx.data_norms, probed, iidx.offsets_dev,
            iidx.sizes_dev, q, K, "l2")
    pv, pi = iscan.ivf_flat_scan_plain(*args)
    kv, ki = iscan.ivf_flat_scan(*args)
    err = check_close(pv, pi, kv, ki, f"K3 ivf_flat_scan ({M} queries, "
                      f"n_probes={N_PROBES}) k={K}")
    qn = fk.prepare_norms("l2", q)
    ms = timer(lambda: iscan.ivf_flat_scan_candidates(
        iidx.data, iidx.data_norms, None, q, qn, probed.int(),
        iidx.offsets_dev, iidx.sizes_dev, K, "l2"))
    plain = timer(lambda: iscan.ivf_flat_scan_plain(*args), reps=3,
                  warmup=0)
    sizes = iidx.sizes_dev.long()
    scanned = int(sizes[probed.long()].sum())          # (pair, row) count
    lists = torch.unique(probed)
    distinct_rows = int(sizes[lists].sum())
    b, by = bound(distinct_rows * (D + 1) * 4 + M * D * 4
                  + M * N_PROBES * (4 + K * 8), 2.0 * D * scanned)
    log(f"  K3 scans {scanned} (pair, row) products over {distinct_rows} "
        "distinct rows")
    return dict(name="ivf_flat_scan", route="cuda",
                source="raft_tpu_torch/csrc/ivf_flat_scan.cu",
                replaces="raft_tpu/ops/ivf_scan.py:284", launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None,
                shape=f"{M} queries x {N_PROBES} probes, k={K}")


def k4_phase(timer, pidx, q, launches):
    q_rot = (q @ pidx.rotation.T).contiguous()
    probed = iscan.coarse_probe(q_rot, pidx.centers_rot, N_PROBES, "l2",
                                pidx.center_norms)

    def args(idx, mode, qr, pr):
        return (idx.codes, idx.row_norms, idx.centers_rot,
                ipq.lut_codebook(idx.codebooks, mode), pr, idx.offsets_dev,
                idx.sizes_dev, qr)

    shape = f"{M} queries x {N_PROBES} probes, pq_dim={PQ_DIM}, k={K0}"
    # the path's LUT mode (bf16) on all its queries: the reported error
    path = args(pidx, "bf16", q_rot, probed)
    err = check_close(*ipq.ivf_pq_scan_plain(*path, K0, "l2"),
                      *ipq.ivf_pq_scan(*path, K0, "l2"),
                      f"K4 ivf_pq_scan bf16 LUT ({shape})")
    full = args(pidx, "f32", q_rot, probed)
    check_close(*ipq.ivf_pq_scan_plain(*full, K0, "l2"),
                *ipq.ivf_pq_scan(*full, K0, "l2"),
                f"K4 ivf_pq_scan f32 LUT ({shape})")
    sub = args(pidx, "int8", q_rot[:1000], probed[:1000])
    check_close(*ipq.ivf_pq_scan_plain(*sub, K0, "l2"),
                *ipq.ivf_pq_scan(*sub, K0, "l2"),
                f"K4 ivf_pq_scan int8 LUT (1000 of {M} queries)")
    # the path's index with a small-integer codebook and centers: every
    # LUT entry and sum is exact, so kernel and plain version are equal
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
            check_equal(ipq.ivf_pq_scan_plain(*a, K0, metric),
                        ipq.ivf_pq_scan(*a, K0, metric),
                        f"K4 ivf_pq_scan {mode} LUT {metric}, integer "
                        "codebook/centers/queries (1000 queries)")
    # time in the path's LUT mode (bf16)
    def launch(sizes):
        return ipq.ivf_pq_scan_candidates(
            pidx.codes, pidx.row_norms, None, path[3], pidx.centers_rot,
            q_rot, probed, pidx.offsets_dev, sizes, K0, "l2")

    ms = timer(lambda: launch(pidx.sizes_dev))
    # every list cut to one row: the per-pair LUT build and each block's
    # fixed cost (k-best init, q·c_l, ||q||², output writes) with almost
    # no list scan
    lut_ms = timer(lambda: launch(torch.clamp_max(pidx.sizes_dev, 1)))
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
    log(f"  K4 scans {scanned} (pair, row) products over {distinct_rows} "
        f"distinct rows; with one row per list (LUT build and per-block "
        f"fixed cost) {lut_ms:.2f} ms")
    return dict(name="ivf_pq_scan", route="cuda",
                source="raft_tpu_torch/csrc/ivf_pq_scan.cu",
                replaces="raft_tpu/ops/ivf_pq_scan.py:290",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=None,
                lut_only_ms=lut_ms, shape=f"{shape}, bf16 LUT")


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

    bidx, iidx, pidx, moved = path_phase(x, q)

    timer = Timer()
    kernels = [k1_phase(timer, moved["select_k"]),
               k2_phase(timer, bidx, q, moved["fused_knn"]),
               k3_phase(timer, iidx, q, moved["ivf_flat_scan"]),
               k4_phase(timer, pidx, q, moved["ivf_pq_scan"])]
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
