"""Time builds of the grouped scans (K3, its store forms beside its f32
form, and K4) from several source trees against each other in one
process, on ``chip_smoke.py``'s data.

    python -m raft_tpu_torch.tools.scan_ab [--only k3|k4] DIR [DIR ...]

Each DIR holds a copy of ``raft_tpu_torch/csrc`` (this tree's, another
commit's from ``git archive``, or a copy with one edit). Every version's
libraries are built with ``_cuda``'s flags into DIR (``kernel_ab.build``:
one nvcc each, all started together) and loaded by ctypes; each version
asks its own library for its plan (the queries a group), packs the pairs
by it and launches its grouped entry, which must keep this tree's C
signature. Prints the card's name and power limit, each instance's
registers and spills from ptxas, each version's plan, whether every
version's outputs equal the first's bit for bit, and each version's
median time in four rounds (versions in order, reversed, in order,
reversed; ``kernel_ab.median_ms``: the card's time of a call, L2 cold)
and the median of the four. Run from the root of the repository, on one
card.

- K3 (``ivf_flat_scan{,_bfloat16,_int8,_uint8}.cu``): ``chip_smoke.py``'s
  IVF-Flat indexes (1,024 lists of its 1M x 128 rows, 20 probes a query;
  float32, bf16 and int8 on the path's data, uint8 on the bench's byte
  grid of it) at k = 10 (the 10,000 queries) and at k = 257 and 512 (the
  first 8,192, as ``chip_smoke.py``'s wide phase).
- K4 (``ivf_pq_scan.cu``): the batch that CAGRA's IVF-PQ graph pass hands
  it in ``chip_smoke.py``'s graph route (k = 2·128 + 1 = 257): the pass's
  index (``cagra.build_knn_graph(algo="ivf_pq")``: 1,024 lists, pq_dim
  128 at 4 bits, the int8 LUT, 64 probes) and its first 32,768 rows; on
  the batch's lists, and with every list cut to one 128-row tile (the
  cost a group beside its tiles).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..neighbors import ivf_flat, ivf_pq
from ..ops import _cuda
from ..ops import fused_knn as fk
from ..ops import ivf_pq_scan as ipq
from ..ops import ivf_scan as iscan
from .kernel_ab import build, median_ms

_K, _BATCH, _TILE = 257, 32768, 128
_K3_KS, _K3_WIDE_QUERIES = (10, 257, 512), 8192
_K3_STORES = ("float32", "bfloat16", "int8", "uint8")


def path_rows():
    """chip_smoke.py's 1M x 128 rows and 10,000 queries, on the card."""
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    rng = np.random.default_rng(cs.SEED)
    centers = rng.standard_normal((cs.N_BLOBS, cs.D), dtype=np.float32)
    scales = rng.uniform(1.0, 1.6, cs.N_BLOBS).astype(np.float32)
    x = torch.from_numpy(cs.clustered(rng, cs.N, centers, scales)).cuda()
    q = torch.from_numpy(cs.clustered(rng, cs.M, centers, scales)).cuda()
    return cs, x, q


def store_indexes():
    """chip_smoke.py's IVF-Flat index of each store (uint8 on the bench's
    byte grid of the rows and queries), its queries, their norms and
    probes."""
    from .. import bench

    cs, x, q = path_rows()
    xb, qb = bench.byte_grid(x, q, "sqeuclidean",
                             ("raft_brute_force", "raft_ivf_flat"))
    out = {}
    for store in _K3_STORES:
        rows, qq = (xb, qb) if store == "uint8" else (x, q)
        idx = ivf_flat.build(rows, ivf_flat.IndexParams(
            n_lists=cs.N_LISTS, seed=cs.SEED, dtype=store))
        probed = iscan.coarse_probe(qq, idx.centers, cs.N_PROBES, "l2",
                                    idx.center_norms).int().contiguous()
        out[store] = dict(idx=idx, q=qq.contiguous(),
                          qn=fk.prepare_norms("l2", qq).contiguous(),
                          probed=probed)
    return out


def k3_launcher(lib, s, k):
    """A function → this library's grouped scan of a store's index at k
    (the first 8,192 queries past k = 256), packed by its own plan; and
    the plan."""
    idx = s["idx"]
    m = s["q"].shape[0] if k <= 256 else _K3_WIDE_QUERIES
    q, qn, probed = s["q"][:m], s["qn"][:m], s["probed"][:m]
    d = q.shape[1]
    plan = (ctypes.c_int * 4)()
    _cuda.check(lib.raft_ivf_flat_scan_group_plan(
        k, d, ctypes.addressof(plan)), "plan")
    qg = plan[0]
    glist, gstart, gcount, order = iscan.pack_pairs(
        probed, idx.offsets_dev.shape[0], qg)
    p = probed.shape[1]
    out_v = torch.empty((m, p * k), dtype=torch.float32, device="cuda")
    out_i = torch.empty((m, p * k), dtype=torch.int32, device="cuda")
    sc = idx.scales

    def run():
        _cuda.check(lib.raft_ivf_flat_scan_group(
            idx.data.data_ptr(), idx.data_norms.data_ptr(), None,
            None if sc is None else sc.data_ptr(), q.data_ptr(),
            qn.data_ptr(), order.data_ptr(), glist.data_ptr(),
            gstart.data_ptr(), gcount.data_ptr(), idx.offsets_dev.data_ptr(),
            idx.sizes_dev.data_ptr(), glist.shape[0], qg, p, d, k, 0,
            out_v.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "k3 group")
        return out_v, out_i

    return run, tuple(plan)


def compare(what, runs, dirs, reps):
    """Outputs of each version against the first's, then four rounds of
    times (versions in order, reversed, in order, reversed)."""
    outs = {d: [t.clone() for t in runs[d]()] for d in dirs}
    for d in dirs:
        same = all(torch.equal(a, c) for a, c in zip(outs[d],
                                                     outs[dirs[0]]))
        print(f"{what} {d}: outputs equal to {dirs[0]}'s: {same}")
    del outs
    times = {d: [] for d in dirs}
    for order in (dirs, dirs[::-1], dirs, dirs[::-1]):
        for d in order:
            times[d].append(median_ms(runs[d], reps))
    for d in dirs:
        print(f"{what} {d}: ms " + " / ".join(f"{t:.3f}" for t in times[d])
              + f"; median {float(np.median(times[d])):.3f}")


def k3_main(dirs) -> None:
    srcs = {st: (_cuda.STORE_SOURCES["ivf_flat_scan"][st], None)
            for st in _K3_STORES}
    libs, notes = build(dirs, srcs)
    print("\n".join(notes))
    idxs = store_indexes()
    for store in _K3_STORES:
        for k in _K3_KS:
            what = f"K3.{store} k={k}"
            runs = {}
            for d in dirs:
                runs[d], plan = k3_launcher(libs[d][store], idxs[store], k)
                print(f"{what} {d}: plan (queries a group, query tile, "
                      f"stages, bytes) {plan}")
            compare(what, runs, dirs, 3)
            del runs
            torch.cuda.empty_cache()


def pass_batch():
    """The graph pass's index and first batch on chip_smoke.py's data."""
    cs, x, _ = path_rows()
    n_lists = max(16, min(1024, int(np.sqrt(cs.N) * 2)))
    idx = ivf_pq.build(x, ivf_pq.IndexParams(
        n_lists=n_lists, pq_dim=min(cs.D, 4 * ivf_pq._default_pq_dim(cs.D)),
        pq_bits=4, seed=cs.SEED))
    q_rot = (x[:_BATCH] @ idx.rotation.T).contiguous()
    probed = iscan.coarse_probe(q_rot, idx.centers_rot,
                                max(16, min(64, n_lists // 8)), "l2",
                                idx.center_norms).int().contiguous()
    return dict(codes=idx.codes, dn=idx.row_norms.float().contiguous(),
                cb=ipq.lut_codebook(idx.codebooks, "int8").contiguous(),
                centers=idx.centers_rot.float().contiguous(), q=q_rot,
                probed=probed, offsets=idx.offsets_dev, sizes=idx.sizes_dev,
                n_lists=n_lists)


def launcher(lib, b, sizes):
    """A function → this library's grouped scan of the batch over
    ``sizes``, packed by its own plan."""
    pq_dim, book, pq_len = b["cb"].shape
    plan = (ctypes.c_int * 4)()
    _cuda.check(lib.raft_ivf_pq_scan_group_plan(
        _K, pq_dim * pq_len, ctypes.addressof(plan)), "plan")
    qg = plan[0]
    glist, gstart, gcount, order = iscan.pack_pairs(b["probed"],
                                                    b["n_lists"], qg)
    m, p = b["probed"].shape
    exact = torch.zeros(1, dtype=torch.int32, device="cuda")
    out_v = torch.empty((m, p * _K), dtype=torch.float32, device="cuda")
    out_i = torch.empty((m, p * _K), dtype=torch.int32, device="cuda")

    def run():
        _cuda.check(lib.raft_ivf_pq_scan_group(
            b["codes"].data_ptr(), b["dn"].data_ptr(), None,
            b["cb"].data_ptr(), b["centers"].data_ptr(), b["q"].data_ptr(),
            exact.data_ptr(), order.data_ptr(), glist.data_ptr(),
            gstart.data_ptr(), gcount.data_ptr(), b["offsets"].data_ptr(),
            sizes.data_ptr(), glist.shape[0], qg, p, pq_dim, pq_len, book,
            _K, 0, out_v.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "k4 group")
        return out_v, out_i

    return run, tuple(plan)


def main(argv) -> int:
    only = None
    if argv[:1] == ["--only"]:
        only, argv = argv[1], argv[2:]
    dirs = argv
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    if only != "k4":
        k3_main(dirs)
    if only != "k3":
        k4_main(dirs)
    return 0


def k4_main(dirs) -> None:
    libs, notes = build(dirs, {"k4": ("ivf_pq_scan", None)})
    print("\n".join(notes))
    b = pass_batch()
    cut = torch.clamp_max(b["sizes"], _TILE).contiguous()
    for what, sizes in (("lists", b["sizes"]), ("one tile", cut)):
        runs = {}
        for d in dirs:
            runs[d], plan = launcher(libs[d]["k4"], b, sizes)
            print(f"{what} {d}: plan (queries a group, query tile, stages, "
                  f"bytes) {plan}")
        compare(what, runs, dirs, 3)
        del runs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
