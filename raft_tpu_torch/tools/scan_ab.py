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
signature (K4's also the older one, before its scratch). Prints the card's
name and power limit, each instance's registers and spills from ptxas
(K4 also which versions compiled each kernel function to the first
version's SASS, by ``cuobjdump``), each version's plan, whether every
version's outputs equal the first's bit for bit, and each version's
median time in four rounds (versions in order, reversed, in order,
reversed; ``kernel_ab.median_ms``: the card's time of a call, L2 cold)
and the median of the four. Run from the root of the repository, on one
card.

- K3 (``ivf_flat_scan{,_bfloat16,_int8,_uint8}.cu``): ``chip_smoke.py``'s
  IVF-Flat indexes (1,024 lists of its 1M x 128 rows, 20 probes a query;
  float32, bf16 and int8 on the path's data, uint8 on the bench's byte
  grid of it) at k = 10 (the 10,000 queries), at k = 257 and 512 (the
  first 8,192, as ``chip_smoke.py``'s wide phase) and past 512 at
  k = 1,025 and 2,048 (the first 8,192: the wide plan,
  ``raft_ivf_flat_scan_wide``, with its scratch; a version without it
  says so), each shape with its bound (:func:`k3_bound`).
- K4 (``ivf_pq_scan.cu``): the batch that CAGRA's IVF-PQ graph pass hands
  it in ``chip_smoke.py``'s graph route (k = 2·128 + 1 = 257; first the
  path's IVF-PQ search at k = 20, its 10,000 queries, bf16 LUT): the pass's
  index (``cagra.build_knn_graph(algo="ivf_pq")``: 1,024 lists, pq_dim
  128 at 4 bits, the int8 LUT, 64 probes) and its first 32,768 rows; on
  the batch's lists, with every list cut to one 128-row tile (the cost a
  group beside its tiles), at k = 512 on its first 8,192 rows, and past
  512 at the batches of the pass at intermediate degree 256 (k = 513, its
  first 17,408 rows, ``cagra.pass_batch``'s) and 512 (k = 1,025, 8,192
  rows), with the per-pair form beside the grouped one at k = 513 (a
  version that refuses a k says so). Then
  each tree's split at the batch, timed in turns: the kernel whole,
  without its selection (its distances computed, nothing selected or
  written) and its products alone, each a copy of the tree's sources in
  DIR/split1, DIR/split2 built with ``ivf_pq_scan.cu``'s diagnostic
  switch ``RAFT_SCAN_SPLIT`` (an older tree without it has its
  selection call, and for the products its distances too, replaced by a
  sum that keeps the products).
"""
from __future__ import annotations

import ctypes
import re
import shutil
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
from .kernel_ab import build, median_ms, same_sass

_K, _BATCH, _TILE = 257, 32768, 128
_K3_KS, _K3_WIDE_QUERIES = (10, 257, 512, 1025, 2048), 8192
# the IVF-PQ pass's k and batch rows at intermediate degree 256 and 512
_PASS_WIDE = ((513, 17408), (1025, 8192))
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
    (the first 8,192 queries past k = 256; past 512 its wide entry with
    the scratch it asks for), packed by its own plan; and the plan. None
    where the library has no grouped form for k."""
    if k > iscan.GROUP_MAX_K and not hasattr(lib, "raft_ivf_flat_scan_wide"):
        return None, None
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
    lists = (idx.data.data_ptr(), idx.data_norms.data_ptr(), None,
             None if sc is None else sc.data_ptr(), q.data_ptr(),
             qn.data_ptr(), order.data_ptr(), glist.data_ptr(),
             gstart.data_ptr(), gcount.data_ptr(), idx.offsets_dev.data_ptr(),
             idx.sizes_dev.data_ptr())
    scratch, lmax = None, 0
    if k > iscan.GROUP_MAX_K:
        lmax = int(idx.sizes_dev.max())
        need = (ctypes.c_longlong * 3)()
        _cuda.check(lib.raft_ivf_flat_scan_wide_scratch(
            k, d, lmax, ctypes.addressof(need)), "scratch")
        scratch = torch.empty(need[0], dtype=torch.uint8, device="cuda")
    # the tensors behind the pointers live as long as the launcher
    keep = (q, qn, probed, order, glist, gstart, gcount, scratch)

    def run():
        assert keep
        stream = torch.cuda.current_stream().cuda_stream
        if scratch is None:
            status = lib.raft_ivf_flat_scan_group(
                *lists, glist.shape[0], qg, p, d, k, 0, out_v.data_ptr(),
                out_i.data_ptr(), stream)
        else:
            status = lib.raft_ivf_flat_scan_wide(
                *lists, scratch.data_ptr(), glist.shape[0], qg, p, d, k, 0,
                lmax, out_v.data_ptr(), out_i.data_ptr(), stream)
        _cuda.check(status, "k3 group")
        return out_v, out_i

    return run, tuple(plan)


def k3_bound(s, k, store):
    """The least time of K3 over a store's index at k on the queries
    :func:`k3_launcher` scans (``chip_smoke.scan_bound``): each probed
    list's rows as stored, their norms (and int8's scales) and the queries
    read once, each pair's k (value, row) written, against the products:
    3xTF32 over f32 rows, 2xTF32 over rows exact in TF32 (the others)."""
    import chip_smoke as cs

    idx = s["idx"]
    m = s["q"].shape[0] if k <= 256 else _K3_WIDE_QUERIES
    probed = s["probed"][:m].long()
    sizes = idx.sizes_dev.long()
    distinct = int(sizes[torch.unique(probed)].sum())
    row_bytes = idx.data.shape[1] * idx.data.element_size() + 4 + (
        4 if idx.scales is not None else 0)
    d = s["q"].shape[1]
    return cs.scan_bound(distinct * row_bytes + m * d * 4
                         + probed.numel() * (4 + k * 8),
                         int(sizes[probed].sum()), d,
                         3 if store == "float32" else 2)


def compare(what, runs, dirs, reps):
    """Outputs of each version against the first's, then four rounds of
    times (versions in order, reversed, in order, reversed); the versions
    without a run (no form for the shape) left out."""
    dirs = [d for d in dirs if runs.get(d) is not None]
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
                      f"stages, bytes) {plan or 'none: no form for this k'}")
            b, by = k3_bound(idxs[store], k, store)
            print(f"{what}: bound {b:.4f} ms ({by})")
            compare(what, runs, dirs, 3)
            del runs
            torch.cuda.empty_cache()


def path_batch():
    """chip_smoke.py's IVF-PQ path: its index (1,024 lists, pq 64 x 8),
    the 10,000 queries rotated, their 20 probes, the bf16 LUT (k = 20)."""
    cs, x, q = path_rows()
    idx = ivf_pq.build(x, ivf_pq.IndexParams(
        n_lists=cs.N_LISTS, pq_dim=cs.PQ_DIM, pq_bits=cs.PQ_BITS,
        seed=cs.SEED))
    q_rot = (q @ idx.rotation.T).contiguous()
    probed = iscan.coarse_probe(q_rot, idx.centers_rot, cs.N_PROBES, "l2",
                                idx.center_norms).int().contiguous()
    return dict(codes=idx.codes, dn=idx.row_norms.float().contiguous(),
                cb=ipq.lut_codebook(idx.codebooks, "bf16").contiguous(),
                centers=idx.centers_rot.float().contiguous(), q=q_rot,
                probed=probed, offsets=idx.offsets_dev, sizes=idx.sizes_dev,
                n_lists=cs.N_LISTS), cs.K0


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


# the grouped entry's C signature before the wide plan's scratch (older
# trees)
_OLD_GROUP_ARGS = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + \
    [ctypes.c_void_p] * 3


def launcher(lib, b, sizes, k=_K, m=None):
    """A function → this library's grouped scan of the batch's first ``m``
    queries over ``sizes`` at k, packed by its own plan (with its scratch,
    where its entry takes one); None where the library has no plan for
    k."""
    pq_dim, book, pq_len = b["cb"].shape
    plan = (ctypes.c_int * 4)()
    if lib.raft_ivf_pq_scan_group_plan(k, pq_dim * pq_len,
                                       ctypes.addressof(plan)) != 0:
        return None, None
    qg = plan[0]
    probed, q = b["probed"][:m], b["q"][:m]
    glist, gstart, gcount, order = iscan.pack_pairs(probed, b["n_lists"],
                                                    qg)
    m, p = probed.shape
    # the wrapper's flag: is every codebook value exact in TF32?
    exact = ((b["cb"].view(torch.int32) & ipq._TF32_LOW) == 0).all().to(
        torch.int32).reshape(1)
    out_v = torch.empty((m, p * k), dtype=torch.float32, device="cuda")
    out_i = torch.empty((m, p * k), dtype=torch.int32, device="cuda")
    lists = (b["codes"].data_ptr(), b["dn"].data_ptr(), None,
             b["cb"].data_ptr(), b["centers"].data_ptr(), q.data_ptr(),
             exact.data_ptr(), order.data_ptr(), glist.data_ptr(),
             gstart.data_ptr(), gcount.data_ptr(), b["offsets"].data_ptr(),
             sizes.data_ptr())
    shape = (qg, p, pq_dim, pq_len, book, k, 0)
    outs = (out_v.data_ptr(), out_i.data_ptr())
    if hasattr(lib, "raft_ivf_pq_scan_group_scratch"):
        lmax = int(sizes.max())
        need = (ctypes.c_longlong * 3)()
        _cuda.check(lib.raft_ivf_pq_scan_group_scratch(
            k, pq_dim * pq_len, lmax, ctypes.addressof(need)), "scratch")
        scratch = torch.empty(max(need[0], 1), dtype=torch.uint8,
                              device="cuda")
        args = (*lists, scratch.data_ptr(), glist.shape[0], *shape, lmax,
                *outs)
    else:
        lib.raft_ivf_pq_scan_group.argtypes = _OLD_GROUP_ARGS
        scratch = None
        args = (*lists, glist.shape[0], *shape, *outs)
    # the tensors behind the pointers live as long as the launcher
    keep = (q, exact, order, glist, gstart, gcount, scratch)

    def run():
        _cuda.check(lib.raft_ivf_pq_scan_group(
            *args, torch.cuda.current_stream().cuda_stream), "k4 group")
        assert keep
        return out_v, out_i

    return run, tuple(plan)


def pair_launcher(lib, b, k, m):
    """A function → this library's per-pair K4 over the batch's first
    ``m`` queries at k, the pairs in list order (as the wrapper)."""
    pq_dim, book, pq_len = b["cb"].shape
    probed, q = b["probed"][:m], b["q"][:m]
    p = probed.shape[1]
    order = torch.argsort(probed.reshape(-1), stable=True).to(torch.int32)
    out_v = torch.empty((m, p * k), dtype=torch.float32, device="cuda")
    out_i = torch.empty((m, p * k), dtype=torch.int32, device="cuda")

    def run():
        _cuda.check(lib.raft_ivf_pq_scan_pair(
            b["codes"].data_ptr(), b["dn"].data_ptr(), None,
            b["cb"].data_ptr(), b["centers"].data_ptr(), q.data_ptr(),
            probed.data_ptr(), order.data_ptr(), b["offsets"].data_ptr(),
            b["sizes"].data_ptr(), m, p, pq_dim, pq_len, book, k, 0,
            out_v.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "k4 pair")
        return out_v, out_i

    return run


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


# the split's diagnostic builds of K4 (ivf_pq_scan.cu's RAFT_SCAN_SPLIT):
# 1 computes the distances and selects nothing, 2 the products alone, 3
# (past k = 256) writes the distances to the scratch and selects nothing
SPLITS = {1: "no selection", 2: "products only", 3: "rows written"}
# an older tree without the switch: its selection call, and the
# distances before it, replaced by a sum that keeps the products
_KEEP = ("{ float kept = 0.f; for (int i = 0; i < MF; ++i) "
         "for (int j = 0; j < 4; ++j) for (int e = 0; e < 4; ++e) "
         "kept += acc[i][j][e]; if (__float_as_uint(kept) == 0x7fc00001u) "
         "out_v[0] = kept; }")
_OFFER = r"offer_tile<MF, R, CAP, RB>\(acc,.*?\);"
_EPILOGUE = r"const float\* side = sides \+ \(tile & 1\).*?" + _OFFER


def split_source(text: str, mode: int):
    """A tree's ivf_pq_scan.cu built for split ``mode``, or None where
    neither the switch nor the older selection call is found."""
    if "RAFT_SCAN_SPLIT" in text:
        return f"#define RAFT_SCAN_SPLIT {mode}\n" + text
    if mode == 3:  # no scratch in such a tree
        return None
    pat = _OFFER if mode == 1 else _EPILOGUE
    out, n = re.subn(pat, lambda _: _KEEP, text, count=1, flags=re.DOTALL)
    return out if n == 1 else None


def split_dirs(dirs, root=None):
    """{(DIR, mode): a copy of DIR's sources built for the split, in
    DIR/split<mode> (or ``root``/split<mode>)}."""
    out = {}
    for d in dirs:
        text = (Path(d) / "ivf_pq_scan.cu").read_text()
        for mode in SPLITS:
            src = split_source(text, mode)
            if src is None:
                print(f"split: no {SPLITS[mode]!r} build of {d}")
                continue
            sd = Path(root or d) / f"split{mode}"
            sd.mkdir(parents=True, exist_ok=True)
            for f in Path(d).glob("*.cu*"):
                shutil.copy(f, sd / f.name)
            (sd / "ivf_pq_scan.cu").write_text(src)
            out[d, mode] = str(sd)
    return out


def k4_main(dirs) -> None:
    splits = split_dirs(dirs)
    libs, notes = build([*dirs, *splits.values()],
                        {"k4": ("ivf_pq_scan", None)})
    print("\n".join(notes))
    same_sass(dirs, "k4")
    path, k0 = path_batch()
    runs = {}
    for d in dirs:
        runs[d], plan = launcher(libs[d]["k4"], path, path["sizes"], k0)
        print(f"path k={k0} {d}: plan (queries a group, query tile, "
              f"stages, bytes) {plan}")
    compare(f"path k={k0}", runs, dirs, 10)
    del runs, path
    b = pass_batch()
    cut = torch.clamp_max(b["sizes"], _TILE).contiguous()
    for what, sizes, k, m in (
            ("lists", b["sizes"], _K, None),
            ("one tile", cut, _K, None),
            (f"k={iscan.GROUP_MAX_K}, {_K3_WIDE_QUERIES} queries",
             b["sizes"], iscan.GROUP_MAX_K, _K3_WIDE_QUERIES),
            *((f"the pass at k={k}, {m} queries", b["sizes"], k, m)
              for k, m in _PASS_WIDE)):
        runs = {}
        for d in dirs:
            runs[d], plan = launcher(libs[d]["k4"], b, sizes, k, m)
            print(f"{what} {d}: plan (queries a group, query tile, stages, "
                  f"bytes) {plan or 'none: no form for this k'}")
        compare(what, runs, dirs, 3)
        del runs
        torch.cuda.empty_cache()
    # the per-pair form at the pass's k = 513, beside the grouped form
    k, m = _PASS_WIDE[0]
    runs = {d: pair_launcher(libs[d]["k4"], b, k, m) for d in dirs}
    compare(f"the pass at k={k}, {m} queries, per-pair form", runs, dirs, 1)
    del runs
    torch.cuda.empty_cache()
    # the split at the pass batch: each tree whole, without its selection,
    # and its products alone, in turns
    for d in dirs:
        runs = {"whole": launcher(libs[d]["k4"], b, b["sizes"])[0]}
        for mode, name in SPLITS.items():
            if (d, mode) in splits:
                runs[name] = launcher(libs[splits[d, mode]]["k4"], b,
                                      b["sizes"])[0]
        print(f"split {d}: " + ", ".join(
            f"{name} {t:.3f} ms" for name, t in split_times(runs).items()))
        del runs
        torch.cuda.empty_cache()


def split_times(runs, reps: int = 3) -> dict:
    """{name: the median of four rounds of ``median_ms``} of the split's
    runs, timed in turns (in order, reversed, in order, reversed)."""
    times = {name: [] for name in runs}
    names = list(runs)
    for order in (names, names[::-1], names, names[::-1]):
        for name in order:
            times[name].append(median_ms(runs[name], reps))
    return {name: float(np.median(t)) for name, t in times.items()}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
