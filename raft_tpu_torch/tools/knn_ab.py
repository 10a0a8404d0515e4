"""Time builds of K1 and of K2 from several source trees against each
other in one process, at the shapes of ``chip_smoke.py``'s paths.

    python -m raft_tpu_torch.tools.knn_ab [--stores S,S,...] [--ks K,K,...] \\
        [--no-k1] [--no-k2] DIR [DIR ...]

Each DIR holds a copy of ``raft_tpu_torch/csrc`` (this tree's, another
commit's from ``git archive``, or a copy with one edit, such as a
diagnostic build that leaves out a part of the kernel). Every version's
``select_k.cu`` and ``fused_knn*.cu`` (one a store in ``--stores``,
default all five) is built with ``_cuda``'s flags into DIR
(``kernel_ab.build``: one nvcc each, all started together) and loaded by
ctypes; entry points must keep this tree's C signatures.

* K1 at the merges ``chip_smoke.py``'s paths hand it, built on its 1M x
  128 rows: the IVF-PQ graph pass's first batch (``scan_ab``'s index and
  batch) scanned by this tree's K4 at k = 257 into (32,768, 64 x 257)
  candidates and, on its first 8,192 rows, at k = 1,025 (the pass at
  intermediate degree 512: (8,192, 65,600)); and the IVF-Flat search at
  k = 2,048 (``chip_smoke.py``'s index, its 10,000 queries x 20 probes:
  (10,000, 40,960)). Each version's form past k = 512 (the radix select,
  ``raft_select_k_radix``; an older tree's k passes,
  ``raft_select_k_kpass``) at every shape, its warp form at 257, each
  checked equal to the plain version, timed beside ``torch.topk`` and the
  plain version.
* K2 at the brute-force path's shape (10,000 queries, 1M rows, d = 128,
  l2) in each store: the f32 rows, ``brute_force.build``'s bf16, int8 and
  int4 stores and the bench's uint8 byte grid; at each k of ``--ks``
  (default 10, the path's, and 257 and 1,024, past the k-lists: the wide
  form, ``raft_fused_knn_wide``, with its candidate buffers; a version
  whose wide entry refuses k runs its k-list plan, one without either
  says so). Up to ``LIST_MAX_K`` a tree whose wide entry takes any k is
  also timed in its wide form, as ``DIR:wide`` (where the plans cross).
  Each version launches its library with its own split plan
  (``fused_knn.split_plan`` over its ``raft_fused_knn_slots``); whether
  its results (its splits' lists merged by this tree's K1, as
  ``fused_knn`` merges them) equal the first version's is printed (a
  diagnostic build's do not), and the time of that merge.

Prints the card's name and power limit, each instance's registers and
spills from ptxas, and each version's median time in four rounds
(versions in order, reversed, in order, reversed;
``kernel_ab.median_ms``: the card's time of a call, L2 cold). Run from
the root of the repository, on one card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .. import bench
from ..matrix import select_k as sk
from ..neighbors import brute_force, ivf_flat
from ..ops import _cuda
from ..ops import fused_knn as fk
from ..ops import ivf_pq_scan as ipq
from ..ops import ivf_scan as iscan
from .kernel_ab import build, median_ms
from .scan_ab import _K, _PASS_WIDE, pass_batch, path_rows

_STORES = ("float32", "bfloat16", "int8", "uint8", "int4")


def rounds(dirs, runs, reps):
    """Each version's times in four rounds: in order, reversed, twice."""
    times = {d: [] for d in dirs}
    for order in (dirs, dirs[::-1], dirs, dirs[::-1]):
        for d in order:
            times[d].append(median_ms(runs[d], reps))
    return times


# K1's C signature, also an older tree's k-pass entry
_K1_ARGS = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3


def k1_inputs():
    """The merge inputs → [(what, values, k)]."""
    b = pass_batch()
    args = (b["codes"], b["dn"], None, b["cb"], b["centers"])
    rest = (b["offsets"], b["sizes"])
    c257, _ = ipq.ivf_pq_scan_candidates(*args, b["q"], b["probed"], *rest,
                                         _K, "l2")
    m = _PASS_WIDE[-1][1]
    c1025, _ = ipq.ivf_pq_scan_candidates(*args, b["q"][:m],
                                          b["probed"][:m], *rest,
                                          _PASS_WIDE[-1][0], "l2")
    del b, args, rest
    cs, x, q = path_rows()
    idx = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=cs.N_LISTS,
                                                 seed=cs.SEED))
    probed = iscan.coarse_probe(q, idx.centers, cs.N_PROBES, "l2",
                                idx.center_norms).int().contiguous()
    c2048, _ = iscan.ivf_flat_scan_candidates(
        idx.data, idx.data_norms, None, q, fk.prepare_norms("l2", q),
        probed, idx.offsets_dev, idx.sizes_dev, 2048, "l2")
    del idx, x, q
    torch.cuda.empty_cache()
    return [("the IVF-PQ pass's merge", c257, _K),
            ("the degree-512 IVF-PQ pass's merge", c1025,
             _PASS_WIDE[-1][0]),
            ("the IVF-Flat search's merge", c2048, 2048)]


def k1_ab(dirs, libs) -> None:
    shapes = k1_inputs()
    stream = torch.cuda.current_stream().cuda_stream
    for what, cand, k in shapes:
        rows, n = cand.shape
        ref = sk.select_k_plain(cand, k)
        ov = torch.empty((rows, k), dtype=torch.float32, device="cuda")
        oi = torch.empty((rows, k), dtype=torch.int32, device="cuda")
        print(f"K1 on {what} ({rows}, {n}) k={k}")
        forms = ("warp", "wide") if k <= sk.WARP_MAX_K else ("wide",)
        for form in forms:
            runs = {}
            for d in dirs:
                lib = libs[d]["k1"]
                name = ("raft_select_k_warp" if form == "warp" else next(
                    e for e in ("raft_select_k_radix", "raft_select_k_kpass")
                    if hasattr(lib, e)))
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = _K1_ARGS, ctypes.c_int

                def run(fn=fn):
                    return fn(cand.data_ptr(), rows, n, k, 1, ov.data_ptr(),
                              oi.data_ptr(), stream)

                if run() != 0:
                    print(f"K1 {name} {d}: refuses k={k}")
                    continue
                torch.cuda.synchronize()
                same = torch.equal(ov, ref[0]) and torch.equal(oi, ref[1])
                print(f"K1 {name} {d}: equal to the plain version: {same}")
                runs[d] = (name, run)
            if runs:
                times = rounds(list(runs), {d: r[1] for d, r in runs.items()},
                               3)
                for d, ts in times.items():
                    print(f"K1 {runs[d][0]} {d}: ms "
                          + " / ".join(f"{t:.3f}" for t in ts)
                          + f"; median {float(np.median(ts)):.3f}")
        topk = median_ms(lambda: torch.topk(cand, k, dim=1, largest=False), 3)
        plain = median_ms(lambda: sk.select_k_plain(cand, k), 3)
        print(f"K1 torch.topk: ms {topk:.3f}; plain: ms {plain:.3f}; bytes "
              f"bound {(rows * n * 4 + rows * k * 8) / 3.35e12 * 1e3:.3f}")
        del ref, ov, oi
    del shapes
    torch.cuda.empty_cache()


def store_data(stores):
    """chip_smoke.py's rows and queries in each store → {store: (queries
    as K2 takes them, their norms, rows, row norms, scales)}."""
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    rng = np.random.default_rng(cs.SEED)
    centers = rng.standard_normal((cs.N_BLOBS, cs.D), dtype=np.float32)
    scales = rng.uniform(1.0, 1.6, cs.N_BLOBS).astype(np.float32)
    x = torch.from_numpy(cs.clustered(rng, cs.N, centers, scales)).cuda()
    q = torch.from_numpy(cs.clustered(rng, cs.M, centers, scales)).cuda()
    out = {}
    for store in stores:
        xs, qs = x, q
        if store == "uint8":
            xs, qs = bench.byte_grid(x, q, "sqeuclidean",
                                     ("raft_brute_force", "raft_ivf_flat"))
        idx = brute_force.build(xs, dtype=store)
        qk = fk.kernel_queries(qs, store, idx.dataset.shape[1]).contiguous()
        out[store] = (qk, fk.prepare_norms("l2", qs),
                      idx.dataset, fk.prepare_norms("l2", None, idx.norms),
                      idx.scales)
    return out


def k2_launcher(lib, store_rows, k, what, forms):
    """A function → this library's K2 over a store's rows at k with its
    own split plan, and (resident blocks, splits, parts, form); None where
    the library has none of ``forms`` ("wide", "list") for k, the first it
    takes being run: its wide entry (with its scratch: the size the
    library states, or an older tree's per-split buffers of 8 bytes a
    key), its k-list entry. ``parts``: the sorted lists a query that it
    writes (the splits, for K1 to merge, or one)."""
    qk, qn, xs, dn, sc = store_rows
    m, d = qk.shape
    n = xs.shape[0]
    slots = lib.raft_fused_knn_slots(k, d, 0, 0)
    if slots < 0:
        _cuda.check(-slots, f"{what} fused_knn slots")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for form in forms:
        if form == "wide" and not hasattr(lib, "raft_fused_knn_wide"):
            continue
        merged = form == "wide" and hasattr(lib,
                                            "raft_fused_knn_wide_scratch")
        # a block's queries: the wide form 128 (an older tree's 64), the
        # k-lists 128 up to k = 64 and 64 above
        queries = 128 if merged or (form == "list" and k <= 64) else 64
        splits, per = fk.split_plan(m, n, k, slots, queries=queries)
        parts = 1 if merged else splits
        ov = torch.empty((m, parts * k), dtype=torch.float32, device="cuda")
        oi = torch.empty((m, parts * k), dtype=torch.int32, device="cuda")
        cap = fk.wide_cap(k)
        size = (lib.raft_fused_knn_wide_scratch(m, splits, cap) if merged
                else 8 * m * splits * cap if form == "wide" else 1)
        scratch = torch.empty(size, dtype=torch.uint8, device="cuda")
        head = (qk.data_ptr(), qn.data_ptr(), xs.data_ptr(), dn.data_ptr(),
                None, None if sc is None else sc.data_ptr(), m, n, d, k, 0,
                splits, per)
        if form == "wide":
            call = lambda h=head, s=scratch, v=ov, i=oi: (  # noqa: E731
                lib.raft_fused_knn_wide(*h, cap, s.data_ptr(), v.data_ptr(),
                                        i.data_ptr(), stream()))
        else:
            call = lambda h=head, v=ov, i=oi: lib.raft_fused_knn(  # noqa
                *h, v.data_ptr(), i.data_ptr(), stream())
        if call() != 0:   # this tree's form refuses k
            continue

        def run(call=call, ov=ov, oi=oi):
            _cuda.check(call(), what)
            return ov, oi

        return run, (slots, splits, parts, form)
    return None, None


def merged(cand_v, cand_i, parts: int, k: int):
    """A launch's lists as ``fused_knn`` returns them: the parts merged by
    this tree's K1 where there are several."""
    if parts == 1:
        return cand_v, cand_i
    vals, pos = sk.kpass_select_k(cand_v, k)
    ids = torch.gather(cand_i, 1, pos.long())
    return vals, torch.where(torch.isfinite(vals), ids, -1)


def k2_ab(dirs, libs, stores, ks) -> None:
    data = store_data(stores)
    for store in stores:
        for k in ks:
            what = f"K2.{store} k={k}"
            runs, outs, plans = {}, {}, {}
            # each tree's form for k (past LIST_MAX_K its wide entry where
            # it takes k); up to LIST_MAX_K also the wide form of a tree
            # whose wide entry takes any k, as "DIR:wide"
            versions = [(dr, ("wide", "list") if k > fk.LIST_MAX_K
                         else ("list",)) for dr in dirs]
            if k <= fk.LIST_MAX_K:
                versions += [(f"{dr}:wide", ("wide",)) for dr in dirs
                             if hasattr(libs[dr][store],
                                        "raft_fused_knn_wide_scratch")]
            for dr, forms in versions:
                lib = libs[dr.split(":")[0]][store]
                run, plan = k2_launcher(lib, data[store], k, f"{dr} {what}",
                                        forms)
                if run is None:
                    print(f"{what} {dr}: no form for this k")
                    continue
                cv, ci = run()
                outs[dr] = merged(cv, ci, plan[2], k)
                torch.cuda.synchronize()
                runs[dr], plans[dr] = run, plan
                print(f"{what} {dr}: {plan[3]} form, {plan[0]} resident "
                      f"blocks, {plan[1]} splits, {plan[2]} lists a query")
            timed = [dr for dr, _ in versions if dr in runs]
            first = outs[timed[0]]
            for dr in timed[1:]:
                same = all(torch.equal(a, c)
                           for a, c in zip(outs[dr], first))
                print(f"{what} {dr}: results equal to {timed[0]}'s: {same}")
            del outs
            for dr, ts in rounds(timed, runs, 3).items():
                print(f"{what} {dr}: ms " + " / ".join(f"{t:.3f}"
                                                       for t in ts)
                      + f"; median {float(np.median(ts)):.3f}")
            for dr in timed:  # the splits' merge, as fused_knn runs it
                parts = plans[dr][2]
                if parts > 1:
                    cand = runs[dr]()[0]
                    ms = median_ms(lambda: sk.kpass_select_k(cand, k), 3)
                    print(f"{what} {dr}: this tree's K1 merge of its "
                          f"{parts} lists {tuple(cand.shape)}: ms {ms:.3f}")
            del runs
            torch.cuda.empty_cache()


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stores", default=",".join(_STORES))
    ap.add_argument("--ks", default="10,257,1024")
    ap.add_argument("--no-k1", action="store_true")
    ap.add_argument("--no-k2", action="store_true")
    ap.add_argument("dirs", nargs="+")
    a = ap.parse_args(argv)
    stores = [] if a.no_k2 else [s for s in a.stores.split(",") if s]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    kernels = {s: (_cuda.STORE_SOURCES["fused_knn"][s], None)
               for s in stores}
    libs, notes = build(a.dirs, kernels)
    if not a.no_k1:
        k1 = {"k1": ("select_k", None)}
        libs_k1, notes_k1 = build(a.dirs, k1)
        for d, lib in libs_k1.items():
            libs.setdefault(d, {}).update(lib)
        notes += notes_k1
    print("\n".join(notes))
    if not a.no_k1:
        k1_ab(a.dirs, libs)
    if stores:
        k2_ab(a.dirs, libs, stores, [int(k) for k in a.ks.split(",") if k])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
