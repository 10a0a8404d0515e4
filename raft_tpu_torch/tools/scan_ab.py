"""Time builds of K4's grouped form from several source trees against each
other in one process, on the batch that CAGRA's IVF-PQ graph pass hands
it in ``chip_smoke.py``'s graph route (k = 2·128 + 1 = 257).

    python -m raft_tpu_torch.tools.scan_ab DIR [DIR ...]

Each DIR holds a copy of ``raft_tpu_torch/csrc`` (this tree's, or a copy
with one edit). Every version's ``ivf_pq_scan.cu`` is built with
``_cuda``'s flags into DIR (``kernel_ab.build``: one nvcc each, all
started together) and loaded by ctypes. The data are ``chip_smoke.py``'s
1M x 128 rows; the index is the pass's
(``cagra.build_knn_graph(algo="ivf_pq")``: 1,024 lists, pq_dim 128 at 4
bits, the int8 LUT, 64 probes) and the batch its first 32,768 rows. Each
version asks its own library for its plan
(``raft_ivf_pq_scan_group_plan``: the queries a group), packs the pairs
by it and launches its grouped entry, which must keep this tree's C
signature. Prints the card's name and power limit, each instance's
registers and spills from ptxas, each version's plan, whether every
version's outputs equal the first's, and each version's median event
time in four rounds (versions in order, reversed, in order, reversed):
on the batch's lists, and with every list cut to one 128-row tile (the
cost a group beside its tiles). Run from the root of the repository, on
one card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..neighbors import ivf_pq
from ..ops import _cuda
from ..ops import ivf_pq_scan as ipq
from ..ops import ivf_scan as iscan
from .kernel_ab import build, median_ms

_K, _BATCH, _TILE = 257, 32768, 128


def pass_batch():
    """The graph pass's index and first batch on chip_smoke.py's data."""
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    rng = np.random.default_rng(cs.SEED)
    centers = rng.standard_normal((cs.N_BLOBS, cs.D), dtype=np.float32)
    scales = rng.uniform(1.0, 1.6, cs.N_BLOBS).astype(np.float32)
    x = torch.from_numpy(cs.clustered(rng, cs.N, centers, scales)).cuda()
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


def main(dirs) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
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
        outs = {d: [t.clone() for t in runs[d]()] for d in dirs}
        for d in dirs:
            same = all(torch.equal(a, c) for a, c in zip(outs[d],
                                                         outs[dirs[0]]))
            print(f"{what} {d}: outputs equal to {dirs[0]}'s: {same}")
        del outs
        times = {d: [] for d in dirs}
        for order in (dirs, dirs[::-1], dirs, dirs[::-1]):
            for d in order:
                times[d].append(median_ms(runs[d], 3))
        for d in dirs:
            print(f"{what} {d}: ms " + " / ".join(f"{t:.3f}"
                                                  for t in times[d]))
        del runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
