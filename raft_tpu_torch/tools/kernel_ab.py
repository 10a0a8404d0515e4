"""Time builds of K5 and K6 from several source trees against each other
in one process, on ``chip_smoke.py``'s CAGRA data (1M x 128 rows, 10,000
queries, the degree-64 int8 edge store, the seeded itopk-64 buffer).

    python -m raft_tpu_torch.tools.kernel_ab DIR [DIR ...]

Each DIR holds a copy of ``raft_tpu_torch/csrc`` (this tree's, another
commit's from ``git archive``, or a copy with one edit). Every version's
``graph_expand.cu`` and ``cagra_fused.cu`` is built with ``_cuda``'s flags
into DIR (one nvcc each, all started together), loaded by ctypes and
called on the same tensors: K6 on the path's buffer (the whole
traversal), K5 with each query's first seed row as its parent. The entry
points must have this tree's C signatures. Prints the card's name and
power limit, each instance's registers and spills from ptxas, whether
every version's outputs equal the first's, and each version's median
event time in four rounds (versions in order, reversed, in order,
reversed). Run from the root of the repository, on one card.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import _cuda

_KERNELS = {"k6": ("cagra_fused", "raft_cagra_fused"),
            "k5": ("graph_expand", "raft_graph_expand")}


def build(dirs, kernels=_KERNELS):
    """Each DIR's ``kernels`` ({key: (source, entry)}) built at once →
    ({dir: {key: library, its entries' C signatures set}}, the ptxas
    register and spill lines of each kernel template instance)."""
    procs = {}
    for d in dirs:
        for key, (src, _) in kernels.items():
            cmd = [_cuda._nvcc(), *_cuda._FLAGS, "-Xptxas", "-v", "-o",
                   str(Path(d) / f"{key}.so"), str(Path(d) / f"{src}.cu")]
            procs[d, key] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True)
    libs, notes = {}, []
    for (d, key), proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {d}:\n{text}")
        lines = text.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"_kernelI(.*?)EEv", line)
            if m and "Compiling" in line:
                tail = " ".join(x.split(":")[-1].strip()
                                for x in lines[i + 1:i + 4]
                                if "registers" in x or "spill" in x)
                notes.append(f"{d} {key} <{m.group(1)}>: {tail}")
        lib = ctypes.CDLL(str(Path(d) / f"{key}.so"))
        for fn, (argtypes, restype) in _cuda._SIGNATURES[
                kernels[key][0]].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs.setdefault(d, {})[key] = lib
    return libs, notes


def path_data():
    """chip_smoke.py's data, CAGRA index, edge store and seeded buffer."""
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from ..neighbors import cagra

    rng = np.random.default_rng(cs.SEED)
    centers = rng.standard_normal((cs.N_BLOBS, cs.D), dtype=np.float32)
    scales = rng.uniform(1.0, 1.6, cs.N_BLOBS).astype(np.float32)
    x = torch.from_numpy(cs.clustered(rng, cs.N, centers, scales)).cuda()
    q = torch.from_numpy(cs.clustered(rng, cs.M, centers, scales)).cuda()
    params = cagra.IndexParams(intermediate_graph_degree=cs.CAGRA_D0,
                               graph_degree=cs.CAGRA_DEG,
                               knn_graph_algo="brute", seed=cs.SEED)
    cidx = cagra.build(x, params)
    cagra.prepare_traversal(cidx)
    buf_d, buf_i = cs.seeded_buffer(cidx, q)
    itopk, width, max_iter = cagra._plan_dims(cs.CAGRA_SP, cs.K)
    return dict(q=q.float().contiguous(), st=cidx.edge_store,
                bd=buf_d.contiguous(), bi=buf_i.int().contiguous(),
                itopk=itopk, width=width, max_iter=max_iter,
                kp=min(cidx.graph_degree, itopk))


def calls(p):
    """Per kernel, a function (entry) → its outputs, on the path's data."""
    st, q, m = p["st"], p["q"], p["q"].shape[0]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    counter = torch.empty(1, dtype=torch.int32, device="cuda")
    pids = p["bi"][:, :1].clamp_min(0).contiguous()

    def k6(fn):
        od, oi = torch.empty_like(p["bd"]), torch.empty_like(p["bi"])
        h = torch.zeros(m, dtype=torch.int32, device="cuda")
        pa = torch.zeros_like(h)
        _cuda.check(fn(q.data_ptr(), p["bd"].data_ptr(), p["bi"].data_ptr(),
                       st.vecs.data_ptr(), st.aux.data_ptr(),
                       st.gp.data_ptr(), None, m, st.vecs.shape[0],
                       p["itopk"], p["width"], p["max_iter"], p["kp"],
                       st.deg_p, st.dim_p, st.degree, 0, 0,
                       counter.data_ptr(), od.data_ptr(), oi.data_ptr(),
                       h.data_ptr(), pa.data_ptr(), stream()), "k6")
        return od, oi, h, pa

    def k5(fn):
        ov = torch.empty((m, 1, p["kp"]), dtype=torch.float32, device="cuda")
        oi = torch.empty((m, 1, p["kp"]), dtype=torch.int32, device="cuda")
        _cuda.check(fn(pids.data_ptr(), q.data_ptr(), st.vecs.data_ptr(),
                       st.aux.data_ptr(), None, m, 1, st.deg_p, st.dim_p,
                       st.degree, p["kp"], 0, 0, ov.data_ptr(), oi.data_ptr(),
                       stream()), "k5")
        return ov, oi

    return {"k6": k6, "k5": k5}


def median_ms(fn, reps):
    for _ in range(2):
        fn()
    e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
    ts = []
    for _ in range(reps):
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return float(np.median(ts))


def main(dirs) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    libs, notes = build(dirs)
    print("\n".join(notes))
    run = calls(path_data())
    entries = {d: {key: getattr(libs[d][key], entry) for key, (_, entry)
                   in _KERNELS.items()} for d in dirs}
    for key, reps in (("k6", 10), ("k5", 50)):
        outs = {d: run[key](entries[d][key]) for d in dirs}
        torch.cuda.synchronize()
        for d in dirs:
            same = all(torch.equal(a, b) for a, b in zip(outs[d],
                                                         outs[dirs[0]]))
            print(f"{key} {d}: outputs equal to {dirs[0]}'s: {same}")
        times = {d: [] for d in dirs}
        for order in (dirs, dirs[::-1], dirs, dirs[::-1]):
            for d in order:
                fn = entries[d][key]
                times[d].append(median_ms(lambda: run[key](fn), reps))
        for d in dirs:
            print(f"{key} {d}: ms " + " / ".join(f"{t:.4f}"
                                                 for t in times[d]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
