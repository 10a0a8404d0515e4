"""Time builds of K5 and K6 from several source trees against each other
in one process, on ``chip_smoke.py``'s CAGRA data (1M x 128 rows, 10,000
queries, the degree-64 edge stores, the seeded itopk-64 buffer).

    python -m raft_tpu_torch.tools.kernel_ab [--kernels K,...] DIR [DIR ...]

Each DIR holds a copy of ``raft_tpu_torch/csrc`` (this tree's, another
commit's from ``git archive``, or a copy with one edit). Every version's
library of each kernel form asked for (``--kernels``, default all: k6 and
k5 over the int8 store, ``graph_expand.cu`` and ``cagra_fused.cu``;
k5_int4, k5_pq and k6_int4 over the int4 and pq stores,
``graph_expand_{int4,pq}.cu`` and ``cagra_fused_int4.cu``; edge, the
int8 store's whole edge-engine search with the version's
``graph_expand.cu`` as K5) is built with
``_cuda``'s flags into DIR (one nvcc each, all started together), loaded
by ctypes and called on the same tensors: K6 on the path's buffer (the
whole traversal), K5 on the parents that the path's hop 32 hands it
(``chip_smoke.walk`` over the int8 store; every store's K5 takes the
same), the pq store with its int8 LUT. The entry points must have this
tree's C signatures. Prints the card's name and power limit, each
instance's registers and spills from ptxas, whether every version's
outputs equal the first's bit for bit, and each version's median time in
four rounds (versions in order, reversed, in order, reversed; the card's
time of a call, L2 cold and the host's work hidden: ``median_ms``) and
the median of the four. The edge search (``cagra.search(...,
engine="edge")`` at ``chip_smoke.py``'s search parameters, the
version's library put in ``_cuda``'s place for K5's int8 store) is
timed instead on the host's clock, synchronised, a search at a time:
it is host-bound, and its K5 launches are a small part of it. Run from
the root of the repository, on one card.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import _cuda

# kernel form: (library source, entry, store, repetitions a timing)
_KERNELS = {"k6": ("cagra_fused", "raft_cagra_fused", "int8", 10),
            "k5": ("graph_expand", "raft_graph_expand", "int8", 50),
            "k5_int4": ("graph_expand_int4", "raft_graph_expand", "int4", 50),
            "k5_pq": ("graph_expand_pq", "raft_graph_expand_pq", "pq", 50),
            "k6_int4": ("cagra_fused_int4", "raft_cagra_fused", "int4", 10),
            "edge": ("graph_expand", None, "int8", 20)}


def build(dirs, kernels=_KERNELS):
    """Each DIR's ``kernels`` ({key: (source, entry, ...)}) built at once →
    ({dir: {key: library, its entries' C signatures set}}, the ptxas
    register and spill lines of each kernel template instance)."""
    procs = {}
    for d in dirs:
        for key, (src, *_) in kernels.items():
            cmd = [_cuda._nvcc(), *_cuda._FLAGS, "-Xptxas", "-v", "-o",
                   str(Path(d) / f"{key}.so"), str(Path(d) / f"{src}.cu")]
            procs[d, key] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True)
    libs, notes = {}, []
    for (d, key), proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {d} ({key}):\n{text}")
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


def path_data(stores=("int8",)):
    """chip_smoke.py's data, CAGRA index, its edge ``stores`` (int8 the
    index's own), the seeded buffer and the parents of hop 32."""
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
    parents, _, _ = cs.walk(cidx, q, buf_d, buf_i)
    st = {"int8": cidx.edge_store}
    for store in stores:
        if store != "int8":
            cagra.prepare_traversal(cidx, store)
            st[store] = cidx.edge_store
    itopk, width, max_iter = cagra._plan_dims(cs.CAGRA_SP, cs.K)
    return dict(q=q.float().contiguous(), st=st, parents=parents, cidx=cidx,
                sp=cs.CAGRA_SP, k=cs.K,
                bd=buf_d.contiguous(), bi=buf_i.int().contiguous(),
                itopk=itopk, width=width, max_iter=max_iter,
                kp=min(cidx.graph_degree, itopk))


def calls(p):
    """Per kernel form, a function (entry) → its outputs, on the path's
    data."""
    q, m = p["q"], p["q"].shape[0]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    counter = torch.empty(1, dtype=torch.int32, device="cuda")
    pids = p["parents"][:, :1].contiguous()

    def k6(fn, st):
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

    def k5(fn, st):
        ov = torch.empty((m, 1, p["kp"]), dtype=torch.float32, device="cuda")
        oi = torch.empty((m, 1, p["kp"]), dtype=torch.int32, device="cuda")
        if st.kernel_mode == "pq":
            pq_dim, book, _ = st.cb.shape
            status = fn(pids.data_ptr(), q.data_ptr(), st.vecs.data_ptr(),
                        st.aux.data_ptr(), None, st.cb.data_ptr(),
                        st.cb_scale.data_ptr(), m, 1, st.deg_p, st.dim_p,
                        pq_dim, book, st.degree, p["kp"], 0, 1,
                        ov.data_ptr(), oi.data_ptr(), stream())
        else:
            status = fn(pids.data_ptr(), q.data_ptr(), st.vecs.data_ptr(),
                        st.aux.data_ptr(), None, m, 1, st.deg_p, st.dim_p,
                        st.degree, p["kp"], 0, 0, ov.data_ptr(),
                        oi.data_ptr(), stream())
        _cuda.check(status, "k5")
        return ov, oi

    def edge(lib, st):
        from ..neighbors import cagra

        _cuda._libs["graph_expand"] = lib
        p["cidx"].edge_store = st
        return cagra.search(p["cidx"], q, p["k"], p["sp"], engine="edge")

    form = {"k6": k6, "k5": k5, "edge": edge}
    return {key: (lambda fn, f=form[key.split("_")[0]],
                  st=p["st"][store]: f(fn, st))
            for key, (_, _, store, _) in _KERNELS.items()
            if store in p["st"]}


def median_ms(fn, reps):
    """The card's median time of one call of ``fn`` in ms, L2 cold: each
    call queued behind a 256 MB write that flushes the L2 cache, all of
    them behind a lead of such writes, so that the card never waits on the
    host's work around a launch (it takes longer than the host's). Warns
    when the card had caught up with the host when the host was done.
    """
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(16):
        flush.zero_()
    evs = []
    for _ in range(reps):
        flush.zero_()
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        fn()
        e1.record()
        evs.append((e0, e1))
    if evs[-1][1].query():  # the card was done before the host was
        print("median_ms: the card caught up with the host's queue; the "
              "times may hold host work")
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in evs]))


def wall_ms(fn, reps):
    """The median of ``reps`` calls of ``fn`` on the host's clock in ms,
    each call synchronised before and after."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main(argv) -> int:
    keys = list(_KERNELS)
    if argv[:1] == ["--kernels"]:
        keys, argv = argv[1].split(","), argv[2:]
    dirs = argv
    kernels = {key: _KERNELS[key] for key in keys}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    libs, notes = build(dirs, kernels)
    print("\n".join(notes))
    run = calls(path_data(tuple({v[2] for v in kernels.values()})))
    # the edge search takes the library; the kernels their entry
    entries = {d: {key: getattr(libs[d][key], v[1]) if v[1] else
                   libs[d][key] for key, v in kernels.items()}
               for d in dirs}
    for key, (_, _, _, reps) in kernels.items():
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
                timed = wall_ms if key == "edge" else median_ms
                times[d].append(timed(lambda: run[key](fn), reps))
        for d in dirs:
            print(f"{key} {d}: ms " + " / ".join(f"{t:.4f}"
                                                 for t in times[d])
                  + f"; median {float(np.median(times[d])):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
