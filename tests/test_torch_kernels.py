"""The port's CUDA kernels against their plain PyTorch versions, and the
comparison contract the port's parity tests share.

This file imports neither JAX nor ``raft_tpu``, so it runs on a machine
with a card and no JAX. The card tests are marked ``cuda`` and skip
without one; on the card::

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest imports JAX.)

Tolerances. Integer-valued inputs: every product and sum is exact in
float32, so values and ids, and their order, must be equal. Gaussian
inputs: the kernels, torch and XLA sum the dot products in different
orders, so distances agree to ``rtol=1e-5, atol=1e-5·max|d|`` and ids are
equal on at least 99% of rows (:func:`assert_knn_close`); K2, which sums
as 3xTF32 on the tensor cores, is held there against its plain version
and also against a float64 evaluation of the same formulas
(:func:`exact_knn`). K3 and K4 run in both forms (grouped and
per-pair); K4 reads a codebook of small integers in its integer cases,
so its sums stay exact in every LUT mode and either order (LUT entries
subspace by subspace, or a dot over the decoded row). Over 129 and more
slots a row, near ties split the ids of more than 1% of the rows between
any two float orders, so the K2–K4 tests hold Gaussian inputs at k <= 64
(K2: <= 100) slot by slot, K3 and K4 also at k = 257 and 512 with values
slot by slot and ids as sets (at least 99.9% shared), and integer inputs
at every k. K5 and K6 and their plain
versions add in the same order (``graph_expand.lane_order_dot``), so they
are equal on any input: on an edge store of small integers with integer
scales (``edge_store``), where every score is an exact integer and ties
abound, and on Gaussian queries with real scales; so are K5's int4 and pq
forms and K6's int4 form (``packed_store``: the same rows as nibbles, or
pq codes over an integer or real codebook). K7 and K8 move values
and compute none, so they equal their plain versions (and
``knn_merge_parts``) on any input.
"""
import functools

import numpy as np
import pytest
import torch

from raft_tpu_torch.comms import Mesh
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.matrix import select_k as tsk
from raft_tpu_torch.neighbors import brute_force
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.neighbors import ivf_pq as tivfpq
from raft_tpu_torch.ops import autotune
from raft_tpu_torch.ops import cagra_fused as tcf
from raft_tpu_torch.ops import fused_knn as tfk
from raft_tpu_torch.ops import graph_expand as tge
from raft_tpu_torch.ops import ivf_pq_scan as tpq
from raft_tpu_torch.ops import ivf_scan as tis
from raft_tpu_torch.ops import quant as tq
from raft_tpu_torch.ops import ring_topk as trt
from raft_tpu_torch.stats.metrics import neighborhood_recall

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _verdicts_in_memory():
    """No autotune verdict file: the CAGRA builds and races of this module
    keep their verdicts in memory, and read none from the user's cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TPU_TORCH_AUTOTUNE_CACHE", "")
        mp.setattr(autotune, "_MEM_CACHE", {})
        mp.setattr(autotune, "_LOADED_FROM", None)
        yield


def test_verdicts_stay_in_memory():
    assert autotune.cache_path() is None


def assert_knn_close(ref_v, ref_i, v, i, rtol=1e-5, min_rows_equal=0.99):
    """The Gaussian-input contract of the module docstring: distances to
    ``rtol`` and ``atol = rtol·max|d|``, ids equal on at least
    ``min_rows_equal`` of the rows. Values are compared slot by slot, so
    where the two ids at a slot differ, the two candidates' distances
    differ by less than the tolerance (a near tie)."""
    ref_v = np.asarray(ref_v, np.float64)
    v = np.asarray(v, np.float64)
    ref_i, i = np.asarray(ref_i), np.asarray(i)
    assert v.shape == ref_v.shape and i.shape == ref_i.shape
    finite = np.isfinite(ref_v)
    np.testing.assert_array_equal(np.isfinite(v), finite)
    np.testing.assert_array_equal(v[~finite], ref_v[~finite])
    np.testing.assert_array_equal(i[~finite], ref_i[~finite])
    atol = rtol * (np.abs(ref_v[finite]).max() if finite.any() else 1.0)
    np.testing.assert_allclose(v[finite], ref_v[finite], rtol=rtol,
                               atol=atol)
    rows_equal = (i == ref_i).all(axis=1)
    assert rows_equal.mean() >= min_rows_equal, (
        f"ids differ on {int((~rows_equal).sum())} of {len(rows_equal)} "
        "rows")


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")


def _ivf_store(integer: bool, seed: int, n=6000, d=40, lists=24, m=150,
               p=6):
    """Cluster-sorted rows with list starts aligned to 8, slack between
    lists, one empty list; queries, probed lists and a penalty row."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, lists, n)
    labels[labels == 3] = 4
    sizes = np.bincount(labels, minlength=lists)
    caps = (sizes + 8 + 7) // 8 * 8
    offsets = np.concatenate([[0], np.cumsum(caps)[:-1]])
    rows = int(caps.sum())
    gen = ((lambda s: rng.integers(-3, 4, s)) if integer
           else rng.standard_normal)
    data = gen((rows, d)).astype(np.float32)
    q = gen((m, d)).astype(np.float32)
    norms = (data.astype(np.float64) ** 2).sum(1).astype(np.float32)
    probed = np.stack([rng.permutation(lists)[:p] for _ in range(m)])
    pen = np.where(rng.random(rows) < 0.25, np.inf, 0.0).astype(np.float32)
    return [torch.from_numpy(a) for a in
            (data, norms, probed.astype(np.int32), offsets.astype(np.int32),
             sizes.astype(np.int32), q, pen)]


STORE_NAMES = ("bfloat16", "int8", "uint8", "int4")


def store_case(store: str, integer: bool, n: int, d: int, m: int,
               seed: int):
    """A corpus in a low-precision store and its queries, made with numpy.
    ``integer``: rows the store holds exactly at a scale of 1 (bf16:
    integers in [-8, 8]; int8 in [-127, 127] and int4 in [-7, 7], each
    row reaching the bound in its first column; uint8: bytes) and integer
    queries (in [-3, 3]; bytes for uint8), so every product, dot and
    distance is exact in float32. Otherwise Gaussian rows (uint8: bytes)
    and real-valued queries. → (stored rows, scales | None, int4_dim |
    None, queries), CPU tensors, coded by ``ops.quant.quantize_rows``."""
    rng = np.random.default_rng(seed)
    if store == "uint8":
        x = rng.integers(0, 256, (n, d)).astype(np.float32)
        q = (rng.integers(0, 256, (m, d)) if integer
             else rng.uniform(0, 255, (m, d))).astype(np.float32)
    elif integer:
        lim = {"bfloat16": 8, "int8": 127, "int4": 7}[store]
        x = rng.integers(-lim, lim + 1, (n, d)).astype(np.float32)
        if store != "bfloat16":
            x[:, 0] = np.where(rng.random(n) < 0.5, -lim, lim)
        q = rng.integers(-3, 4, (m, d)).astype(np.float32)
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((m, d)).astype(np.float32)
    stored, scales = tq.quantize_rows(torch.from_numpy(x), store)
    if integer and scales is not None:
        assert bool((scales == 1.0).all())
    return (stored, scales, d if store == "int4" else None,
            torch.from_numpy(q))


def pq_store(integer: bool, seed: int, pq_bits: int = 8, n=4000, pq_dim=8,
             pq_len=4, lists=16, m=64, p=4):
    """A cluster-sorted PQ store: uint8 codes with list starts aligned to
    8, slack between lists, list 3 empty; a (pq_dim, 2^pq_bits, pq_len)
    codebook, rotated centers and queries (small integers or Gaussian),
    probed lists, a penalty row, and the decoded row norms. Returns a
    dict of CPU tensors plus ``list_offsets`` (lists + 1,) numpy."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, lists, n)
    labels[labels == 3] = 4
    sizes = np.bincount(labels, minlength=lists)
    caps = (sizes + 8 + 7) // 8 * 8
    offsets = np.concatenate([[0], np.cumsum(caps)])
    rows = int(offsets[-1])
    rot_dim = pq_dim * pq_len
    gen = ((lambda s: rng.integers(-3, 4, s)) if integer
           else rng.standard_normal)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    store = {
        "codes": t(rng.integers(0, 1 << pq_bits, (rows, pq_dim)).astype(
            np.uint8)),
        "codebooks": t(gen((pq_dim, 1 << pq_bits, pq_len)).astype(
            np.float32)),
        "centers_rot": t(gen((lists, rot_dim)).astype(np.float32)),
        "q_rot": t(gen((m, rot_dim)).astype(np.float32)),
        "probed": t(np.stack([rng.permutation(lists)[:p]
                              for _ in range(m)]).astype(np.int32)),
        "offsets": t(offsets[:-1].astype(np.int32)),
        "sizes": t(sizes.astype(np.int32)),
        "penalty": t(np.where(rng.random(rows) < 0.25, np.inf, 0.0).astype(
            np.float32)),
        "list_offsets": offsets,
    }
    store["row_norms"] = tpq.decoded_row_norms(
        store["codes"], store["centers_rot"], store["codebooks"], offsets)
    return store


def pq_scan_args(store, mode: str, device="cpu"):
    """The positional arguments of ``ivf_pq_scan`` up to ``q_rot``."""
    names = ("codes", "row_norms", "centers_rot", "codebooks", "probed",
             "offsets", "sizes", "q_rot")
    args = [store[n].to(device) for n in names]
    args[3] = tpq.lut_codebook(args[3], mode)
    return args


def edge_store(dtype, seed: int, integer: bool = True, n=3000, degree=40,
               deg_p=64, dim=100, m=96, itopk=32, closed=False):
    """An edge store (CPU tensors): (n, deg_p, dim_p) rows of small
    integers (int8 or bf16), per-edge scales and the matching norms in
    ``aux``, padded graph rows, queries, an edge penalty (+inf on a
    quarter of the edges), parents, and a sorted seeded buffer (distinct
    ids, +inf tail). ``integer``: scales of 1 or 2 and integer queries,
    so every score is an exact integer; else Gaussian queries and
    uniform scales. ``closed``: nodes 0-3 link only to each other, and
    every 7th query's buffer holds just them, so its frontier closes
    within a few hops."""
    rng = np.random.default_rng(seed)
    dim_p = (dim + 127) // 128 * 128
    rows = np.zeros((n, deg_p, dim_p), np.float32)
    rows[:, :, :dim] = rng.integers(-3, 4, (n, deg_p, dim))
    if integer:
        scales = rng.integers(1, 3, (n, deg_p)).astype(np.float32)
        q = rng.integers(-3, 4, (m, dim)).astype(np.float32)
    else:
        scales = rng.uniform(0.2, 0.6, (n, deg_p)).astype(np.float32)
        q = rng.standard_normal((m, dim)).astype(np.float32)
    aux = np.stack([scales, scales ** 2 * (rows ** 2).sum(-1)], axis=1)
    gph = rng.integers(0, n, (n, deg_p)).astype(np.int32)
    pen = np.where(rng.random((n, deg_p)) < 0.25, np.inf, 0.0).astype(
        np.float32)
    if integer:
        buf_d = rng.integers(200, 900, (m, itopk)).astype(np.float32)
    else:   # around the candidates' scores: ||q||² + ~64 +- 25
        buf_d = ((q ** 2).sum(1)[:, None] + 64
                 + rng.uniform(-25, 25, (m, itopk))).astype(np.float32)
    buf_d = np.sort(buf_d, axis=1)
    buf_d[:, itopk - 3:] = np.inf
    buf_i = np.stack([rng.permutation(n)[:itopk] for _ in range(m)]).astype(
        np.int32)
    if closed:
        gph[:4] = rng.integers(0, 4, (4, deg_p))
        buf_i[::7, :4] = np.arange(4)
        buf_i[::7, 4:] = -1
        buf_d[::7, 4:] = np.inf
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return {"vecs": t(rows).to(dtype), "aux": t(aux), "gph": t(gph),
            "q": t(q), "pen": t(pen), "degree": degree,
            "parents": t(rng.integers(0, n, (m, 2)).astype(np.int32)),
            "buf_d": t(buf_d), "buf_i": t(buf_i)}


def pack_int4(rows: np.ndarray) -> np.ndarray:
    """(..., dim_p) integers in [-8, 7] → (..., dim_p / 2) int8 bytes in
    the split-half layout: byte j holds value j low, j + dim_p / 2 high."""
    half = rows.shape[-1] // 2
    v = rows.astype(np.int32)
    b = (v[..., :half] & 0xF) | ((v[..., half:] & 0xF) << 4)
    return b.astype(np.uint8).view(np.int8)


def packed_store(mode: str, seed: int, integer: bool = True, lut="int8",
                 pq_dim: int = 16, book: int = 256, **shape):
    """``edge_store``'s store in a packed mode (CPU tensors). int4: its
    rows as nibbles (they lie in [-3, 3]). pq: uint8 codes of pq_dim
    subspaces over a codebook (pq_dim, book, pq_len) — int8 with scales
    1 (``integer``) or real scales, or float32 integers or Gaussian
    values — and the decoded rows' norms in aux (scales kept)."""
    es = edge_store(torch.int8, seed, integer, **shape)
    rows = es["vecs"].to(torch.float32).numpy()
    if mode == "int4":
        es["vecs"] = torch.from_numpy(pack_int4(rows))
        es["cb"] = es["cb_scale"] = None
        return es
    rng = np.random.default_rng(seed + 1000)
    n, deg_p, dim_p = rows.shape
    pq_len = dim_p // pq_dim
    codes = rng.integers(0, book, (n, deg_p, pq_dim)).astype(np.uint8)
    if lut == "int8":
        cb = rng.integers(-127, 128, (pq_dim, book, pq_len)).astype(np.int8)
        scale = (np.ones(pq_dim, np.float32) if integer
                 else rng.uniform(0.002, 0.03, pq_dim).astype(np.float32))
        cb_t, sc_t = torch.from_numpy(cb), torch.from_numpy(scale)
    else:
        cb = (rng.integers(-4, 5, (pq_dim, book, pq_len)) if integer
              else rng.standard_normal((pq_dim, book, pq_len)) * 0.3)
        cb_t, sc_t = torch.from_numpy(cb.astype(np.float32)), None
    vecs = torch.from_numpy(codes)
    dec = tge.widen_tile(vecs, "pq", cb_t, sc_t)
    scales = es["aux"][:, 0]
    es["aux"] = torch.stack([scales, scales ** 2 * dec.square().sum(-1)],
                            dim=1).contiguous()
    es.update(vecs=vecs, cb=cb_t, cb_scale=sc_t)
    return es


def test_kernel_entries_refuse_cpu_tensors():
    """The kernel-only entries launch or raise; they never run a plain
    version."""
    x = torch.zeros((8, 4))
    with pytest.raises(RaftError):
        tfk.fused_knn_candidates(x, None, x, None, None, 2, "ip")
    data, norms, probed, offsets, sizes, q, _ = _ivf_store(False, 0)
    with pytest.raises(RaftError):
        tis.ivf_flat_scan_candidates(data, norms, None, q, None, probed,
                                     offsets, sizes, 3, "l2")
    st = pq_store(False, 0)
    with pytest.raises(RaftError):
        tpq.ivf_pq_scan_candidates(
            st["codes"], st["row_norms"], None, st["codebooks"],
            st["centers_rot"], st["q_rot"], st["probed"], st["offsets"],
            st["sizes"], 3, "l2")
    es = edge_store(torch.int8, 0, n=50, m=4)
    with pytest.raises(RaftError):
        tge.graph_expand_kernel(es["parents"], es["q"], es["vecs"],
                                es["aux"], 4)
    with pytest.raises(RaftError):
        tcf.fused_traverse_kernel(es["q"], es["buf_d"], es["buf_i"],
                                  es["vecs"], es["aux"], es["gph"],
                                  itopk=32, width=1, max_iter=2, kprime=8,
                                  degree=40)
    for mode in ("int4", "pq"):
        es = packed_store(mode, 0, n=50, m=4)
        with pytest.raises(RaftError):
            tge.graph_expand_kernel(es["parents"], es["q"], es["vecs"],
                                    es["aux"], 4, mode=mode, cb=es["cb"],
                                    cb_scale=es["cb_scale"])
    es = packed_store("int4", 0, n=50, m=4)
    with pytest.raises(RaftError):
        tcf.fused_traverse_kernel(es["q"], es["buf_d"], es["buf_i"],
                                  es["vecs"], es["aux"], es["gph"],
                                  itopk=32, width=1, max_iter=2, kprime=8,
                                  degree=40, mode="int4")
    ds, gs = ring_parts(4, 6, 5, 0)
    with pytest.raises(RaftError):
        trt.ring_topk_kernel(ds, gs, 5, True, Mesh(["cpu"] * 4))


def ring_parts(p, m, k, seed, select_min=True, integer=True,
               device="cpu"):
    """p shards' (m, k) candidate lists: rows sorted except shard 0's,
    shard 1 an exact copy of shard 0's values (cross-shard ties), shard 2
    dead — (±inf, -1) — when p > 2; integer values with ties inside rows,
    or Gaussian ones."""
    rng = np.random.default_rng(seed)
    d = (rng.integers(0, 20, (p, m, k)) if integer
         else rng.standard_normal((p, m, k))).astype(np.float32)
    d[1:] = np.sort(d[1:], axis=-1)
    d[1] = d[0]
    gid = rng.integers(0, 1 << 20, (p, m, k)).astype(np.int32)
    if p > 2:
        d[2], gid[2] = np.inf, -1
    if not select_min:
        d = -d
    return ([torch.from_numpy(d[r]).to(device) for r in range(p)],
            [torch.from_numpy(gid[r]).to(device) for r in range(p)])


@pytest.mark.parametrize("integer", [True, False])
def test_plain_versions_agree_on_cpu(integer):
    """The CPU paths the kernels are held against: the IVF scan's plain
    version over every list equals brute force over the same rows."""
    data, norms, probed, offsets, sizes, q, pen = _ivf_store(integer, 1)
    lists = offsets.shape[0]
    every = torch.arange(lists, dtype=torch.int32).expand(q.shape[0], -1)
    sv, si = tis.ivf_flat_scan(data, norms, every.contiguous(), offsets,
                               sizes, q, 7, "l2", pen)
    pen = pen.clone()
    valid = torch.zeros(data.shape[0], dtype=torch.bool)
    for o, s in zip(offsets.tolist(), sizes.tolist()):
        valid[o:o + s] = True
    pen[~valid] = float("inf")
    bv, bi = tfk.fused_knn(q, data, 7, "l2", norms, pen)
    if integer:
        assert torch.equal(sv, bv) and torch.equal(si, bi)
    else:
        assert_knn_close(bv, bi, sv, si)


SELECT_KS = (1, 20, 32, 33, 64, 100, 129, 256, 257, 300, 384, 511, 512,
             600)


def select_rows(n, select_min, seed, rows=300):
    """Integer rows with heavy ties and ±inf cells, row 5 all ±inf; then
    (from another generator) -0.0 against 0.0, and rows 6-9 with only 1,
    19, 40 and 0 finite cells (fewer than most k)."""
    rng = np.random.default_rng(seed)
    bad = np.inf if select_min else -np.inf
    x = rng.integers(0, 50, (rows, n)).astype(np.float32)
    x[rng.random((rows, n)) < 0.05] = bad
    x[5] = bad
    more = np.random.default_rng(seed + 1)
    x[x == 0] = np.where(more.random(int((x == 0).sum())) < 0.5, 0.0, -0.0)
    for r, fin in zip(range(6, 10), (1, 19, 40, 0)):
        x[r, fin:] = bad
        x[r] = x[r, more.permutation(n)]
    return torch.from_numpy(x).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20, 140, 200, 1024, 1806, 20000, 60000])
@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_kernel_on_card(n, select_min):
    """K1, each form, against its plain version: the warp select for
    k <= 512 (past 256 a 512-key queue with 128-key buffers; rows read
    16 bytes a lane where n % 4 == 0, else 4) and the radix select for
    every k, rows staged in shared memory where they fit (n = 20000 at
    k = 600 too) and (n = 60000) read from device memory, heavy ties,
    -0.0 against 0.0, rows of ±inf and rows with fewer finite values
    than k. Each call counts one launch of its form, and the default
    takes the form the rule gives."""
    need_cuda()
    xc = select_rows(n, select_min, n)
    for k in (k for k in SELECT_KS if k <= n):
        pv, pi = tsk.select_k_plain(xc, k, select_min)
        forms = ("warp", "radix") if k <= tsk.WARP_MAX_K else ("radix",)
        for form in forms + (None,):
            counts = (tsk.warp_launches, tsk.radix_launches)
            kv, ki = tsk.kpass_select_k(xc, k, select_min, form=form)
            torch.cuda.synchronize()
            assert torch.equal(kv, pv) and torch.equal(ki, pi), (k, form)
            used = form or tsk.select_form(k)
            assert (tsk.warp_launches - counts[0],
                    tsk.radix_launches - counts[1]) == (
                        (1, 0) if used == "warp" else (0, 1))


def nan_rows(n, seed, rows=200):
    """Rows of small integers with NaN, -NaN, ±inf, -0.0 and 0.0 cells
    and ties; rows 0-3 with 0, 1, 7 and 19 cells that are not NaN (fewer
    than most k), row 4 all NaN."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (rows, n)).astype(np.float32)
    for v, share in ((np.nan, 0.15), (-np.float32(np.nan), 0.03),
                     (np.inf, 0.05), (-np.inf, 0.05), (-0.0, 0.1)):
        x[rng.random((rows, n)) < share] = v
    for r, keep in zip(range(5), (0, 1, 7, 19, 0)):
        x[r, keep:] = np.nan
        x[r] = x[r, rng.permutation(n)]
    return torch.from_numpy(x).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [40, 300, 20000])
def test_select_k_kernel_nan_order(n):
    """K1, both forms and both directions, equal to its plain version bit
    for bit on rows with NaN, -NaN, ±inf and -0.0 against 0.0, at k under
    and over each row's count of cells that are not NaN: NaN after +inf in
    a min selection, first in a max selection, returned with its column
    (the JAX package's select_k order)."""
    need_cuda()
    x = nan_rows(n, n)
    for k in (k for k in (1, 5, 20, 33, 256, 257, 300, 384, 511, 512)
              if k <= n):
        forms = ("warp", "radix") if k <= tsk.WARP_MAX_K else ("radix",)
        for sel in (True, False):
            pv, pi = tsk.select_k_plain(x, k, sel)
            for form in forms:
                kv, ki = tsk.kpass_select_k(x, k, sel, form=form)
                torch.cuda.synchronize()
                assert_bits_equal(kv, pv)
                assert torch.equal(ki, pi), (k, sel, form)
                assert bool((ki >= 0).all())


def exact_knn(q, x, k, metric, pen):
    """The k nearest rows by the plain version's formulas evaluated in
    float64 (ties to the lower row) → float32 values, int32 ids, -1 on
    +inf slots."""
    q, x, pen = q.double(), x.double(), pen.double()
    dot = q @ x.T
    qn, xn = (q * q).sum(1), (x * x).sum(1)
    if metric == "l2":
        dist = (qn[:, None] + xn[None, :] - 2 * dot).clamp_min(0)
    elif metric == "cos":
        dist = 1 - dot / (qn.sqrt()[:, None] * xn.sqrt()[None, :])
    else:
        dist = -dot
    v, i = torch.sort(dist + pen[None, :], dim=1, stable=True)
    v, i = v[:, :k].float(), i[:, :k].int()
    return v, torch.where(torch.isfinite(v), i, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [48, 100, 37])
@pytest.mark.parametrize("metric", ["l2", "cos", "ip"])
@pytest.mark.parametrize("m", [7, 200])
def test_fused_knn_kernel_on_card(metric, m, d):
    """K2 with the corpus split over blocks (merged by K1 up to LIST_MAX_K
    = 24, by the wide form's own selection past it): equal to its plain
    version on integer-valued inputs (3xTF32 holds them exactly; the
    cosine's quotients close) at k up to 256 across the kernel's query
    tiles (128 queries; k = 100, 129 and 256 the wide form); on Gaussian
    inputs at
    k <= 100 close to both the plain version and the float64 evaluation
    of the same formulas. Gaussian inputs stop at k = 100: with 129 or
    256 slots a row, near ties split the ids of more than 1% of the rows
    between any two of the three summation orders, the plain version's
    against float64 included, so the ids check cannot be met there; the
    integer cases hold k > 100 exactly. m and n = 40,000 not multiples of
    the tiles, d not a multiple of the 32-dimension stage (and d = 37 not
    of the 16-byte copies), a penalty row dropping a fifth of the rows."""
    need_cuda()
    rng = np.random.default_rng(m + d)
    for integer in (True, False):
        gen = ((lambda s: rng.integers(-2, 3, s)) if integer
               else rng.standard_normal)
        q = torch.from_numpy(gen((m, d)).astype(np.float32)).cuda()
        x = torch.from_numpy(gen((40000, d)).astype(np.float32)).cuda()
        pen = torch.from_numpy(np.where(rng.random(40000) < 0.2, np.inf,
                                        0.0).astype(np.float32)).cuda()
        for k in (1, 17, 100, 129, 256) if integer else (1, 17, 100):
            kv, ki = tfk.fused_knn(q, x, k, metric, penalty=pen)
            pv, pi = tfk.fused_knn_plain(q, x, k, metric, penalty=pen)
            torch.cuda.synchronize()
            if integer and metric != "cos":
                assert torch.equal(kv, pv) and torch.equal(ki, pi), k
            else:
                assert_knn_close(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu())
            if not integer:
                ev, ei = exact_knn(q, x, k, metric, pen)
                assert_knn_close(ev.cpu(), ei.cpu(), kv.cpu(), ki.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [48, 100, 128])
@pytest.mark.parametrize("metric", ["l2", "cos", "ip"])
@pytest.mark.parametrize("store", STORE_NAMES)
def test_fused_knn_store_kernel_on_card(store, metric, d):
    """K2's store forms (:func:`store_case`), the corpus split over blocks
    (merged by K1 up to LIST_MAX_K, the wide form past it), against the
    plain version: equal on integer-valued stores (l2, ip) at k up to 256,
    close on Gaussian ones at k <= 100
    (:func:`assert_knn_close`, as K2's f32 test); n = 40,000 and m = 200
    not multiples of the tiles, a penalty row dropping a fifth of the
    rows, d = 100 rows that are no multiple of 16 bytes in any store but
    int4 (the copies element by element), int4 at half_p 64 for every d.
    Each call launches the store's form, counted under its store; uint8
    as :func:`store_rows_equal` says."""
    need_cuda()
    rng = np.random.default_rng(d)
    pen = torch.from_numpy(np.where(rng.random(40000) < 0.2, np.inf,
                                    0.0).astype(np.float32)).cuda()
    for integer in (True, False):
        x, sc, dim4, q = store_case(store, integer, 40000, d, 200, d)
        x, q = x.cuda(), q.cuda()
        sc = None if sc is None else sc.cuda()
        for k in (1, 17, 100, 129, 256) if integer else (1, 17, 100):
            before = getattr(tfk, f"launches_{store}")
            kv, ki = tfk.fused_knn(q, x, k, metric, penalty=pen, scales=sc,
                                   int4_dim=dim4)
            pv, pi = tfk.fused_knn_plain(q, x, k, metric, penalty=pen,
                                         scales=sc, int4_dim=dim4)
            torch.cuda.synchronize()
            assert getattr(tfk, f"launches_{store}") == before + 1
            if integer and metric != "cos":
                assert torch.equal(kv, pv) and torch.equal(ki, pi), k
            else:
                assert_knn_close(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu(),
                                 min_rows_equal=store_rows_equal(store))
            if store == "uint8":
                fv, fi = tfk.fused_knn(q, x.float(), k, metric, penalty=pen)
                torch.cuda.synchronize()
                assert_bits_equal(kv, fv)
                assert torch.equal(ki, fi), k


def store_rows_equal(store: str) -> float:
    """The share of rows whose ids must be equal to the plain version's
    on a store's real-valued case: 0.99 as in K2's f32 test. uint8 is held
    instead bit for bit to the f32 form on its rows widened to f32 (a byte
    is exact in TF32, so the f32 form's products that read the rows' lo
    parts add exact zeros), and to the plain version on values alone: its
    byte rows in the positive orthant against queries in [0, 255] give
    distances so concentrated that near ties are dense (3–8% of the rows
    at k = 17 or 100 in the card runs), each held to the values' window
    slot by slot."""
    return 0.0 if store == "uint8" else 0.99


def test_store_kernels_refuse_what_they_cannot_take():
    """The store forms' contract, checked before any launch: a store's
    dtype, its scales (int8 and int4 need them, float32 takes none), and
    IVF-Flat has no int4 store."""
    x = torch.zeros((8, 32), dtype=torch.int8)
    q = torch.zeros((4, 32))
    with pytest.raises(RaftError, match="scales"):
        tfk.fused_knn_plain(q, x, 2, "l2")
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(RaftError, match="scales"):
        tis.ivf_flat_scan(x, None, torch.zeros((4, 1), dtype=torch.int32),
                          one, one + 8, q, 2, "ip")
    with pytest.raises(RaftError):
        tfk.fused_knn_plain(q, x.to(torch.int16), 2, "l2")
    with pytest.raises(RaftError):
        tivf.build(np.zeros((64, 32), np.float32),
                   tivf.IndexParams(n_lists=4, dtype="int4"), device="cpu")


# the IVF scans' k by form (the grouped forms' plans change at 64, 256
# and reach 512: tis.group_plan); Gaussian inputs take k <= 64 slot by
# slot: over 129 and more slots a row, near ties split the ids of more
# than 1% of the rows between any two float orders (as in K2's test), so
# past the grouped forms' old limit they are held with ids as sets
# (:func:`assert_knn_sets_close`)
WIDE_KS = (257, 300, 384, 512)
SCAN_KS = {"group": (1, 10, 64, 129, 256) + WIDE_KS,
           "pair": (1, 10, 64, 129, 256) + WIDE_KS + (1000,)}
GAUSSIAN_MAX_K = 64
GAUSSIAN_WIDE_KS = (257, 512)


def scan_cases(integer: bool):
    """(form, k) of the IVF scans' card tests."""
    return [(form, k) for form, ks in SCAN_KS.items() for k in ks
            if integer or k <= GAUSSIAN_MAX_K or k in GAUSSIAN_WIDE_KS]


def assert_knn_sets_close(ref_v, ref_i, v, i, rtol=1e-5, min_shared=0.999):
    """Wide k on Gaussian inputs: values slot by slot as in
    :func:`assert_knn_close`, ids as sets — each row's ids shared with the
    reference row on average over at least ``min_shared`` of the slots
    (a near tie at a row's k-th slot may swap one id in or out)."""
    assert_knn_close(ref_v, ref_i, v, i, rtol=rtol, min_rows_equal=0.0)
    assert neighborhood_recall(torch.tensor(np.asarray(i)),
                               torch.tensor(np.asarray(ref_i))) >= \
        min_shared


def skewed_probes(m: int, lists: int, p: int, seed: int) -> torch.Tensor:
    """(m, p) distinct probed lists a query at the grouped forms' group
    boundaries (128 queries a group up to k = 64, 64 above): list 0
    probed by every query, lists 1 and 2 by exactly 128 and 129, lists 4
    and 5 by exactly 64 and 65, list 7 by one query; the rest drawn from
    lists 6 and 8 up (list 3, empty in the stores here, among them)."""
    assert m >= 258 and p >= 4 and lists >= 12
    rng = np.random.default_rng(seed)
    rest = np.array([3, 6] + list(range(8, lists)))
    probed = np.zeros((m, p), np.int64)
    probed[:, 1] = -1
    probed[:128, 1], probed[128:257, 1], probed[257, 1] = 1, 2, 7
    probed[:, 2] = -1
    probed[:64, 2], probed[64:129, 2] = 4, 5
    for qi in range(m):
        free = [c for c in rng.permutation(rest)]
        for j in range(1, p):
            if probed[qi, j] < 0 or j >= 3:
                probed[qi, j] = free.pop()
    counts = np.bincount(probed.reshape(-1), minlength=lists)
    assert counts[0] == m and tuple(counts[[1, 2, 4, 5, 7]]) == (
        128, 129, 64, 65, 1)
    assert all(len(set(r)) == p for r in probed.tolist())
    return torch.from_numpy(probed.astype(np.int32))


def scan_both(kernel, plain, args, k, form, exact: bool,
              min_rows_equal: float = 0.99):
    """One scan kernel form against its plain version: equal (values and
    ids, their order too) when ``exact``, else within
    :func:`assert_knn_close`; a second launch equal bit for bit."""
    kv, ki = kernel(*args, form=form)
    pv, pi = plain(*args)
    kv2, ki2 = kernel(*args, form=form)
    torch.cuda.synchronize()
    assert_bits_equal(kv, kv2)
    assert torch.equal(ki, ki2)
    if exact:
        assert torch.equal(kv, pv) and torch.equal(ki, pi), (form, k)
    elif k > GAUSSIAN_MAX_K:
        assert_knn_sets_close(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu())
    else:
        assert_knn_close(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu(),
                         min_rows_equal=min_rows_equal)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cos", "ip"])
def test_ivf_flat_scan_kernel_on_card(metric):
    """K3 + the K1 merge, both forms, against the plain version with and
    without the penalty row, with an empty list (:func:`scan_cases`: k =
    1, 10, 64, 129, 256, 257, 300, 384 and 512, and 1000 for the per-pair
    form; Gaussian inputs to k = 64 and at 257 and 512): equal on
    integer-valued inputs (l2, ip), close on Gaussian ones; two launches
    bit-equal. On the store's probes and on probes skewed across the group
    boundaries (:func:`skewed_probes`), over lists of ~250 rows, longer
    than one 128-row tile and, past k = 256, shorter than k."""
    need_cuda()
    for integer in (True, False):
        c = [t.cuda() for t in _ivf_store(integer, 3, m=300)]
        skewed = skewed_probes(300, 24, 6, 13).cuda()
        for probed in (c[2], skewed):
            a = c[:2] + [probed] + c[3:6]
            for penalty in (c[6], None):
                for form, k in scan_cases(integer):
                    scan_both(tis.ivf_flat_scan, tis.ivf_flat_scan_plain,
                              (*a, k, metric, penalty), k, form,
                              integer and metric != "cos")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 64])
@pytest.mark.parametrize("metric", ["l2", "cos", "ip"])
@pytest.mark.parametrize("store", ("bfloat16", "int8", "uint8"))
def test_ivf_flat_scan_store_kernel_on_card(store, metric, d):
    """K3's store forms + the K1 merge, both forms, against the plain
    version (:func:`scan_cases`), with and without the penalty row, on
    the store's probes and on probes skewed across the group boundaries:
    equal on integer-valued lists (:func:`store_case`; l2, ip), close on
    Gaussian ones (uint8: :func:`store_rows_equal`); two launches
    bit-equal; each launch counted under the store. Every store form is
    also bit-equal to the f32 form on its lists widened (int8 at unit
    scales): every stored value is exact in TF32, so the f32 form's
    products that read the rows' lo parts add exact zeros. d = 40 rows
    are no multiple of 16 bytes at int8 / uint8 (the copies element by
    element), d = 64 rows are."""
    need_cuda()
    for integer in (True, False):
        c = _ivf_store(integer, 3, d=d, m=300)
        rows = c[0].shape[0]
        data, sc, _, q = store_case(store, integer, rows, d, 300, d + 7)
        deq = tq.dequantize_rows(data, sc)
        norms = (deq * deq).sum(1)
        c = [t.cuda() for t in (data, norms, *c[2:5], q, c[6])]
        sc = None if sc is None else sc.cuda()
        kernel = functools.partial(tis.ivf_flat_scan, scales=sc)
        plain = functools.partial(tis.ivf_flat_scan_plain, scales=sc)
        skewed = skewed_probes(300, 24, 6, 13).cuda()
        for probed in (c[2], skewed):
            a = c[:2] + [probed] + c[3:6]
            for penalty in (c[6], None):
                for form, k in scan_cases(integer):
                    before = getattr(tis, f"launches_{store}")
                    scan_both(kernel, plain, (*a, k, metric, penalty), k,
                              form, integer and metric != "cos",
                              store_rows_equal(store))
                    assert getattr(tis, f"launches_{store}") == before + 2
                    # the f32 form on the rows widened (int8: the kernel
                    # at unit scales, so both read the same values)
                    wide = [c[0].float()] + a[1:]
                    fv, fi = tis.ivf_flat_scan(*wide, k, metric, penalty,
                                               form=form)
                    kv, ki = tis.ivf_flat_scan(
                        *a, k, metric, penalty, form=form,
                        scales=None if sc is None else torch.ones_like(sc))
                    torch.cuda.synchronize()
                    assert_bits_equal(kv, fv)
                    assert torch.equal(ki, fi), (store, form, k)


@pytest.mark.cuda
@pytest.mark.parametrize("pq_bits", [4, 8])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_ivf_pq_scan_kernel_on_card(mode, metric, pq_bits):
    """K4 + the K1 merge, both forms, against the plain version with the
    penalty row and an empty list (:func:`scan_cases`): equal on
    small-integer inputs in every LUT mode (int8: with an entry of 127 in
    each subspace, so that its scale is 1; with the scale 3/127 of a
    codebook of -3..3 the distances tie by the thousand and the two sum
    orders break the ties apart), close on Gaussian ones; two launches
    bit-equal. Also on probes skewed across the group boundaries
    (:func:`skewed_probes`)."""
    need_cuda()
    for integer in (True, False):
        st = pq_store(integer, 5 + pq_bits, pq_bits, n=12000, pq_dim=16,
                      pq_len=2, lists=24, m=300, p=6)
        if integer and mode == "int8":
            # an entry of 127 in every subspace: the int8 scale is then 1
            # and the decoded codebook the integers themselves
            st["codebooks"][:, 0, 0] = 127.0
            st["row_norms"] = tpq.decoded_row_norms(
                st["codes"], st["centers_rot"], st["codebooks"],
                st["list_offsets"])
        args = pq_scan_args(st, mode, "cuda")
        pen = st["penalty"].cuda()
        skewed = skewed_probes(300, 24, 6, 14 + pq_bits).cuda()
        for probed in (args[4], skewed):
            a = args[:4] + [probed] + args[5:]
            for form, k in scan_cases(integer):
                scan_both(tpq.ivf_pq_scan, tpq.ivf_pq_scan_plain,
                          (*a, k, metric, pen), k, form, integer)


@pytest.mark.cuda
def test_ivf_pq_scan_kernel_byte_codes_and_padding():
    """K4, both forms, with a pq_dim that is not a multiple of 16 (pq_dim
    6, pq_len 3: rot_dim 18, byte loads), a probe of only the empty list,
    and k past the candidates: (+inf, -1) slots as in the plain
    version."""
    need_cuda()
    st = pq_store(True, 9, 8, n=3000, pq_dim=6, pq_len=3, lists=12, m=40,
                  p=3)
    st["probed"][:5] = 3                          # only the empty list
    args = pq_scan_args(st, "f32", "cuda")
    for form, k in (("group", 5), ("pair", 5), ("group", 256),
                    ("group", 512), ("pair", 1000)):
        kv, ki = tpq.ivf_pq_scan(*args, k, "l2", form=form)
        pv, pi = tpq.ivf_pq_scan_plain(*args, k, "l2")
        torch.cuda.synchronize()
        assert torch.equal(kv, pv) and torch.equal(ki, pi), (form, k)
        assert bool((ki[:5] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ivf_pq_scan_kernel_graph_pass_k(metric):
    """K4 at the CAGRA IVF-PQ graph pass's shape: 4-bit codes at pq_len 1
    (pq_dim = rot_dim), the int8 LUT, k = 2·128 + 1 = 257, which the
    grouped form takes (32 queries a group): one grouped launch a call by
    default, one per-pair launch with ``form="pair"``; both equal to the
    plain version on small integers (an entry of 127 in each subspace: the
    int8 scale is 1) and on probes skewed across the group boundaries."""
    need_cuda()
    st = pq_store(True, 17, 4, n=8000, pq_dim=128, pq_len=1, lists=16,
                  m=300, p=6)
    st["codebooks"][:, 0, 0] = 127.0
    st["row_norms"] = tpq.decoded_row_norms(
        st["codes"], st["centers_rot"], st["codebooks"], st["list_offsets"])
    args = pq_scan_args(st, "int8", "cuda")
    assert tis.scan_form(257) == "group"
    assert tis.group_queries(257) == 32
    skewed = skewed_probes(300, 16, 6, 31).cuda()
    for probed in (args[4], skewed):
        a = args[:4] + [probed] + args[5:]
        pv, pi = tpq.ivf_pq_scan_plain(*a, 257, metric)
        for form, want in ((None, (1, 0)), ("pair", (0, 1))):
            before = (tpq.group_launches, tpq.pair_launches)
            kv, ki = tpq.ivf_pq_scan(*a, 257, metric, form=form)
            torch.cuda.synchronize()
            assert (tpq.group_launches - before[0],
                    tpq.pair_launches - before[1]) == want
            assert torch.equal(kv, pv) and torch.equal(ki, pi), form


def wide_pq_store(k: int, seed: int, integer: bool, pq_dim: int,
                  pq_len: int, m: int = 100):
    """A PQ store for the grouped K4 past k = 256 (4-bit codes, the int8
    LUT, as the graph pass), its lists cut where a histogram select can
    go wrong: 0, 1, k - 1, k, k + 1 and 2k rows; 3,000 rows (the longest,
    which sizes the scratch); 800 rows of which 600, scattered, share one
    code vector, so that they tie at the k-th value of every pair (at most
    200 others precede them); 700 equal rows; 1,200 rows with a penalty
    of +inf on 90% of them; a list of 700 rows pruned to size 0. Every
    query probes every list, in its own order. Integer inputs: a codebook
    of small integers with an entry of 127 a subspace (the int8 scale is
    1), integer centers and queries. Returns ``ivf_pq_scan``'s arguments
    up to ``q_rot`` on the card, and the penalty row."""
    rng = np.random.default_rng(seed)
    sizes = np.array([0, 1, k - 1, k, k + 1, 2 * k, 3000, 800, 700, 1200,
                      700])
    caps = (sizes + 8 + 7) // 8 * 8
    offsets = np.concatenate([[0], np.cumsum(caps)])
    rows = int(offsets[-1])
    codes = rng.integers(0, 16, (rows, pq_dim)).astype(np.uint8)
    tie = offsets[7] + rng.permutation(800)[:600]
    codes[tie] = codes[tie[0]]
    codes[offsets[8]:offsets[8] + 700] = codes[offsets[8]]
    pen = np.zeros(rows, np.float32)
    pen[offsets[9] + rng.permutation(1200)[:1080]] = np.inf
    sizes[10] = 0
    rot_dim = pq_dim * pq_len
    gen = ((lambda sh: rng.integers(-3, 4, sh)) if integer
           else rng.standard_normal)
    cb = gen((pq_dim, 16, pq_len)).astype(np.float32)
    if integer:
        cb[:, 0, 0] = 127.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    centers = t(gen((len(sizes), rot_dim)).astype(np.float32))
    probed = np.stack([rng.permutation(len(sizes)) for _ in range(m)])
    norms = tpq.decoded_row_norms(t(codes), centers, t(cb), offsets)
    args = [t(codes), norms, centers, tpq.lut_codebook(t(cb), "int8"),
            t(probed.astype(np.int32)), t(offsets[:-1].astype(np.int32)),
            t(sizes.astype(np.int32)),
            t(gen((m, rot_dim)).astype(np.float32))]
    return [a.cuda() for a in args], t(pen).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("pq_dim,pq_len", [(32, 1), (64, 2)])
@pytest.mark.parametrize("k", [257, 512])
def test_ivf_pq_scan_wide_selection_on_card(k, pq_dim, pq_len):
    """K4's grouped form past k = 256 (the radix select of
    csrc/list_select.cuh) on :func:`wide_pq_store`'s lists, with and
    without the penalty row, at both metrics, at rot_dim 32 (one stage a
    tile) and 128: equal to the plain version on integer inputs; on
    integer and Gaussian inputs each pair's first 256 slots equal bit for
    bit those of the plan at k = 256, whose streaming selection
    (offer_tile) is the plan this form replaced past 256, on the same
    distances; two launches bit-equal; one grouped launch a call."""
    need_cuda()
    for integer in (True, False):
        args, pen = wide_pq_store(k, 40 + k % 7 + pq_dim, integer, pq_dim,
                                  pq_len)
        m, p = args[4].shape
        for metric in ("l2", "ip"):
            for penalty in (pen, None):
                a = (*args, k, metric, penalty)
                before = tpq.group_launches
                kv, ki = tpq.ivf_pq_scan(*a)
                kv2, ki2 = tpq.ivf_pq_scan(*a)
                torch.cuda.synchronize()
                assert tpq.group_launches == before + 2
                assert_bits_equal(kv, kv2)
                assert torch.equal(ki, ki2)
                if integer:
                    pv, pi = tpq.ivf_pq_scan_plain(*a)
                    assert torch.equal(kv, pv) and torch.equal(ki, pi), (
                        metric, penalty is None)
                cand = (args[0], args[1] if metric == "l2" else None,
                        penalty, args[3], args[2], args[7], args[4],
                        args[5], args[6])
                wv, wi = tpq.ivf_pq_scan_candidates(*cand, k, metric)
                sv, si = tpq.ivf_pq_scan_candidates(*cand, 256, metric)
                torch.cuda.synchronize()
                what = (integer, metric, penalty is None)
                assert_bits_equal(wv.view(m, p, k)[:, :, :256],
                                  sv.view(m, p, 256))
                assert torch.equal(wi.view(m, p, k)[:, :, :256],
                                   si.view(m, p, 256)), what


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,store", [
    ("ivf_flat_scan", s) for s in ("float32", "bfloat16", "int8", "uint8")]
    + [("ivf_pq_scan", "float32")])
def test_group_plans_match_the_library(kernel, store):
    """The grouped forms' plans as the card's libraries make them (queries
    a group, query-tile layout, ring stages, shared memory) equal their
    Python statement (``ivf_scan.group_plan`` / ``group_smem``) at every
    k up to ``GROUP_MAX_K``, at the wide plan's k past it, and at several
    widths."""
    need_cuda()
    for d in (18, 32, 100, 128, 256):
        for k in list(range(1, tis.GROUP_MAX_K + 1)) + list(WIDE_SCAN_KS):
            smem, a_res, ns = tis.group_smem(kernel, k, d, store)
            assert tis.group_plan_on_card(kernel, k, d, store) == (
                tis.group_queries(k), a_res, ns, smem), (d, k)


# ---- past the old limits: K2 past its k-lists, K3 and K4 past 512 ----

# the k of the new forms' card tests: around the grouped plans' 512 and
# the per-pair forms' 1024, and FAR_K (past any one sort of a warp's
# shared memory; on FAR_QUERIES queries)
WIDE_SCAN_KS = (513, 1024, 1025, 2048)
WIDE_K2_KS = (25, 32, 33, 64, 65, 129, 256, 257, 511, 512, 513, 1024,
              1025, 2048)
FAR_K, FAR_QUERIES = 16_500, 8


def zero_penalty(rng, n: int, inf_share: float) -> np.ndarray:
    """A penalty row of +inf on ``inf_share`` of the rows, and 0.0 or -0.0
    (half each) on the rest: under the ip metric a zero query's distance
    is -0.0, so its distances are -0.0 and 0.0 side by side."""
    pen = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)
    pen[rng.random(n) < inf_share] = np.inf
    return pen


def wide_knn_case(store: str, seed: int, n: int = 20_000, d: int = 64,
                  m: int = 100):
    """Integer-valued rows and queries for K2's wide form in ``store`` (as
    :func:`store_case`: held exactly at a scale of 1, so every distance is
    exact and ties come by the hundred at every value), 600 copies of one
    row scattered, query 0 all zeros (-0.0 under ip), and three penalty
    rows: +inf on 30% and on 95% of the rows (fewer finite rows than k
    past 1,000) and 0.0 elsewhere, for the merged results (K1's order
    puts -0.0 before 0.0, the plain version's float compare does not),
    and :func:`zero_penalty`'s with 10% +inf, -0.0 and 0.0, for each
    split's candidates. On the card: (stored, scales, int4_dim, queries,
    penalties)."""
    rng = np.random.default_rng(seed)
    if store == "uint8":
        x = rng.integers(0, 4, (n, d)).astype(np.float32)
        q = rng.integers(0, 4, (m, d)).astype(np.float32)
    else:
        x = rng.integers(-2, 3, (n, d)).astype(np.float32)
        if store in ("int8", "int4"):
            lim = 127 if store == "int8" else 7
            x[:, 0] = np.where(rng.random(n) < 0.5, -lim, lim)
        q = rng.integers(-2, 3, (m, d)).astype(np.float32)
    dup = rng.permutation(n)[:600]
    x[dup] = x[dup[0]]
    q[0] = 0.0
    stored, scales = tq.quantize_rows(torch.from_numpy(x), store)
    pens = [torch.from_numpy(zero_penalty(rng, n, share)).cuda()
            for share in (0.3, 0.95, 0.1)]
    pens[0], pens[1] = pens[0] + 0.0, pens[1] + 0.0   # -0.0 -> 0.0
    return (stored.cuda(), None if scales is None else scales.cuda(),
            d if store == "int4" else None, torch.from_numpy(q).cuda(), pens)


def knn_split_plain(q, x, k, metric, pen, sc, dim4, store):
    """K2's wide form held at its own output: its candidates are one list
    a query (the corpus splits meet in the form's selection, which keys
    -0.0 as 0.0 and breaks ties by column, as the plain version's stable
    sort does), so they equal the plain version over the whole corpus,
    values bit for bit, -0.0 beside 0.0 included. Returns the splits of
    the launch's plan."""
    qf = q.float()
    qn = tfk.prepare_norms(metric, qf)
    dn = tfk.corpus_norms(metric, x, None, sc, dim4)
    qk = tfk.kernel_queries(qf, store, x.shape[1]).contiguous()
    cv, ci, parts = tfk.fused_knn_candidates(
        qk, qn, x, None if dn is None else dn.contiguous(), pen, k, metric,
        sc, store)
    assert parts == 1 and cv.shape == (q.shape[0], k)
    pv, pi = tfk.fused_knn_plain(q, x, k, metric, None, pen, sc, dim4)
    assert_bits_equal(cv, pv)
    assert torch.equal(ci, pi)
    return tfk._split_plan(q.shape[0], x.shape[0], k, qk.shape[1], metric,
                           q.device, store)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cos", "ip"])
@pytest.mark.parametrize("store", ("float32",) + STORE_NAMES)
def test_fused_knn_wide_kernel_on_card(store, metric):
    """K2's wide form (k past LIST_MAX_K = 24: its splits sharing a bound,
    their buffers selected together, no K1 merge) on
    :func:`wide_knn_case`'s integer rows at k = 25, 32, 33, 64, 65, 129,
    256 (the k-list plans' until the wide form took them), 257, 511,
    512, 513, 1024,
    1025, 2048, at FAR_K on 8 queries and at k = n on 8: equal to the
    plain version, values bit for bit (l2, ip; cosine's quotients close),
    with +inf penalties on 30% and 95% of the rows (then fewer finite rows
    than k: (+inf, -1) slots); launched twice, bit-equal (the buffers'
    slots and the shared bounds come from atomics); its candidates (one
    list a query) bit for bit against the plain version, -0.0 beside 0.0
    included (query 0 under ip). On Gaussian rows the first 24 columns at
    k = 1024 are those of the k-list plan at k = 24, and the first 256
    those of the form at 256, bit for bit."""
    need_cuda()
    x, sc, dim4, q, pens = wide_knn_case(store, 61)
    n = x.shape[0]
    for k, rows in ([(k, q.shape[0]) for k in WIDE_K2_KS]
                    + [(FAR_K, FAR_QUERIES), (n, FAR_QUERIES)]):
        for pen in pens[:2]:
            a = (q[:rows], x, k, metric)
            kw = dict(penalty=pen, scales=sc, int4_dim=dim4)
            before = tfk.launches
            kv, ki = tfk.fused_knn(*a, **kw)
            kv2, ki2 = tfk.fused_knn(*a, **kw)
            pv, pi = tfk.fused_knn_plain(*a, **kw)
            torch.cuda.synchronize()
            assert tfk.launches == before + 2
            assert_bits_equal(kv, kv2)
            assert torch.equal(ki, ki2)
            if metric != "cos":
                assert_bits_equal(kv, pv)
                assert torch.equal(ki, pi), (k, rows)
            else:
                assert_knn_sets_close(pv.cpu(), pi.cpu(), kv.cpu(),
                                      ki.cpu(), min_shared=0.99)
        if metric != "cos" and k in (65, 257, 1025, FAR_K):
            knn_split_plain(q[:rows], x, k, metric, pens[2], sc, dim4,
                            store)
    xg, scg, d4g, qg = store_case(store, False, 20_000, 64, 100, 17)
    xg, qg = xg.cuda(), qg.cuda()
    scg = None if scg is None else scg.cuda()
    v1k, i1k = tfk.fused_knn(qg, xg, 1024, metric, scales=scg, int4_dim=d4g)
    for short in (tfk.LIST_MAX_K, 256):
        vs, is_ = tfk.fused_knn(qg, xg, short, metric, scales=scg,
                                int4_dim=d4g)
        torch.cuda.synchronize()
        assert_bits_equal(v1k[:, :short].contiguous(), vs)
        assert torch.equal(i1k[:, :short], is_)


@pytest.mark.cuda
@pytest.mark.parametrize("store", ("float32",) + STORE_NAMES)
def test_fused_knn_wide_short_splits_on_card(store):
    """K2's wide form launched by its entry with more splits than its plan
    takes: 8 splits of 384 rows over 3,000, fewer than 2k (k = 300) and
    than k (k = 1,000 and n - 1), so that some splits never shrink nor
    tighten the shared bound while others do; equal to the plain version,
    values bit for bit, with +inf on 95% of the rows and with -0.0 beside
    0.0 (l2, ip); the entry refuses a buffer shorter than k + 128."""
    need_cuda()
    from raft_tpu_torch.ops import _cuda

    x, sc, dim4, q, pens = wide_knn_case(store, 62, n=3000)
    n, m = x.shape[0], q.shape[0]
    lib = _cuda.library(_cuda.STORE_SOURCES["fused_knn"][store])
    splits, per = 8, 384
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    for metric in ("l2", "ip"):
        qf = q.float()
        qn = tfk.prepare_norms(metric, qf)
        dn = tfk.corpus_norms(metric, x, None, sc, dim4)
        dn = None if dn is None else dn.contiguous()
        qk = tfk.kernel_queries(qf, store, x.shape[1]).contiguous()
        for k in (300, 1000, n - 1):
            cap = tfk.wide_cap(k)
            scratch = torch.empty(tfk.wide_scratch_bytes(m, splits, k),
                                  dtype=torch.uint8, device="cuda")
            for pen in pens[1:]:
                ov = torch.empty((m, k), dtype=torch.float32, device="cuda")
                oi = torch.empty((m, k), dtype=torch.int32, device="cuda")
                head = (qk.data_ptr(), ptr(qn), x.data_ptr(), ptr(dn),
                        pen.data_ptr(), ptr(sc), m, n, qk.shape[1], k,
                        tfk._METRIC_CODE[metric], splits, per)
                tail = (scratch.data_ptr(), ov.data_ptr(), oi.data_ptr(),
                        _cuda.stream_of(qk))
                assert lib.raft_fused_knn_wide(*head, cap, *tail) == 0
                assert lib.raft_fused_knn_wide(*head, k + 127, *tail) != 0
                pv, pi = tfk.fused_knn_plain(q, x, k, metric, penalty=pen,
                                             scales=sc, int4_dim=dim4)
                torch.cuda.synchronize()
                assert_bits_equal(ov, pv)
                assert torch.equal(oi, pi), (metric, k)


@pytest.mark.cuda
def test_fused_knn_wide_kernel_all_rows_equal():
    """K2's wide form where every row is the same: every distance ties, so
    each query's k are the first k columns in order, at k = 257, 1024 and
    k = n (n = 3,000, one split) and at 257 and 1024 over 60,000 rows
    (split)."""
    need_cuda()
    for n, ks in ((3000, (257, 1024, 3000)), (60_000, (257, 1024))):
        x = torch.full((n, 40), 1.0, device="cuda")
        q = torch.from_numpy(np.random.default_rng(n).integers(
            -2, 3, (70, 40)).astype(np.float32)).cuda()
        for k in ks:
            for metric in ("l2", "ip"):
                kv, ki = tfk.fused_knn(q, x, k, metric)
                pv, pi = tfk.fused_knn_plain(q, x, k, metric)
                torch.cuda.synchronize()
                assert_bits_equal(kv, pv)
                assert torch.equal(ki, pi)
                assert torch.equal(ki[0], torch.arange(
                    k, dtype=torch.int32, device="cuda"))


def wide_flat_store(k: int, seed: int, store: str, d: int = 40,
                    m: int = 100):
    """IVF-Flat lists for the grouped K3 past k = 512, in ``store``, cut as
    :func:`wide_pq_store` cuts its lists: 0, 1, k - 1, k, k + 1 and 2k
    rows, 3,000 rows, 800 of which 600 scattered rows are one row (ties at
    the k-th value), 700 equal rows, 1,200 rows with +inf on 90% of the
    penalty, 700 rows pruned to size 0; every query probes every list, in
    its own order; integer-valued rows (held exactly by the store at a
    scale of 1) and queries, query 0 all zeros (-0.0 under ip). →
    ``ivf_flat_scan``'s arguments up to the queries and the scales, and
    two penalty rows: :func:`zero_penalty`'s with 10% +inf, and the same
    with -0.0 turned to 0.0 (for the merged results: K1's order puts -0.0
    before 0.0)."""
    rng = np.random.default_rng(seed)
    sizes = np.array([0, 1, k - 1, k, k + 1, 2 * k, 3000, 800, 700, 1200,
                      700])
    caps = (sizes + 8 + 7) // 8 * 8
    offsets = np.concatenate([[0], np.cumsum(caps)])
    rows = int(offsets[-1])
    if store == "uint8":
        x = rng.integers(0, 4, (rows, d)).astype(np.float32)
        q = rng.integers(0, 4, (m, d)).astype(np.float32)
    else:
        x = rng.integers(-3, 4, (rows, d)).astype(np.float32)
        if store == "int8":
            x[:, 0] = np.where(rng.random(rows) < 0.5, -127, 127)
        q = rng.integers(-3, 4, (m, d)).astype(np.float32)
    q[0] = 0.0
    tie = offsets[7] + rng.permutation(800)[:600]
    x[tie] = x[tie[0]]
    x[offsets[8]:offsets[8] + 700] = x[offsets[8]]
    pen = zero_penalty(rng, rows, 0.1)
    pen[offsets[9] + rng.permutation(1200)[:1080]] = np.inf
    sizes[10] = 0
    stored, scales = tq.quantize_rows(torch.from_numpy(x), store)
    deq = tq.dequantize_rows(stored, scales)
    norms = (deq * deq).sum(1)
    probed = np.stack([rng.permutation(len(sizes)) for _ in range(m)])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    args = [stored.cuda(), norms.cuda(), t(probed.astype(np.int32)),
            t(offsets[:-1].astype(np.int32)), t(sizes.astype(np.int32)),
            t(q)]
    pen_t = t(pen)
    return (args, None if scales is None else scales.cuda(),
            (pen_t, pen_t + 0.0))


def pairs_plain(plain, args, probed_at: int, k: int, metric, penalty,
                **kw):
    """The plain version of one scan pair a query: each probe column
    alone, (m, p, k)."""
    probed = args[probed_at]
    outs_v, outs_i = [], []
    for j in range(probed.shape[1]):
        a = list(args)
        a[probed_at] = probed[:, j:j + 1].contiguous()
        v, i = plain(*a, k, metric, penalty, **kw)
        outs_v.append(v)
        outs_i.append(i)
    return torch.stack(outs_v, 1), torch.stack(outs_i, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cos", "ip"])
@pytest.mark.parametrize("store", ("float32", "bfloat16", "int8", "uint8"))
def test_ivf_flat_scan_wide_on_card(store, metric):
    """The grouped K3 past k = 512 (one grouped launch a call; 32 queries
    a group, the wide plan) on :func:`wide_flat_store`'s lists at k = 513,
    1024, 1025, 2048 and at FAR_K on 8 queries: merged with K1, equal to
    the plain version (l2, ip; cosine close), with and without the penalty
    row; launched twice, bit-equal; each pair's k columns bit for bit
    against the plain version of that pair alone, -0.0 beside 0.0
    included; at 513 <= k <= 1024 equal to the per-pair form, bit for
    bit; each pair's first 512 columns those of the plan at k = 512 (on
    integer and Gaussian rows)."""
    need_cuda()
    for k in WIDE_SCAN_KS + (FAR_K,):
        args, sc, (pen0, pen) = wide_flat_store(k, 70 + k % 13, store)
        if k == FAR_K:
            args[2], args[5] = args[2][:FAR_QUERIES], args[5][:FAR_QUERIES]
        m, p = args[2].shape
        kern = functools.partial(tis.ivf_flat_scan, scales=sc)
        plain = functools.partial(tis.ivf_flat_scan_plain, scales=sc)
        for penalty in (pen, None):
            before = tis.group_launches
            kv, ki = kern(*args, k, metric, penalty)
            kv2, ki2 = kern(*args, k, metric, penalty)
            pv, pi = plain(*args, k, metric, penalty)
            torch.cuda.synchronize()
            assert tis.group_launches == before + 2
            assert_bits_equal(kv, kv2)
            assert torch.equal(ki, ki2)
            if metric != "cos":
                assert_bits_equal(kv, pv)
                assert torch.equal(ki, pi), (k, penalty is None)
            else:
                assert_knn_sets_close(pv.cpu(), pi.cpu(), kv.cpu(),
                                      ki.cpu(), min_shared=0.99)
        if metric == "cos":
            continue
        q = args[5]
        qn = tfk.prepare_norms(metric, q)
        dn = tfk.corpus_norms(metric, args[0], args[1], sc, None)
        cand = lambda kk, form=None: tis.ivf_flat_scan_candidates(  # noqa: E731
            args[0], dn, pen0, q, qn, args[2], args[3], args[4], kk, metric,
            form, sc)
        wv, wi = cand(k)
        ppv, ppi = pairs_plain(tis.ivf_flat_scan_plain, args, 2, k, metric,
                               pen0, scales=sc)
        torch.cuda.synchronize()
        assert_bits_equal(wv.view(m, p, k), ppv)
        assert torch.equal(wi.view(m, p, k), ppi), k
        sv, si = cand(512)
        torch.cuda.synchronize()
        assert_bits_equal(wv.view(m, p, k)[:, :, :512].contiguous(),
                          sv.view(m, p, 512))
        assert torch.equal(wi.view(m, p, k)[:, :, :512], si.view(m, p, 512))
        if k <= tis.PAIR_MAX_K:
            rv, ri = cand(k, "pair")
            torch.cuda.synchronize()
            assert_bits_equal(wv, rv)
            assert torch.equal(wi, ri), k
    # Gaussian lists: the first 512 columns a pair as the plan at 512
    c = _ivf_store(False, 9, n=20_000, lists=8, m=100, p=4)
    if store == "uint8":   # bytes, queries in [0, 255]
        c[0] = torch.clamp(torch.round(c[0] * 20 + 128), 0, 255)
        c[5] = c[5] * 20 + 128
    stored, scales = tq.quantize_rows(c[0], store)
    deq = tq.dequantize_rows(stored, scales)
    c[0], c[1] = stored, (deq * deq).sum(1)
    c = [t.cuda() for t in c]
    sc = None if scales is None else scales.cuda()
    qn = tfk.prepare_norms(metric, c[5])
    dn = tfk.corpus_norms(metric, c[0], c[1], sc, None)
    m, p = c[2].shape
    wv, wi = tis.ivf_flat_scan_candidates(c[0], dn, c[6], c[5], qn, c[2],
                                          c[3], c[4], 1025, metric, None, sc)
    sv, si = tis.ivf_flat_scan_candidates(c[0], dn, c[6], c[5], qn, c[2],
                                          c[3], c[4], 512, metric, None, sc)
    torch.cuda.synchronize()
    assert_bits_equal(wv.view(m, p, 1025)[:, :, :512].contiguous(),
                      sv.view(m, p, 512))
    assert torch.equal(wi.view(m, p, 1025)[:, :, :512], si.view(m, p, 512))


@pytest.mark.cuda
@pytest.mark.parametrize("pq_dim,pq_len", [(32, 1), (64, 2)])
@pytest.mark.parametrize("k", WIDE_SCAN_KS + (FAR_K,))
def test_ivf_pq_scan_past_512_on_card(k, pq_dim, pq_len):
    """K4's grouped form past k = 512 (the wide plan selecting in rounds)
    on :func:`wide_pq_store`'s lists (FAR_K: on 8 queries), query 0 all
    zeros and a penalty row of -0.0, 0.0 and +inf (:func:`zero_penalty`):
    merged, equal to the plain version with and without a penalty row of
    0.0 and +inf (integer inputs; both metrics); launched twice,
    bit-equal; each pair's k columns bit for bit against the plain version
    of that pair alone (-0.0 beside 0.0 under ip); each pair's first 512
    columns those of the plan at k = 512 (integer and Gaussian inputs);
    at 513 <= k <= 1024 equal to the per-pair form, bit for bit."""
    need_cuda()
    for integer in (True, False):
        args, pen = wide_pq_store(k, 50 + k % 11 + pq_dim, integer, pq_dim,
                                  pq_len)
        if k == FAR_K:
            args[4], args[7] = args[4][:FAR_QUERIES], args[7][:FAR_QUERIES]
        args[7][0] = 0.0
        m, p = args[4].shape
        rng = np.random.default_rng(k)
        zpen = torch.from_numpy(zero_penalty(rng, pen.shape[0], 0.2)).cuda()
        for metric in ("l2", "ip"):
            if integer:
                for penalty in (zpen + 0.0, None):
                    a = (*args, k, metric, penalty)
                    kv, ki = tpq.ivf_pq_scan(*a)
                    kv2, ki2 = tpq.ivf_pq_scan(*a)
                    pv, pi = tpq.ivf_pq_scan_plain(*a)
                    torch.cuda.synchronize()
                    assert_bits_equal(kv, kv2)
                    assert torch.equal(ki, ki2)
                    assert_bits_equal(kv, pv)
                    assert torch.equal(ki, pi), (metric, penalty is None)
            cand = (args[0], args[1] if metric == "l2" else None, zpen,
                    args[3], args[2], args[7], args[4], args[5], args[6])
            wv, wi = tpq.ivf_pq_scan_candidates(*cand, k, metric)
            sv, si = tpq.ivf_pq_scan_candidates(*cand, 512, metric)
            torch.cuda.synchronize()
            assert_bits_equal(wv.view(m, p, k)[:, :, :512].contiguous(),
                              sv.view(m, p, 512))
            assert torch.equal(wi.view(m, p, k)[:, :, :512],
                               si.view(m, p, 512))
            if not integer:
                continue
            ppv, ppi = pairs_plain(tpq.ivf_pq_scan_plain, args, 4, k,
                                   metric, zpen)
            torch.cuda.synchronize()
            assert_bits_equal(wv.view(m, p, k), ppv)
            assert torch.equal(wi.view(m, p, k), ppi), (metric, k)
            if k <= tis.PAIR_MAX_K:
                rv, ri = tpq.ivf_pq_scan_candidates(*cand, k, metric,
                                                    form="pair")
                torch.cuda.synchronize()
                assert_bits_equal(wv, rv)
                assert torch.equal(wi, ri), (metric, k)


@pytest.mark.cuda
def test_wide_scans_on_two_streams_at_once():
    """The wide plans' scratch comes from ``torch.empty`` a call, which
    PyTorch's caching allocator orders by stream: K4's and K3's wide
    launches and K2's wide form, two at a time on two streams, each over
    its own inputs and k, give what each gives alone on the default
    stream (a scratch kept and shared by the two launches would let one
    overwrite the other's distance rows)."""
    need_cuda()
    pa, _ = wide_pq_store(300, 1, True, 32, 1)
    pb, _ = wide_pq_store(700, 2, True, 64, 2)
    fa, fsc, _ = wide_flat_store(600, 3, "float32")
    x, sc, dim4, q, _ = wide_knn_case("float32", 4, n=8000)
    calls = [
        lambda: tpq.ivf_pq_scan_candidates(
            pa[0], pa[1], None, pa[3], pa[2], pa[7], pa[4], pa[5], pa[6],
            300, "l2"),
        lambda: tpq.ivf_pq_scan_candidates(
            pb[0], pb[1], None, pb[3], pb[2], pb[7], pb[4], pb[5], pb[6],
            700, "l2"),
        lambda: tis.ivf_flat_scan(*fa, 600, "l2"),
        lambda: tfk.fused_knn(q, x, 1000, "l2"),
    ]
    alone = [fn() for fn in calls]
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for rnd in range(3):
        for i in range(len(calls)):
            j = (i + 1 + rnd) % len(calls)
            with torch.cuda.stream(streams[0]):
                got_i = calls[i]()
            with torch.cuda.stream(streams[1]):
                got_j = calls[j]()
            torch.cuda.synchronize()
            for got, ref in ((got_i, alone[i]), (got_j, alone[j])):
                assert_bits_equal(got[0], ref[0])
                assert torch.equal(got[1], ref[1]), (rnd, i, j)


# NN-descent's merge at the knob defaults (s = 16, join = 24) for k = 64
# and 128: (batch rows, k + 2s(1 + join)) with the JAX package's closest
# exposure, (batch rows, k + 2s(1 + join + s)) with CAGRA's sampled one
NND_MERGE_SHAPES = ((8192, 864, 64), (8192, 928, 128), (8192, 1376, 64),
                    (8192, 1440, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,k", NND_MERGE_SHAPES)
def test_select_k_kernel_nn_descent_merge(rows, n, k):
    """K1, both forms, at the NN-descent merge shapes: the sorted list's
    k values (ties, +inf slots) then candidates (ties, +inf for masked
    ones), and the same shape in Gaussian values; equal to the plain
    version."""
    need_cuda()
    rng = np.random.default_rng(n)
    cur = np.sort(rng.integers(0, 400, (rows, k)).astype(np.float32), 1)
    cur[rng.random(rows) < 0.1, k // 2:] = np.inf
    cand = rng.integers(0, 500, (rows, n - k)).astype(np.float32)
    cand[rng.random((rows, n - k)) < 0.3] = np.inf
    ints = torch.from_numpy(np.concatenate([cur, cand], 1)).cuda()
    gauss = torch.from_numpy(rng.standard_normal((rows, n)).astype(
        np.float32)).cuda()
    for x in (ints, gauss):
        pv, pi = tsk.select_k_plain(x, k)
        for form in ("warp", "radix"):
            kv, ki = tsk.kpass_select_k(x, k, form=form)
            torch.cuda.synchronize()
            assert torch.equal(kv, pv) and torch.equal(ki, pi), form


def graph_pass_rows(rows, runs=64, k=257, seed=0):
    """Rows shaped as the IVF-PQ graph pass's merge input (K4's grouped
    output, a probe's k candidates after another's): ``runs`` sorted runs
    of k integer-valued keys (ties), some ending in +inf tails (a probe
    list shorter than k)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.integers(0, 5000, (rows, runs, k)).astype(np.float32),
                2)
    short = rng.integers(0, k, (rows, runs))
    x[np.arange(k)[None, None, :] >= short[:, :, None]
      + (rng.random((rows, runs, 1)) < 0.8) * k] = np.inf
    return torch.from_numpy(x.reshape(rows, runs * k)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_kernel_graph_pass_merge(select_min):
    """K1, both forms, at the IVF-PQ graph pass's merge row shape
    (2,048 of its 32,768 rows x 64 probes x 257, k = 257): 64 sorted
    runs with +inf tails, and Gaussian values; equal to the plain
    version, in both directions (the runs negated for a max
    selection)."""
    need_cuda()
    k = 257
    runs = graph_pass_rows(2048, 64, k)
    gauss = torch.from_numpy(np.random.default_rng(1).standard_normal(
        runs.shape).astype(np.float32)).cuda()
    assert tsk.select_form(k) == "warp"
    for x in (runs, gauss):
        a = x if select_min else -x
        pv, pi = tsk.select_k_plain(a, k, select_min)
        for form in ("warp", "radix"):
            kv, ki = tsk.kpass_select_k(a, k, select_min, form=form)
            torch.cuda.synchronize()
            assert torch.equal(kv, pv) and torch.equal(ki, pi), form


# K1's radix select past the warp form: rows staged in shared memory
# (1,806 and 20,000 columns) and read from device memory, their keys at or
# below the bucket gathered once they fit (40,960: the IVF-Flat merge at
# k = 2,048; 65,600: the degree-512 IVF-PQ pass's merge), k past one
# round of 2,048 keys (2,049, 4,097) and k = n (every column, in rounds)
RADIX_NS = (1806, 20000, 40960, 60000, 65600)
RADIX_KS = (513, 600, 1024, 1025, 2048, 2049, 4097)


def radix_rows(n, select_min, seed, rows=12):
    """Integer rows with heavy ties and ±inf cells (the side a selection
    takes last), then: row 0 one repeated value, row 1 all ±inf, row 2
    with 300 finite cells (fewer than every k here), row 3 NaN, -NaN,
    ±inf and -0.0 against 0.0 mixed in, row 4 Gaussian."""
    rng = np.random.default_rng(seed)
    bad = np.inf if select_min else -np.inf
    x = rng.integers(0, 2000, (rows, n)).astype(np.float32)
    x[rng.random((rows, n)) < 0.05] = bad
    x[0] = 7.0
    x[1] = bad
    x[2, 300:] = bad
    x[2] = x[2, rng.permutation(n)]
    x[3] = rng.integers(-3, 4, n)
    for v, share in ((np.nan, 0.15), (-np.float32(np.nan), 0.03),
                     (np.inf, 0.05), (-np.inf, 0.05), (-0.0, 0.1)):
        x[3, rng.random(n) < share] = v
    x[4] = rng.standard_normal(n)
    return torch.from_numpy(x).cuda()


def check_radix(x, k, select_min):
    """K1's radix select on x at k bit for bit against the plain version,
    one launch of its form counted."""
    pv, pi = tsk.select_k_plain(x, k, select_min)
    counts = (tsk.warp_launches, tsk.radix_launches)
    kv, ki = tsk.kpass_select_k(x, k, select_min, form="radix")
    torch.cuda.synchronize()
    assert_bits_equal(kv, pv)
    assert torch.equal(ki, pi), (tuple(x.shape), k, select_min)
    assert (tsk.warp_launches - counts[0],
            tsk.radix_launches - counts[1]) == (0, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", RADIX_NS)
@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_radix_on_card(n, select_min):
    """K1's radix select past k = 512 (k = n too), bit for bit against
    its plain version on rows of one repeated value, all ±inf, fewer
    finite cells than k, NaN / -NaN / -0.0 and Gaussian values; each call
    one launch of the radix form, and the default takes it past 512."""
    need_cuda()
    x = radix_rows(n, select_min, n + select_min)
    for k in sorted({k for k in RADIX_KS if k <= n} | {n}):
        check_radix(x, k, select_min)
    counts = tsk.radix_launches
    tsk.kpass_select_k(x, 513, select_min)
    assert tsk.radix_launches == counts + 1


@pytest.mark.cuda
@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_radix_merge_rows(select_min):
    """K1's radix select on rows built like the wide-k merges: 64 sorted
    runs of 1,025 with +inf tails (the degree-512 IVF-PQ pass, k =
    1,025) and 20 of 2,048 (the IVF-Flat search at k = 2,048), both
    wider than shared memory, integer values with ties, the runs
    negated for a max selection; and one row of each alone."""
    need_cuda()
    for runs, k in ((64, 1025), (20, 2048)):
        x = graph_pass_rows(256, runs, k, seed=k)
        x = x if select_min else -x
        check_radix(x, k, select_min)
        check_radix(x[:1].contiguous(), k, select_min)
        check_radix(x, 513, select_min)


@pytest.mark.cuda
def test_select_k_radix_on_two_streams_at_once():
    """K1's radix select launched on two streams at once, over two inputs
    of different widths and k (one staged, one read from device memory),
    gives what each gives alone."""
    need_cuda()
    xa = radix_rows(20000, True, 1, rows=64)
    xb = radix_rows(65600, False, 2, rows=48)
    calls = [lambda: tsk.kpass_select_k(xa, 2048, True, form="radix"),
             lambda: tsk.kpass_select_k(xb, 1025, False, form="radix")]
    alone = [fn() for fn in calls]
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for rnd in range(3):
        with torch.cuda.stream(streams[rnd % 2]):
            got_a = calls[0]()
        with torch.cuda.stream(streams[1 - rnd % 2]):
            got_b = calls[1]()
        torch.cuda.synchronize()
        for got, ref in ((got_a, alone[0]), (got_b, alone[1])):
            assert_bits_equal(got[0], ref[0])
            assert torch.equal(got[1], ref[1]), rnd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_cagra_fused_kernel_itopk_256(dtype):
    """K6 at the bench sweep's widest buffer, itopk 256, over a degree-32
    graph (deg_p 32, dim_p 128): equal to its plain version where
    ``fused_capable`` says the card serves the shape; where it says not,
    the kernel refuses the shape (its shared-memory check)."""
    need_cuda()
    es = card_store(dtype, 14, True, n=3000, degree=32, deg_p=32, dim=128,
                    m=200, itopk=256)
    kw = dict(itopk=256, width=1, max_iter=12, kprime=32, degree=32,
              metric="l2")
    args = (es["q"], es["buf_d"], es["buf_i"], es["vecs"], es["aux"],
            es["gph"], None)
    store = "bfloat16" if dtype == torch.bfloat16 else "int8"
    if not tcf.fused_capable(256, 1, 32, 32, 128, store, 12, "cuda"):
        with pytest.raises(RaftError, match="shared memory"):
            tcf.fused_traverse_kernel(*args, **kw)
        return
    kd, ki, _, _ = tcf.fused_traverse_kernel(*args, **kw)
    pd, pi = tcf.fused_traverse_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


@pytest.mark.cuda
def test_ivf_scans_group_without_host_sync():
    """The grouped forms' packing and both K3 and K4 launches, each form,
    run without a host synchronisation; each kernel counts its launches
    by form."""
    need_cuda()
    c = [t.cuda() for t in _ivf_store(False, 4)]
    data, norms, probed, offsets, sizes, q, pen = c
    qn = tfk.prepare_norms("l2", q)
    st = pq_store(False, 6, n=3000, lists=16)
    a = pq_scan_args(st, "bf16", "cuda")
    torch.cuda.synchronize()
    before = (tis.group_launches, tis.pair_launches, tpq.group_launches,
              tpq.pair_launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        tis.pack_pairs(probed, offsets.shape[0], 128)
        for form in ("group", "pair"):
            tis.ivf_flat_scan_candidates(data, norms, pen, q, qn, probed,
                                         offsets, sizes, 10, "l2", form)
            tpq.ivf_pq_scan_candidates(a[0], a[1], None, a[3], a[2], a[7],
                                       a[4], a[5], a[6], 10, "l2", form)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    after = (tis.group_launches, tis.pair_launches, tpq.group_launches,
             tpq.pair_launches)
    assert tuple(x - y for x, y in zip(after, before)) == (1, 1, 1, 1)


# K5's and K6's card shapes past the first ones (seed 11 / 12, dim 100,
# deg_p 64, degree 40): (integer, n, degree, deg_p, dim, m); 9,000
# queries (18,000 pairs) run the persistent warps past one wave of the
# card; n = 400 makes duplicate ids within a graph row and between rows
# and the buffer common; dims 1000 and 768 (dim_p 1024 and 768) are wide
# stores, whose tiles the kernels stage one 128-dim chunk at a time
EDGE_SHAPES = [(True, 5000, 64, 64, 128, 9000),
               (True, 3000, 90, 96, 200, 300),
               (False, 3000, 90, 96, 200, 300),
               (True, 400, 128, 128, 256, 200),
               (False, 400, 128, 128, 256, 200),
               (True, 300, 64, 64, 1000, 200),
               (False, 300, 64, 64, 768, 200)]


def card_store(dtype, seed, integer, **shape):
    return {k: v.cuda() if torch.is_tensor(v) else v
            for k, v in edge_store(dtype, seed, integer, **shape).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("penalty", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_graph_expand_kernel_on_card(dtype, metric, penalty):
    """K5 against its plain version, which adds in the kernel's order:
    equal values and edge positions on an integer-valued store and on
    Gaussian queries with real scales, pad edges and penalized edges as
    (+inf, -1), for k' below and at deg_p; then at the EDGE_SHAPES (deg_p
    96 and 128, dim_p 256, 768 and 1024, 18,000 pairs) with k' = deg_p."""
    need_cuda()
    cases = [(integer, dict(), kout) for integer in (True, False)
             for kout in (1, 24, 64)]
    cases += [(integer, dict(n=n, degree=deg, deg_p=deg_p, dim=dim, m=m),
               deg_p) for integer, n, deg, deg_p, dim, m in EDGE_SHAPES]
    for integer, shape, kout in cases:
        es = card_store(dtype, 11, integer, **shape)
        pen = es["pen"] if penalty else None
        args = (es["parents"], es["q"], es["vecs"], es["aux"], kout, metric,
                es["degree"], pen)
        kv, ki = tge.graph_expand(*args)
        pv, pi = tge.graph_expand_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(kv, pv) and torch.equal(ki, pi), (shape, kout)


@pytest.mark.cuda
@pytest.mark.parametrize("penalty", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_cagra_fused_kernel_on_card(dtype, metric, penalty):
    """K6 against its plain version (max_iter edge hops on the plain K5)
    at width 1 and 3 and k' 1 and 16: equal buffers, ties included, on an
    integer-valued store and on Gaussian queries with real scales, and on
    seeded buffers shuffled out of order (also at max_iter 0, where both
    return the seed as it came); then at the EDGE_SHAPES with k' = deg_p
    or itopk, itopk 64 and 128, width 1-3, every 7th query's frontier
    closing early. A second launch gives the same bits, and the hop and
    parent counts hold."""
    need_cuda()
    cases = [(integer, dict(), width, kprime, 32, hops_max, shuffle)
             for integer, (width, kprime), hops_max, shuffle in (
                 (True, (1, 16), 6, False), (True, (3, 16), 6, False),
                 (True, (2, 1), 6, False), (False, (1, 16), 6, False),
                 (False, (3, 16), 6, False), (True, (2, 16), 6, True),
                 (False, (1, 16), 6, True), (True, (1, 16), 0, True))]
    for (integer, n, deg, deg_p, dim, m), (width, itopk) in zip(
            EDGE_SHAPES, ((1, 64), (2, 128), (3, 64), (3, 128), (2, 64),
                          (1, 64), (2, 64))):
        cases.append((integer, dict(n=n, degree=deg, deg_p=deg_p, dim=dim,
                                    m=m, closed=True),
                      width, min(deg_p, itopk), itopk, 12, False))
    for integer, shape, width, kprime, itopk, hops_max, shuffle in cases:
        es = card_store(dtype, 12, integer, itopk=itopk, **shape)
        pen = es["pen"] if penalty else None
        kw = dict(itopk=itopk, width=width, max_iter=hops_max,
                  kprime=kprime, degree=es["degree"], metric=metric)
        bd, bi = es["buf_d"], es["buf_i"]
        if shuffle:     # each row's cells in a random order
            g = torch.Generator().manual_seed(13)
            perm = torch.argsort(torch.rand(bd.shape, generator=g),
                                 dim=1).cuda()
            bd, bi = bd.gather(1, perm), bi.gather(1, perm)
        args = (es["q"], bd, bi, es["vecs"], es["aux"], es["gph"], pen)
        kd, ki, hops, parents = tcf.fused_traverse_kernel(*args, **kw)
        kd2, ki2, hops2, parents2 = tcf.fused_traverse_kernel(*args, **kw)
        pd, pi = tcf.fused_traverse_plain(*args, **kw)
        torch.cuda.synchronize()
        what = (shape, width, kprime, itopk, hops_max, shuffle)
        assert torch.equal(kd, pd) and torch.equal(ki, pi), what
        assert torch.equal(kd.view(torch.int32), kd2.view(torch.int32))
        assert torch.equal(ki, ki2) and torch.equal(hops, hops2)
        assert torch.equal(parents, parents2)
        assert int(hops.max()) <= hops_max, what
        assert bool((parents <= hops * width).all()), what
        if shape.get("closed"):
            assert int(hops[::7].max()) < hops_max, what


def card_packed(mode, seed, integer, **kw):
    return {k: v.cuda() if torch.is_tensor(v) else v
            for k, v in packed_store(mode, seed, integer, **kw).items()}


# the packed forms' card shapes past the first ones: (integer, n, degree,
# deg_p, dim, m); the EDGE_SHAPES' wide stores, int4 at dim_p 256, 768
# and 1024 (its two 64-byte segments a chunk from two planes, and at 768
# a chunk across the planes' boundary)
PACKED_SHAPES = [EDGE_SHAPES[0], EDGE_SHAPES[1], EDGE_SHAPES[4],
                 EDGE_SHAPES[5], EDGE_SHAPES[6]]


@pytest.mark.cuda
@pytest.mark.parametrize("penalty", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_graph_expand_int4_kernel_on_card(metric, penalty):
    """K5's int4 form against its plain version: equal values and edge
    positions on integer nibbles with integer scales and on Gaussian
    queries with real scales, pad edges and penalties, k' below and at
    deg_p; then at PACKED_SHAPES (18,000 pairs; dim_p up to 1024)."""
    need_cuda()
    cases = [(integer, dict(), kout) for integer in (True, False)
             for kout in (1, 24, 64)]
    cases += [(integer, dict(n=n, degree=deg, deg_p=deg_p, dim=dim, m=m),
               deg_p) for integer, n, deg, deg_p, dim, m in PACKED_SHAPES]
    for integer, shape, kout in cases:
        es = card_packed("int4", 21, integer, **shape)
        pen = es["pen"] if penalty else None
        args = (es["parents"], es["q"], es["vecs"], es["aux"], kout, metric,
                es["degree"], pen, "int4")
        kv, ki = tge.graph_expand(*args)
        pv, pi = tge.graph_expand_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(kv, pv) and torch.equal(ki, pi), (shape, kout)


# pq: (dim, pq_dim, book) past dim 100 at pq_dim 16 and 64 (pq_len 8 and
# 2); dim_p 256 at pq_len 4, 768 at pq_len 12 and 48 (a lane's 4 dims
# within one subspace, the one-word decode), 384 at pq_len 6 (across a
# boundary inside a word)
PQ_CARD = [(100, 16, 256), (100, 64, 256), (200, 64, 128), (768, 64, 48),
           (768, 16, 40), (384, 64, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("penalty", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("lut", ["int8", "f32"])
def test_graph_expand_pq_kernel_on_card(lut, metric, penalty):
    """K5's pq form against its plain version, bit for bit: integer
    codebooks (int8 with scale 1, or float32 integers) with integer
    queries, and real ones with Gaussian queries; at pq_dim 16 and 64
    (pq_len 8 and 2), pq_len 4, 6, 12 and 48 (dim_p up to 768), smaller
    books, k' below and at deg_p, 9,000 queries; a codebook above the
    card's shared memory a block is refused."""
    need_cuda()
    for integer in (True, False):
        for dim, pq_dim, book in PQ_CARD:
            for kout, m in ((24, 96), (64, 96), (64, 9000)):
                if m > 96 and (dim, pq_dim) != (100, 16):
                    continue
                es = card_packed("pq", 31, integer, lut=lut, pq_dim=pq_dim,
                                 book=book, dim=dim, m=m)
                pen = es["pen"] if penalty else None
                args = (es["parents"], es["q"], es["vecs"], es["aux"], kout,
                        metric, es["degree"], pen, "pq", es["cb"],
                        es["cb_scale"])
                kv, ki = tge.graph_expand(*args)
                pv, pi = tge.graph_expand_plain(*args)
                torch.cuda.synchronize()
                what = (integer, dim, pq_dim, book, kout, m)
                assert torch.equal(kv, pv) and torch.equal(ki, pi), what
    es = card_packed("pq", 32, True, lut="f32", pq_dim=64, book=256,
                     dim=1000, m=8)
    with pytest.raises(RaftError, match="shared memory"):
        tge.graph_expand(es["parents"], es["q"], es["vecs"], es["aux"], 8,
                         mode="pq", cb=es["cb"], cb_scale=es["cb_scale"])


@pytest.mark.cuda
@pytest.mark.parametrize("penalty", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cagra_fused_int4_kernel_on_card(metric, penalty):
    """K6's int4 form against its plain version (max_iter edge hops on
    the plain int4 K5): equal buffers at width 1-3 and k' 1 and 16, on
    integer nibbles and Gaussian queries with real scales, from seeds
    shuffled out of order; then at PACKED_SHAPES with itopk 64 and 128
    and frontiers closing early; then where the dedup's ids repeat (400
    nodes), at width 1-3, k' 13 and deg_p, itopk 64 to 256. A second
    launch gives the same bits."""
    need_cuda()
    cases = [(integer, dict(), width, kprime, 32, shuffle)
             for integer, (width, kprime), shuffle in (
                 (True, (1, 16), False), (True, (3, 16), False),
                 (True, (2, 1), True), (False, (1, 16), False),
                 (False, (3, 16), True))]
    for (integer, n, deg, deg_p, dim, m), (width, itopk) in zip(
            PACKED_SHAPES, ((1, 64), (2, 128), (2, 64), (1, 64), (3, 64))):
        cases.append((integer, dict(n=n, degree=deg, deg_p=deg_p, dim=dim,
                                    m=m, closed=True),
                      width, min(deg_p, itopk), itopk, False))
    # the dedup's cases (n = 400: ids repeated within a row, across rows
    # and in the buffer): k' not a multiple of 4 beside earlier parents'
    # ids, k' = deg_p, the widest buffer (itopk 256)
    for integer, n, deg, deg_p, dim, m in EDGE_SHAPES[3:5]:
        for width, kprime, itopk in ((3, 13, 128), (2, deg_p, 256),
                                     (1, deg_p, 64)):
            cases.append((integer, dict(n=n, degree=deg, deg_p=deg_p,
                                        dim=dim, m=m),
                          width, kprime, itopk, integer))
    for integer, shape, width, kprime, itopk, shuffle in cases:
        es = card_packed("int4", 22, integer, itopk=itopk, **shape)
        pen = es["pen"] if penalty else None
        kw = dict(itopk=itopk, width=width, max_iter=10, kprime=kprime,
                  degree=es["degree"], metric=metric, mode="int4")
        bd, bi = es["buf_d"], es["buf_i"]
        if shuffle:
            g = torch.Generator().manual_seed(23)
            perm = torch.argsort(torch.rand(bd.shape, generator=g),
                                 dim=1).cuda()
            bd, bi = bd.gather(1, perm), bi.gather(1, perm)
        args = (es["q"], bd, bi, es["vecs"], es["aux"], es["gph"], pen)
        kd, ki, hops, _ = tcf.fused_traverse_kernel(*args, **kw)
        kd2, ki2, hops2, _ = tcf.fused_traverse_kernel(*args, **kw)
        pd, pi = tcf.fused_traverse_plain(*args, **kw)
        torch.cuda.synchronize()
        what = (integer, shape, width, kprime, itopk, shuffle)
        assert torch.equal(kd, pd) and torch.equal(ki, pi), what
        assert torch.equal(kd.view(torch.int32), kd2.view(torch.int32))
        assert torch.equal(ki, ki2) and torch.equal(hops, hops2)


@pytest.mark.cuda
@pytest.mark.parametrize("store", ["int4", "pq"])
def test_cagra_packed_stores_on_card(store):
    """The engine test's index with an int4 or pq store built on the
    card: the edge engine launches only that form of K5 (and int4's
    fused engine only K6's int4 form, equal to the edge engine); a fused
    search on the pq store raises."""
    need_cuda()
    x, q = (torch.from_numpy(a).cuda() for a in engine_test_data())
    idx = tcagra.build(x, tcagra.IndexParams(**ENGINE_TEST_BUILD))
    tcagra.prepare_traversal(idx, store)
    sp = tcagra.SearchParams(**ENGINE_TEST_SEARCH)
    before = (tge.launches, getattr(tge, f"launches_{store}"),
              tcf.launches, tcf.launches_int4)
    ev, ei = tcagra.search(idx, q, 10, sp, engine="edge")
    torch.cuda.synchronize()
    mid = (tge.launches, getattr(tge, f"launches_{store}"), tcf.launches,
           tcf.launches_int4)
    assert mid[0] - before[0] == mid[1] - before[1] > 0
    assert mid[2:] == before[2:]
    assert bool(((ei >= 0) & (ei < 4000)).all())
    if store == "pq":
        with pytest.raises(RaftError, match="no pq form"):
            tcagra.search(idx, q, 10, sp, engine="fused")
        return
    fv, fi = tcagra.search(idx, q, 10, sp, engine="fused")
    torch.cuda.synchronize()
    assert torch.equal(ei, fi) and torch.equal(ev, fv)
    assert (tcf.launches, tcf.launches_int4) == (mid[2] + 1, mid[3] + 1)


# the CAGRA engine test's data and plans, shared with the CPU test that
# reads the recall its floor rests on (test_torch_cagra.py)
ENGINE_TEST_BUILD = dict(intermediate_graph_degree=48, graph_degree=32)
ENGINE_TEST_SEARCH = dict(itopk_size=32, search_width=2)
ENGINE_TEST_FLOOR = 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d", [(200000, 1024, 128), (300, 7, 3),
                                   (64, 200, 4), (0, 5, 2)])
def test_segment_sum_on_card(n, k, d):
    """``cluster.kmeans.segment_sum`` on the card: exact in fixed point, so
    the same bits on a second call and as on the CPU, with empty
    segments."""
    from raft_tpu_torch.cluster.kmeans import segment_sum

    need_cuda()
    rng = np.random.default_rng(n + k)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, k, n))
    lab[lab == 3] = 2
    xc, lc = x.cuda(), lab.cuda()
    a, b = segment_sum(xc, lc, k), segment_sum(xc, lc, k)
    assert_bits_equal(a, b)
    assert_bits_equal(a.cpu(), segment_sum(x, lab, k))


@pytest.mark.cuda
def test_ivf_builds_are_reproducible_on_card():
    """Two IVF-Flat and two IVF-PQ builds of one tree in one process on the
    card are bit-equal: centers, list contents and order, codebooks and
    codes (the k-means and codebook sums are exact in fixed point,
    ``cluster.kmeans.segment_sum``, where a float ``index_add_`` adds
    with atomics)."""
    need_cuda()
    rng = np.random.default_rng(21)
    centers = rng.standard_normal((50, 32)).astype(np.float32)
    lab = rng.integers(0, 50, 30000)
    x = torch.from_numpy(centers[lab] + rng.standard_normal(
        (30000, 32)).astype(np.float32)).cuda()
    flat = [tivf.build(x, tivf.IndexParams(n_lists=64, seed=3))
            for _ in range(2)]
    pq = [tivfpq.build(x, tivfpq.IndexParams(n_lists=64, pq_dim=8,
                                             seed=3)) for _ in range(2)]
    torch.cuda.synchronize()
    a, b = flat
    assert_bits_equal(a.centers, b.centers)
    assert_bits_equal(a.data, b.data)
    assert torch.equal(a.source_ids, b.source_ids)
    assert np.array_equal(a.list_sizes, b.list_sizes)
    a, b = pq
    for t, u in ((a.centers_rot, b.centers_rot), (a.codebooks, b.codebooks),
                 (a.rotation, b.rotation)):
        assert_bits_equal(t, u)
    assert torch.equal(a.codes, b.codes)
    assert torch.equal(a.source_ids, b.source_ids)
    assert np.array_equal(a.list_sizes, b.list_sizes)


def engine_test_data():
    """(4000, 48) rows and (300, 48) queries, Gaussian, from seed 13."""
    rng = np.random.default_rng(13)
    return (rng.standard_normal((4000, 48)).astype(np.float32),
            rng.standard_normal((300, 48)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_cagra_engines_on_card(metric):
    """A CAGRA index built on the card: the edge (K5) and fused (K6)
    engines return equal ids and distances, through K2, K1, K5 and K6;
    they and the gather engine (bf16 rows, so another traversal) reach
    recall@10 >= ENGINE_TEST_FLOOR against brute force.
    ``test_torch_cagra.py::test_engine_test_data_recall`` holds the CPU
    build of this data (the plain K5, equal to the kernel) and the JAX
    package's gather engine above the floor with room to spare: the floor
    leaves room for the card's own build (other random numbers and float
    sums in another order than the CPU's), not for a wrong traversal."""
    need_cuda()
    x, q = (torch.from_numpy(a).cuda() for a in engine_test_data())
    idx = tcagra.build(x, tcagra.IndexParams(metric=metric,
                                             **ENGINE_TEST_BUILD))
    tcagra.prepare_traversal(idx)
    sp = tcagra.SearchParams(**ENGINE_TEST_SEARCH)
    ev, ei = tcagra.search(idx, q, 10, sp, engine="edge")
    fv, fi = tcagra.search(idx, q, 10, sp, engine="fused")
    gv, gi = tcagra.search(idx, q, 10, sp, engine="gather")
    torch.cuda.synchronize()
    assert torch.equal(ei, fi) and torch.equal(ev, fv)
    assert bool(((ei >= 0) & (ei < 4000)).all())
    _, ref = brute_force.search(brute_force.build(x, metric), q, 10)
    for ids in (ei, gi):
        assert neighborhood_recall(ids, ref) >= ENGINE_TEST_FLOOR


def merge_lists(m, w1, w2, seed, odd=False, pos_ties=False, above=False):
    """The six (m, w) lists of a merge_step: integer distances with ties
    inside rows and across the lists, unsorted; with ``odd`` NaN, -0.0
    against 0.0 and ±inf cells; positions distinct in a row, or drawn
    from 0-3 (``pos_ties``: ties of (key, position) within and across the
    lists), or with the running positions above the block's."""
    rng = np.random.default_rng(seed)
    w = w1 + w2
    d = rng.integers(0, 9, (m, w)).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = np.inf
    d[0] = np.inf
    if odd:
        d[d == 0] = np.where(rng.random(int((d == 0).sum())) < 0.5, 0.0,
                             -0.0)
        for v, share in ((np.nan, 0.08), (-np.inf, 0.05)):
            d[rng.random(d.shape) < share] = v
    if pos_ties:
        pos = rng.integers(0, 4, (m, w)).astype(np.int32)
    else:
        pos = np.stack([rng.permutation(w + 7)[:w]
                        for _ in range(m)]).astype(np.int32)
        if above:
            pos = -np.sort(-pos, axis=1)
    gid = rng.integers(0, 1 << 20, (m, w)).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in (d[:, :w1], pos[:, :w1], gid[:, :w1], d[:, w1:],
                      pos[:, w1:], gid[:, w1:])]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 16, 16, 16), (301, 10, 37, 20),
                                   (257, 100, 100, 100), (64, 3, 5, 8),
                                   (1, 10, 10, 10), (1001, 10, 10, 1),
                                   (999, 31, 7, 38), (77, 200, 56, 256),
                                   (33, 300, 300, 300), (1, 150, 40, 190),
                                   (5, 5000, 3000, 300), (9, 40, 0, 40)])
@pytest.mark.parametrize("select_min", [True, False])
def test_merge_step_kernel_on_card(shape, select_min):
    """K7 against its plain version, bit for bit: integer values with ties
    inside rows and across the lists, w1 != w2, k below and equal to
    w1 + w2, both forms (lists of up to 32 cells in lane groups, wider in
    shared memory, up to 8,000 cells a row), m = 1 and m not a multiple of
    the rows a block; unsorted lists with infinities, running positions
    above the block's; NaN, -0.0 and ±inf cells; ties of (key, position)
    broken by the concat index; a max merge (negated lists)."""
    need_cuda()
    m, w1, w2, k = shape
    for case in ("plain", "above", "odd", "pos_ties"):
        t = merge_lists(m, w1, w2, m + w1 + len(case), odd=case == "odd",
                        pos_ties=case == "pos_ties", above=case == "above")
        if not select_min:
            t[0], t[3] = -t[0], -t[3]
        before = trt.merge_step_launches
        got = trt.merge_step(*t, k, select_min)
        want = trt.merge_step_plain(*t, k, select_min)
        torch.cuda.synchronize()
        assert trt.merge_step_launches == before + 1
        assert_bits_equal(got[0], want[0])
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def ring_odd_cells(ds, seed):
    """The lists with -0.0 against 0.0 and NaN, -inf and +inf cells mixed
    in (the ring orders NaN after +inf; select_k would drop it)."""
    rng = np.random.default_rng(seed)
    out = []
    for d in ds:
        d = d.cpu().numpy().copy()
        z = d == 0
        d[z] = np.where(rng.random(int(z.sum())) < 0.5, 0.0, -0.0)
        for v, share in ((np.nan, 0.05), (-np.inf, 0.03), (np.inf, 0.05)):
            d[rng.random(d.shape) < share] = v
        out.append(torch.from_numpy(d).cuda())
    return out


def assert_bits_equal(a, b):
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 3, 4, 8, 16])
@pytest.mark.parametrize("k", [1, 10, 31, 64, 100, 256, 1024])
@pytest.mark.parametrize("select_min", [True, False])
def test_ring_topk_kernel_on_card(p, k, select_min):
    """K8 with p shards on one card against the plain ring and
    knn_merge_parts, on every shard's copy, each form of its row work
    (k <= 32 in lane groups, k <= 256 in registers, k > 256 in shared
    memory), at m = 1 (fewer rows than
    ring blocks), 3, 1001 and 10,000: an unsorted shard 0, ties across
    shards, a dead shard; and with -0.0 / NaN / ±inf cells against the
    plain ring bit for bit. Two calls back to back on one stream must
    both be right: no stale flag of the first reaches the second. (m =
    10,000 where p·k <= 4,096: the host-side fixtures of the widest cases
    would take most of the test's time.)"""
    need_cuda()
    mesh = Mesh(["cuda"] * p)
    for m in (1, 3, 1001) + ((10_000,) if p * k <= 4096 else ()):
        for integer in (True, False):
            seed = p * k if m == 1001 else p * k + m
            ds, gs = ring_parts(p, m, k, seed, select_min, integer, "cuda")
            odd = ring_odd_cells(ds, m + k)
            before = trt.ring_launches
            first = trt.ring_topk(ds, gs, k, select_min, mesh)
            second = trt.ring_topk(odd, gs, k, select_min, mesh)
            assert trt.ring_launches == before + 2
            plain = trt.ring_topk_plain(ds, gs, k, select_min, mesh)
            plain_odd = trt.ring_topk_plain(odd, gs, k, select_min, mesh)
            ref_d, ref_i = brute_force.knn_merge_parts(
                torch.stack(ds).cpu(), torch.stack(gs).cpu(), select_min)
            torch.cuda.synchronize()
            for r in range(p):
                assert torch.equal(first[0][r], plain[0][r])
                assert torch.equal(first[1][r], plain[1][r])
                assert torch.equal(first[0][r].cpu(), ref_d)
                assert torch.equal(first[1][r].cpu(), ref_i)
                assert_bits_equal(second[0][r], plain_odd[0][r])
                assert torch.equal(second[1][r], plain_odd[1][r])
    # the engines of merge, and the default engine, on the same shards
    ds, gs = ring_parts(p, 1001, k, p * k, select_min, True, "cuda")
    assert trt.resolve_engine(1001, k, p, mesh=mesh) == "ring_pallas"
    ref_d, ref_i = brute_force.knn_merge_parts(
        torch.stack(ds).cpu(), torch.stack(gs).cpu(), select_min)
    for eng in trt.ENGINES if k <= 100 else ("ring_pallas",):
        md, mg = trt.merge(ds, gs, k, select_min, mesh, engine=eng)
        torch.cuda.synchronize()
        assert all(torch.equal(a.cpu(), ref_d) for a in md)
        assert all(torch.equal(a.cpu(), ref_i) for a in mg)


@pytest.mark.cuda
def test_ring_topk_kernel_refuses_what_it_cannot_hold():
    """k above RING_MAX_K: not ring_capable, so the default engine is
    allgather and an explicit ring_pallas raises."""
    need_cuda()
    k = trt.RING_MAX_K + 1
    mesh = Mesh(["cuda"] * 2)
    ds, gs = ring_parts(2, 8, k, 0, device="cuda")
    assert not trt.ring_capable(8, k, mesh)
    assert trt.resolve_engine(8, k, 2, mesh=mesh) == "allgather"
    with pytest.raises(RaftError):
        trt.merge(ds, gs, k, True, mesh, engine="ring_pallas")


@pytest.mark.cuda
@pytest.mark.parametrize("per_card", [1, 2])
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("select_min", [True, False])
def test_ring_topk_kernel_across_cards(per_card, k, select_min):
    """K8's cross-card mode: one shard a card, or shards alternating over
    the cards (every neighbour on another card), one launch per card,
    peer memory for the neighbours' slots; against the plain ring and
    knn_merge_parts on the CPU."""
    need_cuda()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("the cross-card ring needs at least 2 cards")
    mesh = Mesh([f"cuda:{r % n}" for r in range(per_card * n)])
    if not trt.ring_capable(1001, k, mesh):
        pytest.skip("these cards have no peer access to each other")
    # unrun until this test passes: the default keeps to one card
    assert trt.resolve_engine(1001, k, mesh.size, mesh=mesh) == "allgather"
    ds, gs = ring_parts(mesh.size, 1001, k, 9 + k, select_min)
    want = trt.ring_topk_plain(ds, gs, k, select_min,
                               Mesh(["cpu"] * mesh.size))
    ref_d, ref_i = brute_force.knn_merge_parts(torch.stack(ds),
                                               torch.stack(gs), select_min)
    ds = [d.to(dev) for d, dev in zip(ds, mesh.devices)]
    gs = [g.to(dev) for g, dev in zip(gs, mesh.devices)]
    before = trt.ring_launches
    out_d, out_g = trt.ring_topk(ds, gs, k, select_min, mesh)
    assert trt.ring_launches == before + n
    assert torch.cuda.current_device() == 0
    for r, (d, g) in enumerate(zip(out_d, out_g)):
        assert d.device == mesh.devices[r]
        assert torch.equal(d.cpu(), want[0][r]) and torch.equal(
            g.cpu(), want[1][r])
        assert torch.equal(d.cpu(), ref_d) and torch.equal(g.cpu(), ref_i)


def race_data(n: int, m: int, d: int = 32, seed: int = 21):
    """Rows and queries in 40 Gaussian clusters (the race and the chunked
    searches need neighbours that an approximate graph can find)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((40, d)).astype(np.float32) * 3
    x = centers[rng.integers(0, 40, n)] + rng.standard_normal(
        (n, d)).astype(np.float32)
    q = centers[rng.integers(0, 40, m)] + rng.standard_normal(
        (m, d)).astype(np.float32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(q).cuda()


@pytest.mark.cuda
def test_cagra_search_in_chunks_on_card():
    """A CAGRA search in chunks of 1,024 queries on the card (each chunk
    its own random seed rows, one K6 launch a chunk): recall@10 within
    0.01 of the unchunked search's; a chunk of the whole batch is the
    unchunked search, bit for bit."""
    need_cuda()
    x, q = race_data(20_000, 3000)
    idx = tcagra.build(x, tcagra.IndexParams(intermediate_graph_degree=64,
                                              graph_degree=32,
                                              knn_graph_algo="brute"))
    sp = tcagra.SearchParams(itopk_size=64)
    _, ref = brute_force.search(brute_force.build(x), q, 10)
    wd, wi = tcagra.search(idx, q, 10, sp, engine="fused")
    before = tcf.launches
    _, ci = tcagra.search(idx, q, 10, sp, engine="fused", query_chunk=1024)
    assert tcf.launches - before == 3
    assert abs(neighborhood_recall(ci, ref)
               - neighborhood_recall(wi, ref)) <= 0.01
    d, i = tcagra.search(idx, q, 10, sp, engine="fused", query_chunk=3000)
    torch.cuda.synchronize()
    assert torch.equal(d, wd) and torch.equal(i, wi)


@pytest.mark.cuda
def test_graph_race_on_card():
    """The kNN-graph builders' race on 20,000 rows on the card: every
    builder runs, the verdict is the rule's on the race's own readings,
    recorded under the build's own key, and an ``auto`` build runs it."""
    from raft_tpu_torch.bench import graph_race_winner, race_graph_build
    from raft_tpu_torch.distance.distance_types import canonical_metric

    need_cuda()
    x, _ = race_data(20_000, 1)
    winner, secs, recs = race_graph_build(x, 32, "sqeuclidean")
    assert set(secs) == {"brute", "ivf_pq", "nn_descent"}
    assert recs["brute"] == 1.0 and winner == graph_race_winner(secs, recs)
    key = tcagra._graph_algo_key(20_000, 32, 32,
                                 canonical_metric("sqeuclidean"), x.device)
    assert autotune.lookup(key) == winner
    idx = tcagra.build(x, tcagra.IndexParams(intermediate_graph_degree=32,
                                              graph_degree=16))
    assert idx.build_stats["knn_algo"] == winner


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["brute_force", "ivf_flat", "ivf_flat_int8",
                                    "ivf_pq", "cagra"])
def test_save_load_on_card(tmp_path, family):
    """An index built on the card, saved, and loaded back onto the card
    searches bit-equal through the kernels (K2, K3, K4, K6; the launch
    counters move) to the index it was saved from. The loaded IVF lists
    are packed with no slack, so list starts fall off multiples of 8
    where the built ones sit on them: K3 and K4 take both. IVF-Flat runs
    on integer-valued rows, where K3's float32 form also equals its plain
    version."""
    need_cuda()
    if family.startswith("ivf_flat"):
        rng = np.random.default_rng(23)
        x = torch.from_numpy(rng.integers(-8, 9, (20_000, 32)).astype(
            np.float32)).cuda()
        q = torch.from_numpy(rng.integers(-3, 4, (500, 32)).astype(
            np.float32)).cuda()
    else:
        x, q = race_data(20_000, 500)
    mod, counter, build, search = {
        "brute_force": (brute_force, (tfk, "launches"),
                        lambda: brute_force.build(x),
                        lambda i, **kw: brute_force.search(i, q, 10)),
        "ivf_flat": (tivf, (tis, "launches"),
                     lambda: tivf.build(x, tivf.IndexParams(n_lists=64)),
                     lambda i, algo="auto": tivf.search(
                         i, q, 10, tivf.SearchParams(n_probes=8),
                         algo=algo)),
        "ivf_flat_int8": (tivf, (tis, "launches_int8"),
                          lambda: tivf.build(x, tivf.IndexParams(
                              n_lists=64, dtype="int8")),
                          lambda i, algo="auto": tivf.search(
                              i, q, 10, tivf.SearchParams(n_probes=8),
                              algo=algo)),
        "ivf_pq": (tivfpq, (tpq, "launches"),
                   lambda: tivfpq.build(x, tivfpq.IndexParams(n_lists=64,
                                                              pq_dim=16)),
                   lambda i, **kw: tivfpq.search(
                       i, q, 20, tivfpq.SearchParams(n_probes=8))),
        "cagra": (tcagra, (tcf, "launches"),
                  lambda: tcagra.build(x, tcagra.IndexParams(
                      intermediate_graph_degree=64, graph_degree=32,
                      knn_graph_algo="brute")),
                  lambda i, **kw: tcagra.search(
                      i, q, 10, tcagra.SearchParams(itopk_size=64),
                      engine="fused")),
    }[family]
    idx = build()
    want = search(idx)
    mod.save(idx, tmp_path / "index.bin")
    loaded = mod.load(tmp_path / "index.bin")
    assert loaded.device.type == "cuda"
    before = getattr(*counter)
    got = search(loaded)
    torch.cuda.synchronize()
    assert getattr(*counter) > before
    assert_bits_equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    if family.startswith("ivf"):
        assert (idx.list_offsets % 8 == 0).all()
        starts = loaded.list_offsets[:-1][loaded.list_sizes > 0]
        assert (starts % 8 != 0).any()
    if family == "ivf_flat":
        plain = search(loaded, algo="plain")
        assert_bits_equal(got[0], plain[0])
        assert torch.equal(got[1], plain[1])


def pq_store_per_cluster(integer: bool, seed: int, **shape):
    """:func:`pq_store` with per-cluster codebooks: one (book, pq_len)
    codebook a list, (lists, book, pq_len) — small integers or Gaussian
    values — and the decoded row norms through each row's list's
    codebook."""
    st = pq_store(integer, seed, **shape)
    rng = np.random.default_rng(seed + 500)
    lists = st["centers_rot"].shape[0]
    _, book, pq_len = st["codebooks"].shape
    gen = ((lambda s: rng.integers(-3, 4, s)) if integer
           else rng.standard_normal)
    st["codebooks"] = torch.from_numpy(
        gen((lists, book, pq_len)).astype(np.float32))
    st["row_norms"] = tpq.decoded_row_norms(
        st["codes"], st["centers_rot"], st["codebooks"],
        st["list_offsets"], per_cluster=True)
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ivf_pq_scan_per_cluster_on_card(mode, metric):
    """K4's per-cluster form (the grouped kernel at k = 20 and 257, the
    wide plan at 1,025) + the K1 merge against the plain version's
    per-cluster decode, with the penalty row and an empty list: equal on
    small-integer codebooks and queries, close on Gaussian ones (k = 20
    slot by slot; 257 and 1,025 values slot by slot, ids as sets); two
    launches bit-equal; every launch counted as per-cluster; the per-pair
    form refuses per-cluster codebooks."""
    need_cuda()
    for integer in (True, False):
        st = pq_store_per_cluster(integer, 31, n=12000, pq_dim=16,
                                  pq_len=2, lists=16, m=300, p=4)
        args = pq_scan_args(st, mode, "cuda")
        pen = st["penalty"].cuda()
        for k in (20, 257, 1025):
            before = (tpq.per_cluster_launches, tpq.group_launches)
            kv, ki = tpq.ivf_pq_scan(*args, k, metric, pen, form="group",
                                     per_cluster=True)
            kv2, ki2 = tpq.ivf_pq_scan(*args, k, metric, pen,
                                       per_cluster=True)
            pv, pi = tpq.ivf_pq_scan_plain(*args, k, metric, pen,
                                           per_cluster=True)
            torch.cuda.synchronize()
            assert (tpq.per_cluster_launches - before[0],
                    tpq.group_launches - before[1]) == (2, 2)
            assert_bits_equal(kv, kv2)
            assert torch.equal(ki, ki2)
            if integer:
                assert torch.equal(kv, pv) and torch.equal(ki, pi), k
            elif k > GAUSSIAN_MAX_K:
                assert_knn_sets_close(pv.cpu(), pi.cpu(), kv.cpu(),
                                      ki.cpu())
            else:
                assert_knn_close(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu())
        with pytest.raises(RaftError, match="per-pair"):
            tpq.ivf_pq_scan(*args, 20, metric, pen, form="pair",
                            per_cluster=True)


def _relayout(arrays, fills, offsets, sizes, growth):
    """The lists of a layout laid out again with ``growth`` slack: the
    same rows in the same order a list, at other offsets."""
    from raft_tpu_torch.neighbors import _list_layout as ll

    dense = ll.gather_dense(arrays, offsets, sizes)
    labels = ll.span_labels(sizes, dense[0].device)
    out, offs, szs = ll.scatter_build(labels, dense, fills, len(sizes),
                                      growth)
    assert np.array_equal(szs, sizes)
    return out, offs


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ivf_flat", "ivf_pq", "ivf_pq_cluster"])
def test_ivf_scans_on_slack_layout(family):
    """K3 and K4 (per-subspace and per-cluster codebooks) on the lists of
    an index built on the card with no slack, laid out again with
    ``list_growth`` 1.5 (starts further apart, slack rows of code 0 / id
    -1 between them): every search bit-equal to the dense layout's, at k
    = 10 and at 1,025 (the wide plans, which size their scratch by the
    longest list), the row norms recomputed on the new layout."""
    need_cuda()
    x, q = race_data(20_000, 500)
    if family == "ivf_flat":
        idx = tivf.build(x, tivf.IndexParams(n_lists=32))
        (data, dn, ids), offs = _relayout(
            [idx.data, idx.data_norms, idx.source_ids], [0, 0.0, -1],
            idx.list_offsets, idx.list_sizes, 1.5)
        slack = tivf.Index(data, dn, ids, idx.centers, idx.center_norms,
                           offs, idx.list_sizes, idx.metric, None, 1.5)
        search = lambda i, k: tivf.search(  # noqa: E731
            i, q, k, tivf.SearchParams(n_probes=8))
    else:
        kind = (tivfpq.CodebookGen.PER_CLUSTER if family.endswith("cluster")
                else tivfpq.CodebookGen.PER_SUBSPACE)
        idx = tivfpq.build(x, tivfpq.IndexParams(n_lists=32, pq_dim=16,
                                                 codebook_kind=kind))
        (codes, ids), offs = _relayout([idx.codes, idx.source_ids], [0, -1],
                                       idx.list_offsets, idx.list_sizes,
                                       1.5)
        slack = tivfpq.Index(codes, ids, idx.centers_rot, idx.codebooks,
                             idx.rotation, offs, idx.list_sizes, idx.metric,
                             idx.pq_bits, kind, 1.5)
        search = lambda i, k: tivfpq.search(  # noqa: E731
            i, q, k, tivfpq.SearchParams(n_probes=8,
                                         lut_dtype=torch.float32))
    assert offs[-1] > idx.list_offsets[-1]
    for k in (10, 1025):
        want, got = search(idx, k), search(slack, k)
        torch.cuda.synchronize()
        assert_bits_equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["brute_force", "ivf_flat", "cagra"])
@pytest.mark.parametrize("integer", [False, True])
def test_crossover_equals_the_filtered_k2_search_on_card(family, integer):
    """The crossover (500 of 20,000 rows survive) of brute force, IVF-Flat
    and CAGRA against K2 over every row with the filter's penalty (brute
    force under ``suspended()``): K2 on the compacted rows sums each pair
    as over the whole corpus, and ties go to the lowest id in both, so
    ids and values are equal; on Gaussian rows the ids on >= 99.9% of
    the rows and the values to rtol 1e-5 (the contract held by
    ``chip_smoke.py``)."""
    from raft_tpu_torch.core.bitset import Bitset
    from raft_tpu_torch.ops import filter_policy as tfp

    need_cuda()
    if integer:
        rng = np.random.default_rng(29)
        x = torch.from_numpy(rng.integers(-8, 9, (20_000, 32)).astype(
            np.float32)).cuda()
        q = torch.from_numpy(rng.integers(-3, 4, (500, 32)).astype(
            np.float32)).cuda()
    else:
        x, q = race_data(20_000, 500)
    keep = np.zeros(20_000, bool)
    keep[np.random.default_rng(30).choice(20_000, 500, replace=False)] = True
    filt = Bitset.from_mask(torch.from_numpy(keep).cuda())
    bidx = brute_force.build(x)
    with tfp.suspended():
        want = brute_force.search(bidx, q, 10, filter=filt)
    idx = {"brute_force": lambda: bidx,
           "ivf_flat": lambda: tivf.build(x, tivf.IndexParams(n_lists=32)),
           "cagra": lambda: tcagra.build(x, tcagra.IndexParams(
               intermediate_graph_degree=32, graph_degree=16,
               knn_graph_algo="brute"))}[family]()
    search = {"brute_force": lambda: brute_force.search(idx, q, 10,
                                                        filter=filt),
              "ivf_flat": lambda: tivf.search(idx, q, 10, filter=filt),
              "cagra": lambda: tcagra.search(idx, q, 10, filter=filt)}
    before = tfk.launches
    got = search[family]()
    torch.cuda.synchronize()
    assert tfk.launches > before
    if integer:
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    else:
        assert_knn_close(want[0].cpu(), want[1].cpu(), got[0].cpu(),
                         got[1].cpu(), min_rows_equal=0.999)


@pytest.mark.cuda
def test_select_k_auto_keeps_k1_after_a_topk_verdict():
    """A ``tune_select_k`` verdict for ``torch.topk`` steers nothing:
    ``select_k``'s AUTO launches K1 on a CUDA tensor."""
    need_cuda()
    winner, times = tsk.tune_select_k(64, 4096, 10, reps=2)
    assert set(times) == {"kpass", "topk"}
    autotune.record(autotune.shape_bucket("select_k", "cuda", n=4096,
                                          k=10), "topk")
    x = torch.randn(64, 4096, device="cuda")
    before = tsk.launches
    v, i = tsk.select_k(x, 10)
    torch.cuda.synchronize()
    assert tsk.launches == before + 1
    pv, pi = tsk.select_k_plain(x, 10)
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.cuda
def test_brute_force_tune_search_races_k2_and_scan_on_card():
    """The race launches K2 and the scan engine's K1 and records one of
    the two; the plain "matmul" engine never runs, and ``auto`` launches
    K2 after a "scan" verdict."""
    need_cuda()
    x, q = race_data(20_000, 500)
    idx = brute_force.build(x)
    before = tfk.launches
    winner, times = brute_force.tune_search(idx, q, 10, reps=2)
    assert set(times) == {"pallas", "scan"} and winner in times
    assert tfk.launches > before
    key = brute_force._tune_key(idx, 500, 10)
    assert autotune.lookup(key) == winner
    autotune.record(key, "scan")
    before = tfk.launches
    brute_force.search(idx, q, 10)
    assert tfk.launches > before


def _streamed_pair(family: str):
    """An IVF index built on the card (20,000 x 32 Gaussian rows, distinct
    distances, in 64 lists), its resident search, and a copy streamed
    from the host in at least two chunks: (module, resident index,
    streamed index, search, launch counter)."""
    x, q = race_data(20_000, 500, seed=29)
    if family == "ivf_flat":
        mod, counter = tivf, tis
        build = lambda: tivf.build(x, tivf.IndexParams(n_lists=64))  # noqa: E731
        search = lambda i, **kw: tivf.search(  # noqa: E731
            i, q, 10, tivf.SearchParams(n_probes=8), **kw)
        budget, chunk_mb = 20_000 * 136 * 0.3 / 2**30, 0.4
    else:
        mod, counter = tivfpq, tpq
        build = lambda: tivfpq.build(x, tivfpq.IndexParams(  # noqa: E731
            n_lists=64, pq_dim=16))
        search = lambda i, **kw: tivfpq.search(  # noqa: E731
            i, q, 20, tivfpq.SearchParams(n_probes=8), **kw)
        budget, chunk_mb = 20_000 * 28 * 0.3 / 2**30, 0.1
    idx, streamed = build(), build()
    mod.prepare_host_stream(streamed, budget_gb=budget, chunk_mb=chunk_mb)
    assert streamed.host_tier is not None
    assert len(streamed.host_tier.chunks) >= 2
    return mod, idx, streamed, search, counter


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ivf_flat", "ivf_pq"])
def test_host_stream_scans_each_chunk_on_card(family):
    """A host-streamed search launches K3 / K4 once for the resident lists
    and once for each cold chunk its probes touch, from pinned chunks, and
    equals the resident search bit for bit; with each chunk copied and
    scanned twice in a row (the other buffer each time) it is the
    same."""
    need_cuda()
    mod, idx, streamed, search, counter = _streamed_pair(family)
    tier = streamed.host_tier
    assert tier.pinned and all(t.is_pinned() for ch in tier.chunks
                               for t in ch.arrays.values())
    want = search(idx)
    before, chunks = counter.launches, tier.streamed_chunks
    got = search(streamed)
    torch.cuda.synchronize()
    touched = tier.streamed_chunks - chunks
    assert touched >= 2
    assert counter.launches - before == 1 + touched
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    tier.passes = 2
    before = counter.launches
    twice = search(streamed)
    torch.cuda.synchronize()
    tier.passes = 1
    assert counter.launches - before == 1 + 2 * touched
    assert torch.equal(got[0], twice[0]) and torch.equal(got[1], twice[1])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ivf_flat", "ivf_pq"])
def test_host_stream_scan_failure_raises_on_card(family, monkeypatch):
    """With the scan kernel's entry made to fail, a streamed search on the
    card raises; no plain version serves a chunk."""
    need_cuda()
    mod, idx, streamed, search, counter = _streamed_pair(family)

    def broken(*a, **kw):
        raise RaftError("injected kernel failure")

    def plain(*a, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    if family == "ivf_flat":
        monkeypatch.setattr(tis, "ivf_flat_scan_candidates", broken)
        monkeypatch.setattr(tis, "ivf_flat_scan_plain", plain)
        monkeypatch.setattr(tivf, "ivf_flat_scan_plain", plain)
    else:
        monkeypatch.setattr(tpq, "ivf_pq_scan_candidates", broken)
        monkeypatch.setattr(tpq, "ivf_pq_scan_plain", plain)
        monkeypatch.setattr(tivfpq, "ivf_pq_scan_plain", plain)
    with pytest.raises(RaftError, match="injected kernel failure"):
        search(streamed)


@pytest.mark.cuda
def test_mutable_search_launches_kernels_on_card(tmp_path, monkeypatch):
    """A mutable IVF-Flat search on the card (tombstones in the sealed
    segment, a delta) launches K3, K2 and K1 and no plain version, and
    holds to the exact answer over the live rows (every list probed)."""
    need_cuda()
    from raft_tpu_torch.neighbors import mutable

    def plain(*a, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    x, q = race_data(20_300, 200, seed=31)
    x = x.cpu().numpy()
    x, up = x[:20_000], x[20_000:]
    m = mutable.create(tmp_path / "m", x, family="ivf_flat",
                       family_params={"n_lists": 64})
    m.upsert(None, up)
    m.delete(np.arange(0, 20_000, 7))
    for mod, name in ((tis, "ivf_flat_scan_plain"),
                      (tivf, "ivf_flat_scan_plain"),
                      (tfk, "fused_knn_plain"),
                      (brute_force, "fused_knn_plain")):
        monkeypatch.setattr(mod, name, plain)
    before = (tis.launches, tfk.launches, tsk.launches)
    v, i = m.search(q, 10, tivf.SearchParams(n_probes=64))
    torch.cuda.synchronize()
    after = (tis.launches, tfk.launches, tsk.launches)
    assert all(b > a for a, b in zip(before, after)), (before, after)
    keep = np.ones(20_000, bool)
    keep[::7] = False
    live = np.concatenate([x[keep], up])
    ids = np.concatenate([np.flatnonzero(keep), 20_000 + np.arange(300)])
    ev, ei = brute_force.search(brute_force.build(torch.from_numpy(live)),
                                q, 10)
    ext = torch.from_numpy(ids)[ei.cpu().long()].to(torch.int32)
    assert_knn_close(ev.cpu(), ext, v.cpu(), i.cpu())
