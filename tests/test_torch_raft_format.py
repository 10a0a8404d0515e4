"""RAFT-native index files in the PyTorch port
(``raft_tpu_torch.core.raft_format``) against the JAX package's
(``raft_tpu.core.raft_format``): the interleaved list codecs (rows at
veclen 1, 4 and 16; PQ bitfields at 4-8 bits), each ``save_raft_*``
byte for byte against JAX's on the same index (JAX's writers are pinned
to RAFT's C++ wire format by ``tests/test_raft_format.py::
TestReferenceWireFormat``), JAX-written RAFT files loaded and searched
by the port, and int8 / uint8 / veclen-1 IVF-Flat files written frame by
frame with that module's independent encoder (the int8 one loaded with
unit row scales).

Tolerances. IVF-Flat and CAGRA run on integer-valued rows and queries,
so distances are exact in float32: values and ids equal (JAX: IVF-Flat
``algo="xla"``, CAGRA's gather engine at float32 candidates with JAX's
random seed rows injected). IVF-PQ: ``assert_knn_close`` at rtol 1e-4,
ids on >= 98% of the rows (``tests/test_torch_ivf_pq.py``'s). A round
trip in the port searches bit-equal.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import raft_format as jrf
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import convert
from raft_tpu_torch.core import raft_format as rf
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq
from raft_tpu_torch.ops import autotune
from test_raft_format import cxx_mdspan, cxx_scalar, interleave_flat_cxx
from test_torch_kernels import assert_knn_close

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _verdicts_in_memory():
    """No autotune verdict file: this module's verdicts stay in memory, and
    none is read from the user's cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TPU_TORCH_AUTOTUNE_CACHE", "")
        mp.setattr(autotune, "_MEM_CACHE", {})
        mp.setattr(autotune, "_LOADED_FROM", None)
        yield


def test_verdicts_stay_in_memory():
    assert autotune.cache_path() is None


N, D, M, K, N_LISTS, N_PROBES = 800, 32, 40, 5, 8, 3


@pytest.fixture(scope="module")
def ints():
    """Integer-valued rows and queries: every distance exact in f32."""
    rng = np.random.default_rng(21)
    return (rng.integers(-8, 9, (N, D)).astype(np.float32),
            rng.integers(-3, 4, (M, D)).astype(np.float32))


def _raw(save, index, **kw) -> bytes:
    buf = io.BytesIO()
    save(index, buf, **kw)
    return buf.getvalue()


def _equal(a, b) -> None:
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


def _bits(a, b) -> None:
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])


# ------------------------------------------------------------------ codecs

@pytest.mark.parametrize("dtype,dim,veclen", [
    (np.float32, 6, 1), (np.float32, 12, 4), (np.int8, 32, 16),
    (np.uint8, 48, 16)])
@pytest.mark.parametrize("size", [5, 32, 37])
def test_interleaved_rows_match_jax(dtype, dim, veclen, size):
    rng = np.random.default_rng(size)
    rows = rng.integers(-100, 100, (size, dim)).astype(dtype)
    packed = rf._pack_interleaved_rows(rows, veclen)
    np.testing.assert_array_equal(packed,
                                  jrf._pack_interleaved_rows(rows, veclen))
    padded = np.zeros((packed.shape[0] * 32, dim), dtype)
    padded[:size] = rows
    np.testing.assert_array_equal(packed.reshape(-1, dim),
                                  interleave_flat_cxx(padded, veclen))
    np.testing.assert_array_equal(rf._unpack_interleaved_rows(packed, size),
                                  rows)
    np.testing.assert_array_equal(
        rf._unpack_interleaved_rows(packed, size),
        jrf._unpack_interleaved_rows(packed, size))


@pytest.mark.parametrize("pq_bits", [4, 5, 6, 7, 8])
def test_interleaved_pq_match_jax(pq_bits):
    rng = np.random.default_rng(pq_bits)
    codes = rng.integers(0, 1 << pq_bits, (71, 29)).astype(np.uint8)
    packed = rf._pack_interleaved_pq(codes, pq_bits)
    np.testing.assert_array_equal(packed,
                                  jrf._pack_interleaved_pq(codes, pq_bits))
    np.testing.assert_array_equal(
        rf._unpack_interleaved_pq(packed, 71, 29, pq_bits), codes)
    np.testing.assert_array_equal(
        jrf._unpack_interleaved_pq(packed, 71, 29, pq_bits), codes)


# ------------------------------------------------------------------ IVF-PQ

@pytest.mark.parametrize("pq_bits,pq_dim,metric", [
    (4, 8, "sqeuclidean"), (5, 7, "inner_product"), (8, 8, "sqeuclidean")])
def test_ivf_pq_file(pq_bits, pq_dim, metric):
    rng = np.random.default_rng(pq_bits)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((64, D)).astype(np.float32)
    jidx = jpq.build(jnp.asarray(x), jpq.IndexParams(
        n_lists=N_LISTS, pq_bits=pq_bits, pq_dim=pq_dim, metric=metric,
        seed=0))
    carried = convert.ivf_pq_index_from_numpy(
        {"codes": np.asarray(jidx.codes),
         "source_ids": np.asarray(jidx.source_ids),
         "centers_rot": np.asarray(jidx.centers_rot),
         "codebooks": np.asarray(jidx.codebooks),
         "rotation": np.asarray(jidx.rotation),
         "list_offsets": jidx.list_offsets,
         "list_sizes_arr": jidx.list_sizes_arr, "metric": jidx.metric.value,
         "pq_bits": pq_bits}, device="cpu")
    jraw = _raw(jrf.save_raft_ivf_pq, jidx)
    assert _raw(rf.save_raft_ivf_pq, carried) == jraw

    loaded = rf.load_raft_ivf_pq(io.BytesIO(jraw), device="cpu")
    assert (loaded.size, loaded.pq_bits, loaded.pq_dim) == (N, pq_bits,
                                                            pq_dim)
    assert loaded.codes.is_contiguous()
    jv, ji = jpq.search(jrf.load_raft_ivf_pq(io.BytesIO(jraw)),
                        jnp.asarray(q), K,
                        jpq.SearchParams(N_PROBES, lut_dtype=jnp.float32),
                        algo="xla")
    sp = ivf_pq.SearchParams(N_PROBES, lut_dtype=torch.float32)
    tv, ti = ivf_pq.search(loaded, torch.from_numpy(q), K, sp)
    assert_knn_close(np.asarray(jv), np.asarray(ji), tv.numpy(),
                     ti.numpy(), rtol=1e-4, min_rows_equal=0.98)
    _bits(ivf_pq.search(carried, torch.from_numpy(q), K, sp), (tv, ti))


# ---------------------------------------------------------------- IVF-Flat

def test_ivf_flat_file(ints):
    x, q = ints
    jidx = jivf.build(jnp.asarray(x), jivf.IndexParams(n_lists=N_LISTS,
                                                       seed=0))
    arrays = {f: np.asarray(getattr(jidx, f)) for f in (
        "data", "data_norms", "source_ids", "centers", "center_norms",
        "list_offsets", "list_sizes_arr")}
    carried = convert.ivf_flat_index_from_numpy(dict(arrays,
                                                     metric=jidx.metric),
                                                device="cpu")
    jraw = _raw(jrf.save_raft_ivf_flat, jidx)
    assert _raw(rf.save_raft_ivf_flat, carried) == jraw

    loaded = rf.load_raft_ivf_flat(io.BytesIO(jraw), device="cpu")
    assert loaded.store_name == "float32" and loaded.size == N
    sp = ivf_flat.SearchParams(n_probes=N_PROBES)
    want = ivf_flat.search(carried, q, K, sp)
    _equal(jivf.search(jrf.load_raft_ivf_flat(io.BytesIO(jraw)), q, K,
                       jivf.SearchParams(n_probes=N_PROBES), algo="xla"),
           want)
    _bits(ivf_flat.search(loaded, q, K, sp), want)

    tidx = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=N_LISTS),
                          device="cpu")
    back = rf.load_raft_ivf_flat(io.BytesIO(_raw(rf.save_raft_ivf_flat,
                                                 tidx)), device="cpu")
    _bits(ivf_flat.search(back, q, K, sp), ivf_flat.search(tidx, q, K, sp))
    bf16 = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=N_LISTS,
                                                  dtype="bfloat16"),
                          device="cpu")
    with pytest.raises(RaftError, match="only float32"):
        rf.save_raft_ivf_flat(bf16, io.BytesIO())


def _flat_file(rows, labels, centers, tag: bytes) -> bytes:
    """A RAFT IVF-Flat (version 4) stream written frame by frame with the
    independent encoder of ``tests/test_raft_format.py``."""
    n, dim = rows.shape
    n_lists = len(centers)
    veclen = max(1, 16 // rows.dtype.itemsize)
    if dim % veclen:
        veclen = 1
    sizes = np.bincount(labels, minlength=n_lists)
    blob = tag
    blob += cxx_scalar(4, np.int32) + cxx_scalar(n, np.int64)
    blob += cxx_scalar(dim, np.uint32) + cxx_scalar(n_lists, np.uint32)
    blob += cxx_scalar(0, np.int32)                  # L2Expanded
    blob += cxx_scalar(0, np.uint8) + cxx_scalar(0, np.uint8)
    blob += cxx_mdspan(centers)
    blob += cxx_scalar(0, np.uint8)                  # no center norms
    blob += cxx_mdspan(sizes.astype(np.uint32))
    for li in range(n_lists):
        members = np.flatnonzero(labels == li)
        rounded = -(-len(members) // 32) * 32
        blob += cxx_scalar(rounded, np.uint32)
        if not len(members):
            continue
        padded = np.zeros((rounded, dim), rows.dtype)
        padded[: len(members)] = rows[members]
        blob += cxx_mdspan(interleave_flat_cxx(padded, veclen))
        inds = np.full(rounded, -1, np.int64)
        inds[: len(members)] = members
        blob += cxx_mdspan(inds)
    return blob


@pytest.mark.parametrize("dtype,dim,tag", [
    (np.int8, 32, b"|i1\0"), (np.uint8, 32, b"|u1\0"),
    (np.float32, 6, b"<f4\0")])
def test_reference_ivf_flat_files(dtype, dim, tag):
    """int8 (raw rows, no scales: the port's index gets unit scales),
    uint8 and a float32 file at veclen 1: the port's index holds JAX's
    loaded rows and searches equal to it."""
    rng = np.random.default_rng(dim)
    n, n_lists = 300, 5
    lo, hi = (0, 256) if dtype == np.uint8 else (-20, 21)
    rows = rng.integers(lo, hi, (n, dim)).astype(dtype)
    q = rng.integers(lo, hi, (M, dim)).astype(np.float32)
    labels = rng.integers(0, n_lists, n)
    labels[labels == 3] = 2                          # an empty list
    centers = rng.integers(lo, hi, (n_lists, dim)).astype(np.float32)
    blob = _flat_file(rows, labels, centers, tag)
    jidx = jrf.load_raft_ivf_flat(io.BytesIO(blob))
    tidx = rf.load_raft_ivf_flat(io.BytesIO(blob), device="cpu")
    assert tidx.data.dtype == {np.int8: torch.int8, np.uint8: torch.uint8,
                               np.float32: torch.float32}[dtype]
    np.testing.assert_array_equal(tidx.data.numpy(), np.asarray(jidx.data))
    np.testing.assert_array_equal(tidx.list_sizes, jidx.list_sizes)
    if dtype == np.int8:
        assert jidx.scales is None
        np.testing.assert_array_equal(tidx.scales.numpy(), np.ones(n))
    else:
        assert tidx.scales is None
    _equal(jivf.search(jidx, q, K, jivf.SearchParams(n_probes=N_PROBES),
                       algo="xla"),
           ivf_flat.search(tidx, q, K, ivf_flat.SearchParams(
               n_probes=N_PROBES)))


# ------------------------------------------------------------------- CAGRA

CSP = dict(itopk_size=16, search_width=1, max_iterations=4,
           candidate_dtype="float32")


@pytest.fixture
def jax_seeds(monkeypatch):
    """Make the port draw the JAX package's random seed rows."""
    def draw(m, n_seeds, high, seed, device):
        r = jax.random.randint(jax.random.key(seed), (m, n_seeds), 0, high)
        return torch.from_numpy(np.array(r)).to(device)

    monkeypatch.setattr(cagra, "_draw_seeds", draw)


@pytest.mark.parametrize("include_dataset", [True, False])
def test_cagra_file(ints, jax_seeds, include_dataset):
    x, q = ints
    jidx = jcagra.build(jnp.asarray(x), jcagra.IndexParams(
        intermediate_graph_degree=24, graph_degree=16, seed=0))
    carried = convert.cagra_index_from_numpy(
        {"dataset": np.asarray(jidx.dataset), "graph": np.asarray(jidx.graph),
         "metric": jidx.metric.value}, device="cpu")
    jraw = _raw(jrf.save_raft_cagra, jidx, include_dataset=include_dataset)
    assert _raw(rf.save_raft_cagra, carried,
                include_dataset=include_dataset) == jraw
    ds = None if include_dataset else x
    if not include_dataset:
        with pytest.raises(RaftError, match="no dataset"):
            rf.load_raft_cagra(io.BytesIO(jraw), device="cpu")
    loaded = rf.load_raft_cagra(io.BytesIO(jraw), ds, device="cpu")
    assert loaded.seed_nodes is None
    sp = cagra.SearchParams(**CSP)
    want = cagra.search(carried, torch.from_numpy(q), K, sp, engine="gather")
    _equal(jcagra.search(jrf.load_raft_cagra(io.BytesIO(jraw), ds),
                         jnp.asarray(q), K, jcagra.SearchParams(**CSP),
                         engine="gather"), want)
    _bits(cagra.search(loaded, torch.from_numpy(q), K, sp,
                       engine="gather"), want)
