"""IVF-PQ with per-cluster codebooks (``CodebookGen.PER_CLUSTER``: one
(2^pq_bits, pq_len) codebook a list) in the PyTorch port against the JAX
package: search on JAX-built indexes carried over with ``convert``, the
port's own per-cluster build, ``reconstruct`` for both codebook kinds,
``health``, and the index files.

The JAX side searches with its gather engine (``algo="xla"``, the only
one that serves per-cluster codebooks) at ``lut_dtype=float32``.

Tolerances. On integer-valued codebooks, centers and queries (the
rotation is the identity: rot_dim == dim) every LUT entry and sum is an
exact integer in float32 on both sides, so values and ids are equal (L2:
the square roots of equal sums to one ulp, rtol 2e-7, since XLA's CPU
square root is not always the correctly rounded one). On
a JAX-built Gaussian index: distances to rtol 1e-4 and ids on >= 98% of
the rows, as ``test_torch_ivf_pq.py`` states (the port scores in the
expanded form, JAX in the residual form). The port's build draws its
training rows from a ``torch.Generator``, so it is held to JAX's quality,
not its bits: its mean squared reconstruction error within 1.10x of
JAX's on the same rows. ``reconstruct`` to rtol 1e-5 (float32 sums in
another order). Files byte-equal.
"""
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import raft_format as jrf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import convert
from raft_tpu_torch.core import raft_format as rf
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.ops import ivf_pq_scan as tpq
from test_torch_kernels import assert_knn_close
from test_torch_slice import _clustered

torch.set_num_threads(1)

N, D, M, K, N_LISTS, N_PROBES = 4000, 32, 60, 10, 16, 6
PQ = dict(pq_dim=8, pq_bits=6)
PC = jpq.CodebookGen.PER_CLUSTER


@pytest.fixture(scope="module")
def data():
    return _clustered(N, M, D, 11)


@pytest.fixture(scope="module")
def jax_pc(data):
    """A JAX per-cluster index over the first 3,000 rows with list slack,
    then extended by the rest (a capacity layout with slack rows)."""
    x, _ = data
    jidx = jpq.build(jnp.asarray(x[:3000]), jpq.IndexParams(
        n_lists=N_LISTS, codebook_kind=PC, list_growth=1.5, seed=0, **PQ))
    return jpq.extend(jidx, jnp.asarray(x[3000:]))


def _carry(jidx) -> ivf_pq.Index:
    return convert.ivf_pq_index_from_numpy(
        {"codes": np.asarray(jidx.codes),
         "source_ids": np.asarray(jidx.source_ids),
         "centers_rot": np.asarray(jidx.centers_rot),
         "codebooks": np.asarray(jidx.codebooks),
         "rotation": np.asarray(jidx.rotation),
         "list_offsets": jidx.list_offsets,
         "list_sizes_arr": jidx.list_sizes_arr,
         "metric": jidx.metric.value, "pq_bits": jidx.pq_bits,
         "codebook_kind": jidx.codebook_kind,
         "list_growth": jidx.list_growth}, device="cpu")


def _integer_copy(jidx, seed: int):
    """``jidx`` with small-integer codebooks and rotated centers (its codes
    and layout kept) and integer queries."""
    rng = np.random.default_rng(seed)
    np.testing.assert_array_equal(np.asarray(jidx.rotation), np.eye(D))
    cb = rng.integers(-3, 4, np.asarray(jidx.codebooks).shape)
    cen = rng.integers(-4, 5, np.asarray(jidx.centers_rot).shape)
    q = rng.integers(-5, 6, (M, D)).astype(np.float32)
    return dataclasses.replace(
        jidx, codebooks=jnp.asarray(cb, jnp.float32),
        centers_rot=jnp.asarray(cen, jnp.float32)), q


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean",
                                    "inner_product"])
@pytest.mark.parametrize("k", [1, K, 300])
def test_search_exact_on_integer_inputs(jax_pc, metric, k):
    """The JAX-built per-cluster index with integer codebooks: the port's
    search (the kernel path and the plain engine) equal to JAX's at the
    f32 LUT, values and ids, (+inf, -1) slots past the candidates too."""
    jidx, q = _integer_copy(dataclasses.replace(
        jax_pc, metric=jpq.canonical_metric(metric)), 5)
    jv, ji = jpq.search(jidx, jnp.asarray(q), k,
                        jpq.SearchParams(N_PROBES, lut_dtype=jnp.float32),
                        algo="xla")
    tidx = _carry(jidx)
    for algo in ("auto", "plain"):
        tv, ti = ivf_pq.search(tidx, torch.from_numpy(q), k,
                               ivf_pq.SearchParams(N_PROBES,
                                                   lut_dtype=torch.float32),
                               algo=algo)
        if metric == "euclidean":
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-7)
        else:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_search_on_jax_index(data, jax_pc, metric):
    _, q = data
    jidx = dataclasses.replace(jax_pc, metric=jpq.canonical_metric(metric))
    jv, ji = jpq.search(jidx, jnp.asarray(q), K,
                        jpq.SearchParams(N_PROBES, lut_dtype=jnp.float32),
                        algo="xla")
    tv, ti = ivf_pq.search(_carry(jidx), torch.from_numpy(q), K,
                           ivf_pq.SearchParams(N_PROBES,
                                               lut_dtype=torch.float32))
    assert_knn_close(np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy(),
                     rtol=1e-4, min_rows_equal=0.98)


def test_int8_lut_takes_bf16(data, jax_pc):
    """An int8 LUT request on per-cluster codebooks searches as bf16 (the
    JAX gather path has no int8 form for them)."""
    _, q = data
    tidx = _carry(jax_pc)
    a = ivf_pq.search(tidx, q, K, ivf_pq.SearchParams(N_PROBES,
                                                      lut_dtype="int8"))
    b = ivf_pq.search(tidx, q, K, ivf_pq.SearchParams(N_PROBES,
                                                      lut_dtype="bf16"))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_decoded_row_norms_per_cluster(jax_pc):
    """``||c_l + cb[l, code]||²`` a row, slack rows through the list whose
    span holds them, against a float64 numpy decode."""
    tidx = _carry(jax_pc)
    codes = tidx.codes.numpy().astype(np.int64)
    cb = tidx.codebooks.numpy().astype(np.float64)
    cen = tidx.centers_rot.numpy().astype(np.float64)
    lab = np.repeat(np.arange(N_LISTS), np.diff(tidx.list_offsets))
    dec = cb[lab[:, None], codes].reshape(len(codes), -1)
    want = ((cen[lab] + dec) ** 2).sum(1)
    np.testing.assert_allclose(tidx.row_norms.numpy(), want, rtol=1e-5,
                               atol=1e-4)
    again = tpq.decoded_row_norms(tidx.codes, tidx.centers_rot,
                                  tidx.codebooks, tidx.list_offsets, True)
    assert torch.equal(again, tidx.row_norms)


def _mse(x, recon, ids) -> float:
    return float(((x[ids] - recon) ** 2).sum(1).mean())


def test_port_build_quality(data):
    """The port's per-cluster build on the rows JAX builds from: its mean
    squared reconstruction error within 1.10x of JAX's, and a search of
    its own index closer to the exact neighbors than its raw codes."""
    x, _ = data
    p = dict(n_lists=N_LISTS, codebook_kind=PC, seed=0, **PQ)
    jidx = jpq.build(jnp.asarray(x), jpq.IndexParams(**p))
    tidx = ivf_pq.build(x, ivf_pq.IndexParams(
        n_lists=N_LISTS, codebook_kind=ivf_pq.CodebookGen.PER_CLUSTER,
        **PQ), device="cpu")
    assert tuple(tidx.codebooks.shape) == (N_LISTS, 64, 4)
    jrows = np.nonzero(np.asarray(jidx.source_ids) >= 0)[0]
    trows = torch.nonzero(tidx.source_ids >= 0)[:, 0]
    j_err = _mse(x, np.asarray(jpq.reconstruct(jidx, jrows)),
                 np.asarray(jidx.source_ids)[jrows])
    t_err = _mse(x, ivf_pq.reconstruct(tidx, trows).numpy(),
                 tidx.source_ids[trows].numpy())
    assert t_err <= 1.10 * j_err, (t_err, j_err)


@pytest.mark.parametrize("kind", ["PER_SUBSPACE", "PER_CLUSTER"])
def test_reconstruct_matches_jax(data, kind):
    """Physical rows of an extended slack layout, slack rows included
    (decoded through the list whose span holds them, as JAX does)."""
    x, _ = data
    jidx = jpq.build(jnp.asarray(x[:3000]), jpq.IndexParams(
        n_lists=N_LISTS, codebook_kind=jpq.CodebookGen[kind],
        list_growth=1.5, force_random_rotation=True, **PQ))
    jidx = jpq.extend(jidx, jnp.asarray(x[3000:]))
    rows = np.arange(0, int(jidx.list_offsets[-1]), 5)
    assert (np.asarray(jidx.source_ids)[rows] < 0).any()
    np.testing.assert_allclose(
        ivf_pq.reconstruct(_carry(jidx), rows).numpy(),
        np.asarray(jpq.reconstruct(jidx, rows)), rtol=1e-5, atol=1e-5)


def test_health_matches_jax(jax_pc):
    assert ivf_pq.health(_carry(jax_pc)) == jpq.health(jax_pc)


def _bytes_of(save, index, path) -> bytes:
    save(index, path)
    with open(path, "rb") as f:
        return f.read()


def test_files_byte_equal(tmp_path, data, jax_pc):
    """The RAFTTPU2 file of the carried index equals JAX's byte for byte;
    the port loads JAX's file as a per-cluster index that searches
    bit-equal to the carried one; the RAFT 24.02 file ((n_lists, pq_len,
    book) pq_centers) byte-equal too, and loaded back per-cluster."""
    _, q = data
    tidx = _carry(jax_pc)
    assert _bytes_of(ivf_pq.save, tidx, tmp_path / "t.idx") == \
        _bytes_of(jpq.save, jax_pc, tmp_path / "j.idx")
    loaded = ivf_pq.load(tmp_path / "j.idx", device="cpu")
    assert loaded.codebook_kind is ivf_pq.CodebookGen.PER_CLUSTER
    sp = ivf_pq.SearchParams(N_PROBES, lut_dtype=torch.float32)
    a = ivf_pq.search(loaded, q, K, sp)
    b = ivf_pq.search(tidx, q, K, sp)
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    jrf.save_raft_ivf_pq(jax_pc, jbuf)
    rf.save_raft_ivf_pq(tidx, tbuf)
    assert tbuf.getvalue() == jbuf.getvalue()
    back = rf.load_raft_ivf_pq(io.BytesIO(jbuf.getvalue()), device="cpu")
    assert back.codebook_kind is ivf_pq.CodebookGen.PER_CLUSTER
    assert tuple(back.codebooks.shape) == tuple(tidx.codebooks.shape)
    torch.testing.assert_close(back.codebooks, tidx.codebooks, rtol=0,
                               atol=0)


def test_per_cluster_and_per_subspace_need_their_shapes(jax_pc):
    """The codebook kind decides the codebooks' leading size (n_lists or
    pq_dim), also where the two are equal in number."""
    tidx = _carry(jax_pc)
    with pytest.raises(Exception, match="codebooks must number"):
        dataclasses.replace(tidx, codebooks=tidx.codebooks[:4])
    x = _clustered(600, 1, D, 3)[0]
    sixteen = ivf_pq.build(x, ivf_pq.IndexParams(
        n_lists=16, pq_dim=16, pq_bits=4,
        codebook_kind=ivf_pq.CodebookGen.PER_CLUSTER), device="cpu")
    assert tuple(sixteen.codebooks.shape) == (16, 16, 2)
    assert sixteen.pq_dim == 16 and sixteen.per_cluster
