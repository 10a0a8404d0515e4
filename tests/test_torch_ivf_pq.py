"""The port's IVF-PQ and refine against the JAX package: IVF-PQ indexes
built by ``raft_tpu`` and carried over with ``raft_tpu_torch.convert``,
searched by both packages; the port's encode and refine on the same
inputs; the port's own IVF-PQ build judged by recall; and ``health`` on
a carried index, equal to JAX's report.

The JAX side runs its exact gather engine, ``ivf_pq.search(...,
algo="xla")`` with ``lut_dtype=float32`` (its Pallas scan is scrambled in
interpret mode; see ``test_torch_ivf_pq_scan.py``). A filtered search runs
on both sides under each package's ``filter_policy.suspended()`` (case
``True``), and with the adaptive policy on both sides: ``"crossover"``
at the default survivor threshold (the decoded survivors searched by
brute force), ``"widened"`` with ``RAFT_TPU_FILTER_BRUTE_MAX=0`` (8
probes widened to 16).

Tolerances. Search: distances to rtol 1e-4 and ids equal on >= 98% of
rows, because the port scores in the expanded form
``||q||² + ||c+dec||² - 2q·(c+dec)`` and the JAX gather engine in the
residual form, which round differently (cancellation between the norms
and the cross term). Encode: codes equal on >= 99.9% of entries (a near
tie between two codewords may round either way). Refine: the
``assert_knn_close`` contract at rtol 1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann_utils import naive_knn
from raft_tpu.core.bitset import Bitset as JaxBitset
from raft_tpu.distance.distance_types import canonical_metric
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import refine as jrefine
from raft_tpu_torch import convert
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.neighbors import ivf_pq, refine
from raft_tpu_torch.stats.metrics import neighborhood_recall
from test_torch_kernels import assert_knn_close
from test_torch_slice import _clustered, policy

torch.set_num_threads(1)

N, D, M, K, N_LISTS, N_PROBES = 4000, 32, 100, 10, 32, 8
BUILDS = {
    "pq8": dict(pq_dim=8, pq_bits=8),
    "pq4": dict(pq_dim=16, pq_bits=4),
    "rotated": dict(pq_dim=8, pq_bits=8, force_random_rotation=True),
    "dim30": dict(pq_dim=8, pq_bits=8, dim=30),   # rot_dim 32 != dim
}


@pytest.fixture(scope="module")
def data():
    x, q = _clustered(N, M, D, 0)
    keep = np.random.default_rng(1).random(N) < 0.6
    return x, q, keep


def _cut(arrays, name):
    dim = BUILDS[name].get("dim", D)
    return [a[:, :dim] for a in arrays]


@pytest.fixture(scope="module")
def jax_builds(data):
    """One JAX build per parameter set, made on first use: the layout does
    not depend on the metric (k-means and list assignment are L2)."""
    cache = {}

    def get(name):
        if name not in cache:
            kw = {k: v for k, v in BUILDS[name].items() if k != "dim"}
            x, = _cut([data[0]], name)
            cache[name] = jpq.build(jnp.asarray(x), jpq.IndexParams(
                n_lists=N_LISTS, seed=0, **kw))
        return cache[name]

    return get


def _carry(jidx):
    return convert.ivf_pq_index_from_numpy(
        {"codes": np.asarray(jidx.codes),
         "source_ids": np.asarray(jidx.source_ids),
         "centers_rot": np.asarray(jidx.centers_rot),
         "codebooks": np.asarray(jidx.codebooks),
         "rotation": np.asarray(jidx.rotation),
         "list_offsets": jidx.list_offsets,
         "list_sizes_arr": jidx.list_sizes_arr,
         "metric": jidx.metric.value, "pq_bits": jidx.pq_bits,
         "codebook_kind": jidx.codebook_kind}, device="cpu")


_CASES = ([("pq8", m, f) for m in ("sqeuclidean", "euclidean",
                                   "inner_product") for f in (False, True)]
          + [(b, m, f) for b in ("pq4", "rotated", "dim30")
             for m, f in (("sqeuclidean", False), ("inner_product", True))]
          + [(b, m, f) for b in ("pq8", "dim30")
             for m in ("sqeuclidean", "inner_product")
             for f in ("crossover", "widened")])


@pytest.mark.parametrize("build,metric,filtered", _CASES)
def test_carried_index_search(data, jax_builds, build, metric, filtered,
                              monkeypatch):
    x, q = _cut(data[:2], build)
    keep = data[2]
    jidx = dataclasses.replace(jax_builds(build),
                               metric=canonical_metric(metric))
    tidx = _carry(jidx)
    assert tidx.size == N and tidx.rot_dim == 32
    jf = JaxBitset.from_mask(jnp.asarray(keep)) if filtered else None
    tf = Bitset.from_mask(torch.from_numpy(keep)) if filtered else None
    with policy(filtered, monkeypatch):
        jv, ji = jpq.search(jidx, jnp.asarray(q), K,
                            jpq.SearchParams(N_PROBES,
                                             lut_dtype=jnp.float32),
                            filter=jf, algo="xla")
        for algo in ("auto", "plain"):
            tv, ti = ivf_pq.search(
                tidx, torch.from_numpy(q), K,
                ivf_pq.SearchParams(N_PROBES, lut_dtype=torch.float32),
                filter=tf, algo=algo)
            assert tv.device.type == "cpu" and ti.dtype == torch.int32
            assert_knn_close(np.asarray(jv), np.asarray(ji), tv.numpy(),
                             ti.numpy(), rtol=1e-4, min_rows_equal=0.98)
    if filtered:
        assert keep[ti.numpy()[ti.numpy() >= 0]].all()


@pytest.mark.parametrize("build", ["pq8", "pq4"])
def test_encode_matches_jax(data, jax_builds, build):
    """The port's ``_encode`` on the JAX index's residuals and codebooks
    gives the JAX ``_encode``'s codes."""
    jidx = jax_builds(build)
    x, = _cut([data[0]], build)
    rot, cr = np.asarray(jidx.rotation), np.asarray(jidx.centers_rot)
    xr = x @ rot.T
    lab = np.argmin(((xr[:, None, :] - cr[None]) ** 2).sum(-1), axis=1)
    resid = (xr - cr[lab]).astype(np.float32)
    want = np.asarray(jpq._encode(jnp.asarray(resid), jidx.codebooks,
                                  jnp.asarray(lab), False))
    got = ivf_pq._encode(torch.from_numpy(resid),
                         torch.from_numpy(np.asarray(jidx.codebooks)))
    assert got.dtype == torch.uint8
    assert (got.numpy() == want).mean() >= 0.999


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine",
                                    "inner_product"])
@pytest.mark.parametrize("store", ["float32", "bfloat16", "uint8"])
def test_refine_matches_jax(data, store, metric):
    rng = np.random.default_rng(4)
    x, q, _ = data
    cand = rng.integers(0, N, (M, 30)).astype(np.int32)
    cand[rng.random(cand.shape) < 0.1] = -1
    cand[0, 3:] = -1                        # fewer valid candidates than k
    if store == "uint8":
        xs = rng.integers(0, 256, x.shape).astype(np.uint8)
        jx, tx = jnp.asarray(xs), torch.from_numpy(xs)
    elif store == "bfloat16":
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jv, ji = jrefine.refine(jx, jnp.asarray(q), jnp.asarray(cand), K, metric)
    tv, ti = refine.refine(tx, torch.from_numpy(q), torch.from_numpy(cand),
                           K, metric, device="cpu")
    assert ti.dtype == torch.int32
    assert_knn_close(np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy())
    assert (ti[0, 3:] == -1).all()


def test_port_build_recall_and_refine(data, jax_builds):
    """The port's own build (torch.Generator k-means and codebooks) reaches
    the JAX build's recall@10 within 0.05 on the same data and
    parameters, and refine of 4k candidates lifts it."""
    x, q, _ = data
    idx = ivf_pq.build(x, ivf_pq.IndexParams(n_lists=N_LISTS, pq_dim=8),
                       device="cpu")
    assert idx.size == N and idx.codes.dtype == torch.uint8
    assert sorted(idx.source_ids[idx.source_ids >= 0].tolist()) == list(
        range(N))
    assert set(idx.build_seconds) == {"coarse_kmeans", "codebooks",
                                      "encode"}
    sp = ivf_pq.SearchParams(N_PROBES, lut_dtype=torch.float32)
    _, ref = naive_knn(x, q, K)
    ref = torch.from_numpy(ref)
    _, ti = ivf_pq.search(idx, q, 4 * K, sp)
    _, ji = jpq.search(jax_builds("pq8"), jnp.asarray(q), K,
                       jpq.SearchParams(N_PROBES, lut_dtype=jnp.float32),
                       algo="xla")
    r_port = neighborhood_recall(ti[:, :K], ref)
    r_jax = neighborhood_recall(torch.from_numpy(np.asarray(ji)), ref)
    assert r_port >= r_jax - 0.05, (r_port, r_jax)
    _, ri = refine.refine(x, q, ti, K, device="cpu")
    assert neighborhood_recall(ri, ref) > r_port


def test_unported_options_raise(data):
    """The options ported since (per-cluster codebooks, list slack, an
    extend into a filled index) build and search; what stays unported
    (the brownout controller) and an unknown LUT dtype raise."""
    x = data[0][:500]
    for kw in (dict(codebook_kind=ivf_pq.CodebookGen.PER_CLUSTER),
               dict(list_growth=1.2)):
        idx = ivf_pq.build(x, ivf_pq.IndexParams(n_lists=4, pq_dim=8,
                                                 pq_bits=4, **kw),
                           device="cpu")
        assert idx.size == 500
        assert idx.list_offsets[-1] > 500 or "list_growth" not in kw
        assert ivf_pq.search(idx, x[:2], 3)[1].shape == (2, 3)
    idx = ivf_pq.build(x, ivf_pq.IndexParams(n_lists=4, pq_dim=8,
                                             pq_bits=4), device="cpu")
    more = ivf_pq.extend(idx, x[:10])
    assert more.size == 510 and int(more.source_ids.max()) == 509
    with pytest.raises(Exception, match="not ported yet"):
        ivf_pq.make_searcher(idx, degrade=object())
    with pytest.raises(Exception, match="unknown lut_dtype"):
        ivf_pq.search(idx, x[:2], 3, ivf_pq.SearchParams(lut_dtype="f64"))


@pytest.mark.parametrize("build", ["pq8", "pq4", "dim30"])
def test_health_matches_jax(jax_builds, build):
    """``health`` on a carried JAX index equals JAX's report: the list
    skew, the PQ geometry and the sampled codeword utilization (integer
    counts over the same sampled rows)."""
    jidx = jax_builds(build)
    assert ivf_pq.health(_carry(jidx)) == jpq.health(jidx)
    assert ivf_pq.health(_carry(jidx), sample=7) == jpq.health(jidx,
                                                               sample=7)
