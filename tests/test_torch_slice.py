"""The PyTorch port's first slice end to end: brute-force and IVF-Flat
indexes built by ``raft_tpu``, carried over with ``raft_tpu_torch.convert``
and searched by both packages; the port's own IVF-Flat build judged by
recall; and the port's package rules (no JAX, no silent CPU).

The JAX side runs its exact XLA engines (brute force ``algo="matmul"``,
IVF-Flat ``algo="xla"``). A filtered search runs on both sides under
each package's ``filter_policy.suspended()`` (case ``True``: the penalty
and the zero-survivor prune), and with the adaptive policy on both
sides: ``"crossover"`` at the default survivor threshold (every 60%
filter of these 4,000 rows is below 8,192 survivors), ``"widened"`` with
``RAFT_TPU_FILTER_BRUTE_MAX=0``, which both packages read (IVF-Flat
widens 8 probes to 16).

Tolerance (Gaussian inputs): ``test_torch_kernels.assert_knn_close``:
distances to ``rtol=1e-5, atol=1e-5·max|d|``, ids equal on >= 99% of
rows, because XLA and torch sum in different orders.
"""
import contextlib
import dataclasses
import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann_utils import naive_knn
from raft_tpu.core.bitset import Bitset as JaxBitset
from raft_tpu.distance.distance_types import canonical_metric
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.ops import filter_policy
from raft_tpu_torch import convert
from raft_tpu_torch.comms import Mesh
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.neighbors import (brute_force, cagra, ivf_flat, ivf_pq,
                                      refine)
from raft_tpu_torch.ops import autotune
from raft_tpu_torch.ops import filter_policy as tfp
from raft_tpu_torch.parallel import sharded_ann, sharded_knn
from raft_tpu_torch.stats.metrics import neighborhood_recall
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, M, K, N_LISTS, N_PROBES = 4000, 32, 64, 10, 32, 8
METRICS = ["sqeuclidean", "euclidean", "cosine", "inner_product"]


def _clustered(n, m, d, seed):
    """Gaussian blobs (the shape of real embedding data) and queries drawn
    from the same blobs."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, d)).astype(np.float32) * 2
    x = centers[rng.integers(0, 64, n)] + rng.standard_normal(
        (n, d)).astype(np.float32)
    q = centers[rng.integers(0, 64, m)] + rng.standard_normal(
        (m, d)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def data():
    x, q = _clustered(N, M, D, 0)
    keep = np.random.default_rng(1).random(N) < 0.6
    return x, q, keep


@pytest.fixture(scope="module")
def jax_ivf(data):
    """One JAX IVF-Flat build: its layout does not depend on the metric
    (k-means and list assignment are L2), so each metric reuses it."""
    return jivf.build(jnp.asarray(data[0]), jivf.IndexParams(
        n_lists=N_LISTS, seed=0))


def test_bitset_packing_matches(data):
    keep = data[2]
    jw = np.asarray(JaxBitset.from_mask(jnp.asarray(keep)).words)
    tb = Bitset.from_mask(torch.from_numpy(keep))
    np.testing.assert_array_equal(tb.words.numpy(), jw.astype(np.int64))
    np.testing.assert_array_equal(tb.to_mask().numpy(), keep)


# filtered: False (no filter), True (both under suspended()), or the
# adaptive policy on both sides at the crossover / a widened level
FILTERED = [False, True, "crossover", "widened"]


@contextlib.contextmanager
def policy(filtered, monkeypatch):
    """Both packages' filter policy for a case of ``FILTERED``."""
    if filtered == "widened":
        monkeypatch.setenv("RAFT_TPU_FILTER_BRUTE_MAX", "0")
    if filtered is True:
        with filter_policy.suspended(), tfp.suspended():
            yield
    else:
        yield


@pytest.mark.parametrize("filtered", FILTERED)
@pytest.mark.parametrize("metric", METRICS)
def test_brute_force_carried_index(data, metric, filtered, monkeypatch):
    x, q, keep = data
    jidx = jbf.build(jnp.asarray(x), metric)
    tidx = convert.brute_force_index_from_numpy(
        {"dataset": np.asarray(jidx.dataset),
         "norms": None if jidx.norms is None else np.asarray(jidx.norms),
         "metric": jidx.metric.value}, device="cpu")
    jf = JaxBitset.from_mask(jnp.asarray(keep)) if filtered else None
    tf = Bitset.from_mask(torch.from_numpy(keep)) if filtered else None
    with policy(filtered, monkeypatch):
        jv, ji = jbf.search(jidx, jnp.asarray(q), K, filter=jf,
                            algo="matmul")
        for algo in ("auto", "matmul"):
            tv, ti = brute_force.search(tidx, torch.from_numpy(q), K,
                                        filter=tf, algo=algo)
            assert tv.device.type == "cpu" and ti.dtype == torch.int32
            assert_knn_close(np.asarray(jv), np.asarray(ji), tv.numpy(),
                             ti.numpy())
    if filtered:
        assert keep[ti.numpy()].all()


@pytest.mark.parametrize("filtered", FILTERED)
@pytest.mark.parametrize("metric", METRICS)
def test_ivf_flat_carried_index(data, jax_ivf, metric, filtered,
                                monkeypatch):
    _, q, keep = data
    jidx = dataclasses.replace(jax_ivf,
                               metric=canonical_metric(metric))
    tidx = convert.ivf_flat_index_from_numpy(
        {"data": np.asarray(jidx.data),
         "data_norms": np.asarray(jidx.data_norms),
         "source_ids": np.asarray(jidx.source_ids),
         "centers": np.asarray(jidx.centers),
         "center_norms": np.asarray(jidx.center_norms),
         "list_offsets": jidx.list_offsets,
         "list_sizes_arr": jidx.list_sizes_arr,
         "metric": jidx.metric.value}, device="cpu")
    jf = JaxBitset.from_mask(jnp.asarray(keep)) if filtered else None
    tf = Bitset.from_mask(torch.from_numpy(keep)) if filtered else None
    sp = jivf.SearchParams(n_probes=N_PROBES)
    with policy(filtered, monkeypatch):
        jv, ji = jivf.search(jidx, jnp.asarray(q), K, sp, filter=jf,
                             algo="xla")
        for algo in ("auto", "plain"):
            tv, ti = ivf_flat.search(
                tidx, torch.from_numpy(q), K,
                ivf_flat.SearchParams(n_probes=N_PROBES), filter=tf,
                algo=algo)
            assert ti.dtype == torch.int32
            assert_knn_close(np.asarray(jv), np.asarray(ji), tv.numpy(),
                             ti.numpy())
    if filtered:
        assert keep[ti.numpy()[ti.numpy() >= 0]].all()


def test_ivf_flat_build_recall(data):
    """The port's own build (torch.Generator k-means) reaches recall@10 >=
    0.9 against exact search at n_probes = 8 of 32 lists."""
    x, q, _ = data
    idx = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=N_LISTS),
                         device="cpu")
    assert idx.size == N and int(idx.list_sizes.min()) > 0
    assert sorted(idx.source_ids[idx.source_ids >= 0].tolist()) == list(
        range(N))
    _, ti = ivf_flat.search(idx, q, K,
                            ivf_flat.SearchParams(n_probes=N_PROBES))
    _, ref = naive_knn(x, q, K)
    assert neighborhood_recall(ti, torch.from_numpy(ref)) >= 0.9


def test_query_chunks_and_knn_merge_parts(data):
    x, q, _ = data
    idx = brute_force.build(x, device="cpu")
    v, i = brute_force.search(idx, q, K)
    cv, ci = brute_force.search(idx, q, K, query_chunk=24)
    assert torch.equal(v, cv) and torch.equal(i, ci)
    # two shards of the corpus merged back: the whole corpus's answer
    half = N // 2
    v0, i0 = brute_force.search(brute_force.build(x[:half], device="cpu"),
                                q, K)
    v1, i1 = brute_force.search(brute_force.build(x[half:], device="cpu"),
                                q, K)
    mv, mi = brute_force.knn_merge_parts(torch.stack([v0, v1]),
                                         torch.stack([i0, i1 + half]))
    assert torch.equal(mi, i) and torch.allclose(mv, v)


def test_entry_points_raise_without_cuda(data, monkeypatch):
    """No device= and no card: raise, never carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = data[0][:100]
    with pytest.raises(RaftError):
        brute_force.build(x)
    with pytest.raises(RaftError):
        ivf_flat.build(x, ivf_flat.IndexParams(n_lists=4))
    with pytest.raises(RaftError):
        brute_force.knn(x, x[:3], 2)
    with pytest.raises(RaftError):
        ivf_pq.build(x, ivf_pq.IndexParams(n_lists=4))
    with pytest.raises(RaftError):
        refine.refine(x, x[:3], np.zeros((3, 4), np.int32), 2)
    with pytest.raises(RaftError):
        cagra.build(x, cagra.IndexParams(intermediate_graph_degree=8,
                                         graph_degree=4))
    with pytest.raises(RaftError):
        cagra.build_knn_graph(x, 4)
    # a search runs where its index lives; the index carried from numpy
    # (the way to a searchable index besides build) needs the card too
    with pytest.raises(RaftError):
        convert.cagra_index_from_numpy(
            {"dataset": x, "graph": np.zeros((100, 4), np.int32),
             "metric": "sqeuclidean"})
    # the sharded entry points run where their mesh's shards are
    with pytest.raises(RaftError):
        sharded_knn.build(x, Mesh(["cuda"] * 2))
    with pytest.raises(RaftError):
        sharded_ann.build_ivf_flat(x, Mesh(["cuda:0"] * 2),
                                   ivf_flat.IndexParams(n_lists=4))


def test_port_imports_no_jax():
    """Every module of raft_tpu_torch (the comms/ and parallel/
    subpackages among them), and chip_smoke.py, import neither jax nor
    raft_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import raft_tpu_torch\n"
        "for m in pkgutil.walk_packages(raft_tpu_torch.__path__,\n"
        "                               'raft_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke',\n"
        "                                              'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m in ('jax', 'raft_tpu')\n"
        "       or m.startswith(('jax.', 'raft_tpu.'))]\n"
        "assert not bad, bad\n"
        "assert {'raft_tpu_torch.comms.comms',\n"
        "        'raft_tpu_torch.parallel.sharded_ann',\n"
        "        'raft_tpu_torch.parallel.sharded_knn',\n"
        "        'raft_tpu_torch.ops.ring_topk'} <= set(sys.modules)\n"
        "print('ok', len([m for m in sys.modules\n"
        "                 if m.startswith('raft_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert importlib.util.find_spec("raft_tpu_torch") is not None


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result with no card, in
    the repository and in a directory holding nothing else."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py would run")
    src = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        cwd = str(tmp_path)
        with open(src) as f, open(tmp_path / "chip_smoke.py", "w") as g:
            g.write(f.read())
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("n,k,d", [(5000, 64, 16), (300, 7, 3), (64, 200, 4),
                                   (0, 5, 2)])
def test_segment_sum_matches_segment_sums(n, k, d):
    """The IVF builds' segment sum (``cluster.kmeans.segment_sum``, exact
    in fixed point, so two builds on a card are bit-equal) against
    ``index_add_`` in float64 (equal to 1e-12) and JAX's ``segment_sum``
    in float32 (sums in another order: rtol 1e-5); the same bits for the
    rows in another order; labels with empty segments, an empty input and
    more segments than rows. The card's result is held equal to the CPU's
    in ``test_torch_kernels.py::test_segment_sum_on_card``."""
    import jax

    from raft_tpu_torch.cluster.kmeans import segment_sum

    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((n, d))
    lab = rng.integers(0, k, n)
    lab[lab == 3] = 2
    want = torch.zeros((k, d), dtype=torch.float64).index_add_(
        0, torch.from_numpy(lab), torch.from_numpy(x))
    got = segment_sum(torch.from_numpy(x), torch.from_numpy(lab), k)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    x32 = x.astype(np.float32)
    jw = jax.ops.segment_sum(jnp.asarray(x32), jnp.asarray(lab),
                             num_segments=k)
    got32 = segment_sum(torch.from_numpy(x32), torch.from_numpy(lab), k)
    np.testing.assert_allclose(got32.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-5)
    perm = rng.permutation(n)
    again = segment_sum(torch.from_numpy(x32[perm]),
                        torch.from_numpy(lab[perm]), k)
    assert torch.equal(again.view(torch.int32), got32.view(torch.int32))
