"""The IVF families' filled-index ``extend``, capacity slack
(``list_growth``) and streaming builds (``build_from_batches``) in the
PyTorch port against the JAX package.

Layout parity: a JAX index built with ``add_data_on_build=False`` (its
quantizers trained) is carried over empty with ``convert``, and both
packages extend it by the same three batches. With ``list_growth`` 2.0
every later batch fits in the slack (the offsets stay, one scatter); with
1.0 the second batch overflows and the lists are repacked. After each
extend the two layouts must be equal: ``list_offsets``, ``list_sizes``,
every capacity row's id (-1 on slack), the stored rows (IVF-Flat, exact
copies), the scales, and the codes (IVF-PQ, an encode of the same
residuals against the same codebooks: equal on >= 99.9% of the entries,
since a near tie between two codewords may round either way).

Streaming builds: JAX's ``build_from_batches`` against the port's with
the port's quantizer training replaced by JAX's trained quantizers (the
k-means draws differ between ``jax.random`` and ``torch.Generator``), so
that every later step (the slack floor of 1.2, the extends, the ids) is
compared on equal inputs, with and without a ``trainset``.

Files: a slack index saves (``RAFTTPU2`` and RAFT 24.02) byte-equal to
JAX's files of the same index, ``conservative_memory`` included.

Searches on the extended layouts: the JAX side runs ``algo="xla"`` (its
exact gather engine; IVF-PQ at ``lut_dtype=float32``); the tolerance is
``test_torch_kernels.assert_knn_close``'s (IVF-PQ: rtol 1e-4, ids on >=
98% of the rows, as in ``test_torch_ivf_pq.py``).
"""
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import raft_format as jrf
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import convert
from raft_tpu_torch.core import raft_format as rf
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from test_torch_kernels import assert_knn_close
from test_torch_slice import _clustered

torch.set_num_threads(1)

N, D, M, K, N_LISTS, N_PROBES = 3000, 16, 40, 10, 16, 5
BATCHES = (0, 1800, 2400, 3000)     # three extends


@pytest.fixture(scope="module")
def data():
    return _clustered(N, M, D, 7)


def _batches(x):
    return [x[a:b] for a, b in zip(BATCHES[:-1], BATCHES[1:])]


def _flat_arrays(jidx) -> dict:
    arrays = {f: np.asarray(getattr(jidx, f)) for f in (
        "data", "data_norms", "source_ids", "centers", "center_norms",
        "list_offsets", "list_sizes_arr")}
    if jidx.scales is not None:
        arrays["scales"] = np.asarray(jidx.scales)
    arrays.update(metric=jidx.metric, list_growth=jidx.list_growth,
                  conservative_memory=jidx.conservative_memory)
    return arrays


def _carry_flat(jidx) -> ivf_flat.Index:
    return convert.ivf_flat_index_from_numpy(_flat_arrays(jidx),
                                             device="cpu")


def _carry_pq(jidx) -> ivf_pq.Index:
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


def _same_layout(jidx, tidx, rows: str) -> None:
    """Equal offsets, sizes and ids a capacity row; the rows themselves
    equal (IVF-Flat) or the codes on >= 99.9% of the entries (IVF-PQ)."""
    np.testing.assert_array_equal(tidx.list_offsets, jidx.list_offsets)
    np.testing.assert_array_equal(tidx.list_sizes, jidx.list_sizes)
    np.testing.assert_array_equal(tidx.source_ids.numpy(),
                                  np.asarray(jidx.source_ids))
    got = getattr(tidx, rows).numpy()
    want = np.asarray(getattr(jidx, rows))
    if rows == "codes":
        assert (got == want).mean() >= 0.999
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    if getattr(jidx, "scales", None) is not None:
        np.testing.assert_array_equal(tidx.scales.numpy(),
                                      np.asarray(jidx.scales))


@pytest.mark.parametrize("growth", [2.0, 1.0])
@pytest.mark.parametrize("store", ["float32", "int8"])
def test_ivf_flat_extend_layout(data, store, growth):
    x, q = data
    jidx = jivf.build(jnp.asarray(x), jivf.IndexParams(
        n_lists=N_LISTS, add_data_on_build=False, list_growth=growth,
        dtype=store))
    tidx = _carry_flat(jidx)
    assert tidx.size == 0 and tidx.list_growth == growth
    offsets = []
    for b in _batches(x):
        jidx = jivf.extend(jidx, jnp.asarray(b))
        tidx = ivf_flat.extend(tidx, torch.from_numpy(b))
        _same_layout(jidx, tidx, "data")
        np.testing.assert_allclose(tidx.data_norms.numpy(),
                                   np.asarray(jidx.data_norms), rtol=1e-5)
        offsets.append(tidx.list_offsets)
    # 2.0: the later batches scatter into the slack; 1.0: a repack
    assert np.array_equal(offsets[0], offsets[2]) == (growth == 2.0)
    assert sorted(tidx.source_ids[tidx.source_ids >= 0].tolist()) == \
        list(range(N))
    sp = N_PROBES
    jv, ji = jivf.search(jidx, jnp.asarray(q), K,
                         jivf.SearchParams(n_probes=sp), algo="xla")
    tv, ti = ivf_flat.search(tidx, torch.from_numpy(q), K,
                             ivf_flat.SearchParams(n_probes=sp))
    assert_knn_close(np.asarray(jv), np.asarray(ji), tv.numpy(),
                     ti.numpy())


@pytest.mark.parametrize("growth", [2.0, 1.0])
@pytest.mark.parametrize("kind", ["PER_SUBSPACE", "PER_CLUSTER"])
def test_ivf_pq_extend_layout(data, kind, growth):
    x, q = data
    jidx = jpq.build(jnp.asarray(x), jpq.IndexParams(
        n_lists=N_LISTS, pq_dim=8, pq_bits=6, add_data_on_build=False,
        list_growth=growth, codebook_kind=jpq.CodebookGen[kind]))
    tidx = _carry_pq(jidx)
    assert tidx.size == 0 and tidx.codebook_kind.name == kind
    for b in _batches(x):
        jidx = jpq.extend(jidx, jnp.asarray(b))
        tidx = ivf_pq.extend(tidx, torch.from_numpy(b))
        _same_layout(jidx, tidx, "codes")
    sp = N_PROBES
    jv, ji = jpq.search(jidx, jnp.asarray(q), K,
                        jpq.SearchParams(sp, lut_dtype=jnp.float32),
                        algo="xla")
    tv, ti = ivf_pq.search(tidx, torch.from_numpy(q), K,
                           ivf_pq.SearchParams(sp, lut_dtype=torch.float32))
    assert_knn_close(np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy(),
                     rtol=1e-4, min_rows_equal=0.98)


def test_extend_with_ids_and_into_a_built_index(data):
    """``new_ids`` are kept as given; without them the ids continue from
    the largest held; an extend into an index that ``build`` filled (no
    slack: ``list_growth`` 1.0) repacks, each list's old rows first."""
    x, _ = data
    tidx = ivf_flat.build(x[:2000], ivf_flat.IndexParams(n_lists=N_LISTS),
                          device="cpu")
    ids = torch.arange(5000, 5100, dtype=torch.int32)
    a = ivf_flat.extend(tidx, x[2000:2100], ids)
    b = ivf_flat.extend(a, x[2100:2200])
    held = set(b.source_ids[b.source_ids >= 0].tolist())
    assert held == set(range(2000)) | set(range(5000, 5200))
    for idx in (a, b):
        for lst in range(N_LISTS):
            o, s = int(idx.list_offsets[lst]), int(idx.list_sizes[lst])
            got = idx.source_ids[o : o + s].tolist()
            assert got == sorted(got, key=lambda i: (i >= 2000, i))


def _patch_flat_training(monkeypatch, jidx):
    """The port's coarse k-means returns JAX's trained centers."""
    centers = torch.from_numpy(np.asarray(jidx.centers))
    monkeypatch.setattr(ivf_flat.kmeans_balanced, "fit",
                        lambda *a, **kw: centers.clone())


@pytest.mark.parametrize("trainset", [False, True])
def test_ivf_flat_build_from_batches(data, monkeypatch, trainset):
    x, q = data
    p = dict(n_lists=N_LISTS, list_growth=1.0)
    ts = x if trainset else None
    jidx = jivf.build_from_batches(
        [jnp.asarray(b) for b in _batches(x)], jivf.IndexParams(**p),
        None if ts is None else jnp.asarray(ts))
    _patch_flat_training(monkeypatch, jidx)
    tidx = ivf_flat.build_from_batches(_batches(x), ivf_flat.IndexParams(**p),
                                       ts, device="cpu")
    assert tidx.list_growth == jidx.list_growth == 1.2
    _same_layout(jidx, tidx, "data")


@pytest.mark.parametrize("kind", ["PER_SUBSPACE", "PER_CLUSTER"])
def test_ivf_pq_build_from_batches(data, monkeypatch, kind):
    x, q = data
    p = dict(n_lists=N_LISTS, pq_dim=8, pq_bits=6,
             codebook_kind=jpq.CodebookGen[kind])
    jidx = jpq.build_from_batches([jnp.asarray(b) for b in _batches(x)],
                                  jpq.IndexParams(**p), jnp.asarray(x))
    centers = torch.from_numpy(np.asarray(jidx.centers_rot))
    books = torch.from_numpy(np.asarray(jidx.codebooks))
    # the rotation is the identity (rot_dim == dim), so the rotated
    # centers are the centers; the codebook training returns JAX's
    monkeypatch.setattr(ivf_pq.kmeans_balanced, "fit",
                        lambda *a, **kw: centers.clone())
    monkeypatch.setattr(ivf_pq, "_kmeans_fixed",
                        lambda *a, **kw: books.clone())
    monkeypatch.setattr(ivf_pq, "_train_per_cluster",
                        lambda *a, **kw: books.clone())
    tidx = ivf_pq.build_from_batches(
        _batches(x), ivf_pq.IndexParams(codebook_kind=ivf_pq.CodebookGen[kind],
                                        **{k: v for k, v in p.items()
                                           if k != "codebook_kind"}),
        x, device="cpu")
    assert tidx.list_growth == jidx.list_growth == 1.2
    np.testing.assert_array_equal(tidx.rotation.numpy(),
                                  np.asarray(jidx.rotation))
    _same_layout(jidx, tidx, "codes")


def test_build_from_batches_refuses_no_batches():
    with pytest.raises(RaftError, match="empty batch"):
        ivf_flat.build_from_batches([], ivf_flat.IndexParams(n_lists=4),
                                    device="cpu")


def test_add_data_on_build_false_trains_only(data):
    x, _ = data
    for mod, p in ((ivf_flat, ivf_flat.IndexParams(n_lists=8)),
                   (ivf_pq, ivf_pq.IndexParams(n_lists=8, pq_dim=8))):
        idx = mod.build(x, dataclasses.replace(p, add_data_on_build=False),
                        device="cpu")
        assert idx.size == 0 and idx.n_lists == 8
        full = mod.extend(idx, x)
        assert full.size == N
        assert full.source_ids.max() == N - 1


def test_ivf_flat_reconstruct_on_slack(data):
    """Rows of an extended slack layout decode as JAX's ``reconstruct``
    decodes them; a slack row raises, as in JAX."""
    x, _ = data
    jidx = jivf.build(jnp.asarray(x[:2000]), jivf.IndexParams(
        n_lists=N_LISTS, list_growth=1.5, dtype="int8"))
    jidx = jivf.extend(jidx, jnp.asarray(x[2000:]))
    tidx = _carry_flat(jidx)
    real = np.nonzero(np.asarray(jidx.source_ids) >= 0)[0][::7]
    np.testing.assert_array_equal(
        ivf_flat.reconstruct(tidx, real).numpy(),
        np.asarray(jivf.reconstruct(jidx, real)))
    slack = np.nonzero(np.asarray(jidx.source_ids) < 0)[0][:1]
    with pytest.raises(RaftError, match="slack"):
        ivf_flat.reconstruct(tidx, slack)
    with pytest.raises(Exception, match="slack"):
        jivf.reconstruct(jidx, slack)


def _bytes_of(save, index, path) -> bytes:
    save(index, path)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("store", ["float32", "bfloat16", "int8"])
def test_ivf_flat_slack_files(tmp_path, data, store):
    """RAFTTPU2 files of a slack index (lists packed with no slack in the
    file) byte-equal to JAX's; the RAFT file too (float32), with
    ``conservative_memory`` set, which the port's RAFT reader keeps."""
    x, _ = data
    jidx = jivf.build(jnp.asarray(x[:2000]), jivf.IndexParams(
        n_lists=N_LISTS, list_growth=1.5, dtype=store))
    jidx = jivf.extend(jidx, jnp.asarray(x[2000:]))
    tidx = _carry_flat(jidx)
    assert tidx.list_offsets[-1] > tidx.size
    assert _bytes_of(ivf_flat.save, tidx, tmp_path / "t.idx") == \
        _bytes_of(jivf.save, jidx, tmp_path / "j.idx")
    if store != "float32":
        return
    jc = dataclasses.replace(jidx, conservative_memory=True)
    tc = _carry_flat(jc)
    assert tc.conservative_memory
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    jrf.save_raft_ivf_flat(jc, jbuf)
    rf.save_raft_ivf_flat(tc, tbuf)
    assert tbuf.getvalue() == jbuf.getvalue()
    back = rf.load_raft_ivf_flat(io.BytesIO(tbuf.getvalue()), device="cpu")
    assert back.conservative_memory and back.size == N
    again = io.BytesIO()
    rf.save_raft_ivf_flat(back, again)
    assert again.getvalue() == jbuf.getvalue()


def test_ivf_pq_slack_files(tmp_path, data):
    x, _ = data
    jidx = jpq.build(jnp.asarray(x[:2000]), jpq.IndexParams(
        n_lists=N_LISTS, pq_dim=8, pq_bits=5, list_growth=1.5))
    jidx = jpq.extend(jidx, jnp.asarray(x[2000:]))
    tidx = _carry_pq(jidx)
    assert tidx.list_offsets[-1] > tidx.size
    assert _bytes_of(ivf_pq.save, tidx, tmp_path / "t.idx") == \
        _bytes_of(jpq.save, jidx, tmp_path / "j.idx")
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    jrf.save_raft_ivf_pq(jidx, jbuf)
    rf.save_raft_ivf_pq(tidx, tbuf)
    assert tbuf.getvalue() == jbuf.getvalue()
