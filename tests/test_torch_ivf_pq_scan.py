"""The IVF-PQ scan of the PyTorch port (the plain version of kernel K4,
its row norms and LUT-mode codebooks) against ``raft_tpu.ops.ivf_pq_scan``.

The JAX Pallas scan is not a reference here: its one-hot decode needs
``pltpu.repeat`` to tile, but the CPU interpreter repeats element by
element, so its interpret-mode output is scrambled for every LUT mode
(the JAX package's own parity tests of it are xfail). The plain K4 is
held instead against a numpy float64 statement of what the Pallas kernel
computes: the expanded-form distance, the clamp at 0 (l2), the additive
penalty, a per-pair top-k with ties to the lower row, then the
``merge_pairs`` order (lower probe rank first).

Tolerances: the row norms agree with the JAX XLA function to rtol 1e-6
(float32 sums in another order); the LUT-mode codebooks are equal. On
small-integer inputs every product and sum is exact, so values, ids and
their order are equal; on Gaussian inputs ``assert_knn_close`` at rtol
1e-5 (float32 against float64).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.ops.ivf_pq_scan import decoded_row_norms as jax_row_norms
from raft_tpu.ops.ivf_pq_scan import make_cb_matrix
from raft_tpu_torch import convert
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.ops import ivf_pq_scan as tpq
from test_torch_kernels import (assert_knn_close, assert_knn_sets_close,
                                pq_scan_args, pq_store)
from test_torch_slice import _clustered

torch.set_num_threads(1)

K = 10


def _contract(store, cb, k, metric, pen):
    """numpy float64 statement of the Pallas scan + merge (module
    docstring) over the codebook ``cb`` of the LUT mode."""
    f = lambda name: store[name].numpy().astype(np.float64)  # noqa: E731
    codes = store["codes"].numpy().astype(np.int64)
    dn, centers, q = f("row_norms"), f("centers_rot"), f("q_rot")
    offsets, sizes = store["offsets"].numpy(), store["sizes"].numpy()
    cb = np.asarray(cb, np.float64)
    pq_dim, _, pq_len = cb.shape
    m = q.shape[0]
    out_v = np.full((m, k), np.inf)
    out_i = np.full((m, k), -1, np.int64)
    for i in range(m):
        vals, ids = [], []
        for lst in store["probed"].numpy()[i]:
            r = np.arange(offsets[lst], offsets[lst] + sizes[lst])
            dec = cb[np.arange(pq_dim)[None, :], codes[r]]
            pq = (q[i].reshape(pq_dim, pq_len)[None] * dec).sum(axis=(1, 2))
            qc = q[i] @ centers[lst]
            if metric == "l2":
                d = np.maximum(q[i] @ q[i] + dn[r] - 2 * qc - 2 * pq, 0.0)
            else:
                d = -qc - pq
            if pen is not None:
                d = d + pen.numpy()[r]
            o = np.lexsort((r, d))[:k]                 # per pair
            vals.append(d[o])
            ids.append(r[o])
        v, r = np.concatenate(vals), np.concatenate(ids)
        o = np.argsort(v, kind="stable")[:k]           # merge_pairs
        out_v[i, : len(o)] = v[o]
        out_i[i, : len(o)] = np.where(np.isfinite(v[o]), r[o], -1)
    return out_v, out_i


def _mode_codebook_numpy(cb: np.ndarray, mode: str) -> np.ndarray:
    """The LUT-mode codebook in numpy/JAX, independent of the port."""
    if mode == "bf16":
        return np.asarray(jnp.asarray(cb).astype(jnp.bfloat16).astype(
            jnp.float32))
    if mode == "int8":
        scales = np.maximum(np.abs(cb).max(axis=(1, 2)),
                            np.float32(1e-12)) / np.float32(127.0)
        vals = np.clip(np.round(cb / scales[:, None, None]), -127, 127)
        return vals.astype(np.int8).astype(np.float32) * scales[:, None,
                                                                None]
    return cb


@pytest.mark.parametrize("pq_bits", [4, 8])
def test_decoded_row_norms_match_jax(pq_bits):
    st = pq_store(False, pq_bits, pq_bits)
    want = jax_row_norms(jnp.asarray(st["codes"].numpy()),
                         jnp.asarray(st["centers_rot"].numpy()),
                         jnp.asarray(st["codebooks"].numpy()),
                         st["list_offsets"])
    np.testing.assert_allclose(st["row_norms"].numpy(), np.asarray(want),
                               rtol=1e-6)


@pytest.mark.parametrize("pq_bits", [4, 8])
def test_lut_mode_codebooks_match_jax(pq_bits):
    """bf16: the codebook rounded as jnp.bfloat16 rounds it; int8: the
    scales and values of ``_ivf_pq_scan_jit``'s quantization of the
    block-diagonal codebook matrix, recomputed with its own lines."""
    cb = pq_store(False, 11, pq_bits)["codebooks"]
    pq_dim, book, pq_len = cb.shape
    np.testing.assert_array_equal(tpq.lut_codebook(cb, "f32").numpy(),
                                  cb.numpy())
    np.testing.assert_array_equal(
        tpq.lut_codebook(cb, "bf16").numpy(),
        np.asarray(jnp.asarray(cb.numpy()).astype(jnp.bfloat16).astype(
            jnp.float32)))
    cbm = make_cb_matrix(jnp.asarray(cb.numpy()))
    rot_pad = cbm.shape[0]
    absmax = jnp.max(jnp.abs(cbm).reshape(rot_pad, book, pq_dim),
                     axis=(0, 1))
    scales = jnp.maximum(absmax, 1e-12) / 127.0
    q8 = np.asarray(jnp.clip(jnp.round(
        cbm.reshape(rot_pad, book, pq_dim) / scales[None, None, :]),
        -127, 127).astype(jnp.int8))
    # cb_matrix[s*pq_len + l, b*pq_dim + s] holds cb[s, b, l]
    want = np.stack([q8[s * pq_len : (s + 1) * pq_len, :, s].T
                     for s in range(pq_dim)])
    vals, got_scales = tpq.int8_codebook(cb)
    np.testing.assert_array_equal(got_scales.numpy(), np.asarray(scales))
    np.testing.assert_array_equal(vals.numpy(), want)
    np.testing.assert_array_equal(
        tpq.lut_codebook(cb, "int8").numpy(),
        want.astype(np.float32) * np.asarray(scales)[:, None, None])


@pytest.mark.parametrize("pq_bits", [4, 8])
@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_plain_scan_matches_contract(mode, metric, with_penalty, pq_bits):
    st = pq_store(False, pq_bits, pq_bits)
    pen = st["penalty"] if with_penalty else None
    want_v, want_i = _contract(
        st, _mode_codebook_numpy(st["codebooks"].numpy(), mode), K, metric,
        pen)
    v, i = tpq.ivf_pq_scan(*pq_scan_args(st, mode), K, metric, pen)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    assert_knn_close(want_v, want_i, v.numpy(), i.numpy(), rtol=1e-5)


@pytest.mark.parametrize("pq_bits", [4, 8])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_plain_scan_integer_inputs_exact(mode, metric, pq_bits):
    """Ties everywhere: equal values go to the lower probe rank, then the
    lower row, in the contract and in the port."""
    st = pq_store(True, 20 + pq_bits, pq_bits)
    want_v, want_i = _contract(st, st["codebooks"].numpy(), K, metric,
                               st["penalty"])
    v, i = tpq.ivf_pq_scan(*pq_scan_args(st, mode), K, metric,
                           st["penalty"])
    np.testing.assert_array_equal(v.numpy(), want_v.astype(np.float32))
    np.testing.assert_array_equal(i.numpy(), want_i)


def test_empty_list_and_k_past_candidates():
    """A probe of only the empty list gives a row of (+inf, -1); k past a
    query's candidates pads its row the same way."""
    st = pq_store(True, 3, 8, n=300, lists=16, m=12, p=2)
    st["probed"][:4] = 3                              # list 3 is empty
    k = 80
    want_v, want_i = _contract(st, st["codebooks"].numpy(), k, "l2", None)
    v, i = tpq.ivf_pq_scan(*pq_scan_args(st, "f32"), k, "l2")
    np.testing.assert_array_equal(v.numpy(), want_v.astype(np.float32))
    np.testing.assert_array_equal(i.numpy(), want_i)
    assert np.isinf(v[:4].numpy()).all() and (i[:4].numpy() == -1).all()
    assert (i.numpy() == -1).any(axis=1).all()



@pytest.fixture(scope="module", params=[4, 8])
def carried_pq(request):
    """A JAX-built IVF-PQ index (4,000 rows of 32 dims, 32 lists, pq_dim
    16 at 4 bits or 8 at 8 bits) and its queries, carried into the port
    by ``convert``."""
    pq_bits = request.param
    x, q = _clustered(4000, 64, 32, 4)
    jidx = jpq.build(jnp.asarray(x), jpq.IndexParams(
        n_lists=32, pq_dim=16 if pq_bits == 4 else 8, pq_bits=pq_bits,
        seed=0))
    tidx = convert.ivf_pq_index_from_numpy(
        {"codes": np.asarray(jidx.codes),
         "source_ids": np.asarray(jidx.source_ids),
         "centers_rot": np.asarray(jidx.centers_rot),
         "codebooks": np.asarray(jidx.codebooks),
         "rotation": np.asarray(jidx.rotation),
         "list_offsets": jidx.list_offsets,
         "list_sizes_arr": jidx.list_sizes_arr,
         "metric": jidx.metric.value, "pq_bits": jidx.pq_bits,
         "codebook_kind": jidx.codebook_kind}, device="cpu")
    return jidx, tidx, q


@pytest.mark.parametrize("k,n_probes", [(257, 8), (512, 8), (512, 3)])
def test_plain_scan_wide_k_matches_jax_xla(carried_pq, k, n_probes):
    """The plain K4 + merge at the grouped form's new widths, through
    ``ivf_pq.search`` on a JAX-built index, against JAX's exact
    ``algo="xla"`` engine at the f32 LUT: values to rtol 1e-4 slot by slot
    (the port's expanded form against JAX's residual form, as in
    ``test_torch_ivf_pq.py``), ids as sets (near ties reorder ids over
    this many slots); with 3 probes of ~125 rows, fewer candidates than
    k: (+inf, -1) past them in both."""
    jidx, tidx, q = carried_pq
    jv, ji = jpq.search(jidx, jnp.asarray(q), k,
                        jpq.SearchParams(n_probes, lut_dtype=jnp.float32),
                        algo="xla")
    tv, ti = ivf_pq.search(tidx, torch.from_numpy(q), k,
                           ivf_pq.SearchParams(n_probes,
                                               lut_dtype=torch.float32))
    assert tv.shape == (len(q), k) and ti.dtype == torch.int32
    assert_knn_sets_close(np.asarray(jv), np.asarray(ji), tv.numpy(),
                          ti.numpy(), rtol=1e-4)
    assert (ti.numpy() == -1).any() == (n_probes == 3)
