"""The port past its kernels' old limits — K2 past its k-lists (k = 256
until the wide form took every k past 64), K3 and K4 past 512 and 1024 —
against the JAX package, whose kernels take any k: brute
force at k = 300 and k = n against ``brute_force.search(algo="matmul")``,
IVF-Flat (every store) and IVF-PQ (f32 LUT) at k = 1,100 on JAX-built
indexes against the ``algo="xla"`` engines, and CAGRA's exact graph at
intermediate degree 256; then the wrappers' plans past the old limits
(K2's split rule and buffers, the wide scans' scratch, the IVF-PQ graph
pass's batch), which ``chip_smoke.py`` holds against each library on the
card.

On the CPU every wrapper runs its kernel's plain version, so this is the
port's contract at these k; the card tests (``test_torch_kernels.py``,
marked ``cuda``) hold the kernels to the plain versions bit for bit.

Tolerances, as in ``test_torch_stores.py``. Integer-valued data: values
and ids, and their order, equal. Gaussian data: distances slot by slot to
``rtol=1e-5`` (IVF-PQ: 1e-4, its expanded form against JAX's residual
form), ids as sets (``assert_knn_sets_close``: over this many slots near
ties reorder ids).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
from raft_tpu_torch.ops import autotune
from raft_tpu_torch.ops import fused_knn as tfk
from raft_tpu_torch.ops import ivf_scan as tis
from test_torch_ivf_pq import _carry as _carry_pq
from test_torch_kernels import assert_knn_sets_close
from test_torch_slice import _clustered
from test_torch_stores import _carry_bf, _carry_ivf, _source_rows

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

M, N, D = 24, 2000, 32
IVF_K = 1100


def _check(jv, ji, tv, ti, exact: bool, rtol: float = 1e-5):
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = tv.numpy(), ti.numpy()
    assert tv.shape == jv.shape and ti.dtype == np.int32
    if exact:
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti, ji)
    else:
        assert_knn_sets_close(jv, ji, tv, ti, rtol=rtol)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("store", ["float32", "int8"])
@pytest.mark.parametrize("k", [300, N])
def test_brute_force_past_256_matches_jax(k, store, integer):
    """Brute force at k = 300 (past K2's k-lists) and k = n on a JAX-built
    index of each store, carried over, against JAX's matmul engine; k = n
    returns every row, in the (value, row) order."""
    x, q = _source_rows("bfloat16" if store == "float32" else store,
                        integer, N, D, M, 21)
    jidx = jbf.build(jnp.asarray(x), "sqeuclidean", dtype=store)
    tidx = _carry_bf(jidx)
    jv, ji = jbf.search(jidx, q, k, algo="matmul")
    tv, ti = brute_force.search(tidx, q, k)
    _check(jv, ji, tv, ti, integer)
    if k == N:
        assert sorted(ti[0].tolist()) == list(range(N))


def _ivf_case(store: str, integer: bool):
    x, q = _source_rows("bfloat16" if store == "float32" else store,
                        integer, 3000, D, M, 22)
    jidx = jivf.build(jnp.asarray(x), jivf.IndexParams(
        n_lists=16, seed=0, dtype=store))
    return jidx, _carry_ivf(jidx), q


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("store", ["float32", "bfloat16", "int8", "uint8"])
def test_ivf_flat_past_1024_matches_jax_xla(store, integer):
    """IVF-Flat at k = 1,100 (past the per-pair form's 1,024: the grouped
    form's wide plan on the card) on a JAX-built index of each store,
    carried over, against JAX's exact ``algo="xla"`` engine, at 8 probes
    of 16 lists (~1,500 candidates a query) and at 4 (fewer than k:
    (+inf, -1) past them in both)."""
    jidx, tidx, q = _ivf_case(store, integer)
    for n_probes in (8, 4):
        jv, ji = jivf.search(jidx, q, IVF_K,
                             jivf.SearchParams(n_probes=n_probes),
                             algo="xla")
        tv, ti = ivf_flat.search(tidx, q, IVF_K,
                                 ivf_flat.SearchParams(n_probes=n_probes))
        _check(jv, ji, tv, ti, integer)
        if n_probes == 4:
            assert (ti.numpy() == -1).any()


def test_ivf_pq_past_1024_matches_jax_xla():
    """IVF-PQ (pq 8 x 8 bits, f32 LUT) at k = 1,100 on a JAX-built index,
    carried over, against JAX's ``algo="xla"`` engine: distances slot by
    slot at rtol 1e-4, ids as sets; 12 of 32 probes hold ~1,500 rows a
    query, 4 fewer than k ((+inf, -1) past them in both)."""
    x, q = _clustered(4000, M, D, 5)
    jidx = jpq.build(jnp.asarray(x), jpq.IndexParams(
        n_lists=32, seed=0, pq_dim=8, pq_bits=8))
    tidx = _carry_pq(jidx)
    for n_probes in (12, 4):
        jv, ji = jpq.search(jidx, jnp.asarray(q), IVF_K,
                            jpq.SearchParams(n_probes,
                                             lut_dtype=jnp.float32),
                            algo="xla")
        tv, ti = ivf_pq.search(tidx, torch.from_numpy(q), IVF_K,
                               ivf_pq.SearchParams(n_probes,
                                                   lut_dtype=torch.float32))
        _check(jv, ji, tv, ti, False, rtol=1e-4)
        if n_probes == 4:
            assert (ti.numpy() == -1).any()


def test_cagra_exact_graph_at_degree_256_matches_jax():
    """CAGRA's exact route at intermediate degree 256 (brute force at
    k = 257, past K2's k-lists on the card) on 3,000 integer-valued rows:
    the port's graph equals JAX's, through the exact route and through
    ``auto`` (the exact route below ``BRUTE_N`` rows), batched or not."""
    xi = np.random.default_rng(23).integers(-4, 5, (3000, 16)).astype(
        np.float32)
    jg = jcagra.build_knn_graph(xi, 256, algo="brute", engine="matmul")
    for algo, batch in (("brute", 1000), ("auto", 32768)):
        tg = cagra.build_knn_graph(xi, 256, algo=algo, batch=batch,
                                   device="cpu")
        np.testing.assert_array_equal(tg.numpy(), jg)


# ---- the plans past the old limits ----

@pytest.mark.parametrize("m,n,k,slots", [
    (10_000, 1_000_000, 257, 132), (10_000, 1_000_000, 1024, 132),
    (32_768, 1_000_000, 257, 132), (32_768, 200_000, 513, 132),
    (8, 20_000, 16_500, 132), (100, 20_000, 20_000, 132),
    (200, 40_000, 2048, 264), (1, 1000, 300, 132)])
def test_wide_split_plan(m, n, k, slots):
    """K2's grid past LIST_MAX_K (the wide form): every row in one split
    of a multiple of 128 rows; at least 2k rows a split unless there is
    one split; the buffers, m·splits·wide_cap(k) keys of 8 bytes, within
    WIDE_BUDGET unless there is one split (the splits' merged lists are
    the form's own (m, k) output); 128 queries a block; among the split
    counts it may take, the one whose last wave is fullest (fewest among
    equals). Up to LIST_MAX_K the rule is the k-lists' plan's."""
    splits, rows = tfk.split_plan(m, n, k, slots)
    assert rows % 128 == 0 and (splits - 1) * rows < n <= splits * rows
    if splits > 1:
        assert rows >= 2 * k
        assert 8 * m * splits * tfk.wide_cap(k) <= tfk.WIDE_BUDGET
    most = max(1, min(-(-n // 512), n // (2 * k),
                      tfk.WIDE_BUDGET // (8 * m * tfk.wide_cap(k))))
    tiles = -(-m // 128)
    aim = max(1, min(most, -(-4 * slots // tiles)))
    fill = lambda s: (lambda b: b / (-(-b // slots) * slots))(  # noqa: E731
        tiles * -(-n // (-(-(-(-n // s)) // 128) * 128)))
    best = max(range(max(1, aim // 2), min(most, 2 * aim) + 1),
               key=lambda s: (round(fill(s), 12), -s))
    assert splits == -(-n // (-(-(-(-n // best)) // 128) * 128))


def test_wide_cap_and_buffers():
    """A wide K2 buffer holds 2k keys, at least k + 128, rounded up to the
    128-row tile, so a buffer shrunk to its k best keeps room for a tile's
    128 (the kernel refuses less); a launch's scratch is its buffers at 8
    bytes a key, a 64-bit bound a query and a 32-bit count a (query,
    split). The wide form starts past LIST_MAX_K = 24."""
    for k in (25, 65, 100, 129, 257, 300, 512, 1024, 1025, 16_500):
        cap = tfk.wide_cap(k)
        assert cap % 128 == 0 and cap >= 2 * k and cap >= k + 128
        assert cap < max(2 * k, k + 128) + 128
        assert tfk.wide_scratch_bytes(100, 7, k) == \
            8 * 100 * 7 * cap + 8 * 100 + 4 * 100 * 7
    assert tfk.LIST_MAX_K == 24


def test_wide_scan_scratch_statement():
    """The wide scans' scratch (K4 past 256, K3 past 512), as each library
    states it on the card (``wide_scratch_on_card``, which chip_smoke
    holds to this): a 256-byte counter unit, then 32 distance rows a
    persistent block of the longest list rounded up to 128 floats; it
    does not depend on k."""
    assert tis.wide_scratch_bytes(264, 1590) == 256 + 4 * 264 * 32 * 1664
    assert tis.wide_scratch_bytes(264, 1) == 256 + 4 * 264 * 32 * 128
    assert tis.wide_scratch_bytes(132, 1024) == 256 + 4 * 132 * 32 * 1024


def test_graph_pass_batch_shrinks_with_k():
    """The IVF-PQ graph pass keeps its per-pair candidates (batch x probes
    x (2k + 1) keys of 8 bytes) within PASS_BUDGET: the default batch of
    32,768 rows at intermediate degree 128 (k = 257, 64 probes), fewer
    rows, by 1,024, as k grows, never fewer than 1,024."""
    assert cagra.pass_batch(32768, 64, 257) == 32768
    assert cagra.pass_batch(32768, 64, 513) == 17408
    assert cagra.pass_batch(32768, 64, 1025) == 8192
    assert cagra.pass_batch(500, 64, 1025) == 500
    assert cagra.pass_batch(32768, 64, 10**7) == 1024
    for gpu_k in (257, 513, 1025, 2049):
        b = cagra.pass_batch(32768, 64, gpu_k)
        assert b == 32768 or 8 * b * 64 * gpu_k <= cagra.PASS_BUDGET


def test_no_k_limit_left_below_n():
    """The wrappers' checks past the old limits: brute force takes
    0 < k <= n and refuses k > n; the IVF scans take any k > 0 in the
    grouped form (the per-pair form by name up to 1,024)."""
    x = torch.zeros((300, 8))
    tidx = brute_force.build(x, device="cpu")
    v, i = brute_force.search(tidx, torch.zeros((2, 8)), 300)
    assert v.shape == (2, 300) and sorted(i[0].tolist()) == list(range(300))
    with pytest.raises(RaftError):
        brute_force.search(tidx, torch.zeros((2, 8)), 301)
    assert tis.check_form(None, 5000) == "group"
    with pytest.raises(RaftError):
        tis.check_form("pair", 1025)
