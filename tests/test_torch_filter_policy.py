"""The port's adaptive filter policy (``ops/filter_policy.py``) against the
JAX package's (``raft_tpu/ops/filter_policy.py``), run as
``tests/test_filter_adaptive.py`` runs it: indexes built by ``raft_tpu``
on the CPU, carried over with ``raft_tpu_torch.convert``, and searched by
both packages with the same filters (numpy masks from a seed).

Covered: per-list survivors with capacity-slack rows, the decisions'
fields under the settings ``RAFT_TPU_FILTER_BRUTE_MAX`` and
``RAFT_TPU_FILTER_WIDEN_MAX``, the selectivity decades, the crossover and
the widened searches of the four families, the sentinel padding when
fewer than k rows survive, ``suspended()``, a filtered search after an
extend into slack, a crossover verdict, and a crossover whose brute pass
raises.

Tolerances. On integer-valued rows and queries every distance is an
exact float32 integer and ties go to the lowest id in both packages, so
brute force, IVF-Flat and CAGRA (the JAX random seed rows injected) give
equal ids and distances. IVF-PQ's crossover searches the survivors
decoded and rotated back, which the two packages round differently (the
rotation is a float32 product), and its widened scan sums the expanded
form where JAX's gather engine sums the residual form: distances to rtol
1e-4 and ids equal on >= 98% of rows (``test_torch_ivf_pq.py``'s
contract), at ``lut_dtype=float32``.
"""
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.bitset import Bitset as JaxBitset
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.ops import filter_policy as jfp
from raft_tpu_torch import convert
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
from raft_tpu_torch.ops import autotune
from raft_tpu_torch.ops import filter_policy as fp
from test_torch_kernels import assert_knn_close

torch.set_num_threads(1)

N, D, M, K, N_LISTS = 3000, 32, 20, 10, 16
JSP = dict(itopk_size=16, search_width=1, max_iterations=6)


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


@pytest.fixture(scope="module")
def data():
    """Integer-valued rows and queries (exact float32 distances)."""
    rng = np.random.default_rng(7)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    q = rng.integers(-4, 5, (M, D)).astype(np.float32)
    return x, q


def make_mask(survivors: int, seed: int = 3, n: int = N) -> np.ndarray:
    mask = np.zeros(n, bool)
    if survivors:
        rng = np.random.default_rng(seed)
        mask[rng.choice(n, size=survivors, replace=False)] = True
    return mask


def bitsets(mask):
    return (JaxBitset.from_mask(jnp.asarray(mask)),
            Bitset.from_mask(torch.from_numpy(mask)))


def _carry_flat(j):
    return convert.ivf_flat_index_from_numpy(
        {"data": np.asarray(j.data), "data_norms": np.asarray(j.data_norms),
         "source_ids": np.asarray(j.source_ids),
         "centers": np.asarray(j.centers),
         "center_norms": np.asarray(j.center_norms),
         "list_offsets": j.list_offsets, "list_sizes_arr": j.list_sizes_arr,
         "metric": j.metric.value}, device="cpu")


def _carry_pq(j):
    return convert.ivf_pq_index_from_numpy(
        {"codes": np.asarray(j.codes), "source_ids": np.asarray(j.source_ids),
         "centers_rot": np.asarray(j.centers_rot),
         "codebooks": np.asarray(j.codebooks),
         "rotation": np.asarray(j.rotation),
         "list_offsets": j.list_offsets, "list_sizes_arr": j.list_sizes_arr,
         "metric": j.metric.value, "pq_bits": j.pq_bits,
         "codebook_kind": j.codebook_kind}, device="cpu")


@pytest.fixture(scope="module")
def flat(data):
    """JAX IVF-Flat with capacity slack (list_growth 1.5), carried over."""
    j = jivf.build(data[0], jivf.IndexParams(n_lists=N_LISTS, seed=0,
                                             list_growth=1.5))
    return j, _carry_flat(j)


@pytest.fixture(scope="module")
def pq(data):
    j = jpq.build(data[0], jpq.IndexParams(n_lists=N_LISTS, pq_dim=8,
                                           seed=0))
    return j, _carry_pq(j)


@pytest.fixture(scope="module")
def bf(data):
    j = jbf.build(jnp.asarray(data[0]))
    return j, convert.brute_force_index_from_numpy(
        {"dataset": np.asarray(j.dataset), "norms": np.asarray(j.norms),
         "metric": j.metric.value}, device="cpu")


@pytest.fixture(scope="module")
def cg(data):
    j = jcagra.build(data[0], jcagra.IndexParams(
        intermediate_graph_degree=32, graph_degree=16, seed=0, seed_nodes=0))
    return j, convert.cagra_index_from_numpy(
        {"dataset": np.asarray(j.dataset), "graph": np.asarray(j.graph),
         "metric": j.metric.value, "seed_nodes": None}, device="cpu")


@pytest.fixture
def jax_seeds(monkeypatch):
    """Make the port's CAGRA draw the JAX package's random seed rows."""
    def draw(m, n_seeds, high, seed, device):
        r = jax.random.randint(jax.random.key(seed), (m, n_seeds), 0, high)
        return torch.from_numpy(np.array(r)).to(device)

    monkeypatch.setattr(cagra, "_draw_seeds", draw)


def search_both(family, idx, q, mask, k=K, n_probes=4):
    """(JAX's (d, i), the port's (d, i)) as numpy, default policy."""
    j, t = idx
    jf, tf = bitsets(mask)
    if family == "brute_force":
        jr = jbf.search(j, jnp.asarray(q), k, filter=jf, algo="matmul")
        tr = brute_force.search(t, torch.from_numpy(q), k, filter=tf)
    elif family == "ivf_flat":
        jr = jivf.search(j, jnp.asarray(q), k, jivf.SearchParams(
            n_probes=n_probes), filter=jf, algo="xla")
        tr = ivf_flat.search(t, torch.from_numpy(q), k,
                             ivf_flat.SearchParams(n_probes=n_probes),
                             filter=tf)
    elif family == "ivf_pq":
        jr = jpq.search(j, jnp.asarray(q), k, jpq.SearchParams(
            n_probes=n_probes, lut_dtype=jnp.float32), filter=jf,
            algo="xla")
        tr = ivf_pq.search(t, torch.from_numpy(q), k, ivf_pq.SearchParams(
            n_probes=n_probes, lut_dtype=torch.float32), filter=tf)
    else:
        jr = jcagra.search(j, jnp.asarray(q), k, jcagra.SearchParams(
            candidate_dtype="float32", **JSP), filter=jf, engine="gather")
        tr = cagra.search(t, torch.from_numpy(q), k, cagra.SearchParams(
            candidate_dtype="float32", **JSP), filter=tf, engine="gather")
    return ((np.asarray(jr[0]), np.asarray(jr[1])),
            (tr[0].numpy(), tr[1].numpy()))


def assert_same(jr, tr, family):
    if family == "ivf_pq":
        assert_knn_close(*jr, *tr, rtol=1e-4, min_rows_equal=0.98)
    else:
        np.testing.assert_array_equal(tr[1], jr[1])
        np.testing.assert_array_equal(tr[0], jr[0])


# --- survivor counts -------------------------------------------------------

@pytest.mark.parametrize("survivors", [0, 1, 300, 2999])
def test_list_survivors_with_slack_matches_jax(flat, survivors):
    j, t = flat
    assert int(t.data.shape[0]) > t.size      # the layout has slack rows
    jf, tf = bitsets(make_mask(survivors))
    got = fp.list_survivors(t, tf)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfp.list_survivors(j, jf)))
    assert int(got.sum()) == survivors


def test_list_labels_cache_follows_the_offsets(flat):
    """The cached labels equal JAX's, and an index with other offsets
    never reads labels cached for another layout."""
    j, t = flat
    tf = Bitset.from_mask(torch.ones(N, dtype=torch.bool))
    fp.list_survivors(t, tf)
    np.testing.assert_array_equal(t._filter_list_labels[1].numpy(),
                                  np.asarray(jfp._list_labels(j)))
    # the same rows, every one in the last list, with the stale cache
    offsets = np.zeros(N_LISTS + 1, np.int64)
    offsets[-1] = int(t.list_offsets[-1])
    other = types.SimpleNamespace(
        source_ids=t.source_ids, list_offsets=offsets, n_lists=N_LISTS,
        device=t.device, _filter_list_labels=t._filter_list_labels)
    got = fp.list_survivors(other, tf)
    assert int(got[-1]) == N and int(got[:-1].sum()) == 0


# --- decisions -------------------------------------------------------------

SETTINGS = {"default": {}, "no_brute": {"RAFT_TPU_FILTER_BRUTE_MAX": "0"},
            "widen2": {"RAFT_TPU_FILTER_BRUTE_MAX": "0",
                       "RAFT_TPU_FILTER_WIDEN_MAX": "2"},
            "brute50": {"RAFT_TPU_FILTER_BRUTE_MAX": "50"}}


def _fields(fd):
    return (fd.selectivity, fd.survivors, fd.level, fd.n_probes,
            fd.lists_pruned, fd.use_brute)


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("survivors", [0, 30, 300, 1500, 2700, N])
@pytest.mark.parametrize("n_probes", [2, 4])
def test_decide_ivf_matches_jax(flat, monkeypatch, setting, survivors,
                                n_probes):
    for name, value in SETTINGS[setting].items():
        monkeypatch.setenv(name, value)
    j, t = flat
    jf, tf = bitsets(make_mask(survivors, seed=survivors))
    jd = jfp.decide_ivf(j, jf, n_probes, K, "ivf_flat")
    td = fp.decide_ivf(t, tf, n_probes, K, "ivf_flat")
    assert _fields(td) == _fields(jd)
    np.testing.assert_array_equal(td.surv_dev.numpy(),
                                  np.asarray(jd.surv_dev))


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("frac", [0.0, 0.001, 0.009, 0.05, 0.2, 0.6, 1.0])
def test_decide_graph_matches_jax(monkeypatch, setting, frac):
    for name, value in SETTINGS[setting].items():
        monkeypatch.setenv(name, value)
    jf, tf = bitsets(make_mask(int(N * frac), seed=11))
    jd = jfp.decide_graph(jf, N, D, K)
    td = fp.decide_graph(tf, N, D, K)
    assert _fields(td) == _fields(jd)
    assert td.surv_dev is None


def test_selectivity_bucket_matches_jax():
    for s in (0.0, -1.0, 1e-9, 1e-4, 1e-3, 0.009, 0.05, 0.1, 0.5, 1.0, 2.0):
        assert fp.selectivity_bucket(s) == jfp.selectivity_bucket(s)
    assert fp.LEVELS == jfp.LEVELS


def test_crossover_verdict_steers_the_decision(flat):
    """A recorded race winner overrides the survivor threshold, under the
    selectivity decade's key (which names the device)."""
    _, t = flat
    tf = Bitset.from_mask(torch.from_numpy(make_mask(30)))
    q = torch.zeros((2, D))
    key, winner, times = fp.tune_crossover(
        "ivf_flat", t.size, t.dim, K, 30 / N, lambda qq: qq + 1,
        lambda qq: qq + 2, q, reps=1)
    assert key == fp.crossover_key("ivf_flat", t.size, t.dim, K, 0.01,
                                   "cpu")
    assert key.startswith("cpu:cpu:filter_brute") and ":sele2" in key
    assert autotune.lookup(key) == winner and set(times) == {"scan",
                                                            "brute"}
    try:
        autotune.record(key, "scan")
        assert not fp.decide_ivf(t, tf, 4, K, "ivf_flat").use_brute
        autotune.record(key, "brute")
        assert fp.decide_ivf(t, tf, 4, K, "ivf_flat").use_brute
        # a "brute" verdict never crosses over with nothing surviving
        none = Bitset.from_mask(torch.zeros(N, dtype=torch.bool))
        assert not fp.decide_ivf(t, none, 4, K, "ivf_flat").use_brute
    finally:
        autotune.forget(key)


# --- searches --------------------------------------------------------------

FAMILIES = ["brute_force", "ivf_flat", "ivf_pq", "cagra"]


def _index(family, bf, flat, pq, cg):
    return {"brute_force": bf, "ivf_flat": flat, "ivf_pq": pq,
            "cagra": cg}[family]


@pytest.mark.parametrize("family", FAMILIES)
def test_crossover_matches_jax(data, bf, flat, pq, cg, jax_seeds, family,
                               monkeypatch):
    """50 survivors: both packages cross over (the port's brute pass
    observed) and agree."""
    calls = []
    for name in ("survivor_brute_ivf", "survivor_brute_dense"):
        orig = getattr(fp, name)
        monkeypatch.setattr(fp, name, lambda *a, _o=orig, **kw: (
            calls.append(1), _o(*a, **kw))[1])
    mask = make_mask(50, seed=5)
    jr, tr = search_both(family, _index(family, bf, flat, pq, cg), data[1],
                         mask)
    assert calls == [1]
    assert_same(jr, tr, family)
    assert mask[tr[1][tr[1] >= 0]].all() and (tr[1] >= 0).all()


@pytest.mark.parametrize("family", FAMILIES)
def test_widened_matches_jax(data, bf, flat, pq, cg, jax_seeds, family,
                             monkeypatch):
    """300 survivors with the crossover off: IVF widens 2 probes to 16,
    CAGRA itopk 16 to 64 (selectivity 0.1: level 2 ... 0.01: level 4);
    brute force is the plain filtered scan."""
    monkeypatch.setenv("RAFT_TPU_FILTER_BRUTE_MAX", "0")
    mask = make_mask(300, seed=6)
    _, tf = bitsets(mask)
    if family in ("ivf_flat", "ivf_pq"):
        fd = fp.decide_ivf(_index(family, bf, flat, pq, cg)[1], tf, 2, K,
                           family)
        assert fd.level > 1 and not fd.use_brute
    elif family == "cagra":
        assert fp.decide_graph(tf, N, D, K).level > 1
    jr, tr = search_both(family, _index(family, bf, flat, pq, cg), data[1],
                         mask, n_probes=2)
    assert_same(jr, tr, family)
    assert mask[tr[1][tr[1] >= 0]].all()


@pytest.mark.parametrize("survivors", [0, 1, K - 1])
@pytest.mark.parametrize("family", FAMILIES)
def test_sentinel_padding_matches_jax(data, bf, flat, pq, cg, jax_seeds,
                                      family, survivors):
    """Fewer than k survivors: the survivors first, then (+inf, -1), as
    JAX's."""
    mask = make_mask(survivors, seed=survivors + 5)
    jr, tr = search_both(family, _index(family, bf, flat, pq, cg),
                         data[1][:4], mask)
    d, i = tr
    assert (i[:, survivors:] == -1).all() and np.isinf(d[:, survivors:]).all()
    for row in i:
        assert set(row[:survivors].tolist()) == set(np.nonzero(mask)[0])
    np.testing.assert_array_equal(i, jr[1])
    np.testing.assert_array_equal(np.isinf(d), np.isinf(jr[0]))


def test_inner_product_crossover_pads_minus_inf(data):
    x, q = data
    t = brute_force.build(x, "inner_product", device="cpu")
    j = jbf.build(jnp.asarray(x), "inner_product")
    mask = make_mask(3, seed=2)
    jf, tf = bitsets(mask)
    d, i = brute_force.search(t, q[:3], K, filter=tf)
    jd, ji = jbf.search(j, jnp.asarray(q[:3]), K, filter=jf, algo="matmul")
    assert (i[:, 3:] == -1).all() and bool((d[:, 3:] == -np.inf).all())
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_suspended_is_thread_local_and_nests():
    assert not fp.adaptive_off()
    seen = []
    with fp.suspended():
        assert fp.adaptive_off()
        with fp.suspended():
            assert fp.adaptive_off()
        assert fp.adaptive_off()
        th = threading.Thread(target=lambda: seen.append(fp.adaptive_off()))
        th.start()
        th.join(10)
        assert not th.is_alive()
    assert seen == [False] and not fp.adaptive_off()
    with pytest.raises(KeyError):
        with fp.suspended():
            raise KeyError("x")
    assert not fp.adaptive_off()


@pytest.mark.parametrize("family", FAMILIES)
def test_suspended_search_matches_jax_suspended(data, bf, flat, pq, cg,
                                                jax_seeds, family,
                                                monkeypatch):
    """Inside both packages' ``suspended()`` no crossover runs and no
    probe widens: the penalty and the prune alone, as JAX's."""
    monkeypatch.setattr(fp, "survivor_brute_ivf", None)
    monkeypatch.setattr(fp, "survivor_brute_dense", None)
    mask = make_mask(50, seed=5)
    with fp.suspended(), jfp.suspended():
        jr, tr = search_both(family, _index(family, bf, flat, pq, cg),
                             data[1], mask)
    assert_same(jr, tr, family)


def check_exact(x, q, mask, got, ordered: bool):
    """``got`` = (d, i) is the exact filtered top-K of ``q`` over the rows
    ``x``: the k smallest distances among the survivors, each id a
    survivor at its distance. ``ordered``: the ids also in the oracle's
    order, ties to the lowest id (the crossover's; a scan breaks ties by
    storage row)."""
    d, i = got[0].numpy(), got[1].numpy()
    ids = np.nonzero(mask)[0]
    dist = ((q[:, None, :] - x[None, ids]) ** 2).sum(-1)
    order = np.argsort(dist, axis=1, kind="stable")[:, :K]
    np.testing.assert_array_equal(d, np.take_along_axis(dist, order, 1))
    if ordered:
        np.testing.assert_array_equal(i, ids[order])
    assert mask[i].all()
    np.testing.assert_array_equal(((q[:, None, :] - x[i]) ** 2).sum(-1), d)


@pytest.mark.parametrize("setting", ["crossover", "widened"])
def test_filtered_search_after_extend_into_slack(data, monkeypatch,
                                                 setting):
    """A filtered search, then an extend that scatters into the slack, then
    the same filtered search: the new rows are found (the caches of the
    first index are not the second's), and the first index still answers
    for its own rows. A source-id edit in place drops the caches too."""
    if setting == "widened":
        monkeypatch.setenv("RAFT_TPU_FILTER_BRUTE_MAX", "0")
    x, q = data
    idx = ivf_flat.build(x[:2000], ivf_flat.IndexParams(
        n_lists=8, list_growth=1.8), device="cpu")
    sp = ivf_flat.SearchParams(n_probes=8)     # every list: exact
    mask = make_mask(400, seed=9)
    tf = Bitset.from_mask(torch.from_numpy(mask))
    before = ivf_flat.search(idx, q, K, sp, filter=tf)
    old = mask.copy()
    old[2000:] = False
    check_exact(x, q, old, before, setting == "crossover")
    grown = ivf_flat.extend(idx, x[2000:])
    np.testing.assert_array_equal(grown.list_offsets, idx.list_offsets)
    after = ivf_flat.search(grown, q, K, sp, filter=tf)
    check_exact(x, q, mask, after, setting == "crossover")
    assert (after[1] >= 2000).any()
    again = ivf_flat.search(idx, q, K, sp, filter=tf)
    assert torch.equal(again[1], before[1])
    # an edit in place swaps the ids of two rows (query 0's nearest
    # survivor and a filtered-out id): the cached inverse is dropped
    s_in, s_out = int(after[1][0, 0]), int(np.nonzero(~mask)[0][0])
    sid = grown.source_ids
    a, b = int((sid == s_in).nonzero()), int((sid == s_out).nonzero())
    sid[a], sid[b] = s_out, s_in
    x2 = x.copy()
    x2[[s_in, s_out]] = x[[s_out, s_in]]
    edited = ivf_flat.search(grown, q, K, sp, filter=tf)
    check_exact(x2, q, mask, edited, setting == "crossover")
    assert not torch.equal(edited[0], after[0])


def test_ivf_pq_crossover_after_extend_into_slack(data):
    """IVF-PQ's crossover through ``reconstruct`` finds the extended rows
    and equals brute force over the survivors decoded."""
    x, q = data
    idx = ivf_pq.build(x[:2000], ivf_pq.IndexParams(
        n_lists=8, pq_dim=8, list_growth=1.8), device="cpu")
    mask = make_mask(200, seed=12)
    tf = Bitset.from_mask(torch.from_numpy(mask))
    ivf_pq.search(idx, q, K, filter=tf)
    grown = ivf_pq.extend(idx, x[2000:])
    d, i = ivf_pq.search(grown, q, K, filter=tf)
    ids = np.nonzero(mask)[0]
    sid = grown.source_ids.numpy()
    rows = np.array([np.nonzero(sid == s)[0][0] for s in ids])
    dec = ivf_pq.reconstruct(grown, rows)
    ref_d, ref_i = brute_force.search(brute_force.build(dec, device="cpu"),
                                      q, K)
    np.testing.assert_array_equal(i.numpy(), ids[ref_i.numpy()])
    np.testing.assert_array_equal(d.numpy(), ref_d.numpy())
    assert (i >= 2000).any()


@pytest.mark.parametrize("family", ["brute_force", "ivf_flat", "ivf_pq",
                                    "cagra"])
def test_failing_crossover_raises(data, bf, flat, pq, cg, family,
                                  monkeypatch):
    """No fallback: a brute pass that raises makes the search raise."""
    def boom(*a, **kw):
        raise RuntimeError("brute pass failed")

    monkeypatch.setattr(brute_force, "fused_knn", boom)
    _, t = _index(family, bf, flat, pq, cg)
    tf = Bitset.from_mask(torch.from_numpy(make_mask(50, seed=5)))
    q = torch.from_numpy(data[1])
    search = {"brute_force": lambda: brute_force.search(t, q, K, filter=tf),
              "ivf_flat": lambda: ivf_flat.search(t, q, K, filter=tf),
              "ivf_pq": lambda: ivf_pq.search(t, q, K, filter=tf),
              "cagra": lambda: cagra.search(t, q, K, filter=tf)}[family]
    with pytest.raises(RuntimeError, match="brute pass failed"):
        search()


def test_widened_cagra_past_k6_runs_the_edge_engine(data, cg, monkeypatch):
    """itopk 64 x 8 = 512 is past K6's 256: an explicit fused search,
    widened there, runs the edge engine and no fused traversal."""
    monkeypatch.setenv("RAFT_TPU_FILTER_BRUTE_MAX", "0")
    _, t = cg
    hops = []

    def no_fused(*a, **kw):
        raise AssertionError("the fused traversal ran")

    orig = cagra.edge_hop
    monkeypatch.setattr(cagra, "fused_traverse", no_fused)
    monkeypatch.setattr(cagra, "edge_hop", lambda *a, **kw: (
        hops.append(1), orig(*a, **kw))[1])
    mask = make_mask(20, seed=4)       # selectivity 0.0067: level 8
    tf = Bitset.from_mask(torch.from_numpy(mask))
    sp = cagra.SearchParams(itopk_size=64, max_iterations=3)
    d, i = cagra.search(t, torch.from_numpy(data[1][:4]), K, sp, filter=tf,
                        engine="fused")
    assert hops and mask[i[i >= 0].numpy()].all()
    # unwidened, the fused engine serves the plan (its traversal stubbed)
    fused, hops[:] = [], []
    monkeypatch.setattr(cagra, "fused_traverse", lambda q, d, i, *a, **kw: (
        fused.append(1), (d, i))[1])
    with fp.suspended():
        cagra.search(t, torch.from_numpy(data[1][:4]), K, sp, filter=tf,
                     engine="fused")
    assert fused and not hops
