"""Deadlines, cancellation and the chunked searches of the PyTorch port
against the JAX package: ``raft_tpu_torch.core.deadline`` /
``interruptible`` / ``resources`` beside ``raft_tpu.core``'s, the chunk
rule every family shares (``utils.query_chunks``), and ``res=`` /
``query_chunk`` / ``make_searcher`` on brute force, IVF-Flat and IVF-PQ
(CAGRA's are in ``test_torch_cagra.py``).

Tolerances. The deadline clocks are injected, so expiry points and
message fields are equal. Searches: a chunked search equals the
unchunked one bit for bit (each query's answer does not depend on the
rest of its batch), and a ``DeadlineExceeded``'s partial results equal
the finished chunks' rows bit for bit. Against the JAX package on
integer-valued data (exact distances, ties to the lower row in both):
the partial results' ids and values equal JAX's at the same expiry.
"""
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import deadline as jdeadline
from raft_tpu.core import resources as jresources
from raft_tpu.core.resources import Resources
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu_torch import convert
from raft_tpu_torch.core import deadline, interruptible, resources
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from raft_tpu_torch.ops import autotune
from raft_tpu_torch.utils import query_chunks

torch.set_num_threads(1)

N, D, M, K = 2000, 16, 90, 7


@pytest.fixture(scope="module", autouse=True)
def _verdicts_in_memory():
    """No autotune verdict file: this module's verdicts stay in memory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TPU_TORCH_AUTOTUNE_CACHE", "")
        mp.setattr(autotune, "_MEM_CACHE", {})
        mp.setattr(autotune, "_LOADED_FROM", None)
        yield


def test_verdicts_stay_in_memory():
    assert autotune.cache_path() is None


def _ticks(*values):
    """A clock that reads ``values`` in turn, then the last one."""
    it = iter(values)
    last = [values[-1]]

    def clock():
        last[0] = next(it, last[0])
        return last[0]

    return clock


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    q = rng.integers(-4, 5, (M, D)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def indexes(data):
    x, _ = data
    jflat = jivf.build(jnp.asarray(x), jivf.IndexParams(n_lists=12, seed=0))
    flat = convert.ivf_flat_index_from_numpy(
        {"data": np.asarray(jflat.data),
         "data_norms": np.asarray(jflat.data_norms),
         "source_ids": np.asarray(jflat.source_ids),
         "centers": np.asarray(jflat.centers),
         "center_norms": np.asarray(jflat.center_norms),
         "list_offsets": jflat.list_offsets,
         "list_sizes_arr": jflat.list_sizes_arr,
         "metric": jflat.metric.value}, device="cpu")
    return {"bf": brute_force.build(x, device="cpu"), "jbf": jbf.build(x),
            "flat": flat, "jflat": jflat,
            "pq": ivf_pq.build(x, ivf_pq.IndexParams(n_lists=12, pq_dim=8),
                               device="cpu")}


FLAT_SP = ivf_flat.SearchParams(n_probes=5)
PQ_SP = ivf_pq.SearchParams(n_probes=5)


def _searches(indexes):
    """family → search(q, **kw) with the family's index and parameters."""
    return {
        "brute_force": lambda q, **kw: brute_force.search(
            indexes["bf"], q, K, **kw),
        "ivf_flat": lambda q, **kw: ivf_flat.search(
            indexes["flat"], q, K, FLAT_SP, **kw),
        "ivf_pq": lambda q, **kw: ivf_pq.search(
            indexes["pq"], q, K, PQ_SP, **kw)}


FAMILIES = ("brute_force", "ivf_flat", "ivf_pq")


# ------------------------------------------------ the deadline itself


@pytest.mark.parametrize("seconds,ticks", [
    (1.0, (0.0, 0.5, 0.99, 1.0, 3.0)),
    (0.25, (10.0, 10.1, 10.3)),
    (0.0, (2.0, 2.0)),
    (5.0, (0.0, 4.0, 4.9999, 5.0001))])
def test_deadline_matches_jax(seconds, ticks):
    """Expiry, elapsed and remaining time read from one injected clock
    agree with the JAX package's at every read."""
    ours = deadline.Deadline(seconds, clock=_ticks(*ticks))
    theirs = jdeadline.Deadline(seconds, clock=_ticks(*ticks))
    for _ in ticks[1:]:
        assert ours.expired() == theirs.expired()
    ours = deadline.Deadline.after(seconds, clock=_ticks(*ticks))
    theirs = jdeadline.Deadline.after(seconds, clock=_ticks(*ticks))
    for _ in ticks[1:]:
        assert ours.remaining() == theirs.remaining()
        assert ours.elapsed() == theirs.elapsed()


_MSG = re.compile(r"deadline of (\S+)s exceeded \((\S+)s elapsed\); "
                  r"partial results (attached|empty)")


@pytest.mark.parametrize("partial", [None, "kept", lambda: (1, 2)])
def test_checkpoint_matches_jax(partial):
    """Before expiry a checkpoint passes; after it both packages raise
    with the same message fields (budget, elapsed, attached or empty) and
    the partial value (a callable is called only then)."""
    out = []
    for mod in (deadline, jdeadline):
        dl = mod.Deadline(0.75, clock=_ticks(0.0, 0.5, 2.5))
        mod.checkpoint(dl, partial=partial)
        with pytest.raises(mod.DeadlineExceeded) as ei:
            mod.checkpoint(dl, partial=partial)
        out.append((_MSG.search(str(ei.value)).groups(), ei.value.partial))
    assert out[0] == out[1]
    assert issubclass(deadline.DeadlineExceeded, RaftError)


def test_carried_matches_jax():
    dl = deadline.Deadline(1.0)
    holder = types.SimpleNamespace(deadline=dl)
    assert deadline.carried(dl) is dl and deadline.carried(holder) is dl
    assert deadline.carried(None) is None
    assert deadline.carried(types.SimpleNamespace()) is None
    jdl = jdeadline.Deadline(1.0)
    assert jdeadline.carried(Resources(deadline=jdl)) is jdl
    assert deadline.carried(Resources(deadline=dl)) is dl
    assert deadline.checkpoint(None) is None


def test_partial_topk():
    assert deadline.partial_topk([], []) is None
    a = (torch.ones(2, 3), torch.zeros(2, 3, dtype=torch.int32))
    assert deadline.partial_topk([a[0]], [a[1]]) == (a[0], a[1])
    d, i = deadline.partial_topk([a[0], a[0] * 2], [a[1], a[1] + 1])
    assert d.shape == (4, 3) and i.dtype == torch.int32
    assert torch.equal(d[2:], a[0] * 2) and torch.equal(i[2:], a[1] + 1)


@pytest.mark.parametrize("ws", [None, resources.DEFAULT_WORKSPACE_BYTES,
                                1 << 20, 64 << 20, 3 << 30, 8 << 30])
def test_workspace_chunk_bytes_matches_jax(ws):
    holder = None if ws is None else types.SimpleNamespace(
        workspace_bytes=ws)
    assert resources.workspace_chunk_bytes(holder) == \
        jresources.workspace_chunk_bytes(holder)
    assert resources.DEFAULT_WORKSPACE_BYTES == \
        jresources.DEFAULT_WORKSPACE_BYTES


@pytest.mark.parametrize("m,query_chunk,timed,default,want", [
    (100, 0, False, 4096, 0),        # no chunk asked, no deadline
    (100, 0, True, 4096, 100),       # a deadline: one chunk, checked
    (9000, 0, True, 4096, 4096),
    (100, 30, False, 4096, 30),
    (100, 100, False, 4096, 0),      # a chunk of the whole batch
    (100, 500, True, 4096, 500),     # ... under a deadline: checked
    (100, 0, True, 0, 1)])
def test_chunk_rule(m, query_chunk, timed, default, want):
    """The JAX package's rule: a carried deadline with no query_chunk
    chunks at the family's default, and even one chunk passes its
    checkpoint first."""
    res = deadline.Deadline(1.0) if timed else None
    assert query_chunks(m, query_chunk, res, default) == want


# ------------------------------------------------ the chunked searches


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("chunk", [1, 16, 89, 90])
def test_chunked_equals_unchunked(indexes, data, family, chunk):
    search = _searches(indexes)[family]
    q = torch.from_numpy(data[1])
    wd, wi = search(q)
    for res in (None, deadline.Deadline(1e9)):
        d, i = search(q, query_chunk=chunk, res=res)
        assert torch.equal(d, wd) and torch.equal(i, wi)
    d, i = search(q, res=deadline.Deadline(1e9))   # the family's default
    assert torch.equal(d, wd) and torch.equal(i, wi)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("done", [1, 2, 4])
def test_partial_results_are_the_finished_chunks(indexes, data, family,
                                                 done):
    """A deadline that expires at the checkpoint before chunk ``done``:
    the partial results are the unchunked search's first ``done`` chunks,
    bit for bit."""
    search = _searches(indexes)[family]
    q = torch.from_numpy(data[1])
    wd, wi = search(q)
    chunk = 20
    dl = deadline.Deadline(1.0, clock=_ticks(*([0.0] * (done + 1)), 9.0))
    with pytest.raises(deadline.DeadlineExceeded) as ei:
        search(q, query_chunk=chunk, res=dl)
    pd, pi = ei.value.partial
    rows = done * chunk
    assert torch.equal(pd, wd[:rows]) and torch.equal(pi, wi[:rows])


@pytest.mark.parametrize("family", ["brute_force", "ivf_flat"])
def test_partial_results_match_jax(indexes, data, family):
    """The same injected clock stops both packages at the same chunk, with
    equal partial results (integer data: exact, ties to the lower row)."""
    q = data[1]
    ticks = (0.0, 0.5, 0.5, 2.0, 2.0)
    dl = deadline.Deadline(1.0, clock=_ticks(*ticks))
    jres = Resources(deadline=jdeadline.Deadline(1.0, clock=_ticks(*ticks)))
    with pytest.raises(deadline.DeadlineExceeded) as ours:
        _searches(indexes)[family](torch.from_numpy(q), query_chunk=25,
                                   res=dl)
    with pytest.raises(jdeadline.DeadlineExceeded) as theirs:
        if family == "brute_force":
            jbf.search(indexes["jbf"], jnp.asarray(q), K, res=jres,
                       query_chunk=25, algo="matmul")
        else:
            jivf.search(indexes["jflat"], jnp.asarray(q), K,
                        jivf.SearchParams(n_probes=FLAT_SP.n_probes),
                        res=jres, query_chunk=25, algo="xla")
    (td, ti), (jd, ji) = ours.value.partial, theirs.value.partial
    assert td.shape == (50, K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert _MSG.search(str(ours.value)).groups() == \
        _MSG.search(str(theirs.value)).groups()


_ENGINES = {"brute_force": (brute_force, "fused_knn"),
            "ivf_flat": (ivf_flat, "ivf_flat_scan"),
            "ivf_pq": (ivf_pq, "ivf_pq_scan")}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("query_chunk", [0, 30, 500])
def test_expired_deadline_raises_before_any_work(indexes, data, family,
                                                 query_chunk, monkeypatch):
    """An already expired budget raises at the first checkpoint, with no
    partial result, before the family's scan runs, whether or not the
    batch fits one chunk."""
    mod, engine = _ENGINES[family]

    def no_scan(*a, **kw):
        raise AssertionError("the scan ran under an expired deadline")

    monkeypatch.setattr(mod, engine, no_scan)
    with pytest.raises(deadline.DeadlineExceeded) as ei:
        _searches(indexes)[family](torch.from_numpy(data[1]),
                                   query_chunk=query_chunk,
                                   res=deadline.Deadline(0.0))
    assert ei.value.partial is None
    with pytest.raises(AssertionError, match="expired deadline"):
        _searches(indexes)[family](torch.from_numpy(data[1]))


@pytest.mark.parametrize("family", FAMILIES)
def test_cancellation_is_a_checkpoint(indexes, data, family):
    """A cancelled token stops a chunked search at its next checkpoint,
    and the token resets after raising (the interruptible contract)."""
    search = _searches(indexes)[family]
    q = torch.from_numpy(data[1])
    interruptible.cancel()
    with pytest.raises(interruptible.InterruptedException):
        search(q, query_chunk=30)
    d, _ = search(q, query_chunk=30)
    assert d.shape == (M, K)


def test_interruptible_tokens():
    tok = interruptible.get_token()
    assert interruptible.get_token() is tok and not tok.cancelled()
    other = interruptible.get_token(-1)            # no such thread
    other.cancel()
    interruptible.check()                          # not this thread's
    interruptible.cancel()
    assert tok.cancelled()
    with pytest.raises(interruptible.InterruptedException):
        interruptible.synchronize(torch.zeros(2))
    assert not tok.cancelled()
    x = torch.ones(3)
    assert interruptible.synchronize(x) is x
    assert interruptible.synchronize() is None


# ------------------------------------------------ make_searcher


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("opts", [{}, {"query_chunk": 40}])
def test_make_searcher_equals_search(indexes, data, family, opts):
    q = torch.from_numpy(data[1])
    if family == "brute_force":
        fn = brute_force.make_searcher(indexes["bf"], **opts)
    elif family == "ivf_flat":
        fn = ivf_flat.make_searcher(indexes["flat"], FLAT_SP, **opts)
    else:
        fn = ivf_pq.make_searcher(indexes["pq"], PQ_SP, **opts)
    wd, wi = _searches(indexes)[family](q, **opts)
    d, i = fn(q, K)
    assert torch.equal(d, wd) and torch.equal(i, wi)
    with pytest.raises(deadline.DeadlineExceeded):
        fn(q, K, res=deadline.Deadline(0.0))


def test_make_searcher_refusals(indexes):
    with pytest.raises(RaftError, match="no SearchParams"):
        brute_force.make_searcher(indexes["bf"], FLAT_SP)
    with pytest.raises(RaftError, match="not ported yet"):
        ivf_flat.make_searcher(indexes["flat"], degrade=object())
    with pytest.raises(RaftError, match="not ported yet"):
        ivf_pq.make_searcher(indexes["pq"], degrade=object())
