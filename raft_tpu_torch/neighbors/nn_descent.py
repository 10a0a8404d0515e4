"""NN-descent kNN-graph construction with the GNND-shaped API: counterpart
of ``raft_tpu/neighbors/nn_descent.py`` (``build``;
raft/neighbors/detail/nn_descent.cuh:342, params nn_descent_types.hpp:49).

Each round samples new and old neighbors per node (forward and reverse),
proposes every joined pair to each other (the local join), groups the
proposals by target on the host (numpy, ``np.random.default_rng(seed)``:
the same calls in the same order as the JAX package, so the whole graph
equals JAX's on the same seed on integer-valued data), and merges each
node batch's proposals into its list on the device (:func:`_round_batch`:
a gather, ``torch.bmm`` and ``select_k``, K1 on CUDA). Convergence is the
share of list entries replaced in a round (termination_threshold,
nn_descent_types.hpp:53).

CAGRA's builder is the device-resident rewrite in
``raft_tpu_torch/ops/nn_descent.py``; this module keeps the direct API.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.errors import expects
from ..distance.distance_types import DistanceType, canonical_metric
from ..matrix.select_k import select_k
from ..utils import resolve_device

__all__ = ["build"]


def _dedup_rows(cand: np.ndarray) -> np.ndarray:
    """Per-row candidate dedup (the :func:`_round_batch` precondition):
    sort descending, mask adjacent repeats with -1; padding collects at
    the end."""
    cand = -np.sort(-cand, axis=1)
    cand[:, 1:][cand[:, 1:] == cand[:, :-1]] = -1
    return cand


def _round_batch(dataset, rows, g_ids, g_dist, g_new, cand, k: int,
                 inner_product: bool):
    """One merge for a node batch → (ids, distances, new flags (b, k),
    entries taken from ``cand``). ``rows`` (b,) node ids;
    ``g_ids``/``g_dist``/``g_new`` (b, k) lists and new flags; ``cand``
    (b, C) proposals, free of duplicates within a row."""
    x_rows = dataset[rows]
    self_hit = cand == rows[:, None]
    in_list = (cand[:, :, None] == g_ids[:, None, :]).any(dim=2)
    ok = ~(self_hit | in_list) & (cand >= 0)
    vecs = dataset[cand.clamp_min(0)]
    ip = torch.bmm(vecs, x_rows[:, :, None])[:, :, 0]
    if inner_product:
        cd = -ip
    else:
        q2 = (x_rows * x_rows).sum(dim=1, keepdim=True)
        v2 = (vecs * vecs).sum(dim=2)
        cd = torch.clamp_min(q2 + v2 - 2.0 * ip, 0.0)
    cd = torch.where(ok, cd, float("inf"))
    all_d = torch.cat([g_dist, cd], dim=1)
    all_i = torch.cat([g_ids, cand], dim=1)
    all_n = torch.cat([g_new, torch.ones_like(cand, dtype=torch.bool)],
                      dim=1)
    new_d, sel = select_k(all_d, k, select_min=True)
    sel = sel.long()
    new_i = torch.gather(all_i, 1, sel)
    new_n = torch.gather(all_n, 1, sel) & torch.isfinite(new_d)
    return new_i, new_d, new_n, int((sel >= k).sum())


def _group_by_target(targets: np.ndarray, cands: np.ndarray, n: int,
                     cap: int, rng=None) -> np.ndarray:
    """Proposal edge list → (n, cap) per-target candidate table (-1 pad):
    shuffle the edges (arrival order when ``rng`` is None), stable-sort
    by target, keep the first ``cap`` arrivals a target."""
    live = (targets >= 0) & (cands >= 0)
    targets, cands = targets[live], cands[live]
    if rng is not None:
        perm = rng.permutation(len(targets))
        tp, cp = targets[perm], cands[perm]
    else:
        tp, cp = targets, cands
    order = np.argsort(tp, kind="stable")
    ts, cs = tp[order], cp[order]
    counts = np.bincount(ts, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(ts)) - starts[ts]
    keep = pos < cap
    out = np.full((n, cap), -1, np.int32)
    out[ts[keep], pos[keep]] = cs[keep]
    return out


def _sample_cols(flags_match: np.ndarray, s: int, rng) -> np.ndarray:
    """Per row, up to ``s`` column indices where ``flags_match`` holds
    (uniformly, without replacement); -1 where there are fewer."""
    n, k = flags_match.shape
    score = rng.random((n, k)) + (~flags_match) * 10.0
    cols = np.argsort(score, axis=1)[:, :s]
    ok = np.take_along_axis(flags_match, cols, axis=1)
    return np.where(ok, cols, -1)


def _local_join_proposals(graph: np.ndarray, is_new: np.ndarray, s: int,
                          cap: int, rng):
    """The local join (GNND local_join): each node gathers sampled *new*
    neighbors (forward and reverse) and sampled *old* ones; every ordered
    pair with at least one new member proposes its members to each other.
    The proposals are grouped by target, at most ``cap`` a node; the
    sampled new entries are marked old in place."""
    n, k = graph.shape
    idx = np.arange(n, dtype=np.int32)

    new_cols = _sample_cols(is_new, s, rng)
    old_cols = _sample_cols(~is_new & (graph >= 0), s, rng)
    take = lambda cols: np.where(  # noqa: E731
        cols >= 0, np.take_along_axis(graph, np.maximum(cols, 0), axis=1), -1)
    fwd_new, fwd_old = take(new_cols), take(old_cols)

    rows = np.repeat(idx, s)
    csel = new_cols.reshape(-1)
    ok = csel >= 0
    is_new[rows[ok], csel[ok]] = False

    # reverse samples, split by flag: for an edge (i→j), i joins j's set
    src = np.repeat(idx, k)
    dst = graph.reshape(-1)
    nf = is_new.reshape(-1) | False
    rev_new = _group_by_target(dst[nf], src[nf], n, s, rng)
    rev_old = _group_by_target(dst[~nf], src[~nf], n, s, rng)

    jn = np.concatenate([fwd_new, rev_new], axis=1)           # (n, 2s) new
    jo = np.concatenate([fwd_old, rev_old], axis=1)           # (n, 2s) old
    m = jn.shape[1]
    a_nn = np.broadcast_to(jn[:, :, None], (n, m, m)).reshape(-1)
    b_nn = np.broadcast_to(jn[:, None, :], (n, m, m)).reshape(-1)
    a_no = np.broadcast_to(jn[:, :, None], (n, m, m)).reshape(-1)
    b_no = np.broadcast_to(jo[:, None, :], (n, m, m)).reshape(-1)
    a = np.concatenate([a_nn, a_no, b_no])
    b = np.concatenate([b_nn, b_no, a_no])
    neq = a != b
    return _group_by_target(a[neq], b[neq], n, cap, rng)


def build(dataset, k: int, metric=DistanceType.L2Expanded, n_iters: int = 20,
          termination_threshold: float = 0.0001, seed: int = 0,
          sample: int = 0, batch: int = 4096, device=None) -> torch.Tensor:
    """(n, k) kNN graph by NN-descent → int32 neighbor ids on ``device``
    (the CUDA card by default). ``sample``: neighbors sampled a node for
    the local join (0 → max(4, k // 2))."""
    dev = resolve_device(device)
    dataset = np.asarray(torch.as_tensor(dataset).cpu(), np.float32)
    n, _ = dataset.shape
    mt = canonical_metric(metric)
    expects(mt in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                   DistanceType.InnerProduct),
            "nn_descent supports L2/IP metrics, got %s", mt.name)
    expects(k < n, "k %d >= n %d", k, n)
    s = sample or max(4, k // 2)
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(dataset).to(dev)
    ip = mt is DistanceType.InnerProduct

    def merge(b0, g_ids, g_dist, g_new, cand):
        rows = torch.arange(b0, b0 + len(g_ids), device=dev)
        out = _round_batch(data, rows, torch.from_numpy(g_ids).to(dev).long(),
                           torch.from_numpy(g_dist).to(dev),
                           torch.from_numpy(g_new).to(dev),
                           torch.from_numpy(cand).to(dev).long(), k, ip)
        return (out[0].cpu().numpy().astype(np.int32), out[1].cpu().numpy(),
                out[2].cpu().numpy(), out[3])

    # random init: k draws a node; what survives the first merge is new
    graph = rng.integers(0, n, (n, k)).astype(np.int32)
    dist = np.full((n, k), np.inf, np.float32)
    is_new = np.zeros((n, k), bool)
    init_cand = _dedup_rows(graph.copy())
    for b0 in range(0, n, batch):
        b1 = min(b0 + batch, n)
        graph[b0:b1], dist[b0:b1], is_new[b0:b1], _ = merge(
            b0, np.full((b1 - b0, k), -1, np.int32),
            np.full((b1 - b0, k), np.inf, np.float32),
            np.zeros((b1 - b0, k), bool), init_cand[b0:b1])

    # each node gets ~2s x 4s proposals; keep enough of them, but bound the
    # (n, cap) int32 table to ~512 MB of host memory (a uniform random
    # subset is dropped: extra rounds recover it)
    cap = min(4 * s * s, max(4 * k, (512 << 20) // (4 * n)))
    for _ in range(n_iters):
        cand = _dedup_rows(_local_join_proposals(graph, is_new, s, cap, rng))
        changed = 0
        for b0 in range(0, n, batch):
            b1 = min(b0 + batch, n)
            graph[b0:b1], dist[b0:b1], is_new[b0:b1], ch = merge(
                b0, graph[b0:b1], dist[b0:b1], is_new[b0:b1], cand[b0:b1])
            changed += ch
        if changed < termination_threshold * n * k:
            break
    return torch.from_numpy(graph).to(dev)
