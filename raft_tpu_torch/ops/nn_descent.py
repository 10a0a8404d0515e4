"""Batched NN-descent kNN-graph construction: counterpart of
``raft_tpu/ops/nn_descent.py`` (``supports``, ``_rev_sample``,
``_join_batch``, ``build_graph``), CAGRA's graph builder past the exact
pass's budget (raft/neighbors/detail/nn_descent.cuh:342, GNND).

Plain PyTorch, as in the JAX package, which has no Pallas site here.
Each round every node draws ``sample`` of its current neighbors (the
forward sample) plus up to ``sample`` nodes that drew it (the reverse
sample, :func:`_rev_sample`); its candidates are those joined nodes and
the neighbors each one offers: by default (``exposure="sampled"``, the
rule CAGRA's route runs) ``join`` drawn from its whole list plus its
reverse sample; with ``exposure="closest"`` its ``join`` closest, the
JAX package's rule, which the parity tests run (:func:`_join_batch`).
Candidates are scored by one batched gather and ``torch.bmm``, masked
where they are the node, invalid or already listed
(``ops.cagra_fused.dup_mask``), and merged into the node's sorted list by
``select_k`` (K1 on CUDA). The rounds stop early once the share of
replaced list slots falls below ``termination``; the finished lists go
through ``cagra._drop_self_pad``, so every id is a valid non-self row.

The graph and distance state stay on the device; a round reads one
scalar (its update rate) on the host. The score copy is float32 by
default (the JAX package's rule off the TPU, which keeps the two
packages' graphs equal on integer-valued data); ``score_dtype=
torch.bfloat16`` halves the gather's bytes. The random draws (the
initial ids, each round's sample columns and sampled exposure) all go
through :func:`_draw_ints`.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..core.errors import expects
from ..distance.distance_types import DistanceType, canonical_metric
from ..matrix.select_k import select_k
from ..utils import resolve_device
from .cagra_fused import dup_mask

__all__ = ["build_graph", "supports", "ROUNDS", "SAMPLE", "JOIN",
           "TERMINATION", "BATCH"]

# the JAX package's knob defaults (RAFT_TPU_NND_*)
ROUNDS, SAMPLE, JOIN, TERMINATION, BATCH = 15, 16, 24, 0.002, 8192

_INF = float("inf")


def supports(metric) -> bool:
    """Whether the descent builder serves ``metric`` (L2 family and inner
    product)."""
    return canonical_metric(metric) in (DistanceType.L2Expanded,
                                        DistanceType.L2SqrtExpanded,
                                        DistanceType.InnerProduct)


def _draw_ints(gen: torch.Generator, shape, high: int) -> torch.Tensor:
    """Uniform integers in [0, high) of ``shape`` on the generator's
    device: the one place the builder draws random numbers."""
    return torch.randint(0, high, shape, generator=gen, device=gen.device)


def _rev_sample(fwd: torch.Tensor, s: int) -> torch.Tensor:
    """(n, s) forward sample → (n, s) reverse sample: node ``i`` is in row
    ``j`` iff ``i`` sampled ``j`` this round, the first ``s`` arrivals
    kept (in node order), -1 padded. One stable sort of the n·s sampled
    edges by target."""
    n = fwd.shape[0]
    dev = fwd.device
    src = torch.arange(n, device=dev).repeat_interleave(s)
    tgt = fwd.reshape(-1).long()
    tgt = torch.where((tgt >= 0) & (tgt < n), tgt, n)    # junk → row n
    ts, order = torch.sort(tgt, stable=True)
    cs = src[order]
    counts = torch.bincount(ts, minlength=n + 1)
    pos = torch.arange(ts.shape[0], device=dev) - (torch.cumsum(counts, 0)
                                                   - counts)[ts]
    keep = (pos < s) & (ts < n)
    out = torch.full((n, s), -1, dtype=torch.int32, device=dev)
    out[ts[keep], pos[keep]] = cs[keep].to(torch.int32)
    return out


def _join_batch(score, norms, graph, dist, jlist, rows, k: int,
                exposed: Optional[torch.Tensor], inner_product: bool):
    """One node batch of the neighbor-of-neighbor join → (new ids (b, k),
    new distances (b, k), replaced slots a row (b,)).

    ``rows`` (b,) node ids; ``jlist`` (b, t) joined node ids (-1 pad).
    The candidates are the joined nodes and, for each, its row of
    ``exposed`` (n, join): the neighbors it offers this round (the JAX
    package's: its ``join`` closest, ``graph[:, :join]``). ``exposed=None``
    is the initial merge (``jlist`` is the candidate list). Distances are
    squared L2 (the build order only needs it) or the negated inner
    product."""
    b, t = jlist.shape
    rl = rows.long()
    g = graph[rl]                                        # (b, k)
    gd = dist[rl]
    if exposed is not None:
        nbr = exposed[jlist.clamp_min(0).long()]         # (b, t, join)
        nbr = torch.where(jlist[:, :, None] >= 0, nbr, -1)
        cand = torch.cat([jlist.to(graph.dtype),
                          nbr.reshape(b, -1).to(graph.dtype)], dim=1)
    else:
        cand = jlist.to(graph.dtype)
    ok = (cand >= 0) & (cand != rows[:, None]) & ~dup_mask(cand, keep=g)
    cl = cand.clamp_min(0).long()
    x = score[rl].to(torch.float32)
    vecs = score[cl].to(torch.float32)                   # (b, C, d)
    ip = torch.bmm(vecs, x[:, :, None])[:, :, 0]
    if inner_product:
        cd = -ip
    else:
        cd = torch.clamp_min(norms[rl][:, None] + norms[cl] - 2.0 * ip, 0.0)
    cd = torch.where(ok, cd, _INF)
    new_d, sel = select_k(torch.cat([gd, cd], dim=1), k, select_min=True)
    sel = sel.long()
    new_i = torch.gather(torch.cat([g, cand], dim=1), 1, sel)
    changed = ((sel >= k) & torch.isfinite(new_d)).sum(dim=1)
    return new_i, new_d, changed


def build_graph(dataset, k: int, metric=DistanceType.L2Expanded,
                rounds: int = ROUNDS, sample: int = SAMPLE, join: int = JOIN,
                termination: float = TERMINATION, seed: int = 0,
                batch: int = BATCH, init_graph=None,
                progress: Optional[Callable] = None,
                score_dtype: torch.dtype = torch.float32,
                exposure: str = "sampled", device=None) -> torch.Tensor:
    """(n, k) approximate kNN graph by batched NN-descent → int32 ids on
    ``device`` (the CUDA card by default), each a valid non-self row.

    ``init_graph``: optional (n, k0) candidate lists to start from (e.g.
    an IVF-PQ candidate pass); by default k uniform ids a node.
    ``exposure``: what a joined node offers its joiners each round —
    ``"sampled"`` (the default, CAGRA's route): ``join`` of its
    neighbors drawn afresh each round from its whole list, plus the
    nodes that sampled it this round (its reverse sample), as GNND's
    local join mixes forward and reverse neighbors; ``"closest"`` (the
    JAX package's rule, kept for parity): its ``join`` closest
    neighbors, the same ones every round. On high-dimensional data the
    closest slice stalls far from the true graph (a fixed
    neighbor-of-neighbor set: 0.46 edge recall at 1M rows of
    ``chip_smoke.py``'s data, PERF.md); the sampled exposure keeps
    offering new candidates, for ``sample`` more per joined node.
    ``progress(round, rounds, update_rate, elapsed_s)`` is called once a
    round. Deterministic for a fixed seed on a fixed device."""
    from ..neighbors.cagra import _drop_self_pad

    dev = resolve_device(device)
    x = torch.as_tensor(dataset).to(device=dev, dtype=torch.float32)
    n = x.shape[0]
    mt = canonical_metric(metric)
    expects(supports(mt), "nn_descent supports L2/IP metrics, got %s",
            mt.name)
    expects(0 < k < n, "k %d out of range for n %d", k, n)
    expects(score_dtype in (torch.float32, torch.bfloat16),
            "score_dtype must be float32 or bfloat16, got %s", score_dtype)
    s, join = min(sample, k), min(join, k)
    expects(exposure in ("closest", "sampled"), "unknown exposure %r",
            exposure)
    batch = min(batch, n)
    score = x.to(score_dtype).contiguous()
    # norms of the score copy: the ordering stays consistent with its
    # rounded cross terms
    norms = score.to(torch.float32).square().sum(dim=1)
    ip = mt is DistanceType.InnerProduct
    gen = torch.Generator(device=dev).manual_seed(seed)

    graph = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    dist = torch.full((n, k), _INF, dtype=torch.float32, device=dev)

    def run_pass(jlist, exposed):
        """One sweep of :func:`_join_batch` over the node batches, all
        reading the state before the sweep."""
        gs, ds, ch = [], [], 0
        for b0 in range(0, n, batch):
            rows = torch.arange(b0, min(b0 + batch, n), device=dev,
                                dtype=torch.int32)
            gi, di, c = _join_batch(score, norms, graph, dist,
                                    jlist[b0:b0 + batch], rows, k, exposed,
                                    ip)
            gs.append(gi)
            ds.append(di)
            ch = ch + c.sum()
        return torch.cat(gs), torch.cat(ds), ch

    if init_graph is not None:
        cand0 = torch.as_tensor(init_graph).to(device=dev,
                                               dtype=torch.int32)
        expects(cand0.dim() == 2 and cand0.shape[0] == n,
                "init_graph must be (n, k0)")
    else:
        cand0 = _draw_ints(gen, (n, k), n).to(torch.int32)
    graph, dist, _ = run_pass(cand0, None)

    t0 = time.perf_counter()
    for r in range(rounds):
        cols = _draw_ints(gen, (n, s), k).long()
        # sampling an unfilled slot proposes a junk id the join masks out
        fwd = torch.gather(graph, 1, cols)
        rev = _rev_sample(fwd, s)
        jlist = torch.cat([fwd, rev], dim=1)
        if exposure == "closest":
            exposed = graph[:, :join]
        else:
            picks = _draw_ints(gen, (n, join), k).long()
            exposed = torch.cat([torch.gather(graph, 1, picks), rev], dim=1)
        graph, dist, ch = run_pass(jlist, exposed)
        rate = float(ch) / float(n * k)              # the round's one read
        if progress is not None:
            progress(r + 1, rounds, rate, time.perf_counter() - t0)
        if rate < termination:
            break

    ref = torch.where(torch.isfinite(dist), graph, -1)
    out = torch.empty((n, k), dtype=torch.int32, device=dev)
    for b0 in range(0, n, batch):
        rows = torch.arange(b0, min(b0 + batch, n), device=dev)
        out[b0:b0 + batch] = _drop_self_pad(ref[b0:b0 + batch].long(), rows,
                                            k, n)
    return out
