"""Dense pairwise distances: counterpart of
``raft_tpu/distance/pairwise.py`` (``pairwise_distance``, ``distance``,
the expanded and elementwise engines, Haversine, ``_tile_sizes``).

Two engines, as the JAX package's:

- the **expanded** engine for the metrics whose cross term is an inner
  product (squared L2 and L2, cosine, inner product, correlation,
  Hellinger, Russell-Rao): one ``torch.matmul`` in full float32 plus
  row and column terms;
- the **elementwise** engine for the metrics that need |x - y|-style
  terms (L1, L2Unexpanded, L2SqrtUnexpanded, Linf, Canberra,
  LpUnexpanded, HammingUnexpanded, BrayCurtis, KLDivergence,
  JensenShannon): broadcast (tm, tn, d) terms reduced over d, in tiles
  whose broadcast block stays within a 64 MiB budget
  (:func:`_tile_sizes`), so 1,000 queries x 8,192 rows x 128 dimensions
  (4 GiB as one block) run in 64 MiB pieces.

The JAX package computes both in XLA; no Pallas kernel covers them, so
this module is plain PyTorch on any device: it is the counterpart of
that XLA code, not a fallback for a kernel.
"""
from __future__ import annotations

import functools

import torch

from ..core.errors import expects
from ..core.resources import DEFAULT_WORKSPACE_BYTES
from ..utils import cdiv, resolve_device
from .distance_types import DistanceType, canonical_metric

__all__ = ["pairwise_distance", "distance"]

# bytes of broadcast terms the elementwise engine materializes a tile
_TILE_BUDGET_BYTES = 64 * 1024 * 1024


def _norms(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(dim=1, keepdim=True)


def _l2_expanded(x, y, sqrt: bool):
    """||x - y||² = ||x||² + ||y||² - 2<x, y>, clamped at 0."""
    d = torch.clamp_min(_norms(x) + _norms(y).T - 2.0 * (x @ y.T), 0.0)
    return torch.sqrt(d) if sqrt else d


def _cosine(x, y):
    xn = torch.sqrt(_norms(x))
    yn = torch.sqrt(_norms(y))
    return 1.0 - (x @ y.T) / torch.clamp_min(xn * yn.T, 1e-30)


def _correlation(x, y):
    return _cosine(x - x.mean(dim=1, keepdim=True),
                   y - y.mean(dim=1, keepdim=True))


def _hellinger(x, y):
    """sqrt(1 - Σ sqrt(x_i y_i)) over probability-like rows."""
    ip = torch.sqrt(x.abs()) @ torch.sqrt(y.abs()).T
    return torch.sqrt(torch.clamp_min(1.0 - torch.clamp_max(ip, 1.0), 0.0))


def _russelrao(x, y):
    """(d - <x, y>) / d over binary-ish rows."""
    k = x.shape[1]
    return (k - x @ y.T) / k


def _elementwise_tile(x_tile, y_tile, metric: DistanceType, p: float):
    """(tm, tn) distances of a (tm, d) x-tile to a (tn, d) y-tile through
    broadcast terms reduced over d."""
    xe = x_tile[:, None, :]
    ye = y_tile[None, :, :]
    if metric is DistanceType.L1:
        return (xe - ye).abs().sum(dim=-1)
    if metric in (DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded):
        d = ((xe - ye) ** 2).sum(dim=-1)
        return torch.sqrt(d) if metric is DistanceType.L2SqrtUnexpanded \
            else d
    if metric is DistanceType.Linf:
        return (xe - ye).abs().amax(dim=-1)
    if metric is DistanceType.Canberra:
        num = (xe - ye).abs()
        den = xe.abs() + ye.abs()
        return torch.where(den == 0, 0.0,
                           num / torch.where(den == 0, 1.0, den)).sum(dim=-1)
    if metric is DistanceType.LpUnexpanded:
        return ((xe - ye).abs() ** p).sum(dim=-1) ** (1.0 / p)
    if metric is DistanceType.HammingUnexpanded:
        return (xe != ye).to(x_tile.dtype).mean(dim=-1)
    if metric is DistanceType.BrayCurtis:
        num = (xe - ye).abs().sum(dim=-1)
        den = (xe + ye).abs().sum(dim=-1)
        return torch.where(den == 0, 0.0,
                           num / torch.where(den == 0, 1.0, den))
    if metric is DistanceType.KLDivergence:
        # Σ x log(x / y); a term with x == 0 adds 0
        ratio = torch.where(xe > 0, xe / torch.where(ye > 0, ye, 1.0), 1.0)
        return torch.where(xe > 0, xe * torch.log(ratio), 0.0).sum(dim=-1)
    if metric is DistanceType.JensenShannon:
        m = 0.5 * (xe + ye)

        def _kl_terms(a):
            r = torch.where(a > 0, a / torch.where(m > 0, m, 1.0), 1.0)
            return torch.where(a > 0, a * torch.log(r), 0.0)

        js = 0.5 * (_kl_terms(xe) + _kl_terms(ye)).sum(dim=-1)
        return torch.sqrt(torch.clamp_min(js, 0.0))
    raise AssertionError(f"not an elementwise metric: {metric}")


def _haversine(x, y):
    """Great-circle distance over (lat, lon) radian pairs."""
    expects(x.shape[1] == 2, "haversine requires 2-D (lat, lon) inputs")
    lat1, lon1 = x[:, None, 0], x[:, None, 1]
    lat2, lon2 = y[None, :, 0], y[None, :, 1]
    sin_dlat = torch.sin(0.5 * (lat2 - lat1))
    sin_dlon = torch.sin(0.5 * (lon2 - lon1))
    a = sin_dlat ** 2 + torch.cos(lat1) * torch.cos(lat2) * sin_dlon ** 2
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


_EXPANDED = {
    DistanceType.L2Expanded: functools.partial(_l2_expanded, sqrt=False),
    DistanceType.L2SqrtExpanded: functools.partial(_l2_expanded, sqrt=True),
    DistanceType.CosineExpanded: _cosine,
    DistanceType.InnerProduct: lambda x, y: x @ y.T,
    DistanceType.CorrelationExpanded: _correlation,
    DistanceType.HellingerExpanded: _hellinger,
    DistanceType.RusselRaoExpanded: _russelrao,
}

_ELEMENTWISE = {
    DistanceType.L1,
    DistanceType.L2Unexpanded,
    DistanceType.L2SqrtUnexpanded,
    DistanceType.Linf,
    DistanceType.Canberra,
    DistanceType.LpUnexpanded,
    DistanceType.HammingUnexpanded,
    DistanceType.BrayCurtis,
    DistanceType.KLDivergence,
    DistanceType.JensenShannon,
}


def _tile_sizes(m: int, n: int, d: int, itemsize: int,
                workspace_bytes: int | None = None):
    """(tm, tn) with tm·tn·d·itemsize within the tile budget (64 MiB, or
    an eighth of an explicitly set workspace, clamped to [16, 256] MiB),
    n tiles as wide as the budget lets them be."""
    if workspace_bytes is not None and \
            workspace_bytes != DEFAULT_WORKSPACE_BYTES:
        total = min(max(workspace_bytes // 8, 16 << 20), 256 << 20)
    else:
        total = _TILE_BUDGET_BYTES
    budget = total // max(1, d * itemsize)
    tn = min(n, max(128, budget // 128))
    tm = max(1, min(m, budget // max(1, tn)))
    return tm, tn


def elementwise_distance(x: torch.Tensor, y: torch.Tensor,
                         metric: DistanceType, metric_arg: float = 2.0,
                         workspace_bytes: int | None = None
                         ) -> torch.Tensor:
    """The elementwise engine: (m, n) distances in tiles of
    :func:`_tile_sizes`."""
    m, n, d = x.shape[0], y.shape[0], x.shape[1]
    tm, tn = _tile_sizes(m, n, d, x.element_size(), workspace_bytes)
    if tm >= m and tn >= n:
        return _elementwise_tile(x, y, metric, metric_arg)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    for i in range(cdiv(m, tm)):
        xt = x[i * tm : (i + 1) * tm]
        for j in range(cdiv(n, tn)):
            out[i * tm : (i + 1) * tm, j * tn : (j + 1) * tn] = \
                _elementwise_tile(xt, y[j * tn : (j + 1) * tn], metric,
                                  metric_arg)
    return out


def pairwise_distance(x, y, metric="l2_expanded", metric_arg: float = 2.0,
                      res=None, device=None) -> torch.Tensor:
    """All-pairs distances between the rows of ``x`` (m, d) and ``y``
    (n, d) → (m, n) float32, on ``device`` (the CUDA card by default).
    ``metric_arg`` is LpUnexpanded's p; ``res``: an object whose
    ``workspace_bytes`` sizes the elementwise tiles."""
    mt = canonical_metric(metric)
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(device=dev, dtype=torch.float32)
    y = torch.as_tensor(y).to(device=dev, dtype=torch.float32)
    expects(x.dim() == 2 and y.dim() == 2,
            "inputs must be 2-D (got %dD/%dD)", x.dim(), y.dim())
    expects(x.shape[1] == y.shape[1], "dimension mismatch: %d vs %d",
            x.shape[1], y.shape[1])
    expects(mt is not DistanceType.Precomputed,
            "Precomputed is not a computable metric")
    if mt in _EXPANDED:
        return _EXPANDED[mt](x, y)
    if mt is DistanceType.Haversine:
        return _haversine(x, y)
    expects(mt in _ELEMENTWISE, "metric %s is not supported by the dense "
            "engine", mt.name)
    ws = getattr(res, "workspace_bytes", None) if res is not None else None
    return elementwise_distance(x, y, mt, metric_arg, ws)


def distance(x, y, metric="l2_expanded", metric_arg: float = 2.0,
             device=None) -> torch.Tensor:
    """Alias of :func:`pairwise_distance` (the reference's
    ``raft::distance::distance``)."""
    return pairwise_distance(x, y, metric, metric_arg, device=device)
