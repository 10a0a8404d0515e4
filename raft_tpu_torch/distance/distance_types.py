"""Distance metric enumeration: counterpart of
``raft_tpu/distance/distance_types.py`` (``DistanceType``,
``canonical_metric``, ``is_min_close``)."""
from __future__ import annotations

import enum

__all__ = ["DistanceType", "canonical_metric", "is_min_close"]


class DistanceType(enum.Enum):
    """Metric identifiers; the values equal the JAX package's, so a
    metric carried across as its ``.value`` resolves to the same member."""

    L2Expanded = "l2_expanded"              # squared L2 via GEMM expansion
    L2SqrtExpanded = "l2_sqrt_expanded"     # L2 via GEMM expansion
    CosineExpanded = "cosine"               # 1 - cos(x, y)
    L1 = "l1"                               # Manhattan
    L2Unexpanded = "l2_unexpanded"          # squared L2, diff-based
    L2SqrtUnexpanded = "l2_sqrt_unexpanded"
    InnerProduct = "inner_product"          # similarity (larger = closer)
    Linf = "linf"                           # Chebyshev
    Canberra = "canberra"
    LpUnexpanded = "lp"                     # Minkowski, p = metric_arg
    CorrelationExpanded = "correlation"
    JaccardExpanded = "jaccard"
    HellingerExpanded = "hellinger"
    Haversine = "haversine"                 # 2-D lat/lon
    BrayCurtis = "braycurtis"
    JensenShannon = "jensenshannon"
    HammingUnexpanded = "hamming"
    KLDivergence = "kl_divergence"
    RusselRaoExpanded = "russelrao"
    DiceExpanded = "dice"
    Precomputed = "precomputed"


_ALIASES = {
    "euclidean": DistanceType.L2SqrtExpanded,
    "l2": DistanceType.L2SqrtExpanded,
    "sqeuclidean": DistanceType.L2Expanded,
    "l2_expanded": DistanceType.L2Expanded,
    "l2_sqrt_expanded": DistanceType.L2SqrtExpanded,
    "l2_unexpanded": DistanceType.L2Unexpanded,
    "l2_sqrt_unexpanded": DistanceType.L2SqrtUnexpanded,
    "cosine": DistanceType.CosineExpanded,
    "l1": DistanceType.L1,
    "cityblock": DistanceType.L1,
    "manhattan": DistanceType.L1,
    "taxicab": DistanceType.L1,
    "inner_product": DistanceType.InnerProduct,
    "linf": DistanceType.Linf,
    "chebyshev": DistanceType.Linf,
    "canberra": DistanceType.Canberra,
    "lp": DistanceType.LpUnexpanded,
    "minkowski": DistanceType.LpUnexpanded,
    "correlation": DistanceType.CorrelationExpanded,
    "jaccard": DistanceType.JaccardExpanded,
    "hellinger": DistanceType.HellingerExpanded,
    "haversine": DistanceType.Haversine,
    "braycurtis": DistanceType.BrayCurtis,
    "jensenshannon": DistanceType.JensenShannon,
    "hamming": DistanceType.HammingUnexpanded,
    "kl_divergence": DistanceType.KLDivergence,
    "kldivergence": DistanceType.KLDivergence,
    "russelrao": DistanceType.RusselRaoExpanded,
    "dice": DistanceType.DiceExpanded,
    "precomputed": DistanceType.Precomputed,
}


def canonical_metric(metric) -> DistanceType:
    """Resolve a string alias or enum to a :class:`DistanceType`."""
    if isinstance(metric, DistanceType):
        return metric
    try:
        return _ALIASES[metric.lower()]
    except (KeyError, AttributeError):
        raise ValueError(f"unknown distance metric: {metric!r}") from None


def is_min_close(metric) -> bool:
    """True when smaller distance means closer (everything except
    InnerProduct, a similarity)."""
    return canonical_metric(metric) is not DistanceType.InnerProduct
