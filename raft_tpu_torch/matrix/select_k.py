"""Batched top-k selection: counterpart of ``raft_tpu/matrix/select_k.py``.

Returns the k smallest (or largest) entries of each row, best first.

The order is the JAX package's ``select_k`` (``lax.top_k``), measured on
its CPU build, for every engine here and both forms of K1. Values order
as IEEE 754 totalOrder: -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf <
+NaN. ``select_min=True`` takes them ascending, so NaN comes after +inf
and -0.0 before +0.0; ``select_min=False`` takes them descending, so NaN
comes first, before +inf, and +0.0 before -0.0. Among equal values
(equal bits) the lowest column comes first, in both directions. Every
cell, NaN included, is returned with its column; an unfilled slot would
read (±inf, -1), and since k <= n there is none. (JAX's own ring merge
sorts with ``lax.sort``, which takes -0.0 as 0.0 and NaN after +inf in
both directions; ``ops/ring_topk.py`` mirrors that one.)

Two engines:

* ``KPASS`` — kernel K1 (``csrc/select_k.cu``), the port of the Pallas
  ``_kpass_2d``. :func:`kpass_select_k` launches it for a CUDA tensor and
  takes the plain version for a CPU tensor. K1 has two forms, chosen by
  k alone (:func:`select_form`): the warp select (a sorted queue in a
  warp's registers, one warp per row; past k = 256 a 512-key queue
  folding 128-key buffers) for k <= :data:`WARP_MAX_K`, and the radix
  select above it (one block per row: digit histograms find the k-th
  key, an ordered compaction takes the keys before it and its first
  ties, a bitonic sort orders them; past the kernel's ``kRadixCap`` =
  2,048 keys in rounds). Each form has its own launch counter.
* ``TOPK`` — the plain version, :func:`select_k_plain`: a stable sort and
  a slice (``torch.topk`` is not used: its tie order is unspecified).

``AUTO`` is the kernel on CUDA and the plain version on the CPU, whatever
a :func:`tune_select_k` verdict says: that race (K1 against
``torch.topk``, the library call) is a calibration record, since a plain
or library version may serve no main path on the card. The JAX
package's ``RADIX`` alias of ``TOPK`` is not carried over.
"""
from __future__ import annotations

import enum
from typing import Optional, Tuple

import torch

from ..core.errors import expects
from ..ops import _cuda
from ..utils import resolve_device

__all__ = ["SelectAlgo", "WARP_MAX_K", "order_key", "select_form",
           "select_k", "select_k_plain", "smallest_k_plain",
           "kpass_select_k", "tune_select_k"]

WARP_MAX_K = 512   # the warp select's queue: at most 512 keys a warp

launches = 0            # K1 launches since the last reset, both forms
warp_launches = 0       # of them, the warp select's
radix_launches = 0      # of them, the radix select's


class SelectAlgo(enum.Enum):
    """Mirror of raft/matrix/select_k_types.hpp:36."""

    AUTO = "auto"
    TOPK = "topk"        # plain stable sort
    KPASS = "kpass"      # kernel K1 on CUDA


_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def order_key(values: torch.Tensor, select_min: bool = True
              ) -> torch.Tensor:
    """Each value's place in the selection order as an integer: a float's
    bits mapped to IEEE 754 totalOrder (the sign bit set flips the other
    bits), bitwise-inverted for a max selection, which reverses the
    integer order exactly. Integer values are their own place."""
    if values.is_floating_point():
        bits = _BITS[values.element_size()]
        b = values.view(bits)
        key = b ^ ((b >> (8 * values.element_size() - 1))
                   & torch.iinfo(bits).max)
    else:
        key = values
    return key if select_min else ~key


def select_k_plain(values: torch.Tensor, k: int, select_min: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: a stable sort of each row's order keys (module
    docstring), first k columns."""
    si = torch.sort(order_key(values, select_min), dim=-1,
                    stable=True).indices[..., :k]
    return torch.gather(values, -1, si), si.to(torch.int32)


def smallest_k_plain(values: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row by float comparison: -0.0 equal to
    +0.0, NaN after +inf, ties to the lowest column. The order in which
    the scan kernels K2–K5 and their Pallas counterparts compare
    distances, as opposed to :func:`select_k`'s totalOrder."""
    sv, si = torch.sort(values, dim=-1, stable=True)
    return sv[..., :k], si[..., :k].to(torch.int32)


def select_form(k: int) -> str:
    """The form of K1 that selects k per row: ``"warp"`` (the warp select)
    up to :data:`WARP_MAX_K`, ``"radix"`` above it. A rule of shape: a
    form that fails to build or launch raises."""
    return "warp" if k <= WARP_MAX_K else "radix"


def kpass_select_k(values: torch.Tensor, k: int, select_min: bool = True,
                   form: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K1 on a (rows, n) float32 tensor → (values, int32 columns)
    (rows, k). ``form`` (``"warp"`` or ``"radix"``) overrides
    :func:`select_form`, for holding both forms against the plain version;
    the warp select takes k <= :data:`WARP_MAX_K`. A CPU tensor takes the
    plain version. The order, NaN and -0.0 included, is the module
    docstring's."""
    global launches, warp_launches, radix_launches
    if values.device.type == "cpu":
        return select_k_plain(values, k, select_min)
    expects(values.is_cuda, "select_k kernel needs a CUDA tensor, got %s",
            values.device)
    expects(values.dtype == torch.float32 and values.dim() == 2
            and values.is_contiguous(),
            "select_k kernel takes a contiguous 2-D float32 tensor, got "
            "%s %s", values.dtype, tuple(values.shape))
    rows, n = values.shape
    expects(0 < k <= n, "k=%d out of range for row length %d", k, n)
    ov = torch.empty((rows, k), dtype=torch.float32, device=values.device)
    oi = torch.empty((rows, k), dtype=torch.int32, device=values.device)
    if rows == 0:
        return ov, oi
    form = select_form(k) if form is None else form
    expects(form in ("warp", "radix") and (form == "radix"
                                           or k <= WARP_MAX_K),
            "select_k kernel: no form %r for k=%d", form, k)
    lib = _cuda.library("select_k")
    entry = (lib.raft_select_k_warp if form == "warp"
             else lib.raft_select_k_radix)
    status = entry(values.data_ptr(), rows, n, k, int(select_min),
                   ov.data_ptr(), oi.data_ptr(), _cuda.stream_of(values))
    _cuda.check(status, f"select_k ({form})")
    launches += 1
    if form == "warp":
        warp_launches += 1
    else:
        radix_launches += 1
    return ov, oi


def select_k(values: torch.Tensor, k: int, select_min: bool = True,
             indices: Optional[torch.Tensor] = None,
             algo: SelectAlgo | str = SelectAlgo.AUTO
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row k smallest (or largest) of ``values`` (..., n).

    Returns (values (..., k), int32 indices (..., k)), sorted best first.
    ``indices`` optionally maps positions to global ids."""
    algo = SelectAlgo(algo) if not isinstance(algo, SelectAlgo) else algo
    n = values.shape[-1]
    expects(0 < k <= n, "k=%d out of range for row length %d", k, n)
    if algo is SelectAlgo.AUTO or algo is SelectAlgo.KPASS:
        lead = values.shape[:-1]
        flat = values.reshape(-1, n).to(torch.float32).contiguous()
        vals, idxs = kpass_select_k(flat, k, select_min)
        vals = vals.reshape(*lead, k).to(values.dtype)
        idxs = idxs.reshape(*lead, k)
    else:
        vals, idxs = select_k_plain(values, k, select_min)
    if indices is not None:
        idxs = torch.gather(indices, -1, idxs.long()).to(torch.int32)
    return vals, idxs


def tune_select_k(rows: int, n: int, k: int, select_min: bool = True,
                  reps: int = 5, device=None):
    """Race K1 (``"kpass"``) against ``torch.topk`` (``"topk"``) on a
    (rows, n) float32 normal tensor made from seed 0 on ``device`` (the
    card by default), record the winner under the (n, k) shape class and
    return (winner, {name: median seconds}) — the measurement role of the
    reference's ``choose_select_k_algorithm`` table. The verdict steers no
    dispatch (module docstring). On the CPU ``"kpass"`` is the plain
    version."""
    from ..ops import autotune

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((rows, n), generator=gen, device=dev)
    cands = {
        "topk": lambda v: torch.topk(v, k, dim=-1, largest=not select_min),
        "kpass": lambda v: kpass_select_k(v, k, select_min),
    }
    return autotune.tune_best(autotune.shape_bucket("select_k", dev, n=n,
                                                    k=k),
                              cands, x, reps=reps, force=True)
