"""The card's measured peaks: counterpart of ``raft_tpu/bench/roofline.py``
(``probe``, ``matmul_tflops``, ``hbm_stream_gbps``, ``gather_gbps``,
``dispatch_us``, ``dispatch_split``; the same keys and method).

A roofline share divides a kernel's achieved rate by the card's. This
probe measures those rates on the card in use: chained matmuls (TFLOP/s),
a read-and-write stream (GB/s), random-row gathers (GB/s), and the cost
of a launch. Each rate is the slope of a two-point fit: the same chain of
launches at two iteration counts (i1, i2),

    per_iter_s = (t(i2) - t(i1)) / (i2 - i1),

so a call's constant costs (its first launch, the closing read) cancel.
Each time is :func:`raft_tpu_torch.ops.autotune.measure_value_read_wall`
over two inputs of distinct content after a warm-up input, the window
closed by a host read of a scalar folded from every output; every
iteration reads the previous one's result, so none can be skipped.
Every size is an argument (the tests run them tiny on the CPU, where the
numbers are the CPU's and name no device metric). ``torch.matmul`` at
f32 runs under torch's default, TF32 off (``probe`` reports the
setting). A reading above the card's data sheet (H100 SXM: 989 TFLOP/s
bf16 dense, 3.35 TB/s) counts work the card did not do: a fault of the
probe.

Run: ``python -m raft_tpu_torch.bench.roofline [--quick]`` on the card
(one JSON line).
"""
from __future__ import annotations

import math
import time
from typing import Dict

import torch

from ..ops.autotune import measure, measure_value_read_wall
from ..utils import resolve_device

__all__ = ["probe", "matmul_tflops", "hbm_stream_gbps", "gather_gbps",
           "dispatch_us", "dispatch_split"]

# elementwise ops a process rarely launches, each a kernel compiled into
# torch (not one torch compiles at run time, as it does most of
# torch.special on CUDA, which would time a compile): dispatch_split's
# first launch takes the first of them not yet taken in this process
_FRESH_OPS = (torch.frac, torch.sinc, torch.erfinv, torch.logit,
              torch.signbit, torch.exp2, torch.trunc)
_fresh_taken = []
# rows a bag of gather_gbps' embedding_bag: bags enough to fill the card
_BAG = 16


def _slope(make_fn, make_inputs, i1: int, i2: int) -> float:
    """Seconds an iteration from the two-point fit of t(iters)."""
    times = {}
    for iters in (i1, i2):
        fn = make_fn(iters)
        ins = make_inputs(3)
        times[iters] = measure_value_read_wall(fn, ins[1:],
                                               warm_input=ins[0])
    return (times[i2] - times[i1]) / (i2 - i1)


def _normal(shape, seed: int, dev) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev)


def matmul_tflops(n: int = 8192, dtype=torch.bfloat16, i1: int = 64,
                  i2: int = 192, device=None) -> float:
    """Sustained TFLOP/s of chained n x n x n ``torch.matmul``: c ← c @
    (b / √n), each product reading the last, the magnitudes steady."""
    dev = resolve_device(device)
    bs = (_normal((n, n), 1, dev) / math.sqrt(n)).to(dtype)

    def make(iters):
        def f(a):
            for _ in range(iters):
                a = torch.matmul(a, bs)
            return a
        return f

    def inputs(m):
        return [_normal((n, n), 20 + j, dev).to(dtype) for j in range(m)]

    return 2.0 * n ** 3 / _slope(make, inputs, i1, i2) / 1e12


def hbm_stream_gbps(mbytes: int = 1024, i1: int = 64, i2: int = 256,
                    device=None) -> float:
    """Sustained GB/s of a float32 buffer of ``mbytes`` MiB read and
    written once an iteration, scaled by a factor that changes with the
    iteration (every value changes)."""
    dev = resolve_device(device)
    rows = max(1, (mbytes << 20) // 4 // 1024)
    traffic = 2.0 * 4 * rows * 1024

    def make(iters):
        def f(x):
            for i in range(iters):
                x = x * (1.0 + 2.0 ** -6 * (i % 3 + 1))
            return x
        return f

    def inputs(m):
        return [_normal((rows, 1024), 10 + j, dev) for j in range(m)]

    return traffic / _slope(make, inputs, i1, i2) / 1e9


def gather_gbps(tbl_rows: int = 1 << 20, row_d: int = 128,
                g_rows: int = 1 << 18, i1: int = 16, i2: int = 64,
                device=None) -> float:
    """Effective GB/s of random-row gathers (the traffic of CAGRA hops
    and refine): ``g_rows`` rows of a (``tbl_rows``, ``row_d``) float32
    table an iteration, at indices hashed from the iteration and the
    carried sum (uint32 arithmetic, as the JAX probe), so the index stream
    depends on the input. The rows are read once and summed as they are
    read (``embedding_bag``, bags of 16 rows), as XLA fuses the JAX
    probe's take and sum; a gathered block written out and read back
    would triple the bytes the rate counts."""
    dev = resolve_device(device)
    tbl = _normal((tbl_rows, row_d), 3, dev)
    mask = (1 << 32) - 1
    lanes = torch.arange(g_rows, dtype=torch.int64, device=dev)
    bags = torch.arange(0, g_rows, _BAG, dtype=torch.int64, device=dev)

    def make(iters):
        def f(c):
            for i in range(iters):
                iu = (i + c[0].to(torch.int64)) & mask
                base = (iu * 1315423911 + 2654435761) & mask
                idx = ((base + lanes * 2654435761) & mask) % tbl_rows
                c = c + torch.nn.functional.embedding_bag(
                    idx, tbl, bags, mode="sum").sum(dim=0)
            return c
        return f

    def inputs(m):
        return [torch.zeros(row_d, device=dev) + j for j in range(m)]

    return g_rows * row_d * 4 / _slope(make, inputs, i1, i2) / 1e9


def dispatch_us(reps: int = 11, device=None) -> float:
    """Median round trip of a trivial launch (an add on 8 x 128 floats and
    a synchronise): the per-call constant the slopes cancel."""
    dev = resolve_device(device)
    x = torch.zeros((8, 128), device=dev)
    return measure(lambda a: a + 1.0, x, reps=reps) * 1e6


def dispatch_split(reps: int = 32, device=None) -> dict:
    """The launch constant split: ``dispatch_once_us``, the first launch
    of an op this process has not launched before (its kernel's module
    loaded on the card then) and its synchronise, against
    ``dispatch_steady_us``, a launch's share of ``reps`` back-to-back
    launches, each reading the last, closed by one synchronise.
    ``dispatch_once_op`` names the op; once every op of the list has been
    taken, the last one is launched again and
    ``dispatch_once_fresh`` is False."""
    dev = resolve_device(device)
    x = torch.zeros((8, 128), device=dev)
    fresh = len(_fresh_taken) < len(_FRESH_OPS)
    op = _FRESH_OPS[len(_fresh_taken)] if fresh else _FRESH_OPS[-1]
    if fresh:
        _fresh_taken.append(op)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    op(x)
    sync()
    once = time.perf_counter() - t0
    y = x
    t0 = time.perf_counter()
    for _ in range(reps):
        y = y + 1.0
    sync()
    steady = (time.perf_counter() - t0) / reps
    return {"dispatch_once_us": once * 1e6,
            "dispatch_steady_us": steady * 1e6,
            "dispatch_once_op": op.__name__, "dispatch_once_fresh": fresh}


def probe(quick: bool = False, device=None, matmul_n: int = 8192,
          stream_mbytes: int = 0, tbl_rows: int = 1 << 20, row_d: int = 128,
          g_rows: int = 1 << 18) -> Dict[str, object]:
    """This card's peaks by slope fits: JAX's keys (``matmul_bf16_tflops``,
    ``matmul_f32_tflops``, ``hbm_stream_gbps``, ``gather_gbps``,
    ``dispatch_us``, ``dispatch_once_us``, ``dispatch_steady_us``) and
    ``matmul_f32_allow_tf32`` (torch's setting the f32 matmul ran under),
    ``dispatch_once_op`` / ``dispatch_once_fresh``, ``device``.
    ``quick`` shortens the larger iteration counts (the matmul pair
    stays at >= 64 iterations); ``stream_mbytes`` 0 means 512 MiB quick,
    1,024 otherwise."""
    dev = resolve_device(device)
    mm = (64, 128) if quick else (64, 192)
    st = (64, 160) if quick else (64, 256)
    ga = (16, 48) if quick else (16, 64)
    mbytes = stream_mbytes or (512 if quick else 1024)
    return {
        "device": (f"gpu:{torch.cuda.get_device_name(dev)}"
                   if dev.type == "cuda" else dev.type),
        "matmul_bf16_tflops": matmul_tflops(matmul_n, torch.bfloat16,
                                            *mm, device=dev),
        "matmul_f32_tflops": matmul_tflops(matmul_n, torch.float32, *mm,
                                           device=dev),
        "matmul_f32_allow_tf32": bool(
            torch.backends.cuda.matmul.allow_tf32),
        "hbm_stream_gbps": hbm_stream_gbps(mbytes, *st, device=dev),
        "gather_gbps": gather_gbps(tbl_rows, row_d, g_rows, *ga,
                                   device=dev),
        "dispatch_us": dispatch_us(device=dev),
        **dispatch_split(device=dev),
    }


if __name__ == "__main__":
    import json
    import sys

    print(json.dumps(probe(quick="--quick" in sys.argv[1:])))
