"""Edge recall of the NN-descent builders by rule and round cap, at a
corpus size a user builds.

Usage, from the root of a checkout, on a machine with a card::

    python -m raft_tpu_torch.tools.nnd_sweep --data path --k 128 \\
        --exposure closest,sampled --rounds 20,100

``--data path``: ``chip_smoke.py``'s corpus (1,000,000 x 128 rows in 1,000
overlapping Gaussian clusters, seed 0, the same draws; ``--rows`` draws
fewer, in one cluster a 1,000 rows); ``--data blobs``: the bench
harness's ``blobs-1000000x128``. For each (exposure, round cap) of the
batched builder (``ops.nn_descent.build_graph``) it prints the rounds
run, the last update rate, the build seconds and the edge recall: the
share of the exact ``k`` nearest other rows of ``--sample`` random rows
(brute force, K2 + K1) that the graph holds. ``--gnnd`` also runs the
GNND-shaped builder (``neighbors.nn_descent.build``) at each round cap,
after printing the candidate pairs its local join holds on the host a
round (3·n·(2s)², s = k / 2) and the bytes of their two int32 arrays;
it skips the build where those bytes exceed an eighth of the host's
memory (the join and its grouping by target hold a dozen arrays of that
length at once: broadcast copies, masks, a shuffle, sort orders).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..bench import load_dataset
from ..neighbors import brute_force
from ..neighbors import nn_descent as gnnd
from ..neighbors.cagra import _drop_self_pad
from ..ops import nn_descent as nnd
from ..stats.metrics import neighborhood_recall


def path_data(n: int = 1_000_000, d: int = 128, blobs: int = 1000,
              seed: int = 0) -> np.ndarray:
    """``chip_smoke.py``'s corpus: the same numpy draws in the same
    order (centers, spreads, then the rows)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((blobs, d), dtype=np.float32)
    scales = rng.uniform(1.0, 1.6, blobs).astype(np.float32)
    lab = rng.integers(0, blobs, n)
    x = rng.standard_normal((n, d), dtype=np.float32)
    x *= scales[lab, None]
    x += centers[lab]
    return x


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m raft_tpu_torch.tools."
                                "nnd_sweep")
    p.add_argument("--data", choices=["path", "blobs"], default="path")
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--exposure", default="closest,sampled")
    p.add_argument("--rounds", default="20,100")
    p.add_argument("--rows", type=int, default=1_000_000,
                   help="rows of the path corpus (drawn as it draws them, "
                   "one cluster a 1,000 rows)")
    p.add_argument("--gnnd", action="store_true",
                   help="also run the GNND-shaped builder")
    p.add_argument("--sample", type=int, default=10_000)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.data == "path":
        x = torch.from_numpy(path_data(
            args.rows, blobs=max(1, args.rows // 1000))).to(
            args.device or "cuda")
    else:
        x = load_dataset("blobs-1000000x128", device=args.device)[0]
    dev = x.device
    n, k = x.shape[0], args.k
    g = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randperm(n, generator=g, device=dev)[:args.sample]
    _, ids = brute_force.search(brute_force.build(x, device=dev), x[rows],
                                k + 1)
    exact = _drop_self_pad(ids.long(), rows, k, n)
    for exposure in args.exposure.split(","):
        for cap in (int(r) for r in args.rounds.split(",")):
            rates = []
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            graph = nnd.build_graph(
                x, k, rounds=cap, exposure=exposure, device=dev,
                progress=lambda r, total, rate, s: rates.append(rate))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t = time.perf_counter() - t0
            print(f"{args.data} n={n} k={k} exposure={exposure} cap={cap}: "
                  f"{len(rates)} rounds, last update rate {rates[-1]:.4f}, "
                  f"{t:.1f} s, edge recall "
                  f"{neighborhood_recall(graph[rows], exact):.4f}",
                  flush=True)
    if args.gnnd:
        s = max(4, k // 2)
        pairs = 3 * n * (2 * s) ** 2
        need = 2 * 4 * pairs
        host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        print(f"{args.data} n={n} k={k} gnnd: local join {pairs} pairs a "
              f"round, {need / 2**30:.1f} GiB for their two int32 arrays "
              f"(host {host / 2**30:.1f} GiB)", flush=True)
        for cap in (int(r) for r in args.rounds.split(",")):
            if 8 * need > host:
                print(f"{args.data} n={n} k={k} gnnd cap={cap}: skipped, "
                      f"the pair arrays exceed an eighth of the host's "
                      f"memory", flush=True)
                continue
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            graph = gnnd.build(x, k, n_iters=cap, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t = time.perf_counter() - t0
            print(f"{args.data} n={n} k={k} gnnd cap={cap}: {t:.1f} s, "
                  f"edge recall "
                  f"{neighborhood_recall(graph[rows], exact):.4f}",
                  flush=True)


if __name__ == "__main__":
    main()
