"""CLI: ``python -m raft_tpu_torch.bench <subcommand>``, counterpart of
``raft_tpu/bench/__main__.py``.

The raft-ann-bench subcommands (run/__main__.py:141-256):
``groundtruth`` (exact ground truth by brute force), ``run`` (the
QPS-at-recall sweeps, Google-Benchmark JSON out), ``lane`` (the standing
SIFT-1M lane, with its synthetic fallback stamped into the artifact),
``export`` (JSON → CSV with the Pareto points marked) and ``plot``
(QPS-vs-recall curves; matplotlib is imported only here). ``--device``
(the CUDA card by default) picks where ``groundtruth``, ``run`` and
``lane`` run.
"""
from __future__ import annotations

import argparse
import csv
import json
import platform
import subprocess
import time
from pathlib import Path

import torch

from ..utils import resolve_device


def _device_context(dev: torch.device) -> dict:
    """What ran the benchmark: the torch device and, on a card, its name
    and power limit as ``nvidia-smi`` gives them."""
    ctx = {"backend": dev.type, "device": str(dev)}
    if dev.type == "cuda":
        ctx["device_name"] = torch.cuda.get_device_name(dev)
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i",
                              str(dev.index or 0)], capture_output=True,
                             text=True, timeout=60, check=True)
        ctx["nvidia_smi"] = out.stdout.strip()
    return ctx


def _cmd_groundtruth(args):
    from .datasets import (generate_groundtruth, load_dataset, write_fbin,
                           write_ibin)

    dev = resolve_device(args.device)
    base, queries, _, metric = load_dataset(args.dataset, args.dataset_dir,
                                            device=dev)
    d, i = generate_groundtruth(base, queries, args.k, metric, device=dev)
    out = Path(args.output or f"{args.dataset}.gt")
    out.mkdir(parents=True, exist_ok=True)
    write_ibin(out / "groundtruth.neighbors.ibin", i)
    write_fbin(out / "groundtruth.distances.fbin", d)
    print(f"wrote ground truth (k={args.k}) to {out}/")


def _cmd_run(args):
    from .datasets import generate_groundtruth, load_dataset
    from .runner import run_benchmarks, to_gbench_json

    dev = resolve_device(args.device)
    base, queries, gt, metric = load_dataset(args.dataset, args.dataset_dir,
                                             device=dev)
    if args.metric:
        metric = args.metric
    if gt is None or gt.shape[1] < args.k:
        print("# generating ground truth (exact brute force)...")
        _, gt = generate_groundtruth(base, queries, max(args.k, 100),
                                     metric, device=dev)
    results = run_benchmarks(
        base, queries, gt, k=args.k, metric=metric,
        algos=args.algorithms.split(","), batch_size=args.batch_size,
        reps=args.reps, dtype=args.dtype, device=dev)
    context = {
        "date": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "dataset": args.dataset,
        "host_name": platform.node(),
        "executable": "raft_tpu_torch.bench",
        "num_cpus": 0,
        **_device_context(dev),
    }
    out = Path(args.output or f"{args.dataset}.bench.json")
    out.write_text(to_gbench_json(results, context))
    print(f"wrote {len(results)} benchmark cases to {out}")


def _cmd_lane(args):
    from .datasets import resolve_lane_dataset

    name, kind = resolve_lane_dataset(args.dataset_dir, args.budget_rows)
    if kind == "synthetic-fallback":
        print(f"# lane: SIFT-1M absent from dataset dir -> {name} "
              "(synthetic fallback; NOT a comparable number)")
    else:
        print(f"# lane: {name} ({kind})")
    args.dataset = name
    args.output = args.output or f"lane.{name}.bench.json"
    _cmd_run(args)
    out = Path(args.output)
    doc = json.loads(out.read_text())
    doc.setdefault("context", {})["lane"] = {"dataset": name, "kind": kind}
    out.write_text(json.dumps(doc, indent=2))


def _pareto(points):
    """The Pareto-optimal (recall, qps) points (data_export)."""
    return [not any(r2 >= r and q2 > q or r2 > r and q2 >= q
                    for r2, q2 in points) for r, q in points]


def _cmd_export(args):
    doc = json.loads(Path(args.input).read_text())
    by_algo = {}
    for r in doc["benchmarks"]:
        by_algo.setdefault(r["name"].split(".")[0], []).append(r)
    out = Path(args.output or Path(args.input).with_suffix(".csv"))
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["algo", "name", "recall", "qps", "latency_s",
                    "build_time", "pareto"])
        for algo, rs in by_algo.items():
            flags = _pareto([(r["Recall"], r["items_per_second"])
                             for r in rs])
            for r, p in zip(rs, flags):
                w.writerow([algo, r["name"], r["Recall"],
                            r["items_per_second"], r["Latency"],
                            r.get("build_time", ""), int(p)])
    print(f"wrote {out}")


def _cmd_plot(args):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    doc = json.loads(Path(args.input).read_text())
    by_algo = {}
    for r in doc["benchmarks"]:
        by_algo.setdefault(r["name"].split(".")[0], []).append(
            (r["Recall"], r["items_per_second"]))
    fig, ax = plt.subplots(figsize=(8, 6))
    for algo, pts in sorted(by_algo.items()):
        pts.sort()
        ax.plot([p[0] for p in pts], [p[1] for p in pts], "o-", label=algo)
    ax.set_xlabel("recall@k")
    ax.set_ylabel("QPS")
    ax.set_yscale("log")
    ax.set_title(doc.get("context", {}).get("dataset", ""))
    ax.grid(True, alpha=0.3)
    ax.legend()
    out = Path(args.output or Path(args.input).with_suffix(".png"))
    fig.savefig(out, dpi=120, bbox_inches="tight")
    print(f"wrote {out}")


def _sweep_args(p, algorithms_help: str):
    p.add_argument("--dataset-dir", default=None)
    p.add_argument("--algorithms",
                   default="raft_brute_force,raft_ivf_flat,raft_ivf_pq,"
                           "raft_cagra", help=algorithms_help)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--metric", default=None)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16", "int8", "uint8", "int4"],
                   help="dataset storage dtype (brute force / ivf_flat; "
                        "int4: brute force only)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--output", default=None)


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m raft_tpu_torch.bench")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("groundtruth", help="exact GT via brute force")
    g.add_argument("--dataset", required=True)
    g.add_argument("--dataset-dir", default=None)
    g.add_argument("-k", type=int, default=100)
    g.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    g.add_argument("--output", default=None)
    g.set_defaults(fn=_cmd_groundtruth)

    r = sub.add_parser("run", help="run QPS@recall sweeps")
    r.add_argument("--dataset", required=True)
    _sweep_args(r, "comma-separated algos")
    r.set_defaults(fn=_cmd_run)

    ln = sub.add_parser(
        "lane", help="standing SIFT-1M Pareto lane (synthetic fallback)")
    ln.add_argument("--budget-rows", type=int, default=100_000,
                    help="synthetic fallback corpus rows when SIFT absent")
    _sweep_args(ln, "comma-separated algos")
    ln.set_defaults(fn=_cmd_lane)

    e = sub.add_parser("export", help="GBench JSON → CSV + pareto")
    e.add_argument("--input", required=True)
    e.add_argument("--output", default=None)
    e.set_defaults(fn=_cmd_export)

    pl = sub.add_parser("plot", help="QPS-vs-recall curves")
    pl.add_argument("--input", required=True)
    pl.add_argument("--output", default=None)
    pl.set_defaults(fn=_cmd_plot)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
