"""The bench harness of the PyTorch port (``raft_tpu_torch.bench``) against
the JAX package's (``raft_tpu.bench``), mirroring ``tests/test_bench.py``:
fbin/ibin files each package writes read by the other, the synthetic
specs, the big-ann directory and the lane resolution, ground truth, the
sweep runner's case names and Google-Benchmark keys (CAGRA's case with
its kNN-graph builder race and engine race), the CSV export and its
Pareto flags, and the CLI end to end with ``--device cpu``.

Tolerances. Ground-truth ids on integer-valued data: equal (exact
distances; both packages break ties to the lower row). Runner recall:
brute force exactly 1.0 in both packages; each IVF-Flat point within 0.02
of JAX's (the two builds draw their k-means from different generators,
so the lists, and with them the recall, differ a little). Export: the
same CSV text from the same JSON.
"""
import json

import numpy as np
import pytest
import torch

from ann_utils import naive_knn
from raft_tpu import bench as jbench
from raft_tpu.bench.__main__ import main as jmain
from raft_tpu_torch import bench
from raft_tpu_torch.bench.__main__ import main
from raft_tpu_torch.bench.datasets import resolve_lane_dataset
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.ops import autotune

torch.set_num_threads(1)


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


class TestIO:
    def test_fbin_ibin_roundtrip_across_packages(self, tmp_path):
        a = np.random.default_rng(0).standard_normal((13, 7)).astype(
            np.float32)
        b = np.arange(12, dtype=np.int32).reshape(4, 3)
        bench.write_fbin(tmp_path / "a.fbin", torch.from_numpy(a))
        bench.write_ibin(tmp_path / "b.ibin", b)
        np.testing.assert_array_equal(jbench.read_fbin(tmp_path / "a.fbin"),
                                      a)
        np.testing.assert_array_equal(jbench.read_ibin(tmp_path / "b.ibin"),
                                      b)
        jbench.write_fbin(tmp_path / "c.fbin", a * 2)
        jbench.write_ibin(tmp_path / "d.ibin", b + 1)
        np.testing.assert_array_equal(bench.read_fbin(tmp_path / "c.fbin"),
                                      a * 2)
        np.testing.assert_array_equal(bench.read_ibin(tmp_path / "d.ibin"),
                                      b + 1)
        jbench.write_fbin(tmp_path / "ja.fbin", a)
        assert (tmp_path / "a.fbin").read_bytes() == (
            tmp_path / "ja.fbin").read_bytes()

    def test_iter_fbin_batches(self, tmp_path):
        from raft_tpu_torch.bench.datasets import iter_fbin

        a = np.arange(50 * 3, dtype=np.float32).reshape(50, 3)
        bench.write_fbin(tmp_path / "a.fbin", a)
        parts = list(iter_fbin(tmp_path / "a.fbin", batch_rows=16))
        assert [len(p) for p in parts] == [16, 16, 16, 2]
        np.testing.assert_array_equal(np.concatenate(parts), a)

    @pytest.mark.parametrize("spec", ["blobs-1000x16", "uniform-500x8"])
    def test_load_synthetic(self, spec):
        base, q, gt, metric = bench.load_dataset(spec, n_queries=100,
                                                 device="cpu")
        jb, jq, jgt, jm = jbench.load_dataset(spec, n_queries=100)
        assert base.shape == jb.shape and q.shape == jq.shape
        assert base.dtype == torch.float32 and base.device.type == "cpu"
        assert gt is None and jgt is None and metric == jm == "sqeuclidean"
        if spec.startswith("uniform"):
            assert 0.0 <= float(base.min()) and float(base.max()) < 1.0
        else:
            # max(16, d // 2) blobs of std 3.0 around centers in ±10
            assert float(base.abs().max()) < 10 + 6 * 3.0

    def test_load_bigann_dir(self, tmp_path):
        rng = np.random.default_rng(1)
        base = rng.standard_normal((200, 8)).astype(np.float32)
        qs = rng.standard_normal((20, 8)).astype(np.float32)
        gt = rng.integers(0, 200, (20, 5)).astype(np.int32)
        d = tmp_path / "toy"
        d.mkdir()
        jbench.write_fbin(d / "base.fbin", base)
        jbench.write_fbin(d / "query.fbin", qs)
        jbench.write_ibin(d / "groundtruth.neighbors.ibin", gt)
        got_b, got_q, got_gt, metric = bench.load_dataset(
            "toy", dataset_dir=str(tmp_path), device="cpu")
        np.testing.assert_array_equal(got_b.numpy(), base)
        np.testing.assert_array_equal(got_q.numpy(), qs)
        np.testing.assert_array_equal(got_gt.numpy(), gt)
        assert metric == "sqeuclidean"
        with pytest.raises(RaftError, match="not found"):
            bench.load_dataset("absent", dataset_dir=str(tmp_path),
                               device="cpu")

    @pytest.mark.parametrize("name,metric", [
        ("toy-8-angular", "cosine"), ("toy-8-dot", "inner_product"),
        ("toy-8-euclidean", "sqeuclidean")])
    def test_load_hdf5(self, tmp_path, name, metric):
        import h5py

        rng = np.random.default_rng(2)
        with h5py.File(tmp_path / f"{name}.hdf5", "w") as f:
            f["train"] = rng.standard_normal((100, 8)).astype(np.float32)
            f["test"] = rng.standard_normal((10, 8)).astype(np.float32)
            f["neighbors"] = rng.integers(0, 100, (10, 5)).astype(np.int32)
        base, q, gt, got = bench.load_dataset(name,
                                              dataset_dir=str(tmp_path),
                                              device="cpu")
        want = jbench.load_dataset(name, dataset_dir=str(tmp_path))
        np.testing.assert_array_equal(base.numpy(), want[0])
        np.testing.assert_array_equal(gt.numpy(), want[2])
        assert got == want[3] == metric


class TestLaneResolution:
    def test_order_matches_jax(self, tmp_path):
        from raft_tpu.bench.datasets import resolve_lane_dataset as jres

        import h5py

        steps = [resolve_lane_dataset(str(tmp_path), budget_rows=5000)]
        assert steps[0] == jres(str(tmp_path), budget_rows=5000) == (
            "blobs-5000x128", "synthetic-fallback")
        with h5py.File(tmp_path / "sift-128-euclidean.hdf5", "w") as f:
            f["train"] = np.zeros((4, 8), np.float32)
        assert resolve_lane_dataset(str(tmp_path)) == jres(
            str(tmp_path)) == ("sift-128-euclidean", "hdf5")
        d = tmp_path / "sift-1m"
        d.mkdir()
        bench.write_fbin(d / "base.fbin", np.zeros((4, 8), np.float32))
        assert resolve_lane_dataset(str(tmp_path)) == jres(
            str(tmp_path)) == ("sift-1m", "fbin")

    def test_lane_cli_stamps_kind(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        out = tmp_path / "lane.json"
        main(["lane", "--dataset-dir", str(tmp_path / "nothing"),
              "--budget-rows", "2000", "--algorithms", "raft_brute_force",
              "-k", "5", "--reps", "1", "--batch-size", "50", "--device",
              "cpu", "--output", str(out)])
        doc = json.loads(out.read_text())
        assert doc["context"]["lane"] == {"dataset": "blobs-2000x128",
                                          "kind": "synthetic-fallback"}
        assert doc["context"]["backend"] == "cpu"
        assert [b["name"] for b in doc["benchmarks"]] == [
            "raft_brute_force/search"]


class TestGroundTruth:
    @pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
    def test_ids_match_jax_on_integer_data(self, metric):
        rng = np.random.default_rng(3)
        base = rng.integers(-3, 4, (700, 12)).astype(np.float32)
        qs = rng.integers(-3, 4, (45, 12)).astype(np.float32)
        d, i = bench.generate_groundtruth(base, qs, k=7, metric=metric,
                                          batch=20, device="cpu")
        jd, ji = jbench.generate_groundtruth(base, qs, k=7, metric=metric,
                                             batch=20)
        assert i.dtype == torch.int32 and i.shape == (45, 7)
        np.testing.assert_array_equal(i.numpy(), ji)
        np.testing.assert_array_equal(d.numpy(), jd)

    def test_matches_naive(self):
        rng = np.random.default_rng(4)
        base = rng.standard_normal((500, 16)).astype(np.float32)
        qs = rng.standard_normal((30, 16)).astype(np.float32)
        _, i = bench.generate_groundtruth(base, qs, k=5, device="cpu")
        _, want = naive_knn(base, qs, 5)
        assert np.mean([len(set(i[r].tolist()) & set(want[r])) / 5
                        for r in range(30)]) == 1.0


@pytest.fixture(scope="module")
def tiny():
    """A tiny blobs corpus as numpy arrays (both packages read it) and its
    ground truth from the port."""
    base, q, _, metric = bench.load_dataset("blobs-2000x16", n_queries=200,
                                            device="cpu")
    _, gt = bench.generate_groundtruth(base, q, k=10, metric=metric,
                                       device="cpu")
    return base.numpy(), q.numpy(), gt.numpy(), metric


@pytest.fixture(scope="module")
def cagra_run(tiny):
    """The CAGRA case on 1,000 rows and 32 queries, from no verdict: its
    results and the verdicts it recorded."""
    base, q, gt, metric = tiny
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(autotune, "_MEM_CACHE", {})
        got = bench.run_benchmarks(base[:1000], q[:32], naive_knn(
            base[:1000], q[:32], 10)[1], k=10, metric=metric,
            algos=("raft_cagra",), reps=1, verbose=False, device="cpu")
        yield got, autotune.entries()


class TestRunner:
    def test_runner_matches_jax(self, tiny):
        base, q, gt, metric = tiny
        algos = ("raft_brute_force", "raft_ivf_flat")
        got = bench.run_benchmarks(base, q, gt, k=10, metric=metric,
                                   algos=algos, reps=1, verbose=False,
                                   device="cpu")
        want = jbench.run_benchmarks(base, q, gt, k=10, metric=metric,
                                     algos=algos, reps=1, verbose=False)
        assert [r.name for r in got] == [r.name for r in want]
        for g, w in zip(got, want):
            assert list(g.to_gbench()) == list(w.to_gbench())
            assert g.qps > 0 and g.search_params == w.search_params
            if g.algo == "raft_brute_force":
                assert g.recall == w.recall == 1.0
            else:
                assert abs(g.recall - w.recall) <= 0.02, (g.name, g.recall,
                                                          w.recall)
        ivf = [r.recall for r in got if r.algo == "raft_ivf_flat"]
        assert all(b >= a - 0.005 for a, b in zip(ivf, ivf[1:]))

    def test_cagra_case_records_the_race(self, cagra_run):
        got, _ = cagra_run
        assert [r.name for r in got] == [
            f"raft_cagra.degree32.itopk{t}" for t in (32, 64, 128, 256)]
        for r in got:
            g = r.to_gbench()
            race = {k[5:-3]: v for k, v in g.items()
                    if k.startswith("race_") and k.endswith("_ms")}
            assert set(race) == {"gather", "edge", "fused"}
            assert g["engine"] == min(race, key=race.get)
            assert r.recall >= 0.9

    def test_cagra_case_builds_on_the_graph_race(self, cagra_run):
        """The case races the kNN-graph builders first, records the
        verdict under the build's own key, builds on it, and stamps the
        race into every entry."""
        from raft_tpu_torch.distance.distance_types import canonical_metric
        from raft_tpu_torch.neighbors import cagra

        got, verdicts = cagra_run
        extra = got[0].extra
        builders = ("brute", "ivf_pq", "nn_descent")
        secs = {b: extra[f"race_{b}_s"] for b in builders}
        recalls = {b: extra[f"edge_recall_{b}"] for b in builders}
        assert recalls["brute"] == 1.0
        assert extra["graph_algo"] == bench.graph_race_winner(secs, recalls)
        key = cagra._graph_algo_key(1000, 16, 64,
                                    canonical_metric("sqeuclidean"), "cpu")
        assert verdicts[key] == extra["graph_algo"]
        for r in got:
            g = r.to_gbench()
            assert g["graph_algo"] == extra["graph_algo"]
            assert {k: g[k] for k in extra if k.startswith(
                ("race_", "edge_recall_")) and not k.endswith("_ms")} == {
                k: v for k, v in extra.items() if k.startswith(
                    ("race_", "edge_recall_")) and not k.endswith("_ms")}

    def test_dtypes_not_ported(self, tiny):
        """Every store is ported: the tags of the JAX harness, and what
        stays refused is refused in both packages (an unknown dtype, int4
        for IVF-Flat, uint8's byte-grid remap of a float corpus with a
        non-L2 metric or an algorithm that ignores the store)."""
        base, q, gt, _ = tiny
        algos = ("raft_brute_force", "raft_ivf_flat", "raft_ivf_pq")
        for dtype in ("bfloat16", "int8", "uint8"):
            got = bench.default_configs(base, "sqeuclidean", algos,
                                        dtype=dtype, device="cpu")
            want = jbench.default_configs(base, "sqeuclidean", algos,
                                          dtype=dtype)
            assert {a: t for a, (_, t) in got.items()} == {
                a: t for a, (_, t) in want.items()}
        with pytest.raises(RaftError):
            bench.default_configs(base, "sqeuclidean", algos, dtype="fp8",
                                  device="cpu")
        with pytest.raises(RaftError, match="int4"):
            bench.default_configs(base, "sqeuclidean", ("raft_ivf_flat",),
                                  dtype="int4", device="cpu")
        for metric, algo in (("cosine", "raft_brute_force"),
                             ("sqeuclidean", "raft_cagra")):
            with pytest.raises(RaftError, match="uint8 on a float corpus"):
                bench.run_benchmarks(base, q, gt, metric=metric,
                                     algos=(algo,), dtype="uint8",
                                     device="cpu")


class TestCli:
    def test_export_matches_jax(self, tmp_path):
        doc = {
            "context": {"dataset": "toy"},
            "benchmarks": [
                {"name": "algoA.p1/search", "Recall": 0.8,
                 "items_per_second": 1000.0, "Latency": 0.01},
                {"name": "algoA.p2/search", "Recall": 0.9,
                 "items_per_second": 500.0, "Latency": 0.02},
                {"name": "algoA.p3/search", "Recall": 0.7,
                 "items_per_second": 400.0, "Latency": 0.02},
                {"name": "algoB.p1/search", "Recall": 0.9,
                 "items_per_second": 500.0, "Latency": 0.02,
                 "build_time": 3.0},
                {"name": "algoB.p2/search", "Recall": 0.9,
                 "items_per_second": 600.0, "Latency": 0.02,
                 "build_time": 3.0},
            ],
        }
        src = tmp_path / "r.json"
        src.write_text(json.dumps(doc))
        main(["export", "--input", str(src), "--output",
              str(tmp_path / "t.csv")])
        jmain(["export", "--input", str(src), "--output",
               str(tmp_path / "j.csv")])
        text = (tmp_path / "t.csv").read_text()
        assert text == (tmp_path / "j.csv").read_text()
        pareto = {r.split(",")[1]: r.split(",")[-1]
                  for r in text.strip().splitlines()[1:]}
        assert pareto == {"algoA.p1/search": "1", "algoA.p2/search": "1",
                          "algoA.p3/search": "0", "algoB.p1/search": "0",
                          "algoB.p2/search": "1"}

    def test_cli_prints_the_graph_race(self, tmp_path, monkeypatch, capsys):
        """``run`` with CAGRA prints the graph race's line and the verdict
        file it recorded in, and the file holds the race's verdict (the
        itopk sweep cut to one point to keep the run short)."""
        from functools import partial

        from raft_tpu_torch.bench import runner

        path = tmp_path / "verdicts.json"
        monkeypatch.setenv("RAFT_TPU_TORCH_AUTOTUNE_CACHE", str(path))
        monkeypatch.setattr(autotune, "_MEM_CACHE", {})
        monkeypatch.setattr(autotune, "_LOADED_FROM", None)
        monkeypatch.setattr(runner, "default_configs", partial(
            runner.default_configs, itopk_sweep=[32]))
        out = tmp_path / "run.json"
        main(["run", "--dataset", "blobs-800x8", "--algorithms",
              "raft_cagra", "-k", "10", "--reps", "1", "--batch-size",
              "20", "--device", "cpu", "--output", str(out)])
        said = capsys.readouterr().out
        entry = json.loads(out.read_text())["benchmarks"][0]
        line = next(ln for ln in said.splitlines() if "graph race" in ln)
        assert f"-> {entry['graph_algo']}" in line and str(path) in line
        disk = json.loads(path.read_text())
        assert entry["graph_algo"] in disk.values()
        assert any(":cagra_knn_graph:" in k for k in disk)

    def test_cli_end_to_end(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        main(["groundtruth", "--dataset", "blobs-1500x16", "-k", "20",
              "--device", "cpu", "--output", str(tmp_path / "gt")])
        gt = bench.read_ibin(tmp_path / "gt" / "groundtruth.neighbors.ibin")
        assert gt.shape == (10_000, 20)
        out = tmp_path / "run.json"
        main(["run", "--dataset", "blobs-1500x16", "--algorithms",
              "raft_brute_force,raft_ivf_flat,raft_ivf_pq", "-k", "10",
              "--reps", "1", "--batch-size", "100", "--device", "cpu",
              "--output", str(out)])
        doc = json.loads(out.read_text())
        ctx = doc["context"]
        assert ctx["executable"] == "raft_tpu_torch.bench"
        assert (ctx["backend"], ctx["device"]) == ("cpu", "cpu")
        names = [b["name"] for b in doc["benchmarks"]]
        assert names[0] == "raft_brute_force/search" and len(names) == 15
        assert doc["benchmarks"][0]["Recall"] == 1.0
        main(["export", "--input", str(out)])
        assert (tmp_path / "run.csv").read_text().count("\n") == 16
        main(["plot", "--input", str(out)])
        assert (tmp_path / "run.png").stat().st_size > 0


@pytest.mark.parametrize("call", [
    lambda: bench.load_dataset("blobs-100x4", n_queries=4),
    lambda: bench.generate_groundtruth(np.zeros((10, 4), np.float32),
                                       np.zeros((2, 4), np.float32), k=2),
    lambda: bench.run_benchmarks(np.zeros((10, 4), np.float32),
                                 np.zeros((2, 4), np.float32),
                                 np.zeros((2, 2), np.int32), k=2),
    lambda: main(["run", "--dataset", "blobs-100x4"]),
])
def test_entry_points_need_a_card_or_cpu(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RaftError, match="no CUDA device"):
        call()
