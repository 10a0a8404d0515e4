"""The port's measurement tools on the CPU: ``ops.autotune``'s
``measure_value_read_wall``, ``measure_throughput`` and the plausibility
floor (``TimingUnreliableError``), ``matrix.select_k.tune_select_k``,
``bench.roofline.probe`` at tiny sizes, ``bench.select_k_sweep.run`` on a
small grid, and brute force's ``tune_search``, whose verdict ``auto``
does not follow. The numbers here are the CPU's: the tests hold the contracts
(call counts, keys, verdicts, files), never a time.
"""
import hashlib
import json
import math
import os

import pytest
import torch

from raft_tpu.bench import roofline as jroofline
from raft_tpu_torch.bench import roofline, select_k_sweep
from raft_tpu_torch.matrix import select_k as sk
from raft_tpu_torch.neighbors import brute_force
from raft_tpu_torch.ops import autotune

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX probe's keys (raft_tpu/bench/roofline.py::probe)
JAX_PROBE_KEYS = {"matmul_bf16_tflops", "matmul_f32_tflops",
                  "hbm_stream_gbps", "gather_gbps", "dispatch_us",
                  "dispatch_once_us", "dispatch_steady_us"}


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


class Counted:
    """A callable that counts its calls and returns (x + 1, x)."""

    def __init__(self):
        self.calls = 0

    def __call__(self, x, *rest):
        self.calls += 1
        return (x + 1.0, x)


def _ok(t):
    return math.isfinite(t) and t > 0


def test_value_read_wall_calls_each_input_once():
    fn = Counted()
    inputs = [torch.full((4,), float(i)) for i in range(5)]
    t = autotune.measure_value_read_wall(fn, inputs, warm_input=torch.zeros(4))
    assert fn.calls == 6 and _ok(t)
    fn = Counted()
    assert _ok(autotune.measure_value_read_wall(fn, inputs[:2]))
    assert fn.calls == 2


def test_value_read_wall_folds_non_finite_outputs():
    fn = lambda x: (torch.full((2,), float("nan")),)  # noqa: E731
    assert _ok(autotune.measure_value_read_wall(fn, [torch.zeros(1)] * 3))
    with pytest.raises(Exception):
        autotune.measure_value_read_wall(lambda x: None, [torch.zeros(1)])


def test_throughput_windows():
    fn = Counted()
    t = autotune.measure_throughput(fn, torch.zeros(3), depth=4, reps=3)
    assert fn.calls == 1 + 4 * 3 and _ok(t)
    fn = Counted()
    autotune.measure_throughput(fn, torch.zeros(3), depth=2, reps=2,
                                out0=fn(torch.zeros(3)))
    assert fn.calls == 1 + 2 * 2


def test_floor_remeasures_once_then_raises():
    fn = Counted()
    with pytest.raises(autotune.TimingUnreliableError):
        autotune.measure_throughput(fn, torch.zeros(3), depth=2, reps=3,
                                    suspect_floor_s=60.0)
    assert fn.calls == 1 + 2 * (2 * 3)
    fn = Counted()
    with pytest.raises(autotune.TimingUnreliableError):
        autotune.measure(fn, torch.zeros(3), reps=3, suspect_floor_s=60.0,
                         value_read=True)
    assert fn.calls == 1 + 2 * 3
    fn = Counted()
    assert _ok(autotune.measure(fn, torch.zeros(3), reps=3,
                                suspect_floor_s=1e-12))
    assert fn.calls == 1 + 3


def test_tune_best_lets_an_unreliable_candidate_raise():
    cands = {"a": Counted(), "b": Counted()}
    with pytest.raises(autotune.TimingUnreliableError):
        autotune.tune_best("measure-test", cands, torch.zeros(2), reps=1,
                           suspect_floor_s=60.0, force=True)
    assert autotune.lookup("measure-test") is None
    winner, times = autotune.tune_best("measure-test", cands,
                                       torch.zeros(2), reps=1,
                                       value_read=True)
    assert autotune.lookup("measure-test") == winner and set(times) == {
        "a", "b"}


def test_tune_select_k_records_a_verdict():
    winner, times = sk.tune_select_k(16, 1024, 10, reps=2, device="cpu")
    assert set(times) == {"kpass", "topk"} and all(map(_ok, times.values()))
    key = autotune.shape_bucket("select_k", "cpu", n=1024, k=10)
    assert autotune.lookup(key) == winner
    # the verdict steers nothing: AUTO still takes K1's path
    autotune.record(key, "topk")
    x = torch.randn(4, 1024)
    v, i = sk.select_k(x, 10)
    assert torch.equal(v, sk.select_k_plain(x, 10)[0])


def test_roofline_probe_tiny_returns_jax_keys():
    out = roofline.probe(quick=True, device="cpu", matmul_n=16,
                         stream_mbytes=1, tbl_rows=256, row_d=8, g_rows=64)
    assert JAX_PROBE_KEYS <= set(out)
    # the JAX probe returns these keys (its probe body, read as text)
    src = open(jroofline.__file__).read()
    assert all(f'"{k}"' in src for k in JAX_PROBE_KEYS)
    assert out["device"] == "cpu" and out["matmul_f32_allow_tf32"] in (
        True, False)
    for k in JAX_PROBE_KEYS:
        assert isinstance(out[k], float) and math.isfinite(out[k])
    assert out["dispatch_once_us"] > 0 and out["dispatch_steady_us"] > 0


def test_roofline_pieces_at_tiny_sizes():
    assert math.isfinite(roofline.matmul_tflops(8, torch.float32, 2, 6,
                                                device="cpu"))
    assert math.isfinite(roofline.hbm_stream_gbps(1, 2, 6, device="cpu"))
    assert math.isfinite(roofline.gather_gbps(64, 4, 16, 2, 6,
                                              device="cpu"))
    assert roofline.dispatch_us(reps=3, device="cpu") > 0


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_select_k_sweep_writes_its_document(tmp_path, monkeypatch):
    root_file = os.path.join(ROOT, "bench_select_k_sweep.json")
    before = _digest(root_file)
    monkeypatch.setattr(select_k_sweep, "GRID", [(8, 256, 10),
                                                 (4, 512, 32)])
    out = tmp_path / "sweep.json"
    doc = select_k_sweep.run(str(out), device="cpu", reps=2)
    assert json.loads(out.read_text()) == doc
    assert doc["device"] == "cpu" and doc["power_limit"] is None
    assert [(r["rows"], r["n"], r["k"]) for r in doc["results"]] == [
        (8, 256, 10), (4, 512, 32)]
    for r in doc["results"]:
        assert r["winner"] in ("kpass", "topk")
        assert set(r["ms"]) == {"kpass", "topk"}
    assert _digest(root_file) == before
    assert select_k_sweep.DEFAULT_OUT.startswith("build" + os.sep)
    assert len(select_k_sweep.GRID) == 2


def test_select_k_sweep_grid_is_jax_grid():
    from raft_tpu.bench import select_k_sweep as jsweep

    assert select_k_sweep.GRID == jsweep.GRID


def test_brute_force_tune_search_races_k2_and_scan(monkeypatch):
    """The race is K2 ("pallas") against the scan engine, never the plain
    "matmul"; ``auto`` stays on K2 whatever verdict is recorded."""
    x = torch.randn(600, 16, generator=torch.Generator().manual_seed(0))
    q = x[:40] + 0.1
    idx = brute_force.build(x, device="cpu")
    winner, times = brute_force.tune_search(idx, q, 5, reps=1)
    assert set(times) == {"pallas", "scan"} and winner in times
    scans = []
    orig = brute_force._search_scan
    monkeypatch.setattr(brute_force, "_search_scan", lambda *a: (
        scans.append(1), orig(*a))[1])
    key = brute_force._tune_key(idx, 40, 5)
    for verdict in ("scan", "pallas", "matmul"):
        autotune.record(key, verdict)
        v_auto, i_auto = brute_force.search(idx, q, 5)
        assert scans == []
    v_k2, i_k2 = brute_force.search(idx, q, 5, algo="pallas")
    assert torch.equal(i_auto, i_k2) and torch.equal(v_auto, v_k2)
    # a metric K2 does not serve races the scan engine alone
    l1 = brute_force.build(x, "l1", device="cpu")
    assert set(brute_force.tune_search(l1, q, 5, reps=1)[1]) == {"scan"}
