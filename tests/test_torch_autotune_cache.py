"""The port's on-disk verdict cache (``raft_tpu_torch.ops.autotune``)
against the JAX package's (``raft_tpu.ops.autotune``): the same file
protocol under the port's own variable, ``RAFT_TPU_TORCH_AUTOTUNE_CACHE``.

Record → file → forget → load round trip; ``""`` keeps verdicts in the
process and writes nothing; an unreadable or unwritable file warns and
the cache carries on in memory; a verdict recorded in one process is
found by ``lookup`` in another; the two packages' files stay apart. Every
test points the variable at its own ``tmp_path`` (or at ``""``) and
starts from an empty in-process cache, so no test reads or writes the
user's cache.
"""
import json
import os
import subprocess
import sys

import pytest

from raft_tpu.ops import autotune as jautotune
from raft_tpu_torch.ops import autotune

VAR = "RAFT_TPU_TORCH_AUTOTUNE_CACHE"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _verdicts_in_memory():
    """No verdict file for this module unless a test names one."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(VAR, "")
        mp.setattr(autotune, "_MEM_CACHE", {})
        mp.setattr(autotune, "_LOADED_FROM", None)
        yield


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """An empty in-process cache whose file is ``tmp_path/at.json``, as a
    new process would start with."""
    path = tmp_path / "at.json"
    monkeypatch.setenv(VAR, str(path))
    monkeypatch.setattr(autotune, "_MEM_CACHE", {})
    monkeypatch.setattr(autotune, "_LOADED_FROM", None)
    return path


def _restart(monkeypatch):
    """Forget what this process holds, as a new process would."""
    monkeypatch.setattr(autotune, "_MEM_CACHE", {})
    monkeypatch.setattr(autotune, "_LOADED_FROM", None)


def test_verdicts_stay_in_memory():
    assert autotune.cache_path() is None


def test_record_forget_load_round_trip(fresh, monkeypatch):
    autotune.record("cuda:H100:fam:n20", "fused")
    autotune.record("cuda:H100:fam:n10", "edge")
    assert json.loads(fresh.read_text()) == {"cuda:H100:fam:n10": "edge",
                                             "cuda:H100:fam:n20": "fused"}
    _restart(monkeypatch)
    assert autotune.lookup("cuda:H100:fam:n20") == "fused"
    assert autotune.entries() == {"cuda:H100:fam:n10": "edge",
                                  "cuda:H100:fam:n20": "fused"}
    autotune.forget("cuda:H100:fam:n20")
    autotune.forget("no such key")           # forgetting nothing is a no-op
    assert json.loads(fresh.read_text()) == {"cuda:H100:fam:n10": "edge"}
    _restart(monkeypatch)
    autotune.load_cache()
    assert autotune.lookup("cuda:H100:fam:n20") is None
    assert autotune.lookup("cuda:H100:fam:n10") == "edge"
    assert not [p for p in os.listdir(fresh.parent) if ".tmp" in p]


def test_same_protocol_as_jax(fresh, monkeypatch, tmp_path):
    """The port writes the file the JAX package writes for the same
    verdicts (one JSON object, sorted keys, indent 1), and reads one the
    JAX package wrote."""
    jfile = tmp_path / "jax.json"
    monkeypatch.setenv("RAFT_TPU_AUTOTUNE_CACHE", str(jfile))
    monkeypatch.setattr(jautotune, "_MEM_CACHE", {})
    monkeypatch.setattr(jautotune, "_EPHEMERAL", set())
    monkeypatch.setattr(jautotune, "_DISK_LOADED", False)
    for key, v in (("b:k", "x"), ("a:k", "y")):
        jautotune.record(key, v)
        autotune.record(key, v)
    assert fresh.read_text() == jfile.read_text()
    monkeypatch.setenv(VAR, str(jfile))
    _restart(monkeypatch)
    assert autotune.entries() == {"a:k": "y", "b:k": "x"}


def test_packages_keep_their_own_files(fresh, monkeypatch, tmp_path):
    """A verdict in the JAX package's file does not steer the port, and the
    port writes nothing there."""
    jfile = tmp_path / "jax.json"
    jfile.write_text(json.dumps({"k": "from_jax"}))
    monkeypatch.setenv("RAFT_TPU_AUTOTUNE_CACHE", str(jfile))
    assert autotune.lookup("k") is None
    autotune.record("k", "from_port")
    assert json.loads(jfile.read_text()) == {"k": "from_jax"}
    assert json.loads(fresh.read_text()) == {"k": "from_port"}


def test_empty_variable_writes_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv(VAR, "")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    _restart(monkeypatch)
    assert autotune.cache_path() is None
    autotune.record("k", "v")
    autotune.forget("k")
    autotune.record("k", "w")
    assert autotune.lookup("k") == "w"
    assert list(tmp_path.iterdir()) == []


def test_default_path(monkeypatch, tmp_path):
    monkeypatch.delenv(VAR)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert autotune.cache_path() == str(tmp_path / "raft_tpu_torch" /
                                        "autotune.json")
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert autotune.cache_path() == str(
        tmp_path / "home" / ".cache" / "raft_tpu_torch" / "autotune.json")


@pytest.mark.parametrize("text", ["{not json", "[1, 2]"])
def test_unreadable_file_warns_and_carries_on(fresh, text):
    fresh.write_text(text)
    with pytest.warns(UserWarning, match="unreadable"):
        assert autotune.lookup("k") is None
    autotune.record("k", "v")              # rewrites the file whole
    assert autotune.lookup("k") == "v"
    assert json.loads(fresh.read_text()) == {"k": "v"}


def test_unwritable_path_warns_and_keeps_memory(monkeypatch, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv(VAR, str(blocker / "at.json"))    # under a file
    _restart(monkeypatch)
    with pytest.warns(UserWarning, match="unwritable"):
        autotune.record("k", "v")
    assert autotune.lookup("k") == "v"


def test_file_read_once_per_path(fresh, monkeypatch, tmp_path):
    """The file is read at the first lookup after the variable names it;
    a verdict already in memory wins over the file's."""
    fresh.write_text(json.dumps({"a": "1", "b": "2"}))
    assert autotune.lookup("a") == "1"
    fresh.write_text(json.dumps({"a": "changed", "c": "3"}))
    assert autotune.lookup("a") == "1" and autotune.lookup("c") is None
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"a": "other", "d": "4"}))
    monkeypatch.setenv(VAR, str(other))
    assert autotune.lookup("d") == "4" and autotune.lookup("a") == "1"


def _child(code: str, path) -> str:
    env = {**os.environ, VAR: str(path)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.strip()


def test_verdict_crosses_processes(tmp_path):
    """A verdict recorded in one process is found by ``lookup`` in
    another, both pointed at the same file; with the variable empty the
    second finds nothing."""
    path = tmp_path / "shared.json"
    _child("from raft_tpu_torch.ops import autotune\n"
           "autotune.record(autotune.shape_bucket('cagra_knn_graph', 'cpu', "
           "n=1000000, d=128, k=64, m='L2Expanded'), 'ivf_pq')", path)
    lookup = ("from raft_tpu_torch.ops import autotune\n"
              "print(autotune.lookup(autotune.shape_bucket("
              "'cagra_knn_graph', 'cpu', n=999999, d=128, k=64, "
              "m='L2Expanded')))")
    assert _child(lookup, path) == "ivf_pq"
    assert _child(lookup, "") == "None"
