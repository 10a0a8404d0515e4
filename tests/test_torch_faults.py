"""The port's fault probes (``raft_tpu_torch/core/faults.py``) against the
JAX package's (``raft_tpu/core/faults.py``): the spec grammar
``kind@pattern[:count][=value]`` gives the same fields, and the probes —
``fired``, ``check``, ``corrupt``, ``cut``, ``crash``, ``sleep_if`` —
fire, count and transform bytes as JAX's do. Both modules' armed faults
are process state; every test arms through ``inject`` or re-reads a
patched environment, and leaves nothing armed.
"""
import numpy as np
import pytest

from raft_tpu.core import faults as jfaults
from raft_tpu_torch.core import faults
from raft_tpu_torch.core.errors import RaftError

SPECS = ["kernel_compile@*", "shard_dead@*.shard1",
         "io_error@core.serialize.*:1", "slow_dispatch@ivf_flat.*=0.05",
         "corrupt_bytes@core.serialize.array.codes:2=7", "crash_point",
         "wal_torn_tail@core.wal.append:1=10", "kind@", " io_error@x:3 "]


@pytest.fixture(autouse=True)
def _no_env_faults(monkeypatch):
    monkeypatch.delenv("RAFT_TPU_FAULTS", raising=False)
    faults.reload_env()
    yield
    monkeypatch.delenv("RAFT_TPU_FAULTS", raising=False)
    faults.reload_env()
    faults.reset_stats()


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_gives_the_jax_fields(spec):
    got = faults._parse_spec(spec)
    want = jfaults._parse_spec(spec)
    assert (got.kind, got.pattern, got.count, got.value) == (
        want.kind, want.pattern, want.count, want.value)


@pytest.mark.parametrize("spec", ["@x", "", "@a:2"])
def test_parse_spec_refuses_an_empty_kind(spec):
    with pytest.raises(ValueError):
        faults._parse_spec(spec)
    with pytest.raises(ValueError):
        jfaults._parse_spec(spec)


def test_counts_and_patterns():
    with faults.inject("io_error", "core.serialize.*", count=2) as f:
        assert faults.fired("io_error", "core.wal.append") is None
        assert faults.fired("kernel_compile", "core.serialize.x") is None
        assert faults.fired("io_error", "core.serialize.save_arrays") is f
        assert faults.fired("io_error", "core.serialize.array.codes") is f
        assert faults.fired("io_error", "core.serialize.save_arrays") is None
        assert f.fires == 2
        assert "core.serialize.save_arrays" in faults.seen_sites()
        faults.reset_stats()
        assert f.fires == 0 and not faults.seen_sites()
    assert faults.active() == []
    assert faults.fired("io_error", "core.serialize.save_arrays") is None


def test_check_crash_and_the_exception_classes():
    assert issubclass(faults.InjectedFault, RaftError)
    assert not issubclass(faults.InjectedCrash, Exception)
    assert issubclass(faults.InjectedCrash, BaseException)
    with faults.inject("io_error", "a.*"):
        with pytest.raises(faults.InjectedFault) as e:
            faults.check("io_error", "a.b")
        assert (e.value.kind, e.value.site) == ("io_error", "a.b")
        faults.check("io_error", "b.a")
    with faults.inject("crash_point", "m.x", count=1):
        try:
            faults.crash("m.x")
        except Exception:  # noqa: BLE001 - must not catch a crash
            pytest.fail("InjectedCrash was caught as an Exception")
        except faults.InjectedCrash as e:
            assert (e.kind, e.site) == ("crash_point", "m.x")
        faults.crash("m.x")                  # its one firing is spent


def test_reload_env(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FAULTS",
                       "io_error@core.serialize.*:1,slow_dispatch@s=0")
    faults.reload_env()
    kinds = [(f.kind, f.pattern, f.count, f.value) for f in faults.active()]
    assert kinds == [("io_error", "core.serialize.*", 1, None),
                     ("slow_dispatch", "s", None, "0")]
    with pytest.raises(faults.InjectedFault):
        faults.check("io_error", "core.serialize.save_arrays")
    faults.check("io_error", "core.serialize.save_arrays")   # count 1
    faults.sleep_if("s")
    monkeypatch.setenv("RAFT_TPU_FAULTS", "")
    faults.reload_env()
    assert faults.active() == []


@pytest.mark.parametrize("value", [None, 0, 3, 10, 99])
@pytest.mark.parametrize("n", [1, 2, 17])
def test_cut_and_corrupt_equal_jax(value, n):
    data = bytes(np.random.default_rng(n).integers(0, 256, n, np.uint8))
    with faults.inject("wal_torn_tail", "w", value=value), \
            jfaults.inject("wal_torn_tail", "w", value=value):
        assert faults.cut("w", data) == jfaults.cut("w", data)
        if n > 1:
            assert len(faults.cut("w", data)) < n
    with faults.inject("corrupt_bytes", "c", value=value), \
            jfaults.inject("corrupt_bytes", "c", value=value):
        assert faults.corrupt("c", data) == jfaults.corrupt("c", data)
        assert faults.corrupt("c", data) != data
    assert faults.cut("w", data) is data
    assert faults.corrupt("c", data) is data
    assert faults.corrupt("c", b"") == b""
