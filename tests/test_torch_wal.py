"""The port's write-ahead log (``raft_tpu_torch/core/wal.py``) against the
JAX package's (``raft_tpu/core/wal.py``): for the same records the two
write the same bytes, each replays the other's log, and the recovery
cases of ``tests/test_mutable.py`` hold on the port — a torn tail cut
(and the log appended to after), a bad CRC on the last frame cut,
mid-log corruption and a torn closed log raised, a bad magic raised,
an append after a failed write landing after the last good frame — and
the ``wal_torn_tail`` / ``crash_point`` probes leave the files that
JAX's leave.
"""
import os
import struct

import numpy as np
import pytest

from raft_tpu.core import faults as jfaults
from raft_tpu.core import wal as jwal
from raft_tpu_torch.core import faults, wal
from raft_tpu_torch.core.errors import CorruptIndexError


def _records(seed: int = 0):
    rng = np.random.default_rng(seed)
    return [("upsert", np.array([5, 6, 7]),
             rng.standard_normal((3, 4)).astype(np.float32)),
            ("delete", np.array([6]), None),
            ("upsert", np.arange(100, 164),
             rng.standard_normal((64, 16)).astype(np.float32)),
            ("delete", np.array([], np.int64), None)]


def _write(mod, path, records):
    w = mod.WriteAheadLog.create(str(path))
    for kind, ids, vecs in records:
        w.append(kind, ids, vecs)
    w.close()


def _same(a, b):
    assert len(a) == len(b)
    for (k1, i1, v1), (k2, i2, v2) in zip(a, b):
        assert k1 == k2 and np.array_equal(i1, i2)
        assert (v1 is None) == (v2 is None)
        if v1 is not None:
            assert v1.dtype == v2.dtype and np.array_equal(v1, v2)


@pytest.mark.parametrize("seed", [0, 1])
def test_bytes_equal_jax_and_each_replays_the_other(tmp_path, seed):
    recs = _records(seed)
    _write(wal, tmp_path / "port.log", recs)
    _write(jwal, tmp_path / "jax.log", recs)
    assert (tmp_path / "port.log").read_bytes() == (
        tmp_path / "jax.log").read_bytes()
    for reader in (wal, jwal):
        for f in ("port.log", "jax.log"):
            got, cut = reader.replay(str(tmp_path / f))
            assert cut == 0
            _same(got, recs)


def test_size_bytes_and_reopen(tmp_path):
    p = tmp_path / "w.log"
    w = wal.WriteAheadLog.create(str(p))
    assert w.size_bytes() == 12
    w.append("delete", np.array([1]))
    assert w.size_bytes() == os.path.getsize(p)
    w.close()
    w = wal.WriteAheadLog.open(str(p))
    w.append("delete", np.array([2]))
    w.close()
    assert [int(r[1][0]) for r in wal.replay(str(p))[0]] == [1, 2]


def test_torn_tail_truncates_and_reopens(tmp_path):
    p = str(tmp_path / "w.log")
    _write(wal, p, [("delete", np.array([1]), None)])
    good = os.path.getsize(p)
    with open(p, "ab") as f:
        f.write(struct.pack("<I", 1000) + b"partial")
    jrec, jcut = jwal.replay(p, repair=False)
    records, truncated = wal.replay(p, repair=True)
    assert len(records) == 1 and truncated == jcut > 0
    assert os.path.getsize(p) == good
    w = wal.WriteAheadLog.open(p)
    w.append("delete", np.array([2]))
    w.close()
    records, truncated = wal.replay(p)
    assert [r[0] for r in records] == ["delete", "delete"] and truncated == 0


def test_bad_crc_on_last_frame_truncates(tmp_path):
    p = str(tmp_path / "w.log")
    _write(wal, p, [("delete", np.array([1]), None),
                    ("delete", np.array([2]), None)])
    with open(p, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 1]))
    records, truncated = wal.replay(p, repair=False)
    assert len(records) == 1 and truncated > 0
    assert truncated == jwal.replay(p)[1]


def test_midlog_corruption_raises(tmp_path):
    p = str(tmp_path / "w.log")
    _write(wal, p, [("delete", np.array([1]), None),
                    ("delete", np.array([2]), None)])
    off = len(b"RAFTWAL1") + 4 + 4 + 2
    with open(p, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(CorruptIndexError, match="mid-log"):
        wal.replay(p)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 2)
    with pytest.raises(CorruptIndexError):
        wal.replay(p, allow_torn_tail=False)


@pytest.mark.parametrize("blob", [b"GARBAGE!", b"RAFTWAL", b""])
def test_bad_magic(tmp_path, blob):
    p = tmp_path / "not.log"
    p.write_bytes(blob)
    with pytest.raises(CorruptIndexError):
        wal.replay(str(p))
    with pytest.raises(CorruptIndexError):
        wal.WriteAheadLog.open(str(p))


def test_append_after_failed_write_truncates_garbage(tmp_path):
    p = str(tmp_path / "w.log")
    w = wal.WriteAheadLog.create(p)
    w.append("delete", np.array([1]))
    w._f.write(struct.pack("<I", 999) + b"torn")
    w._f.flush()
    w.append("delete", np.array([2]))
    w.close()
    records, truncated = wal.replay(p)
    assert [int(r[1][0]) for r in records] == [1, 2] and truncated == 0


def test_seal_cuts_a_failed_append(tmp_path):
    p = str(tmp_path / "w.log")
    w = wal.WriteAheadLog.create(p)
    w.append("delete", np.array([1]))
    w._f.write(b"torn bytes")
    w._f.flush()
    w.seal()
    w.close()
    records, _ = wal.replay(p, allow_torn_tail=False)
    assert len(records) == 1


@pytest.mark.parametrize("value", [None, 1, 9, 40])
def test_torn_tail_probe_leaves_jax_file(tmp_path, value):
    """``wal_torn_tail`` at the append site writes the same prefix in both
    packages and dies; each package cuts the same tail."""
    recs = _records(2)[:2]
    for mod, fmod, name in ((wal, faults, "port.log"),
                            (jwal, jfaults, "jax.log")):
        w = mod.WriteAheadLog.create(str(tmp_path / name))
        w.append(*recs[0][:2], recs[0][2])
        with pytest.raises(fmod.InjectedCrash):
            with fmod.inject("wal_torn_tail", mod.APPEND_SITE, count=1,
                             value=value):
                w.append(recs[1][0], recs[1][1])
        w.close()
    assert (tmp_path / "port.log").read_bytes() == (
        tmp_path / "jax.log").read_bytes()
    got, cut = wal.replay(str(tmp_path / "jax.log"), repair=True)
    _same(got, recs[:1])
    assert cut > 0 and cut == jwal.replay(str(tmp_path / "port.log"))[1]


def test_crash_point_between_write_and_fsync(tmp_path):
    """A death between the write and the fsync leaves the un-acked frame
    whole on disk here; the next append after reopening keeps it."""
    p = str(tmp_path / "w.log")
    w = wal.WriteAheadLog.create(p)
    w.append("delete", np.array([1]))
    with pytest.raises(faults.InjectedCrash):
        with faults.inject("crash_point", wal.APPEND_SITE, count=1):
            w.append("delete", np.array([2]))
    w.close()
    assert [int(r[1][0]) for r in wal.replay(p)[0]] == [1, 2]
