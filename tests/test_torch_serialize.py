"""The index file format of the PyTorch port (``raft_tpu_torch.core
.serialize``) against the JAX package's (``raft_tpu.core.serialize``):
files written by either read in the other, byte-identical files for the
same kind, version, meta and arrays (a bfloat16 tensor framed as the
uint16 words JAX's families write), and the integrity checks — a
flipped byte in any section, a truncation, a length prefix with its high
bit set, a bad magic — each raising ``CorruptIndexError`` naming the
section; the legacy ``RAFT_TPU`` layout; atomic path saves; a
non-seekable sink.

Tolerances: none. Every comparison is of bytes or of arrays, exactly.
"""
import io
import os
import struct
import tracemalloc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import serialize as jser
from raft_tpu.core.errors import CorruptIndexError as JaxCorruptIndexError
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import CorruptIndexError, RaftError

META = {"metric": "l2_expanded", "n_lists": 7, "metric_arg": 2.0,
        "flag": True, "empty": ""}


def _arrays(seed: int = 0) -> dict:
    """Numpy arrays of the dtypes the index files hold, small."""
    rng = np.random.default_rng(seed)
    return {"data": rng.standard_normal((9, 4)).astype(np.float32),
            "source_ids": np.arange(9, dtype=np.int32),
            "list_offsets": np.array([0, 4, 9], np.int64),
            "codes": rng.integers(0, 256, (9, 3)).astype(np.uint8),
            "scales": rng.random(9).astype(np.float32)}


def _tensors(arrays: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}


def _blob(arrays, meta=META, kind="ivf_flat", version=2, mod=ser) -> bytes:
    buf = io.BytesIO()
    mod.save_arrays(buf, kind, version, meta, arrays)
    return buf.getvalue()


def _load(blob: bytes, **kw):
    return ser.load_arrays(io.BytesIO(blob), **kw)


def _sections(blob: bytes, names) -> dict:
    """Byte spans of the file's sections: "header" (magic through its
    CRC), and per array name its ``frame`` (name frame), ``len``,
    ``payload`` and ``crc`` spans."""
    out = {}
    pos = 8
    (kind_len, _), pos = struct.unpack_from("<HI", blob, pos), pos + 6
    pos += kind_len
    (n_items,), pos = struct.unpack_from("<I", blob, pos), pos + 4
    for _ in range(n_items):
        (klen,) = struct.unpack_from("<H", blob, pos)
        pos += 2 + klen
        tag = blob[pos : pos + 1]
        pos += 1
        if tag == b"s":
            (slen,) = struct.unpack_from("<I", blob, pos)
            pos += 4 + slen
        else:
            pos += {b"b": 1, b"i": 8, b"f": 8}[tag]
    pos += 4 + 4                          # array count, header CRC
    out["header"] = (0, pos)
    for name in sorted(names):
        (nlen,) = struct.unpack_from("<H", blob, pos)
        assert blob[pos + 2 : pos + 2 + nlen].decode() == name
        frame = (pos, pos + 2 + nlen)
        (plen,) = struct.unpack_from("<Q", blob, frame[1])
        ln = (frame[1], frame[1] + 8)
        payload = (ln[1], ln[1] + plen)
        crc = (payload[1], payload[1] + 4)
        out[name] = {"frame": frame, "len": ln, "payload": payload,
                     "crc": crc}
        pos = crc[1]
    assert pos == len(blob)
    return out


def _flip(blob: bytes, at: int) -> bytes:
    b = bytearray(blob)
    b[at] ^= 0x5A
    return bytes(b)


def _equal_arrays(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------- parity with JAX

@pytest.mark.parametrize("as_tensors", [False, True])
def test_same_bytes_as_jax(as_tensors):
    """The same kind, version, meta and arrays give the same file from
    either package: numpy arrays, and tensors made C-contiguous."""
    arrays = _arrays()
    ours = _tensors(arrays) if as_tensors else arrays
    assert _blob(ours) == _blob(arrays, mod=jser)


def test_noncontiguous_tensor_written_c_order():
    """A transposed tensor is written as the C-ordered array JAX writes
    (np.save would otherwise write its Fortran header)."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = torch.from_numpy(a.T.copy()).T          # (3, 4) with F strides
    assert not t.is_contiguous()
    assert _blob({"a": t}) == _blob({"a": np.ascontiguousarray(a)},
                                    mod=jser)


def test_bfloat16_tensor_framed_as_uint16_words():
    """A bfloat16 tensor is written as its uint16 words: the bytes of the
    JAX package's ``ml_dtypes`` array viewed as uint16."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    jwords = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    t = torch.from_numpy(x).to(torch.bfloat16)
    meta = {"store_dtype": "bfloat16"}
    assert (_blob({"dataset": t}, meta) ==
            _blob({"dataset": jwords}, meta, mod=jser))
    _, _, _, got = _load(_blob({"dataset": t}, meta))
    back = ser.device_tensor(got["dataset"], "cpu", bfloat16=True)
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


def test_port_file_loads_in_jax_and_back():
    arrays = _arrays(1)
    blob = _blob(_tensors(arrays), META, "cagra", 1)
    kind, version, meta, got = jser.load_arrays(io.BytesIO(blob), "cagra")
    assert (kind, version, meta) == ("cagra", 1, META)
    _equal_arrays(got, arrays)
    jblob = _blob(arrays, META, "cagra", 1, mod=jser)
    kind, version, meta, got = _load(jblob, expect_kind="cagra")
    assert (kind, version, meta) == ("cagra", 1, META)
    assert all(type(meta[k]) is type(META[k]) for k in META)
    _equal_arrays(got, arrays)


def test_scalar_frames_match_jax():
    buf, jbuf = io.BytesIO(), io.BytesIO()
    for fmt, v in (("<q", -5), ("<I", 7), ("<d", 0.25), ("<?", True)):
        ser.serialize_scalar(buf, v, fmt)
        jser.serialize_scalar(jbuf, v, fmt)
    assert buf.getvalue() == jbuf.getvalue()
    buf.seek(0)
    assert [ser.deserialize_scalar(buf, f) for f in
            ("<q", "<I", "<d", "<?")] == [-5, 7, 0.25, True]
    a = np.arange(5, dtype=np.int64)
    b = io.BytesIO()
    ser.serialize_array(b, torch.from_numpy(a))
    b.seek(0)
    np.testing.assert_array_equal(jser.deserialize_array(b), a)


def test_meta_value_types():
    """Meta keeps Python's bool / int / float / str apart (an int written
    as ``i``, a float as ``f``), as the JAX package's reader reads them;
    anything else is refused."""
    meta = {"a_int": 2, "b_float": 2.0, "c_bool": False, "d_str": "x"}
    _, _, got, _ = jser.load_arrays(io.BytesIO(_blob({}, meta)))
    assert got == meta and [type(v) for v in got.values()] == [
        int, float, bool, str]
    with pytest.raises(TypeError, match="unsupported meta value"):
        _blob({}, {"bad": [1]})


# ------------------------------------------------------------- corruption

def test_every_header_byte_is_checked():
    """A flipped byte anywhere in the header section (magic, kind,
    version, meta, count, CRC) raises CorruptIndexError("header"), never
    a wrong kind or a parse error."""
    arrays = _arrays()
    blob = _blob(arrays)
    lo, hi = _sections(blob, arrays)["header"]
    for at in range(lo, hi):
        with pytest.raises(CorruptIndexError) as e:
            _load(_flip(blob, at), expect_kind="ivf_flat")
        assert e.value.section == "header", at


@pytest.mark.parametrize("part", ["len", "payload", "crc"])
def test_every_array_byte_is_checked(part):
    """A flipped byte in an array section's length prefix, npy frame or
    CRC raises CorruptIndexError naming that array (checked before the
    frame is parsed); in the JAX package's reader too."""
    arrays = _arrays()
    blob = _blob(arrays)
    spans = _sections(blob, arrays)
    for name in arrays:
        lo, hi = spans[name][part]
        for at in range(lo, hi):
            bad = _flip(blob, at)
            with pytest.raises(CorruptIndexError) as e:
                _load(bad)
            assert e.value.section == name, (name, at)
            with pytest.raises(JaxCorruptIndexError) as je:
                jser.load_arrays(io.BytesIO(bad))
            assert je.value.section == name


def test_flipped_name_frame_is_corruption():
    arrays = _arrays()
    blob = _blob(arrays)
    spans = _sections(blob, arrays)
    for name in arrays:
        lo, hi = spans[name]["frame"]
        for at in range(lo, hi):
            with pytest.raises(CorruptIndexError):
                _load(_flip(blob, at))


def test_truncation_anywhere():
    """A file cut at any byte raises CorruptIndexError; at each section
    boundary, naming the section it cut into."""
    arrays = _arrays()
    blob = _blob(arrays)
    spans = _sections(blob, arrays)
    want = {0: "header", spans["header"][1]: "array table"}
    for name in arrays:
        want[spans[name]["frame"][1]] = name
        want[spans[name]["len"][1]] = name
        want[spans[name]["payload"][1]] = name
    for name in sorted(arrays)[1:]:
        want[spans[name]["frame"][0]] = "array table"
    for cut in range(len(blob)):
        with pytest.raises(CorruptIndexError) as e:
            _load(blob[:cut])
        if cut in want:
            assert e.value.section == want[cut], cut


class _Stream:
    """A read-only, non-seekable source."""

    def __init__(self, blob: bytes):
        self._b = io.BytesIO(blob)

    def read(self, n=-1):
        return self._b.read(n)


@pytest.mark.parametrize("seekable", [True, False])
def test_huge_length_prefix_allocates_nothing(tmp_path, seekable):
    """A length prefix with its high bit set raises CorruptIndexError
    naming the array, from a file path and from a non-seekable stream,
    without allocating anything near that size."""
    arrays = _arrays()
    blob = bytearray(_blob(arrays))
    lo, _ = _sections(bytes(blob), arrays)["codes"]["len"]
    blob[lo + 7] |= 0x80
    path = tmp_path / "huge.idx"
    path.write_bytes(bytes(blob))
    tracemalloc.start()
    try:
        with pytest.raises(CorruptIndexError) as e:
            if seekable:
                ser.load_arrays(path)
            else:
                ser.load_arrays(_Stream(bytes(blob)))
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert e.value.section == "codes"
    assert peak < 1 << 20


def test_bad_magic():
    blob = _blob(_arrays())
    with pytest.raises(CorruptIndexError, match="bad magic") as e:
        _load(b"NOTRAFT!" + blob[8:])
    assert e.value.section == "header"
    with pytest.raises(CorruptIndexError):
        _load(b"")


def test_wrong_kind_is_a_value_error():
    """A kind mismatch raises ValueError after the header's CRC passed,
    and is not reported as corruption."""
    blob = _blob(_arrays(), kind="ivf_pq")
    with pytest.raises(ValueError, match="expected index kind") as e:
        _load(blob, expect_kind="ivf_flat")
    assert not isinstance(e.value, CorruptIndexError)
    assert isinstance(CorruptIndexError("x"), (RaftError, ValueError))


def test_legacy_layout_written_by_jax():
    """A ``RAFT_TPU`` file (no checksums) from the JAX package's
    ``serialize_header`` and array frames loads, kind checked."""
    arrays = _arrays(2)
    buf = io.BytesIO()
    jser.serialize_header(buf, "brute_force", 1, META)
    buf.write(struct.pack("<I", len(arrays)))
    for name, a in sorted(arrays.items()):
        nb = name.encode()
        buf.write(struct.pack("<H", len(nb)) + nb)
        jser.serialize_array(buf, a)
    kind, version, meta, got = _load(buf.getvalue(),
                                     expect_kind="brute_force")
    assert (kind, version, meta) == ("brute_force", 1, META)
    _equal_arrays(got, arrays)
    with pytest.raises(ValueError, match="expected index kind"):
        _load(buf.getvalue(), expect_kind="cagra")


# ------------------------------------------------------------ path saves

class _Unconvertible:
    """An array whose conversion to numpy raises ``exc``."""

    def __init__(self, exc):
        self.exc = exc

    def __array__(self, *args, **kwargs):
        raise self.exc


@pytest.mark.parametrize("exc", [ValueError("no"), KeyboardInterrupt()])
def test_failed_save_keeps_old_file(tmp_path, exc):
    """A save that fails mid-write (its last array's conversion raises)
    leaves the previous file intact and no temp file behind."""
    path = tmp_path / "index.bin"
    ser.save_arrays(path, "ivf_flat", 2, META, _arrays())
    before = path.read_bytes()
    bad = dict(_arrays(5), zz=_Unconvertible(exc))
    with pytest.raises(type(exc)):
        ser.save_arrays(path, "ivf_flat", 2, META, bad)
    assert path.read_bytes() == before
    assert os.listdir(tmp_path) == ["index.bin"]


def test_path_save_equals_stream_save(tmp_path):
    arrays = _arrays()
    ser.save_arrays(tmp_path / "a", "ivf_flat", 2, META, arrays)
    ser.save_arrays(str(tmp_path / "b"), "ivf_flat", 2, META, arrays)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes() \
        == _blob(arrays)
    _equal_arrays(ser.load_arrays(tmp_path / "a")[3], arrays)


class _Sink:
    """A write-only, non-seekable sink."""

    def __init__(self):
        self.parts = []

    def write(self, b):
        self.parts.append(bytes(b))

    def seekable(self):
        return False


def test_non_seekable_sink_same_bytes():
    arrays = _tensors(_arrays())
    sink = _Sink()
    ser.save_arrays(sink, "ivf_flat", 2, META, arrays)
    assert b"".join(sink.parts) == _blob(arrays)
