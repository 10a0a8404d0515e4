"""Index files in NumPy ``.npy`` framing: counterpart of
``raft_tpu/core/serialize.py`` (``serialize_scalar``,
``deserialize_scalar``, ``serialize_array``, ``deserialize_array``,
``serialize_header``, ``deserialize_header``, ``save_arrays``,
``load_arrays``, ``fsync_dir``).

The wire format is the JAX package's, byte for byte, so that either
package reads the other's files:

* ``RAFTTPU2`` files: the magic, a header section (the index kind, its
  serialization version, a metadata dict sorted by key with the tags
  ``b``, ``i``, ``f`` and ``s``, and the array count) closed by its
  CRC32, then one section an array in name order: the name frame, the
  length-prefixed ``.npy`` frame and a CRC32 over the name and the
  payload with the length folded in last. A mismatch, a truncation or a
  length past the end of the file raises :class:`CorruptIndexError`
  naming the section.
* ``RAFT_TPU`` files (the legacy layout, without checksums) are read;
  :func:`serialize_header` / :func:`deserialize_header` write and read
  that layout's header (its magic, then the same kind, version and
  metadata, no CRC) for callers that frame their own arrays after it.

Path saves are atomic: a temp file in the target directory, fsynced,
``os.replace``-d into place, and the directory fsynced
(:func:`fsync_dir`); the temp file is unlinked on any failure.

Arrays are written from a tensor on any device or a numpy array; a
bfloat16 tensor is framed as its uint16 words (numpy has no bfloat16),
and tensors are written C-contiguous. The writer carries the JAX package's
fault probes (``core/faults.py``): ``io_error`` at
``core.serialize.save_arrays`` after the header, and ``corrupt_bytes`` at
``core.serialize.array.<name>`` on the bytes an array section writes
(its CRC covers the true bytes, so the reader catches the flip). A
corrupt load records a ``corrupt_index`` event (its site the failing
section) and counts ``serialize.corrupt_load``, as the JAX package's
reader does.
"""
from __future__ import annotations

import io
import os
import struct
import uuid
import zlib
from typing import Any, BinaryIO, Dict, List, Tuple

import numpy as np
import torch

from . import faults
from .errors import CorruptIndexError

__all__ = ["serialize_scalar", "deserialize_scalar", "serialize_array",
           "deserialize_array", "serialize_header", "deserialize_header",
           "host_array", "device_tensor", "save_arrays", "load_arrays",
           "fsync_dir"]

_MAGIC = b"RAFT_TPU"      # legacy layout, no checksums
_MAGIC_CRC = b"RAFTTPU2"  # the checksummed layout
_CHUNK = 64 << 20         # bytes a read of an untrusted length


def fsync_dir(path) -> None:
    """fsync the directory holding ``path`` (or ``path`` itself when it is
    a directory), so that a rename or a create survives a crash; a
    directory handle that rejects fsync is let be."""
    d = os.fspath(path)
    if not os.path.isdir(d):
        d = os.path.dirname(d) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def host_array(arr) -> np.ndarray:
    """A tensor (any device) or array as the numpy array that is framed: a
    tensor detached, on the host and C-contiguous, bfloat16 as its uint16
    words; a numpy array as it is."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().contiguous().numpy().view(
                np.uint16)
        return t.cpu().contiguous().numpy()
    return np.asarray(arr)


def device_tensor(a: np.ndarray, device, bfloat16: bool = False
                  ) -> torch.Tensor:
    """A loaded array as a C-contiguous tensor on ``device`` (no host copy
    of a C-ordered array; a Fortran-ordered frame is reordered, since
    the kernels read rows); ``bfloat16``: its 16-bit words viewed as
    bfloat16."""
    a = np.ascontiguousarray(a)
    if bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def serialize_scalar(f: BinaryIO, value, fmt: str) -> None:
    """Write one struct-packed scalar (``fmt`` e.g. ``'<q'``)."""
    f.write(struct.pack(fmt, value))


def deserialize_scalar(f: BinaryIO, fmt: str):
    (v,) = struct.unpack(fmt, f.read(struct.calcsize(fmt)))
    return v


def serialize_array(f: BinaryIO, arr) -> None:
    """Write an array as one ``.npy`` frame (:func:`host_array`)."""
    np.save(f, host_array(arr), allow_pickle=False)


def deserialize_array(f: BinaryIO) -> np.ndarray:
    return np.load(f, allow_pickle=False)


class _CrcIO:
    """Pass-through reader or writer accumulating a CRC32 of the current
    section; ``n`` counts the bytes written. ``site``: a writer's
    ``corrupt_bytes`` probe, applied to the bytes written after the CRC
    has taken them."""

    def __init__(self, f: BinaryIO, crc: int = 0, site: str = ""):
        self._f = f
        self.crc = crc
        self.n = 0
        self._site = site

    def write(self, b) -> None:
        self.crc = zlib.crc32(b, self.crc)
        self.n += len(b)
        self._f.write(faults.corrupt(self._site, b) if self._site else b)

    def read(self, n: int = -1) -> bytes:
        b = self._f.read(n)
        self.crc = zlib.crc32(b, self.crc)
        return b

    def take(self) -> int:
        """Finish the current section: its CRC, reset to 0."""
        c, self.crc = self.crc, 0
        return c


def _seekable(f) -> bool:
    return hasattr(f, "seekable") and f.seekable()


def _write_array_section(f: BinaryIO, name: str, arr) -> None:
    """Name frame, length-prefixed npy frame, CRC32 over both with the
    length folded in last. A seekable sink gets a placeholder length,
    patched once the frame has streamed; a non-seekable one gets the
    frame buffered."""
    nb = name.encode()
    name_frame = struct.pack("<H", len(nb)) + nb
    f.write(name_frame)
    crc = zlib.crc32(name_frame)
    site = f"core.serialize.array.{name}"
    if _seekable(f):
        len_pos = f.tell()
        f.write(struct.pack("<Q", 0))
        tee = _CrcIO(f, crc, site)
        serialize_array(tee, arr)
        plen, crc = tee.n, tee.crc
        end = f.tell()
        f.seek(len_pos)
        f.write(struct.pack("<Q", plen))
        f.seek(end)
    else:
        buf = io.BytesIO()
        serialize_array(buf, arr)
        payload = buf.getbuffer()
        plen = len(payload)
        f.write(struct.pack("<Q", plen))
        crc = zlib.crc32(payload, crc)
        f.write(faults.corrupt(site, payload))
    crc = zlib.crc32(struct.pack("<Q", plen), crc)
    f.write(struct.pack("<I", crc))


def _read_exact(f, n: int, section: str) -> bytes:
    """Exactly ``n`` bytes, or CorruptIndexError (truncation); read in
    bounded chunks, since ``n`` may come from a corrupt length."""
    if n < 0:
        raise CorruptIndexError(section, f"negative length {n}")
    chunks = []
    remaining = n
    while remaining > 0:
        b = f.read(min(remaining, _CHUNK))
        if not b:
            raise CorruptIndexError(
                section, f"truncated: wanted {n} bytes, got {n - remaining}")
        chunks.append(b)
        remaining -= len(b)
    return chunks[0] if len(chunks) == 1 else b"".join(chunks)


def _read_payload(f, n: int, section: str):
    """An array payload of ``n`` bytes. On a seekable source ``n`` is
    checked against the bytes left before anything is allocated, then one
    buffer is filled; otherwise the bounded chunked read."""
    if n < 0:
        raise CorruptIndexError(section, f"negative length {n}")
    if not _seekable(f):
        return _read_exact(f, n, section)
    pos = f.tell()
    end = f.seek(0, 2)
    f.seek(pos)
    if n > end - pos:
        raise CorruptIndexError(
            section, f"length {n} exceeds the {end - pos} bytes remaining")
    buf = bytearray(n)
    mv = memoryview(buf)
    got = 0
    while got < n:
        if hasattr(f, "readinto"):
            r = f.readinto(mv[got:])
        else:
            b = f.read(n - got)
            r = len(b)
            mv[got : got + r] = b
        if not r:
            raise CorruptIndexError(
                section, f"truncated: wanted {n} bytes, got {got}")
        got += r
    return buf


def _serialize_header_body(f: BinaryIO, kind: str, version: int,
                           meta: Dict[str, Any]) -> None:
    kind_b = kind.encode()
    f.write(struct.pack("<HI", len(kind_b), version))
    f.write(kind_b)
    items: List[Tuple[str, Any]] = sorted(meta.items())
    f.write(struct.pack("<I", len(items)))
    for k, v in items:
        kb = k.encode()
        if isinstance(v, bool):
            tag, payload = b"b", struct.pack("<?", v)
        elif isinstance(v, int):
            tag, payload = b"i", struct.pack("<q", v)
        elif isinstance(v, float):
            tag, payload = b"f", struct.pack("<d", v)
        elif isinstance(v, str):
            vb = v.encode()
            tag, payload = b"s", struct.pack("<I", len(vb)) + vb
        else:
            raise TypeError(f"unsupported meta value for {k!r}: {type(v)}")
        f.write(struct.pack("<H", len(kb)) + kb + tag + payload)


def serialize_header(f: BinaryIO, kind: str, version: int,
                     meta: Dict[str, Any]) -> None:
    """The legacy layout's versioned header: the ``RAFT_TPU`` magic, the
    index kind, its serialization version and a metadata dict of plain
    bools, ints, floats and strings, sorted by key."""
    f.write(_MAGIC)
    _serialize_header_body(f, kind, version, meta)


def deserialize_header(f: BinaryIO, expect_kind: str | None = None):
    """Read a :func:`serialize_header` header → (kind, version, meta).
    A wrong magic raises :class:`CorruptIndexError`; a kind other than
    ``expect_kind`` (when given) raises ``ValueError``."""
    magic = _read_exact(f, len(_MAGIC), "header")
    if magic != _MAGIC:
        raise CorruptIndexError(
            "header", "not a raft_tpu serialized file (bad magic)")
    kind, version, meta = _deserialize_header_body(f)
    if expect_kind is not None and kind != expect_kind:
        raise ValueError(f"expected index kind {expect_kind!r}, found "
                         f"{kind!r}")
    return kind, version, meta


def _deserialize_header_body(f: BinaryIO):
    kind_len, version = struct.unpack("<HI", _read_exact(f, 6, "header"))
    kind = _read_exact(f, kind_len, "header").decode()
    (n_items,) = struct.unpack("<I", _read_exact(f, 4, "header"))
    meta: Dict[str, Any] = {}
    for _ in range(n_items):
        (klen,) = struct.unpack("<H", _read_exact(f, 2, "header"))
        k = _read_exact(f, klen, "header").decode()
        tag = _read_exact(f, 1, "header")
        if tag == b"b":
            (v,) = struct.unpack("<?", _read_exact(f, 1, "header"))
        elif tag == b"i":
            (v,) = struct.unpack("<q", _read_exact(f, 8, "header"))
        elif tag == b"f":
            (v,) = struct.unpack("<d", _read_exact(f, 8, "header"))
        elif tag == b"s":
            (slen,) = struct.unpack("<I", _read_exact(f, 4, "header"))
            v = _read_exact(f, slen, "header").decode()
        else:
            raise CorruptIndexError("header", f"bad meta tag {tag!r}")
        meta[k] = v
    return kind, version, meta


def save_arrays(path_or_file, kind: str, version: int, meta: Dict[str, Any],
                arrays: Dict[str, Any]) -> None:
    """Write a ``RAFTTPU2`` file: the header and ``arrays`` (tensors or
    numpy arrays) in name order, each section checksummed. A path save is
    atomic (module docstring); a file object is written as it is."""

    def _write(f: BinaryIO):
        w = _CrcIO(f)
        w.write(_MAGIC_CRC)
        _serialize_header_body(w, kind, version, meta)
        items = sorted(arrays.items())
        w.write(struct.pack("<I", len(items)))
        f.write(struct.pack("<I", w.take()))
        faults.check("io_error", "core.serialize.save_arrays")
        for name, arr in items:
            _write_array_section(f, name, arr)

    if not isinstance(path_or_file, (str, bytes, os.PathLike)):
        _write(path_or_file)
        return
    path = os.fspath(path_or_file)
    # the uuid keeps two saves of one path apart
    suffix = f".tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    tmp = path + (suffix.encode() if isinstance(path, bytes) else suffix)
    try:
        with open(tmp, "wb") as f:
            _write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _read_arrays(f: BinaryIO, r: _CrcIO, n: int) -> Dict[str, np.ndarray]:
    """The checksummed array sections."""
    arrays: Dict[str, np.ndarray] = {}
    for _ in range(n):
        (nlen,) = struct.unpack("<H", _read_exact(r, 2, "array table"))
        try:
            name = _read_exact(r, nlen, "array table").decode()
        except UnicodeDecodeError as e:
            raise CorruptIndexError("array table",
                                    f"undecodable name: {e}") from e
        # the length folds into the CRC last, as the writer folds it
        plen_b = _read_exact(f, 8, name)
        (plen,) = struct.unpack("<Q", plen_b)
        payload = _read_payload(f, plen, name)
        r.crc = zlib.crc32(payload, r.crc)
        r.crc = zlib.crc32(plen_b, r.crc)
        got = r.take()
        (want,) = struct.unpack("<I", _read_exact(f, 4, name))
        if got != want:
            raise CorruptIndexError(
                name, f"CRC mismatch ({got:#010x} != {want:#010x})")
        bio = io.BytesIO(payload)
        del payload   # BytesIO holds its own copy
        try:
            arrays[name] = np.load(bio, allow_pickle=False)
        except ValueError as e:
            raise CorruptIndexError(name, f"bad npy frame: {e}") from e
    return arrays


def _read_legacy_arrays(f: BinaryIO) -> Dict[str, np.ndarray]:
    """The legacy layout's array table: a count, then name + npy frame."""
    arrays: Dict[str, np.ndarray] = {}
    (n,) = struct.unpack("<I", _read_exact(f, 4, "array table"))
    for _ in range(n):
        (nlen,) = struct.unpack("<H", _read_exact(f, 2, "array table"))
        try:
            name = _read_exact(f, nlen, "array table").decode()
        except UnicodeDecodeError as e:
            raise CorruptIndexError("array table",
                                    f"undecodable name: {e}") from e
        arrays[name] = deserialize_array(f)
    return arrays


def load_arrays(path_or_file, expect_kind: str | None = None):
    """Inverse of :func:`save_arrays` → (kind, version, meta, {name:
    ndarray}). Every section's CRC is checked (CorruptIndexError names
    the one that failed); ``expect_kind`` is checked after the header's
    CRC has passed (ValueError), so that corruption is never reported as
    a wrong kind. Legacy files are read without checks."""

    def _read(f: BinaryIO):
        r = _CrcIO(f)
        # the magic tells the layouts apart, never a flag inside the file
        magic = _read_exact(r, len(_MAGIC), "header")
        if magic not in (_MAGIC, _MAGIC_CRC):
            raise CorruptIndexError(
                "header", "not a raft_tpu serialized file (bad magic)")
        try:
            kind, version, meta = _deserialize_header_body(r)
        except (struct.error, UnicodeDecodeError, OverflowError,
                MemoryError) as e:
            raise CorruptIndexError("header", f"unparseable: {e}") from e
        if magic == _MAGIC_CRC:
            (n,) = struct.unpack("<I", _read_exact(r, 4, "header"))
            got = r.take()
            (want,) = struct.unpack("<I", _read_exact(f, 4, "header"))
            if got != want:
                raise CorruptIndexError(
                    "header", f"CRC mismatch ({got:#010x} != {want:#010x})")
        if expect_kind is not None and kind != expect_kind:
            raise ValueError(
                f"expected index kind {expect_kind!r}, found {kind!r}")
        arrays = (_read_arrays(f, r, n) if magic == _MAGIC_CRC
                  else _read_legacy_arrays(f))
        return kind, version, meta, arrays

    try:
        if isinstance(path_or_file, (str, bytes, os.PathLike)):
            with open(path_or_file, "rb") as f:
                return _read(f)
        return _read(path_or_file)
    except CorruptIndexError as e:
        # a corrupt load is an operational event, not only an exception:
        # the ops surface shows it even where the caller contains it
        try:
            from . import events

            events.record("corrupt_index", e.section, error=str(e))
            from ..serve import metrics

            metrics.counter("serialize.corrupt_load").inc()
        except Exception:  # noqa: BLE001 - telemetry must not mask it
            pass
        raise
