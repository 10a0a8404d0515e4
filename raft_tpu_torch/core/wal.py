"""CRC32-framed write-ahead log of a mutable index: counterpart of
``raft_tpu/core/wal.py`` (``WriteAheadLog``, ``replay``,
``APPEND_SITE``), byte for byte, so that either package replays the
other's log.

Every mutation of :mod:`raft_tpu_torch.neighbors.mutable` is appended
here, framed, checksummed and fsynced, before the caller is acked, so an
acked write survives a crash. Wire format::

    RAFTWAL1 <u32 version>                      -- file header
    [ <u32 payload_len> <payload> <u32 crc> ]*  -- frames, appended

``crc`` is the CRC32 of the length prefix and the payload, so a frame
whose length itself was torn fails its check. A payload is a record: one
byte of kind (``U`` upsert, ``D`` delete), then ``.npy`` frames of the
int64 ids and, for an upsert, the float32 vectors (no pickle).

:func:`replay`: a frame that runs past the end of the file, or whose
CRC fails on the last frame, is a torn tail — the append a crash cut,
never acked — and is dropped (cut from the file with ``repair=True``); a
CRC failure with whole frames after it damages acked data and raises
:class:`~raft_tpu_torch.core.errors.CorruptIndexError`.

Probes (``core/faults.py``) at :data:`APPEND_SITE`: ``wal_torn_tail``
writes a prefix of the frame and dies, ``crash_point`` dies between the
write and the fsync; both raise ``InjectedCrash``.
"""
from __future__ import annotations

import io
import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from . import faults
from .errors import CorruptIndexError
from .serialize import fsync_dir

__all__ = ["WriteAheadLog", "replay", "APPEND_SITE"]

_MAGIC = b"RAFTWAL1"
_VERSION = 1
_HEADER_LEN = len(_MAGIC) + 4

# the crash and torn-write site of an append
APPEND_SITE = "core.wal.append"

_KINDS = (b"U", b"D")


def _encode_record(kind: str, ids, vectors=None) -> bytes:
    tag = {"upsert": b"U", "delete": b"D"}[kind]
    buf = io.BytesIO()
    buf.write(tag)
    np.save(buf, np.ascontiguousarray(ids, dtype=np.int64),
            allow_pickle=False)
    if tag == b"U":
        np.save(buf, np.ascontiguousarray(vectors, dtype=np.float32),
                allow_pickle=False)
    return buf.getvalue()


def _decode_record(payload: bytes, frame: str):
    tag = payload[:1]
    if tag not in _KINDS:
        raise CorruptIndexError(frame, f"unknown record kind {tag!r}")
    buf = io.BytesIO(payload[1:])
    try:
        ids = np.load(buf, allow_pickle=False)
        vectors = np.load(buf, allow_pickle=False) if tag == b"U" else None
    except (ValueError, OSError, EOFError) as e:
        raise CorruptIndexError(frame, f"bad record arrays: {e}") from e
    return ("upsert" if tag == b"U" else "delete"), ids, vectors


class WriteAheadLog:
    """An append-only mutation log with one writer (the owning mutable
    index appends under its lock); readers use :func:`replay`."""

    def __init__(self, path: str, _f):
        self.path = path
        self._f = _f
        # the end of the last acked frame: a failed write leaves bytes
        # past it, which the next append cuts first
        self._good_end = _f.tell()

    @classmethod
    def create(cls, path: str) -> "WriteAheadLog":
        """A new log: the header written and fsynced, then its directory
        fsynced, so that the file exists after a crash before a manifest
        names it."""
        with open(path, "wb") as f:
            f.write(_MAGIC + struct.pack("<I", _VERSION))
            f.flush()
            os.fsync(f.fileno())
        fsync_dir(path)
        return cls.open(path)

    @classmethod
    def open(cls, path: str) -> "WriteAheadLog":
        """An existing log opened for appending (its magic checked)."""
        f = open(path, "r+b")
        try:
            head = f.read(_HEADER_LEN)
            if head[: len(_MAGIC)] != _MAGIC:
                raise CorruptIndexError("wal header",
                                        "not a raft_tpu WAL (bad magic)")
            f.seek(0, os.SEEK_END)
        except BaseException:
            f.close()
            raise
        return cls(path, f)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def seal(self) -> None:
        """Cut the bytes a failed append left past the last acked frame,
        and fsync: a log rotated out of the active slot is replayed with
        ``allow_torn_tail=False``, so it must hold whole frames only."""
        f = self._f
        if f.tell() != self._good_end:
            f.truncate(self._good_end)
            f.seek(self._good_end)
            f.flush()
            os.fsync(f.fileno())

    def size_bytes(self) -> int:
        return self._f.tell()

    def append(self, kind: str, ids, vectors=None) -> None:
        """Append one record (``"upsert"`` with ``vectors``, or
        ``"delete"``) and return once it is on disk (write, flush,
        fsync): the caller acks after this returns. A failed append's
        bytes are cut before the next frame is written, so that an acked
        retry never lands after garbage."""
        payload = _encode_record(kind, ids, vectors)
        hdr = struct.pack("<I", len(payload))
        frame = hdr + payload + struct.pack(
            "<I", zlib.crc32(payload, zlib.crc32(hdr)))
        f = self._f
        if f.tell() != self._good_end:
            f.truncate(self._good_end)
            f.seek(self._good_end)
        torn = faults.cut(APPEND_SITE, frame)
        if len(torn) != len(frame):
            # a power cut mid-write: the prefix reaches the disk, then
            # the process dies
            f.write(torn)
            f.flush()
            os.fsync(f.fileno())
            raise faults.InjectedCrash("wal_torn_tail", APPEND_SITE)
        f.write(frame)
        f.flush()
        # death between the write and the fsync: the un-acked frame may
        # survive or not, and recovery takes either
        faults.crash(APPEND_SITE)
        os.fsync(f.fileno())
        self._good_end = f.tell()


def replay(path: str, repair: bool = False,
           allow_torn_tail: bool = True) -> Tuple[list, int]:
    """Every good frame of the log at ``path`` → (records, bytes cut).

    ``records``: ``(kind, ids, vectors)`` tuples in append order
    (``vectors`` None for a delete). A torn tail ends the replay; with
    ``repair=True`` the file is cut at the last good frame (fsynced).
    ``allow_torn_tail=False`` (a log that was rotated closed, which no
    append was writing) makes any bad frame mid-log corruption, which
    raises :class:`CorruptIndexError`, as a bad CRC before a whole frame
    does."""
    records: list = []
    with open(path, "rb") as f:
        head = f.read(_HEADER_LEN)
        if len(head) < _HEADER_LEN or head[: len(_MAGIC)] != _MAGIC:
            raise CorruptIndexError("wal header",
                                    f"{path}: not a raft_tpu WAL")
        end = f.seek(0, os.SEEK_END)
        pos = _HEADER_LEN
        f.seek(pos)
        good_end = pos
        torn: Optional[str] = None
        n_frame = 0
        while pos < end:
            n_frame += 1
            frame_name = f"wal frame {n_frame}"
            hdr = f.read(4)
            if len(hdr) < 4:
                torn = f"{frame_name}: truncated length prefix"
                break
            (plen,) = struct.unpack("<I", hdr)
            if pos + 4 + plen + 4 > end:
                torn = (f"{frame_name}: frame wants {plen} payload bytes, "
                        f"{end - pos - 8} remain")
                break
            payload = f.read(plen)
            (want,) = struct.unpack("<I", f.read(4))
            got = zlib.crc32(payload, zlib.crc32(hdr))
            pos = pos + 4 + plen + 4
            if got != want:
                if pos >= end:
                    torn = (f"{frame_name}: CRC mismatch "
                            f"({got:#010x} != {want:#010x}) at tail")
                    break
                raise CorruptIndexError(
                    frame_name,
                    f"{path}: CRC mismatch ({got:#010x} != {want:#010x}) "
                    "mid-log — acked data is damaged")
            records.append(_decode_record(payload, frame_name))
            good_end = pos
    truncated = 0
    if torn is not None:
        if not allow_torn_tail:
            raise CorruptIndexError(
                "wal tail", f"{path}: torn frame in a closed log ({torn})")
        truncated = end - good_end
        if repair:
            with open(path, "r+b") as f:
                f.truncate(good_end)
                f.flush()
                os.fsync(f.fileno())
    return records, truncated
