"""Persistent key-value store behind the header chain and the UTXO set.

The reference persists headers in RocksDB (C++) through a typed query layer
(reference: package.yaml:32-33, used at src/Haskoin/Node/Chain.hs:73-84,
233-263, 454-491) with optional column families, atomic ``writeBatch`` and
prefix iterators (used by the version-purge at Chain.hs:472-491).

This module defines the same capability surface as a small protocol —
``get``/``put``/``delete``/``write_batch``/``scan_prefix`` plus column-family
style namespacing — with two Python engines:

* :class:`MemoryKV` — ephemeral dict store for tests.
* :class:`LogKV` — durable segmented append log + in-memory index, replayed
  on open and compacted when garbage accumulates.

``LogKV`` writes **log format v2**, built for crash consistency:

* every record carries a CRC32 and a per-segment sequence number, and every
  segment file opens with a magic/version header — replay distinguishes a
  *torn tail* (the last record of the active segment cut mid-write: truncated
  quietly, today's pre-v2 behavior) from *mid-log corruption* (a complete
  record failing CRC/sequence checks: loud ``store.corruption`` event +
  metric, salvage mode keeps the valid prefix, quarantines the corrupt
  suffix to ``<file>.quarantine`` and **never returns corrupt bytes as
  data**);
* the log is segmented: appends rotate to a fresh segment at
  ``segment_bytes``; compaction writes a full snapshot to ``<path>.compact``,
  fsyncs the file *and the parent directory*, then ``os.replace``\\ s it over
  the base path and deletes the subsumed segments — every crash window
  between those steps replays to the same state (records are last-writer-wins
  idempotent), and stale ``.compact`` temps are cleaned on open;
* :meth:`LogKV.write_batch_async` routes the physical append + ``fsync``
  through a group-commit writer thread: the caller's future resolves only
  once the batch is on disk (acked ⇒ durable), the event loop never blocks
  on ``os.fsync``, and batches queued while one fsync runs coalesce into the
  next (one fsync amortized over the group);
* v1 logs (the pre-v2 single-file format, what the C++ ``NativeKV`` writes
  on fresh paths) replay bit-identically under the v2 reader; new writes go
  to v2 segments and the first compaction rewrites everything as a v2
  snapshot.  The C++ engine reads AND appends the v2 format too — ``auto`` still prefers :class:`LogKV` for v2
  directories (group-commit async writes, quarantining salvage), with the
  native engine an explicit opt-in.

A C++ engine (``native/kvstore``) plugs in behind the same protocol via
:func:`open_store` once built; see native/kvstore/README.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import queue
import struct
import threading
import time
import zlib
from typing import Iterator, Optional, Protocol, Sequence

from . import threadsan
from .chaos import ChaosFault, chaos
from .events import events
from .metrics import metrics

__all__ = [
    "KVStore",
    "BatchOp",
    "put_op",
    "delete_op",
    "MemoryKV",
    "LogKV",
    "Namespaced",
    "StoreCorruption",
    "StoreVersionError",
    "open_store",
    "v2_artifacts",
]

log = logging.getLogger("tpunode_torch.store")

# ('put', key, value) | ('del', key, b'')
BatchOp = tuple[str, bytes, bytes]


def put_op(key: bytes, value: bytes) -> BatchOp:
    return ("put", key, value)


def delete_op(key: bytes) -> BatchOp:
    return ("del", key, b"")


class StoreVersionError(RuntimeError):
    """Engine/format mismatch: e.g. the v1-only native engine asked to open
    a directory holding v2 artifacts (segments or a v2 base file)."""


class StoreCorruption(RuntimeError):
    """Unrecoverable store damage (a base/segment header that cannot be a
    v1 or v2 log at all).  Salvageable damage never raises — it is
    quarantined and reported (``store.corruption``)."""


class KVStore(Protocol):
    def get(self, key: bytes) -> Optional[bytes]: ...

    def put(self, key: bytes, value: bytes) -> None: ...

    def delete(self, key: bytes) -> None: ...

    def write_batch(self, ops: Sequence[BatchOp]) -> None: ...

    def scan_prefix(self, prefix: bytes) -> Iterator[tuple[bytes, bytes]]: ...

    def close(self) -> None: ...


def _validate_ops(ops: Sequence[BatchOp]) -> None:
    """Reject unknown ops BEFORE any mutation: a batch is atomic — a typo'd
    op must not leave the first half applied (pinned by test_store.py)."""
    for op, _, _ in ops:
        if op not in ("put", "del"):
            raise ValueError(f"unknown batch op {op!r}")


class MemoryKV:
    """Ephemeral dict-backed store."""

    def __init__(self) -> None:
        self._data: dict[bytes, bytes] = {}

    def get(self, key: bytes) -> Optional[bytes]:
        return self._data.get(key)

    def put(self, key: bytes, value: bytes) -> None:
        if chaos.on:  # injected write failure (chaos.py)
            chaos.maybe_raise("store.write", "memory")
        self._data[key] = value

    def delete(self, key: bytes) -> None:
        if chaos.on:
            chaos.maybe_raise("store.write", "memory")
        self._data.pop(key, None)

    def write_batch(self, ops: Sequence[BatchOp]) -> None:
        if chaos.on:  # injected write failure (chaos.py)
            chaos.maybe_raise("store.write", "memory")
        _validate_ops(ops)
        for op, k, v in ops:
            if op == "put":
                self._data[k] = v
            else:
                self._data.pop(k, None)

    def scan_prefix(self, prefix: bytes) -> Iterator[tuple[bytes, bytes]]:
        for k in sorted(self._data):
            if k.startswith(prefix):
                yield k, self._data[k]

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# on-disk formats

# v1 record (legacy, still written by native/kvstore): op, klen, vlen
_REC_V1 = struct.Struct("<BII")
# v2 record: crc32, seq, op, klen, vlen — crc covers everything after
# itself (seq..value), so a flipped bit anywhere in the record is caught.
_REC_V2 = struct.Struct("<IIBII")
_REC_V2_BODY = struct.Struct("<IBII")  # seq, op, klen, vlen
_OP_PUT = 1
_OP_DEL = 2

# v2 segment/snapshot file header: magic, version, kind, segment sequence.
_MAGIC = b"TPK2"
_FILE_HDR = struct.Struct("<4sHHQ")
_FMT_VERSION = 2
_KIND_LOG = 0
_KIND_SNAPSHOT = 1

#: Bounded replay read size: reopening a multi-GB log must stream, not
#: slurp (the old one-shot ``f.read()`` doubled resident memory exactly at
#: recovery time).
_REPLAY_CHUNK = 1 << 20

_SEG_SUFFIX = ".seg"


def _seg_path(base: str, seq: int) -> str:
    return f"{base}.{seq:08d}{_SEG_SUFFIX}"


def _list_segments(base: str) -> list[tuple[int, str]]:
    """(seq, path) for every segment of ``base``, ascending."""
    d = os.path.dirname(base) or "."
    prefix = os.path.basename(base) + "."
    out: list[tuple[int, str]] = []
    try:
        names = os.listdir(d)
    except OSError:
        return []
    for name in names:
        if not (name.startswith(prefix) and name.endswith(_SEG_SUFFIX)):
            continue
        mid = name[len(prefix) : -len(_SEG_SUFFIX)]
        if mid.isdigit():
            out.append((int(mid), os.path.join(d, name)))
    out.sort()
    return out


def v2_artifacts(path: str) -> bool:
    """Does ``path`` hold a v2 store (v2 base file and/or segment files)?
    The native engine's version gate (native.py) and
    :func:`open_store`'s engine dispatch both key on this."""
    if _list_segments(path):
        return True
    try:
        with open(path, "rb") as f:
            return f.read(4) == _MAGIC
    except OSError:
        return False


def _fsync_dir(path: str) -> None:
    """Durable directory entry: after create/rename/unlink the parent
    directory must be fsynced or the *name* change can be lost even though
    the file data survived."""
    fd = os.open(path or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _resync_finds_record(buf: bytes, expect_seq: int) -> bool:
    """Does ``buf`` (the unparseable tail region) contain a CRC-valid v2
    record with a plausible forward sequence number at ANY byte offset?
    A real torn write cannot be followed by one (nothing was written
    after the tear), so a hit reclassifies the region as corruption.
    False positives need a 32-bit CRC collision on top of a sane header
    — negligible."""
    horizon = expect_seq + 1_000_000  # seq plausibility window
    # candidate anchor: the op byte (offset 8 within a record header) —
    # buf.find runs at C speed, so only ~2/256 of offsets pay for an
    # unpack + the rare CRC
    for op_byte in (b"\x01", b"\x02"):
        i = buf.find(op_byte, 8)
        while i != -1:
            off = i - 8
            if off + _REC_V2.size <= len(buf):
                crc, seq, _op, klen, vlen = _REC_V2.unpack_from(buf, off)
                if expect_seq <= seq <= horizon:
                    end = off + _REC_V2.size + klen + vlen
                    if end <= len(buf) and (
                        zlib.crc32(buf[off + 4 : end]) == crc
                    ):
                        return True
            i = buf.find(op_byte, i + 1)
    return False


class _BoundedReader:
    """Sequential reader with a rolling bounded buffer (streamed replay)."""

    __slots__ = ("_f", "_buf", "eof")

    def __init__(self, f):
        self._f = f
        self._buf = bytearray()
        self.eof = False

    def ensure(self, n: int) -> bool:
        while len(self._buf) < n and not self.eof:
            chunk = self._f.read(max(_REPLAY_CHUNK, n - len(self._buf)))
            if not chunk:
                self.eof = True
                break
            self._buf += chunk
        return len(self._buf) >= n

    def peek(self, n: int) -> bytes:
        return bytes(self._buf[:n])

    def take(self, n: int) -> bytes:
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def pending(self) -> int:
        return len(self._buf)


class _GroupCommitWriter(threading.Thread):
    """The off-loop durability path: batches enqueued by
    :meth:`LogKV.write_batch_async` are appended + fsynced here, one fsync
    per drained *group*, and each batch's future resolves only after its
    bytes are on disk — acked ⇒ durable, with the event loop never inside
    ``os.fsync``."""

    _STOP = object()

    def __init__(self, store: "LogKV"):
        super().__init__(
            name=f"logkv-commit:{os.path.basename(store.path)}", daemon=True
        )
        self._store = store
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()

    def submit(
        self, ops: Sequence[BatchOp], stage: bool = False
    ) -> "concurrent.futures.Future[None]":
        """``stage=True``: the writer applies the batch to the index right
        after its physical append (the sync-path contract: index never
        ahead of disk) and BEFORE any compaction can snapshot — a
        snapshot missing a just-appended batch would delete its segment
        and lose it.  ``stage=False``: the caller staged already (the
        async path's read-your-writes)."""
        fut: "concurrent.futures.Future[None]" = concurrent.futures.Future()
        self._q.put((list(ops), stage, fut))
        return fut

    def close(self) -> None:
        self._q.put(self._STOP)
        self.join()

    def run(self) -> None:
        stop = False
        while not stop:
            item = self._q.get()
            if item is self._STOP:
                break
            group = [item]
            while True:  # coalesce everything already queued
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is self._STOP:
                    stop = True
                    break
                group.append(nxt)
            flat = [op for ops, _, _ in group for op in ops]
            t0 = time.perf_counter()
            try:
                self._store._append_physical(flat)
                for ops, needs_stage, _ in group:
                    if needs_stage:
                        self._store._stage(ops)
                self._store._maybe_compact()
            # a worker thread sees no CancelledError; every failure is
            # routed to the waiters' futures and poisons the store
            except BaseException as e:  # asyncsan: disable=cancel-swallow
                self._store._poison(e)
                for _, _, fut in group:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            if not metrics.disabled:
                metrics.observe(
                    "store.commit_seconds", time.perf_counter() - t0
                )
                metrics.inc("store.group_commits")
                metrics.observe("store.group_size", float(len(group)))
            for _, _, fut in group:
                if not fut.done():
                    fut.set_result(None)


class LogKV:
    """Durable segmented append log + in-memory index (log format v2).

    Write path: append CRC'd records to the active segment, keep live
    values in a dict.  Open path: replay base snapshot/legacy file then
    segments in order — streaming, torn-tail tolerant, corruption loud
    (module docstring).  Compaction rewrites only live records once dead
    bytes dominate.  This trades memory for simplicity — the header store
    working set (~120 bytes/header) stays comfortably in RAM even for a
    full mainnet chain, matching how the reference leans on RocksDB's
    memtable for its hot path.
    """

    def __init__(
        self,
        path: str,
        fsync: bool = False,
        *,
        segment_bytes: int = 64 << 20,
    ):
        self.path = path
        self.fsync = fsync
        self.segment_bytes = max(int(segment_bytes), _FILE_HDR.size + 1)
        self._data: dict[bytes, bytes] = {}
        self._read_tick = 0
        self._dead_bytes = 0
        self._live_bytes = 0
        # guards file handles, segment bookkeeping and _data mutation —
        # the group-commit thread and the caller thread share all three
        self._lock = threadsan.rlock("store.groupcommit")
        self._writer: Optional[_GroupCommitWriter] = None
        self._failed: Optional[BaseException] = None
        self._compacting = False
        self._segments: list[tuple[int, str]] = []  # sealed (seq, path)
        self._active_seq = 0
        self._active_bytes = 0
        self._rec_seq = 0  # next record seq within the active segment
        self._replayed_rec_seq = 0
        self._file = None  # type: ignore[assignment]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        t0 = time.perf_counter()
        stats = self._open_replay()
        if not metrics.disabled:
            metrics.observe("store.open_seconds", time.perf_counter() - t0)
        events.emit(
            "store.recovery",
            path=self.path,
            segments=stats["segments"],
            records=stats["records"],
            truncated_bytes=stats["truncated"],
            corrupt=stats["corrupt"],
        )

    # -- open / replay -------------------------------------------------------

    def _open_replay(self) -> dict:
        stats = {"segments": 0, "records": 0, "truncated": 0, "corrupt": 0}
        # stale compaction temp: the process died between writing it and
        # the os.replace — its contents are a subset of base+segments, so
        # it is garbage, never data
        tmp = self.path + ".compact"
        if os.path.exists(tmp):
            os.remove(tmp)
            _fsync_dir(os.path.dirname(self.path))
            metrics.inc("store.stale_temps")
            log.info("[LogKV] removed stale compaction temp %s", tmp)
        segments = _list_segments(self.path)
        if os.path.exists(self.path):
            self._replay_file(
                self.path, is_last=not segments, stats=stats
            )
        for i, (seq, seg) in enumerate(segments):
            stats["segments"] += 1
            self._replay_file(
                seg, is_last=(i == len(segments) - 1), stats=stats
            )
        # resume appends on the last segment when it has room AND its file
        # header survived replay — a segment whose torn header was
        # truncated away (size < header) must NOT be appended to: records
        # at offset 0 of a headerless file would be misread as v1 on the
        # next open and silently dropped.  Rotate past it instead (the
        # empty husk replays as nothing and is swept by compaction).
        next_seq = (segments[-1][0] + 1) if segments else 1
        last_size = os.path.getsize(segments[-1][1]) if segments else 0
        if segments and _FILE_HDR.size <= last_size < self.segment_bytes:
            self._active_seq, active_path = segments[-1]
            self._segments = segments[:-1]
            self._file = open(active_path, "ab")
            self._active_bytes = last_size
            # _rec_seq was counted by the replay of that segment
            self._rec_seq = self._replayed_rec_seq
        else:
            self._segments = segments
            self._new_segment(next_seq)
        metrics.set_gauge("store.segments", float(len(self._segments) + 1))
        return stats

    def _replay_file(self, path: str, is_last: bool, stats: dict) -> None:
        """Replay one file (v2 segment/snapshot, or a legacy v1 log)."""
        self._replayed_rec_seq = 0
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(len(_MAGIC))
            if head == _MAGIC:
                f.seek(0)
                self._replay_v2(f, path, size, is_last, stats)
            else:
                f.seek(0)
                self._replay_v1(f, path, size, is_last, stats)

    def _replay_v1(self, f, path: str, size: int, is_last: bool, stats) -> None:
        """Legacy single-file format: bit-identical semantics to the pre-v2
        reader (op/klen/vlen records, anomalies truncate the tail) — pinned
        by test_store.py's v1-compat test.  Streamed in bounded chunks."""
        r = _BoundedReader(f)
        pos = 0
        while True:
            if not r.ensure(_REC_V1.size):
                break
            op, klen, vlen = _REC_V1.unpack_from(r.peek(_REC_V1.size))
            total = _REC_V1.size + klen + vlen
            if op not in (_OP_PUT, _OP_DEL) or not r.ensure(total):
                break  # torn or unreadable tail: v1 cannot tell them apart
            rec = r.take(total)
            key = rec[_REC_V1.size : _REC_V1.size + klen]
            self._apply_replayed(
                op, key, rec[_REC_V1.size + klen :], total
            )
            stats["records"] += 1
            pos += total
        if pos < size:
            if is_last:
                self._truncate_tail(path, pos, size - pos, stats)
            else:
                self._salvage(path, pos, size, "v1 tail mid-log", stats)

    def _replay_v2(self, f, path: str, size: int, is_last: bool, stats) -> None:
        hdr = f.read(_FILE_HDR.size)
        if len(hdr) < _FILE_HDR.size:
            # header itself torn: an empty just-created segment
            if is_last:
                self._truncate_tail(path, 0, size, stats)
            else:
                self._salvage(path, 0, size, "short v2 header", stats)
            return
        magic, version, kind, _seg_seq = _FILE_HDR.unpack(hdr)
        if magic != _MAGIC:
            raise StoreCorruption(f"{path}: bad magic {magic!r}")
        if version > _FMT_VERSION:
            raise StoreVersionError(
                f"{path}: log format v{version} is newer than this reader "
                f"(v{_FMT_VERSION})"
            )
        del kind  # snapshot vs log segment replay identically
        r = _BoundedReader(f)
        pos = _FILE_HDR.size
        expect_seq = 0
        while True:
            if not r.ensure(_REC_V2.size):
                if r.pending():
                    self._tail_or_corrupt(
                        path, pos, size, is_last, stats,
                        r.peek(r.pending()), expect_seq,
                    )
                break
            crc, seq, op, klen, vlen = _REC_V2.unpack_from(
                r.peek(_REC_V2.size)
            )
            total = _REC_V2.size + klen + vlen
            if not r.ensure(total):
                # ensure() read to EOF before failing: the buffer holds
                # the whole unparseable region for the resync scan
                self._tail_or_corrupt(
                    path, pos, size, is_last, stats,
                    r.peek(r.pending()), expect_seq,
                )
                break
            rec = r.take(total)
            body = rec[4:]  # everything the crc covers
            if (
                zlib.crc32(body) != crc
                or seq != expect_seq
                or op not in (_OP_PUT, _OP_DEL)
            ):
                self._salvage(
                    path, pos, size,
                    "crc mismatch" if zlib.crc32(body) != crc
                    else "sequence break" if seq != expect_seq
                    else "bad op", stats,
                )
                break
            key = rec[_REC_V2.size : _REC_V2.size + klen]
            self._apply_replayed(op, key, rec[_REC_V2.size + klen :], total)
            stats["records"] += 1
            pos += total
            expect_seq += 1
        self._replayed_rec_seq = expect_seq

    def _tail_or_corrupt(self, path, pos, size, is_last, stats, remaining,
                         expect_seq) -> None:
        """Bytes that stop parsing mid-record: a torn tail only where a
        tear can physically happen (the end of the LAST file) — anywhere
        else a sealed segment is damaged and that is corruption.  Even in
        the last file, a TRUE tear leaves nothing after the cut, so a
        CRC-valid successor record downstream (the resync scan) proves
        this is mid-log damage — e.g. a flipped length field — and must
        be loud, not a quiet truncate of every acked record after it."""
        if is_last and not _resync_finds_record(remaining, expect_seq):
            self._truncate_tail(path, pos, size - pos, stats)
        else:
            self._salvage(
                path, pos, size,
                "torn record mid-log" if not is_last
                else "unparseable bytes with valid successor records",
                stats,
            )

    def _apply_replayed(self, op: int, key: bytes, value: bytes, total: int):
        self._note_replace(key)
        if op == _OP_PUT:
            self._data[key] = value
            self._live_bytes += total
        else:
            self._data.pop(key, None)
            self._dead_bytes += total

    def _truncate_tail(self, path: str, good: int, lost: int, stats) -> None:
        """Quiet torn-tail recovery (today's pre-v2 behavior): the write
        was never acked, dropping it is correct, no event."""
        with open(path, "r+b") as f:
            f.truncate(good)
        stats["truncated"] += lost
        metrics.inc("store.torn_tails")
        log.debug("[LogKV] truncated %d torn tail bytes of %s", lost, path)

    def _salvage(self, path: str, good: int, size: int, why: str, stats):
        """LOUD mid-log corruption recovery: keep the valid prefix,
        quarantine the rest (never deleted — it is evidence), and report.
        Corrupt bytes are never applied to the index, so they can never
        come back out of ``get``/``scan_prefix`` as data."""
        qpath = path + ".quarantine"
        n = 1
        while os.path.exists(qpath):
            qpath = f"{path}.quarantine.{n}"
            n += 1
        with open(path, "rb") as src, open(qpath, "wb") as dst:
            src.seek(good)
            while True:
                chunk = src.read(_REPLAY_CHUNK)
                if not chunk:
                    break
                dst.write(chunk)
            dst.flush()
            os.fsync(dst.fileno())
        with open(path, "r+b") as f:
            f.truncate(good)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(os.path.dirname(path))
        lost = size - good
        stats["corrupt"] += 1
        metrics.inc("store.corruption")
        metrics.inc("store.quarantined_bytes", lost)
        events.emit(
            "store.corruption",
            path=path, offset=good, bytes=lost, reason=why,
            quarantine=qpath,
        )
        log.error(
            "[LogKV] CORRUPTION in %s at offset %d (%s): %d bytes "
            "quarantined to %s; replay continues with the valid prefix",
            path, good, why, lost, qpath,
        )

    # -- physical write path -------------------------------------------------

    def _new_segment(self, seq: int) -> None:
        """Create + fsync a fresh active segment (rotation and open share
        this; crash windows inside are torture-harness points)."""
        if chaos.on:
            chaos.maybe_crash("store.rotate", f"{self.path}:pre")
        if self._file is not None and not self._file.closed:
            self._file.flush()
            if self.fsync:
                os.fsync(self._file.fileno())
            self._file.close()
            self._segments.append(
                (self._active_seq, _seg_path(self.path, self._active_seq))
            )
        path = _seg_path(self.path, seq)
        self._file = open(path, "ab")
        if self._file.tell() == 0:
            self._file.write(
                _FILE_HDR.pack(_MAGIC, _FMT_VERSION, _KIND_LOG, seq)
            )
            self._file.flush()
            if self.fsync:
                os.fsync(self._file.fileno())
        _fsync_dir(os.path.dirname(self.path))
        self._active_seq = seq
        self._active_bytes = os.path.getsize(path)
        self._rec_seq = 0
        if chaos.on:
            chaos.maybe_crash("store.rotate", f"{self.path}:post")
        metrics.inc("store.rotations")
        metrics.set_gauge("store.segments", float(len(self._segments) + 1))

    def _pack_records(self, ops: Sequence[BatchOp], seq0: int) -> bytes:
        parts = []
        seq = seq0
        for op, k, v in ops:
            opc = _OP_PUT if op == "put" else _OP_DEL
            val = v if op == "put" else b""
            body = _REC_V2_BODY.pack(seq, opc, len(k), len(val)) + k + val
            parts.append(zlib.crc32(body).to_bytes(4, "little") + body)
            seq += 1
        return b"".join(parts)

    def _append_physical(self, ops: Sequence[BatchOp]) -> None:
        """Append ``ops`` to the active segment (rotating first when full)
        and make them as durable as ``self.fsync`` promises.  Raises
        without side effects on an injected ``error``; ``torn_write``/
        ``bit_flip``/``crash`` faults damage the disk exactly the way the
        recovery path must survive."""
        with self._lock:
            if self._active_bytes >= self.segment_bytes:
                self._new_segment(self._next_seg_seq())
            blob = self._pack_records(ops, self._rec_seq)
            exit_after_write = False
            if chaos.on:
                spec = chaos.decide("store.append", self.path)
                if spec is not None:
                    if spec.action == "error":
                        raise ChaosFault(
                            f"chaos[{spec.describe()}] at {self.path}"
                        )
                    if spec.action == "crash":
                        chaos.hard_exit()
                    blob = chaos.mutate_blob(spec, blob)
                    exit_after_write = spec.action == "torn_write"
            try:
                self._file.write(blob)
                self._file.flush()
                if self.fsync:
                    os.fsync(self._file.fileno())
            except ChaosFault:
                raise
            except BaseException as e:  # disk state now ambiguous
                self._poison(e)
                raise
            if exit_after_write:
                chaos.hard_exit()
            self._rec_seq += len(ops)
            self._active_bytes += len(blob)

    def _next_seg_seq(self) -> int:
        used = [s for s, _ in self._segments] + [self._active_seq]
        return max(used) + 1

    def _poison(self, exc: BaseException) -> None:
        if self._failed is None:
            self._failed = exc
            log.error("[LogKV] store %s failed: %r", self.path, exc)

    def _check_failed(self) -> None:
        if self._failed is not None:
            raise RuntimeError(
                f"store {self.path} failed earlier: {self._failed!r}"
            ) from self._failed

    # -- index bookkeeping ---------------------------------------------------

    def _note_replace(self, key: bytes) -> None:
        old = self._data.get(key)
        if old is not None:
            dead = _REC_V2.size + len(key) + len(old)
            self._dead_bytes += dead
            self._live_bytes -= dead

    def _stage(self, ops: Sequence[BatchOp]) -> None:
        """Apply a validated batch to the in-memory index + accounting."""
        with self._lock:
            for op, k, v in ops:
                self._note_replace(k)
                size = _REC_V2.size + len(k) + len(v)
                if op == "put":
                    self._data[k] = v
                    self._live_bytes += size
                else:
                    self._data.pop(k, None)
                    self._dead_bytes += size

    # -- KVStore protocol ----------------------------------------------------

    # Read latency is SAMPLED 1-in-64: a dict hit is ~100ns and taking the
    # registry lock on every read would cost 10x the operation measured
    # (header walks do thousands of gets per batch).
    _READ_SAMPLE_MASK = 63

    def get(self, key: bytes) -> Optional[bytes]:
        if metrics.disabled:
            return self._data.get(key)
        self._read_tick += 1
        if self._read_tick & self._READ_SAMPLE_MASK:
            return self._data.get(key)
        t0 = time.perf_counter()
        out = self._data.get(key)
        metrics.observe("store.read_seconds", time.perf_counter() - t0)
        return out

    def put(self, key: bytes, value: bytes) -> None:
        self.write_batch([put_op(key, value)])

    def delete(self, key: bytes) -> None:
        self.write_batch([delete_op(key)])

    def write_batch(self, ops: Sequence[BatchOp]) -> None:
        """Synchronous atomic batch.  Disk first, index second: an injected
        or real write failure leaves the in-memory index exactly as it was
        (no half-applied ``_data`` observable after a ChaosFault).  Once the group-commit writer is running, sync writes
        serialize through it (and then block the *calling thread* until
        durable)."""
        self._check_failed()
        if chaos.on:  # injected write failure (chaos.py)
            chaos.maybe_raise("store.write", self.path)
        _validate_ops(ops)
        t0 = time.perf_counter()
        if self._writer is not None:
            # disk-then-index here too: the WRITER thread stages this
            # batch right after its physical append (stage=True), so a
            # real I/O failure (which poisons the store) never leaves
            # never-durable values readable.  Caveat: an async batch
            # submitted DURING this wait stages immediately — same-key
            # races across the two APIs are the caller's to avoid (the
            # node's users write disjoint namespaces: chain 0x90*,
            # utxo u/*).
            self._writer.submit(ops, stage=True).result()
        else:
            self._append_physical(ops)
            self._stage(ops)
            self._maybe_compact()
        if not metrics.disabled:
            metrics.observe("store.write_seconds", time.perf_counter() - t0)
            metrics.inc("store.writes", len(ops))

    def write_batch_async(
        self, ops: Sequence[BatchOp]
    ) -> "concurrent.futures.Future[None]":
        """Atomic batch through the group-commit writer thread: the index
        updates immediately (read-your-writes), the returned future
        resolves once the batch is fsynced (acked ⇒ durable), and the
        calling event loop never blocks on the fsync.  A physical failure
        poisons the store (crash-only: the embedding actor's await raises
        and tears the node down)."""
        self._check_failed()
        if chaos.on:
            try:
                chaos.maybe_raise("store.write", self.path)
            except ChaosFault as e:
                fut: "concurrent.futures.Future[None]" = (
                    concurrent.futures.Future()
                )
                fut.set_exception(e)
                return fut
        _validate_ops(ops)
        with self._lock:
            if self._writer is None:
                self._writer = _GroupCommitWriter(self)
                self._writer.start()
        self._stage(ops)
        if not metrics.disabled:
            metrics.inc("store.writes", len(ops))
        return self._writer.submit(ops)

    def scan_prefix(self, prefix: bytes) -> Iterator[tuple[bytes, bytes]]:
        with self._lock:  # stable order vs the group-commit thread
            keys = sorted(k for k in self._data if k.startswith(prefix))
        for k in keys:
            v = self._data.get(k)
            if v is not None:
                yield k, v

    # -- compaction ----------------------------------------------------------

    def _maybe_compact(self) -> None:
        if self._dead_bytes < 1 << 20 or self._dead_bytes < 3 * self._live_bytes:
            return
        self.compact()

    def compact(self) -> None:
        """Crash-atomic compaction: write a full v2 snapshot to
        ``<path>.compact``, fsync the file and the parent directory, then
        ``os.replace`` it over the base path (+ fsync dir again) and delete
        the subsumed segments.  A crash in ANY window replays correctly:
        before the replace the old base+segments are intact (the stale temp
        is cleaned on open); after it, the snapshot already holds every
        record and leftover segments merely re-apply idempotent writes.

        The SLOW part — writing + fsyncing the snapshot — runs OUTSIDE the
        store lock: phase 1 rotates to a fresh segment and copies the index
        under the lock (fast), so concurrent writes land in a segment the
        cleanup never deletes and the event loop's ``_stage`` is never
        blocked for the compaction pause."""
        t0 = time.perf_counter()
        dirname = os.path.dirname(self.path)
        tmp = self.path + ".compact"
        with self._lock:
            if self._compacting:
                return  # one compaction at a time; the next pass retries
            self._compacting = True
        try:
            with self._lock:
                if chaos.on:
                    chaos.maybe_crash(
                        "store.compact", f"{self.path}:snapshot"
                    )
                # writes from here on go to a fresh segment that survives
                # the cleanup, so they replay on top of the snapshot
                self._new_segment(self._next_seg_seq())
                items = list(self._data.items())
                doomed = list(self._segments)
            with open(tmp, "wb") as f:  # slow phase: NO lock held
                f.write(
                    _FILE_HDR.pack(_MAGIC, _FMT_VERSION, _KIND_SNAPSHOT, 0)
                )
                for seq, (k, v) in enumerate(items):
                    body = _REC_V2_BODY.pack(seq, _OP_PUT, len(k), len(v))
                    body += k + v
                    f.write(zlib.crc32(body).to_bytes(4, "little") + body)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(dirname)
            if chaos.on:
                chaos.maybe_crash(
                    "store.compact", f"{self.path}:pre_replace"
                )
            with self._lock:
                os.replace(tmp, self.path)
                _fsync_dir(dirname)
                if chaos.on:
                    chaos.maybe_crash(
                        "store.compact", f"{self.path}:post_replace"
                    )
                # every snapshotted record is durable in the base: the
                # pre-rotation segments are garbage
                for _, seg in doomed:
                    os.remove(seg)
                self._segments = [
                    s for s in self._segments if s not in doomed
                ]
                _fsync_dir(dirname)
                if chaos.on:
                    chaos.maybe_crash(
                        "store.compact", f"{self.path}:cleanup"
                    )
                self._dead_bytes = 0
                self._live_bytes = (
                    os.path.getsize(self.path) + self._active_bytes
                )
                metrics.set_gauge(
                    "store.segments", float(len(self._segments) + 1)
                )
        finally:
            self._compacting = False
        metrics.inc("store.compactions")
        if not metrics.disabled:
            metrics.observe(
                "store.compact_seconds", time.perf_counter() - t0
            )

    def close(self) -> None:
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.close()  # drains queued batches first: acked ⇒ durable
        if self._file is not None and not self._file.closed:
            self._file.flush()
            self._file.close()


class Namespaced:
    """Column-family analog: a prefixed view over another store
    (reference: ``withDBCF``/``insertCF`` usage, NodeSpec.hs:247,279-280)."""

    def __init__(self, inner: KVStore, namespace: bytes):
        self._inner = inner
        self._ns = namespace

    def _k(self, key: bytes) -> bytes:
        return self._ns + key

    def get(self, key: bytes) -> Optional[bytes]:
        return self._inner.get(self._k(key))

    def put(self, key: bytes, value: bytes) -> None:
        self._inner.put(self._k(key), value)

    def delete(self, key: bytes) -> None:
        self._inner.delete(self._k(key))

    def write_batch(self, ops: Sequence[BatchOp]) -> None:
        self._inner.write_batch([(op, self._k(k), v) for op, k, v in ops])

    def scan_prefix(self, prefix: bytes) -> Iterator[tuple[bytes, bytes]]:
        n = len(self._ns)
        for k, v in self._inner.scan_prefix(self._k(prefix)):
            yield k[n:], v

    def close(self) -> None:
        pass  # owner closes the inner store


def open_store(path: Optional[str], engine: str = "auto") -> KVStore:
    """Open a store: ``None`` -> in-memory; else durable at ``path``.

    ``engine`` may be ``auto``/``native``/``log``/``memory``:

    * ``auto`` opens an **existing v1 single-file log** with the native
      engine when its shared library builds (compat with stores it wrote),
      and everything else — fresh paths and v2 stores — with :class:`LogKV`
      (async group-commit writes, quarantining salvage);
    * ``native`` opens v1 files AND v2 directories with the C++ engine;
      it raises :class:`StoreVersionError` only on mid-log
      damage or a newer-than-v2 format, where LogKV's salvage/reader is
      required — never silently serving a stale subset of the data.
    """
    if path is None or engine == "memory":
        return MemoryKV()
    if engine == "native":
        from .native import NativeKV  # built lazily; see native/kvstore

        return NativeKV(path)
    if (
        engine == "auto"
        and os.path.exists(path)
        and not v2_artifacts(path)
    ):
        try:
            from .native import NativeKV

            return NativeKV(path)
        except StoreVersionError:
            raise
        except Exception:
            pass  # no native toolchain: the Python engine reads v1 fine
    return LogKV(path)
