"""Build the repository's native C++ libraries on first use, and bind the
native KV store.

The port loads ``native/``'s libraries (the same C++ sources the reference
package builds) through ctypes; :func:`ensure_native_lib` runs
``make -C native <lib>`` when the library is missing or older than its
sources.

:class:`NativeKV` is the C++ append-log store (``native/kvstore``) behind
the :class:`~tpunode_torch.store.KVStore` protocol.  Two on-disk modes,
decided by what is at ``path``:

* **legacy v1** single-file log for paths with no v2 artifacts, replayed
  bit-identically by the Python v2 reader;
* **v2 segmented** (the CRC+seq format ``LogKV`` writes): replays the base
  snapshot/legacy file plus every segment with CRC and per-segment
  sequence validation, truncates a torn tail of the last file, and appends
  its own records into a fresh v2 segment, so ``LogKV`` replays the result
  bit-identically.

Mid-log damage (a sealed file failing CRC/sequence checks) makes
``kv_open`` FAIL rather than silently serve a prefix of acked data — the
quarantining salvage path belongs to ``LogKV`` (store.py).
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import subprocess
import time
from typing import Iterator, Optional, Sequence

from . import threadsan
from .metrics import metrics
from .store import BatchOp, StoreVersionError, delete_op, put_op, v2_artifacts

__all__ = ["REPO_ROOT", "ensure_native_lib", "NativeKV", "load_kvstore_lib"]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LIB_PATH = os.path.join(REPO_ROOT, "native", "build", "libkvstore.so")

log = logging.getLogger("tpunode_torch.native")


def ensure_native_lib(lib_path: str, src_subdir: str) -> str:
    """Build ``lib_path`` with make when missing or older than its sources.

    If a rebuild fails but a prebuilt library exists, it is loaded with a
    warning: a fresh checkout gives every source a newer mtime than a
    current prebuilt library, and a host without a toolchain must still
    run.  A missing library whose build fails raises."""
    native_dir = os.path.join(REPO_ROOT, "native")
    srcs = [os.path.join(native_dir, "Makefile")]
    src_dir = os.path.join(native_dir, src_subdir)
    if os.path.isdir(src_dir):
        srcs += [
            os.path.join(src_dir, f)
            for f in os.listdir(src_dir)
            if f.endswith((".cpp", ".h", ".hpp"))
        ]
    stale = not os.path.exists(lib_path) or any(
        os.path.getmtime(s) > os.path.getmtime(lib_path)
        for s in srcs
        if os.path.exists(s)
    )
    if stale:
        try:
            subprocess.run(
                ["make", "-C", native_dir,
                 os.path.join("build", os.path.basename(lib_path))],
                check=True,
                capture_output=True,
            )
        except (OSError, subprocess.CalledProcessError):
            if not os.path.exists(lib_path):
                raise
            log.warning(
                "rebuild of %s failed but a prebuilt library exists; "
                "loading it", os.path.basename(lib_path),
            )
    return lib_path


_REC = struct.Struct("<BII")
_SCAN_HDR = struct.Struct("<II")
_OP_PUT = 1
_OP_DEL = 2

_lib_lock = threadsan.lock("native.lib")
_lib: Optional[ctypes.CDLL] = None


def load_kvstore_lib() -> ctypes.CDLL:
    """Build (if needed) and load the shared library, once per process."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        ensure_native_lib(_LIB_PATH, "kvstore")
        lib = ctypes.CDLL(_LIB_PATH)
        lib.kv_open.restype = ctypes.c_void_p
        lib.kv_open.argtypes = [ctypes.c_char_p]
        lib.kv_close.argtypes = [ctypes.c_void_p]
        lib.kv_format.restype = ctypes.c_int
        lib.kv_format.argtypes = [ctypes.c_void_p]
        lib.kv_get.restype = ctypes.c_int
        lib.kv_get.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.kv_write_batch.restype = ctypes.c_int
        lib.kv_write_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_int,
        ]
        lib.kv_scan_prefix.restype = ctypes.c_int
        lib.kv_scan_prefix.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.kv_compact.restype = ctypes.c_int
        lib.kv_compact.argtypes = [ctypes.c_void_p]
        lib.kv_count.restype = ctypes.c_uint64
        lib.kv_count.argtypes = [ctypes.c_void_p]
        lib.kv_buf_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeKV:
    """C++ append-log KV store behind the KVStore protocol."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._read_tick = 0
        self._h = None  # __del__ must survive an open failure
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lib = load_kvstore_lib()
        self._h = self._lib.kv_open(path.encode())
        if not self._h:
            # kv_open refuses mid-log damage (a sealed segment failing
            # CRC/sequence validation) and formats newer than v2: both
            # are LogKV's richer recovery/reader territory, never a
            # silent stale-prefix serve.
            if v2_artifacts(path):
                raise StoreVersionError(
                    f"{path}: native v2 replay refused (mid-log damage or "
                    "newer format) — open with the LogKV engine to salvage"
                )
            raise OSError(f"kv_open failed for {path!r}")
        self.format_v2 = bool(self._lib.kv_format(self._h))

    # Same 1-in-64 read-latency sampling as LogKV (store.py): the registry
    # lock must not dominate a sub-µs native lookup.
    _READ_SAMPLE_MASK = 63

    def get(self, key: bytes) -> Optional[bytes]:
        sample = False
        if not metrics.disabled:
            self._read_tick += 1
            sample = not (self._read_tick & self._READ_SAMPLE_MASK)
        t0 = time.perf_counter() if sample else 0.0
        out = ctypes.c_void_p()
        outlen = ctypes.c_uint64()
        found = self._lib.kv_get(
            self._h, key, len(key), ctypes.byref(out), ctypes.byref(outlen)
        )
        try:
            if not found:
                return None
            try:
                return ctypes.string_at(out.value, outlen.value)
            finally:
                self._lib.kv_buf_free(out)
        finally:
            if sample:
                metrics.observe(
                    "store.read_seconds", time.perf_counter() - t0
                )

    def put(self, key: bytes, value: bytes) -> None:
        self.write_batch([put_op(key, value)])

    def delete(self, key: bytes) -> None:
        self.write_batch([delete_op(key)])

    def write_batch(self, ops: Sequence[BatchOp]) -> None:
        blob = bytearray()
        for op, k, v in ops:
            if op == "put":
                blob += _REC.pack(_OP_PUT, len(k), len(v)) + k + v
            elif op == "del":
                blob += _REC.pack(_OP_DEL, len(k), 0) + k
            else:
                raise ValueError(f"unknown batch op {op!r}")
        t0 = 0.0 if metrics.disabled else time.perf_counter()
        rc = self._lib.kv_write_batch(
            self._h, bytes(blob), len(blob), 1 if self.fsync else 0
        )
        if rc != 0:
            raise OSError(f"kv_write_batch failed ({rc})")
        if not metrics.disabled:
            metrics.observe("store.write_seconds", time.perf_counter() - t0)
            metrics.inc("store.writes", len(ops))

    def scan_prefix(self, prefix: bytes) -> Iterator[tuple[bytes, bytes]]:
        out = ctypes.c_void_p()
        outlen = ctypes.c_uint64()
        rc = self._lib.kv_scan_prefix(
            self._h, prefix, len(prefix), ctypes.byref(out), ctypes.byref(outlen)
        )
        if rc != 0:
            raise OSError(f"kv_scan_prefix failed ({rc})")
        try:
            raw = ctypes.string_at(out.value, outlen.value)
        finally:
            self._lib.kv_buf_free(out)
        pos = 0
        while pos + _SCAN_HDR.size <= len(raw):
            klen, vlen = _SCAN_HDR.unpack_from(raw, pos)
            pos += _SCAN_HDR.size
            yield raw[pos : pos + klen], raw[pos + klen : pos + klen + vlen]
            pos += klen + vlen

    def compact(self) -> None:
        if self._lib.kv_compact(self._h) != 0:
            raise OSError("kv_compact failed")

    def count(self) -> int:
        return int(self._lib.kv_count(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.kv_close(self._h)
            self._h = None

    def __del__(self):  # best-effort; owners should close() explicitly
        try:
            self.close()
        except Exception:
            pass
