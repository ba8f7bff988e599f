"""ctypes binding to the repository's native C++ secp256k1 library.

Two entry points of ``native/secp256k1`` (built on first use by
:func:`tpunode_torch.native.ensure_native_lib`):

* ``secp_prepare_batch_w`` — the host prep of a device batch (batch
  inversion, GLV split, digit and limb rows, written limb-major) at a
  window width of 4 or 5 bits;
* ``secp_verify_batch`` — the CPU verdicts: the engine's cpu rung, and
  what ``chip_smoke.py`` holds the card's verdicts against.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np
from numpy.ctypeslib import ndpointer

from .. import threadsan
from ..native import REPO_ROOT, ensure_native_lib
from .raw import RawBatch
from .width import windows

__all__ = ["NativeVerifier", "load_native_verifier"]

_LIB_PATH = os.path.join(REPO_ROOT, "native", "build", "libsecp_cpu.so")

NLIMBS = 24


class NativeVerifier:
    """The two native calls the port needs, over packed byte rows."""

    def __init__(self, lib_path: Optional[str] = None):
        self._lib = ctypes.CDLL(lib_path or ensure_native_lib(_LIB_PATH, "secp256k1"))
        u8p = ctypes.c_char_p
        self._lib.secp_verify_batch.restype = ctypes.c_int
        self._lib.secp_verify_batch.argtypes = [
            u8p, u8p, u8p, u8p, u8p,  # px, py, z, r, s
            u8p,  # present (per-row algorithm)
            ctypes.c_int,  # count
            u8p,  # out
        ]
        i32 = ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8 = ndpointer(np.uint8, flags="C_CONTIGUOUS")
        try:
            self._prep = self._lib.secp_prepare_batch_w
        except AttributeError:
            raise RuntimeError(
                "the native library has no secp_prepare_batch_w (a build older "
                "than its sources): run `make -C native`"
            ) from None
        self._prep.restype = ctypes.c_int
        self._prep.argtypes = [
            u8p, u8p, u8p, u8p, u8p, u8p,  # px, py, z, r, s, present
            ctypes.c_int,  # count
            ctypes.c_int,  # size (padded)
            i32, i32, i32, i32,  # d1a, d1b, d2a, d2b
            u8,  # negs (4, size)
            i32, i32, i32, i32,  # qx, qy, r1, r2
            u8, u8, u8, u8,  # r2_valid, host_valid, schnorr, bip340
            ctypes.c_int,  # nthreads (0 = hardware concurrency)
            ctypes.c_int,  # window_bits (4 or 5)
        ]

    def prepare_batch_arrays(self, raw: RawBatch, size: int, window_bits: int) -> dict:
        """Host prep of ``raw`` padded to ``size`` lanes at ``window_bits``
        (4: 33 digit rows, 5: 27): the dict of limb-major numpy arrays.
        Raises on a GLV bound violation (|k| >= 2^132 at 4-bit, 2^135 at
        5-bit), which in-range scalars cannot produce: nonzero means a
        bug."""
        count = len(raw)
        if size < count:
            raise ValueError(f"pad size {size} < batch of {count}")
        nwin = windows(window_bits)
        out = {
            "d1a": np.zeros((nwin, size), np.int32),
            "d1b": np.zeros((nwin, size), np.int32),
            "d2a": np.zeros((nwin, size), np.int32),
            "d2b": np.zeros((nwin, size), np.int32),
            "negs": np.zeros((4, size), np.uint8),
            "qx": np.zeros((NLIMBS, size), np.int32),
            "qy": np.zeros((NLIMBS, size), np.int32),
            "r1": np.zeros((NLIMBS, size), np.int32),
            "r2": np.zeros((NLIMBS, size), np.int32),
            "r2_valid": np.zeros(size, np.uint8),
            "host_valid": np.zeros(size, np.uint8),
            "schnorr": np.zeros(size, np.uint8),
            "bip340": np.zeros(size, np.uint8),
        }
        bad = self._prep(
            *_rows(raw), count, size,
            out["d1a"], out["d1b"], out["d2a"], out["d2b"], out["negs"],
            out["qx"], out["qy"], out["r1"], out["r2"],
            out["r2_valid"], out["host_valid"], out["schnorr"], out["bip340"],
            0, window_bits,
        )
        if bad:
            raise ValueError(
                f"native prep: {bad} GLV half-scalars out of range" if bad > 0
                else f"native prep rejected window_bits={window_bits}"
            )
        return out

    def verify_raw(self, raw: RawBatch) -> list[bool]:
        """CPU verdicts for a packed batch (``present == 0`` rows are
        invalid)."""
        n = len(raw)
        if n == 0:
            return []
        out = ctypes.create_string_buffer(n)
        self._lib.secp_verify_batch(*_rows(raw), n, out)
        return [bool(raw.present[i]) and out.raw[i] == 1 for i in range(n)]


def _rows(raw: RawBatch) -> tuple:
    present = np.ascontiguousarray(raw.present, dtype=np.uint8)
    return (
        np.ascontiguousarray(raw.px).tobytes(),
        np.ascontiguousarray(raw.py).tobytes(),
        np.ascontiguousarray(raw.z).tobytes(),
        np.ascontiguousarray(raw.r).tobytes(),
        np.ascontiguousarray(raw.s).tobytes(),
        present.tobytes(),
    )


_cached: Optional[NativeVerifier] = None
_cached_lock = threadsan.lock("verify.native_verifier")


def load_native_verifier() -> NativeVerifier:
    """Build (if needed) and load the native library, once per process.
    Raises when it cannot be built: the port has no Python prep fallback
    on its main path."""
    global _cached
    with _cached_lock:
        if _cached is None:
            _cached = NativeVerifier()
        return _cached
