"""Canonical raw representation of a verify batch: packed byte rows.

``RawBatch`` is the interchange format between the engine, the native CPU
verifier (``secp_verify_batch``) and the native host prep
(``secp_prepare_batch_w``): five ``(N, 32)`` uint8 arrays of big-endian
values plus a per-item ``present`` flag carrying the algorithm:

* ``present == 0``: auto-invalid row (zeros elsewhere);
* ``present == 1``: ECDSA — ``z`` is the sighash digest;
* ``present == 2``: BCH Schnorr — ``z`` is the precomputed challenge ``e``,
  ``r`` the Fp x-coordinate;
* ``present == 3``: BIP340 — as BCH Schnorr with the tagged challenge and
  the lift_x'd even-y pubkey.

Tuple items pack with the degenerate-item rules checked on the ORIGINAL
ints (None/infinity pubkey, out-of-range r/s), so oversized values from a
lax encoding cannot alias onto valid ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .ecdsa_cpu import CURVE_N, CURVE_P

__all__ = ["RawBatch", "pack_items", "as_raw_batch", "concat_raw"]


@dataclass
class RawBatch:
    """Packed verify items: ``(N, 32)`` big-endian uint8 rows."""

    px: np.ndarray
    py: np.ndarray
    z: np.ndarray
    r: np.ndarray
    s: np.ndarray
    present: np.ndarray  # (N,) uint8; 0 absent, 1 ecdsa, 2 bch-schnorr, 3 bip340

    def __len__(self) -> int:
        return len(self.present)

    def slice(self, lo: int, hi: int) -> "RawBatch":
        return RawBatch(
            px=self.px[lo:hi],
            py=self.py[lo:hi],
            z=self.z[lo:hi],
            r=self.r[lo:hi],
            s=self.s[lo:hi],
            present=self.present[lo:hi],
        )


def pack_items(items: Sequence[tuple]) -> RawBatch:
    """Pack verify item tuples (4-tuples ECDSA, 5-tuples tagged "schnorr" or
    "bip340"), zeroing degenerate rows with ``present = 0``."""
    n = len(items)
    px = np.zeros((n, 32), np.uint8)
    py = np.zeros((n, 32), np.uint8)
    z = np.zeros((n, 32), np.uint8)
    r = np.zeros((n, 32), np.uint8)
    s = np.zeros((n, 32), np.uint8)
    present = np.zeros(n, np.uint8)
    for i, item in enumerate(items):
        q, zi, ri, si = item[:4]
        tag = item[4] if len(item) >= 5 else None
        if q is None or q.infinity:
            continue
        if tag in ("schnorr", "bip340"):
            # spec ranges: r an Fp element, s a scalar; zero allowed
            if not (0 <= ri < CURVE_P and 0 <= si < CURVE_N):
                continue
            present[i] = 2 if tag == "schnorr" else 3
        else:
            if not (0 < ri < CURVE_N and 0 < si < CURVE_N):
                continue
            present[i] = 1
        px[i] = np.frombuffer(q.x.to_bytes(32, "big"), np.uint8)
        py[i] = np.frombuffer(q.y.to_bytes(32, "big"), np.uint8)
        z[i] = np.frombuffer((zi % CURVE_N).to_bytes(32, "big"), np.uint8)
        r[i] = np.frombuffer(ri.to_bytes(32, "big"), np.uint8)
        s[i] = np.frombuffer(si.to_bytes(32, "big"), np.uint8)
    return RawBatch(px=px, py=py, z=z, r=r, s=s, present=present)


def as_raw_batch(obj) -> RawBatch:
    """A RawBatch as is, or a sequence of verify item tuples packed."""
    return obj if isinstance(obj, RawBatch) else pack_items(obj)


def concat_raw(batches: Sequence[RawBatch]) -> RawBatch:
    if len(batches) == 1:
        return batches[0]
    return RawBatch(
        px=np.concatenate([b.px for b in batches]),
        py=np.concatenate([b.py for b in batches]),
        z=np.concatenate([b.z for b in batches]),
        r=np.concatenate([b.r for b in batches]),
        s=np.concatenate([b.s for b in batches]),
        present=np.concatenate([b.present for b in batches]),
    )
