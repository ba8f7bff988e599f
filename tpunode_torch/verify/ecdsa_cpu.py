"""Pure-Python secp256k1: the correctness oracle and the test signers.

The port's own copy of the reference oracle: curve constants, affine point
arithmetic, SEC1 pubkey and DER signature decoding (the transaction
layer's parsers), deterministic-nonce signers and verifiers for ECDSA, BCH
Schnorr and BIP340, and :func:`verify_batch_cpu`, the sequential verifier that engine warmup
and ``chip_smoke.py`` hold the device verdicts against.  Clarity over
speed; it is ground truth, not a verify backend.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Sequence

from .. import threadsan

__all__ = [
    "CURVE_P",
    "CURVE_N",
    "CURVE_B",
    "GENERATOR",
    "INFINITY",
    "Point",
    "decode_pubkey",
    "parse_der_signature",
    "point_add",
    "point_mul",
    "sign",
    "verify",
    "jacobi",
    "schnorr_challenge",
    "sign_schnorr",
    "verify_schnorr",
    "verify_schnorr_e",
    "tagged_hash",
    "lift_x",
    "bip340_challenge",
    "sign_bip340",
    "verify_bip340",
    "verify_bip340_e",
    "verify_batch_cpu",
]

# Curve: y^2 = x^3 + 7 over F_p
CURVE_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
CURVE_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
CURVE_B = 7
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


@dataclass(frozen=True)
class Point:
    """Affine point; ``None`` coordinates encode the point at infinity."""

    x: Optional[int]
    y: Optional[int]

    @property
    def infinity(self) -> bool:
        return self.x is None

    def on_curve(self) -> bool:
        if self.infinity:
            return True
        return (self.y * self.y - (self.x * self.x * self.x + CURVE_B)) % CURVE_P == 0


INFINITY = Point(None, None)
GENERATOR = Point(_GX, _GY)


def point_add(p: Point, q: Point) -> Point:
    if p.infinity:
        return q
    if q.infinity:
        return p
    if p.x == q.x:
        if (p.y + q.y) % CURVE_P == 0:
            return INFINITY
        return point_double(p)
    lam = (q.y - p.y) * pow(q.x - p.x, -1, CURVE_P) % CURVE_P
    x = (lam * lam - p.x - q.x) % CURVE_P
    y = (lam * (p.x - x) - p.y) % CURVE_P
    return Point(x, y)


def point_double(p: Point) -> Point:
    if p.infinity or p.y == 0:
        return INFINITY
    lam = 3 * p.x * p.x * pow(2 * p.y, -1, CURVE_P) % CURVE_P
    x = (lam * lam - 2 * p.x) % CURVE_P
    y = (lam * (p.x - x) - p.y) % CURVE_P
    return Point(x, y)


# Fixed-base window table for G: table[w][d] = d * 16^w * G.  G-multiplies
# dominate signing, and the windowed path is several times faster than the
# generic ladder.  Built once under a lock, published by one assignment.
_G_TABLE: Optional[tuple] = None
_G_TABLE_LOCK = threadsan.lock("verify.ecdsa_table")


def _g_table() -> tuple:
    global _G_TABLE
    table = _G_TABLE
    if table is not None:
        return table
    with _G_TABLE_LOCK:
        if _G_TABLE is None:
            rows = []
            base = GENERATOR
            for _ in range(64):
                row = [INFINITY]
                for _d in range(15):
                    row.append(point_add(row[-1], base))
                rows.append(tuple(row))
                for _d in range(4):
                    base = point_double(base)
            _G_TABLE = tuple(rows)
        return _G_TABLE


def point_mul(k: int, p: Point) -> Point:
    k %= CURVE_N
    if p == GENERATOR:
        table = _g_table()
        acc = INFINITY
        for w in range(64):
            acc = point_add(acc, table[w][(k >> (4 * w)) & 0xF])
        return acc
    acc = INFINITY
    addend = p
    while k:
        if k & 1:
            acc = point_add(acc, addend)
        addend = point_double(addend)
        k >>= 1
    return acc


def decode_pubkey(data: bytes) -> Optional[Point]:
    """SEC1 public key: compressed (33B, 02/03) or uncompressed (65B, 04).

    Returns None for malformed keys or points not on the curve.
    """
    if len(data) == 33 and data[0] in (2, 3):
        x = int.from_bytes(data[1:], "big")
        if x >= CURVE_P:
            return None
        y2 = (x * x * x + CURVE_B) % CURVE_P
        y = pow(y2, (CURVE_P + 1) // 4, CURVE_P)
        if y * y % CURVE_P != y2:
            return None
        if (y & 1) != (data[0] & 1):
            y = CURVE_P - y
        return Point(x, y)
    if len(data) == 65 and data[0] == 4:
        x = int.from_bytes(data[1:33], "big")
        y = int.from_bytes(data[33:], "big")
        p = Point(x, y)
        if x >= CURVE_P or y >= CURVE_P or not p.on_curve():
            return None
        return p
    return None


def parse_der_signature(sig: bytes) -> Optional[tuple[int, int]]:
    """Parse a DER ECDSA signature into (r, s).

    Accepts the (lax, pre-BIP66-ish) shapes found in historical Bitcoin
    transactions as long as the basic TLV structure holds.
    """
    try:
        if len(sig) < 8 or sig[0] != 0x30:
            return None
        if sig[1] != len(sig) - 2:
            return None
        if sig[2] != 0x02:
            return None
        rlen = sig[3]
        r = int.from_bytes(sig[4 : 4 + rlen], "big")
        pos = 4 + rlen
        if sig[pos] != 0x02:
            return None
        slen = sig[pos + 1]
        s = int.from_bytes(sig[pos + 2 : pos + 2 + slen], "big")
        if pos + 2 + slen != len(sig):
            return None
        return r, s
    except IndexError:
        return None


def sign(priv: int, z: int, nonce: int) -> tuple[int, int]:
    """Deterministic-nonce ECDSA signing for tests (NOT for production)."""
    k = nonce % CURVE_N or 1
    R = point_mul(k, GENERATOR)
    r = R.x % CURVE_N
    s = pow(k, -1, CURVE_N) * (z + r * priv) % CURVE_N
    if r == 0 or s == 0:
        return sign(priv, z, nonce + 1)
    return r, s


def verify(pubkey: Optional[Point], z: int, r: int, s: int) -> bool:
    """ECDSA: R = u1*G + u2*Q, accept iff R is finite and x(R) ≡ r (mod n).
    A ``None`` pubkey is invalid."""
    if not (0 < r < CURVE_N and 0 < s < CURVE_N):
        return False
    if pubkey is None or pubkey.infinity or not pubkey.on_curve():
        return False
    w = pow(s, -1, CURVE_N)
    R = point_add(
        point_mul(z * w % CURVE_N, GENERATOR), point_mul(r * w % CURVE_N, pubkey)
    )
    if R.infinity:
        return False
    return R.x % CURVE_N == r


# --- BCH Schnorr (2019-05 upgrade spec) ------------------------------------
# R' = s·G − e·P with e = SHA256(r ∥ P_compressed ∥ m) mod n; accept iff R'
# is finite, jacobi(y(R')) = 1 and x(R') = r.  Same dual-scalar MSM as
# ECDSA (u1 = s, u2 = n − e), so one device program verifies both.


def jacobi(a: int) -> int:
    """Legendre symbol of ``a`` mod p via Euler's criterion."""
    if a % CURVE_P == 0:
        return 0
    return 1 if pow(a, (CURVE_P - 1) // 2, CURVE_P) == 1 else -1


def _compress(p: Point) -> bytes:
    return bytes([2 + (p.y & 1)]) + p.x.to_bytes(32, "big")


def schnorr_challenge(r: int, pubkey: Point, m: int) -> int:
    digest = hashlib.sha256(
        r.to_bytes(32, "big") + _compress(pubkey) + m.to_bytes(32, "big")
    ).digest()
    return int.from_bytes(digest, "big") % CURVE_N


def sign_schnorr(priv: int, m: int, nonce: int) -> tuple[int, int]:
    """Deterministic-nonce BCH Schnorr signing for tests."""
    k = nonce % CURVE_N or 1
    R = point_mul(k, GENERATOR)
    if jacobi(R.y) != 1:
        k = CURVE_N - k
        R = Point(R.x, CURVE_P - R.y)
    pub = point_mul(priv, GENERATOR)
    e = schnorr_challenge(R.x, pub, m)
    return R.x, (k + e * priv) % CURVE_N


def verify_schnorr_e(pubkey: Optional[Point], e: int, r: int, s: int) -> bool:
    """BCH Schnorr from a precomputed challenge ``e`` (the batch item form)."""
    if not (0 <= r < CURVE_P and 0 <= s < CURVE_N):
        return False
    if pubkey is None or pubkey.infinity or not pubkey.on_curve():
        return False
    R = point_add(
        point_mul(s, GENERATOR), point_mul(CURVE_N - e % CURVE_N, pubkey)
    )
    if R.infinity:
        return False
    return jacobi(R.y) == 1 and R.x == r


def verify_schnorr(pubkey: Optional[Point], m: int, r: int, s: int) -> bool:
    """Full BCH Schnorr verification over the message hash ``m``."""
    if pubkey is None or pubkey.infinity:
        return False
    return verify_schnorr_e(pubkey, schnorr_challenge(r, pubkey, m), r, s)


# --- BIP340 Schnorr (taproot) ----------------------------------------------
# x-only keys lifted to the even-y point, a tagged challenge hash, and y(R')
# even in place of the jacobi test.


def tagged_hash(tag: bytes, data: bytes) -> bytes:
    """BIP340's tagged hash: SHA256(SHA256(tag) ∥ SHA256(tag) ∥ data)."""
    th = hashlib.sha256(tag).digest()
    return hashlib.sha256(th + th + data).digest()


def lift_x(x: int) -> Optional[Point]:
    """The even-y point with x-coordinate ``x``; None if there is none."""
    if not (0 <= x < CURVE_P):
        return None
    y2 = (x * x * x + CURVE_B) % CURVE_P
    y = pow(y2, (CURVE_P + 1) // 4, CURVE_P)
    if y * y % CURVE_P != y2:
        return None
    return Point(x, y if y % 2 == 0 else CURVE_P - y)


def bip340_challenge(r: int, pubkey_x: int, m: int) -> int:
    e = tagged_hash(
        b"BIP0340/challenge",
        r.to_bytes(32, "big") + pubkey_x.to_bytes(32, "big")
        + m.to_bytes(32, "big"),
    )
    return int.from_bytes(e, "big") % CURVE_N


def sign_bip340(priv: int, m: int, nonce: int) -> tuple[int, int]:
    """Deterministic-nonce BIP340 signing for tests (no aux-rand)."""
    P = point_mul(priv, GENERATOR)
    d = priv if P.y % 2 == 0 else CURVE_N - priv
    k = nonce % CURVE_N or 1
    R = point_mul(k, GENERATOR)
    if R.y % 2 != 0:
        k = CURVE_N - k
        R = Point(R.x, CURVE_P - R.y)
    e = bip340_challenge(R.x, P.x, m)
    return R.x, (k + e * d) % CURVE_N


def verify_bip340_e(pubkey: Optional[Point], e: int, r: int, s: int) -> bool:
    """BIP340 from a precomputed challenge; ``pubkey`` is the lifted point."""
    if not (0 <= r < CURVE_P and 0 <= s < CURVE_N):
        return False
    if pubkey is None or pubkey.infinity or not pubkey.on_curve():
        return False
    R = point_add(
        point_mul(s, GENERATOR), point_mul(CURVE_N - e % CURVE_N, pubkey)
    )
    if R.infinity:
        return False
    return R.y % 2 == 0 and R.x == r


def verify_bip340(pubkey_x: int, m: int, r: int, s: int) -> bool:
    """Full BIP340 verification over an x-only public key."""
    P = lift_x(pubkey_x)
    if P is None:
        return False
    return verify_bip340_e(P, bip340_challenge(r, pubkey_x, m), r, s)


def verify_batch_cpu(items: Sequence[tuple]) -> list[bool]:
    """Sequential batch verify.  Items are ``(pubkey|None, z, r, s)`` for
    ECDSA, or 5-tuples tagged ``"schnorr"`` / ``"bip340"`` with the
    precomputed challenge in the z position."""
    out = []
    for item in items:
        tag = item[4] if len(item) >= 5 else None
        if tag == "schnorr":
            out.append(verify_schnorr_e(*item[:4]))
        elif tag == "bip340":
            out.append(verify_bip340_e(*item[:4]))
        else:
            out.append(verify(*item[:4]))
    return out
