"""Low-level primitives shared across the framework.

Hashing, variable-length integers, compact difficulty bits and byte-order
helpers, as ``haskoin-core`` provides them to a Haskell node:
double-SHA256 block/tx hashing, Bitcoin wire varints and the compact
target encoding used in block headers.
"""

from __future__ import annotations

import hashlib

__all__ = [
    "sha256",
    "double_sha256",
    "read_varint",
    "write_varint",
    "read_varstr",
    "write_varstr",
    "hash_to_hex",
    "hex_to_hash",
    "bits_to_target",
    "target_to_bits",
    "Reader",
]


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def double_sha256(data: bytes) -> bytes:
    """The ubiquitous Bitcoin hash: SHA256(SHA256(data))."""
    return hashlib.sha256(hashlib.sha256(data).digest()).digest()


def hash_to_hex(h: bytes) -> str:
    """Internal byte order -> RPC display order (reversed hex)."""
    return h[::-1].hex()


def hex_to_hash(s: str) -> bytes:
    """RPC display order (reversed hex) -> internal byte order."""
    return bytes.fromhex(s)[::-1]


def write_varint(n: int) -> bytes:
    if n < 0xFD:
        return n.to_bytes(1, "little")
    if n <= 0xFFFF:
        return b"\xfd" + n.to_bytes(2, "little")
    if n <= 0xFFFFFFFF:
        return b"\xfe" + n.to_bytes(4, "little")
    return b"\xff" + n.to_bytes(8, "little")


def write_varstr(b: bytes) -> bytes:
    return write_varint(len(b)) + b


class Reader:
    """Cursor over a byte buffer with exact-read semantics.

    Raises ``ValueError`` on truncated input, which message decoders surface
    as decode errors (the analog of cereal parse failures in the reference).
    """

    __slots__ = ("_buf", "_pos")

    def __init__(self, data: bytes, pos: int = 0):
        self._buf = data
        self._pos = pos

    @property
    def pos(self) -> int:
        return self._pos

    def remaining(self) -> int:
        return len(self._buf) - self._pos

    def slice_from(self, start: int) -> bytes:
        """Bytes consumed since ``start`` (a previously read ``pos``)."""
        return self._buf[start : self._pos]

    def peek(self, n: int) -> bytes:
        return self._buf[self._pos : self._pos + n]

    def read(self, n: int) -> bytes:
        end = self._pos + n
        if end > len(self._buf):
            raise ValueError(f"truncated read: wanted {n}, have {self.remaining()}")
        out = self._buf[self._pos : end]
        self._pos = end
        return out

    def u8(self) -> int:
        return self.read(1)[0]

    def u16(self) -> int:
        return int.from_bytes(self.read(2), "little")

    def u32(self) -> int:
        return int.from_bytes(self.read(4), "little")

    def u64(self) -> int:
        return int.from_bytes(self.read(8), "little")

    def i32(self) -> int:
        return int.from_bytes(self.read(4), "little", signed=True)

    def i64(self) -> int:
        return int.from_bytes(self.read(8), "little", signed=True)

    def u16be(self) -> int:
        return int.from_bytes(self.read(2), "big")

    def varint(self) -> int:
        # Non-minimal encodings are rejected (Bitcoin Core ReadCompactSize):
        # a hostile peer encoding e.g. an input count as fd 01 00 would
        # otherwise produce a different txid/sighash on paths that hash raw
        # spans than on paths that re-serialize canonically.
        first = self.u8()
        if first < 0xFD:
            return first
        if first == 0xFD:
            v = self.u16()
            lo = 0xFD
        elif first == 0xFE:
            v = self.u32()
            lo = 0x10000
        else:
            v = self.u64()
            lo = 0x100000000
        if v < lo:
            raise ValueError(f"non-minimal varint: {v} encoded with 0x{first:02x}")
        return v

    def varstr(self) -> bytes:
        return self.read(self.varint())


def read_varint(data: bytes, pos: int = 0) -> tuple[int, int]:
    r = Reader(data, pos)
    return r.varint(), r.pos


def read_varstr(data: bytes, pos: int = 0) -> tuple[bytes, int]:
    r = Reader(data, pos)
    return r.varstr(), r.pos


# --- compact difficulty encoding ------------------------------------------
#
# Block headers carry the proof-of-work target as a 32-bit base-256 floating
# point number ("nBits").  Encoding matches Bitcoin Core's arith_uint256
# SetCompact/GetCompact.


def bits_to_target(bits: int) -> int:
    """Decode compact bits to the 256-bit integer target.

    Returns 0 for encodings that are negative or overflow 256 bits (such a
    target can never be met, so callers treat the header as invalid).
    """
    exponent = bits >> 24
    mantissa = bits & 0x007FFFFF
    if bits & 0x00800000:  # sign bit: negative target is invalid
        return 0
    if exponent <= 3:
        target = mantissa >> (8 * (3 - exponent))
    else:
        target = mantissa << (8 * (exponent - 3))
    if target.bit_length() > 256:
        return 0
    return target


def target_to_bits(target: int) -> int:
    """Encode a 256-bit integer target into compact bits (canonical form)."""
    if target <= 0:
        return 0
    size = (target.bit_length() + 7) // 8
    if size <= 3:
        compact = target << (8 * (3 - size))
    else:
        compact = target >> (8 * (size - 3))
    # If the mantissa's top bit is set it would read as negative: renormalize.
    if compact & 0x00800000:
        compact >>= 8
        size += 1
    return compact | (size << 24)


def header_work(bits: int) -> int:
    """Expected work for a header: 2^256 / (target + 1).

    Same quantity Bitcoin Core accumulates as chain work; used to compare
    competing chains (haskoin-core's BlockNode chain-work field).
    """
    target = bits_to_target(bits)
    if target <= 0:
        return 0
    return (1 << 256) // (target + 1)
