"""Bitcoin wire protocol codec: messages, transactions, blocks, framing.

The reference obtains its codec from haskoin-core (``getMessage``/``putMessage``
and the ``Message`` sum type; consumed at src/Haskoin/Node/Peer.hs:61-82 and
framed at src/Haskoin/Node/Peer.hs:247-283).  This module is a from-scratch
implementation of the same wire format: a 24-byte envelope (magic, command,
length, checksum) followed by the payload, plus codecs for every message the
node exchanges.

Hash values are held in *internal* byte order (raw double-SHA256 output); use
``util.hash_to_hex`` for display order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional

from .params import Network
from .util import (
    Reader,
    double_sha256,
    hash_to_hex,
    write_varint,
    write_varstr,
)

__all__ = [
    "MessageHeader",
    "NetworkAddress",
    "InvType",
    "InvVector",
    "OutPoint",
    "TxIn",
    "TxOut",
    "Tx",
    "BlockHeader",
    "Block",
    "LazyBlock",
    "LazyTx",
    "MsgVersion",
    "MsgVerAck",
    "MsgPing",
    "MsgPong",
    "MsgAddr",
    "MsgInv",
    "MsgGetData",
    "MsgNotFound",
    "MsgGetBlocks",
    "MsgGetHeaders",
    "MsgHeaders",
    "MsgBlock",
    "MsgTx",
    "MsgGetAddr",
    "MsgMempool",
    "MsgSendHeaders",
    "MsgFeeFilter",
    "MsgReject",
    "MsgOther",
    "encode_message",
    "decode_message",
    "decode_message_header",
    "build_merkle_root",
    "DecodeError",
    "HEADER_SIZE",
    "MAX_PAYLOAD",
]

HEADER_SIZE = 24
# Largest payload the peer loop will accept (reference: Peer.hs:266).
MAX_PAYLOAD = 32 * 1024 * 1024


class DecodeError(ValueError):
    """Raised when wire bytes cannot be decoded."""


# --- envelope --------------------------------------------------------------


@dataclass(frozen=True)
class MessageHeader:
    """24-byte message envelope: magic | command[12] | length | checksum."""

    magic: int
    command: str
    length: int
    checksum: bytes

    def serialize(self) -> bytes:
        cmd = self.command.encode("ascii")
        if len(cmd) > 12:
            raise DecodeError(f"command too long: {self.command}")
        return (
            self.magic.to_bytes(4, "big")
            + cmd.ljust(12, b"\x00")
            + self.length.to_bytes(4, "little")
            + self.checksum
        )

    @classmethod
    def deserialize(cls, data: bytes) -> "MessageHeader":
        if len(data) < HEADER_SIZE:
            raise DecodeError("short message header")
        magic = int.from_bytes(data[0:4], "big")
        command = data[4:16].rstrip(b"\x00").decode("ascii", errors="replace")
        length = int.from_bytes(data[16:20], "little")
        checksum = data[20:24]
        return cls(magic, command, length, checksum)


# --- shared structures -----------------------------------------------------


@dataclass(frozen=True)
class NetworkAddress:
    """services + IPv6-mapped address + port (no timestamp; version-msg form)."""

    services: int
    address: bytes  # 16 bytes, IPv6 or IPv4-mapped ::ffff:a.b.c.d
    port: int

    @staticmethod
    def from_host_port(host: str, port: int, services: int = 0) -> "NetworkAddress":
        import ipaddress

        ip = ipaddress.ip_address(host)
        if ip.version == 4:
            raw = b"\x00" * 10 + b"\xff\xff" + ip.packed
        else:
            raw = ip.packed
        return NetworkAddress(services, raw, port)

    def to_host_port(self) -> tuple[str, int]:
        import ipaddress

        if self.address[:12] == b"\x00" * 10 + b"\xff\xff":
            host = str(ipaddress.IPv4Address(self.address[12:]))
        else:
            host = str(ipaddress.IPv6Address(self.address))
        return host, self.port

    def serialize(self) -> bytes:
        return (
            self.services.to_bytes(8, "little")
            + self.address
            + self.port.to_bytes(2, "big")
        )

    @classmethod
    def deserialize(cls, r: Reader) -> "NetworkAddress":
        services = r.u64()
        address = r.read(16)
        port = r.u16be()
        return cls(services, address, port)


class InvType:
    """Inventory vector types (getdata/inv/notfound)."""

    ERROR = 0
    TX = 1
    BLOCK = 2
    MERKLE_BLOCK = 3
    COMPACT_BLOCK = 4
    WITNESS_FLAG = 1 << 30
    WITNESS_TX = TX | WITNESS_FLAG
    WITNESS_BLOCK = BLOCK | WITNESS_FLAG


@dataclass(frozen=True)
class InvVector:
    type: int
    hash: bytes  # 32 bytes, internal order

    def serialize(self) -> bytes:
        return self.type.to_bytes(4, "little") + self.hash

    @classmethod
    def deserialize(cls, r: Reader) -> "InvVector":
        t = r.u32()
        h = r.read(32)
        return cls(t, h)


# --- transactions ----------------------------------------------------------


@dataclass(frozen=True)
class OutPoint:
    txid: bytes  # 32 bytes internal order
    index: int

    def serialize(self) -> bytes:
        return self.txid + self.index.to_bytes(4, "little")

    @classmethod
    def deserialize(cls, r: Reader) -> "OutPoint":
        return cls(r.read(32), r.u32())


@dataclass(frozen=True)
class TxIn:
    prevout: OutPoint
    script: bytes
    sequence: int

    def serialize(self) -> bytes:
        return (
            self.prevout.serialize()
            + write_varstr(self.script)
            + self.sequence.to_bytes(4, "little")
        )

    @classmethod
    def deserialize(cls, r: Reader) -> "TxIn":
        prevout = OutPoint.deserialize(r)
        script = r.varstr()
        sequence = r.u32()
        return cls(prevout, script, sequence)


@dataclass(frozen=True)
class TxOut:
    value: int
    script: bytes

    def serialize(self) -> bytes:
        return self.value.to_bytes(8, "little") + write_varstr(self.script)

    @classmethod
    def deserialize(cls, r: Reader) -> "TxOut":
        return cls(r.u64(), r.varstr())


@dataclass(frozen=True)
class Tx:
    """A transaction; segwit marker/flag form supported on segwit networks."""

    version: int
    inputs: tuple[TxIn, ...]
    outputs: tuple[TxOut, ...]
    locktime: int
    # per-input witness stacks; empty tuple means non-segwit serialization
    witnesses: tuple[tuple[bytes, ...], ...] = ()
    # original wire bytes when this Tx came off the network (deserialize
    # sets it) — the zero-reparse input for the native extract fast path
    # (txextract.py).  Not part of value identity.
    raw: Optional[bytes] = field(default=None, compare=False, repr=False)

    @cached_property
    def has_witness(self) -> bool:
        # cached: wants_amount consults this per input, and an any() scan
        # per call would be O(n_inputs^2) on large transactions
        return any(self.witnesses)

    def serialize(self, include_witness: bool = True) -> bytes:
        parts = [self.version.to_bytes(4, "little", signed=False)]
        wit = include_witness and self.has_witness
        if wit:
            parts.append(b"\x00\x01")
        parts.append(write_varint(len(self.inputs)))
        parts.extend(i.serialize() for i in self.inputs)
        parts.append(write_varint(len(self.outputs)))
        parts.extend(o.serialize() for o in self.outputs)
        if wit:
            for stack in self.witnesses:
                parts.append(write_varint(len(stack)))
                parts.extend(write_varstr(item) for item in stack)
        parts.append(self.locktime.to_bytes(4, "little"))
        return b"".join(parts)

    @cached_property
    def txid(self) -> bytes:
        """Hash of the non-witness serialization (internal order)."""
        return double_sha256(self.serialize(include_witness=False))

    @cached_property
    def wtxid(self) -> bytes:
        return double_sha256(self.serialize(include_witness=True))

    @classmethod
    def deserialize(cls, r: Reader) -> "Tx":
        start = r.pos
        version = r.u32()
        marker = r.peek(2)
        segwit = marker[:1] == b"\x00" and len(marker) == 2 and marker[1] == 1
        if segwit:
            r.read(2)
        n_in = r.varint()
        inputs = tuple(TxIn.deserialize(r) for _ in range(n_in))
        n_out = r.varint()
        outputs = tuple(TxOut.deserialize(r) for _ in range(n_out))
        witnesses: tuple[tuple[bytes, ...], ...] = ()
        if segwit:
            witnesses = tuple(
                tuple(r.varstr() for _ in range(r.varint())) for _ in range(n_in)
            )
        locktime = r.u32()
        return cls(
            version, inputs, outputs, locktime, witnesses,
            raw=r.slice_from(start),
        )


# --- block header / block --------------------------------------------------


@dataclass(frozen=True)
class BlockHeader:
    """80-byte block header (consensus-critical serialization)."""

    version: int
    prev: bytes  # 32 bytes internal order
    merkle: bytes  # 32 bytes internal order
    timestamp: int
    bits: int
    nonce: int

    def serialize(self) -> bytes:
        return (
            self.version.to_bytes(4, "little", signed=False)
            + self.prev
            + self.merkle
            + self.timestamp.to_bytes(4, "little")
            + self.bits.to_bytes(4, "little")
            + self.nonce.to_bytes(4, "little")
        )

    @cached_property
    def hash(self) -> bytes:
        """Header hash, internal byte order."""
        return double_sha256(self.serialize())

    @property
    def hash_hex(self) -> str:
        return hash_to_hex(self.hash)

    @classmethod
    def deserialize(cls, r: Reader) -> "BlockHeader":
        return cls(
            version=r.u32(),
            prev=r.read(32),
            merkle=r.read(32),
            timestamp=r.u32(),
            bits=r.u32(),
            nonce=r.u32(),
        )


@dataclass(frozen=True)
class Block:
    header: BlockHeader
    txs: tuple[Tx, ...]
    # original tx-region wire bytes (deserialize sets it): feeds the native
    # extract fast path without re-serializing.  Not part of value identity.
    raw_txs: Optional[bytes] = field(default=None, compare=False, repr=False)

    @property
    def tx_count(self) -> int:
        return len(self.txs)

    def serialize(self) -> bytes:
        return (
            self.header.serialize()
            + write_varint(len(self.txs))
            + b"".join(t.serialize() for t in self.txs)
        )

    @classmethod
    def deserialize(cls, r: Reader) -> "Block":
        header = BlockHeader.deserialize(r)
        n = r.varint()
        start = r.pos
        txs = tuple(Tx.deserialize(r) for _ in range(n))
        return cls(header, txs, raw_txs=r.slice_from(start))


class LazyBlock:
    """A block whose tx region stays raw wire bytes until ``.txs`` is
    touched.  ``MsgBlock`` decodes to this, so receiving a full block
    costs no Python tx parsing on the event loop: the verify-ingest fast
    path hands ``raw_txs`` + ``tx_count`` straight to the native extractor
    (txextract.py), and only an embedder that actually reads
    ``.txs`` pays the parse (which then validates the region fully and
    yields exactly what an eager Block carries).

    The reference parses every message eagerly in its conduit
    (Peer.hs:247-279) because its node never looks inside block bodies at
    all; this framework's verify hook does, and at spec rates (32 MB
    blocks, ~150k sigs) eager Python parsing bounds block ingest.
    """

    def __init__(self, header: BlockHeader, tx_count: int, raw_txs: bytes):
        self.header = header
        self.tx_count = tx_count
        self.raw_txs = raw_txs

    @cached_property
    def txs(self) -> tuple[Tx, ...]:
        r = Reader(self.raw_txs)
        txs = tuple(Tx.deserialize(r) for _ in range(self.tx_count))
        if r.remaining():
            raise ValueError("trailing bytes in block tx region")
        return txs

    def serialize(self) -> bytes:
        return (
            self.header.serialize()
            + write_varint(self.tx_count)
            + self.raw_txs
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, (Block, LazyBlock))
            and self.header == other.header
            and self.txs == tuple(other.txs)
        )

    def __hash__(self) -> int:
        # Must match the eager Block's dataclass hash (tuple of its
        # compare fields — raw_txs is compare=False) so mixed sets/dicts
        # of Block and LazyBlock behave; hashing pays the one-time parse,
        # like any other content access.
        return hash((self.header, self.txs))

    def __repr__(self) -> str:
        return f"LazyBlock(header={self.header!r}, tx_count={self.tx_count})"


def build_merkle_root(txids: list[bytes]) -> bytes:
    """Merkle root over txids (internal order), duplicating odd tails."""
    if not txids:
        return b"\x00" * 32
    level = list(txids)
    while len(level) > 1:
        if len(level) % 2 == 1:
            level.append(level[-1])
        level = [
            double_sha256(level[i] + level[i + 1]) for i in range(0, len(level), 2)
        ]
    return level[0]


# --- messages --------------------------------------------------------------


@dataclass(frozen=True)
class MsgVersion:
    command = "version"
    version: int
    services: int
    timestamp: int
    addr_recv: NetworkAddress
    addr_from: NetworkAddress
    nonce: int
    user_agent: bytes
    start_height: int
    relay: bool = True

    def serialize_payload(self) -> bytes:
        out = (
            self.version.to_bytes(4, "little")
            + self.services.to_bytes(8, "little")
            + self.timestamp.to_bytes(8, "little")
            + self.addr_recv.serialize()
            + self.addr_from.serialize()
            + self.nonce.to_bytes(8, "little")
            + write_varstr(self.user_agent)
            + self.start_height.to_bytes(4, "little")
        )
        if self.version >= 70001:
            out += b"\x01" if self.relay else b"\x00"
        return out

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgVersion":
        version = r.u32()
        services = r.u64()
        timestamp = r.u64()
        addr_recv = NetworkAddress.deserialize(r)
        addr_from = NetworkAddress.deserialize(r)
        nonce = r.u64()
        user_agent = r.varstr()
        start_height = r.u32()
        relay = True
        if version >= 70001 and r.remaining() > 0:
            relay = r.u8() != 0
        return cls(
            version,
            services,
            timestamp,
            addr_recv,
            addr_from,
            nonce,
            user_agent,
            start_height,
            relay,
        )


@dataclass(frozen=True)
class MsgVerAck:
    command = "verack"

    def serialize_payload(self) -> bytes:
        return b""

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgVerAck":
        return cls()


@dataclass(frozen=True)
class MsgPing:
    command = "ping"
    nonce: int

    def serialize_payload(self) -> bytes:
        return self.nonce.to_bytes(8, "little")

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgPing":
        return cls(r.u64())


@dataclass(frozen=True)
class MsgPong:
    command = "pong"
    nonce: int

    def serialize_payload(self) -> bytes:
        return self.nonce.to_bytes(8, "little")

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgPong":
        return cls(r.u64())


@dataclass(frozen=True)
class MsgAddr:
    command = "addr"
    # (last-seen timestamp, address) pairs
    addrs: tuple[tuple[int, NetworkAddress], ...]

    def serialize_payload(self) -> bytes:
        out = [write_varint(len(self.addrs))]
        for ts, na in self.addrs:
            out.append(ts.to_bytes(4, "little") + na.serialize())
        return b"".join(out)

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgAddr":
        n = r.varint()
        addrs = tuple((r.u32(), NetworkAddress.deserialize(r)) for _ in range(n))
        return cls(addrs)


def _ser_invs(invs: tuple[InvVector, ...]) -> bytes:
    return write_varint(len(invs)) + b"".join(i.serialize() for i in invs)


def _deser_invs(r: Reader) -> tuple[InvVector, ...]:
    n = r.varint()
    return tuple(InvVector.deserialize(r) for _ in range(n))


@dataclass(frozen=True)
class MsgInv:
    command = "inv"
    invs: tuple[InvVector, ...]

    def serialize_payload(self) -> bytes:
        return _ser_invs(self.invs)

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgInv":
        return cls(_deser_invs(r))


@dataclass(frozen=True)
class MsgGetData:
    command = "getdata"
    invs: tuple[InvVector, ...]

    def serialize_payload(self) -> bytes:
        return _ser_invs(self.invs)

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgGetData":
        return cls(_deser_invs(r))


@dataclass(frozen=True)
class MsgNotFound:
    command = "notfound"
    invs: tuple[InvVector, ...]

    def serialize_payload(self) -> bytes:
        return _ser_invs(self.invs)

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgNotFound":
        return cls(_deser_invs(r))


@dataclass(frozen=True)
class MsgGetBlocks:
    command = "getblocks"
    version: int
    locator: tuple[bytes, ...]
    stop: bytes

    def serialize_payload(self) -> bytes:
        return (
            self.version.to_bytes(4, "little")
            + write_varint(len(self.locator))
            + b"".join(self.locator)
            + self.stop
        )

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgGetBlocks":
        version = r.u32()
        n = r.varint()
        locator = tuple(r.read(32) for _ in range(n))
        stop = r.read(32)
        return cls(version, locator, stop)


@dataclass(frozen=True)
class MsgGetHeaders:
    command = "getheaders"
    version: int
    locator: tuple[bytes, ...]
    stop: bytes

    def serialize_payload(self) -> bytes:
        return (
            self.version.to_bytes(4, "little")
            + write_varint(len(self.locator))
            + b"".join(self.locator)
            + self.stop
        )

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgGetHeaders":
        version = r.u32()
        n = r.varint()
        locator = tuple(r.read(32) for _ in range(n))
        stop = r.read(32)
        return cls(version, locator, stop)


@dataclass(frozen=True)
class MsgHeaders:
    command = "headers"
    # (header, tx-count) pairs; tx-count is a varint on the wire, normally 0
    headers: tuple[tuple[BlockHeader, int], ...]

    def serialize_payload(self) -> bytes:
        out = [write_varint(len(self.headers))]
        for h, n in self.headers:
            out.append(h.serialize() + write_varint(n))
        return b"".join(out)

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgHeaders":
        n = r.varint()
        headers = tuple(
            (BlockHeader.deserialize(r), r.varint()) for _ in range(n)
        )
        return cls(headers)


@dataclass(frozen=True)
class MsgBlock:
    command = "block"
    block: "Block | LazyBlock"

    def serialize_payload(self) -> bytes:
        return self.block.serialize()

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgBlock":
        # Lazy: the tx region is the rest of the payload by definition, so
        # no parsing happens here (see LazyBlock).
        header = BlockHeader.deserialize(r)
        n = r.varint()
        return cls(LazyBlock(header, n, r.read(r.remaining())))


class LazyTx:
    """A transaction whose parse is deferred: ``raw`` holds the exact wire
    bytes; touching any other attribute parses once and delegates to the
    eager :class:`Tx`.  ``MsgTx`` decodes to this, so a mempool firehose
    costs no Python tx parsing on the event loop — the native verify
    ingest consumes ``raw`` directly (txextract.py), and only code
    that actually inspects the tx pays the parse (which validates the
    payload fully, surfacing what eager decode would have)."""

    __slots__ = ("raw", "_tx")

    def __init__(self, raw: bytes):
        self.raw = raw
        self._tx: Optional[Tx] = None

    def _parsed(self) -> Tx:
        tx = self._tx
        if tx is None:
            r = Reader(self.raw)
            tx = Tx.deserialize(r)
            if r.remaining():
                raise ValueError("trailing bytes after tx payload")
            self._tx = tx
        return tx

    def serialize(self, include_witness: bool = True) -> bytes:
        if include_witness:
            return self.raw
        return self._parsed().serialize(include_witness=False)

    def __getattr__(self, name):
        # reached only for names not on LazyTx itself (raw/_tx/serialize)
        return getattr(self._parsed(), name)

    def __eq__(self, other) -> bool:
        if isinstance(other, LazyTx):
            return self.raw == other.raw
        if isinstance(other, Tx):
            return self._parsed() == other
        return NotImplemented

    def __hash__(self) -> int:
        # Must match the eager Tx's dataclass hash (raw is compare=False)
        # so mixed sets/dicts of Tx and LazyTx behave; hashing pays the
        # one-time parse, like any other content access.
        return hash(self._parsed())

    def __repr__(self) -> str:
        return f"LazyTx({len(self.raw)} bytes)"


@dataclass(frozen=True)
class MsgTx:
    command = "tx"
    tx: "Tx | LazyTx"

    def serialize_payload(self) -> bytes:
        return self.tx.serialize()

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgTx":
        # Lazy: the payload IS the tx by definition (see LazyTx).
        return cls(LazyTx(r.read(r.remaining())))


@dataclass(frozen=True)
class MsgGetAddr:
    command = "getaddr"

    def serialize_payload(self) -> bytes:
        return b""

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgGetAddr":
        return cls()


@dataclass(frozen=True)
class MsgMempool:
    command = "mempool"

    def serialize_payload(self) -> bytes:
        return b""

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgMempool":
        return cls()


@dataclass(frozen=True)
class MsgSendHeaders:
    command = "sendheaders"

    def serialize_payload(self) -> bytes:
        return b""

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgSendHeaders":
        return cls()


@dataclass(frozen=True)
class MsgFeeFilter:
    command = "feefilter"
    feerate: int

    def serialize_payload(self) -> bytes:
        return self.feerate.to_bytes(8, "little")

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgFeeFilter":
        return cls(r.u64())


@dataclass(frozen=True)
class MsgReject:
    command = "reject"
    message: bytes
    code: int
    reason: bytes
    data: bytes = b""

    def serialize_payload(self) -> bytes:
        return (
            write_varstr(self.message)
            + self.code.to_bytes(1, "little")
            + write_varstr(self.reason)
            + self.data
        )

    @classmethod
    def deserialize_payload(cls, r: Reader) -> "MsgReject":
        message = r.varstr()
        code = r.u8()
        reason = r.varstr()
        data = r.read(r.remaining())
        return cls(message, code, reason, data)


@dataclass(frozen=True)
class MsgOther:
    """Any command this codec has no structured decoder for."""

    cmd: str
    payload: bytes

    @property
    def command(self) -> str:  # type: ignore[override]
        return self.cmd

    def serialize_payload(self) -> bytes:
        return self.payload


_MESSAGE_TYPES = {
    m.command: m
    for m in (
        MsgVersion,
        MsgVerAck,
        MsgPing,
        MsgPong,
        MsgAddr,
        MsgInv,
        MsgGetData,
        MsgNotFound,
        MsgGetBlocks,
        MsgGetHeaders,
        MsgHeaders,
        MsgBlock,
        MsgTx,
        MsgGetAddr,
        MsgMempool,
        MsgSendHeaders,
        MsgFeeFilter,
        MsgReject,
    )
}

Message = (
    MsgVersion
    | MsgVerAck
    | MsgPing
    | MsgPong
    | MsgAddr
    | MsgInv
    | MsgGetData
    | MsgNotFound
    | MsgGetBlocks
    | MsgGetHeaders
    | MsgHeaders
    | MsgBlock
    | MsgTx
    | MsgGetAddr
    | MsgMempool
    | MsgSendHeaders
    | MsgFeeFilter
    | MsgReject
    | MsgOther
)


def encode_message(net: Network, msg) -> bytes:
    """Serialize a message with its 24-byte envelope."""
    payload = msg.serialize_payload()
    header = MessageHeader(
        magic=net.magic,
        command=msg.command,
        length=len(payload),
        checksum=double_sha256(payload)[:4],
    )
    return header.serialize() + payload


def decode_message_header(net: Network, data: bytes) -> MessageHeader:
    hdr = MessageHeader.deserialize(data)
    if hdr.magic != net.magic:
        raise DecodeError(
            f"bad magic: got {hdr.magic:#x}, want {net.magic:#x}"
        )
    return hdr


def decode_message(net: Network, header: MessageHeader, payload: bytes):
    """Decode a payload given its (already validated) envelope."""
    if len(payload) != header.length:
        raise DecodeError("payload length mismatch")
    if double_sha256(payload)[:4] != header.checksum:
        raise DecodeError(f"bad checksum for command {header.command}")
    typ = _MESSAGE_TYPES.get(header.command)
    if typ is None:
        return MsgOther(header.command, payload)
    r = Reader(payload)
    try:
        msg = typ.deserialize_payload(r)
    except ValueError as e:
        raise DecodeError(f"cannot decode {header.command}: {e}") from e
    return msg
