"""Peer session actor: one async task per connected peer.

Mirror of the reference's peer process (Node/Peer.hs):
frames and decodes the byte stream, publishes every inbound message as a
``PeerMessage`` event, accepts ``SendMessage``/``KillPeer`` commands through its
mailbox, and offers synchronous request helpers (``get_blocks``/``get_txs``/
``get_data``/``ping_peer``, reference Peer.hs:309-399) built on pub/sub-as-RPC
with the ping-sentinel trick.

The transport is injectable (the ``WithConnection`` seam, Peer.hs:112-117):
production uses TCP (node.py), tests use an in-memory duplex pipe —
this seam is what makes the whole node testable without a network.
"""

from __future__ import annotations

import asyncio
import logging
import random
from contextlib import AbstractAsyncContextManager
from dataclasses import dataclass
from typing import Callable, Optional, Protocol, Union

from .actors import Mailbox, Publisher, spawn_supervised
from .chaos import chaos
from .compat import timeout as _timeout
from .metrics import metrics
from .params import Network
from .trace import span
from .tracectx import _ACTIVE as _active_trace, tracer
from .wire import (
    Block,
    DecodeError,
    LazyBlock,
    LazyTx,
    InvType,
    InvVector,
    MAX_PAYLOAD,
    MsgBlock,
    MsgGetData,
    MsgNotFound,
    MsgPing,
    MsgPong,
    MsgTx,
    Tx,
    decode_message,
    decode_message_header,
    encode_message,
    HEADER_SIZE,
)

__all__ = [
    "Connection",
    "WithConnection",
    "ConnectionReader",
    "PeerError",
    "PeerMisbehaving",
    "DuplicateVersion",
    "DecodeHeaderError",
    "CannotDecodePayload",
    "PeerIsMyself",
    "PayloadTooLarge",
    "PeerAddressInvalid",
    "PeerSentBadHeaders",
    "NotNetworkPeer",
    "PeerNoSegWit",
    "PeerTimeout",
    "UnknownPeer",
    "PeerTooOld",
    "EmptyHeader",
    "Peer",
    "PeerConfig",
    "PeerConnected",
    "PeerDisconnected",
    "PeerMessage",
    "PeerEvent",
    "run_peer",
    "get_blocks",
    "get_txs",
    "get_data",
    "ping_peer",
]


class Connection(Protocol):
    """A byte-stream transport to one peer (the ``Conduits`` pair,
    reference Peer.hs:112-115)."""

    async def read_chunk(self) -> bytes:
        """Next chunk of inbound bytes; empty bytes means EOF."""
        ...

    async def write(self, data: bytes) -> None: ...


# A connection factory: entered per session, closes the transport on exit.
# (the ``WithConnection`` CPS connector, reference Peer.hs:117)
WithConnection = Callable[[], AbstractAsyncContextManager[Connection]]


# --- exceptions (reference Peer.hs:132-165) --------------------------------


class PeerError(Exception):
    """Base class for conditions that kill a peer session."""


class PeerMisbehaving(PeerError):
    pass


class DuplicateVersion(PeerError):
    pass


class DecodeHeaderError(PeerError):
    pass


class CannotDecodePayload(PeerError):
    pass


class PeerIsMyself(PeerError):
    pass


class PayloadTooLarge(PeerError):
    pass


class PeerAddressInvalid(PeerError):
    pass


class PeerSentBadHeaders(PeerError):
    pass


class NotNetworkPeer(PeerError):
    pass


class PeerNoSegWit(PeerError):
    pass


class PeerTimeout(PeerError):
    pass


class UnknownPeer(PeerError):
    pass


class PeerTooOld(PeerError):
    pass


class EmptyHeader(PeerError):
    pass


# --- peer handle & events ---------------------------------------------------


log = logging.getLogger("tpunode_torch.peer")

@dataclass(frozen=True)
class _SendMessage:
    message: object


@dataclass(frozen=True)
class _KillPeer:
    error: PeerError


class Peer:
    """Handle to a peer session: its mailbox, event bus, label and busy flag
    (reference Peer.hs:170-175).  Identity comparison, like the reference's
    mailbox equality."""

    # __weakref__: the task-supervision registry holds peers weakly as
    # the owners of their session's inbound/outbound loop tasks
    __slots__ = ("mailbox", "pub", "label", "_busy", "__weakref__")

    def __init__(self, mailbox: Mailbox, pub: "Publisher[PeerEvent]", label: str):
        self.mailbox = mailbox
        self.pub = pub
        self.label = label
        self._busy = False

    # busy-lock (reference Peer.hs:293-304): single-threaded event loop makes
    # the check-and-set atomic, the STM analog.
    def get_busy(self) -> bool:
        return self._busy

    def set_busy(self) -> bool:
        """Try to acquire; True iff we took the lock."""
        if self._busy:
            return False
        self._busy = True
        return True

    def set_free(self) -> None:
        self._busy = False

    def send_message(self, msg) -> None:
        """Queue a wire message for delivery (reference Peer.hs:290-291)."""
        self.mailbox.send(_SendMessage(msg))

    def kill(self, error: PeerError) -> None:
        """Ask the session to die with ``error`` (reference Peer.hs:286-287)."""
        log.debug("[Peer] %s: kill requested: %r", self.label, error)
        self.mailbox.send(_KillPeer(error))

    def __repr__(self) -> str:
        return f"<Peer {self.label}>"


@dataclass(frozen=True)
class PeerConnected:
    peer: Peer


@dataclass(frozen=True)
class PeerDisconnected:
    peer: Peer


@dataclass(frozen=True)
class PeerMessage:
    peer: Peer
    message: object


PeerEvent = Union[PeerConnected, PeerDisconnected, PeerMessage]


@dataclass
class PeerConfig:
    """Per-session configuration (reference Peer.hs:119-124)."""

    pub: Publisher
    net: Network
    label: str
    connect: WithConnection


class ConnectionReader:
    """Exact-read buffering over chunked transport reads."""

    def __init__(self, conn: Connection):
        self._conn = conn
        self._buf = bytearray()

    async def read_exact(self, n: int) -> bytes:
        """Read exactly n bytes; raises EmptyHeader on EOF at a message
        boundary, DecodeHeaderError on EOF mid-item (reference semantics of
        Peer.hs:256-268)."""
        while len(self._buf) < n:
            chunk = await self._conn.read_chunk()
            if not chunk:
                if not self._buf:
                    raise EmptyHeader("connection closed")
                raise DecodeHeaderError("connection closed mid-frame")
            self._buf.extend(chunk)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


# Message commands that open a per-item pipeline trace (tracectx): the
# payloads whose lifecycle spans actor hops and the verify engine.
_TRACED_COMMANDS = ("block", "tx", "headers")


async def _inbound_loop(cfg: PeerConfig, peer: Peer, conn: Connection) -> None:
    """Frame, decode and publish every message from the peer
    (the hot loop; reference ``inPeerConduit`` Peer.hs:247-279)."""
    reader = ConnectionReader(conn)
    while True:
        raw_header = await reader.read_exact(HEADER_SIZE)
        try:
            header = decode_message_header(cfg.net, raw_header)
        except DecodeError as e:
            raise DecodeHeaderError(str(e)) from e
        if header.length > MAX_PAYLOAD:
            raise PayloadTooLarge(f"{header.command}: {header.length}")
        # Block/tx/headers messages start a causal trace here — the first
        # point the item exists — so payload delivery, decode, actor hops
        # and verify phases all land in one tree.  Other commands keep the
        # untraced hot path (one `enabled` read, no allocation).
        tok = None
        if tracer.enabled and header.command in _TRACED_COMMANDS:
            tr = tracer.start(
                header.command, peer=cfg.label, bytes=header.length
            )
            tok = _active_trace.set((tr, tr.root.id))
        try:
            if tok is not None:
                with span("peer.payload"):
                    payload = (
                        await reader.read_exact(header.length)
                        if header.length
                        else b""
                    )
                try:
                    with span("peer.decode"):
                        msg = decode_message(cfg.net, header, payload)
                except DecodeError as e:
                    raise CannotDecodePayload(f"{header.command}: {e}") from e
            else:
                payload = (
                    await reader.read_exact(header.length)
                    if header.length
                    else b""
                )
                try:
                    msg = decode_message(cfg.net, header, payload)
                except DecodeError as e:
                    raise CannotDecodePayload(f"{header.command}: {e}") from e
            if not metrics.disabled:  # hot loop: one flag read when off
                metrics.inc_batch((  # one lock for all three
                    ("peer.msgs_in", 1.0, None),
                    ("peer.bytes_in", HEADER_SIZE + header.length, None),
                    ("peer.msgs", 1.0,
                     {"peer": cfg.label, "cmd": header.command}),
                ))
            if log.isEnabledFor(logging.DEBUG):  # hot loop: skip format cost
                log.debug(
                    "[Peer] %s: received %s (%d bytes)",
                    cfg.label,
                    header.command,
                    header.length,
                )
            cfg.pub.publish(PeerMessage(peer, msg))
        finally:
            if tok is not None:
                _active_trace.reset(tok)


async def _outbound_loop(cfg: PeerConfig, inbox: Mailbox, conn: Connection) -> None:
    """Drain the mailbox into the socket; ``_KillPeer`` raises
    (reference ``dispatchMessage`` Peer.hs:234-244)."""
    while True:
        item = await inbox.receive()
        if isinstance(item, _KillPeer):
            raise item.error
        data = encode_message(cfg.net, item.message)
        if not metrics.disabled:
            metrics.inc_batch((
                ("peer.msgs_out", 1.0, None),
                ("peer.bytes_out", len(data), None),
            ))
        await conn.write(data)


async def run_peer(cfg: PeerConfig, peer: Peer, inbox: Mailbox) -> None:
    """Run a peer session in the current task until it dies
    (reference ``peer`` Peer.hs:204-231).

    Opens the injected transport, then runs the inbound decode loop and the
    outbound mailbox loop linked together: either side failing (EOF, decode
    error, kill command) tears the session down.  Exceptions propagate to the
    supervisor, which the peer manager turns into ``PeerDied`` handling.
    """
    log.debug("[Peer] %s: session starting", cfg.label)
    async with cfg.connect() as conn:
        if chaos.on:  # fault injection on the transport (chaos.py)
            conn = chaos.wrap_connection(conn, cfg.label)
        # owner=peer: both loops are cancelled+awaited in the finally
        # below, but the registry still scopes them to this session so a
        # concurrent node's shutdown never misreads them as leaks
        t_in = spawn_supervised(
            _inbound_loop(cfg, peer, conn),
            name=f"peer-in-{cfg.label}", owner=peer,
        )
        t_out = spawn_supervised(
            _outbound_loop(cfg, inbox, conn),
            name=f"peer-out-{cfg.label}", owner=peer,
        )
        try:
            done, pending = await asyncio.wait(
                {t_in, t_out}, return_when=asyncio.FIRST_EXCEPTION
            )
        finally:
            for t in (t_in, t_out):
                t.cancel()
            await asyncio.gather(t_in, t_out, return_exceptions=True)
        for t in done:
            if not t.cancelled() and t.exception() is not None:
                log.debug(
                    "[Peer] %s: session ending: %s", cfg.label, t.exception()
                )
                raise t.exception()
        log.debug("[Peer] %s: session ended cleanly", cfg.label)


# --- synchronous request helpers -------------------------------------------


def _filter_peer(p: Peer):
    def select(ev: PeerEvent):
        if isinstance(ev, PeerMessage) and ev.peer is p:
            return ev.message
        return None

    return select


async def get_data(
    seconds: float, p: Peer, invs: list[InvVector]
) -> Optional[list[Union[Tx, Block]]]:
    """Request inventory and await the items in strict order.

    Implements the reference's pub/sub-as-RPC with a trailing ping sentinel
    (Peer.hs:349-387): subscribe first, send ``getdata`` then ``ping``; the
    matching ``pong`` bounds the wait because a peer answers requests in
    order.  Returns None on timeout, not-found, out-of-order or interleaved
    replies.
    """
    async with p.pub.subscription() as inbox:
        nonce = random.getrandbits(64)
        p.send_message(MsgGetData(tuple(invs)))
        p.send_message(MsgPing(nonce))
        select = _filter_peer(p)
        acc: list[Union[Tx, Block]] = []
        remaining = list(invs)
        try:
            async with _timeout(seconds):
                while remaining:
                    msg = await inbox.receive_match(select)
                    iv = remaining[0]
                    try:
                        tx_match = (
                            isinstance(msg, MsgTx)
                            and _is_tx_type(iv.type)
                            and msg.tx.txid == iv.hash
                        )
                    except ValueError:
                        # lazy tx whose payload does not parse: the eager
                        # decode used to kill the peer before we ever saw
                        # it; preserve the returns-None-on-garbage contract
                        return None
                    if tx_match:
                        acc.append(msg.tx)
                        remaining.pop(0)
                    elif (
                        isinstance(msg, MsgBlock)
                        and _is_block_type(iv.type)
                        and msg.block.header.hash == iv.hash
                    ):
                        acc.append(msg.block)
                        remaining.pop(0)
                    elif isinstance(msg, MsgNotFound) and (
                        {v.hash for v in msg.invs} & {v.hash for v in remaining}
                    ):
                        return None
                    elif isinstance(msg, MsgPong) and msg.nonce == nonce:
                        return None  # peer finished answering: incomplete
                    elif acc:
                        return None  # interleaved garbage mid-stream
        except TimeoutError:
            return None
        return acc


def _is_tx_type(t: int) -> bool:
    return t in (InvType.TX, InvType.WITNESS_TX)


def _is_block_type(t: int) -> bool:
    return t in (InvType.BLOCK, InvType.WITNESS_BLOCK)


async def get_blocks(
    net: Network, seconds: float, p: Peer, block_hashes: list[bytes]
) -> Optional[list["Block | LazyBlock"]]:
    """Fetch full blocks by hash (reference Peer.hs:309-324).  Wire-decoded
    blocks arrive as wire.LazyBlock (tx region unparsed until .txs)."""
    t = InvType.WITNESS_BLOCK if net.segwit else InvType.BLOCK
    out = await get_data(seconds, p, [InvVector(t, h) for h in block_hashes])
    if out is None or not all(isinstance(x, (Block, LazyBlock)) for x in out):
        return None
    return out  # type: ignore[return-value]


async def get_txs(
    net: Network, seconds: float, p: Peer, tx_hashes: list[bytes]
) -> Optional[list["Tx | LazyTx"]]:
    """Fetch transactions by txid (reference Peer.hs:329-344).  Wire-decoded
    txs arrive as wire.LazyTx (the txid match already parsed them)."""
    t = InvType.WITNESS_TX if net.segwit else InvType.TX
    out = await get_data(seconds, p, [InvVector(t, h) for h in tx_hashes])
    if out is None or not all(isinstance(x, (Tx, LazyTx)) for x in out):
        return None
    return out  # type: ignore[return-value]


async def ping_peer(seconds: float, p: Peer) -> bool:
    """Round-trip a ping; False on timeout (reference Peer.hs:391-399)."""
    async with p.pub.subscription() as inbox:
        nonce = random.getrandbits(64)
        p.send_message(MsgPing(nonce))

        def select(ev: PeerEvent):
            if (
                isinstance(ev, PeerMessage)
                and ev.peer is p
                and isinstance(ev.message, MsgPong)
                and ev.message.nonce == nonce
            ):
                return True
            return None

        try:
            async with _timeout(seconds):
                return await inbox.receive_match(select)
        except TimeoutError:
            return False
