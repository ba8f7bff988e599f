"""Peer manager: fleet lifecycle actor.

Mirror of Node/PeerMgr.hs: a connect loop keeps
``max_peers`` sessions alive from an address book (static peers + DNS seeds +
``addr`` gossip), every session runs under a supervisor whose death
notifications become ``PeerDied`` handling, the version/verack handshake state
machine marks peers online (``online = version AND verack``), pings track RTT
(last 11, median ranks peers), and jittered health checks evict stale or old
peers.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import random
import statistics
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from .actors import (
    LinkedTasks,
    Mailbox,
    Publisher,
    Supervisor,
    spawn_supervised,
)
from .events import events
from .metrics import metrics
from .params import NODE_NETWORK, PROTOCOL_VERSION, Network
from .peer import (
    CannotDecodePayload,
    DecodeHeaderError,
    DuplicateVersion,
    Peer,
    PeerConfig,
    PeerConnected,
    PeerDisconnected,
    PeerIsMyself,
    PeerMisbehaving,
    PeerSentBadHeaders,
    PeerTimeout,
    PeerTooOld,
    NotNetworkPeer,
    PayloadTooLarge,
    UnknownPeer,
    WithConnection,
    run_peer,
)
from .wire import MsgPing, MsgPong, MsgVerAck, MsgVersion, NetworkAddress

__all__ = [
    "PeerMgrConfig",
    "OnlinePeer",
    "PeerMgr",
    "PROTOCOL_VERSION",
    "build_version",
    "to_host_service",
    "to_sock_addr",
]

log = logging.getLogger("tpunode_torch.peermgr")

SockAddr = tuple[str, int]  # (host, port)

# Session-death causes that indicate peer misbehavior (vs. ordinary churn):
# these emit a ``peer.ban`` event so embedders doing reputation tracking
# see the protocol violation, not just a disconnect.
_BAN_ERRORS = (
    PeerMisbehaving,
    PeerSentBadHeaders,
    NotNetworkPeer,
    DuplicateVersion,
    PeerIsMyself,
    CannotDecodePayload,
    DecodeHeaderError,
    PayloadTooLarge,
)


@dataclass
class PeerMgrConfig:
    """Reference PeerMgr.hs:149-159."""

    max_peers: int
    peers: list[str]
    discover: bool
    address: NetworkAddress
    net: Network
    pub: Publisher
    timeout: float
    max_peer_life: float
    # injectable transport: SockAddr -> WithConnection (reference Node.hs:95)
    connect: Callable[[SockAddr], WithConnection]
    # -- fleet hardening ------------------------------------------
    # Per-address dial backoff: decorrelated jitter
    # (next = min(cap, uniform(base, 3 * prev))), reset on a completed
    # handshake — a dead or flapping address cannot monopolize dial slots.
    dial_backoff_base: float = 0.5
    dial_backoff_cap: float = 30.0
    # Misbehavior-score escalation: each protocol-violation death (the
    # _BAN_ERRORS classes) bumps the address's score and bans it for
    # min(ban_cap, ban_base * 2**(score-1)) seconds — timed bans, not
    # one-shot kills, so a garbage-spewing peer stays gone for a while
    # but a once-glitchy one gets another chance.
    ban_base: float = 10.0
    ban_cap: float = 600.0
    # Reconnect-storm cap: at most `reconnect_burst` dials per
    # `reconnect_window` seconds; excess dials are deferred back into the
    # address book.  0 = auto (max(8, 2 * max_peers)); negative disables.
    reconnect_burst: int = 0
    reconnect_window: float = 1.0


@dataclass
class _AddrState:
    """Per-address dial/ban bookkeeping.  The
    reference evicts misbehavers one-shot (PeerMgr.hs kills and forgets);
    here an address carries its dial backoff and misbehavior score across
    sessions so churn and garbage degrade that address's slot, not the
    fleet's."""

    backoff: float = 0.0  # current decorrelated-jitter backoff (seconds)
    not_before: float = 0.0  # monotonic: no dial before this
    failures: int = 0  # consecutive session deaths (reset on handshake)
    score: int = 0  # misbehavior incidents (never auto-reset)
    banned_until: float = 0.0  # monotonic: timed ban horizon


@dataclass
class OnlinePeer:
    """Book-keeping for one connected peer (reference PeerMgr.hs:183-195)."""

    address: SockAddr
    peer: Peer
    task: asyncio.Task
    nonce: int
    connected: float
    tickled: float
    verack: bool = False
    online: bool = False
    version: Optional[MsgVersion] = None
    ping: Optional[tuple[float, int]] = None  # (sent monotonic, nonce)
    pings: list[float] = field(default_factory=list)

    def median_ping(self) -> float:
        """Peers are ranked by median RTT; unknown = 60s
        (reference PeerMgr.hs:202-205,833-843)."""
        if not self.pings:
            return 60.0
        return statistics.median(self.pings)


# internal mailbox messages (reference PeerMgrMessage PeerMgr.hs:170-180)
@dataclass(frozen=True)
class _Connect:
    addr: SockAddr


@dataclass(frozen=True)
class _CheckPeer:
    peer: Peer


@dataclass(frozen=True)
class _PeerDied:
    task: asyncio.Task
    error: Optional[BaseException]


@dataclass(frozen=True)
class _ManagerBest:
    height: int


@dataclass(frozen=True)
class _PeerVersion:
    peer: Peer
    version: MsgVersion


@dataclass(frozen=True)
class _PeerVerAck:
    peer: Peer


@dataclass(frozen=True)
class _PeerPing:
    peer: Peer
    nonce: int


@dataclass(frozen=True)
class _PeerPong:
    peer: Peer
    nonce: int


@dataclass(frozen=True)
class _PeerAddrs:
    peer: Peer
    addrs: list[NetworkAddress]


@dataclass(frozen=True)
class _PeerTickle:
    peer: Peer


class PeerMgr:
    """The peer-manager actor handle (reference ``PeerMgr`` PeerMgr.hs:161-168
    + ``withPeerMgr`` PeerMgr.hs:207-234)."""

    def __init__(self, cfg: PeerMgrConfig, on_failure=None):
        self.cfg = cfg
        self.mailbox: Mailbox = Mailbox(name="peermgr")
        self.supervisor = Supervisor(on_death=self._peer_died, name="peers")
        self._best_height = 0
        self._addresses: set[SockAddr] = set()
        self._peers: list[OnlinePeer] = []
        # per-address backoff/ban state + the dial-rate window
        self._addr_state: dict[SockAddr, _AddrState] = {}
        self._dial_times: deque[float] = deque()
        self._burst: Optional[int] = (
            None
            if cfg.reconnect_burst < 0
            else (cfg.reconnect_burst or max(8, 2 * cfg.max_peers))
        )
        self._tasks = LinkedTasks(name="peermgr", on_failure=on_failure)
        self._started = asyncio.Event()

    # -- lifecycle ----------------------------------------------------------

    async def __aenter__(self) -> "PeerMgr":
        self._tasks.link(self._main_loop(), name="peermgr-main")
        self._tasks.link(self._connect_loop(), name="peermgr-connect")
        return self

    async def __aexit__(self, *exc) -> None:
        await self.supervisor.aclose()
        await self._tasks.__aexit__(*exc)

    def _peer_died(self, task: asyncio.Task, exc: Optional[BaseException]) -> None:
        # supervisor Notify -> PeerDied message (reference PeerMgr.hs:230)
        self.mailbox.send(_PeerDied(task, exc))

    async def _main_loop(self) -> None:
        # Block until the chain's initial best height arrives — the startup
        # ordering constraint of the reference (PeerMgr.hs:244-247).
        height = await self.mailbox.receive_match(
            lambda m: m.height if isinstance(m, _ManagerBest) else None
        )
        self._best_height = height
        self._started.set()
        while True:
            msg = await self.mailbox.receive()
            await self._dispatch(msg)

    async def _connect_loop(self) -> None:
        """Jittered top-up loop (reference ``withConnectLoop``
        PeerMgr.hs:606-625)."""
        await self._started.wait()
        while True:
            if len(self._peers) < self.cfg.max_peers:
                sa = await self._get_new_peer()
                if sa is not None:
                    self.mailbox.send(_Connect(sa))
            await asyncio.sleep(random.uniform(0.1, 5.0))

    # -- dispatch (reference PeerMgr.hs:304-396) -----------------------------

    async def _dispatch(self, msg) -> None:
        if isinstance(msg, _PeerVersion):
            self._on_version(msg.peer, msg.version)
        elif isinstance(msg, _PeerVerAck):
            self._on_verack(msg.peer)
        elif isinstance(msg, _PeerAddrs):
            self._on_addrs(msg.addrs)
        elif isinstance(msg, _PeerPong):
            self._on_pong(msg.peer, msg.nonce)
        elif isinstance(msg, _PeerPing):
            msg.peer.send_message(MsgPong(msg.nonce))
        elif isinstance(msg, _ManagerBest):
            self._best_height = msg.height
        elif isinstance(msg, _Connect):
            self._connect_peer(msg.addr)
        elif isinstance(msg, _PeerDied):
            self._process_peer_offline(msg.task)
        elif isinstance(msg, _CheckPeer):
            self._check_peer(msg.peer)
        elif isinstance(msg, _PeerTickle):
            o = self._find_peer(msg.peer)
            if o is not None:
                o.tickled = time.monotonic()

    def _on_version(self, p: Peer, v: MsgVersion) -> None:
        """Handshake step 1 (reference ``dispatch (PeerVersion ...)``
        PeerMgr.hs:311-329 + ``setPeerVersion`` :654-674)."""
        if v.services & NODE_NETWORK == 0:
            log.warning(
                "[PeerMgr] peer %s lacks network service bit; killing", p.label
            )
            events.emit(
                "peer.handshake", peer=p.label, ok=False,
                reason="not-network-peer",
            )
            p.kill(NotNetworkPeer(p.label))
            return
        if any(o.nonce == v.nonce for o in self._peers):
            log.warning("[PeerMgr] peer %s is myself (nonce match); killing", p.label)
            events.emit(
                "peer.handshake", peer=p.label, ok=False, reason="is-myself"
            )
            p.kill(PeerIsMyself(p.label))
            return
        o = self._find_peer(p)
        if o is None:
            p.kill(UnknownPeer(p.label))
            return
        log.debug(
            "[PeerMgr] version from %s: %d %s height=%d",
            p.label,
            v.version,
            v.user_agent.decode("latin-1"),
            v.start_height,
        )
        o.version = v
        o.online = o.verack
        p.send_message(MsgVerAck())
        if o.online:
            self._announce_peer(o)

    def _on_verack(self, p: Peer) -> None:
        """Handshake step 2 (reference PeerMgr.hs:330-343 + ``setPeerVerAck``
        :676-685)."""
        o = self._find_peer(p)
        if o is None:
            p.kill(UnknownPeer(p.label))
            return
        o.verack = True
        o.online = o.version is not None
        if o.online:
            self._announce_peer(o)

    def _announce_peer(self, o: OnlinePeer) -> None:
        # reference logConnectedPeers (PeerMgr.hs:285-290)
        st = self._addr_state.get(o.address)
        if st is not None:
            # success reset: a completed handshake clears the
            # dial backoff — misbehavior score deliberately persists
            st.backoff = 0.0
            st.not_before = 0.0
            st.failures = 0
        n_online = sum(1 for x in self._peers if x.online)
        log.info(
            "[PeerMgr] connected to peer %s (%d online)", o.peer.label, n_online
        )
        dial = time.monotonic() - o.connected
        metrics.observe("peermgr.dial_seconds", dial)
        metrics.set_gauge("peermgr.peers_online", n_online)
        v = o.version
        events.emit(
            "peer.handshake", peer=o.peer.label, ok=True,
            version=v.version if v else None,
            user_agent=v.user_agent.decode("latin-1") if v else None,
            height=v.start_height if v else None,
            dial_seconds=round(dial, 6),
        )
        events.emit("peer.connect", peer=o.peer.label, online=n_online)
        self.cfg.pub.publish(PeerConnected(o.peer))

    def _on_addrs(self, addrs: list[NetworkAddress]) -> None:
        """``addr`` gossip ingestion when discovery is on
        (reference PeerMgr.hs:344-360)."""
        if not self.cfg.discover:
            return
        log.debug("[PeerMgr] received %d addresses via gossip", len(addrs))
        for na in addrs:
            self._new_peer(na.to_host_port())

    def _on_pong(self, p: Peer, nonce: int) -> None:
        """RTT sample (reference ``gotPong`` PeerMgr.hs:636-648)."""
        o = self._find_peer(p)
        if o is None or o.ping is None:
            return
        sent, expected = o.ping
        if nonce != expected:
            return
        o.ping = None
        rtt = time.monotonic() - sent
        metrics.observe("peer.rtt", rtt)
        metrics.observe("peer.rtt", rtt, labels={"peer": o.peer.label})
        # newest 11 samples (reference keeps `take 11 $ diff : pings`)
        o.pings = ([rtt] + o.pings)[:11]

    def _check_peer(self, p: Peer) -> None:
        """Health check: lifetime eviction + tickle/ping staleness
        (reference ``checkPeer`` PeerMgr.hs:398-425)."""
        o = self._find_peer(p)
        if o is None:
            return
        now = time.monotonic()
        if now > o.connected + self.cfg.max_peer_life:
            log.info("[PeerMgr] peer %s exceeded max life; evicting", p.label)
            p.kill(PeerTooOld(p.label))
            return
        if now > o.tickled + self.cfg.timeout:
            if o.ping is None:
                log.debug("[PeerMgr] peer %s quiet; pinging", p.label)
                self._send_ping(o)
            else:
                log.warning("[PeerMgr] peer %s unresponsive; killing", p.label)
                p.kill(PeerTimeout(p.label))

    def _send_ping(self, o: OnlinePeer) -> None:
        if not o.online:
            return
        nonce = random.getrandbits(64)
        o.ping = (time.monotonic(), nonce)
        o.peer.send_message(MsgPing(nonce))

    def _process_peer_offline(self, task: asyncio.Task) -> None:
        """Peer task ended (reference ``processPeerOffline``
        PeerMgr.hs:447-487)."""
        o = next((x for x in self._peers if x.task is task), None)
        if o is None:
            return
        exc = task.exception() if task.done() and not task.cancelled() else None
        log.info(
            "[PeerMgr] peer %s offline%s (%d online)",
            o.peer.label,
            f": {exc}" if exc else "",
            sum(1 for x in self._peers if x.online) - (1 if o.online else 0),
        )
        metrics.inc("peermgr.disconnects")
        if not o.online:
            # died before completing the handshake: a failed dial
            metrics.inc("peermgr.connect_failures")
        events.emit(
            "peer.disconnect", peer=o.peer.label, online=o.online,
            error=repr(exc) if exc else None,
        )
        now = time.monotonic()
        st = self._addr_state.setdefault(o.address, _AddrState())
        # Dial backoff with decorrelated jitter: every session
        # death backs the address off; repeated failures grow the window
        # up to the cap, a completed handshake resets it (_announce_peer).
        st.failures += 1
        st.backoff = min(
            self.cfg.dial_backoff_cap,
            random.uniform(
                self.cfg.dial_backoff_base,
                max(self.cfg.dial_backoff_base, 3.0 * st.backoff),
            ),
        )
        st.not_before = now + st.backoff
        metrics.inc("peermgr.backoffs")
        metrics.observe("peermgr.backoff_seconds", st.backoff)
        events.emit(
            "peermgr.backoff", peer=o.peer.label,
            seconds=round(st.backoff, 3), failures=st.failures,
        )
        if isinstance(exc, _BAN_ERRORS):
            # Misbehavior-score escalation to a TIMED ban: the
            # address sits out min(cap, base * 2**(score-1)) seconds —
            # repeat offenders sit out exponentially longer.
            st.score += 1
            ban = min(
                self.cfg.ban_cap,
                self.cfg.ban_base * (2.0 ** min(st.score - 1, 16)),
            )
            st.banned_until = now + ban
            metrics.inc("peermgr.bans")
            metrics.inc("peermgr.timed_bans")
            events.emit(
                "peer.ban", peer=o.peer.label,
                reason=type(exc).__name__, error=str(exc),
                ban_seconds=round(ban, 1), score=st.score,
            )
        if o.online:
            self.cfg.pub.publish(PeerDisconnected(o.peer))
        self._peers.remove(o)
        # the address returns to the book behind its backoff/ban horizon
        # (gossip addresses used to vanish on death; static peers were
        # re-resolved anyway)
        self._addresses.add(o.address)
        # evict the dead peer's labeled series (peer.msgs{peer=},
        # peer.rtt{peer=}): churn through thousands of addresses must not
        # grow the registry without bound
        metrics.drop_label("peer", o.peer.label)
        metrics.set_gauge("peermgr.peers", len(self._peers))
        metrics.set_gauge(
            "peermgr.peers_online", sum(1 for x in self._peers if x.online)
        )

    # -- address book & connecting ------------------------------------------

    async def _load_peers(self) -> None:
        """Static peers + DNS seeds (reference PeerMgr.hs:266-283)."""
        for s in self.cfg.peers:
            for sa in await to_sock_addr(self.cfg.net, s):
                self._new_peer(sa)
        if self.cfg.discover:
            for seed in self.cfg.net.seeds:
                for sa in await to_sock_addr(self.cfg.net, seed):
                    self._new_peer(sa)

    def _new_peer(self, sa: SockAddr) -> None:
        """Add a candidate address unless already connected
        (reference ``newPeer`` PeerMgr.hs:627-634)."""
        if any(o.address == sa for o in self._peers):
            return
        self._addresses.add(sa)

    def _dialable(self, sa: SockAddr, now: float) -> bool:
        """Is this address past its backoff and ban horizons?"""
        st = self._addr_state.get(sa)
        return st is None or (now >= st.not_before and now >= st.banned_until)

    async def _get_new_peer(self) -> Optional[SockAddr]:
        """Random unconnected candidate (reference ``getNewPeer``
        PeerMgr.hs:505-520), skipping addresses still backing off or
        serving a timed ban — those stay in the book for later."""
        await self._load_peers()
        now = time.monotonic()
        eligible = [sa for sa in self._addresses if self._dialable(sa, now)]
        while eligible:
            sa = random.choice(eligible)
            eligible.remove(sa)
            self._addresses.discard(sa)
            if not any(o.address == sa for o in self._peers):
                return sa
        return None

    # Address-state pruning bound: churn through thousands of gossip
    # addresses must not grow _addr_state without limit (the same
    # discipline as metrics.drop_label on peer churn).
    _ADDR_STATE_MAX = 4096

    def _prune_addr_state(self, now: float) -> None:
        if len(self._addr_state) <= self._ADDR_STATE_MAX:
            return
        for sa in [
            sa
            for sa, st in self._addr_state.items()
            if now >= st.not_before and now >= st.banned_until
            and st.score == 0
        ]:
            del self._addr_state[sa]

    def _connect_peer(self, sa: SockAddr) -> None:
        """Launch one supervised peer session (reference ``connectPeer``
        PeerMgr.hs:522-589)."""
        if any(o.address == sa for o in self._peers):
            return
        now = time.monotonic()
        if self._burst is not None:
            # Reconnect-storm cap: a mass disconnect (network
            # blip, remote restart) must not translate into an immediate
            # synchronized dial storm.  Excess dials defer back into the
            # address book behind a one-window not_before.
            while (
                self._dial_times
                and now - self._dial_times[0] > self.cfg.reconnect_window
            ):
                self._dial_times.popleft()
            if len(self._dial_times) >= self._burst:
                metrics.inc("peermgr.reconnects_capped")
                events.emit(
                    "peermgr.reconnect_capped",
                    address=f"{sa[0]}:{sa[1]}",
                    burst=self._burst,
                    window=self.cfg.reconnect_window,
                )
                st = self._addr_state.setdefault(sa, _AddrState())
                st.not_before = max(
                    st.not_before, now + self.cfg.reconnect_window
                )
                self._addresses.add(sa)
                return
            self._dial_times.append(now)
        self._prune_addr_state(now)
        label = f"[{sa[0]}]:{sa[1]}" if ":" in sa[0] else f"{sa[0]}:{sa[1]}"
        log.debug("[PeerMgr] connecting to %s", label)
        metrics.inc("peermgr.connect_attempts")
        nonce = random.getrandbits(64)
        inbox: Mailbox = Mailbox(name=f"peer-{label}")
        pc = PeerConfig(
            pub=self.cfg.pub,
            net=self.cfg.net,
            label=label,
            connect=self.cfg.connect(sa),
        )
        p = Peer(inbox, self.cfg.pub, label)
        task = self.supervisor.add_child(
            self._launch_peer(pc, p, inbox), name=f"peer-{label}"
        )
        # We speak first (reference PeerMgr.hs:564).
        ver = build_version(
            self.cfg.net,
            nonce,
            self._best_height,
            self.cfg.address,
            NetworkAddress.from_host_port(sa[0], sa[1], services=_srv(self.cfg.net)),
        )
        p.send_message(ver)
        now = time.monotonic()
        self._peers.append(
            OnlinePeer(
                address=sa,
                peer=p,
                task=task,
                nonce=nonce,
                connected=now,
                tickled=now,
            )
        )
        metrics.set_gauge("peermgr.peers", len(self._peers))

    async def _launch_peer(self, pc: PeerConfig, p: Peer, inbox: Mailbox) -> None:
        """Child body: the session linked with its jittered check timer
        (reference ``launch``/``withPeerLoop`` PeerMgr.hs:586-604)."""

        async def check_loop():
            while True:
                await asyncio.sleep(
                    random.uniform(0.75, 1.0) * self.cfg.timeout
                )
                self.mailbox.send(_CheckPeer(p))

        # the jittered check timer is registry-supervised, and
        # cancelled+awaited on session exit
        timer = spawn_supervised(
            check_loop(), name=f"peer-check-{p.label}", owner=self.supervisor
        )
        try:
            await run_peer(pc, p, inbox)
        finally:
            timer.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await timer

    # -- event injectors (reference PeerMgr.hs:738-796) ----------------------

    def set_best(self, height: int) -> None:
        self.mailbox.send(_ManagerBest(height))

    def version(self, p: Peer, v: MsgVersion) -> None:
        self.mailbox.send(_PeerVersion(p, v))

    def verack(self, p: Peer) -> None:
        self.mailbox.send(_PeerVerAck(p))

    def ping(self, p: Peer, nonce: int) -> None:
        self.mailbox.send(_PeerPing(p, nonce))

    def pong(self, p: Peer, nonce: int) -> None:
        self.mailbox.send(_PeerPong(p, nonce))

    def addrs(self, p: Peer, addrs: list[NetworkAddress]) -> None:
        self.mailbox.send(_PeerAddrs(p, addrs))

    def tickle(self, p: Peer) -> None:
        self.mailbox.send(_PeerTickle(p))

    def connect(self, sa: SockAddr) -> None:
        self.mailbox.send(_Connect(sa))

    # -- queries (reference PeerMgr.hs:727-736) ------------------------------

    def _find_peer(self, p: Peer) -> Optional[OnlinePeer]:
        return next((o for o in self._peers if o.peer is p), None)

    def get_peers(self) -> list[OnlinePeer]:
        """Connected peers, best (lowest median RTT) first."""
        return sorted(
            (o for o in self._peers if o.online), key=OnlinePeer.median_ping
        )

    def fleet(self) -> list[OnlinePeer]:
        """Every tracked peer, online or mid-handshake (telemetry view)."""
        return list(self._peers)

    def get_online_peer(self, p: Peer) -> Optional[OnlinePeer]:
        return self._find_peer(p)

    def backoff_stats(self) -> dict:
        """Fleet-hardening snapshot for Node.stats(): how many
        addresses are backing off or banned right now, plus the lifetime
        escalation counters."""
        now = time.monotonic()
        sts = self._addr_state.values()
        return {
            "addresses": len(self._addresses),
            "tracked": len(self._addr_state),
            "backing_off": sum(1 for s in sts if s.not_before > now),
            "banned": sum(1 for s in sts if s.banned_until > now),
            "backoffs": metrics.get("peermgr.backoffs"),
            "timed_bans": metrics.get("peermgr.timed_bans"),
            "capped_dials": metrics.get("peermgr.reconnects_capped"),
        }


def _srv(net: Network) -> int:
    # segwit service bit on networks that have it (reference PeerMgr.hs:583-585)
    return 8 if net.segwit else 0


def build_version(
    net: Network,
    nonce: int,
    height: int,
    local: NetworkAddress,
    remote: NetworkAddress,
    timestamp: Optional[int] = None,
) -> MsgVersion:
    """Build our ``version`` message (reference ``buildVersion``
    PeerMgr.hs:845-864)."""
    return MsgVersion(
        version=PROTOCOL_VERSION,
        services=local.services,
        timestamp=int(time.time()) if timestamp is None else timestamp,
        addr_recv=remote,
        addr_from=local,
        nonce=nonce,
        user_agent=net.user_agent.encode(),
        start_height=height,
        relay=True,
    )


def to_host_service(s: str) -> tuple[Optional[str], Optional[str]]:
    """Split "host", "host:port", "[v6]", "[v6]:port" (reference
    ``toHostService`` PeerMgr.hs:798-820)."""
    host: Optional[str]
    srv: Optional[str]
    if s.startswith("["):
        end = s.find("]")
        if end == -1:
            return None, None
        host = s[1:end] or None
        rest = s[end + 1 :]
        srv = rest[1:] if rest.startswith(":") else None
        return host, srv or None
    if s.startswith(":"):
        # leading colon: an IPv6 literal like "::1" (reference PeerMgr.hs:817)
        return s, None
    if ":" in s and s.count(":") > 1:
        # raw IPv6 literal without brackets
        return s, None
    head, sep, tail = s.partition(":")
    host = head or None
    srv = tail if sep else None
    return host, srv or None


async def to_sock_addr(net: Network, s: str) -> list[SockAddr]:
    """Resolve a peer string to socket addresses, filling the network default
    port (reference ``toSockAddr`` PeerMgr.hs:822-831)."""
    host, srv = to_host_service(s)
    if host is None:
        return []
    port = int(srv) if srv and srv.isdigit() else None
    if port is None:
        port = net.default_port
    try:
        loop = asyncio.get_running_loop()
        infos = await loop.getaddrinfo(host, port)
        out = []
        for _, _, _, _, sockaddr in infos:
            sa = (sockaddr[0], sockaddr[1])
            if sa not in out:
                out.append(sa)
        return out
    except OSError:
        return []
