"""Mempool actor: the unconfirmed-transaction lifecycle in front of the
batch verify engine.

The reference haskoin-node drops every ``inv`` on the floor and never
deduplicates transaction pushes — each of N peers relaying the same tx
costs a full extract + verify.  For a node whose distinguishing feature
is the batch verify hot path on the card, ingest dedup and admission
ARE the workload shape: batch slots spent re-verifying known txs are
stolen straight from the device.  This actor owns:

* **Inv-driven relay** — ``inv`` tx announcements are coalesced across
  peers into a want-list; unseen txids are fetched in batches over the
  existing ``peer.get_txs`` RPC with per-peer in-flight limits, and a
  failed/notfound/stalled fetch is retried from another announcer (the
  prefetch-with-reassignment shape).
* **Admission dedup** — a bounded seen/verdict LRU keyed by txid (with a
  wtxid alias for witness serializations, so the fast-path key is one
  double-SHA over the raw bytes, no parse) short-circuits duplicate
  pushes BEFORE the verify pipeline; each unique tx is extracted and
  verified exactly once, and a re-push or re-announcement of a
  known-invalid tx costs zero verify work and feeds a per-peer
  misbehavior count.
* **Orphan pool** — a tx whose witness-bearing inputs spend unknown
  prevouts (not in the mempool, not resolvable via the embedder's
  ``NodeConfig.prevout_lookup`` oracle) would verify degraded
  (unsupported inputs), so it parks in a size- and age-bounded orphan
  set and re-enters admission when its parent arrives (push, fetch or
  block).  Parked orphans' missing parents join the want-list — the
  relaying peer likely has them.  An orphan leaving the pool
  unresolved — aged out or size-evicted — is admitted anyway
  (verify-what's-extractable — the pre-mempool behavior) so the
  embedder still gets a verdict; size pressure never loses one.
* **Confirmation eviction** — block connect (txids from the block
  ingest path, C++-computed on the native path) flips entries to
  CONFIRMED, drops their payloads, and re-checks waiting orphans.
* **Backpressure** — fetch scheduling defers while the node's ingest
  accumulator is saturated (``VerifyShed``/``MAX_TX_ACCUM`` machinery in
  node.py), so a flooding peer degrades into a stale want-list instead
  of unbounded memory.

Single-threaded like chain.py/peermgr.py: all state mutation happens in
the actor loop; the handle methods only enqueue mailbox messages.
Everything is instrumented under the ``mempool.*`` metric/event layer
(OBSERVABILITY.md) and the admission path is spanned
(``span.mempool.admit``) so a benchmark can report admission p50/p99.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional

from .actors import LinkedTasks, Mailbox, Supervisor
from .events import events
from .metrics import metrics
from .params import Network
from .peer import CannotDecodePayload, Peer, get_txs
from .seenlru import SeenLru
from .trace import span
from .tracectx import discard_active as _discard_active_trace
from .txverify import needs_prevout
from .util import double_sha256, hash_to_hex

__all__ = ["MempoolConfig", "Mempool", "TxState"]

log = logging.getLogger("tpunode_torch.mempool")


class TxState:
    """Lifecycle states of a seen txid."""

    PENDING = "pending"  # admitted, verdict not yet published
    VALID = "valid"  # verified: every extracted signature passed
    INVALID = "invalid"  # verified: at least one signature failed
    CONFIRMED = "confirmed"  # seen in a connected block
    ORPHAN = "orphan"  # parked: waiting for missing parents


@dataclass
class MempoolConfig:
    """Bounds and cadences for the mempool actor.  Every bound exists so
    a hostile or flooding peer degrades service instead of growing
    memory (the same policy as the bounded user bus, actors.py)."""

    # seen/verdict LRU: unique txids remembered for dedup + verdict cache
    max_txs: int = 50_000
    # orphan pool size bound (evict-oldest) and age bound; either way
    # out, the orphan is admitted degraded instead of silently dropped
    max_orphans: int = 1_000
    orphan_ttl: float = 600.0
    # want-list bound: announced-but-unfetched txids, and how long one
    # may sit unfetched (announcers pinned at their in-flight cap, or
    # stalling) before its slot is reclaimed
    max_wanted: int = 50_000
    want_ttl: float = 120.0
    # fetch scheduler: txids per getdata batch, concurrent batches per
    # peer, per-batch timeout, and how many announcers to try per txid
    fetch_batch: int = 256
    max_inflight_per_peer: int = 2
    fetch_timeout: float = 30.0
    fetch_retries: int = 3
    # housekeeping cadence (orphan expiry, deferred fetch scheduling)
    tick_interval: float = 1.0


class _Entry:
    """One seen txid: state + (while useful) the tx and its outputs."""

    __slots__ = ("txid", "wtxid", "state", "tx", "outputs", "origin",
                 "missing", "added", "verdicts")

    def __init__(self, txid: bytes, wtxid: bytes, state: str, tx=None,
                 outputs=None, origin: str = "?"):
        self.txid = txid
        self.wtxid = wtxid
        self.state = state
        self.tx = tx
        # tuple of (value, scriptPubKey) rows: the in-mempool prevout
        # oracle for children (and the orphan-resolvability check)
        self.outputs = outputs
        self.origin = origin  # label of the peer that delivered it
        self.missing: Optional[set[bytes]] = None  # ORPHAN: parent txids
        self.added = time.monotonic()
        self.verdicts: tuple[bool, ...] = ()


class _Want:
    """One announced-but-not-yet-delivered txid."""

    __slots__ = ("announcers", "tried", "inflight", "attempts", "added")

    def __init__(self, announcer: Optional[Peer]):
        self.announcers: list[Peer] = [announcer] if announcer else []
        self.tried: set[Peer] = set()
        self.inflight: Optional[Peer] = None
        self.attempts = 0
        self.added = time.monotonic()


# --- mailbox messages --------------------------------------------------------


@dataclass(frozen=True)
class _TxPush:
    peer: object
    tx: object


@dataclass(frozen=True)
class _Invs:
    peer: object
    txids: tuple


@dataclass(frozen=True)
class _Verdict:
    txid: bytes
    valid: bool
    verdicts: tuple
    error: Optional[str]


@dataclass(frozen=True)
class _Confirmed:
    txids: tuple


@dataclass(frozen=True)
class _ConfirmedBlock:
    block: object


@dataclass(frozen=True)
class _PeerGone:
    peer: object


@dataclass(frozen=True)
class _FetchDone:
    peer: object
    txids: tuple
    ok: bool


class _Tick:
    pass


class _Sched:
    """Deferred scheduling marker: posted to the mailbox tail so a burst
    of inv/fetch-done messages triggers ONE want-list scan after the
    burst drains, not one full scan per message."""


def _label(peer) -> str:
    lab = getattr(peer, "label", None)
    return lab if isinstance(lab, str) else f"<{type(peer).__name__}>"


def _bump_label(counter: "dict[str, int]", label: str, n: int = 1,
                bound: int = 512) -> None:
    """Per-label counter bounded against label churn: past ``bound``
    distinct labels, the smallest count is evicted (flooders keep their
    standing, one-shot labels age out)."""
    counter[label] = counter.get(label, 0) + n
    if len(counter) > bound:
        counter.pop(min(counter, key=counter.get))


class Mempool:
    """The mempool actor handle + query API.

    ``submit(peer, tx)`` is the verify-ingest hook (node.py's
    ``_submit_verify_tx``); ``prevout_lookup`` is the embedder's UTXO
    oracle (NodeConfig.prevout_lookup); ``pressure()`` true defers fetch
    scheduling (ingest backpressure).
    Like Chain/PeerMgr, constructed by Node and entered inside the node
    bracket."""

    def __init__(
        self,
        cfg: MempoolConfig,
        net: Network,
        submit: Callable[[object, object], None],
        prevout_lookup: Optional[Callable] = None,
        pressure: Optional[Callable[[], bool]] = None,
        on_failure=None,
    ):
        self.cfg = cfg
        self.net = net
        self._submit = submit
        self._oracle = prevout_lookup
        self._pressure = pressure
        self.mailbox: Mailbox = Mailbox(name="mempool")
        self._tasks = LinkedTasks(name="mempool", on_failure=on_failure)
        # fetch tasks are crash-isolated: one failed getdata RPC must
        # never tear the node down (death is handled via _FetchDone)
        self._fetchers = Supervisor(name="mempool-fetch")
        # seen/verdict LRU (extracted structure: seenlru.py) — keyed by
        # txid with a wtxid alias; PENDING entries are pinned (verdict
        # in flight: a re-push would double-verify) up to the hard 2x
        # ceiling the structure enforces
        self._seen: SeenLru = SeenLru(
            cfg.max_txs, pinned=lambda e: e.state == TxState.PENDING
        )
        self._orphans: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._waiting: dict[bytes, set[bytes]] = {}  # parent -> orphans
        self._want: "OrderedDict[bytes, _Want]" = OrderedDict()
        self._inflight: dict[Peer, int] = {}
        self._sched_queued = False  # a _Sched marker is in the mailbox
        self._size = 0  # PENDING + VALID entries
        self._announcers: dict[str, int] = {}  # label -> announcements
        self._misbehavior: dict[str, int] = {}  # label -> incidents
        # stats() counters: instance-owned (the metrics registry is
        # process-global and cumulative — a second Node in the same
        # process must not inherit the first one's hit-rate)
        self._admitted = 0
        self._dedup_hits = 0
        self._orphan_resolved = 0
        self._fetched = 0
        self._fetch_failures = 0

    # -- lifecycle ----------------------------------------------------------

    async def __aenter__(self) -> "Mempool":
        self._tasks.link(self._main_loop(), name="mempool-main")
        if self.cfg.tick_interval > 0:
            self._tasks.link(self._tick_loop(), name="mempool-tick")
        return self

    async def __aexit__(self, *exc) -> None:
        await self._fetchers.aclose()
        await self._tasks.__aexit__(*exc)

    async def _main_loop(self) -> None:
        while True:
            msg = await self.mailbox.receive()
            if isinstance(msg, _TxPush):
                with span("mempool.admit"):
                    self._on_push(msg.peer, msg.tx)
            elif isinstance(msg, _Invs):
                self._on_invs(msg.peer, msg.txids)
            elif isinstance(msg, _Verdict):
                self._on_verdict(msg)
            elif isinstance(msg, _Confirmed):
                self._on_confirmed(msg.txids)
            elif isinstance(msg, _ConfirmedBlock):
                self._on_confirmed_block(msg.block)
            elif isinstance(msg, _FetchDone):
                self._on_fetch_done(msg.peer, msg.txids, msg.ok)
            elif isinstance(msg, _PeerGone):
                self._on_peer_gone(msg.peer)
            elif isinstance(msg, _Tick):
                self._on_tick()
            elif isinstance(msg, _Sched):
                self._sched_queued = False
                self._schedule()

    async def _tick_loop(self) -> None:
        while True:
            await asyncio.sleep(self.cfg.tick_interval)
            self.mailbox.send(_Tick())

    # -- handle methods (enqueue only; any-thread unsafe like the other
    #    actors: call from the event loop) -----------------------------------

    def tx_pushed(self, peer, tx) -> None:
        """An unsolicited (or fetched) ``tx`` message arrived from peer."""
        self.mailbox.send(_TxPush(peer, tx))

    def invs(self, peer, txids: "list[bytes]") -> None:
        """Peer announced transactions by txid (``inv``)."""
        if txids:
            self.mailbox.send(_Invs(peer, tuple(txids)))

    def verdict(self, txid: bytes, valid: bool, verdicts: tuple = (),
                error: Optional[str] = None) -> None:
        """The verify pipeline published a TxVerdict for ``txid``."""
        self.mailbox.send(_Verdict(txid, valid, tuple(verdicts), error))

    def confirmed(self, txids: "list[bytes]") -> None:
        """Block connect: these txids are now in a block."""
        if txids:
            self.mailbox.send(_Confirmed(tuple(txids)))

    def block_connected(self, block) -> None:
        """Block connect with only the block in hand (no-verify-engine
        path): txids are extracted inside the actor, guarded."""
        self.mailbox.send(_ConfirmedBlock(block))

    def peer_gone(self, peer) -> None:
        self.mailbox.send(_PeerGone(peer))

    def chain_event(self, _event) -> None:
        """Chain activity (new best block): run housekeeping soon."""
        self.mailbox.send(_Tick())

    # -- query API (lock-free reads of loop-owned state; same contract as
    #    Chain's read queries) ----------------------------------------------

    def contains(self, txid: bytes) -> bool:
        """Is ``txid`` an active (pending or valid) mempool member?"""
        e = self._seen.lookup(txid)
        return e is not None and e.state in (TxState.PENDING, TxState.VALID)

    def get(self, txid: bytes):
        """The tx object for an active member, else None."""
        e = self._seen.get(txid)
        return e.tx if e is not None and e.tx is not None else None

    def state(self, txid: bytes) -> Optional[str]:
        e = self._seen.get(txid)
        return e.state if e is not None else None

    def size(self) -> int:
        return self._size

    def orphan_count(self) -> int:
        return len(self._orphans)

    def orphans(self) -> "list[bytes]":
        return list(self._orphans)

    def lookup_prevout(self, txid: bytes, vout: int):
        """In-mempool prevout oracle: ``(value, scriptPubKey)`` when the
        funding tx is an active member, else None.  Node composes this
        in FRONT of the embedder's oracle so children spending unconfirmed
        parents extract with full prevout data."""
        e = self._seen.get(txid)
        if e is not None and e.outputs is not None and 0 <= vout < len(e.outputs):
            return e.outputs[vout]
        return None

    def stats(self) -> dict:
        """Snapshot for Node.stats() / the debug server."""
        hits = self._dedup_hits
        admitted = self._admitted
        deliveries = hits + admitted
        top = sorted(
            self._announcers.items(), key=lambda kv: -kv[1]
        )[:10]
        return {
            "size": self._size,
            "orphans": len(self._orphans),
            "wanted": len(self._want),
            "inflight_fetches": sum(self._inflight.values()),
            "admitted": admitted,
            "dedup_hits": hits,
            "dedup_hit_rate": round(hits / deliveries, 4) if deliveries else 0.0,
            "orphan_resolved": self._orphan_resolved,
            "fetched": self._fetched,
            "fetch_failures": self._fetch_failures,
            "top_announcers": [
                {"peer": k, "announcements": v} for k, v in top
            ],
            "misbehavior": dict(
                sorted(self._misbehavior.items(), key=lambda kv: -kv[1])[:10]
            ),
        }

    # -- admission ----------------------------------------------------------

    def _on_push(self, peer, tx) -> None:
        admitted = self._admit(peer, tx)
        if not admitted:
            # dedup/orphan/malformed short-circuit: this message's
            # pipeline trace (started in the peer wire loop) ends here,
            # unretained — exactly like the shed path in node.py
            _discard_active_trace()

    def _admit(self, peer, tx, re_entry: bool = False,
               force: bool = False, resolve: bool = True) -> bool:
        """Run one tx through admission.  Returns True iff it was
        submitted to the verify pipeline (False: dedup hit, parked as
        orphan, or rejected as malformed)."""
        origin = _label(peer)
        raw = getattr(tx, "raw", None)
        if raw is not None and not re_entry:
            # fast dedup: one double-SHA over the wire bytes (== wtxid
            # for witness serializations, == txid otherwise), no parse
            k = double_sha256(raw)
            known = self._seen.resolve(k)
            if known in self._seen:
                self._dedup_hit(peer, known)
                return False
        try:
            txid = tx.txid  # parses a LazyTx once (validates the payload)
            wtxid = tx.wtxid if tx.has_witness else txid
            n_out = len(tx.outputs)
        except Exception as e:
            # unparseable push: same contract as the pre-mempool decode
            # path — the relaying peer dies, the node does not
            metrics.inc("mempool.malformed")
            self._misbehave(peer, "malformed-tx")
            events.emit("mempool.reject", peer=origin,
                        error=str(e)[:200])
            kill = getattr(peer, "kill", None)
            if kill is not None:
                kill(CannotDecodePayload(f"mempool tx: {e}"))
            return False
        if not re_entry and txid in self._seen:
            # NO alias insert on this path: a malleated witness gives
            # every re-push of one known tx a fresh wtxid, and recording
            # each would grow _alias without bound (the dedup stays
            # correct — it just re-parses instead of raw-hash matching)
            self._dedup_hit(peer, txid)
            return False
        if wtxid != txid:
            self._seen.alias(wtxid, txid)
        if not force:
            missing = self._missing_parents(tx)
            if missing:
                self._park_orphan(peer, tx, txid, wtxid, missing,
                                  re_entry=re_entry)
                return False
        outputs = tuple(
            (tx.outputs[i].value, tx.outputs[i].script) for i in range(n_out)
        )
        entry = _Entry(txid, wtxid, TxState.PENDING, tx=tx,
                       outputs=outputs, origin=origin)
        self._insert_seen(entry)
        self._size += 1
        self._admitted += 1
        metrics.inc("mempool.admitted")
        metrics.set_gauge("mempool.size", self._size)
        self._drop_want(txid)
        self._submit(peer, tx)
        if resolve:
            # a newly admitted tx may be the parent an orphan waits for
            self._resolve_waiting(txid)
        return True

    def _dedup_hit(self, peer, txid: bytes) -> None:
        self._dedup_hits += 1
        metrics.inc("mempool.dedup_hits")
        e = self._seen.get(txid)
        if e is not None:
            self._seen.touch(txid)  # recently relevant: keep in LRU
            if e.state == TxState.INVALID:
                # a verdict served from cache: zero verify work, and the
                # peer relaying a known-invalid tx is counted against it
                self._misbehave(peer, "relayed-known-invalid")

    def _missing_parents(self, tx) -> "set[bytes]":
        """Parent txids whose absence would degrade this tx's
        verification: only inputs whose digest/classification actually
        consumes prevout data gate admission (txverify.needs_prevout) —
        a legacy input with an unknown prevout verifies fine and must
        not orphan the tx."""
        missing: set[bytes] = set()
        for idx, txin in enumerate(tx.inputs):
            if not needs_prevout(tx, idx):
                continue
            prev = txin.prevout
            e = self._seen.get(prev.txid)
            if e is not None:
                if e.outputs is not None and prev.index < len(e.outputs):
                    continue
                if e.state == TxState.CONFIRMED:
                    continue  # in the chain: the embedder's oracle owns it
            if self._oracle is not None and (
                self._oracle(prev.txid, prev.index) is not None
            ):
                continue
            missing.add(prev.txid)
        return missing

    def _insert_seen(self, entry: _Entry) -> None:
        # eviction policy (PENDING rotation, 2x ceiling) lives in the
        # extracted structure; this actor owns index teardown + metrics
        for old_txid, old in self._seen.insert(entry.txid, entry):
            self._forget(old_txid, old)
            metrics.inc("mempool.evicted")

    def _forget(self, txid: bytes, e: _Entry) -> None:
        """Drop every index entry for a seen txid (LRU eviction)."""
        if e.wtxid != txid:
            self._seen.drop_alias(e.wtxid)
        if e.state in (TxState.PENDING, TxState.VALID):
            self._size -= 1
            metrics.set_gauge("mempool.size", self._size)
        if e.state == TxState.ORPHAN:
            self._unpark(txid, e)

    # -- orphan pool --------------------------------------------------------

    def _park_orphan(self, peer, tx, txid: bytes, wtxid: bytes,
                     missing: "set[bytes]", re_entry: bool = False) -> None:
        entry = _Entry(txid, wtxid, TxState.ORPHAN, tx=tx,
                       origin=_label(peer))
        entry.missing = missing
        self._insert_seen(entry)
        self._orphans[txid] = entry
        for parent in missing:
            self._waiting.setdefault(parent, set()).add(txid)
            # the peer that relayed the child likely has the parent:
            # put the parent on the want-list sourced from that peer
            if isinstance(peer, Peer):
                self._want_tx(parent, peer)
        if not re_entry:
            metrics.inc("mempool.orphaned")
        metrics.set_gauge("mempool.orphans", len(self._orphans))
        events.emit("mempool.orphan", txid=hash_to_hex(txid),
                    missing=len(missing), peer=entry.origin)
        self._drop_want(txid)
        while len(self._orphans) > self.cfg.max_orphans:
            old_txid, old = self._orphans.popitem(last=False)
            self._unpark(old_txid, old, pop=False)
            self._seen.pop(old_txid, None)
            if old.wtxid != old_txid:
                self._seen.drop_alias(old.wtxid)
            metrics.inc("mempool.orphan_evicted")
            # same contract as TTL expiry: the embedder gets a verdict
            # for every ingested tx — size pressure degrades the oldest
            # orphan to verify-what's-extractable, never silent loss
            self._admit(_Origin(old.origin), old.tx, re_entry=True,
                        force=True)
        self._schedule_soon()

    def _unpark(self, txid: bytes, e: _Entry, pop: bool = True) -> None:
        """Remove orphan bookkeeping (the seen entry is the caller's)."""
        if pop:
            self._orphans.pop(txid, None)
        for parent in e.missing or ():
            waiters = self._waiting.get(parent)
            if waiters is not None:
                waiters.discard(txid)
                if not waiters:
                    del self._waiting[parent]
        metrics.set_gauge("mempool.orphans", len(self._orphans))

    def _resolve_waiting(self, parent: bytes) -> None:
        """A parent arrived (admitted or confirmed): re-run admission for
        the orphans that were waiting on it.  Iterative worklist — a
        deep orphan chain resolving parent-by-parent must not recurse
        ``max_orphans`` frames deep."""
        queue = [parent]
        while queue:
            parent = queue.pop()
            waiters = self._waiting.pop(parent, None)
            if not waiters:
                continue
            for child_txid in list(waiters):
                e = self._orphans.get(child_txid)
                if e is None:
                    continue
                e.missing.discard(parent)
                if e.missing:
                    continue  # still waiting on other parents
                self._unpark(child_txid, e)
                self._seen.pop(child_txid, None)
                # re-admission re-checks every prevout: other parents
                # may have been evicted meanwhile -> it re-parks
                if self._admit(_Origin(e.origin), e.tx, re_entry=True,
                               resolve=False):
                    self._orphan_resolved += 1
                    metrics.inc("mempool.orphan_resolved")
                    events.emit(
                        "mempool.orphan_resolved",
                        txid=hash_to_hex(child_txid),
                        parent=hash_to_hex(parent),
                    )
                    queue.append(child_txid)  # may unblock grandchildren

    def _expire_orphans(self) -> None:
        now = time.monotonic()
        while self._orphans:
            txid, e = next(iter(self._orphans.items()))
            if now - e.added <= self.cfg.orphan_ttl:
                break
            self._unpark(txid, e)
            self._seen.pop(txid, None)
            metrics.inc("mempool.orphan_expired")
            events.emit("mempool.orphan_expired", txid=hash_to_hex(txid))
            # degrade to the pre-mempool contract instead of silence:
            # verify what's extractable, the embedder gets a verdict
            self._admit(_Origin(e.origin), e.tx, re_entry=True, force=True)

    # -- verdicts and confirmation ------------------------------------------

    def _on_verdict(self, v: _Verdict) -> None:
        e = self._seen.get(v.txid)
        if e is None or e.state != TxState.PENDING:
            return
        if v.error is not None:
            # indeterminate (engine/extract failure): forget the entry so
            # a later re-push retries instead of serving a bogus verdict
            self._seen.pop(v.txid, None)
            self._forget(v.txid, e)
            return
        e.verdicts = v.verdicts
        if v.valid:
            e.state = TxState.VALID
            metrics.inc("mempool.accepted")
        else:
            e.state = TxState.INVALID
            e.tx = None
            e.outputs = None
            self._size -= 1
            metrics.inc("mempool.rejected")
            metrics.set_gauge("mempool.size", self._size)
            self._misbehave(_Origin(e.origin), "relayed-invalid")

    def _on_confirmed(self, txids: tuple) -> None:
        flipped = 0
        for txid in txids:
            e = self._seen.get(txid)
            if e is None and (txid in self._waiting or txid in self._want):
                # Never seen, but actively tracked: an orphan waits on it
                # or it's on the want-list.  Tombstone it as CONFIRMED so
                # a late inv for it doesn't trigger a pointless fetch.
                # Both sets are bounded, so this can't flood the LRU.
                e = _Entry(txid, txid, TxState.CONFIRMED)
                self._insert_seen(e)
                flipped += 1
            elif e is not None:
                # Only entries we already track flip to CONFIRMED.  Any
                # other never-seen block txid is NOT cached: block sync
                # would otherwise pump thousands of historical txids per
                # block through the LRU, churning out the live mempool
                # state the cache exists to protect.
                if e.state == TxState.ORPHAN:
                    self._unpark(txid, e)
                elif e.state in (TxState.PENDING, TxState.VALID):
                    self._size -= 1
                    metrics.inc("mempool.confirmed_evictions")
                e.state = TxState.CONFIRMED
                e.tx = None
                e.outputs = None
                e.missing = None
                flipped += 1
            self._drop_want(txid)
        metrics.set_gauge("mempool.size", self._size)
        if flipped:
            metrics.inc("mempool.confirmed", flipped)
        # confirmed parents can unblock waiting orphans (their prevouts
        # are now the embedder oracle's/chain's responsibility) — seen
        # or not: an orphan can wait on a parent that was never relayed
        for txid in txids:
            self._resolve_waiting(txid)

    def _on_confirmed_block(self, block) -> None:
        try:
            txids = [tx.txid for tx in block.txs]
        except Exception as e:
            log.debug("[Mempool] unparseable block on connect: %s", e)
            return
        self._on_confirmed(tuple(txids))

    # -- inv relay / fetch scheduler ----------------------------------------

    def _on_invs(self, peer, txids: tuple) -> None:
        _bump_label(self._announcers, _label(peer), len(txids))
        metrics.inc("mempool.announcements", len(txids))
        for txid in txids:
            e_txid = self._seen.resolve(txid)
            if e_txid in self._seen:
                self._dedup_hit(peer, e_txid)
                continue
            self._want_tx(txid, peer)
        self._schedule_soon()

    def _want_tx(self, txid: bytes, peer: Peer) -> None:
        w = self._want.get(txid)
        if w is None:
            if len(self._want) >= self.cfg.max_wanted:
                metrics.inc("mempool.inv_dropped")
                return
            self._want[txid] = w = _Want(None)
            metrics.inc("mempool.announced")
        if peer not in w.announcers and peer not in w.tried:
            w.announcers.append(peer)

    def _drop_want(self, txid: bytes) -> None:
        w = self._want.pop(txid, None)
        if w is not None and w.inflight is not None:
            # delivered by another path while a fetch was in flight: the
            # in-flight accounting is reconciled at _FetchDone
            self._want[txid] = w

    def _schedule_soon(self) -> None:
        """Request a scheduling pass after the current mailbox burst
        drains.  The scan in _schedule is O(want-list); running it per
        inv message makes a flood quadratic — coalescing to one marker
        at the mailbox tail makes it amortized one scan per burst."""
        if not self._sched_queued:
            self._sched_queued = True
            self.mailbox.send(_Sched())

    def _schedule(self) -> None:
        """Assign wanted txids to announcers with capacity, batched."""
        if self._pressure is not None and self._pressure():
            metrics.inc("mempool.fetch_deferred")
            return  # the tick loop re-schedules once pressure clears
        batches: dict[Peer, list[bytes]] = {}
        for txid, w in self._want.items():
            if w.inflight is not None:
                continue
            for p in w.announcers:
                if p in batches:
                    batch = batches[p]
                    if len(batch) >= self.cfg.fetch_batch:
                        continue  # this announcer's batch is full
                else:
                    # at most ONE new batch per peer per scheduling pass,
                    # and never past the per-peer in-flight cap
                    if self._inflight.get(p, 0) + 1 > (
                        self.cfg.max_inflight_per_peer
                    ):
                        continue
                    batch = batches.setdefault(p, [])
                batch.append(txid)
                w.inflight = p
                break
        for p, txids in batches.items():
            self._inflight[p] = self._inflight.get(p, 0) + 1
            metrics.inc("mempool.fetches")
            self._fetchers.add_child(
                self._fetch(p, tuple(txids)), name=f"mempool-fetch-{_label(p)}"
            )

    async def _fetch(self, peer: Peer, txids: tuple) -> None:
        """One getdata batch against one announcer.  The RPC's returned
        txs are NOT admitted here: every served tx also arrives through
        the normal peer-message path (the wire loop publishes it), so
        admission stays single-path and the dedup metric honest.  This
        task only reconciles the want-list."""
        ok = False
        try:
            res = await get_txs(self.net, self.cfg.fetch_timeout, peer, list(txids))
            ok = res is not None
        except Exception as e:
            log.debug("[Mempool] fetch from %s failed: %s", _label(peer), e)
        finally:
            self.mailbox.send(_FetchDone(peer, txids, ok))

    def _on_fetch_done(self, peer, txids: tuple, ok: bool) -> None:
        if ok:
            # counted here, not in the fetcher task: all state mutation
            # (instance counters included) stays in the actor loop
            self._fetched += len(txids)
            metrics.inc("mempool.fetched", len(txids))
        n = self._inflight.get(peer, 0) - 1
        if n > 0:
            self._inflight[peer] = n
        else:
            self._inflight.pop(peer, None)
        for txid in txids:
            w = self._want.get(txid)
            if w is None or w.inflight is not peer:
                continue
            w.inflight = None
            if ok or self._seen.resolve(txid) in self._seen:
                # served (or delivered by another path mid-flight): the
                # push path owns admission from here
                del self._want[txid]
                continue
            w.attempts += 1
            w.tried.add(peer)
            w.announcers = [p for p in w.announcers if p is not peer]
            if w.attempts >= self.cfg.fetch_retries or not w.announcers:
                del self._want[txid]
                self._fetch_failures += 1
                metrics.inc("mempool.fetch_failures")
                events.emit(
                    "mempool.fetch_failed", txid=hash_to_hex(txid),
                    attempts=w.attempts, peer=_label(peer),
                )
            else:
                metrics.inc("mempool.fetch_retries")
        self._schedule_soon()

    def _on_peer_gone(self, peer) -> None:
        self._inflight.pop(peer, None)
        for txid in list(self._want):
            w = self._want[txid]
            if w.inflight is peer:
                w.inflight = None
            if peer in w.announcers:
                w.announcers.remove(peer)
            if w.inflight is None and not w.announcers:
                del self._want[txid]
        self._schedule_soon()

    # -- housekeeping --------------------------------------------------------

    def _on_tick(self) -> None:
        self._expire_orphans()
        self._expire_wants()
        self._schedule()

    def _expire_wants(self) -> None:
        """Reclaim want-list slots that never got fetched: an entry can
        sit with ``inflight=None`` indefinitely when its announcers are
        permanently at their in-flight cap or never answer (the TxRelay
        "stall" shape keeps the peer connected, so _on_peer_gone never
        clears it).  A fresh announcement re-adds the txid."""
        now = time.monotonic()
        expired = 0
        for txid in list(self._want):
            w = self._want[txid]
            if w.inflight is None and now - w.added > self.cfg.want_ttl:
                del self._want[txid]
                expired += 1
        if expired:
            metrics.inc("mempool.want_expired", expired)

    def _misbehave(self, peer, why: str) -> None:
        metrics.inc("mempool.misbehavior")
        lab = _label(peer)
        _bump_label(self._misbehavior, lab)
        events.emit("mempool.misbehavior", peer=lab, reason=why)

    def misbehavior(self, peer) -> int:
        """Misbehavior incidents attributed to ``peer`` (by label)."""
        return self._misbehavior.get(_label(peer), 0)


class _Origin:
    """Stand-in peer for re-admissions (orphan resolution/expiry): the
    original relayer's label for attribution, no live session."""

    __slots__ = ("label",)

    def __init__(self, label: str):
        self.label = label

    def __repr__(self) -> str:
        return f"<Origin {self.label}>"
