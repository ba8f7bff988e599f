"""Node composition: wire the chain and peer managers together.

Mirror of haskoin-node's Node.hs: ``Node`` starts the Chain actor,
then the PeerMgr actor, then links two glue loops that route events between
them — the ONLY place the two managers are wired to each other (reference
Node.hs:130-174).  Everything is scoped: leaving the async context kills every
actor, peer session and timer (the ``withNode`` bracket, Node.hs:177-193).

Also provides the production TCP transport (reference ``withConnection``
Node.hs:108-128); tests inject an in-memory transport instead through
``NodeConfig.connect`` — the seam that makes the whole stack testable without
a network.

In the port, the node's block and mempool ingest verify through the port's
engine (``verify/engine.py``) and, on the card, its hand-written kernels;
``NodeConfig.verify=VerifyConfig()`` asks for the card (``backend`` "auto")
and raises at construction without one, and the CPU tests pass
``backend="cpu"`` or ``"oracle"``.  Wire bytes are extracted by the native
extractor (``native/txextract``): the node raises at start when it does not
build or load, and the Python extraction path serves only data that has no
wire bytes (``tx.raw is None``, eager blocks without ``raw_txs``).
"""

from __future__ import annotations

import asyncio
import contextlib
import functools
import logging
import os
import time as _time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Optional

from . import threadsan
from .actors import (
    LinkedTasks,
    Publisher,
    Supervisor,
    spawn_supervised,
    task_registry,
)
from .blackbox import FlightRecorder, FlightRecorderConfig
from .chain import Chain, ChainBestBlock, ChainConfig, ChainEvent
from .events import StatsReporter, events
from .timeseries import Timeline
from .slo import DEFAULT_SLOS, SloDef, SloEvaluator
from .mempool import Mempool, MempoolConfig
from .metrics import metrics, percentiles
from .trace import span
from .tracectx import (
    activate as _activate_trace,
    clear_active as _clear_active_trace,
    current as _trace_current,
    discard_active as _discard_active_trace,
    finish_active as _finish_active_trace,
    tracer,
)
from .watchdog import Watchdog, WatchdogConfig
from .txverify import (
    ExtractStats,
    combine_verdicts,
    extract_sig_items,
    intra_block_prevouts,
    wants_amount,
)
from .verify.engine import VerifyConfig, VerifyEngine
from .verify.sched import affinity_key
from .params import NODE_NETWORK, Network
from .peer import (
    CannotDecodePayload,
    PeerAddressInvalid,
    PeerConnected,
    PeerDisconnected,
    PeerEvent,
    PeerMessage,
    WithConnection,
)
from .peermgr import PeerMgr, PeerMgrConfig, SockAddr
from .store import KVStore, Namespaced
from .ibd import BlockFetcher, IbdConfig
from .utxo import UNDO_DEPTH_DEFAULT, UTXO_NAMESPACE, UtxoStore
from .wire import (
    InvType,
    MsgAddr,
    MsgBlock,
    MsgHeaders,
    MsgInv,
    MsgNotFound,
    MsgOther,
    MsgPing,
    MsgPong,
    MsgTx,
    MsgVerAck,
    MsgVersion,
    NetworkAddress,
    Tx,
)

__all__ = [
    "NodeConfig", "Node", "TxVerdict", "VerifyShed", "tcp_connect",
    "IbdConfig",
]


log = logging.getLogger("tpunode_torch.node")


def _prevout_info(res) -> "tuple[Optional[int], Optional[bytes]]":
    """Normalize a ``prevout_lookup`` result: plain satoshi amount (the
    pre-taproot form), an ``(amount, scriptPubKey)`` tuple, or None."""
    if res is None:
        return None, None
    if isinstance(res, tuple):
        return res[0], res[1]
    return res, None


@dataclass(frozen=True)
class VerifyShed:
    """Published when verify-ingest backpressure drops a message's txs
    (MAX_VERIFY_PENDING reached): embedders observe DoS-shed decisions
    instead of losing them to a silent counter.
    ``dropped_txs`` counts drops caused by ``peer`` alone (aggregated
    per peer within the rate-limit window), so per-peer banning is
    sound."""

    peer: object
    dropped_txs: int
    pending: int  # in-flight ingest submissions at the time


@dataclass(frozen=True)
class TxVerdict:
    """Published to the user bus for every tx that went through the verify
    engine — the ingest hook's output (haskoin-node itself does no script
    validation)."""

    peer: object  # the Peer the tx arrived from
    txid: bytes
    valid: bool  # every extracted signature verified
    verdicts: tuple[bool, ...]  # per extracted signature
    stats: ExtractStats  # how many inputs were extractable at all
    error: Optional[str] = None  # engine failure: verdict is indeterminate


@dataclass
class NodeConfig:
    """The entire configuration surface (reference ``NodeConfig``
    Node.hs:74-96)."""

    net: Network
    store: KVStore
    pub: Publisher
    max_peers: int = 20
    peers: list[str] = field(default_factory=list)
    discover: bool = False
    address: NetworkAddress = field(
        default_factory=lambda: NetworkAddress.from_host_port(
            "0.0.0.0", 0, services=NODE_NETWORK
        )
    )
    timeout: float = 120.0
    max_peer_life: float = 48 * 3600.0
    # transport hook; defaults to real TCP (reference Node.hs:95,108-128)
    connect: Callable[[SockAddr], WithConnection] = None  # type: ignore[assignment]
    # north-star hook: when set, inbound tx/block signatures stream through
    # the batch verify engine and TxVerdict events reach the user bus
    verify: Optional[VerifyConfig] = None
    # mempool subsystem (mempool.py): inv-driven tx relay with
    # fetch retry, admission dedup + verdict cache (each unique tx is
    # verified exactly once), orphan pool, confirmation eviction.  None
    # (the default) preserves the bare ingest path: pushes go straight
    # to the verify engine, inv announcements are dropped (and counted
    # under ``node.unhandled``).
    mempool: Optional[MempoolConfig] = None
    # telemetry: seconds between StatsReporter snapshots (windowed rates +
    # ``node.stats`` events on the structured event log); 0 disables the loop
    stats_interval: float = 30.0
    # stall watchdog cadence (event-loop lag, actor-mailbox head age,
    # verify dispatch in-flight time -> ``watchdog.stall`` events);
    # 0 disables the loop.  Thresholds live in watchdog.py.
    watchdog_interval: float = 1.0
    # metrics timeline sampler (timeseries.py): seconds between
    # registry snapshots into the ring-buffer history (downsampling tiers,
    # Node.stats()["fleet_history"]); 0 disables the sampler.
    timeline_interval: float = 1.0
    # flight recorder (blackbox.py): trigger events (watchdog
    # stalls, breaker opens, host losses, store corruption, ...) freeze a
    # rate-limited post-mortem bundle — always into the in-memory ring;
    # also onto disk when blackbox_dir (or
    # $TPUNODE_BLACKBOX_DIR) is set.  False turns the recorder off.
    blackbox: bool = True
    blackbox_dir: Optional[str] = None
    # SLO engine (slo.py): declarative objectives —
    # per-class verdict-latency targets, a dispatch-stall budget, a
    # breaker-open budget — evaluated once a second against the live
    # registry; fast/slow-window burn breaches emit ``slo.burn`` events
    # (a flight-recorder trigger) and surface at stats()["slo"] and
    # health().  None disables the evaluator entirely.
    slos: Optional[tuple[SloDef, ...]] = DEFAULT_SLOS
    # prevout oracle for BIP143 (P2WPKH / BCH FORKID) and BIP341 (taproot)
    # sighashes: (prevout txid, vout) -> satoshi amount, or
    # (amount, scriptPubKey), or None if unknown.  The tuple form enables
    # taproot keypath extraction: a P2TR spend is only detectable from the
    # prevout script, and its BIP341 digest signs over every input's
    # amount AND script.  Block ingest resolves
    # intra-block spends automatically; this hook lets the embedder (which
    # may hold a UTXO set) resolve the rest.
    prevout_lookup: Optional[
        Callable[[bytes, int], "Optional[int | tuple[int, bytes]]"]
    ] = None
    # Parallel host extraction: how many
    # worker threads shard native ``ParsedTxRegion`` construction +
    # extraction over tx ranges.  0 = auto (``min(4, cpu_count)``);
    # 1 = serial (the pre-pipeline behavior, the A/B baseline — also
    # disables the extract→verify overlap ring).  The native extractor
    # releases the GIL, so threads scale on real cores.
    extract_workers: int = 0
    # persistent UTXO store (utxo.py):
    # when True the node maintains a durable UTXO set over a namespaced
    # view of ``store`` — block connect applies spends/creates + a
    # block-height watermark in ONE atomic write_batch (idempotent
    # crash-replay), the set serves the prevout oracle between the
    # mempool and ``prevout_lookup``, and blocks at or below the
    # watermark skip re-verification entirely on restart.
    utxo: bool = False
    # per-block UNDO retention: reorgs at/below the watermark
    # up to this deep disconnect cleanly (utxo.disconnect) instead of
    # going loudly stale; 0 disables undo records entirely.
    utxo_undo_depth: int = UNDO_DEPTH_DEFAULT
    # block-fetch-driven IBD: when set, the
    # node schedules its own getdata block batches across the peer fleet
    # from the UTXO watermark to the header tip (ibd.py) — a bare
    # Node syncs the whole chain with no embedder pushes, and a restart
    # resumes from the watermark re-fetching nothing below it.  Requires
    # ``utxo=True`` (the watermark IS the sync cursor).
    ibd: Optional[IbdConfig] = None
    def __post_init__(self):
        if self.connect is None:
            self.connect = tcp_connect
        if self.ibd is not None and not self.utxo:
            raise ValueError(
                "NodeConfig.ibd requires utxo=True: the persistent UTXO "
                "watermark is the fetch planner's sync cursor"
            )


class Node:
    """A running node: ``peer_mgr`` + ``chain`` (reference ``Node``
    Node.hs:98-101).  Use as an async context manager::

        async with Node(cfg) as node:
            best = node.chain.get_best()
    """

    def __init__(self, cfg: NodeConfig):
        self.cfg = cfg
        # Internal glue buses are unbounded: their only subscribers are the
        # linked router loops (always draining; death tears the node down),
        # and dropping a control message (headers, version) would corrupt
        # protocol state.  The bounded drop-oldest default protects the
        # USER bus (cfg.pub), where subscribers are outside our control.
        self._chain_pub: Publisher[ChainEvent] = Publisher(
            name="chain-internal", maxsize=None
        )
        self._peer_pub: Publisher[PeerEvent] = Publisher(
            name="peer-internal", maxsize=None
        )
        self.chain = Chain(
            ChainConfig(
                store=cfg.store,
                net=cfg.net,
                pub=self._chain_pub,
                timeout=cfg.timeout,
            ),
            on_failure=self._component_failed,
        )
        self.peer_mgr = PeerMgr(
            PeerMgrConfig(
                max_peers=cfg.max_peers,
                peers=cfg.peers,
                discover=cfg.discover,
                address=cfg.address,
                net=cfg.net,
                pub=self._peer_pub,
                timeout=cfg.timeout,
                max_peer_life=cfg.max_peer_life,
                connect=cfg.connect,
            ),
            on_failure=self._component_failed,
        )
        self._tasks = LinkedTasks(name="node", on_failure=self._component_failed)
        self._stack = contextlib.AsyncExitStack()
        self._owner: Optional[asyncio.Task] = None
        self._failure: Optional[BaseException] = None
        self.verify_engine: Optional[VerifyEngine] = (
            VerifyEngine(cfg.verify) if cfg.verify is not None else None
        )
        # persistent UTXO set over the main store (NodeConfig.utxo); the
        # watermark survives restarts, so it must be read before ingest
        self.utxo: Optional[UtxoStore] = (
            UtxoStore(
                Namespaced(cfg.store, UTXO_NAMESPACE),
                undo_depth=cfg.utxo_undo_depth,
            )
            if cfg.utxo
            else None
        )
        # block-fetch-driven IBD planner: schedules getdata
        # batches across the fleet from the watermark to the header tip
        self.ibd: Optional[BlockFetcher] = (
            BlockFetcher(
                cfg.ibd,
                net=cfg.net,
                chain=self.chain,
                peer_mgr=self.peer_mgr,
                utxo=self.utxo,
                pressure=self._ibd_pressure,
                on_failure=self._component_failed,
            )
            if cfg.ibd is not None
            else None
        )
        # block connects serialize here: applies are atomic per block, but
        # the watermark check-then-apply across concurrent ingest tasks
        # must not interleave
        self._utxo_lock = asyncio.Lock()
        # out-of-order completions parked until their predecessor lands
        # (concurrent block verification finishes in any order); bounded —
        # beyond the cap a block is dropped and re-delivery heals
        self._utxo_pending: dict[int, object] = {}
        self.mempool: Optional[Mempool] = (
            Mempool(
                cfg.mempool,
                net=cfg.net,
                submit=self._mempool_submit,
                prevout_lookup=cfg.prevout_lookup,
                pressure=self._ingest_pressure,
                on_failure=self._component_failed,
            )
            if cfg.mempool is not None
            else None
        )
        self._verify_tasks = Supervisor(
            name="verify-ingest", on_death=self._verify_task_died
        )
        self._verify_pending = 0
        # mempool-tx batch accumulator (see _submit_verify_tx)
        self._tx_accum: list = []
        self._tx_drain: Optional[asyncio.Task] = None
        # Parallel extraction: worker pool for native
        # ParsedTxRegion construction/extraction (built in _start when
        # >1 worker resolves; shut down in __aexit__), plus the bounded
        # ring that lets extraction of drain batch K+1 overlap
        # verification of K (sched.ring_occupancy gauge).
        w = cfg.extract_workers
        self._extract_workers = w if w > 0 else min(4, os.cpu_count() or 1)
        self._extract_pool: Optional[ThreadPoolExecutor] = None
        self._extract_ring = asyncio.Semaphore(self.EXTRACT_RING)
        self._ring_busy = 0
        # shed-event aggregation (a flood must not also flood the bus),
        # keyed by peer: drops must be attributed to the peer that caused
        # them — an embedder doing per-peer DoS banning acts on this
        #
        self._shed_counts: dict = {}
        self._shed_last_pub = 0.0
        self._shed_flush: Optional[asyncio.Task] = None
        self._started_at: Optional[float] = None
        self._stats_reporter: Optional[StatsReporter] = None
        self._watchdog: Optional[Watchdog] = None
        self.timeline: Optional[Timeline] = None
        self.blackbox: Optional[FlightRecorder] = None
        self.slo: Optional[SloEvaluator] = None

    @staticmethod
    def _verify_task_died(task, exc) -> None:
        """An ingest task crashed outside its own error handling: record it
        (verdicts for its txs were already published or are indeterminate)."""
        if exc is not None and not isinstance(exc, asyncio.CancelledError):
            metrics.inc("node.verify_task_crashes")
            log.warning("[Node] verify ingest task crashed: %r", exc)

    def _component_failed(self, exc: BaseException) -> None:
        """An internal actor crashed: abort the embedding scope, the analog of
        the reference ``link``-ing its loops so a crash takes down the whole
        node bracket (Node.hs:191-192; crash-only design)."""
        if self._failure is None:
            log.error("[Node] component failed, tearing down node: %r", exc)
            self._failure = exc
            if self._owner is not None:
                self._owner.cancel()

    async def __aenter__(self) -> "Node":
        # Subscriptions must exist before the actors start so the chain's
        # initial best-block event reaches the peer manager (the startup
        # ordering constraint, reference Node.hs:183-192 + PeerMgr.hs:245-247).
        self._owner = asyncio.current_task()
        from .txextract import have_native_extract

        if not have_native_extract():
            # no Python stand-in for the native extractor: wire bytes
            # are extracted natively or not at all
            raise RuntimeError(
                "native tx extractor unavailable: native/build/"
                "libtxextract.so did not build or load"
            )
        return await self._start()

    async def _start(self) -> "Node":
        await self._stack.__aenter__()
        chain_sub = await self._stack.enter_async_context(
            self._chain_pub.subscription()
        )
        peer_sub = await self._stack.enter_async_context(
            self._peer_pub.subscription()
        )
        if self.verify_engine is not None:
            await self._stack.enter_async_context(self.verify_engine)
            # Always a pool (1 worker = serial): close-ownership transfer
            # (_run_extract_owned) needs the CONCURRENT future, which
            # only executor.submit exposes — to_thread hides it behind a
            # wrapper whose cancelled() lies about a still-running job.
            self._extract_pool = ThreadPoolExecutor(
                max_workers=self._extract_workers,
                thread_name_prefix="extract",
            )
        if self.verify_engine is not None or self.utxo is not None:
            # utxo-only nodes still spawn supervised block-connect tasks
            await self._stack.enter_async_context(self._verify_tasks)
        if self.mempool is not None:
            await self._stack.enter_async_context(self.mempool)
        await self._stack.enter_async_context(self.chain)
        await self._stack.enter_async_context(self.peer_mgr)
        if self.ibd is not None:
            await self._stack.enter_async_context(self.ibd)
        self._tasks.link(self._chain_events(chain_sub), name="glue-chain")
        self._tasks.link(self._peer_events(peer_sub), name="glue-peer")
        self._started_at = _time.monotonic()
        if self.cfg.stats_interval > 0:
            self._stats_reporter = StatsReporter(
                interval=self.cfg.stats_interval, extra=self._stats_extra
            )
            self._tasks.link(self._stats_reporter.run(), name="stats-reporter")
        if self.cfg.watchdog_interval > 0:
            boxes = [self.chain.mailbox, self.peer_mgr.mailbox]
            if self.mempool is not None:
                boxes.append(self.mempool.mailbox)
            self._watchdog = Watchdog(
                WatchdogConfig(interval=self.cfg.watchdog_interval),
                mailboxes=boxes,
                engine=self.verify_engine,
            )
            self._tasks.link(self._watchdog.run(), name="watchdog")
        if self.cfg.timeline_interval > 0:
            self.timeline = Timeline(interval=self.cfg.timeline_interval)
            self._tasks.link(self.timeline.run(), name="timeline-sampler")
        if self.cfg.slos is not None:
            # SLO evaluator: objectives over the live registry;
            # the ledger hook folds the engine's cost attribution into
            # every snapshot (stats()["slo"], flight bundles)
            self.slo = SloEvaluator(
                self.cfg.slos,
                ledger=(
                    self.verify_engine.ledger
                    if self.verify_engine is not None
                    else None
                ),
            )
            if not self.slo.disabled:
                self._tasks.link(self.slo.run(), name="slo-evaluator")
        if self.cfg.blackbox:
            # bundle state sources: each is one lock-cheap snapshot call,
            # safe from whatever thread the trigger event fires on
            sources: dict = {"health": self.health}
            if self.verify_engine is not None:
                sources["engine"] = self.verify_engine.stats
            if self._watchdog is not None:
                sources["watchdog"] = self._watchdog.snapshot
            if self.utxo is not None:
                sources["utxo"] = self.utxo.stats
            if self.slo is not None:
                sources["slo"] = self.slo.snapshot
            sources["threadsan"] = threadsan.registry.snapshot
            self.blackbox = FlightRecorder(
                FlightRecorderConfig(dir=self.cfg.blackbox_dir),
                timeline=self.timeline,
                sources=sources,
            )
            self.blackbox.attach()
        log.info(
            "[Node] started on %s (%d static peers, discover=%s, verify=%s)",
            self.cfg.net.name,
            len(self.cfg.peers),
            self.cfg.discover,
            "on" if self.verify_engine is not None else "off",
        )
        return self

    async def __aexit__(self, exc_type, exc, tb) -> None:
        log.info("[Node] stopping")
        # unclean shutdown is a flight-recorder trigger: freeze the bundle
        # BEFORE teardown (the state sources still describe the live node),
        # bypassing the rate limit — this is the last chance to record.
        if self.blackbox is not None:
            unclean = self._failure is not None or (
                exc is not None and not isinstance(exc, asyncio.CancelledError)
            )
            if unclean:
                cause = self._failure if self._failure is not None else exc
                self.blackbox.record(
                    "node.unclean_shutdown",
                    trigger={
                        "type": "node.unclean_shutdown",
                        "failure": repr(cause),
                    },
                    force=True,
                )
            self.blackbox.detach()
        self._owner = None
        try:
            await self._tasks.__aexit__(exc_type, exc, tb)
        finally:
            try:
                await self._stack.__aexit__(exc_type, exc, tb)
            finally:
                if self._extract_pool is not None:
                    # non-blocking: queued jobs are cancelled; a job
                    # already RUNNING finishes on its daemonless thread
                    # (it owns its region handle — _extract_and_close —
                    # so nothing the loop side still references is freed
                    # under it)
                    self._extract_pool.shutdown(
                        wait=False, cancel_futures=True
                    )
                    self._extract_pool = None
                # asyncsan task-leak sweep: everything this node owned is
                # now cancelled+awaited, so any still-pending registered
                # task with no live open owner is an orphan — report it
                # (asyncsan.task_leak events) instead of letting GC eat it
                task_registry.report_leaks()
        # Surface an internal crash instead of the bare CancelledError the
        # embedding scope was aborted with.
        if self._failure is not None and isinstance(exc, asyncio.CancelledError):
            raise self._failure

    # -- telemetry snapshot API ---------------------------------------------

    def _stats_extra(self) -> dict:
        """Node-level context merged into every ``node.stats`` event."""
        fleet = self.peer_mgr.fleet()
        extra = {
            "height": self._best_height(),
            "peers": len(fleet),
            "peers_online": sum(1 for o in fleet if o.online),
        }
        if self.verify_engine is not None:
            extra["verify_backlog"] = self.verify_engine.queue_depth()
            extra["verify_pending"] = self._verify_pending
        if self.mempool is not None:
            extra["mempool_size"] = self.mempool.size()
            extra["mempool_orphans"] = self.mempool.orphan_count()
        if self.utxo is not None:
            extra["utxo_height"] = self.utxo.height
        if self.ibd is not None:
            extra["ibd_target"] = self.ibd.stats()["target"]
        return extra

    def _uptime(self) -> float:
        if self._started_at is None:
            return 0.0  # not started yet: never report wall-clock garbage
        return round(_time.monotonic() - self._started_at, 3)

    def _best_height(self) -> Optional[int]:
        """Best height, or None before the chain DB is initialized — a
        probe scraped during startup must get an unhealthy snapshot, not
        a RuntimeError from the uninitialized header store."""
        try:
            return self.chain.get_best().height
        except Exception:
            return None

    def health(self) -> dict:
        """Cheap liveness summary (the load-balancer probe shape)."""
        fleet = self.peer_mgr.fleet()
        return {
            "ok": self._failure is None and self._started_at is not None,
            "failure": repr(self._failure) if self._failure else None,
            "uptime_seconds": self._uptime(),
            "height": self._best_height(),
            "synced": self.chain.is_synced(),
            "peers": len(fleet),
            "peers_online": sum(1 for o in fleet if o.online),
            "verify": (
                self.verify_engine.device_state
                if self.verify_engine is not None
                else "off"
            ),
            # device-path breaker: ready/degraded/open/probing
            # once the device is warm, else the warmup state
            "verify_breaker": (
                self.verify_engine.breaker_state
                if self.verify_engine is not None
                else None
            ),
            # persistent UTXO watermark: the height below which
            # a restart resumes without re-verifying anything
            "utxo_height": (
                self.utxo.height if self.utxo is not None else None
            ),
            # SLO burn: degraded while any FAST-window burn
            # episode is active (the page-now condition); slow-window
            # burns surface in stats()["slo"] without degrading health
            "slo_burning": (
                self.slo.burning("fast") if self.slo is not None else []
            ),
            "degraded": bool(
                self.slo is not None and self.slo.burning("fast")
            ),
        }

    def stats(self) -> dict:
        """Full telemetry snapshot in one call: chain height, per-peer
        fleet state with RTT quantiles, verify-engine backlog and error
        counts, event totals.  Everything here is lock-cheap reads — safe
        to call from an embedder's status endpoint."""
        try:
            best = self.chain.get_best()
        except Exception:  # pre-start: DB not initialized yet
            best = None
        now = _time.monotonic()
        peers = []
        for o in self.peer_mgr.fleet():
            v = o.version
            peers.append(
                {
                    "peer": o.peer.label,
                    "address": f"{o.address[0]}:{o.address[1]}",
                    "online": o.online,
                    "connected_seconds": round(now - o.connected, 3),
                    "rtt": percentiles(o.pings, (0.5, 0.9, 0.99)),
                    "rtt_samples": len(o.pings),
                    "user_agent": (
                        v.user_agent.decode("latin-1") if v else None
                    ),
                    "start_height": v.start_height if v else None,
                }
            )
        verify: dict = {
            "enabled": self.verify_engine is not None,
            "txs": metrics.get("node.verify_txs"),
            "inputs": metrics.get("node.verify_inputs"),
            "errors": metrics.get("node.verify_errors"),
            "dropped": metrics.get("node.verify_dropped"),
        }
        if self.verify_engine is not None:
            verify.update(self.verify_engine.stats())
            verify.update(
                pending_ingest=self._verify_pending,
                accumulated_txs=len(self._tx_accum),
                extract_workers=self._extract_workers,
                ring_busy=self._ring_busy,
            )
        return {
            "uptime_seconds": self._uptime(),
            "chain": {
                "height": best.height if best is not None else None,
                "hash": best.hash_hex if best is not None else None,
                "synced": self.chain.is_synced(),
                "headers": metrics.get("chain.headers"),
                "reorgs": metrics.get("chain.reorgs"),
            },
            "peers": peers,
            "peermgr": self.peer_mgr.backoff_stats(),
            "verify": verify,
            "mempool": (
                self.mempool.stats()
                if self.mempool is not None
                else {"enabled": False}
            ),
            "utxo": (
                self.utxo.stats()
                if self.utxo is not None
                else {"enabled": False}
            ),
            "ibd": (
                self.ibd.stats()
                if self.ibd is not None
                else {"enabled": False}
            ),
            "events": events.counts(),
            # per-host fleet series history: how the queue
            # depths / breaker states / sub-mesh widths got here
            "fleet_history": (
                self.timeline.fleet_history()
                if self.timeline is not None
                else {}
            ),
            "timeline": (
                self.timeline.stats()
                if self.timeline is not None
                else {"enabled": False}
            ),
            "blackbox": (
                self.blackbox.stats()
                if self.blackbox is not None
                else {"enabled": False}
            ),
            "slo": (
                self.slo.snapshot()
                if self.slo is not None
                else {"enabled": False}
            ),
        }

    def _verify_failure(self, where: str, error) -> None:
        """Count + record one verify-path failure (extract/engine/decode)."""
        metrics.inc("node.verify_errors")
        events.emit("verify.failure", where=where, error=str(error)[:300])

    def _publish_verdict(self, v: TxVerdict) -> None:
        """Every TxVerdict flows through here: the mempool's verdict
        cache learns it (dedup: re-relays of this tx now cost zero
        verify work) before the user bus does."""
        if self.mempool is not None:
            self.mempool.verdict(v.txid, v.valid, v.verdicts, v.error)
        self.cfg.pub.publish(v)

    def _mempool_submit(self, peer, tx) -> None:
        """Mempool admission -> verify ingest.  Without a verify engine
        the mempool still dedups/relays, but nothing verifies (entries
        stay pending until evicted)."""
        if self.verify_engine is not None:
            self._submit_verify_tx(peer, tx)

    def _mempool_shed(self, txs) -> None:
        """Shed txs never get a TxVerdict: a mempool-admitted one must
        not stay PENDING in the dedup cache (it would block its own
        re-verification on a later re-push) — the error verdict makes
        the mempool forget it, same as an engine failure."""
        if self.mempool is None:
            return
        for tx in txs:
            try:
                txid = tx.txid
            except Exception:
                continue  # unparseable: was never admitted
            self.mempool.verdict(txid, False, (), error="shed")

    def _ingest_pressure(self) -> bool:
        """Is the verify ingest saturated?  The mempool defers fetch
        scheduling while true, so inv floods degrade into a stale
        want-list instead of feeding the shed path."""
        if len(self._tx_accum) >= self.MAX_TX_ACCUM // 2:
            return True
        return self._verify_pending >= self.MAX_VERIFY_PENDING

    def _ibd_pressure(self) -> bool:
        """Should the IBD planner defer scheduling more block batches?
        Half the shed bound: the planner can keep the pipeline saturated
        but a delivery burst must never reach MAX_VERIFY_PENDING (every
        shed block costs a refetch round-trip later)."""
        return (
            self._verify_pending >= self.MAX_VERIFY_PENDING // 2
            or len(self._utxo_pending) >= self.MAX_UTXO_PENDING // 2
        )

    @staticmethod
    def _affinity(key) -> Optional[int]:
        """The placement hint for one engine submission: the affinity key
        of the hash ``key()`` returns, or None when the payload cannot
        name one (an unparseable lazy tx)."""
        try:
            return affinity_key(key())
        except Exception:
            return None

    def _block_priority(self) -> str:
        """Engine priority class for block verify submissions: planner-era
        backfill runs at ``ibd`` (beneath live block/mempool traffic in
        the lane packer, verify/sched.py) so a syncing node still
        serves fresh verdicts first; live pushed blocks keep ``block``."""
        if self.ibd is not None and self.ibd.backfilling:
            return "ibd"
        return "block"

    def _prevout_oracle(self):
        """The prevout lookup the verify paths consult, in precedence
        order: the mempool's unconfirmed outputs (a child spending an
        in-mempool parent extracts with full prevout data), then the
        persistent UTXO store's confirmed outputs, then the
        embedder's ``cfg.prevout_lookup``.  None when nothing can answer
        — block ingest then skips the whole scan_prevouts + per-input
        lookup pass (hot path)."""
        sources = []
        if self.mempool is not None and self.mempool.size():
            # an empty mempool misses every lookup: skip it entirely
            sources.append(self.mempool.lookup_prevout)
        if self.utxo is not None:
            sources.append(self.utxo.lookup)
        if self.cfg.prevout_lookup is not None:
            sources.append(self.cfg.prevout_lookup)
        if not sources:
            return None
        if len(sources) == 1:
            return sources[0]

        def combined(txid: bytes, vout: int):
            for lookup in sources:
                res = lookup(txid, vout)
                if res is not None:
                    return res
            return None

        return combined

    # -- persistent UTXO block connect ----------------------------

    def _persisted_height(self, block) -> Optional[int]:
        """Height of ``block`` if it is already covered by the UTXO
        watermark (fully verified + applied before a restart), else None.
        Height alone is NOT enough after a reorg: the delivered block
        must BE the watermark branch's block at that height (ancestor
        hash check) — a new-branch block at an old height was never
        verified and must not be skipped."""
        if self.utxo is None:
            return None
        bn = self.chain.get_block(block.header.hash)
        if bn is None or bn.height > self.utxo.height:
            return None
        if self.utxo.block_hash is not None:
            wm = self.chain.get_block(self.utxo.block_hash)
            if wm is None:
                return None  # watermark block unknown here: re-verify
            anc = self.chain.get_ancestor(bn.height, wm)
            if anc is None or anc.hash != bn.hash:
                return None  # different branch: not covered
        return bn.height

    def _connect_block_utxo(self, block) -> None:
        """Schedule the persistent UTXO connect for an ingested block
        (supervised; ordering enforced by ``_utxo_lock``)."""
        if self.utxo is None:
            return
        self._verify_tasks.add_child(
            self._apply_block_utxo(block), name="utxo-connect"
        )

    async def _apply_block_utxo(self, block) -> None:
        """Apply one block's spends/creates + watermark atomically.  The
        tx parse and the store write both run off-loop; failures are loud
        (``utxo.error``) but never kill ingest — the UTXO set degrades to
        a stale oracle, not a crashed node."""
        bn = self.chain.get_block(block.header.hash)
        if bn is None:
            # headers-first sync means this is rare: a block whose header
            # the chain has not accepted cannot be assigned a height
            metrics.inc("utxo.no_header")
            return
        assert self.utxo is not None
        async with self._utxo_lock:
            if bn.height <= self.utxo.height:
                metrics.inc("utxo.skipped")
                return
            # CONTIGUOUS connects only: applying height N+2 over a
            # watermark of N would silently drop N+1's whole delta (its
            # later re-delivery lands below the watermark and is skipped
            # forever).  Concurrent verification completes in any order,
            # so an early arrival PARKS (bounded) until its predecessor
            # lands; past the cap it is dropped — re-delivery heals.
            expected = max(self.utxo.height + 1, 1)
            if bn.height < expected:
                # below the first applicable height (a delivered genesis
                # block on a fresh store): nothing to park for — the
                # drain loop could never reach it
                metrics.inc("utxo.skipped")
                return
            if bn.height > expected:
                if len(self._utxo_pending) < self.MAX_UTXO_PENDING:
                    self._utxo_pending[bn.height] = block
                    metrics.inc("utxo.deferred")
                else:
                    metrics.inc("utxo.out_of_order")
                    events.emit(
                        "utxo.out_of_order", height=bn.height,
                        watermark=self.utxo.height,
                    )
                return
            await self._utxo_apply_one(bn.height, block)
            # drain parked successors now contiguous with the watermark
            while True:
                nxt = self._utxo_pending.pop(self.utxo.height + 1, None)
                if nxt is None:
                    break
                await self._utxo_apply_one(self.utxo.height + 1, nxt)
        if self.ibd is not None:
            # the watermark may have moved: the planner retires finished
            # batches and schedules further ahead
            self.ibd.nudge()

    # Bound on parked out-of-order block connects (blocks are held alive
    # while parked; MAX_VERIFY_PENDING already bounds how many can be in
    # flight at once, this is belt-and-braces above it).
    MAX_UTXO_PENDING = 128

    async def _utxo_apply_one(self, height: int, block) -> None:
        """One atomic connect (caller holds ``_utxo_lock`` and guarantees
        ``height`` is the first applicable one, ``max(watermark+1, 1)``);
        parse + write both off-loop.

        HASH-chain contiguity, not just height: after a reorg beneath the
        watermark, the new branch's block at watermark+1 does not extend
        the watermark block — applying it would stack the new branch's
        deltas on the orphaned branch's UTXO state.  The per-block UNDO
        log disconnects tip blocks back to the fork point when
        the records are retained (``utxo.undo_depth``, default 100);
        deeper reorgs keep the old behavior and go loudly STALE
        (``utxo.reorg_stale``), refusing further connects until the
        embedder rebuilds the set (delete the ``u/`` namespace and
        re-sync).

        Note the watermark gates on the block's verdicts having been
        *published*, not on every signature being valid: this node is a
        verification service reporting verdicts, not a consensus
        validator rejecting blocks (haskoin-node has no script
        validation at all) — gating on all-valid would
        wedge the watermark forever on one hostile signature."""
        assert self.utxo is not None
        if (
            self.utxo.block_hash is not None
            and block.header.prev != self.utxo.block_hash
        ):
            if await self._utxo_unwind_reorg(block):
                # the watermark rolled back to this block's branch; the
                # parked blocks were fetched against the OLD branch state
                # and may now be stale — drop them, re-delivery heals
                # (the fetch planner replans against the new best chain)
                self._utxo_pending.clear()
                bn = self.chain.get_block(block.header.hash)
                expected = max(self.utxo.height + 1, 1)
                if bn is None or bn.height < expected:
                    metrics.inc("utxo.skipped")
                    return
                if bn.height > expected:
                    # above the rolled-back watermark: park — its
                    # predecessors on the new branch are being fetched
                    if len(self._utxo_pending) < self.MAX_UTXO_PENDING:
                        self._utxo_pending[bn.height] = block
                        metrics.inc("utxo.deferred")
                    return
                height = bn.height
                if (
                    self.utxo.block_hash is not None
                    and block.header.prev != self.utxo.block_hash
                ):
                    return  # unwound, but this block is on a third branch
            else:
                metrics.inc("utxo.reorg_stale")
                events.emit(
                    "utxo.reorg_stale", height=height,
                    watermark=self.utxo.height,
                )
                log.error(
                    "[Node] UTXO set is STALE: block %d does not extend "
                    "the watermark block (reorg beneath height %d deeper "
                    "than the undo retention); rebuild the UTXO namespace "
                    "to resume",
                    height, self.utxo.height,
                )
                return
        try:
            await self._utxo_connect_off_loop(height, block)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            metrics.inc("utxo.errors")
            events.emit(
                "utxo.error", height=height, error=str(e)[:300]
            )
            log.warning(
                "[Node] utxo connect failed at height %d: %r", height, e
            )

    async def _utxo_connect_off_loop(self, height: int, block) -> None:
        """The physical connect, off-loop.  Native fast path:
        the C++ extractor computes the whole spend/create delta + undo
        rows in ONE pass over the wire bytes (``ParsedTxRegion.utxo_ops``
        -> ``UtxoStore.apply_ops_blob``), so no Python per-tx parse ever
        runs during block connect.  The Python ``apply_block`` path serves
        only eager blocks without raw bytes; both produce bit-identical
        stores (tests/test_torch_store.py)."""
        assert self.utxo is not None
        raw = getattr(block, "raw_txs", None)
        if raw is not None:
            utxo = self.utxo
            block_hash = block.header.hash
            n_txs = block.tx_count

            def connect_native():
                from .txextract import ParsedTxRegion

                with ParsedTxRegion(raw, n_txs) as region:
                    blob, created, spent = region.utxo_ops()
                    return utxo.apply_ops_blob(
                        height, block_hash, blob, created, spent
                    )

            await self._run_extract(connect_native)
        else:
            txs = await asyncio.to_thread(lambda: list(block.txs))
            await asyncio.to_thread(
                self.utxo.apply_block, height, block.header.hash, txs
            )

    async def _utxo_unwind_reorg(self, block) -> bool:
        """Disconnect tip blocks (per-block UNDO records) until
        the watermark block lies on ``block``'s branch — the fork point.
        True when the unwind reached it; False (store untouched beyond
        any blocks already unwound) when an undo record is missing
        (reorg deeper than retention) or the branch is unknown — the
        caller then falls back to loudly-stale."""
        assert self.utxo is not None
        bn = self.chain.get_block(block.header.hash)
        if bn is None:
            return False
        unwound = 0
        start = self.utxo.height
        while self.utxo.height >= 0:
            wm_hash = self.utxo.block_hash
            if wm_hash is not None and self.utxo.height <= bn.height:
                anc = self.chain.get_ancestor(self.utxo.height, bn)
                if anc is not None and anc.hash == wm_hash:
                    break  # the watermark is an ancestor: fork reached
            ok = await asyncio.to_thread(self.utxo.disconnect)
            if not ok:
                return False
            unwound += 1
        if unwound:
            metrics.inc("utxo.reorg_unwound")
            events.emit(
                "utxo.reorg_unwound", from_height=start,
                to_height=self.utxo.height, blocks=unwound,
            )
            log.info(
                "[Node] reorg: disconnected %d block(s), watermark %d -> %d",
                unwound, start, self.utxo.height,
            )
        return True

    def _count_unhandled(self, msg) -> None:
        """A peer message the event router has no handler for: count it
        (bounded label set — every decoded command is one of wire.py's
        fixed message classes; unknown commands decode to MsgOther and
        collapse into one label) so the next missing handler shows up in
        the metrics instead of vanishing."""
        if isinstance(msg, MsgNotFound):
            # not a missing handler: RPC replies are consumed by the
            # requester's own subscription (peer.get_data), and healthy
            # mempool fetch-retry traffic produces them steadily —
            # counting them would bury a real gap in noise
            return
        cmd = "other" if isinstance(msg, MsgOther) else getattr(
            msg, "command", "other"
        )
        metrics.inc("node.unhandled", labels={"cmd": cmd})

    async def _chain_events(self, sub) -> None:
        """Chain events -> PeerMgr best height + user bus
        (reference ``chainEvents`` Node.hs:130-142)."""
        while True:
            event = await sub.receive()
            if isinstance(event, ChainBestBlock):
                self.peer_mgr.set_best(event.node.height)
                if self.mempool is not None:
                    # chain activity triggers mempool housekeeping
                    # (orphan expiry, deferred fetch scheduling)
                    self.mempool.chain_event(event)
                if self.ibd is not None:
                    # new headers extend the fetch planner's target
                    self.ibd.nudge()
            self.cfg.pub.publish(event)

    async def _peer_events(self, sub) -> None:
        """Peer events -> demux raw messages to the managers + user bus
        (reference ``peerEvents`` Node.hs:144-174)."""
        mgr = self.peer_mgr
        chain = self.chain
        while True:
            event = await sub.receive()
            if isinstance(event, PeerConnected):
                chain.peer_connected(event.peer)
            elif isinstance(event, PeerDisconnected):
                chain.peer_disconnected(event.peer)
                if self.mempool is not None:
                    # release in-flight fetch slots + announcer entries
                    self.mempool.peer_gone(event.peer)
                if self.ibd is not None:
                    # in-flight block batches reassign to another peer
                    self.ibd.peer_gone(event.peer)
            elif isinstance(event, PeerMessage):
                p, msg = event.peer, event.message
                if isinstance(msg, MsgVersion):
                    mgr.version(p, msg)
                elif isinstance(msg, MsgVerAck):
                    mgr.verack(p)
                elif isinstance(msg, MsgPing):
                    mgr.ping(p, msg.nonce)
                elif isinstance(msg, MsgPong):
                    mgr.pong(p, msg.nonce)
                elif isinstance(msg, MsgAddr):
                    mgr.addrs(p, [na for _, na in msg.addrs])
                elif isinstance(msg, MsgHeaders):
                    chain.headers(p, [h for h, _ in msg.headers])
                elif self.mempool is not None and isinstance(msg, MsgInv):
                    # tx announcements feed the mempool's want-list;
                    # block invs are ignored (sync is headers-driven)
                    self.mempool.invs(
                        p,
                        [
                            iv.hash
                            for iv in msg.invs
                            if iv.type in (InvType.TX, InvType.WITNESS_TX)
                        ],
                    )
                elif self.mempool is not None and isinstance(msg, MsgTx):
                    # admission (dedup/orphan gate) before the engine
                    self.mempool.tx_pushed(p, msg.tx)
                elif self.verify_engine is not None and isinstance(msg, MsgTx):
                    self._submit_verify_tx(p, msg.tx)
                elif self.verify_engine is not None and isinstance(msg, MsgBlock):
                    # the block stays lazy (wire.LazyBlock): the native path
                    # never parses its txs in Python.  Confirmation
                    # eviction rides the ingest path (txids are computed
                    # there, natively when possible).
                    self._submit_verify(p, block=msg.block)
                elif isinstance(msg, MsgBlock) and (
                    self.mempool is not None or self.utxo is not None
                ):
                    # no verify engine: still evict confirmed txs and
                    # connect the persistent UTXO set
                    if self.mempool is not None:
                        self.mempool.block_connected(msg.block)
                    if self._persisted_height(msg.block) is None:
                        self._connect_block_utxo(msg.block)
                    else:
                        metrics.inc("node.block_replay_skipped")
                else:
                    self._count_unhandled(msg)
                # every message refreshes liveness (reference Node.hs:173)
                mgr.tickle(p)
            self.cfg.pub.publish(event)

    # Backpressure bound on in-flight ingest submissions (peer-facing DoS
    # guard: a flooding peer gets its excess dropped, mirroring how the
    # connect loop bounds the peer fleet rather than growing it).
    MAX_VERIFY_PENDING = 64
    # Mempool firehose bound: txs queued in the ingest accumulator.
    MAX_TX_ACCUM = 16384

    def _publish_shed(self, peer, n_txs: int) -> None:
        """Aggregate + rate-limit VerifyShed: under a sustained flood the
        shed path fires per message, and publishing each one would flood
        the user bus worse than the flood being shed.  At most ~2
        flushes/sec; each flush publishes ONE event PER SHEDDING PEER with
        that peer's own accumulated count, so per-peer DoS accounting in
        the embedder bans the right peer.  Counts
        accumulated inside the window are flushed by a delayed task so a
        burst that then stops is still reported."""
        self._shed_counts[peer] = self._shed_counts.get(peer, 0) + n_txs
        now = _time.monotonic()
        if now - self._shed_last_pub >= 0.5:
            self._flush_shed()
        elif self._shed_flush is None or self._shed_flush.done():

            async def flush_later():
                # sleep until the window actually reopens (a direct flush
                # may move _shed_last_pub while we wait) so the ~2/sec cap
                # holds even when direct and delayed flushes interleave
                while True:
                    remain = self._shed_last_pub + 0.5 - _time.monotonic()
                    if remain <= 0:
                        break
                    await asyncio.sleep(remain)
                if self._shed_counts:
                    self._flush_shed()

            self._shed_flush = self._verify_tasks.add_child(
                flush_later(), name="shed-flush"
            )

    def _flush_shed(self) -> None:
        self._shed_last_pub = _time.monotonic()
        pending = len(self._tx_accum) + self._verify_pending
        counts, self._shed_counts = self._shed_counts, {}
        for peer, n in counts.items():
            self.cfg.pub.publish(VerifyShed(peer, n, pending))

    def _resolve_ext_rows(
        self, region, bch: bool
    ) -> "tuple[Optional[list[int]], Optional[list[Optional[bytes]]]]":
        """External-oracle rows for a parsed region: per-input amounts and
        scriptPubKeys from the prevout oracle (mempool outputs first,
        then ``cfg.prevout_lookup``), aligned with the region's flat
        input order (only rows the tx-level wants gate marks are looked
        up).  Shared by block and mempool ingest."""
        lookup = self._prevout_oracle()
        if lookup is None:
            return None, None
        pv_txids, pv_vouts, pv_wants = region.scan_prevouts(bch)
        ext: list[int] = [-1] * len(pv_wants)
        ext_scripts: list[Optional[bytes]] = [None] * len(pv_wants)
        for i in pv_wants.nonzero()[0]:
            amt, script = _prevout_info(
                lookup(pv_txids[i].tobytes(), int(pv_vouts[i]))
            )
            if amt is not None:
                ext[int(i)] = amt
            if script is not None:
                ext_scripts[int(i)] = script
        return ext, ext_scripts

    def _submit_verify_tx(self, peer, tx) -> None:
        """Mempool-tx ingest: append the tx's raw wire bytes to the batch
        accumulator and make sure a drain task is running.  Coalescing many
        single-tx messages into one native extract + one engine batch is
        what lifts the firehose off the per-message task/thread overhead.
        A tx without raw wire bytes takes the per-message Python path."""
        raw = tx.raw
        if raw is None:
            self._submit_verify(peer, txs=[tx], raw=raw)
            return
        if len(self._tx_accum) >= self.MAX_TX_ACCUM:
            metrics.inc("node.verify_dropped")
            self._publish_shed(peer, 1)
            self._mempool_shed([tx])
            # the shed decision ends this message's pipeline: close its
            # trace unretained (a flood of shed stubs must not evict the
            # traces that matter from the rings)
            _discard_active_trace()
            return
        self._tx_accum.append((peer, tx, raw, _trace_current()))
        if self._tx_drain is None or self._tx_drain.done():
            self._tx_drain = self._verify_tasks.add_child(
                self._drain_tx_accum(), name="verify-tx-drain"
            )

    # Extract→verify overlap ring: how many drain batches may
    # sit between extraction start and verdict publish at once.  2 =
    # extraction of batch K+1 overlaps verification of K; the drain loop
    # blocks when the ring is full, which backpressures into MAX_TX_ACCUM.
    EXTRACT_RING = 2
    # Minimum txs per extraction shard: below this the per-shard native
    # call overhead beats the parallelism.
    MIN_SHARD_TXS = 64

    async def _run_extract(self, fn, *args, **kw):
        """Run one native-extraction step off-loop: in the shared worker
        pool, else via ``to_thread``."""
        pool = self._extract_pool
        if pool is not None:
            return await asyncio.get_running_loop().run_in_executor(
                pool, functools.partial(fn, *args, **kw)
            )
        return await asyncio.to_thread(fn, *args, **kw)

    def _shard_batch(self, batch: list) -> list[list]:
        """Split a drain batch into contiguous per-worker tx ranges
        (mempool txs are independent: ``intra_amounts`` is off, so the
        shards share nothing but the prevout oracle)."""
        workers = self._extract_workers
        if workers <= 1 or len(batch) < 2 * self.MIN_SHARD_TXS:
            return [batch]
        n = min(workers, len(batch) // self.MIN_SHARD_TXS)
        size = (len(batch) + n - 1) // n
        return [batch[i : i + size] for i in range(0, len(batch), size)]

    @staticmethod
    def _begin_tx_spans(batch: list, name: str) -> list:
        """Open one ``name`` span in EACH traced message's own trace."""
        recs = []
        for _, _, _, act in batch:
            if act is not None:
                recs.append((act[0], act[0].begin(name, act[1])))
        return recs

    @staticmethod
    def _end_tx_spans(recs: list) -> None:
        for tr, rec in recs:
            tr.end(rec)

    @staticmethod
    def _extract_and_close(region, **kw):
        """Worker-thread tail of a shard extract: the thread that runs
        the native extract also frees the handle.  Closing from the loop
        side would race a cancelled-but-still-running extract (awaiting
        an executor future stops WAITING on cancellation, it does not
        stop the thread) — txx_parse_free under a live txx_extract_h2 is
        a native use-after-free."""
        try:
            return region.extract(**kw)
        finally:
            region.close()

    async def _run_extract_owned(self, region, **kw):
        """Submit the extract with close-ownership attached: the worker
        thread closes the region when the job RUNS (`_extract_and_close`);
        a job cancelled while still QUEUED (node teardown, pool
        `cancel_futures`) never runs, so the done-callback closes it.

        The callback MUST watch the CONCURRENT future: it reports
        cancelled only when the cancel beat the job (no thread attached,
        close is safe).  The asyncio wrapper would report cancelled even
        while the job is still running (task cancellation cancels the
        wrapper regardless of ``concurrent.Future.cancel()`` failing) —
        closing on that signal is the very use-after-free this path
        exists to avoid."""
        pool = self._extract_pool
        assert pool is not None  # built with the engine
        cfut = pool.submit(
            self._extract_and_close, region, **kw
        )
        cfut.add_done_callback(
            lambda f: region.close() if f.cancelled() else None
        )
        return await asyncio.wrap_future(cfut)

    async def _extract_shard(self, shard: list, bch: bool):
        """One C++ extract over a contiguous run of accumulated txs
        (``intra_amounts`` off — mempool txs are independent, exactly
        like the old per-message path).  Returns RawSigItems, or None on
        failure (the caller isolates the offender per tx)."""
        from .txextract import ParsedTxRegion

        concat = b"".join(r for _, _, r, _ in shard)
        region = None
        submitted = False
        try:
            region = await self._run_extract(
                ParsedTxRegion, concat, len(shard)
            )
            # oracle lookups stay on the loop thread (they read
            # mempool/utxo state owned by it)
            ext, ext_scripts = self._resolve_ext_rows(region, bch)
            submitted = True  # from here the job owns close
            return await self._run_extract_owned(
                region,
                bch=bch,
                intra_amounts=False,
                ext_amounts=ext,
                ext_scripts=ext_scripts,
            )
        except asyncio.CancelledError:
            raise
        except Exception:
            return None
        finally:
            if region is not None and not submitted:
                region.close()

    async def _ring_acquire(self) -> None:
        await self._extract_ring.acquire()
        self._ring_busy += 1
        metrics.set_gauge("sched.ring_occupancy", float(self._ring_busy))

    def _ring_release(self) -> None:
        self._ring_busy -= 1
        metrics.set_gauge("sched.ring_occupancy", float(self._ring_busy))
        self._extract_ring.release()

    async def _drain_tx_accum(self) -> None:
        """Drain the mempool accumulator in batches: C++ extraction
        sharded over the worker pool (``NodeConfig.extract_workers``
        contiguous tx ranges in parallel), each shard one engine
        submission (the lane packer re-bins them into full device lanes),
        verdict publication through a bounded ring so extraction of
        batch K+1 overlaps verification of K.  A malformed tx poisons
        only itself: on shard extract failure each of its txs retries
        individually (:meth:`_verify_txs_native`), so one hostile peer
        cannot fail other peers' verdicts."""
        bch = self.cfg.net.bch
        # The drain task inherited the FIRST accumulated message's trace
        # context at creation and outlives it by many batches: clear it —
        # per-tx spans are recorded into each tx's OWN trace below.
        _clear_active_trace()
        # Bounded drain batches: one giant extract+verify would add seconds
        # of verdict latency under flood; ~2k txs keeps the engine fed in
        # device-batch-sized bites while verdicts keep flowing.
        DRAIN_BATCH = 2048
        while self._tx_accum:
            batch = self._tx_accum[:DRAIN_BATCH]
            del self._tx_accum[:DRAIN_BATCH]
            shards = self._shard_batch(batch)
            # per-tx extract spans in each tx's own trace (they bound the
            # whole sharded extraction: begin before, end when all shards
            # land — exact per shard, conservative across shards)
            recs = self._begin_tx_spans(batch, "node.extract")
            try:
                # span(): the metrics histogram (stage busy fractions);
                # the per-tx trace records are the recs above
                with span("node.extract"):
                    extracted = await asyncio.gather(
                        *(self._extract_shard(s, bch) for s in shards)
                    )
            finally:
                self._end_tx_spans(recs)
            pairs = []
            for shard, items in zip(shards, extracted):
                if items is None:
                    # isolate the offender: each tx goes through the
                    # single-tx native path on its own (error verdicts +
                    # peer kill there; finishes each tx's trace too)
                    for peer, tx, raw, act in shard:
                        with _activate_trace(act):
                            await self._verify_txs_native(
                                peer, raw, 1, txs=[tx], tracked=False
                            )
                    continue
                pairs.append((shard, items))
            if not pairs:
                continue
            if self._extract_workers > 1:
                # ring stage: ONE slot per drain batch (a slot per shard
                # would let 2 of N shards stall the loop and shrink the
                # K+1/K overlap to a fraction of a batch); all shards'
                # verdicts publish in a supervised child while this loop
                # extracts the next batch
                await self._ring_acquire()
                self._verify_tasks.add_child(
                    self._commit_batch(pairs, ring=True),
                    name="verify-drain-commit",
                )
            else:
                # serial A/B baseline: extract → verify → publish
                await self._commit_batch(pairs, ring=False)

    async def _commit_batch(self, pairs: list, ring: bool) -> None:
        """Commit one drain batch's extracted shards: all shards submit
        to the engine concurrently (the packer coalesces them into full
        lanes) and the ring slot frees when the whole batch published."""
        try:
            await asyncio.gather(
                *(self._commit_drained(shard, items)
                  for shard, items in pairs)
            )
        finally:
            if ring:
                self._ring_release()

    async def _commit_drained(self, shard: list, items) -> None:
        """Await one extracted shard's verdicts and publish per-tx
        TxVerdicts (each into its own trace)."""
        act0 = next((a for _, _, _, a in shard if a is not None), None)
        try:
            metrics.inc("node.verify_txs", len(shard))
            metrics.inc("node.verify_inputs", int(items.tx_n_inputs.sum()))
            verdicts: list[bool] = []
            if items.count:
                try:
                    assert self.verify_engine is not None
                    # the verify.queue span lands in the first traced
                    # submitter's tree (the packer's act0 convention).
                    # The first txid's key is the submission's placement
                    # hint (the single-host engine keeps it; a fleet
                    # routes by it).
                    aff = self._affinity(lambda: shard[0][1].txid)
                    with _activate_trace(act0):
                        verdicts = await self.verify_engine.verify_raw(
                            items, priority="mempool", affinity=aff
                        )
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    self._verify_failure("engine", e)
                    for ti, (peer, _, _, _) in enumerate(shard):
                        self._publish_verdict(
                            TxVerdict(peer, items.txid(ti), False, (),
                                      items.stats(ti),
                                      error=f"engine: {e}")
                        )
                    return
            per_sig = items.combine(verdicts)
            sig_slices = items.sig_slices()
            for ti, (peer, _, _, act) in enumerate(shard):
                vs = tuple(per_sig[sig_slices[ti]])
                # per-tx commit span in the tx's OWN trace
                with _activate_trace(act):
                    with span("node.commit"):
                        self._publish_verdict(
                            TxVerdict(peer, items.txid(ti), all(vs), vs,
                                      items.stats(ti))
                        )
        finally:
            # traces end AFTER the spans close, so a finished trace is
            # never mutated (retention/export reads it immediately)
            self._finish_batch_traces(shard)

    @staticmethod
    def _finish_batch_traces(batch) -> None:
        """Finish every accumulated message's trace at its verdict (the
        per-message traces are distinct; finish is idempotent anyway)."""
        for _, _, _, act in batch:
            if act is not None:
                tracer.finish(act[0])

    def _submit_verify(
        self,
        peer,
        txs: Optional[list[Tx]] = None,
        raw: Optional[bytes] = None,
        block=None,
    ) -> None:
        """Fan inbound transactions into the batch verify engine without
        blocking the event-routing loop; one TxVerdict per tx lands on the
        user bus when its batch completes (or fails: ``error`` set).

        Tx messages pass ``txs`` (+ ``raw`` wire bytes); block messages
        pass ``block`` (a wire.LazyBlock), whose tx region is handed to
        the native extractor without ever parsing txs in Python.  Wire
        bytes are always extracted in C++; the Python path serves only a
        tx or an eager block that carries no wire bytes."""
        if block is not None and self._persisted_height(block) is not None:
            # restart replay: this block is at or below the
            # persistent UTXO watermark — it was fully verified AND its
            # UTXO delta durably applied before a crash/restart, so
            # re-delivery costs nothing: no extract, no engine batch,
            # no re-apply.
            metrics.inc("node.block_replay_skipped")
            _discard_active_trace()
            return
        n_txs = block.tx_count if block is not None else len(txs)
        if self._verify_pending >= self.MAX_VERIFY_PENDING:
            metrics.inc("node.verify_dropped", n_txs)
            self._publish_shed(peer, n_txs)
            if txs is not None:  # block txs are never mempool-admitted
                self._mempool_shed(txs)
            _discard_active_trace()  # shed: pipeline ends here, unretained
            return
        self._verify_pending += 1
        if block is not None:
            raw = block.raw_txs
        if raw is not None:
            coro = self._verify_txs_native(peer, raw, n_txs, block=block, txs=txs)
        else:
            if txs is None:
                try:
                    txs = list(block.txs)  # python fallback parses lazily
                except Exception as e:
                    # Malformed lazy tx region: the eager decode used to
                    # surface this as a DecodeError in the peer loop (and
                    # kill the peer); with lazy blocks it surfaces here —
                    # report it and kill the peer, never crash the router.
                    self._verify_pending -= 1
                    self._verify_failure("block-decode", e)
                    self._publish_verdict(
                        TxVerdict(peer, b"", False, (), ExtractStats(),
                                  error=f"block decode: {e}")
                    )
                    peer.kill(CannotDecodePayload(f"block: {e}"))
                    _finish_active_trace()  # verdict published: trace ends
                    return
            if block is not None and self.mempool is not None:
                # python-path block connect: txs parsed above anyway
                self.mempool.confirmed([tx.txid for tx in txs])
            coro = self._verify_txs(peer, txs, block=block)
        self._verify_tasks.add_child(coro, name="verify-txs")

    async def _verify_txs_native(
        self,
        peer,
        raw: bytes,
        n_txs: int,
        block=None,
        txs: Optional[list[Tx]] = None,
        tracked: bool = True,  # False: caller owns _verify_pending
    ) -> None:
        """Native-extract fast path of :meth:`_verify_txs`: parse + sighash +
        DER + pubkey decode run in C++ over the original wire bytes
        (txextract.py), and the packed item arrays go to the engine
        with no per-item Python objects — for a block, not even Tx objects
        (prevouts for the amount oracle come from ``scan_prevouts``, C++
        too).  Bit-identical verdicts to the Python path
        (tests/test_torch_txextract.py); one behavioral difference: a
        malformed-region extract error fails the whole message's txs
        (the Python path can fail per tx)."""
        assert self.verify_engine is not None
        from .txextract import ParsedTxRegion

        bch = self.cfg.net.bch

        def _publish_extract_error(e: Exception) -> None:
            self._verify_failure("extract", e)
            txids: list[bytes] = []
            try:
                src = txs if txs is not None else block.txs
                txids = [tx.txid for tx in src]
            except Exception:
                # tx region unparseable (lazy tx/block): one aggregate
                # verdict, and the peer dies as under eager decode
                txids = [b""]
                peer.kill(CannotDecodePayload(str(e)))
            for txid in txids:
                self._publish_verdict(
                    TxVerdict(peer, txid, False, (), ExtractStats(),
                              error=f"extract: {e}")
                )

        region: Optional[ParsedTxRegion] = None
        submitted = False  # once the extract job is in a worker thread,
        # that thread owns region.close (see _extract_and_close)
        try:
            # ONE native parse feeds both the prevout listing and the
            # extraction (ParsedTxRegion; the amount-oracle path used to
            # parse the region twice more).
            with span("node.extract"):
                try:
                    # shared worker pool: several blocks'
                    # regions parse/extract in parallel
                    region = await self._run_extract(
                        ParsedTxRegion, raw, n_txs
                    )
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    _publish_extract_error(e)
                    return
                # Out-of-block prevout rows via the embedder's oracle,
                # flattened per input in parse order.  The native side
                # consults its intra-block map FIRST, so resolving every
                # wants-marked input here matches the Python path's
                # block_outs -> prevout_lookup precedence (an in-block hit
                # shadows whatever the oracle would have said).
                ext, ext_scripts = self._resolve_ext_rows(region, bch)
                # BLOCK regions shard across the worker pool as contiguous
                # tx ranges, exactly like mempool drains: the
                # intra-block prevout map is built ONCE on the shared
                # handle (read-only for the range jobs), so sharded
                # extraction is bit-identical to serial (pinned by
                # tests/test_torch_txextract.py).
                shard_block = (
                    block is not None
                    and self._extract_workers > 1
                    and region.n_txs >= 2 * self.MIN_SHARD_TXS
                )
                try:
                    if shard_block:
                        submitted = True
                        shards = await self._extract_block_sharded(
                            region, bch, ext, ext_scripts
                        )
                    else:
                        submitted = True
                        shards = [await self._run_extract_owned(
                            region,
                            bch=bch,
                            intra_amounts=n_txs > 1,
                            ext_amounts=ext,
                            ext_scripts=ext_scripts,
                        )]
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    _publish_extract_error(e)
                    return
            if block is not None and self.mempool is not None:
                # block connect: evict confirmed txs from the mempool.
                # The txids come from the native extract — no Python
                # parse — and arrive before the verdicts do.
                self.mempool.confirmed(
                    [it.txid(ti) for it in shards
                     for ti in range(it.n_txs)]
                )
            metrics.inc(
                "node.verify_txs", sum(it.n_txs for it in shards)
            )
            metrics.inc(
                "node.verify_inputs",
                sum(int(it.tx_n_inputs.sum()) for it in shards),
            )
            # every shard is its own engine submission (the lane packer
            # coalesces them into full device lanes); planner-era
            # backfill rides the "ibd" class beneath live traffic
            priority = (
                self._block_priority() if block is not None else "mempool"
            )
            # block affinity: a block's shards share one key (the block
            # hash), so a fleet verifies the whole block on one host
            aff = self._affinity(
                lambda: block.header.hash if block is not None
                else txs[0].txid if txs else b""
            )
            clean = all(await asyncio.gather(*(
                self._commit_items(peer, it, priority, aff)
                for it in shards
            )))
            if block is not None and clean:
                # persistent UTXO connect only AFTER the block's verdicts
                # are published: the watermark means "verified AND
                # applied", so a crash mid-verify must leave the block
                # unpersisted for its re-delivery to re-verify (extract/
                # engine failure paths return before reaching here)
                self._connect_block_utxo(block)
        finally:
            if region is not None and not submitted:
                region.close()
            if tracked:
                self._verify_pending -= 1
            # the item's pipeline trace (if any) ends with its verdicts
            _finish_active_trace()

    async def _commit_items(
        self, peer, items, priority: str, affinity: Optional[int] = None
    ) -> bool:
        """Engine round + verdict publication for one RawSigItems batch
        (a whole message, or one tx-range shard of a block).  Returns
        False when the engine failed (error verdicts published)."""
        assert self.verify_engine is not None
        verdicts: list[bool] = []
        if items.count:
            try:
                verdicts = await self.verify_engine.verify_raw(
                    items, priority=priority, affinity=affinity
                )
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self._verify_failure("engine", e)
                for ti in range(items.n_txs):
                    self._publish_verdict(
                        TxVerdict(peer, items.txid(ti), False, (),
                                  items.stats(ti), error=f"engine: {e}")
                    )
                return False
        # candidate verdicts -> per-signature verdicts (consensus walk)
        with span("node.commit"):
            per_sig = items.combine(verdicts)
            for ti, sl in enumerate(items.sig_slices()):
                vs = tuple(per_sig[sl])
                self._publish_verdict(
                    TxVerdict(peer, items.txid(ti), all(vs), vs,
                              items.stats(ti))
                )
        return True

    async def _extract_block_sharded(self, region, bch: bool, ext,
                                     ext_scripts) -> list:
        """Split a parsed BLOCK region into contiguous per-worker
        tx-range sub-extractions.  The shared intra-block
        prevout map is built once (off-loop) before the range jobs go to
        the pool; each job's oracle rows are the range's slice of the
        whole-region rows.  Close ownership is collective: the region is
        freed when the LAST submitted job finishes (or every queued job
        is cancelled before running) — never under a live extract."""
        n = region.n_txs
        w = min(self._extract_workers, n // self.MIN_SHARD_TXS)
        if n > 1:
            await self._run_extract(region.build_intra)
        off = region.input_offsets()
        size = (n + w - 1) // w
        jobs = []
        for lo in range(0, n, size):
            hi = min(lo + size, n)
            fl, fh = int(off[lo]), int(off[hi])
            jobs.append(functools.partial(
                region.extract_range, lo, hi,
                bch=bch,
                intra_amounts=n > 1,
                ext_amounts=ext[fl:fh] if ext is not None else None,
                ext_scripts=(
                    ext_scripts[fl:fh] if ext_scripts is not None else None
                ),
            ))
        assert self._extract_pool is not None  # built with the engine
        cfuts = []
        try:
            for job in jobs:
                cfuts.append(self._extract_pool.submit(job))
        finally:
            self._close_when_done(region, cfuts)
        return list(await asyncio.gather(
            *(asyncio.wrap_future(f) for f in cfuts)
        ))

    @staticmethod
    def _close_when_done(region, cfuts: list) -> None:
        """Free a shared region handle once every submitted job is out of
        the pool (finished OR cancelled-before-running).  The callbacks
        watch the CONCURRENT futures — the only signal that cannot fire
        while a worker thread still holds the handle (the same
        use-after-free discipline as `_run_extract_owned`)."""
        if not cfuts:
            region.close()
            return
        state = {"remaining": len(cfuts)}
        lock = threadsan.lock("node.region_refcount")

        def _done(_f):
            with lock:
                state["remaining"] -= 1
                last = state["remaining"] == 0
            if last:
                region.close()

        for f in cfuts:
            f.add_done_callback(_done)

    async def _verify_txs(self, peer, txs: list[Tx], block=None) -> None:
        """Verify every tx of one message.  All txs' signatures are submitted
        to the engine CONCURRENTLY so a whole block coalesces into full
        device batches (awaiting per tx would degrade a 150k-sig block into
        sequential tiny batches).  ``block``: the originating block, UTXO-
        connected only after every verdict published without an error."""
        assert self.verify_engine is not None
        # Intra-block prevouts: a block message carries the funding tx for
        # every in-block spend — exactly what BIP143 (amount) and BIP341
        # (amount + script) digests need.
        # Misses fall through to cfg.prevout_lookup.
        block_outs = intra_block_prevouts(txs) if len(txs) > 1 else {}
        oracle = self._prevout_oracle()
        per_tx: list[tuple[Tx, ExtractStats, list, Optional[asyncio.Task]]] = []
        clean = True  # no extract/engine error verdicts published
        try:
            with span("node.extract"):
                for tx in txs:
                    try:
                        # everything touching tx attributes goes inside the
                        # guard: a malformed LazyTx (wire.LazyTx) raises on
                        # first attribute access, which must become an error
                        # verdict + peer kill, never a dead ingest task
                        amounts: dict[int, int] = {}
                        scripts: dict[int, bytes] = {}
                        for idx, txin in enumerate(tx.inputs):
                            key = (txin.prevout.txid, txin.prevout.index)
                            # Precedence mirrors the native resolve(): the
                            # intra-block map is consulted for EVERY input (a
                            # dict hit is free, and classification must see
                            # in-block P2TR scripts identically on both
                            # paths); the external oracle only for inputs the
                            # tx-level witness gate marks.
                            hit = block_outs.get(key)
                            if hit is not None:
                                amt, script = hit
                            elif oracle is not None and (
                                wants_amount(tx, idx, self.cfg.net.bch)
                            ):
                                amt, script = _prevout_info(oracle(*key))
                            else:
                                amt = script = None
                            if amt is not None:
                                amounts[idx] = amt
                            if script is not None:
                                scripts[idx] = script
                        items, stats = extract_sig_items(
                            tx,
                            prevout_amounts=amounts or None,
                            bch=self.cfg.net.bch,
                            prevout_scripts=scripts or None,
                        )
                    except Exception as e:
                        clean = False
                        self._verify_failure("extract", e)
                        try:
                            txid = tx.txid
                        except Exception:
                            txid = b""  # unparseable lazy tx: aggregate
                            peer.kill(CannotDecodePayload(f"tx: {e}"))
                        self._publish_verdict(
                            TxVerdict(peer, txid, False, (), ExtractStats(),
                                      error=f"extract: {e}")
                        )
                        continue
                    metrics.inc("node.verify_txs")
                    metrics.inc("node.verify_inputs", stats.total_inputs)
                    task = None
                    if items:
                        task = spawn_supervised(
                            self.verify_engine.verify(
                                [i.verify_item for i in items],
                                priority=(
                                    self._block_priority()
                                    if block is not None
                                    else "mempool"
                                ),
                            ),
                            name="verify-sigbatch",
                            owner=self._verify_tasks,
                        )
                    per_tx.append((tx, stats, items, task))
            # Awaiting the engine happens OUTSIDE any commit span — the
            # wait is already attributed by the verify.queue spans, and
            # folding it into node.commit would make that histogram mean
            # something different on this path than on the native one.
            for tx, stats, items, task in per_tx:
                if task is None:
                    self._publish_verdict(
                        TxVerdict(peer, tx.txid, True, (), stats)
                    )
                    continue
                try:
                    verdicts = await task
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    clean = False
                    self._verify_failure("engine", e)
                    self._publish_verdict(
                        TxVerdict(peer, tx.txid, False, (), stats,
                                  error=f"engine: {e}")
                    )
                    continue
                # candidate verdicts -> per-signature (consensus walk)
                with span("node.commit"):
                    per_sig = tuple(combine_verdicts(items, verdicts))
                    self._publish_verdict(
                        TxVerdict(peer, tx.txid, all(per_sig), per_sig,
                                  stats)
                    )
            if block is not None and clean:
                # persistent UTXO connect only AFTER every verdict landed
                # cleanly (mirrors the native path): the watermark means
                # "verified AND applied" — an error-verdict block stays
                # unpersisted so its re-delivery re-verifies
                self._connect_block_utxo(block)
        finally:
            self._verify_pending -= 1
            for _, _, _, task in per_tx:
                if task is not None and not task.done():
                    task.cancel()
            # the message's pipeline trace (if any) ends with its verdicts
            _finish_active_trace()


class _TCPConnection:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._reader = reader
        self._writer = writer

    async def read_chunk(self) -> bytes:
        return await self._reader.read(65536)

    async def write(self, data: bytes) -> None:
        self._writer.write(data)
        await self._writer.drain()


def _numeric_host(host: str) -> bool:
    """Is ``host`` a numeric IPv4/IPv6 literal (zone id allowed)?"""
    import ipaddress

    try:
        ipaddress.ip_address(host.split("%", 1)[0])
        return True
    except ValueError:
        return False


def tcp_connect(sa: SockAddr) -> WithConnection:
    """Production transport (reference ``withConnection`` Node.hs:108-128).

    NUMERIC hosts only (reference ``fromSockAddr`` resolves with
    NumericHost): hostnames are resolved ONCE at address-book build time
    (``peermgr.to_sock_addr``), so the connect path itself never performs
    a DNS lookup — a slow or wedged resolver must not stall a peer slot
    for its whole connect timeout.  A non-numeric host here is a caller
    bug and fails fast as PeerAddressInvalid."""

    @contextlib.asynccontextmanager
    async def factory():
        if not _numeric_host(sa[0]):
            raise PeerAddressInvalid(
                f"{sa}: non-numeric host (resolve via to_sock_addr first)"
            )
        try:
            reader, writer = await asyncio.open_connection(sa[0], sa[1])
        except OSError as e:
            raise PeerAddressInvalid(f"{sa}: {e}") from e
        try:
            yield _TCPConnection(reader, writer)
        finally:
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    return factory
