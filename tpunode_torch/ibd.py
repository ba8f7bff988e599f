"""Block-fetch-driven IBD: the fetch planner behind ``NodeConfig.ibd``
.

Without it the node's block ingest is embedder-driven: headers sync
through the chain actor, but block BODIES arrive only when the embedding
process pushes them or drives ``peer.get_blocks`` windows itself.
:class:`BlockFetcher` closes that gap: a bare ``Node`` syncs the whole
chain by itself, the way the mempool's inv-driven fetch pipeline
self-drives tx relay.

Shape (deliberately the mempool fetcher's, mempool.py):

* the planner walks the **persisted chain from the UTXO watermark** —
  restart resumes exactly where the store says verification stopped, so a
  kill -9 mid-sync re-fetches (and re-verifies) nothing below the
  watermark (the UTXO store's crash contract, end to end);
* block hashes come from an incrementally-maintained height->hash view of
  the best chain (one O(1) step per new header, one bounded walk per
  reorg) — never an O(n) ancestor walk per batch;
* ``getdata`` batches (``batch_blocks`` hashes each) are spread across the
  online peer fleet best-RTT-first with a per-peer in-flight cap; a
  failed/timed-out batch retries from another peer (its ``tried`` set
  rotates the fleet), and a dead peer's batches reassign immediately;
* delivered blocks arrive through the NORMAL peer-message path (the wire
  loop publishes them; ``node._peer_events`` routes them into verify
  ingest + UTXO connect) — the planner never touches block bytes, so
  admission stays single-path exactly like mempool fetch;
* scheduling is watermark-gated: at most ``max_lead`` blocks beyond the
  watermark are ever in flight (bounded by the node's out-of-order
  parking), and planning defers while verify-ingest pressure is high —
  the planner can saturate the pipeline but never outrun it into the
  shed path;
* a delivered-but-stuck head batch (its blocks shed, or lost to an engine
  failure) is re-fetched after ``refetch_after`` seconds — the watermark
  can stall but never wedge.

Telemetry: ``ibd.*`` metrics/events (OBSERVABILITY.md).  Engine-side, the
node submits planner-era block batches at the ``ibd`` priority — beneath
live ``block``/``mempool`` traffic in the lane packer — so a backfilling
node still serves fresh verdicts first (verify/sched.py).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Callable, Optional

from .actors import LinkedTasks, Supervisor
from .events import events
from .metrics import metrics
from .peer import get_blocks

__all__ = ["IbdConfig", "BlockFetcher"]

log = logging.getLogger("tpunode_torch.ibd")


@dataclass
class IbdConfig:
    """Fetch-planner knobs (``NodeConfig.ibd``).  The defaults keep the
    total in-flight block count under the node's verify-pending and
    out-of-order-parking bounds, so a healthy sync never sheds."""

    # blocks per getdata batch (one peer round-trip)
    batch_blocks: int = 16
    # concurrent batches per peer
    max_inflight_per_peer: int = 2
    # per-batch RPC timeout (the trailing-ping sentinel bounds the wait)
    fetch_timeout: float = 45.0
    # max blocks scheduled beyond the UTXO watermark: bounds in-flight
    # memory AND stays inside Node.MAX_VERIFY_PENDING (64 messages) and
    # MAX_UTXO_PENDING (128 parked) so healthy syncs never shed
    max_lead: int = 48
    # a delivered head batch whose blocks still have not connected after
    # this long is re-fetched (heals shed/failed ingest; in a healthy sync
    # this never fires, keeping verdicts exactly-once)
    refetch_after: float = 30.0
    # planner cadence (timeouts/retries are detected on ticks; deliveries
    # and chain events wake it immediately)
    tick_interval: float = 0.5


class _Batch:
    """One scheduled getdata window: heights ``[lo, hi]`` on the best
    chain.  States: queued -> fetching -> delivered (-> dropped once the
    watermark passes ``hi``); failures return it to queued."""

    __slots__ = (
        "lo", "hi", "hashes", "state", "peer", "task", "tried",
        "attempts", "delivered_at",
    )

    def __init__(self, lo: int, hi: int, hashes: list[bytes]):
        self.lo = lo
        self.hi = hi
        self.hashes = hashes
        self.state = "queued"
        self.peer = None
        self.task: Optional[asyncio.Task] = None
        self.tried: set = set()
        self.attempts = 0
        self.delivered_at = 0.0


class BlockFetcher:
    """The IBD fetch planner.  Constructed by ``Node`` (never directly);
    lives inside the node bracket like the other subsystems."""

    def __init__(
        self,
        cfg: IbdConfig,
        net,
        chain,
        peer_mgr,
        utxo,
        pressure: Callable[[], bool],
        on_failure=None,
    ):
        self.cfg = cfg
        self._net = net
        self._chain = chain
        self._peer_mgr = peer_mgr
        self._utxo = utxo
        self._pressure = pressure
        # host-affine gate: true for a BLOCK HASH whose
        # target verify host is over its feed ceiling — _assign skips
        # just that batch instead of deferring the whole plan
        self._tasks = LinkedTasks(name="ibd", on_failure=on_failure)
        # fetch RPCs are crash-isolated: one failed getdata must never
        # tear the node down (failure returns the batch to queued)
        self._fetchers = Supervisor(name="ibd-fetch")
        self._wake = asyncio.Event()
        self._batches: dict[int, _Batch] = {}  # keyed by lo height
        self._inflight: dict[object, int] = {}
        self._hashes: dict[int, bytes] = {}  # best-chain height -> hash
        self._cache_best: Optional[bytes] = None
        self._cache_floor = 1 << 62  # lowest height the view covers
        self._target = 0
        self._announced = False
        self.synced = asyncio.Event()  # wm reached the header tip once
        self._fetched_blocks = 0
        self._refetches = 0
        self._retries = 0

    # -- lifecycle -----------------------------------------------------------

    async def __aenter__(self) -> "BlockFetcher":
        self._tasks.link(self._main_loop(), name="ibd-planner")
        return self

    async def __aexit__(self, *exc) -> None:
        await self._fetchers.aclose()
        await self._tasks.__aexit__(*exc)

    # -- wiring from the node's routers (event-loop only) ---------------------

    def nudge(self) -> None:
        """Chain activity (new best header) or a delivered block: plan."""
        self._wake.set()

    def peer_gone(self, peer) -> None:
        """A peer died: its in-flight batches reassign immediately instead
        of waiting out the RPC timeout."""
        self._inflight.pop(peer, None)
        for b in self._batches.values():
            if b.state == "fetching" and b.peer is peer:
                if b.task is not None and not b.task.done():
                    b.task.cancel()  # -> _fetch's finally requeues it
        self._wake.set()

    # -- introspection --------------------------------------------------------

    @property
    def backfilling(self) -> bool:
        """True while the watermark trails the header tip by more than
        the planner's lead window: the node tags block verify submissions
        ``ibd`` (beneath live traffic) during a genuine backfill and
        ``block`` otherwise.  The margin matters: on a SYNCED node a live
        block's headers land (bumping the target) before its UTXO connect
        advances the watermark, so a trail of a few blocks is the normal
        live-tip state — classifying it ``ibd`` would put fresh blocks
        beneath mempool relay, inverting the block > mempool ordering
       ."""
        return self._target - self._utxo.height > self.cfg.max_lead

    def stats(self) -> dict:
        return {
            "enabled": True,
            "target": self._target,
            "watermark": self._utxo.height,
            "batches": len(self._batches),
            "inflight": sum(self._inflight.values()),
            "fetched_blocks": self._fetched_blocks,
            "retries": self._retries,
            "refetches": self._refetches,
        }

    # -- planner --------------------------------------------------------------

    async def _main_loop(self) -> None:
        while True:
            try:
                await asyncio.wait_for(
                    self._wake.wait(), self.cfg.tick_interval
                )
            except (asyncio.TimeoutError, TimeoutError):
                pass
            self._wake.clear()
            self._plan()

    def _best(self):
        try:
            return self._chain.get_best()
        except Exception:
            return None  # chain DB not initialized yet

    def _plan(self) -> None:
        best = self._best()
        if best is None:
            return
        self._target = best.height
        wm = self._utxo.height
        metrics.set_gauge("ibd.target", float(self._target))
        if not self._announced and self._target > wm:
            self._announced = True
            events.emit(
                "ibd.start", watermark=wm, target=self._target,
            )
        # connected batches retire; stale cache entries prune
        for lo in [lo for lo, b in self._batches.items() if b.hi <= wm]:
            del self._batches[lo]
        for h in [h for h in self._hashes if h <= wm]:
            del self._hashes[h]
        self._cache_floor = max(self._cache_floor, wm + 1)
        if wm >= self._target:
            if self._target > 0 and not self.synced.is_set():
                self.synced.set()
                events.emit("ibd.synced", height=wm)
                log.info("[IBD] watermark reached header tip %d", wm)
            metrics.set_gauge("ibd.inflight_blocks", 0.0)
            return
        self.synced.clear()
        now = time.monotonic()
        # head-of-line healing: the batch holding wm+1 was delivered but
        # never connected (shed under pressure, or its ingest failed) —
        # after the grace window, fetch it again
        head = next(
            (b for b in self._batches.values() if b.lo <= wm + 1 <= b.hi),
            None,
        )
        if (
            head is not None
            and head.state == "delivered"
            and now - head.delivered_at > self.cfg.refetch_after
        ):
            head.state = "queued"
            head.tried.clear()
            self._refetches += 1
            metrics.inc("ibd.refetches")
            events.emit("ibd.refetch", lo=head.lo, hi=head.hi)
        if self._pressure():
            metrics.inc("ibd.deferred")
            return  # the tick retries once ingest drains
        self._refresh_hashes(best)
        # a reorg may have rewritten heights under planned batches: a
        # batch whose hashes no longer match the best-chain view fetches
        # orphaned blocks nobody can connect — drop it and replan
        for lo in [
            lo for lo, b in self._batches.items()
            if any(
                self._hashes.get(h) != hh
                for h, hh in zip(range(b.lo, b.hi + 1), b.hashes)
                if h > wm  # connected heights are pruned from the view
            )
        ]:
            b = self._batches.pop(lo)
            if b.task is not None and not b.task.done():
                b.state = "dropped"  # _fetch_done ignores it
                b.task.cancel()
            metrics.inc("ibd.reorg_dropped")
        # extend the plan over every uncovered height up to the lead
        # horizon.  Not just past the highest batch: after a reorg unwind
        # the watermark sits BELOW surviving batches, and the gap in
        # front of them is exactly what must be fetched next.
        horizon = min(self._target, wm + self.cfg.max_lead)
        for lo, hi in self._uncovered(max(wm + 1, 1), horizon):
            next_h = lo
            while next_h <= hi:
                b_hi = min(next_h + self.cfg.batch_blocks - 1, hi)
                hashes = [
                    self._hashes.get(h) for h in range(next_h, b_hi + 1)
                ]
                if any(h is None for h in hashes):
                    break  # header gap (mid-reorg): replan on the next tick
                self._batches[next_h] = _Batch(next_h, b_hi, hashes)
                next_h = b_hi + 1
        metrics.set_gauge(
            "ibd.inflight_blocks",
            float(sum(
                b.hi - b.lo + 1
                for b in self._batches.values()
                if b.state == "fetching"
            )),
        )
        self._assign()

    def _uncovered(self, lo: int, hi: int) -> list[tuple[int, int]]:
        """Height ranges in ``[lo, hi]`` not covered by any batch."""
        gaps: list[tuple[int, int]] = []
        cur = lo
        for b_lo, b_hi in sorted(
            (b.lo, b.hi) for b in self._batches.values()
        ):
            if b_lo > cur:
                gaps.append((cur, min(b_lo - 1, hi)))
            cur = max(cur, b_hi + 1)
            if cur > hi:
                break
        if cur <= hi:
            gaps.append((cur, hi))
        return [(a, b) for a, b in gaps if a <= b]

    def _refresh_hashes(self, best) -> None:
        """Maintain the height->hash view of the best chain: O(1) per tip
        extension, one bounded walk down to the first already-agreeing
        entry after a reorg.  The view covers ``[watermark+1, best]`` —
        ``_cache_floor`` tracks its lower edge so a reorg unwind that
        moves the watermark BACKWARD re-fills the newly-needed heights
        (early-stopping on an agreeing entry is only sound when the
        cached range already reaches the floor)."""
        floor = max(self._utxo.height, 0)
        covered = self._cache_floor <= floor + 1
        if best.hash == self._cache_best and covered:
            return
        node = best
        while node is not None and node.height > floor:
            if covered and self._hashes.get(node.height) == node.hash:
                break  # below here the cached view already agrees
            self._hashes[node.height] = node.hash
            node = self._chain.get_block(node.header.prev)
        self._cache_floor = min(self._cache_floor, floor + 1)
        self._cache_best = best.hash
        # a reorg may have shortened the chain: drop orphaned heights
        for h in [h for h in self._hashes if h > best.height]:
            del self._hashes[h]

    def _assign(self) -> None:
        """Hand queued batches to online peers with capacity, lowest
        heights first (the watermark only advances contiguously)."""
        peers = self._peer_mgr.get_peers()  # online, best median RTT first
        if not peers:
            return
        cap = self.cfg.max_inflight_per_peer
        for lo in sorted(self._batches):
            b = self._batches[lo]
            if b.state != "queued":
                continue
            pick = next(
                (o.peer for o in peers
                 if self._inflight.get(o.peer, 0) < cap
                 and o.peer not in b.tried),
                None,
            )
            if pick is None:
                # every capable peer already failed this batch: rotate the
                # fleet and let the next pass retry from anyone
                if b.tried and all(
                    o.peer in b.tried for o in peers
                ):
                    b.tried.clear()
                    self._retries += 1
                    metrics.inc("ibd.rotations")
                continue
            b.state = "fetching"
            b.peer = pick
            self._inflight[pick] = self._inflight.get(pick, 0) + 1
            metrics.inc("ibd.fetches")
            b.task = self._fetchers.add_child(
                self._fetch(b, pick), name=f"ibd-fetch-{b.lo}"
            )

    async def _fetch(self, b: _Batch, peer) -> None:
        """One getdata batch.  The returned blocks are DISCARDED here:
        every served block also arrives through the peer-message path
        (the wire loop publishes it), which is where ingest happens —
        this task only acks delivery for the planner's bookkeeping."""
        ok = False
        try:
            res = await get_blocks(
                self._net, self.cfg.fetch_timeout, peer, b.hashes
            )
            ok = res is not None
        except asyncio.CancelledError:
            raise  # finally still runs: the batch requeues
        except Exception as e:
            log.debug("[IBD] fetch [%d,%d] failed: %s", b.lo, b.hi, e)
        finally:
            self._fetch_done(b, peer, ok)

    def _fetch_done(self, b: _Batch, peer, ok: bool) -> None:
        n = self._inflight.get(peer, 0) - 1
        if n > 0:
            self._inflight[peer] = n
        else:
            self._inflight.pop(peer, None)
        if b.state != "fetching" or b.peer is not peer:
            return  # already retired or reassigned (peer_gone raced)
        b.task = None
        if ok:
            b.state = "delivered"
            b.delivered_at = time.monotonic()
            self._fetched_blocks += b.hi - b.lo + 1
            metrics.inc("ibd.blocks", b.hi - b.lo + 1)
        else:
            b.state = "queued"
            b.peer = None
            b.tried.add(peer)
            b.attempts += 1
            metrics.inc("ibd.batch_failures")
            events.emit(
                "ibd.batch_failed", lo=b.lo, hi=b.hi,
                attempts=b.attempts,
                peer=getattr(peer, "label", "?"),
            )
        self._wake.set()
