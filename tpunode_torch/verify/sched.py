"""Lane-packing verify scheduler.

The engine used to dispatch FIFO-coalesced submissions: whole payloads
were popped until the fill target was crossed, and a sub-``min_tpu_batch``
remainder was shunted to the CPU rung.  Under many-tenant traffic (Flow's
consensus/compute separation, arXiv:1909.05832: one verify service fed by
many light ingest sources) that wastes device occupancy twice — lanes
dispatch part-empty, and small tails pay a CPU step that the *next*
submission's items could have filled.

This module owns the queue instead:

* **Priority classes** — ``block`` > ``mempool`` > ``ibd`` > ``bulk``.
  Live block-ingest items always pack (and therefore dispatch) ahead of
  mempool relay, which packs ahead of IBD backfill, which packs
  ahead of bulk/re-index traffic.  Within a class, FIFO.
* **Cross-submission packing** — :meth:`LanePacker.pop_lane` slices
  queued payloads so every lane is exactly ``target`` items (the
  compiled device shape) regardless of how the work arrived.  One
  submission may span several lanes; several submissions may share one.
  Per-item futures still resolve exactly once with exactly their items'
  verdicts (verdict conservation — the chaos SOAK invariant).
* **Max-linger deadline** — a lone small submission is dispatched as a
  partial lane once its linger expires; ``min_tpu_batch`` degrades from
  a routing rule to a shed-only floor applied at dispatch time.

The packer is plain data + arithmetic on the event loop; the engine's
pipeline (``engine.PIPELINE_DEPTH`` lanes in flight) pulls lanes from it.

The fleet half of the reference's module (``FleetDispatcher``,
``AffinityMap``, ``host_names``) comes with the engine's fleet;
``Submission.affinity`` keeps a caller's placement hint until then, and
the node computes that hint with :func:`affinity_key`.

Telemetry: ``sched.queue_depth{priority=}`` gauges, the
``sched.pack_efficiency`` histogram (lane occupancy at dispatch) and the
``sched.lanes`` / ``sched.packed_submissions`` counters.
"""

from __future__ import annotations

import asyncio
import collections
import time
from typing import Optional, Sequence

from ..metrics import metrics

__all__ = [
    "OCCUPANCY_BUCKETS",
    "PRIORITIES",
    "Submission",
    "PackedLane",
    "LanePacker",
    "affinity_key",
]

# Dispatch order under saturation: live block ingest outranks mempool
# relay, which outranks IBD backfill (planner-fetched historical blocks:
# a syncing node keeps serving fresh verdicts first), which
# outranks bulk (API default / re-index) traffic.
PRIORITIES = ("block", "mempool", "ibd", "bulk")

# Linear occupancy buckets (0.05 steps): lane occupancy lives in [0, 1],
# which the duration-shaped default bounds would quantize uselessly.
OCCUPANCY_BUCKETS = tuple(i / 20 for i in range(1, 21))

metrics.describe(
    "node.verdict_latency",
    "submit->verdict-publish latency per priority class (seconds)",
)


def slice_payload(payload, lo: int, hi: int):
    """A view/copy of ``payload[lo:hi]`` in dispatchable form: list
    payloads slice natively, raw-batch payloads through
    :func:`raw.as_raw_batch` (numpy views, no copies)."""
    if lo == 0 and hi >= len(payload):
        return payload
    if isinstance(payload, list):
        return payload[lo:hi]
    from .raw import as_raw_batch

    return as_raw_batch(payload).slice(lo, hi)


class Submission:
    """One queued verify request: a payload plus the future its caller
    awaits.  ``results`` fills in slices as the lanes carrying this
    submission complete (in any order); the future resolves when the
    last slice lands, or fails on the FIRST lane failure (later slices
    of a failed submission are delivered into a dead buffer)."""

    __slots__ = (
        "payload", "n", "fut", "act", "priority", "enqueued",
        "taken", "results", "remaining", "failed", "affinity", "tenant",
    )

    def __init__(
        self,
        payload,
        fut: asyncio.Future,
        act: Optional[tuple],
        priority: str,
        enqueued: Optional[float] = None,
        affinity: Optional[int] = None,
        tenant: Optional[str] = None,
    ):
        if priority not in PRIORITIES:
            raise ValueError(
                f"unknown priority {priority!r}: one of {PRIORITIES}"
            )
        self.payload = payload
        self.n = len(payload)
        self.fut = fut
        self.act = act
        self.priority = priority
        self.affinity = affinity
        # serve-layer attribution: the registered tenant this
        # submission bills to, None for the node's own traffic
        self.tenant = tenant
        self.enqueued = time.monotonic() if enqueued is None else enqueued
        self.taken = 0  # items already claimed into lanes
        self.results: list = [None] * self.n
        self.remaining = self.n
        self.failed = False

    def deliver(self, lo: int, verdicts: Sequence[bool]) -> None:
        """Fill ``results[lo:lo+len(verdicts)]``; resolve the future when
        the submission is complete.  Idempotent against a prior failure."""
        self.results[lo : lo + len(verdicts)] = verdicts
        self.remaining -= len(verdicts)
        if self.remaining <= 0 and not self.failed and not self.fut.done():
            # Per-class e2e latency: admission stamp -> last
            # slice delivered.  Observed HERE — submission-side, not
            # lane-side — so packed/sliced/stolen/requeued lanes still
            # attribute the latency to the originating priority class.
            metrics.observe(
                "node.verdict_latency",
                time.monotonic() - self.enqueued,
                labels={"priority": self.priority},
            )
            self.fut.set_result(self.results)

    def fail(self, exc: BaseException) -> None:
        """A lane carrying part of this submission failed on every rung:
        the whole submission's waiter learns it (partial verdict lists
        are never surfaced — all-or-nothing per submission)."""
        self.failed = True
        if not self.fut.done():
            self.fut.set_exception(exc)


class PackedLane:
    """One dispatchable lane: ``(submission, lo, hi)`` slices summing to
    ``total`` items (≤ the pack target).  ``requeues`` counts fleet
    re-queues after a host loss — the engine bounds it so a
    lane bouncing between dying hosts eventually falls through the
    local ladder instead of orbiting forever."""

    __slots__ = ("slices", "total", "target", "requeues")

    def __init__(
        self, slices: list[tuple[Submission, int, int]], target: int
    ):
        self.slices = slices
        self.total = sum(hi - lo for _, lo, hi in slices)
        self.target = target
        self.requeues = 0

    @property
    def occupancy(self) -> float:
        return self.total / self.target if self.target else 1.0

    @property
    def act0(self) -> Optional[tuple]:
        """First traced submitter's trace position — the tree the
        dispatch-phase spans are recorded into (exact for the
        one-block-per-lane common case)."""
        for sub, _, _ in self.slices:
            if sub.act is not None:
                return sub.act
        return None

    def payloads(self) -> list:
        """Sliced payloads in lane order (what the dispatch rungs run)."""
        return [
            slice_payload(sub.payload, lo, hi) for sub, lo, hi in self.slices
        ]

    def class_counts(self) -> dict[str, int]:
        """Items per priority class carried by this lane — the cost
        ledger's attribution input: the engine pro-rates the
        lane's wall-clock rung time across these counts."""
        out: dict[str, int] = {}
        for sub, lo, hi in self.slices:
            out[sub.priority] = out.get(sub.priority, 0) + (hi - lo)
        return out

    def tenant_counts(self) -> dict[str, int]:
        """Items per serve-layer tenant carried by this lane
        — empty for pure node traffic, so the ledger's tenant table only
        exists when the serve subsystem is live."""
        out: dict[str, int] = {}
        for sub, lo, hi in self.slices:
            if sub.tenant is not None:
                out[sub.tenant] = out.get(sub.tenant, 0) + (hi - lo)
        return out


class LanePacker:
    """Priority-binned submission queue with cross-boundary lane packing.

    Not thread-safe by design: every method runs on the event loop (the
    engine's queue loop and ``_enqueue``).

    ``gauge=False`` silences the ``sched.queue_depth{priority=}``
    gauges: the fleet's per-host packers would otherwise
    last-writer-win the same gauge keys as the central packer.  The
    counters/histogram stay on — they are process totals and sum
    correctly across packers.
    """

    def __init__(self, gauge: bool = True):
        self._gauge_on = gauge
        self._q: dict[str, collections.deque[Submission]] = {
            p: collections.deque() for p in PRIORITIES
        }
        # Running unclaimed-item counts (global + per priority): push and
        # pop_lane maintain them in O(1) — recomputing by summing the
        # deque would make a burst of n enqueues O(n^2) on the event
        # loop (review finding).
        self._pending_items = 0
        self._depth: dict[str, int] = {p: 0 for p in PRIORITIES}

    # -- intake ---------------------------------------------------------------

    def push(self, sub: Submission) -> None:
        # Unclaimed remainder, not sub.n: a host deactivation re-routes
        # its packer's queue through push(), and a partially-claimed
        # submission must not inflate the depth by items already cut
        # into lanes.
        rem = sub.n - sub.taken
        self._q[sub.priority].append(sub)
        self._pending_items += rem
        self._depth[sub.priority] += rem
        if self._gauge_on:
            metrics.set_gauge(
                "sched.queue_depth",
                float(self._depth[sub.priority]),
                labels={"priority": sub.priority},
            )

    # -- introspection --------------------------------------------------------

    def pending(self) -> int:
        """Unclaimed items across every priority class."""
        return self._pending_items

    def batches(self) -> int:
        return sum(len(q) for q in self._q.values())

    def depths(self) -> dict[str, int]:
        """Unclaimed items per priority (stats/debug endpoints)."""
        return dict(self._depth)

    def oldest_enqueued(self) -> Optional[float]:
        """Enqueue time of the oldest queued submission (any class) —
        the linger deadline anchors on it so a lone low-priority
        submission still dispatches promptly."""
        heads = [q[0].enqueued for q in self._q.values() if q]
        return min(heads) if heads else None

    def head_class(self) -> Optional[int]:
        """Index into PRIORITIES of the highest class with unclaimed
        items (None when empty) — the fleet feed loop compares per-host
        packers by this before cutting, so per-host packing preserves
        GLOBAL priority order."""
        for i, p in enumerate(PRIORITIES):
            if self._depth[p] > 0:
                return i
        return None

    # -- packing --------------------------------------------------------------

    def pop_lane(self, target: int) -> Optional[PackedLane]:
        """Claim up to ``target`` items into one lane, draining priority
        classes in order and slicing across submission boundaries.
        Returns None when the queue is empty."""
        slices: list[tuple[Submission, int, int]] = []
        room = target
        for p in PRIORITIES:
            q = self._q[p]
            while q and room > 0:
                sub = q[0]
                if sub.failed:
                    # an earlier lane already failed this submission's
                    # waiter: dispatching its remainder would burn whole
                    # device lanes on verdicts nobody can observe
                    rem = sub.n - sub.taken
                    sub.taken = sub.n
                    self._pending_items -= rem
                    self._depth[p] -= rem
                    metrics.inc("sched.failed_skipped", rem)
                    q.popleft()
                    continue
                take = min(room, sub.n - sub.taken)
                slices.append((sub, sub.taken, sub.taken + take))
                sub.taken += take
                room -= take
                self._pending_items -= take
                self._depth[p] -= take
                if sub.taken >= sub.n:
                    q.popleft()
            if self._gauge_on:
                metrics.set_gauge(
                    "sched.queue_depth",
                    float(self._depth[p]),
                    labels={"priority": p},
                )
            if room <= 0:
                break
        if not slices:
            return None
        lane = PackedLane(slices, target)
        metrics.inc("sched.lanes")
        metrics.inc("sched.packed_submissions", len(slices))
        metrics.observe(
            "sched.pack_efficiency", lane.occupancy, buckets=OCCUPANCY_BUCKETS
        )
        return lane

    # -- shutdown -------------------------------------------------------------

    def drain(self) -> list[Submission]:
        """Remove and return every queued submission (engine teardown:
        their futures are cancelled by the caller).  Partially-claimed
        submissions are included — their in-flight slices resolve or
        fail through the lane that claimed them."""
        out: list[Submission] = []
        for p, q in self._q.items():
            out.extend(q)
            q.clear()
            self._depth[p] = 0
            if self._gauge_on:
                metrics.set_gauge(
                    "sched.queue_depth", 0.0, labels={"priority": p}
                )
        self._pending_items = 0
        return out


def affinity_key(txid: bytes) -> int:
    """The affinity key for a txid / block hash: its first 8 bytes as a
    little-endian integer.  Hash digests are already uniform, so no
    extra mixing is needed here."""
    return int.from_bytes(txid[:8], "little")
