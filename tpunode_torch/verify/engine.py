"""Async batch verification engine: the queue between ingest and the card.

Ingest submits verify items — ``(pubkey, z, r, s)`` ECDSA tuples or
5-tuples tagged ``"schnorr"`` / ``"bip340"`` — or packed
:class:`~tpunode_torch.verify.raw.RawBatch` rows.  The engine bins them
into fixed-shape lanes, runs each lane down a ladder of backends and
resolves each submission's future with its own verdicts.

**Rung names.** The ladder's rungs and ``VerifyConfig.backend`` keep the
reference engine's strings — ``"tpu"``, ``"cpu"``, ``"oracle"`` — as do
its metric and event names (``verify.tpu_items``, ``verify.cpu_items``,
``verify.failovers``, ``verify.dispatch`` ...): the knobs mirror the
reference's names and values, and the node, receipts and stats read these
strings.  In this port ``"tpu"`` names the device rung, which is the card
(the hand-written CUDA kernels; ``device="cpu"`` runs their plain PyTorch
version instead), ``"cpu"`` the native C++ verifier, ``"oracle"`` the
Python one.

**Streaming pipeline.** Queued submissions go to a lane packer
(:class:`~tpunode_torch.verify.sched.LanePacker`): it cuts full
``device_batch`` lanes across submission boundaries in priority order
(block > mempool > ibd > bulk) with a max-linger deadline (``max_wait``),
and up to :data:`PIPELINE_DEPTH` lanes are in flight at once, each in its own
dispatch thread, so lane N+1's host prep and upload overlap lane N's
kernel and the event loop never blocks.  Item tuples are packed into rows
in the dispatch thread (the ``verify.pack`` span), never on the loop;
``verify_sync`` packs in its caller's thread.

**Device rung.** Work is cut into chunks of ``device_batch`` lanes; a chunk
no longer than ``batch_size`` is padded to ``batch_size`` instead.  Each
chunk is host-prepped, uploaded and launched without waiting (the launch
is asynchronous on the current stream), and the verdicts are read back at
the end.  With ``backend="auto"`` a caller may set ``min_tpu_batch``: a
batch or chunk shorter than it then goes to the cpu rung (the default, 0,
sends none there).

**Fleet and mesh.** ``mesh_devices >= 2`` shards each device chunk over
a mesh of that many visible cards (:func:`multichip.dispatch_raw_sharded`:
one host prep, each shard uploaded and launched on its card and a stream
of its own).  ``mesh_hosts >= 2`` promotes the pipeline into a fleet: the
cards are carved into that many host groups (a ``(host, chip)`` hybrid
mesh, :func:`multichip.make_hybrid_mesh`), each host runs
:data:`PIPELINE_DEPTH` dispatch workers pulling packed lanes from a
work-stealing :class:`~tpunode_torch.verify.sched.FleetDispatcher` (keyed
submissions go to their rendezvous home host's packer; idle hosts steal
whole lanes from the deepest peer queue), and each host carries its own
circuit breaker and device sub-mesh so one sick host degrades alone.  A
device failure on a multi-card host shrinks its sub-mesh to the largest
still-healthy half (re-grown after the breaker's cooldown); a host
partition (:class:`HostLost`, an injected ``mesh.dispatch`` partition)
re-queues the lane onto a healthy peer exactly once, deactivates the
host, and a cooldown-paced canary rejoins it.  The mesh is an upgrade,
never a gate: with fewer cards than asked, or a grid that does not fit,
the rung dispatches on the engine's one card and says so (a
``verify.mesh`` event with ``state="failed"``, ``stats()["mesh"]`` and
``stats()["fleet"]["hybrid_state"]``).  With every host dark, lanes run
on the engine's own rung (the card for "auto"/"tpu").

**Warmup.** The device rung is used only after a warmup in a background
thread (:func:`_device_warmup`: both shapes in the engine's modes, 8
mixed-algorithm verdicts held against the oracle) says ``ready``; a batch
for the device rung waits for it (up to :data:`WARMUP_TIMEOUT`).  A big
shape that fails while the small one works degrades ``device_batch`` to
``batch_size`` (:class:`BigShapeFailed`); any other failure marks the
device ``failed``, and is re-probed after :data:`WARMUP_RETRY` seconds.

**Dispatch ladder.** A batch that fails on the cpu rung is re-run on the
oracle and reported: a ``verify.failover`` event and ``verify.failovers``
count, a ``verify.failure`` event and ``verify.dispatch_errors`` count.
The device rung has nothing below it: a batch that fails there (a kernel
that fails to build or launch) is reported the same way, minus the
failover, and fails its waiters.  Device-rung failures feed a
:class:`CircuitBreaker` (``ready -> degraded -> open -> probing ->
ready``); while it is open, "auto" batches for the device are refused.

**Where the port differs from the reference.** No CPU path stands in for
the card.  ``backend`` "auto" or "tpu" with ``device=None`` and no card
raises at construction.  The reference re-runs a failed device batch on
the cpu rung and the oracle, serves "auto" batches on the cpu rung while
the device warms up, has failed or has its breaker open, and sends
chunks below ``min_tpu_batch`` (default 1024) to the cpu rung.  Here a
batch for the card waits for the warmup, and raises when the device
failed its warmup, when the batch failed on it, or when the breaker is
open; only ``min_tpu_batch``, set by the caller, routes short work to the
cpu rung.  There is no fallback from one kernel to another.  ``backend``
"cpu" or "oracle" is the caller asking for the CPU, and runs anywhere.
In a fleet the same holds per host: the reference serves a lane on the
CPU when its host's breaker refuses the card, or when a lost host's lane
finds no healthy peer; here a host whose breaker refuses the card leaves
its lanes to an active peer (its workers take none, and a lane it already
holds is re-queued onto the peer), a lane with no active peer waits for
its host's breaker (a canary in flight, or the cooldown), and a lane no
peer can take after a host loss runs on the engine's own rung.  The
reference's ``pipeline_depth``, ``fleet_queue``, ``warmup_timeout``,
``warmup_retry`` and ``breaker_*`` fields are the module constants
below, at the reference's defaults, and its ``cpu_threads`` is not here,
until a caller needs to set them.  The mode
knobs travel as arguments: the config resolves each into its
field once, and the engine reads the select and the pow ladder
(``TPUNODE_SELECT16``, ``TPUNODE_POW_LADDER``) once, at construction, as
:attr:`VerifyEngine.select` and :attr:`VerifyEngine.ladder`; no process
global flips.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from .. import threadsan
from ..actors import spawn_supervised
from ..chaos import ChaosPartition, chaos
from ..events import events
from ..metrics import metrics
from ..trace import span
from ..tracectx import activate as _activate_trace, current as _trace_current
from .cpu_native import load_native_verifier
from .curve import check_point_form, point_form
from .ecdsa_cpu import (
    CURVE_N,
    GENERATOR,
    bip340_challenge,
    lift_x,
    point_mul,
    schnorr_challenge,
    sign,
    sign_bip340,
    sign_schnorr,
    verify_batch_cpu,
)
from .field import check_mul, check_reduce, check_sqr, mul_mode, reduce_mode, sqr_mode
from .kernel import (
    collect_verdicts,
    dispatch_batch_gpu_raw,
    kernel_modes,
    pow_ladder_mode,
    resolve_device,
    select_mode,
)
from .raw import RawBatch, as_raw_batch, concat_raw, pack_items
from .multichip import (dispatch_raw_sharded, host_submesh, make_hybrid_mesh, make_mesh,
                        visible_devices)
from .sched import OCCUPANCY_BUCKETS as _OCCUPANCY_BUCKETS
from .sched import FleetDispatcher, LanePacker, PackedLane, Submission, host_names
from .width import window_bits, windows

__all__ = [
    "BACKENDS",
    "BigShapeFailed",
    "CircuitBreaker",
    "CostLedger",
    "HostLost",
    "VerifyConfig",
    "VerifyEngine",
    "VerifyItem",
    "warmup_items",
]

# (pubkey, z, r, s) for ECDSA; 5-tuples append "schnorr" (BCH) or
# "bip340" (taproot) with the precomputed challenge in the z position.
VerifyItem = tuple  # see raw.pack_items for the per-algorithm rules

#: ``VerifyConfig.backend`` values: the starting rung ("auto": the device
#: rung, or the cpu rung below ``min_tpu_batch``).
BACKENDS = ("auto", "tpu", "cpu", "oracle")

#: Packed lanes in flight at once, each in its own dispatch thread: lane
#: N+1's host prep and upload overlap lane N's kernel.
PIPELINE_DEPTH = 2
#: The longest wait, in seconds, of a device-rung batch for the warmup.
WARMUP_TIMEOUT = 600.0
#: A failed warmup is re-probed after this many seconds; 0 never re-probes.
WARMUP_RETRY = 60.0
#: Circuit breaker on the device rung: BREAKER_THRESHOLD failures inside
#: BREAKER_WINDOW seconds open it; after BREAKER_COOLDOWN seconds one live
#: batch probes the device and, on success, closes it.
BREAKER_THRESHOLD = 3
BREAKER_WINDOW = 30.0
BREAKER_COOLDOWN = 5.0
#: Fleet mode: how many packed lanes the scheduler may pre-assign onto one
#: host's queue before it waits.  Shallow queues keep late high-priority
#: submissions packing ahead of un-cut work; work stealing makes depth
#: mostly latency, not throughput.
FLEET_QUEUE = 2

log = logging.getLogger("tpunode_torch.verify")


class HostLost(RuntimeError):
    """A fleet host is unreachable: the dispatch ladder must NOT serve the
    lane on this host's behalf — the worker re-queues it onto a healthy
    peer and deactivates the host.  Raised for an injected
    ``mesh.dispatch:partition``."""


class _HostRefused(Exception):
    """A fleet host's breaker refuses the card (open, or its one canary
    already in flight) while a peer host is active: the host's worker
    hands the lane to that peer instead of waiting."""


def warmup_items() -> tuple[list[tuple], list[bool]]:
    """8 items over all three algorithms, every third one corrupted, with
    the verdicts the oracle gives them."""
    items = []
    for i in range(8):
        priv = (0xA11CE + i) % CURVE_N
        pub = point_mul(priv, GENERATOR)
        z = (0xD00D << i) % CURVE_N
        if i % 4 == 1:
            r, s = sign_schnorr(priv, z, 0xC0FFEE + i)
            z ^= 1 if i % 3 == 2 else 0
            items.append((pub, schnorr_challenge(r, pub, z), r, s, "schnorr"))
        elif i % 4 == 3:
            r, s = sign_bip340(priv, z, 0xC0FFEE + i)
            z ^= 1 if i % 3 == 2 else 0
            items.append((lift_x(pub.x), bip340_challenge(r, pub.x, z), r, s, "bip340"))
        else:
            r, s = sign(priv, z, 0xC0FFEE + i)
            z ^= 1 if i % 3 == 2 else 0
            items.append((pub, z, r, s))
    return items, verify_batch_cpu(items)


class BigShapeFailed(RuntimeError):
    """Warmup outcome: the small device shape ran and cross-checked but
    the steady-state ``device_batch`` shape did not.  Carries the device
    kind so the engine stays on the device path with ``device_batch``
    degraded to ``batch_size``."""

    def __init__(self, kind: str, error: str):
        super().__init__(error)
        self.kind = kind


def _device_warmup(batch_size: int, device_batch: int = 0, *, engine: "VerifyEngine") -> str:
    """Default warmup body (runs in a daemon thread): run ``engine``'s
    device rung at its small shape ``batch_size`` first, so readiness
    comes early, then at its steady-state shape ``device_batch``, each on
    the 8 :func:`warmup_items` (as many as the shape holds) held against
    the oracle's verdicts.  Builds the kernel on first use.  Returns the
    device kind ("cuda:<card name>" or "cpu").  Raises on any failure, a
    verdict mismatch included; :class:`BigShapeFailed` when only the big
    shape fails to run."""
    dev = engine.device
    kind = f"cuda:{torch.cuda.get_device_name(dev)}" if dev.type == "cuda" else dev.type
    items, expect = warmup_items()
    raw = pack_items(items)

    def run(shape: int) -> tuple[list, list]:
        n = min(shape, len(expect))
        got = collect_verdicts(*engine._dispatch_chunk(raw.slice(0, n), pad_to=shape))
        return got, expect[:n]

    got, want = run(batch_size)
    if got != want:
        raise RuntimeError(f"device/oracle verdict mismatch during warmup: {got} != {want}")
    if device_batch and device_batch != batch_size:
        try:
            got, want = run(device_batch)
        except Exception as e:  # noqa: BLE001 — verdict errors are raised below
            # the small shape works but the steady-state one does not run:
            # keep the device path, chunked at the small shape
            raise BigShapeFailed(kind, f"{type(e).__name__}: {e}"[:300]) from e
        if got != want:
            raise RuntimeError(f"device/oracle verdict mismatch at device_batch: "
                               f"{got} != {want}")
    return kind


class CircuitBreaker:
    """Device-path health state machine.

    States (``STATES`` order is the ``verify.breaker_state`` gauge
    encoding):

    * ``ready``    — device path in use, no recent failures.
    * ``degraded`` — failures seen inside the window (< threshold); the
      device is still used, each failed batch already failed its waiters.
    * ``open``     — threshold reached: "auto" batches for the device are
      refused, and the device isn't attempted at all until the cooldown
      elapses.
    * ``probing``  — cooldown elapsed: exactly one live batch is routed
      to the device as a half-open canary.  Success closes the breaker
      (``ready``, recovery latency observed); failure re-opens it and
      restarts the cooldown.

    Thread-safe: transitions happen on the engine's dispatch worker
    threads (ladder outcomes).  Every transition emits one
    ``verify.breaker`` event and updates the ``verify.breaker_state``
    gauge.
    """

    STATES = ("ready", "degraded", "open", "probing")

    def __init__(self, threshold: int = 3, window: float = 30.0, cooldown: float = 5.0,
                 name: str = ""):
        self.threshold = max(1, threshold)
        self.window = window
        self.cooldown = cooldown
        # Fleet host identity: named breakers label their gauge and events
        # with host= so one sick host's transitions don't masquerade as
        # engine-wide device health.
        self.name = name
        # Reentrant: _transition emits verify.breaker with the lock held,
        # and a synchronous event observer may call back into stats() on
        # the same thread — a plain Lock would self-deadlock there.
        # Per-host breakers register under their own name so the fleet's
        # host->engine acquisition edges don't alias into self-loops.
        self._lock = threadsan.rlock(f"verify.breaker.{name}" if name else "verify.breaker")
        self._state = "ready"
        self._failures: collections.deque[float] = collections.deque()
        self._opened_at: Optional[float] = None
        self._last_error: Optional[str] = None
        self.opens = 0
        self.closes = 0

    @property
    def state(self) -> str:
        return self._state

    def allow_device(self) -> bool:
        """May this batch take the device path?  ``open -> probing`` when
        the cooldown has elapsed — the caller's batch becomes the canary
        (exactly one: while ``probing``, everyone else is refused)."""
        with self._lock:
            if self._state in ("ready", "degraded"):
                return True
            if self._state == "probing":
                return False  # a canary is already in flight
            now = time.monotonic()
            if self._opened_at is not None and now - self._opened_at >= self.cooldown:
                self._transition("probing")
                return True
            return False

    def admits(self) -> bool:
        """Would :meth:`allow_device` let a batch through now?  Read-only:
        no transition, no canary claimed."""
        with self._lock:
            if self._state in ("ready", "degraded"):
                return True
            return (self._state == "open" and self._opened_at is not None
                    and time.monotonic() - self._opened_at >= self.cooldown)

    def record_success(self) -> bool:
        """A device batch completed: close toward ``ready``.  Returns True
        when this success closed an open or probing breaker."""
        with self._lock:
            self._failures.clear()
            if self._state == "ready":
                return False
            fields = {}
            if self._opened_at is not None:
                recovery = time.monotonic() - self._opened_at
                metrics.observe("verify.breaker_recovery_seconds", recovery)
                fields["recovery_seconds"] = round(recovery, 3)
            closed = self._state in ("open", "probing")
            if closed:
                self.closes += 1
                metrics.inc("verify.breaker_closes")
            self._opened_at = None
            self._last_error = None
            self._transition("ready", **fields)
            return closed

    def record_failure(self, error: str = "") -> None:
        """A device batch failed (the ladder already reported it)."""
        with self._lock:
            now = time.monotonic()
            self._failures.append(now)
            while self._failures and now - self._failures[0] > self.window:
                self._failures.popleft()
            self._last_error = error or None
            if self._state == "probing" or len(self._failures) >= self.threshold:
                # a failed canary re-opens immediately; repeated failures
                # inside the window open from ready/degraded
                self._opened_at = now
                if self._state != "open":
                    self.opens += 1
                    metrics.inc("verify.breaker_opens")
                    self._transition("open", failures=len(self._failures), error=error)
            elif self._state == "ready":
                self._transition("degraded", failures=len(self._failures), error=error)

    def trip(self, error: str = "") -> None:
        """Force the breaker open at once: a host partition is not three
        strikes — the host is gone now; the cooldown and canary recovery
        apply unchanged."""
        with self._lock:
            now = time.monotonic()
            self._failures.append(now)
            self._last_error = error or None
            self._opened_at = now
            if self._state != "open":
                self.opens += 1
                metrics.inc("verify.breaker_opens")
                self._transition("open", error=error, forced=True)

    def _transition(self, to: str, **fields) -> None:
        # lock held by the caller
        frm, self._state = self._state, to
        metrics.set_gauge("verify.breaker_state", float(self.STATES.index(to)),
                          labels={"host": self.name} if self.name else None)
        if self.name:
            fields = {"host": self.name, **fields}
        log.warning("[Engine] breaker %s -> %s %s", frm, to, fields or "")
        events.emit("verify.breaker", **{"from": frm, "to": to, **fields})

    def stats(self) -> dict:
        with self._lock:
            out = {
                "state": self._state,
                "failures_in_window": len(self._failures),
                "threshold": self.threshold,
                "opens": self.opens,
                "closes": self.closes,
                "last_error": self._last_error,
            }
            if self._opened_at is not None:
                out["open_age_seconds"] = round(time.monotonic() - self._opened_at, 3)
            return out


@dataclass
class VerifyConfig:
    """Engine knobs; the defaults are the reference engine's."""

    backend: str = "auto"  # auto | tpu | cpu | oracle (BACKENDS)
    batch_size: int = 4096  # small device shape: tails pad to it
    device_batch: int = 32768  # steady-state device shape: work is chunked at it
    max_wait: float = 0.025  # seconds an async submission lingers for a fuller lane
    # backend="auto": a batch or chunk shorter than this goes to the cpu
    # rung rather than a device step padded to batch_size.  0 sends none
    # there (the reference's default is 1024; the port routes work to the
    # CPU only where its caller asks).
    min_tpu_batch: int = 0
    warmup: bool = True  # start the warmup thread at construction
    device: Optional[str] = None  # None = the card; "cpu" = the plain version
    window_bits: Optional[int] = None  # 4 or 5; None = TPUNODE_WINDOW_BITS, else 4
    # "projective" or "affine"; None = TPUNODE_POINT_FORM, else "projective"
    point_form: Optional[str] = None
    # "lazy" or "eager"; None = TPUNODE_FIELD_REDUCE, else "lazy"
    field_reduce: Optional[str] = None
    # "half" or "mul"; None = TPUNODE_FIELD_SQR, else "half"
    field_sqr: Optional[str] = None
    # "shift_add" or "dot_general"; None = TPUNODE_FIELD_MUL, else "shift_add"
    field_mul: Optional[str] = None
    # Mesh-aware device rung: >1 shards each device chunk over a mesh of
    # that many visible cards (multichip.dispatch_raw_sharded) when they
    # are there; 0/1 keeps single-card dispatch.
    mesh_devices: int = 0
    # Fleet dispatch: >= 2 carves the cards into this many host groups (a
    # (host, chip) hybrid mesh — multichip.make_hybrid_mesh; with
    # mesh_devices set, only that many cards are carved) and runs
    # PIPELINE_DEPTH work-stealing dispatch workers PER HOST
    # (sched.FleetDispatcher), each host with its own circuit breaker and
    # device sub-mesh so one sick host degrades alone.  0 (default) keeps
    # the single-host pipeline; 1 is rejected: a one-host fleet is the
    # single-host pipeline.
    mesh_hosts: int = 0

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r}: one of {BACKENDS}")
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.device_batch < self.batch_size:
            self.device_batch = self.batch_size
        if self.min_tpu_batch < 0:
            raise ValueError("min_tpu_batch must be >= 0")
        if self.mesh_hosts == 1 or self.mesh_hosts < 0:
            raise ValueError("mesh_hosts: 0 disables the fleet, >= 2 enables it")
        if self.window_bits is None:
            self.window_bits = window_bits()
        windows(self.window_bits)  # raises ValueError unless 4 or 5
        if self.point_form is None:
            self.point_form = point_form()
        check_point_form(self.point_form)
        if self.field_reduce is None:
            self.field_reduce = reduce_mode()
        check_reduce(self.field_reduce)
        if self.field_sqr is None:
            self.field_sqr = sqr_mode()
        check_sqr(self.field_sqr)
        if self.field_mul is None:
            self.field_mul = mul_mode()
        check_mul(self.field_mul)


class _HostState:
    """Per-host fleet state: its breaker, its device sub-mesh (with the
    current healthy width), and the lost/rejoin machinery.  Mesh fields
    are guarded by the engine's ``_mesh_lock`` (dispatch worker threads
    race on first build, shrink and re-grow); ``lost`` only ever flips
    through the engine's ``_host_down`` / ``_host_rejoin``, which the
    worker tasks serialize per host."""

    __slots__ = (
        "name", "index", "breaker", "lost", "lost_at",
        "mesh", "mesh_state", "chips", "full_chips", "shrunk_at", "event", "inflight",
    )

    def __init__(self, name: str, index: int):
        self.name = name
        self.index = index
        self.breaker = CircuitBreaker(threshold=BREAKER_THRESHOLD, window=BREAKER_WINDOW,
                                      cooldown=BREAKER_COOLDOWN, name=name)
        self.lost = False
        self.lost_at = 0.0
        self.mesh = None  # lazily-built 1-D sub-mesh over this host's row
        self.mesh_state = "cold"  # cold -> ready | failed (soft: single card)
        self.chips = 0  # current healthy sub-mesh width (0 = not built yet)
        self.full_chips = 0  # the full row width (re-grow target)
        self.shrunk_at = 0.0  # last shrink time (paces the re-grow probe)
        self.event: Optional[asyncio.Event] = None  # lane-assigned wakeup
        self.inflight = 0  # lanes this host's workers are dispatching


metrics.describe(
    "verify.cost_seconds",
    "wall-clock rung seconds charged to each priority class, pro-rated "
    "by item count",
)


class CostLedger:
    """Per-class cost attribution: every dispatched lane's wall-clock rung
    time is charged back to the priority classes of the submissions it
    carried, pro-rated by item count.  The charge is cut from the one
    measured ``dt`` around :meth:`VerifyEngine._run_ladder`, so summed
    charged seconds equal total rung busy seconds by construction.

    Thread-safe — charges arrive from every dispatch worker thread."""

    def __init__(self):
        self._lock = threadsan.lock("verify.ledger")
        # (priority, rung) -> [charged seconds, items]
        self._cells: dict[tuple[str, str], list] = {}
        self._busy = 0.0  # total measured rung busy seconds
        # host -> charged seconds: per-host attribution, charged to the
        # EXECUTING host, so a stolen lane bills the thief and per-host
        # shares stay truthful under heavy stealing
        self._by_host: dict[str, float] = {}
        # tenant -> [charged seconds, items].  Unattributed items bill to
        # the node itself under the "" key, so conservation holds over the
        # tenant axis too.
        self._by_tenant: dict[str, list] = {}

    def charge(self, class_counts: dict[str, int], total: int, dt: float, rung: str,
               host: Optional[str] = None, tenants: Optional[dict] = None) -> None:
        if total <= 0 or dt < 0:
            return
        shares = [(p, n, dt * n / total) for p, n in class_counts.items() if n > 0]
        tenant_shares = []
        if tenants:
            tenant_items = 0
            for t, n in tenants.items():
                if n > 0:
                    tenant_shares.append((t, n, dt * n / total))
                    tenant_items += n
            rest = total - tenant_items
            if rest > 0:
                tenant_shares.append(("", rest, dt * rest / total))
        with self._lock:
            self._busy += dt
            if host is not None:
                self._by_host[host] = self._by_host.get(host, 0.0) + dt
            for p, n, share in shares:
                cell = self._cells.get((p, rung))
                if cell is None:
                    cell = self._cells[(p, rung)] = [0.0, 0]
                cell[0] += share
                cell[1] += n
            for t, n, share in tenant_shares:
                cell = self._by_tenant.get(t)
                if cell is None:
                    cell = self._by_tenant[t] = [0.0, 0]
                cell[0] += share
                cell[1] += n
        host_labels = {} if host is None else {"host": host}
        metrics.inc_batch(
            ("verify.cost_seconds", share, {"priority": p, "rung": rung, **host_labels})
            for p, _, share in shares
        )

    def snapshot(self) -> dict:
        """The ``engine.stats()["ledger"]`` section: per-(class, rung)
        charged seconds and items, each class's share of the total, and
        the busy-seconds pin."""
        with self._lock:
            cells = {k: list(v) for k, v in self._cells.items()}
            busy = self._busy
            by_host = dict(self._by_host)
            by_tenant = {k: list(v) for k, v in self._by_tenant.items()}
        charged = sum(v[0] for v in cells.values())
        by_class: dict[str, dict] = {}
        for (p, rung), (secs, items) in sorted(cells.items()):
            c = by_class.setdefault(p, {"seconds": 0.0, "items": 0, "rungs": {}})
            c["seconds"] += secs
            c["items"] += items
            c["rungs"][rung] = {"seconds": round(secs, 6), "items": items}
        for c in by_class.values():
            c["seconds"] = round(c["seconds"], 6)
            c["share"] = round(c["seconds"] / charged, 4) if charged else 0.0
        out = {
            "busy_seconds": round(busy, 6),
            "charged_seconds": round(charged, 6),
            "by_class": by_class,
        }
        if by_host:
            # fleet mode only: busy seconds by EXECUTING host
            out["by_host"] = {h: round(secs, 6) for h, secs in sorted(by_host.items())}
        if by_tenant:
            out["by_tenant"] = {
                t: {"seconds": round(v[0], 6), "items": v[1]}
                for t, v in sorted(by_tenant.items())
            }
        return out


class VerifyEngine:
    """Submit items, get verdicts.

    Usage::

        engine = VerifyEngine(VerifyConfig())
        engine.wait_warmup(600)               # "ready" once the card is warm
        ok = engine.verify_sync(items)        # list[bool]
        async with engine:
            ok = await engine.verify(items, priority="block")
    """

    # Test seam: replace to simulate a slow or broken device warmup.
    _warmup_fn: Callable[..., str] = staticmethod(_device_warmup)

    def __init__(self, cfg: Optional[VerifyConfig] = None):
        self.cfg = cfg or VerifyConfig()
        self.select = select_mode()  # the knobs', read once
        self.ladder = pow_ladder_mode()
        self.modes()  # a knob value that names no mode raises here
        # the device rung's device: the card unless the config names the
        # CPU; with no card a device backend raises here
        self.device = (resolve_device(self.cfg.device)
                       if self.cfg.backend in ("auto", "tpu") else None)
        # Lane-packing scheduler: submissions (with their futures and
        # trace positions) queue here; the pipeline loop pops packed
        # lanes from it.
        self._packer = LanePacker()
        # Per-inflight dispatch start times keyed by a monotonic token:
        # the oldest in-flight dispatch is the stall signal.  Written by
        # the lane tasks, read by any thread: guarded by _inflight_lock.
        self._inflight: dict[int, float] = {}
        self._inflight_lock = threadsan.lock("verify.inflight")
        self._inflight_seq = 0
        # Cost ledger, and the per-dispatch-thread slot carrying the
        # lane's class and tenant counts into _dispatch_multi.
        self._ledger = CostLedger()
        self._tls = threading.local()
        self._last_rung = "none"  # rung of the latest served batch
        self._lane_tasks: set[asyncio.Task] = set()
        self._slots: Optional[asyncio.Semaphore] = None
        self._kick: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._closing = False  # task-registry owner convention (actors.py)
        # sharded device rung (cfg.mesh_devices): lazily-built mesh;
        # "failed" means mesh construction was tried and is off for good.
        # Init races between concurrent dispatch threads are serialized by
        # _mesh_lock — without it two lanes would double-build, and a
        # transient loser could pin "failed" over a winner's mesh.
        self._mesh_obj = None
        self._mesh_state = "cold"
        self._mesh_lock = threadsan.lock("verify.mesh")
        # Fleet (cfg.mesh_hosts >= 2): per-host states + the work-stealing
        # dispatcher; the hybrid mesh's device rows are carved lazily on
        # the first device dispatch (guarded by _mesh_lock).
        self._fleet: Optional[FleetDispatcher] = None
        self._hosts: dict[str, _HostState] = {}
        self._fleet_hybrid = None  # the (host, chip) Mesh, carved lazily
        self._fleet_hybrid_state = "cold"
        self._room: Optional[asyncio.Event] = None
        if self.cfg.mesh_hosts >= 2:
            # canonical names from sched.py: the affinity map's rendezvous
            # seeds hash these strings, so the naming must be stable
            self._hosts = {name: _HostState(name, i)
                           for i, name in enumerate(host_names(self.cfg.mesh_hosts))}
            self._fleet = FleetDispatcher(list(self._hosts), self._packer,
                                          max_queue=FLEET_QUEUE)
            metrics.set_gauge("mesh.active_hosts", float(len(self._hosts)))
        self._cpu = (load_native_verifier()
                     if self.cfg.backend == "cpu"
                     or (self.cfg.backend == "auto" and self.cfg.min_tpu_batch > 0) else None)
        # Steady-state device shape in use: the config's, degraded to
        # batch_size if the big shape fails in warmup (never written back
        # into the caller's cfg).
        self._device_batch = self.cfg.device_batch
        # device readiness: cold -> warming -> ready | failed (failed
        # re-probes on the WARMUP_RETRY timer)
        self._device_state = "cold"
        self._device_kind = ""
        self._device_error: Optional[str] = None
        self._warmup_started = 0.0
        self._warmup_failed_at = 0.0
        self._warmup_lock = threadsan.lock("verify.warmup")
        self._warmup_done = threading.Event()
        self._breaker = CircuitBreaker(
            threshold=BREAKER_THRESHOLD, window=BREAKER_WINDOW, cooldown=BREAKER_COOLDOWN)
        if self.cfg.warmup and self.cfg.backend in ("auto", "tpu"):
            self.start_warmup()

    def modes(self) -> tuple:
        """The engine's mode tuple (``kernel.kernel_modes``): its width,
        point form, reduction, select, ladder, square and multiply."""
        return kernel_modes(self.cfg.window_bits, self.cfg.point_form, self.cfg.field_reduce,
                            self.select, self.ladder, self.cfg.field_sqr, self.cfg.field_mul)

    # -- device warmup -------------------------------------------------------

    def start_warmup(self) -> None:
        """Start the device warmup in a daemon thread (idempotent).  While
        it runs, device-rung batches wait for it; when it succeeds, the
        device rung switches on."""
        if self._device_state != "cold":
            return
        self._device_state = "warming"
        self._warmup_started = time.monotonic()

        def run() -> None:
            try:
                if chaos.on:  # injected warmup failure
                    chaos.maybe_raise("engine.warmup")
                kind = type(self)._warmup_fn(self.cfg.batch_size, self.cfg.device_batch,
                                             engine=self)
            except BigShapeFailed as e:
                # the small shape is good: stay on the device path,
                # chunked at the small shape
                self._device_batch = self.cfg.batch_size
                self._device_kind = e.kind
                self._device_state = "ready"
                log.warning("[Engine] device ready (%s) but the device_batch shape failed "
                            "(%s) — chunking at batch_size=%d", e.kind, e, self.cfg.batch_size)
                events.emit("verify.device", state="ready", kind=e.kind,
                            degraded_batch=self.cfg.batch_size, error=str(e))
            except Exception as e:  # noqa: BLE001 — any failure disables the device rung
                self._device_error = f"{type(e).__name__}: {e}"
                self._warmup_failed_at = time.monotonic()
                self._device_state = "failed"
                log.warning("[Engine] device warmup failed (re-probe in %.0fs): %s",
                            WARMUP_RETRY, self._device_error)
                events.emit("verify.device", state="failed", error=self._device_error)
            else:
                self._device_kind = kind
                self._device_state = "ready"
                dt = time.monotonic() - self._warmup_started
                log.info("[Engine] device ready (%s) after %.1fs", kind, dt)
                events.emit("verify.device", state="ready", kind=kind,
                            warmup_seconds=round(dt, 3))
            finally:
                self._warmup_done.set()

        threading.Thread(target=run, name="verify-warmup", daemon=True).start()

    def _retry_warmup(self) -> None:
        """Re-probe a failed device warmup once :data:`WARMUP_RETRY` seconds
        have passed; idempotent and thread-safe — exactly one caller flips
        failed -> cold and restarts the warmup thread."""
        with self._warmup_lock:
            if self._device_state != "failed":
                return
            if time.monotonic() - self._warmup_failed_at < WARMUP_RETRY:
                return
            log.info("[Engine] re-probing device warmup after failure: %s", self._device_error)
            events.emit("verify.device", state="reprobe", error=self._device_error)
            # fresh latch: device-rung waiters block on this attempt
            self._warmup_done = threading.Event()
            self._device_state = "cold"
            self.start_warmup()

    def wait_warmup(self, timeout: Optional[float] = None) -> str:
        """Block until the warmup under way ends or ``timeout`` seconds
        pass; returns :attr:`device_state` (at once when none is under
        way)."""
        if self._device_state == "warming":
            self._warmup_done.wait(timeout)
        return self._device_state

    @property
    def device_state(self) -> str:
        return self._device_state

    @property
    def breaker(self) -> CircuitBreaker:
        return self._breaker

    @property
    def breaker_state(self) -> str:
        """Device-path breaker state: the warmup's view until the device
        is warm, the breaker's after."""
        if self._device_state != "ready":
            return self._device_state
        return self._breaker.state

    def queue_depth(self) -> dict:
        """Current backlog: queued submissions, total unclaimed items, and
        the per-priority split.  Fleet mode aggregates the central and
        per-host packers."""
        if self._fleet is not None:
            return {
                "batches": self._fleet.batches(),
                "items": self._fleet.uncut_pending(),
                "by_priority": self._fleet.depths(),
            }
        return {
            "batches": self._packer.batches(),
            "items": self._packer.pending(),
            "by_priority": self._packer.depths(),
        }

    def dispatch_inflight_seconds(self) -> float:
        """Age of the oldest in-flight dispatch across the pipeline (0.0
        when idle): a wedged device pins the oldest entry while younger
        lanes and the event loop stay healthy."""
        with self._inflight_lock:
            if not self._inflight:
                return 0.0
            return time.monotonic() - min(self._inflight.values())

    def dispatch_inflight(self) -> int:
        """How many packed lanes are in dispatch threads now."""
        with self._inflight_lock:
            return len(self._inflight)

    def ledger(self) -> dict:
        """Cost-attribution snapshot (also under ``stats()["ledger"]``)."""
        return self._ledger.snapshot()

    @property
    def last_rung(self) -> str:
        """The ladder rung that served the most recent batch ("none"
        before any dispatch)."""
        return self._last_rung

    def stats(self) -> dict:
        """Telemetry snapshot."""
        out = {
            "backend": self.cfg.backend,
            "device_state": self._device_state,
            "device_kind": self._device_kind or None,
            "device_error": self._device_error,
            "device_batch": self._device_batch,
            "backlog": self.queue_depth(),
            "dispatch_inflight_seconds": round(self.dispatch_inflight_seconds(), 3),
            "dispatch_inflight": self.dispatch_inflight(),
            "pipeline_depth": PIPELINE_DEPTH,
            "lanes": metrics.get("sched.lanes"),
            "batches": metrics.get("verify.batches"),
            "items": metrics.get("verify.items"),
            "errors": metrics.get("verify.dispatch_errors"),
            "failovers": metrics.get("verify.failovers"),
            "breaker": self._breaker.stats(),
        }
        if self.cfg.mesh_devices >= 2:
            out["mesh"] = {"devices": self.cfg.mesh_devices, "state": self._mesh_state,
                           "shape": (list(self._mesh_obj.devices.shape)
                                     if self._mesh_obj is not None else None)}
        if self._fleet is not None:
            out["fleet"] = {
                "hosts": len(self._hosts),
                "active": self._fleet.active_hosts(),
                "depths": self._fleet.host_depths(),
                "steals": self._fleet.steals,
                "host_steals": dict(self._fleet.host_steals),
                "requeued": self._fleet.requeued,
                "queued_lanes": self._fleet.queued_lanes(),
                "breakers": {name: hs.breaker.state for name, hs in self._hosts.items()},
                "chips": {name: hs.chips for name, hs in self._hosts.items()},
                # the mesh as an upgrade: "failed" = the hosts dispatch on
                # the engine's one card
                "hybrid_state": self._fleet_hybrid_state,
                "mesh_states": {name: hs.mesh_state for name, hs in self._hosts.items()},
                # host-affine feed surface
                "feed_depths": self._fleet.feed_depths(),
                "feed_idle": {h: round(v, 4) for h, v in self._fleet.feed_idle().items()},
                "affinity": {
                    "routed": self._fleet.affinity_routed,
                    "spilled": self._fleet.affinity_spilled,
                },
            }
        occ = metrics.histogram("verify.occupancy")
        if occ is not None:
            out["occupancy"] = occ.summary()
        pack = metrics.histogram("sched.pack_efficiency")
        if pack is not None:
            out["pack_efficiency"] = pack.summary()
        disp = metrics.histogram("span.verify.dispatch")
        if disp is not None:
            out["dispatch_seconds"] = disp.summary()
        out["ledger"] = self._ledger.snapshot()
        return out

    # -- lifecycle -----------------------------------------------------------

    async def __aenter__(self) -> "VerifyEngine":
        self._kick = asyncio.Event()
        self._slots = asyncio.Semaphore(PIPELINE_DEPTH)
        self._closing = False
        if self._fleet is not None:
            self._room = asyncio.Event()
            for hs in self._hosts.values():
                hs.event = asyncio.Event()
                for _ in range(PIPELINE_DEPTH):
                    t = spawn_supervised(self._host_worker(hs), name=f"verify-host-{hs.name}",
                                         owner=self)
                    self._lane_tasks.add(t)
                    t.add_done_callback(self._lane_tasks.discard)
        self._task = spawn_supervised(self._run(), name="verify-engine", owner=self)
        return self

    async def __aexit__(self, *exc) -> None:
        self._closing = True
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
            self._task = None
        # in-flight lanes and fleet workers: cancel and await (their
        # dispatch threads finish behind the cancelled await; their
        # futures are cancelled)
        for t in list(self._lane_tasks):
            t.cancel()
        for t in list(self._lane_tasks):
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await t
        self._lane_tasks.clear()
        if self._fleet is not None:
            # lanes still assigned to host queues (cut from a packer but
            # never taken, re-queued ones included): cancel their carried
            # futures like queued submissions; Submission.deliver tolerates
            # a done future, so a late delivery cannot double-resolve
            for lane in self._fleet.drain_lanes():
                for sub, _, _ in lane.slices:
                    if not sub.fut.done():
                        sub.fut.cancel()
            # stragglers across the central and per-host packers
            for sub in self._fleet.drain_submissions():
                if not sub.fut.done():
                    sub.fut.cancel()
            # engine teardown is the one point a fleet's hosts retire for
            # good: drop their host= series from the registry (and, via its
            # drop hooks, from any Timeline sampler) so fleet churn across
            # engine lifetimes cannot grow label cardinality
            for name in self._hosts:
                metrics.drop_label("host", name)
        else:
            # fail any stragglers still queued (or partly claimed)
            for sub in self._packer.drain():
                if not sub.fut.done():
                    sub.fut.cancel()
        self._kick = None

    # -- API -----------------------------------------------------------------

    async def verify(self, items: Sequence[VerifyItem], priority: str = "bulk",
                     affinity: Optional[int] = None,
                     tenant: Optional[str] = None) -> list[bool]:
        """Queue items; resolves when their lanes have been verified.
        ``priority``: ``block`` > ``mempool`` > ``ibd`` > ``bulk`` — the
        class whose lanes pack and dispatch first under saturation.
        ``affinity`` (fleet mode): a ``sched.affinity_key`` routing this
        submission to its home host's packer — a placement hint only, never
        a correctness input.  ``tenant`` is the
        registered tenant this submission's rung time bills to in the cost
        ledger.  The items are packed into rows in the dispatch thread,
        not here on the loop."""
        return await self._enqueue(list(items), priority, affinity, tenant)

    async def verify_raw(self, raw, priority: str = "bulk", affinity: Optional[int] = None,
                         tenant: Optional[str] = None) -> list[bool]:
        """Queue a packed batch (a RawBatch, or anything ``as_raw_batch``
        takes)."""
        return await self._enqueue(as_raw_batch(raw), priority, affinity, tenant)

    async def _enqueue(self, payload, priority: str = "bulk", affinity: Optional[int] = None,
                       tenant: Optional[str] = None) -> list[bool]:
        if not len(payload):
            return []
        if self._kick is None:
            raise RuntimeError("engine not started: use `async with engine`")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        act = _trace_current()
        if act is not None:
            # queue-wait + dispatch as one span in the submitter's trace,
            # closed when the future resolves however it resolves
            tr = act[0]
            rec = tr.begin("verify.queue", act[1], items=len(payload))
            fut.add_done_callback(lambda _f, tr=tr, rec=rec: tr.end(rec))
        sub = Submission(payload, fut, act, priority, affinity=affinity, tenant=tenant)
        if self._fleet is not None:
            # host-affine route: keyed submissions land in their home
            # host's packer; keyless work stays central
            self._fleet.push(sub)
        else:
            self._packer.push(sub)
        self._kick.set()
        return await fut

    # -- host-affine feed surface ---------------------------------------------

    def route_host(self, key: int) -> Optional[str]:
        """The ACTIVE host an affinity key routes to right now (None
        without a fleet, or with every host dark) — upstream ingest
        sharding partitions parse/prep work by this."""
        if self._fleet is None:
            return None
        return self._fleet.affinity.route(key, self._fleet.active_hosts())

    def _feed_limit(self) -> int:
        """Per-host feed-depth ceiling for intake gating: the host's queue
        allowance plus one lane of headroom, in items."""
        return (FLEET_QUEUE + 1) * self._lane_target()

    def host_pressured(self, key: int) -> bool:
        """Is the TARGET host of ``key`` over its feed ceiling?  The
        per-host backpressure signal: intake for one slow host's keys
        defers without stalling the rest of the fleet.  False without a
        fleet or with every host dark — callers fall back to their global
        gates."""
        if self._fleet is None:
            return False
        host = self._fleet.affinity.route(key, self._fleet.active_hosts())
        if host is None:
            return False
        return self._fleet.feed_depth(host) >= self._feed_limit()

    def hosts_all_pressured(self) -> bool:
        """Every ACTIVE host over its feed ceiling (the fleet-wide intake
        gate: one slow host alone must never trip it)."""
        if self._fleet is None:
            return False
        active = self._fleet.active_hosts()
        if not active:
            return False
        limit = self._feed_limit()
        return all(self._fleet.feed_depth(h) >= limit for h in active)

    def verify_sync(self, items: Sequence[VerifyItem]) -> list[bool]:
        """Blocking verification (benchmarks, scripts): no queueing; the
        items are packed in the caller's thread."""
        return self._dispatch(list(items))

    def verify_raw_sync(self, raw) -> list[bool]:
        """Blocking verification of a packed batch."""
        return self._dispatch(as_raw_batch(raw))

    # -- internals -----------------------------------------------------------

    def _lane_target(self) -> int:
        """Pack/fill goal: the steady-state device shape once the device
        is up, the small shape before."""
        return self._device_batch if self._device_state == "ready" else self.cfg.batch_size

    def _uncut_pending(self) -> int:
        """Unclaimed queued items across every packer (fleet mode sums the
        central and per-host packers)."""
        if self._fleet is not None:
            return self._fleet.uncut_pending()
        return self._packer.pending()

    def _uncut_oldest(self) -> Optional[float]:
        if self._fleet is not None:
            return self._fleet.oldest_enqueued()
        return self._packer.oldest_enqueued()

    async def _run(self) -> None:
        """Pipeline scheduler loop: linger toward full lanes, then keep up
        to :data:`PIPELINE_DEPTH` packed lanes in flight, each in its own
        dispatch thread.  In fleet mode the same linger feeds the
        work-stealing dispatcher instead: each cut lane is assigned to a
        host queue, and the per-host workers (not this loop) own
        dispatch."""
        assert self._kick is not None and self._slots is not None
        while True:
            while not self._uncut_pending():
                await self._kick.wait()
                self._kick.clear()
            target = self._lane_target()
            # Event-driven fill: sleep until a new enqueue kicks or the
            # linger deadline passes.  The deadline anchors on the oldest
            # queued submission, so a lone small batch still dispatches
            # promptly.
            while self._uncut_pending() < target:
                oldest = self._uncut_oldest()
                if oldest is None:
                    break
                remain = oldest + self.cfg.max_wait - time.monotonic()
                if remain <= 0:
                    break
                try:
                    await asyncio.wait_for(self._kick.wait(), timeout=remain)
                except asyncio.TimeoutError:
                    break
                self._kick.clear()
            if not self._uncut_pending():
                continue
            if self._fleet is not None:
                await self._feed_fleet()
                continue
            # admission: a free pipeline slot (more work keeps queueing —
            # and packing fuller lanes — while every slot is busy)
            await self._slots.acquire()
            lane = self._packer.pop_lane(self._lane_target())
            if lane is None:
                self._slots.release()
                continue
            self._spawn_lane_task(lane)

    def _spawn_lane_task(self, lane: PackedLane) -> None:
        """Spawn one locally-dispatched lane task (the caller holds a
        pipeline slot; _dispatch_lane releases it)."""
        task = spawn_supervised(self._dispatch_lane(lane), name="verify-lane", owner=self)
        self._lane_tasks.add(task)
        task.add_done_callback(self._lane_tasks.discard)

    async def _feed_fleet(self) -> None:
        """Cut ONE lane and hand it to the fleet.  ``cut_next`` picks the
        globally most-urgent feedable source — an active host's HOME
        packer (the lane lands on that host's own queue) or the central
        packer (the lane lands on the shallowest queue) — so per-host
        packing keeps the global priority order.  Admission is a feedable
        source (shallow queues keep late high-priority submissions packing
        ahead of un-cut work); with every host lost, lanes are served on
        the engine's own rung under the ordinary pipeline slots — a dark
        fleet still produces verdicts."""
        assert self._fleet is not None and self._room is not None
        assert self._slots is not None
        while not self._fleet.feedable() and self._fleet.active_hosts():
            self._room.clear()
            await self._room.wait()
        if not self._fleet.active_hosts():
            # no active host at all: the engine's own rung, traffic never stops
            lane = self._fleet.pop_any(self._lane_target())
            if lane is None:
                return
            await self._slots.acquire()
            self._spawn_lane_task(lane)
            return
        lane, host = self._fleet.cut_next(self._lane_target())
        if lane is None:
            return
        if host is None:
            # cut from the central packer but no queue had room (raced
            # with other cuts): serve it here rather than re-queueing — the
            # lane exists now and must resolve exactly once
            await self._slots.acquire()
            self._spawn_lane_task(lane)
            return
        self._wake_fleet()

    def _wake_fleet(self) -> None:
        """Wake every host worker (a new or re-queued lane may be stolen by
        ANY idle host, not just the one it was assigned to)."""
        for hs in self._hosts.values():
            if hs.event is not None:
                hs.event.set()

    async def _host_worker(self, hs: _HostState) -> None:
        """One host's dispatch worker (:data:`PIPELINE_DEPTH` of these run
        per host): pull lanes — own queue first, then steal from the
        deepest peer — and dispatch them over this host's sub-mesh with
        this host's breaker.  A lost host's workers pace the canary
        rejoin instead of pulling work."""
        assert self._fleet is not None and self._room is not None
        while True:
            if hs.lost:
                # cooldown-paced rejoin, anchored on the LOSS time (several
                # workers share one host): after BREAKER_COOLDOWN the host
                # re-enters the active set with its breaker open — the next
                # lane a worker takes is the half-open canary, and a
                # still-dead host is deactivated again.
                remain = hs.lost_at + BREAKER_COOLDOWN - time.monotonic()
                await asyncio.sleep(max(0.01, remain))
                if hs.lost:
                    self._host_rejoin(hs)
                continue
            if self._sits_out(hs):
                await asyncio.sleep(0.01)
                continue
            lane = self._fleet.take(hs.name)
            if lane is None:
                self._room.set()
                assert hs.event is not None
                await hs.event.wait()
                hs.event.clear()
                continue
            self._room.set()
            hs.inflight += 1
            try:
                await self._dispatch_lane(lane, host=hs, slot=False)
            finally:
                hs.inflight -= 1

    def _sits_out(self, hs: _HostState) -> bool:
        """Does ``hs`` leave the queued lanes to its peers?  Yes while its
        breaker refuses the card to "auto" batches (open, or a canary in
        flight) or would admit only the one canary, which a lane this host
        already holds may claim, and another host is active to serve them.
        With no active peer the host takes its lanes, which wait in
        :meth:`_pick` for its breaker."""
        breaker = hs.breaker
        if self.cfg.backend != "auto" or breaker.state in ("ready", "degraded"):
            return False
        if breaker.admits() and hs.inflight == 0:
            return False
        return self._has_peer(hs)

    def _has_peer(self, hs: _HostState) -> bool:
        assert self._fleet is not None
        return any(h != hs.name for h in self._fleet.active_hosts())

    async def _dispatch_lane(self, lane: PackedLane, host: Optional[_HostState] = None,
                             slot: bool = True) -> None:
        """Run one packed lane end to end: dispatch in a worker thread (the
        ladder and breaker of :meth:`_run_ladder` apply per lane), then
        deliver each slice's verdicts to its submission.  A lane that
        fails fails exactly the submissions it carries slices of.

        Fleet mode (``host`` set): the lane runs with that host's breaker
        and sub-mesh; a :class:`HostLost` deactivates the host and
        RE-QUEUES the lane onto a healthy peer — exactly once, since
        nothing was delivered and the lane now lives in exactly one peer
        queue.  A lane that has already bounced through every host (or
        finds no healthy peer) runs on the engine's own rung, so its
        waiters still resolve.  A lane whose host's breaker refuses the
        card goes to an active peer the same way, without the host going
        down."""
        assert self._kick is not None and self._slots is not None
        payloads = lane.payloads()
        total = lane.total
        metrics.inc("verify.batches")
        metrics.inc("verify.items", total)
        metrics.set_gauge("verify.batch_occupancy", lane.occupancy)
        with self._inflight_lock:
            self._inflight_seq += 1
            token = self._inflight_seq
            self._inflight[token] = time.monotonic()
        try:
            classes = lane.class_counts()
            tenants = lane.tenant_counts()
            try:
                while True:
                    try:
                        results = await asyncio.to_thread(
                            self._dispatch_traced, payloads, lane.target, lane.act0, host,
                            classes, tenants,
                        )
                        break
                    except _HostRefused:
                        # the host's breaker refuses the card and a peer is
                        # active: the peer takes the lane (nothing was
                        # delivered).  A peer lost meanwhile leaves the lane
                        # here, to wait for this host's breaker.
                        assert host is not None and self._fleet is not None
                        if self._fleet.requeue(host.name, lane) is not None:
                            self._wake_fleet()
                            return
            except HostLost as e:
                assert host is not None and self._fleet is not None
                self._host_down(host, str(e))
                if (lane.requeues < len(self._hosts)
                        and self._fleet.requeue(host.name, lane) is not None):
                    self._wake_fleet()
                    return
                # no healthy peer (or the lane is orbiting dying hosts):
                # the engine's own rung serves it, no host's
                results = await asyncio.to_thread(
                    self._dispatch_traced, payloads, lane.target, lane.act0, None,
                    classes, tenants,
                )
        except asyncio.CancelledError:
            # engine teardown mid-dispatch: waiters must not hang on a
            # future nobody will resolve
            for sub, _, _ in lane.slices:
                if not sub.fut.done():
                    sub.fut.cancel()
            raise
        except Exception as e:  # noqa: BLE001 — the lane failed: the waiters learn it
            log.error("[Engine] lane of %d failed: %s", total, e)
            for sub, _, _ in lane.slices:
                sub.fail(e)
            return
        finally:
            with self._inflight_lock:
                self._inflight.pop(token, None)
            if slot:
                self._slots.release()
            if self._room is not None:
                self._room.set()
            if self._kick is not None:
                self._kick.set()  # a freed slot may unblock the scheduler
        pos = 0
        for sub, lo, hi in lane.slices:
            sub.deliver(lo, results[pos : pos + (hi - lo)])
            pos += hi - lo

    def _dispatch(self, payload) -> list[bool]:
        """Pick a backend and run one payload (the synchronous paths)."""
        return self._dispatch_multi([payload])

    def _dispatch_traced(self, payloads: list, target: Optional[int], act: Optional[tuple],
                         host: Optional[_HostState] = None,
                         classes: Optional[dict] = None,
                         tenants: Optional[dict] = None) -> list[bool]:
        """Worker-thread entry: re-activate the submitter's trace
        (contextvars do not cross ``to_thread`` from the queue loop) so
        the dispatch, pack, prepare, transfer, kernel and readback spans
        land in its tree.  ``classes`` and ``tenants`` ride a thread-local
        into _dispatch_multi's ledger charge."""
        self._tls.classes = classes
        self._tls.tenants = tenants
        try:
            with _activate_trace(act):
                if host is None:
                    # keep the 2-argument call shape: tests spy on
                    # _dispatch_multi with (payloads, target)
                    return self._dispatch_multi(payloads, target)
                return self._dispatch_multi(payloads, target, host=host)
        finally:
            self._tls.classes = None
            self._tls.tenants = None

    def _pick(self, n: int, host: Optional[_HostState] = None) -> str:
        """Resolve the starting rung for one batch of ``n`` items.  "cpu"
        and "oracle" are the caller's choice; "auto" sends a batch shorter
        than ``min_tpu_batch`` to the cpu rung.  Every other batch goes to
        the device rung, after a bounded wait for a warmup under way; a
        device that is not ready raises.  For "auto" the breaker decides
        next — the HOST's own in fleet mode, so one sick host degrades
        alone: a refusing engine breaker (open, or one canary already
        probing) raises; a fleet host's refusing breaker hands the batch
        to an active peer (:class:`_HostRefused`), and with no active peer
        the batch waits for the breaker (up to :data:`WARMUP_TIMEOUT`, then
        raises): nothing on the CPU stands in for the card."""
        backend = self.cfg.backend
        if backend in ("cpu", "oracle"):
            return backend
        if backend == "auto" and n < self.cfg.min_tpu_batch:
            return "cpu" if self._cpu is not None else "oracle"
        if self._device_state == "failed" and WARMUP_RETRY > 0:
            self._retry_warmup()  # no-op until the retry interval elapses
        if self._device_state == "cold":  # cfg.warmup=False: warm lazily
            self.start_warmup()
        if self._device_state == "warming":
            remain = WARMUP_TIMEOUT - (time.monotonic() - self._warmup_started)
            self._warmup_done.wait(timeout=max(0.0, remain))
        if self._device_state != "ready":
            raise RuntimeError(
                "tpu backend unavailable: " + (self._device_error or "warmup timed out"))
        if backend != "auto":
            return "tpu"
        breaker = host.breaker if host is not None else self._breaker
        deadline = time.monotonic() + (WARMUP_TIMEOUT if host is not None else 0.0)
        while not breaker.allow_device():
            if host is not None and self._has_peer(host):
                raise _HostRefused(host.name)
            if time.monotonic() >= deadline:
                raise RuntimeError("tpu backend unavailable: circuit breaker "
                                   f"{breaker.state}: {breaker.stats()['last_error']}")
            time.sleep(0.01)
        return "tpu"

    # Linear occupancy buckets (0.05 steps) shared with the packer's
    # sched.pack_efficiency histogram so the two stay comparable.
    OCCUPANCY_BUCKETS = _OCCUPANCY_BUCKETS

    def _dispatch_multi(self, payloads: list, target: Optional[int] = None,
                        host: Optional[_HostState] = None) -> list[bool]:
        """Verify a coalesced batch of payloads (tuple lists and/or raw
        batches) on one backend; results are in payload order.  ``target``
        is the fill goal the queue lingered for (None on the synchronous
        paths): it sizes the occupancy observation.  ``host`` routes the
        batch through that fleet host's breaker and sub-mesh."""
        with span("verify.dispatch"):
            total = sum(len(p) for p in payloads)
            occupancy = total / target if target else None
            if occupancy is not None:
                metrics.observe("verify.occupancy", min(1.0, occupancy),
                                buckets=self.OCCUPANCY_BUCKETS)
            try:
                picked = self._pick(total, host)
            except _HostRefused:
                raise  # not a failure: the lane goes to a peer
            except Exception as e:  # the device rung is unavailable: reported, then raised
                metrics.inc("verify.dispatch_errors")
                events.emit("verify.failure", where="pick", backend=self.cfg.backend,
                            size=total, error=f"{type(e).__name__}: {e}"[:300],
                            **({"host": host.name} if host is not None else {}))
                raise
            t0 = time.perf_counter()
            out, served = self._run_ladder(picked, payloads, total, host)
            dt = time.perf_counter() - t0
            metrics.inc("verify.seconds", dt)
            # The one measured rung time is cut across the lane's classes;
            # the synchronous paths have no class counts and charge "bulk".
            classes = getattr(self._tls, "classes", None)
            self._ledger.charge(classes if classes else {"bulk": total}, total, dt, served,
                                host=host.name if host is not None else None,
                                tenants=getattr(self._tls, "tenants", None))
            # the rung that served the latest batch (best-effort under
            # concurrent lanes)
            self._last_rung = served
            events.emit("verify.dispatch", backend=served, size=total,
                        occupancy=round(occupancy, 4) if occupancy is not None else None,
                        seconds=round(dt, 6),
                        **({"host": host.name} if host is not None else {}))
            return out

    # Failover order from each starting rung.  The Python oracle cannot
    # fail for native reasons, so a fault on the cpu rung never surfaces
    # to waiters.  The device rung has nothing below it: the reference's
    # tpu -> cpu -> oracle would put the CPU in the card's place.
    _LADDER = {"tpu": ("tpu",), "cpu": ("cpu", "oracle"), "oracle": ("oracle",)}

    def _run_ladder(self, backend: str, payloads: list, total: int,
                    host: Optional[_HostState] = None) -> tuple[list[bool], str]:
        """Run one coalesced batch starting at ``backend``, re-dispatching
        the same batch down its ladder on failure.  Device-rung outcomes
        feed the circuit breaker (the HOST's in fleet mode).  Returns
        (results, rung that served).  A batch that fails on its last rung
        raises — and then fails just this batch's waiters; the queue loop
        survives.

        Fleet specifics: a host partition (:class:`HostLost` / an injected
        ``mesh.dispatch:partition``) escapes the ladder at once — the
        worker re-queues the lane.  A device failure on a fleet host
        probes a smaller sub-mesh: it shrinks to the largest still-healthy
        half for later lanes; a device success after the breaker's
        cooldown (or a canary that closes it) re-grows it."""
        breaker = host.breaker if host is not None else self._breaker
        rungs = [r for r in self._LADDER[backend] if r != "cpu" or self._cpu is not None]
        for i, rung in enumerate(rungs):
            try:
                if chaos.on:  # injected batch, device or host failure
                    if host is not None:
                        chaos.maybe_raise("mesh.dispatch", f"{host.name}:{rung}:chips{host.chips}")
                    chaos.maybe_raise("engine.dispatch", rung)
                # 3-argument call shape kept when hostless: tests wrap
                # _run_backend with (rung, payloads, total)
                out = (self._run_backend(rung, payloads, total) if host is None
                       else self._run_backend(rung, payloads, total, host))
            except HostLost:
                raise
            except ChaosPartition as e:
                raise HostLost(str(e)) from e
            except Exception as e:  # noqa: BLE001 — reported, then the next rung or raised
                err = f"{type(e).__name__}: {e}"[:300]
                metrics.inc("verify.dispatch_errors")
                events.emit("verify.failure", where="dispatch", backend=rung, size=total,
                            error=err, **({"host": host.name} if host is not None else {}))
                if rung == "tpu":
                    breaker.record_failure(err)
                    if host is not None:
                        # any device-rung failure on a fleet host probes the
                        # smaller sub-mesh: device losses surface as assorted
                        # runtime errors that cannot be classified reliably.
                        # A wrong shrink self-heals through the re-grow.
                        self._host_shrink(host)
                if i + 1 >= len(rungs):
                    raise  # the last rung failed: the waiters learn it
                metrics.inc("verify.failovers")
                events.emit("verify.failover", source=rung, target=rungs[i + 1], size=total,
                            error=err)
                log.warning("[Engine] batch of %d failed on %s, retrying on %s: %s",
                            total, rung, rungs[i + 1], err)
                continue
            if rung == "tpu":
                closed = breaker.record_success()
                if host is not None and (
                    closed
                    or (
                        # the re-grow is not gated on a breaker open/close
                        # cycle (a single device loss only degrades it): any
                        # device success on a shrunken host re-probes the
                        # full row once a breaker cooldown has passed
                        0 < host.chips < host.full_chips
                        and time.monotonic() - host.shrunk_at >= BREAKER_COOLDOWN
                    )
                ):
                    self._host_regrow(host)
            return out, rung
        raise RuntimeError("no verify backend available")  # unreachable

    @staticmethod
    def _pack(payloads: list) -> RawBatch:
        """The payloads as one RawBatch: item tuples are packed here, in
        the dispatching thread."""
        with span("verify.pack"):
            return concat_raw([as_raw_batch(p) for p in payloads])

    def _run_backend(self, rung: str, payloads: list, total: int,
                     host: Optional[_HostState] = None) -> list[bool]:
        """Execute one ladder rung over the coalesced payloads."""
        if rung == "tpu":
            # counts tpu and cpu items per chunk; the 1-argument call shape
            # kept when hostless: tests wrap _run_tpu with (payloads)
            return self._run_tpu(payloads) if host is None else self._run_tpu(payloads, host)
        if rung == "cpu" and self._cpu is not None:
            out = self._cpu.verify_raw(self._pack(payloads))
            metrics.inc("verify.cpu_items", total)
            return out
        out = []
        for p in payloads:
            out.extend(verify_batch_cpu(p if isinstance(p, list) else as_raw_batch(p).to_tuples()))
        metrics.inc("verify.oracle_items", total)
        return out

    def _mesh(self):
        """Lazily-built card mesh for the sharded device rung: None when
        ``mesh_devices`` is off, fewer than 2 cards are visible, or mesh
        construction already failed (tried once; the rung then runs on the
        engine's one card).  Thread-safe: concurrent lanes race to be the
        first dispatch."""
        if self.cfg.mesh_devices < 2 or self._mesh_state == "failed":
            return None
        with self._mesh_lock:
            if self._mesh_state == "failed":
                return None
            if self._mesh_obj is None:
                try:
                    n = min(self.cfg.mesh_devices, len(visible_devices(self.device)))
                    if n < 2:
                        raise RuntimeError(f"mesh_devices={self.cfg.mesh_devices} but only "
                                           f"{n} device(s) visible")
                    self._mesh_obj = make_mesh(n, device=self.device)
                    self._mesh_state = "ready"
                    events.emit("verify.mesh", state="ready", devices=n)
                except Exception as e:  # noqa: BLE001 — the mesh is an upgrade, never a gate
                    self._mesh_state = "failed"
                    log.warning("[Engine] sharded dispatch unavailable, single-card rung: %s", e)
                    events.emit("verify.mesh", state="failed", error=str(e)[:300])
                    return None
            return self._mesh_obj

    # -- fleet host health and sub-meshes --------------------------------------

    def _host_down(self, hs: _HostState, error: str) -> None:
        """Deactivate a lost host: trip its breaker (open at once — the
        cooldown and canary recovery apply unchanged), move its queued
        lanes to active peers, and wake the fleet.  Idempotent —
        concurrent lanes observing the same partition deactivate once."""
        assert self._fleet is not None
        if hs.lost:
            return
        hs.lost = True
        hs.lost_at = time.monotonic()
        hs.breaker.trip(error[:300])
        moved = self._fleet.deactivate(hs.name)
        active = len(self._fleet.active_hosts())
        metrics.inc("mesh.host_losses")
        metrics.set_gauge("mesh.active_hosts", float(active))
        events.emit("mesh.host_down", host=hs.name, error=error[:200],
                    requeued_lanes=moved, active_hosts=active)
        log.warning("[Engine] fleet host %s lost (%d active): %s", hs.name, active, error)
        self._wake_fleet()
        if self._room is not None:
            self._room.set()

    def _host_rejoin(self, hs: _HostState) -> None:
        """Cooldown elapsed: the host re-enters the active set with its
        breaker open — the first lane it takes is the half-open canary
        (success closes the breaker and re-grows the sub-mesh; a
        still-dead host is deactivated again by the next HostLost)."""
        assert self._fleet is not None
        hs.lost = False
        self._fleet.activate(hs.name)
        active = len(self._fleet.active_hosts())
        metrics.set_gauge("mesh.active_hosts", float(active))
        events.emit("mesh.host_up", host=hs.name, active_hosts=active, probing=True)
        self._wake_fleet()
        if self._room is not None:
            self._room.set()

    def _host_shrink(self, hs: _HostState) -> None:
        """Device failure on a multi-card host: rebuild its sub-mesh as the
        largest still-healthy half (8 -> 4 -> 2 -> 1 cards) instead of
        dropping to one card in one step.  The failed batch has already
        failed its waiters; later lanes use the smaller mesh."""
        with self._mesh_lock:
            if not hs.full_chips:
                # the failure can precede the first sub-mesh build (chips
                # still 0): resolve this host's row width so there is a
                # known-good whole to halve
                hybrid = self._fleet_hybrid_mesh()
                if hybrid is not None:
                    hs.full_chips = int(hybrid.devices.shape[-1])
                    hs.chips = hs.full_chips
            if hs.chips <= 1:
                return
            hs.chips //= 2
            hs.shrunk_at = time.monotonic()
            hs.mesh = None  # rebuilt lazily at the new width
            hs.mesh_state = "cold"
            chips = hs.chips
        metrics.inc("mesh.shrinks")
        self._chips_gauge(hs.name, chips)
        events.emit("mesh.shrink", host=hs.name, chips=chips)
        log.warning("[Engine] host %s sub-mesh shrunk to %d card(s)", hs.name, chips)

    def _host_regrow(self, hs: _HostState) -> None:
        """Restore the host's full device row — on a breaker canary close,
        or on any device success once a breaker cooldown has passed since
        the shrink, so a loss that never opened the breaker cannot pin the
        host at reduced width forever.  A repeat loss just shrinks again,
        at most once per cooldown."""
        with self._mesh_lock:
            if not hs.full_chips or hs.chips >= hs.full_chips:
                return
            hs.chips = hs.full_chips
            hs.mesh = None
            hs.mesh_state = "cold"
            chips = hs.chips
        metrics.inc("mesh.regrows")
        self._chips_gauge(hs.name, chips)
        events.emit("mesh.regrow", host=hs.name, chips=chips)
        log.info("[Engine] host %s sub-mesh re-grown to %d card(s)", hs.name, chips)

    @staticmethod
    def _chips_gauge(host: str, chips: int) -> None:
        # per-host sub-mesh width as a labeled gauge: the fleet timeline
        # (timeseries.py) samples it, so a shrink and re-grow can be
        # reconstructed after the fact
        metrics.set_gauge("mesh.host_chips", float(chips), labels={"host": host})

    def _fleet_hybrid_mesh(self):
        """The fleet's (host, chip) hybrid mesh, carved lazily on first
        device dispatch.  Caller holds ``_mesh_lock``.  None = hybrid
        construction failed: every host dispatches on the engine's one
        card (the mesh is an upgrade, never a gate)."""
        if self._fleet_hybrid_state == "failed":
            return None
        if self._fleet_hybrid is None:
            try:
                n = len(visible_devices(self.device))
                if self.cfg.mesh_devices:
                    n = min(n, self.cfg.mesh_devices)
                hosts = self.cfg.mesh_hosts
                chips = max(1, n // hosts)
                self._fleet_hybrid = make_hybrid_mesh(hosts, chips, device=self.device)
                self._fleet_hybrid_state = "ready"
                events.emit("verify.mesh", state="ready", hosts=hosts, chips_per_host=chips)
            except Exception as e:  # noqa: BLE001 — the mesh is an upgrade, never a gate
                self._fleet_hybrid_state = "failed"
                log.warning("[Engine] hybrid fleet mesh unavailable, per-host single-card "
                            "dispatch: %s", e)
                events.emit("verify.mesh", state="failed", error=str(e)[:300])
                return None
        return self._fleet_hybrid

    def _host_mesh(self, hs: _HostState):
        """This host's 1-D device sub-mesh at its current healthy width
        (its hybrid-mesh row via :func:`multichip.host_submesh`; None =
        the engine's one card).  Thread-safe: dispatch threads race on
        first build and after shrink or re-grow."""
        if hs.mesh_state == "ready":
            return hs.mesh
        if hs.mesh_state == "failed":
            return None
        with self._mesh_lock:
            if hs.mesh_state != "cold":
                return hs.mesh if hs.mesh_state == "ready" else None
            hybrid = self._fleet_hybrid_mesh()
            if hybrid is None:
                hs.mesh_state = "failed"
                return None
            try:
                if not hs.full_chips:
                    hs.full_chips = int(hybrid.devices.shape[-1])
                    hs.chips = hs.full_chips
                hs.mesh = host_submesh(hybrid, hs.index, chips=hs.chips)
                hs.mesh_state = "ready"
                self._chips_gauge(hs.name, hs.chips)
                return hs.mesh
            except Exception as e:  # noqa: BLE001 — the mesh is an upgrade, never a gate
                hs.mesh_state = "failed"
                events.emit("verify.mesh", state="failed", host=hs.name, error=str(e)[:300])
                return None

    def _dispatch_chunk(self, chunk: RawBatch, pad_to: int,
                        host: Optional[_HostState] = None) -> tuple:
        """Launch one fixed-shape chunk on the device rung without waiting:
        sharded over the host's sub-mesh in fleet mode, over the engine's
        mesh when ``mesh_devices`` is set, on the engine's one card
        otherwise.  Returns the (verdicts, count) handle for
        ``collect_verdicts``."""
        mesh = self._host_mesh(host) if host is not None else self._mesh()
        modes = dict(window_bits=self.cfg.window_bits, point_form=self.cfg.point_form,
                     reduce=self.cfg.field_reduce, select=self.select, ladder=self.ladder,
                     sqr=self.cfg.field_sqr, mul=self.cfg.field_mul)
        if mesh is not None:
            return dispatch_raw_sharded(chunk, mesh, pad_to=pad_to, **modes)
        return dispatch_batch_gpu_raw(chunk, pad_to=pad_to, device=self.device, **modes)

    def _run_tpu(self, payloads: list, host: Optional[_HostState] = None) -> list[bool]:
        """The device rung in fixed-size chunks: each launch is at one of
        the two shapes the warmup ran (``device_batch``, or ``batch_size``
        for short tails), every chunk is launched before any verdict is
        read back, and whole lanes overlap through :data:`PIPELINE_DEPTH`
        dispatch threads.  With "auto", a chunk shorter than
        ``min_tpu_batch`` goes to the cpu rung."""
        raw = self._pack(payloads)
        big = self._device_batch
        pending: list = []  # (verdicts, count) handles or cpu verdicts
        for lo in range(0, len(raw), big):
            chunk = raw.slice(lo, lo + big)
            if (len(chunk) < self.cfg.min_tpu_batch and self.cfg.backend != "tpu"
                    and self._cpu is not None):
                pending.append(self._cpu.verify_raw(chunk))
                metrics.inc("verify.cpu_items", len(chunk))
            else:
                pad = big if len(chunk) > self.cfg.batch_size else self.cfg.batch_size
                pending.append(self._dispatch_chunk(chunk, pad, host))
                metrics.inc("verify.tpu_items", len(chunk))
        out: list[bool] = []
        for p in pending:
            out.extend(p if isinstance(p, list) else collect_verdicts(*p))
        return out
