"""chaos — deterministic fault injection for the whole node.

The reference haskoin-node earns its keep by *surviving*: peers drop,
stall, and send garbage, and the supervisor tree keeps the chain
consistent through all of it.  None of that is testable here without a
way to make those failures happen on demand — so this module is a
seeded, declarative fault registry with **named injection points** wired
into the layers that actually fail in production:

========================  =================================================
point                     actions
========================  =================================================
``peer.recv``             ``drop`` (EOF), ``stall`` (sleep ``dur`` then
                          read), ``garbage`` (replace the chunk with
                          deterministic noise), ``partial`` (truncate the
                          chunk, then EOF — a mid-frame cut)
``peer.send``             ``drop``, ``stall``, ``garbage``
``mailbox.send``          ``delay`` (deliver after ``dur``), ``reorder``
                          (jump the queue head)
``store.write``           ``error`` (raise ChaosFault from the write)
``store.append``          ``error``, ``torn_write`` (write a prefix of the
                          record blob, then hard-exit — a torn page),
                          ``bit_flip`` (flip one bit in the blob before it
                          hits disk; the process continues — simulated
                          media corruption the CRC must catch on reopen),
                          ``crash`` (``os._exit(CRASH_EXIT)`` at the
                          injection point, before the write)
``store.rotate``          ``error``, ``crash`` (at segment-rotation steps)
``store.compact``         ``error``, ``crash`` (at compaction sub-steps;
                          ``match`` selects the window: ``snapshot``,
                          ``pre_replace``, ``post_replace``, ``cleanup``)
``engine.dispatch``       ``error`` (batch failure), ``device_loss``
                          (raise ChaosDeviceLoss — the breaker's
                          signal), ``stall`` (sleep ``dur`` in the
                          dispatch worker thread — a wedged backend;
                          the SLO engine's synthetic burn source)
``engine.warmup``         ``error`` (device warmup/compile failure)
``mesh.dispatch``         ``error``, ``device_loss`` (one host's chip/
                          sub-mesh fails — that host's breaker degrades
                          it alone), ``partition`` (raise ChaosPartition
                          — the whole host is unreachable: the fleet
                          dispatcher re-queues its lanes and drops it
                          from the active set until a canary rejoins
                          it).  ``match`` scopes the fault to one host
                          and/or rung: the site label is
                          ``<host>:<rung>:chips<n>``
========================  =================================================

A fault plan is a seed plus a list of :class:`FaultSpec`, parsed by
:meth:`ChaosPlan.parse` (or built programmatically) and armed with
``chaos.install``::

    chaos.install(ChaosPlan.parse(
        "seed=42;peer.recv:garbage:p=0.05;engine.dispatch:device_loss:match=tpu,n=3,after=2"))

Segments are ``;``-separated; a fault segment is
``<point>:<action>[:key=val[,key=val...]]`` with keys ``p`` (fire
probability, default 1), ``n`` (max fires, default unlimited),
``after`` (eligible hits skipped before the first fire), ``dur``
(seconds, for stall/delay), ``match`` (substring filter on the site
label — a peer label, mailbox name, or engine backend rung).  Every
random decision — fire/don't, garbage bytes — comes from one
``random.Random(seed)``, so a failure scenario is a *reproducible seed*:
re-running the same plan against the same workload injects the same
faults in the same order.

**Zero overhead when off** is a hard contract: every injection site is
written ``if chaos.on: ...`` so no installed plan costs one
attribute read and a never-taken branch on the hot paths it guards
(pinned by the micro-bench in tests/test_chaos.py).  Unknown points or
actions fail ``parse`` loudly — a typo'd plan must never silently
no-op.  Every fire is counted (``chaos.injections`` labeled metric) and
logged (``chaos.inject`` event) so a soak run's artifact shows exactly
what was injected where.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from . import threadsan
from .events import events
from .metrics import metrics

__all__ = [
    "CRASH_EXIT",
    "POINTS",
    "ChaosDeviceLoss",
    "ChaosFault",
    "ChaosPartition",
    "ChaosPlan",
    "FaultSpec",
    "chaos",
]

#: Exit status of an injected ``crash``/``torn_write`` hard-exit: the
#: kill-torture harness (tpunode/torture.py) asserts on it to tell an
#: injected death apart from an ordinary child failure.
CRASH_EXIT = 86

log = logging.getLogger("tpunode_torch.chaos")


class ChaosFault(RuntimeError):
    """An injected fault (store write / engine batch / warmup)."""


class ChaosDeviceLoss(ChaosFault):
    """Injected device loss: what a mid-run device disappearance raises on
    the engine's device rung (the circuit breaker's trigger)."""


class ChaosPartition(ChaosFault):
    """Injected host partition: the WHOLE host is gone, so
    the dispatch ladder must not serve the lane locally — the fleet
    dispatcher re-queues it onto a healthy peer and deactivates the
    host until a canary re-probe succeeds."""


#: Injection-point catalog: point -> allowed actions (ROBUSTNESS.md is
#: the user-facing version).  ``parse`` validates against this.
POINTS: dict[str, tuple[str, ...]] = {
    "peer.recv": ("drop", "stall", "garbage", "partial"),
    "peer.send": ("drop", "stall", "garbage"),
    "mailbox.send": ("delay", "reorder"),
    "store.write": ("error",),
    "store.append": ("error", "torn_write", "bit_flip", "crash"),
    "store.rotate": ("error", "crash"),
    "store.compact": ("error", "crash"),
    "engine.dispatch": ("error", "device_loss", "stall"),
    "engine.warmup": ("error",),
    "mesh.dispatch": ("error", "device_loss", "partition"),
}


@dataclass
class FaultSpec:
    """One declarative fault: where, what, and how often."""

    point: str
    action: str
    p: float = 1.0  # fire probability per eligible hit
    n: Optional[int] = None  # max fires (None = unlimited)
    after: int = 0  # eligible hits skipped before the first fire
    dur: float = 0.05  # seconds (stall / delay)
    match: str = ""  # substring filter on the site label
    # runtime counters (owned by the installed Chaos registry)
    hits: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        allowed = POINTS.get(self.point)
        if allowed is None:
            raise ValueError(
                f"unknown chaos point {self.point!r} (known: "
                f"{', '.join(sorted(POINTS))})"
            )
        if self.action not in allowed:
            raise ValueError(
                f"chaos point {self.point!r} has no action "
                f"{self.action!r} (allowed: {', '.join(allowed)})"
            )
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"chaos p={self.p} outside [0, 1]")

    def describe(self) -> str:
        opts = []
        if self.p < 1.0:
            opts.append(f"p={self.p}")
        if self.n is not None:
            opts.append(f"n={self.n}")
        if self.after:
            opts.append(f"after={self.after}")
        if self.action in ("stall", "delay"):
            opts.append(f"dur={self.dur}")
        if self.match:
            opts.append(f"match={self.match}")
        tail = ":" + ",".join(opts) if opts else ""
        return f"{self.point}:{self.action}{tail}"


@dataclass
class ChaosPlan:
    """A seed plus the faults it drives (the :meth:`parse` syntax)."""

    seed: int = 0
    faults: list[FaultSpec] = field(default_factory=list)

    @classmethod
    def parse(cls, spec: str) -> "ChaosPlan":
        """Parse the declarative syntax (module docstring).  Raises
        ``ValueError`` on any unknown point/action/key — a chaos plan
        that silently no-ops would fake out the very tests it exists
        for."""
        seed = 0
        faults: list[FaultSpec] = []
        for seg in spec.split(";"):
            seg = seg.strip()
            if not seg:
                continue
            if seg.startswith("seed="):
                seed = int(seg[5:], 0)
                continue
            parts = seg.split(":", 2)
            if len(parts) < 2:
                raise ValueError(f"bad chaos segment {seg!r}")
            kw: dict = {"point": parts[0], "action": parts[1]}
            if len(parts) == 3 and parts[2]:
                for opt in parts[2].split(","):
                    k, _, v = opt.partition("=")
                    k = k.strip()
                    if k == "p":
                        kw["p"] = float(v)
                    elif k == "n":
                        kw["n"] = int(v)
                    elif k == "after":
                        kw["after"] = int(v)
                    elif k == "dur":
                        kw["dur"] = float(v)
                    elif k == "match":
                        kw["match"] = v
                    else:
                        raise ValueError(
                            f"unknown chaos option {k!r} in {seg!r}"
                        )
            faults.append(FaultSpec(**kw))
        return cls(seed=seed, faults=faults)

    def describe(self) -> str:
        return ";".join(
            [f"seed={self.seed}"] + [f.describe() for f in self.faults]
        )


class Chaos:
    """The process-wide injection registry.

    ``on`` is the only thing the hot paths read: injection sites are
    ``if chaos.on: <site hook>``, so the OFF path is one attribute load.
    All decision state (per-spec counters, the plan RNG) lives behind a
    lock — decisions happen on the event loop AND in the engine's
    dispatch worker thread, and determinism requires one serialized
    stream of RNG draws.
    """

    def __init__(self):
        self.on = False
        self._lock = threadsan.lock("chaos.controller")
        self._plan: Optional[ChaosPlan] = None
        self._rng: Optional[random.Random] = None
        self._by_point: dict[str, list[FaultSpec]] = {}

    # -- lifecycle -----------------------------------------------------------

    def install(self, plan: ChaosPlan) -> None:
        """Arm the registry with ``plan`` (replacing any previous plan;
        runtime counters reset)."""
        with self._lock:
            self._plan = plan
            self._rng = random.Random(plan.seed)
            self._by_point = {}
            for f in plan.faults:
                f.hits = f.fired = 0
                self._by_point.setdefault(f.point, []).append(f)
            self.on = bool(plan.faults)
        if self.on:
            log.warning("[Chaos] armed: %s", plan.describe())
            events.emit("chaos.install", plan=plan.describe())
            metrics.set_gauge("chaos.enabled", 1.0)

    def uninstall(self) -> None:
        """Disarm (test teardown): the OFF fast path is restored."""
        with self._lock:
            self.on = False
            self._plan = None
            self._rng = None
            self._by_point = {}
        metrics.set_gauge("chaos.enabled", 0.0)

    def stats(self) -> dict:
        """Injection telemetry: per-fault hit/fire counts (soak artifacts
        record this so a run shows what was actually injected)."""
        with self._lock:
            return {
                "enabled": self.on,
                "plan": self._plan.describe() if self._plan else None,
                "faults": [
                    {
                        "fault": f.describe(),
                        "hits": f.hits,
                        "fired": f.fired,
                    }
                    for f in (self._plan.faults if self._plan else ())
                ],
            }

    # -- the decision core ---------------------------------------------------

    def decide(self, point: str, label: str = "") -> Optional[FaultSpec]:
        """One injection decision at ``point`` (site context ``label``):
        the fault to apply, or None.  First matching spec wins; every
        fire is counted + logged."""
        with self._lock:
            specs = self._by_point.get(point)
            if not specs or self._rng is None:
                return None
            for spec in specs:
                if spec.match and spec.match not in label:
                    continue
                spec.hits += 1
                if spec.hits <= spec.after:
                    continue
                if spec.n is not None and spec.fired >= spec.n:
                    continue
                if spec.p < 1.0 and self._rng.random() >= spec.p:
                    continue
                spec.fired += 1
                metrics.inc(
                    "chaos.injections",
                    labels={"point": point, "action": spec.action},
                )
                events.emit(
                    "chaos.inject", point=point, action=spec.action,
                    label=label or None, fired=spec.fired,
                )
                return spec
        return None

    def maybe_raise(self, point: str, label: str = "") -> None:
        """Raise the configured fault at a raise-style point (store
        write, engine dispatch/warmup); no-op when nothing fires."""
        spec = self.decide(point, label)
        if spec is None:
            return
        if spec.action == "stall":
            # Blocks THIS dispatch worker thread for ``dur`` — the event
            # loop stays healthy, exactly like a wedged backend.
            time.sleep(spec.dur)
            return
        msg = f"chaos[{spec.describe()}] at {label or point}"
        if spec.action == "device_loss":
            raise ChaosDeviceLoss(msg)
        if spec.action == "partition":
            raise ChaosPartition(msg)
        raise ChaosFault(msg)

    def garbage(self, n: int) -> bytes:
        """``n`` deterministic noise bytes from the plan RNG."""
        with self._lock:
            rng = self._rng or random.Random(0)
            return rng.randbytes(n)

    def maybe_crash(self, point: str, label: str = "") -> None:
        """Structural storage point (rotate/compact sub-steps): ``crash``
        hard-exits the process at the injection point; ``error`` raises
        ChaosFault; no-op when nothing fires."""
        spec = self.decide(point, label)
        if spec is None:
            return
        if spec.action == "crash":
            self.hard_exit()
        raise ChaosFault(f"chaos[{spec.describe()}] at {label or point}")

    def mutate_blob(self, spec: FaultSpec, blob: bytes) -> bytes:
        """Apply a physical-write fault to ``blob``: ``bit_flip`` flips one
        deterministic bit, ``torn_write`` keeps a deterministic strict
        prefix (the caller writes it, then hard-exits).  Draws come from
        the plan RNG so the damage is part of the reproducible seed."""
        if not blob:
            return blob
        with self._lock:
            rng = self._rng or random.Random(0)
            if spec.action == "bit_flip":
                mutated = bytearray(blob)
                mutated[rng.randrange(len(blob))] ^= 1 << rng.randrange(8)
                return bytes(mutated)
            if spec.action == "torn_write":
                return blob[: rng.randrange(1, len(blob))] if len(blob) > 1 else b""
        return blob

    @staticmethod
    def hard_exit() -> None:
        """Die like ``kill -9``: no atexit, no finally blocks, no buffer
        flushing beyond what the caller already forced.  The distinctive
        status lets the torture harness assert the death was injected."""
        os._exit(CRASH_EXIT)

    # -- transport wrapper ---------------------------------------------------

    def wrap_connection(self, conn, label: str):
        """Wrap a peer transport with the ``peer.recv``/``peer.send``
        injection points; returns ``conn`` untouched when no peer faults
        are planned (sessions opened while armed pay nothing unless the
        plan targets them)."""
        with self._lock:
            active = "peer.recv" in self._by_point or (
                "peer.send" in self._by_point
            )
        if not active:
            return conn
        return _ChaosConnection(self, conn, label)


class _ChaosConnection:
    """Transport decorator applying socket-level faults (peer.py wraps
    the injected ``Connection`` with this when chaos is armed)."""

    __slots__ = ("_chaos", "_inner", "_label", "_eof")

    def __init__(self, registry: Chaos, inner, label: str):
        self._chaos = registry
        self._inner = inner
        self._label = label
        self._eof = False

    async def read_chunk(self) -> bytes:
        if self._eof:
            return b""
        spec = self._chaos.decide("peer.recv", self._label)
        if spec is None:
            return await self._inner.read_chunk()
        if spec.action == "drop":
            self._eof = True
            return b""  # EOF: the session dies like a real disconnect
        if spec.action == "stall":
            await asyncio.sleep(spec.dur)
            return await self._inner.read_chunk()
        chunk = await self._inner.read_chunk()
        if not chunk:
            return chunk
        if spec.action == "garbage":
            return self._chaos.garbage(len(chunk))
        # partial: a mid-frame cut — half the chunk, then EOF, so the
        # reader hits DecodeHeaderError("connection closed mid-frame")
        self._eof = True
        return chunk[: max(1, len(chunk) // 2)]

    async def write(self, data: bytes) -> None:
        spec = self._chaos.decide("peer.send", self._label)
        if spec is not None:
            if spec.action == "drop":
                return  # swallowed: the remote never sees it
            if spec.action == "stall":
                await asyncio.sleep(spec.dur)
            elif spec.action == "garbage":
                data = self._chaos.garbage(len(data))
        await self._inner.write(data)


#: The process-wide registry (mirrors ``metrics``/``events``).
chaos = Chaos()
