"""threadsan: the thread-side twin of asyncsan.

asyncsan watches the event loop; this module watches the ~18
``threading.Lock``/``RLock`` instances the node has grown across 12
modules — the group-commit writer, extract pool workers, dispatch
workers, fleet host workers, the flight recorder's synchronous
observers.  One bug shows the gap: the ``CircuitBreaker._lock``
self-deadlock (breaker emits ``verify.breaker`` holding its lock, the
recorder's observer re-enters ``stats()`` on the same thread) was only
found because a bench worker *hung*.  threadsan finds that class of bug
before anything hangs:

* **Lock-order cycle detection** — every instrumented acquire while
  other locks are held adds name-level edges to a global lock-order
  graph; the first edge that closes a cycle records a
  ``threadsan.lock_cycle`` finding (both witness stacks attached) the
  moment the *potential* deadlock is created, not when two threads
  finally interleave badly.
* **Reentry detection** — a blocking re-acquire of a non-reentrant lock
  by the thread that already holds it is a guaranteed self-deadlock;
  threadsan records a ``threadsan.lock_reentry`` finding and raises
  :class:`ThreadSanError` instead of hanging (the breaker bug above,
  pinned in tests/test_threadsan.py with the RLock fix reverted).
* **Hold-time + loop-blocking telemetry** — per-lock
  ``threadsan.hold_seconds{lock=}`` histograms, a max-hold watermark for
  bench.py's sanitizers section, and detection of a *blocking* acquire
  that stalls a registered event-loop thread (``threadsan.loop_block``),
  complementing asyncsan's slow-callback attribution.

Off path (the default) an instrumented acquire is two attribute reads
ahead of the raw ``lock.acquire`` — micro-benched <5µs per
acquire/release pair in tests/test_threadsan.py.  Arm it with
``registry.arm()`` (and ``registry.register_loop_thread()`` for the
loop-blocking report).

Reporting never happens synchronously under user locks: findings and
counters update in place (guarded by the registry's one sanctioned bare
lock), while events/metrics emission — which would re-enter the very
locks being watched — runs on a short-lived daemon reporter thread with
the per-thread ``busy`` flag set so threadsan never instruments itself.

Import discipline: stdlib-only at module scope (``metrics`` and
``events`` construct registry locks at import time, so threadsan
must not import them back except lazily inside reporting paths).
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
import traceback
from typing import Optional, Union

__all__ = [
    "lock",
    "rlock",
    "registry",
    "LockRegistry",
    "SanLock",
    "ThreadSanError",
]

log = logging.getLogger("tpunode_torch.threadsan")

#: Loop-thread blocking-acquire threshold in seconds.
LOOP_BLOCK_THRESHOLD = 0.05

#: Frames kept per witness stack.
_MAX_FRAMES = 16

#: Findings kept in the registry (counters keep counting past this).
_MAX_FINDINGS = 64


class ThreadSanError(RuntimeError):
    """A guaranteed self-deadlock: blocking acquire of a non-reentrant
    lock by the thread that already holds it.  Raised *instead of*
    hanging, so the bug surfaces as a stack trace, not a stuck worker."""


def _capture_stack(skip: int = 2) -> list[str]:
    """Innermost-first formatted frames of the caller, threadsan frames
    skipped.  Cheap enough for first-witness capture (once per lock
    pair), never on the steady-state path."""
    try:
        frame = sys._getframe(skip)
    except ValueError:  # pragma: no cover - shallow stacks
        return []
    out = []
    for fs in reversed(traceback.extract_stack(frame)):
        out.append(
            f"{os.path.basename(fs.filename)}:{fs.lineno} in {fs.name}"
        )
        if len(out) >= _MAX_FRAMES:
            break
    return out


class _Held:
    """One entry in a thread's held-lock stack."""

    __slots__ = ("lock", "name", "t0", "depth")

    def __init__(self, san: "SanLock", t0: float):
        self.lock = san
        self.name = san.name
        self.t0 = t0
        self.depth = 1


class SanLock:
    """Named instrumented wrapper over ``threading.Lock``/``RLock``.

    Supports the full subset of the lock protocol the tree uses:
    ``acquire(blocking, timeout)``, ``release()``, context manager, and
    ``locked()``.  Disarmed, ``acquire`` is two attribute reads ahead of
    the raw primitive.
    """

    __slots__ = ("_raw", "_reg", "name", "reentrant")

    def __init__(self, name: str, reg: "LockRegistry", reentrant: bool):
        self.name = name
        self._reg = reg
        self.reentrant = reentrant
        self._raw = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not self._reg._armed:
            return self._raw.acquire(blocking, timeout)
        return self._reg._acquire(self, blocking, timeout)

    def release(self) -> None:
        if not self._reg._armed:
            self._raw.release()
            return
        self._reg._release(self)

    def __enter__(self) -> "SanLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        fn = getattr(self._raw, "locked", None)
        if fn is not None:
            return bool(fn())
        return bool(self._raw._is_owned())  # RLock before py3.12

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        kind = "rlock" if self.reentrant else "lock"
        return f"<SanLock {self.name!r} ({kind})>"


class LockRegistry:
    """Global registry of named instrumented locks + the lock-order
    graph and per-thread lockset state that power the detectors."""

    def __init__(self):
        # The ONE sanctioned bare lock in the tree outside test fixtures:
        # it guards threadsan's own graph/finding state and must never be
        # instrumented (it would watch itself).
        self._meta = threading.Lock()
        self._armed = False
        self._epoch = 0
        self._tls = threading.local()
        self._loop_threads: set[int] = set()
        # name -> number of instances constructed under that name
        self._names: dict[str, int] = {}
        # name-level order graph: edge a -> b when b was acquired with a
        # held.  _edge_seen makes the steady-state re-walk O(held) set
        # probes with no witness-stack capture.
        self._edges: dict[str, set[str]] = {}
        self._edge_seen: set[tuple[str, str]] = set()
        self._edge_witness: dict[tuple[str, str], dict] = {}
        self._reported_cycles: set[frozenset] = set()
        self._reported_reentries: set[str] = set()
        self.findings: list[dict] = []
        self.lock_cycles = 0
        self.lock_reentries = 0
        self.loop_blocks = 0
        self.max_hold_seconds = 0.0
        self.last_loop_block: Optional[dict] = None

    # ------------------------------------------------------------------
    # construction / lifecycle

    def lock(self, name: str) -> SanLock:
        """A named non-reentrant lock (wraps ``threading.Lock``)."""
        return self._new(name, reentrant=False)

    def rlock(self, name: str) -> SanLock:
        """A named reentrant lock (wraps ``threading.RLock``)."""
        return self._new(name, reentrant=True)

    def _new(self, name: str, reentrant: bool) -> SanLock:
        with self._meta:
            self._names[name] = self._names.get(name, 0) + 1
        return SanLock(name, self, reentrant)

    def arm(self) -> None:
        """Turn instrumentation on.  Bumps the epoch so held-stack state
        from a previous arming window is discarded per thread."""
        with self._meta:
            self._epoch += 1
            self._armed = True

    def disarm(self) -> None:
        self._armed = False

    def register_loop_thread(self, ident: Optional[int] = None) -> None:
        """Mark a thread (default: current) as an event-loop thread so
        blocking acquires that stall it are reported."""
        self._loop_threads.add(
            threading.get_ident() if ident is None else ident
        )

    def reset(self) -> None:
        """Drop graph + findings + counters (tests)."""
        with self._meta:
            self._epoch += 1
            self._loop_threads.clear()
            self._edges.clear()
            self._edge_seen.clear()
            self._edge_witness.clear()
            self._reported_cycles.clear()
            self._reported_reentries.clear()
            self.findings = []
            self.lock_cycles = 0
            self.lock_reentries = 0
            self.loop_blocks = 0
            self.max_hold_seconds = 0.0
            self.last_loop_block = None

    def snapshot(self) -> dict:
        """Cheap state dump for bench.py's sanitizers section and the
        flight recorder's ``threadsan`` source."""
        with self._meta:
            return {
                "armed": self._armed,
                "locks": len(self._names),
                "edges": len(self._edge_seen),
                "lock_cycles": self.lock_cycles,
                "lock_reentries": self.lock_reentries,
                "loop_blocks": self.loop_blocks,
                "max_hold_ms": round(self.max_hold_seconds * 1000.0, 3),
                "findings": list(self.findings[-8:]),
            }

    # ------------------------------------------------------------------
    # instrumented acquire / release

    def _state(self):
        tls = self._tls
        if getattr(tls, "epoch", None) != self._epoch:
            tls.epoch = self._epoch
            tls.held = []
            tls.busy = False
        return tls

    def _acquire(self, san: SanLock, blocking: bool, timeout: float) -> bool:
        tls = self._state()
        if tls.busy:  # threadsan's own reporting path: stay raw
            return san._raw.acquire(blocking, timeout)
        held = tls.held
        for h in held:
            if h.lock is san:
                if san.reentrant:
                    ok = san._raw.acquire(blocking, timeout)
                    if ok:
                        h.depth += 1
                    return ok
                # Non-reentrant re-acquire by the holding thread: a
                # blocking call can never return.  Report, then raise
                # rather than hang (timeout'd/non-blocking calls are
                # left to fail on their own).
                self._report_reentry(san, tls)
                if blocking and timeout < 0:
                    raise ThreadSanError(
                        f"thread {threading.current_thread().name!r} "
                        f"re-acquired non-reentrant lock {san.name!r} it "
                        "already holds (guaranteed self-deadlock; use "
                        "threadsan.rlock() if reentry is intended)"
                    )
                return san._raw.acquire(blocking, timeout)
        if held:
            self._note_edges(held, san, tls)
        waited = None
        ok = san._raw.acquire(False)
        if not ok:
            if not blocking:
                return False
            t0 = time.perf_counter()
            ok = san._raw.acquire(True, timeout)
            waited = time.perf_counter() - t0
        if not ok:
            return False
        if (
            waited is not None
            and threading.get_ident() in self._loop_threads
            and waited >= LOOP_BLOCK_THRESHOLD
        ):
            self._report_loop_block(san, waited, tls)
        held.append(_Held(san, time.perf_counter()))
        return True

    def _release(self, san: SanLock) -> None:
        tls = self._state()
        if tls.busy:
            san._raw.release()
            return
        held = tls.held
        for i in range(len(held) - 1, -1, -1):
            h = held[i]
            if h.lock is san:
                if h.depth > 1:
                    h.depth -= 1
                    san._raw.release()
                    return
                del held[i]
                dt = time.perf_counter() - h.t0
                san._raw.release()
                self._note_hold(san, dt, tls)
                return
        # Acquired before arming (or on another thread — already a bug
        # the raw primitive will raise on): pass through.
        san._raw.release()

    # ------------------------------------------------------------------
    # lock-order graph

    def _note_edges(self, held: list, san: SanLock, tls) -> None:
        name_b = san.name
        fresh: list[tuple[str, str]] = []
        with self._meta:
            for h in held:
                if h.name == name_b:
                    continue  # same-name siblings (e.g. per-host breakers)
                pair = (h.name, name_b)
                if pair not in self._edge_seen:
                    self._edge_seen.add(pair)
                    fresh.append(pair)
        if not fresh:
            return  # steady state: no witness capture, no graph walk
        stack = _capture_stack(skip=3)
        thread = threading.current_thread().name
        cycles: list[dict] = []
        with self._meta:
            for a, b in fresh:
                # A path b ->* a through existing edges means adding
                # a -> b closes a cycle: two threads CAN deadlock.
                path = self._find_path(b, a)
                self._edges.setdefault(a, set()).add(b)
                self._edge_witness[(a, b)] = {
                    "thread": thread,
                    "stack": stack,
                }
                if path is None:
                    continue
                chain = [a] + path  # a -> b -> ... -> a
                key = frozenset(chain)
                if key in self._reported_cycles:
                    continue
                self._reported_cycles.add(key)
                witnesses = {}
                for x, y in zip(path, path[1:]):
                    w = self._edge_witness.get((x, y))
                    if w is not None:
                        witnesses[f"{x}->{y}"] = w
                finding = {
                    "kind": "cycle",
                    "chain": chain,
                    "edge": f"{a}->{b}",
                    "thread": thread,
                    "stack": stack,
                    "witnesses": witnesses,
                }
                self.lock_cycles += 1
                if len(self.findings) < _MAX_FINDINGS:
                    self.findings.append(finding)
                cycles.append(finding)
        for finding in cycles:
            log.error(
                "threadsan: lock-order cycle %s (first witness: %s)",
                " -> ".join(finding["chain"]),
                finding["thread"],
            )
            self._emit(
                "threadsan.lock_cycle",
                {
                    "chain": finding["chain"],
                    "edge": finding["edge"],
                    "thread": finding["thread"],
                    "stack": finding["stack"][:8],
                    "witnesses": {
                        k: w["stack"][:8]
                        for k, w in finding["witnesses"].items()
                    },
                },
                "threadsan.lock_cycles",
            )

    def _find_path(self, src: str, dst: str) -> Optional[list[str]]:
        """DFS: a path src -> ... -> dst through the order graph, or
        None.  Returned list starts at src and ends at dst."""
        if src == dst:
            return [src]
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in self._edges.get(node, ()):
                if nxt == dst:
                    return path + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # ------------------------------------------------------------------
    # findings + telemetry

    def _report_reentry(self, san: SanLock, tls) -> None:
        stack = _capture_stack(skip=3)
        thread = threading.current_thread().name
        with self._meta:
            self.lock_reentries += 1
            first = san.name not in self._reported_reentries
            if first:
                self._reported_reentries.add(san.name)
                if len(self.findings) < _MAX_FINDINGS:
                    self.findings.append(
                        {
                            "kind": "reentry",
                            "lock": san.name,
                            "thread": thread,
                            "stack": stack,
                        }
                    )
        log.error(
            "threadsan: non-reentrant lock %r re-acquired by holding "
            "thread %r",
            san.name,
            thread,
        )
        if first:
            self._emit(
                "threadsan.lock_reentry",
                {"lock": san.name, "thread": thread, "stack": stack[:8]},
                "threadsan.lock_reentries",
            )

    def _report_loop_block(self, san: SanLock, waited: float, tls) -> None:
        info = {
            "lock": san.name,
            "waited_seconds": round(waited, 4),
            "thread": threading.current_thread().name,
            "stack": _capture_stack(skip=3)[:8],
        }
        with self._meta:
            self.loop_blocks += 1
            self.last_loop_block = info
        log.warning(
            "threadsan: blocking acquire of %r stalled loop thread for "
            "%.1fms",
            san.name,
            waited * 1000.0,
        )
        self._emit("threadsan.loop_block", info, "threadsan.loop_blocks")

    def _note_hold(self, san: SanLock, dt: float, tls) -> None:
        if dt > self.max_hold_seconds:
            self.max_hold_seconds = dt
        tls.busy = True
        try:
            from .metrics import metrics

            metrics.observe(
                "threadsan.hold_seconds", dt, labels={"lock": san.name}
            )
        except Exception:  # pragma: no cover - metrics must never break locks
            pass
        finally:
            tls.busy = False

    def _emit(self, event_type: str, fields: dict, counter: str) -> None:
        """Emit the finding's event + metric from a one-shot daemon
        thread.  Synchronous emission would run the flight recorder's
        observers (which re-enter engine/metrics locks) while the caller
        may be holding the very locks being reported — the exact shape
        of bug threadsan exists to catch."""

        def run() -> None:
            tls = self._state()
            tls.busy = True
            try:
                from .events import events
                from .metrics import metrics

                metrics.inc(counter)
                events.emit(event_type, **fields)
            except Exception:  # pragma: no cover
                log.debug("threadsan: report emission failed", exc_info=True)

        threading.Thread(
            target=run, name="threadsan-report", daemon=True
        ).start()


#: Process-wide registry.  Module-level so every subsystem's locks share
#: one order graph regardless of construction order.
registry = LockRegistry()


def lock(name: str) -> SanLock:
    """A named non-reentrant lock on the global registry."""
    return registry.lock(name)


def rlock(name: str) -> SanLock:
    """A named reentrant lock on the global registry."""
    return registry.rlock(name)

