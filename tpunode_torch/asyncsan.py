"""asyncsan runtime sanitizers: hazards that only exist at runtime.

* **Loop debug mode** — :func:`install` switches the running event loop
  into asyncio debug mode with a tight ``slow_callback_duration``
  (default :data:`SLOW_CALLBACK_DURATION`, 0.1s), so any callback that
  holds the loop logs itself with source location.
* **Blocked-loop attribution** — :class:`LoopAttributor`: a sampling
  daemon thread watches a heartbeat the loop refreshes; when the
  heartbeat goes stale (the loop is frozen inside sync code) it captures
  the loop thread's CURRENT Python stack via ``sys._current_frames``.
  The stall watchdog (watchdog.py) attaches the captured frames to its
  ``watchdog.stall`` event — upgrading "the loop stalled" to "the loop
  stalled HERE".
* **Task-leak reporting** rides the supervision registry in actors.py
  (``spawn_supervised`` / ``task_registry``): leaks surface as
  ``asyncsan.task_leak`` events at node shutdown — reporting is cheap
  and always on; the debug mode and the attributor are opt-in.

Everything here is stdlib-only.
"""

from __future__ import annotations

import asyncio
import logging
import os
import sys
import threading
import time
import traceback
from typing import Optional

__all__ = [
    "install",
    "LoopAttributor",
    "SLOW_CALLBACK_DURATION",
]

log = logging.getLogger("tpunode_torch.asyncsan")

#: Default slow-callback threshold in seconds.
SLOW_CALLBACK_DURATION = 0.1


def install(loop: Optional[asyncio.AbstractEventLoop] = None) -> None:
    """Wire asyncio debug mode + slow-callback reporting into ``loop``
    (default: the running loop).  Idempotent; debug mode adds
    per-callback overhead, so only an embedder or a test that wants it
    calls this."""
    if loop is None:
        loop = asyncio.get_running_loop()
    loop.set_debug(True)
    loop.slow_callback_duration = SLOW_CALLBACK_DURATION
    log.info(
        "[asyncsan] loop debug mode on (slow_callback_duration=%.3fs)",
        loop.slow_callback_duration,
    )


class LoopAttributor:
    """Blocked-event-loop attributor: names the frame that froze the loop.

    The loop refreshes a heartbeat timestamp every ``interval`` seconds
    (a ``call_later`` chain — O(20/s) trivial callbacks).  A daemon
    sampler thread checks the heartbeat's age; past ``threshold`` it
    snapshots the loop thread's stack.  The snapshot taken *during* the
    freeze is exactly the offending synchronous code — information that
    is gone by the time the watchdog's next wakeup measures the lag.
    Consumers read :meth:`last_blocked`.
    """

    def __init__(
        self,
        threshold: float = 0.1,
        interval: float = 0.05,
        max_frames: int = 12,
    ):
        self.threshold = threshold
        self.interval = interval
        self.max_frames = max_frames
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread_id: Optional[int] = None
        self._beat = 0.0
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # newest capture: {"age_seconds", "frames", "captured_at"}
        self._last: Optional[dict] = None

    # -- lifecycle (call from the loop thread) -------------------------------

    def start(self, loop: Optional[asyncio.AbstractEventLoop] = None) -> None:
        if self._thread is not None:
            return
        self._loop = loop if loop is not None else asyncio.get_running_loop()
        self._loop_thread_id = threading.get_ident()
        self._beat = time.monotonic()
        self._loop.call_soon(self._heartbeat)
        self._thread = threading.Thread(
            target=self._sample_loop, name="asyncsan-attributor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None

    # -- loop side -----------------------------------------------------------

    def _heartbeat(self) -> None:
        self._beat = time.monotonic()
        if not self._stopped.is_set() and self._loop is not None:
            self._loop.call_later(self.interval, self._heartbeat)

    # -- sampler thread ------------------------------------------------------

    def _sample_loop(self) -> None:
        # ONE capture per stale episode, taken at the FIRST over-threshold
        # sample: that one runs mid-freeze and names the offender.  Later
        # samples of the same episode may land after the freeze ended but
        # before the delayed heartbeat drains (age still growing), and
        # would overwrite the evidence with whatever innocent callback the
        # loop is running by then.  Re-armed when the heartbeat recovers.
        in_episode = False
        while not self._stopped.wait(self.interval):
            age = time.monotonic() - self._beat
            if age <= self.threshold:
                in_episode = False
                continue
            if in_episode:
                continue
            frames = self._capture()
            if frames:
                in_episode = True
                self._last = {
                    "age_seconds": round(age, 4),
                    "frames": frames,
                    "captured_at": time.monotonic(),
                }

    def _capture(self) -> "list[str]":
        frame = sys._current_frames().get(self._loop_thread_id)
        if frame is None:
            return []
        # innermost first: the blocking call is the headline
        out = [
            f"{os.path.basename(fs.filename)}:{fs.lineno} in {fs.name}"
            for fs, _ in zip(
                traceback.extract_stack(frame)[::-1], range(self.max_frames)
            )
        ]
        del frame
        return out

    # -- consumer ------------------------------------------------------------

    def last_blocked(self, max_age: float = 120.0) -> Optional[dict]:
        """The newest capture no older than ``max_age`` seconds, as
        ``{"age_seconds", "frames"}`` (frames innermost-first) — or None.
        The watchdog merges this into its ``watchdog.stall`` event."""
        last = self._last
        if last is None:
            return None
        if time.monotonic() - last["captured_at"] > max_age:
            return None
        return {
            "age_seconds": last["age_seconds"],
            "frames": list(last["frames"]),
        }
