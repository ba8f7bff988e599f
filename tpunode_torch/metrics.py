"""Telemetry registry: counters, gauges, histograms — labeled, thread-safe.

The reference exposes no metrics (SURVEY.md §5: logging only, RTT stats as
the lone performance signal); the benchmark harness, verify engine and the
network layers need real distributions — dispatch latency, batch occupancy,
per-peer RTT — because averages hide the tail that determines block-relay
latency.  This registry provides them process-wide with zero dependencies.

Conventions:

* metric names follow ``<layer>.<name>`` (``^[a-z]+(\\.[a-z_]+)+$``),
  enforced by a lint test (tests/test_metrics.py);
* histograms use fixed log-scaled buckets so ``observe()`` is O(log n
  buckets) and shapes never grow with traffic;
* every mutation takes one process-wide lock — the verify engine and
  asyncio executors mutate from worker threads;
* ``Metrics(disabled=True)`` records nothing (reads still work and
  report zeros/empties).
"""

from __future__ import annotations

import math
import threading
import time
import weakref
from bisect import bisect_left
from collections import deque
from typing import Callable, Iterable, Optional, Sequence

from . import threadsan

__all__ = [
    "DEFAULT_BUCKETS",
    "Histogram",
    "Metrics",
    "metrics",
    "percentiles",
]

# Log-scaled duration buckets: 1µs .. ~134s, ×2 per bucket (+overflow).
DEFAULT_BUCKETS: tuple[float, ...] = tuple(1e-6 * 2**i for i in range(28))

# Labels normalize to a sorted tuple of (key, value) pairs; the internal
# registry key is (name, label_tuple) with () meaning "unlabeled".
_LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: Optional[dict]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_key(name: str, lk: _LabelKey) -> str:
    if not lk:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in lk)
    return f"{name}{{{inner}}}"


def _weak_callable(fn):
    """A weak reference to ``fn`` suitable for callback lists: bound
    methods need WeakMethod (a plain ref to the transient bound-method
    object dies immediately)."""
    if hasattr(fn, "__self__"):
        return weakref.WeakMethod(fn)
    return weakref.ref(fn)


def percentiles(values: Sequence[float], ps: Iterable[float]) -> dict[str, float]:
    """Exact percentiles of a small sample (per-peer RTT lists): linear
    interpolation between order statistics; {} when empty."""
    if not values:
        return {}
    s = sorted(values)
    out = {}
    for p in ps:
        rank = p * (len(s) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(s) - 1)
        out[f"p{int(p * 100)}"] = s[lo] + (s[hi] - s[lo]) * (rank - lo)
    return out


class Histogram:
    """Fixed-bucket histogram with quantile estimation.

    Buckets are half-open ``(bounds[i-1], bounds[i]]`` plus an overflow
    bucket.  ``quantile`` returns the geometric midpoint of the target
    bucket clamped to the observed [min, max], so a single-sample (or
    single-valued) histogram reports the exact value.
    """

    __slots__ = ("bounds", "counts", "count", "total", "min", "max")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BUCKETS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        self.counts[bisect_left(self.bounds, value)] += 1
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def quantile(self, p: float) -> Optional[float]:
        """Estimate the p-quantile (p in [0, 1]); None when empty."""
        if self.count == 0:
            return None
        rank = max(1, math.ceil(p * self.count))
        cum = 0
        idx = len(self.counts) - 1
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                idx = i
                break
        lo = self.bounds[idx - 1] if idx > 0 else 0.0
        hi = self.bounds[idx] if idx < len(self.bounds) else self.max
        if lo > 0 and hi > 0:
            mid = math.sqrt(lo * hi)  # geometric: log-scaled buckets
        else:
            mid = (lo + hi) / 2.0
        return min(max(mid, self.min), self.max)

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def summary(self) -> dict:
        """Self-describing stats dict (the BENCH ``telemetry`` rows)."""
        out: dict = {"count": self.count}
        if self.count:
            out.update(
                sum=self.total,
                min=self.min,
                max=self.max,
                p50=self.quantile(0.50),
                p90=self.quantile(0.90),
                p99=self.quantile(0.99),
            )
        else:
            # same keys as the populated case: BENCH consumers diff these
            # rows across rounds and a schema flip would break them
            out.update(sum=0.0, min=None, max=None,
                       p50=None, p90=None, p99=None)
        return out

    def count_le(self, bound: float) -> int:
        """Observations ``<= bound`` — exact when ``bound`` is one of the
        bucket boundaries (the SLO evaluator picks its latency thresholds
        on boundaries for exactly this reason); otherwise the cumulative
        count up to the last boundary ``<= bound`` (a lower bound)."""
        if math.isinf(bound) and bound > 0:
            return self.count  # +Inf: everything, incl. the overflow bucket
        idx = bisect_left(self.bounds, bound)
        if idx < len(self.bounds) and self.bounds[idx] == bound:
            idx += 1
        return sum(self.counts[:idx])

    def bucket_counts(self) -> dict[str, int]:
        """Non-empty buckets keyed by upper bound (readable exposition)."""
        out = {}
        for i, c in enumerate(self.counts):
            if c:
                le = self.bounds[i] if i < len(self.bounds) else math.inf
                out[f"{le:.6g}"] = c
        return out


class _Counter:
    __slots__ = ("value", "updated", "samples")

    def __init__(self, now: float):
        self.value = 0.0
        self.updated = now
        # (monotonic, value) checkpoints for windowed rates, ≥1s apart;
        # seeded at 0 so the first window covers the counter's whole life.
        self.samples: deque[tuple[float, float]] = deque(maxlen=720)
        self.samples.append((now, 0.0))


# Minimum spacing between rate checkpoints (keeps inc() allocation-light).
_RATE_RESOLUTION = 1.0


class Metrics:
    """Process-wide registry.  All public methods are thread-safe."""

    def __init__(self, disabled: bool = False):
        self.disabled = disabled
        self._lock = threadsan.lock("metrics.registry")
        self._counters: dict[tuple[str, _LabelKey], _Counter] = {}
        self._gauges: dict[tuple[str, _LabelKey], float] = {}
        self._hists: dict[tuple[str, _LabelKey], Histogram] = {}
        # metric family -> help text (# HELP exposition lines); optional,
        # registered at first use via describe()
        self._help: dict[str, str] = {}
        # drop_label listeners:
        # weakly-referenced callables invoked OUTSIDE the lock with
        # (key, value) after an eviction, so downstream samplers (the
        # Timeline) retire the same series instead of re-growing them.
        # Weak refs: a churned Timeline must not be kept alive (or
        # called) by the process-global registry.
        self._drop_hooks: list = []
        self._created = time.monotonic()

    def describe(self, name: str, help_: str) -> None:
        """Register a one-line description for a metric family: rendered
        as a ``# HELP`` line by :meth:`render_prometheus`.  Idempotent —
        the first registration wins (call it where the family is first
        recorded).  Works even when recording is disabled (descriptions
        are metadata, not samples)."""
        with self._lock:
            self._help.setdefault(name, help_)

    # -- write path ----------------------------------------------------------

    def _inc_locked(
        self, key: tuple[str, _LabelKey], amount: float, now: float
    ) -> None:
        """Counter update + rate checkpointing; caller holds the lock."""
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = _Counter(now)
        c.value += amount
        c.updated = now
        if now - c.samples[-1][0] >= _RATE_RESOLUTION:
            c.samples.append((now, c.value))

    def inc(
        self, name: str, amount: float = 1.0, labels: Optional[dict] = None
    ) -> None:
        if self.disabled:
            return
        now = time.monotonic()
        with self._lock:
            self._inc_locked((name, _label_key(labels)), amount, now)

    def inc_batch(
        self, items: Iterable[tuple[str, float, Optional[dict]]]
    ) -> None:
        """Increment several counters under ONE lock acquisition — the
        per-message hot-loop form (see trace.span's time_span for the
        same pattern): ``items`` is (name, amount, labels-or-None)."""
        if self.disabled:
            return
        now = time.monotonic()
        with self._lock:
            for name, amount, labels in items:
                self._inc_locked((name, _label_key(labels)), amount, now)

    def set_gauge(
        self, name: str, value: float, labels: Optional[dict] = None
    ) -> None:
        if self.disabled:
            return
        with self._lock:
            self._gauges[(name, _label_key(labels))] = value

    def observe(
        self,
        name: str,
        value: float,
        labels: Optional[dict] = None,
        buckets: Optional[Sequence[float]] = None,
    ) -> None:
        """Record ``value`` into the named histogram (created on first use;
        ``buckets`` overrides the default log-scaled bounds then)."""
        if self.disabled:
            return
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram(
                    buckets if buckets is not None else DEFAULT_BUCKETS
                )
            h.observe(value)

    def time_span(self, hist_name: str, seconds_name: str, count_name: str,
                  dt: float) -> None:
        """One-lock fast path for trace.span: histogram observe + the two
        legacy counters (``span.<name>.seconds`` / ``.count``)."""
        if self.disabled:
            return
        now = time.monotonic()
        with self._lock:
            h = self._hists.get((hist_name, ()))
            if h is None:
                h = self._hists[(hist_name, ())] = Histogram()
            h.observe(dt)
            self._inc_locked((seconds_name, ()), dt, now)
            self._inc_locked((count_name, ()), 1.0, now)

    def on_drop(self, hook: Callable[[str, str], None]) -> None:
        """Register a ``(key, value)`` callback fired after every
        :meth:`drop_label` eviction.  Held by WEAK reference — callers
        must keep the callable alive (a bound method of a live object
        does); dead refs are pruned on the next drop."""
        with self._lock:
            self._drop_hooks.append(_weak_callable(hook))

    def drop_label(self, key: str, value: str) -> None:
        """Evict every labeled series carrying ``key=value`` (all names).

        Per-peer labeled series (``peer.msgs{peer=...}``, ``peer.rtt``)
        would otherwise grow the registry without bound on a long-running
        node churning through addresses; the peer manager calls this when
        a session ends — and the verify engine retires its fleet's
        ``host=`` series at teardown.  Unlabeled aggregates
        are untouched.  Registered :meth:`on_drop` hooks fire after the
        eviction, outside the lock."""
        pair = (str(key), str(value))
        with self._lock:
            for table in (self._counters, self._gauges, self._hists):
                for k in [k for k in table if pair in k[1]]:
                    del table[k]
            hooks = list(self._drop_hooks)
        live = []
        for ref in hooks:
            fn = ref()
            if fn is None:
                continue
            live.append(ref)
            fn(pair[0], pair[1])
        if len(live) != len(hooks):
            with self._lock:
                self._drop_hooks = [
                    r for r in self._drop_hooks if r() is not None
                ]

    # -- read path -----------------------------------------------------------

    def get(self, name: str, labels: Optional[dict] = None) -> float:
        key = (name, _label_key(labels))
        with self._lock:
            if key in self._gauges:
                return self._gauges[key]
            c = self._counters.get(key)
            return c.value if c is not None else 0.0

    def histogram(
        self, name: str, labels: Optional[dict] = None
    ) -> Optional[Histogram]:
        return self._hists.get((name, _label_key(labels)))

    def series(self, name: str) -> dict[_LabelKey, float]:
        """All labeled values of one counter/gauge name (round-trippable:
        keys are the normalized (key, value) tuples)."""
        out: dict[_LabelKey, float] = {}
        with self._lock:
            for (n, lk), c in self._counters.items():
                if n == name:
                    out[lk] = c.value
            for (n, lk), v in self._gauges.items():
                if n == name:
                    out[lk] = v
        return out

    def rate(self, name: str, window: float = 60.0,
             labels: Optional[dict] = None) -> float:
        """Windowed rate (per second) of a counter over roughly the last
        ``window`` seconds (accurate to the ~1s checkpoint resolution).
        The old since-process-start behavior — which understates rates
        after any idle period — is ``lifetime_rate``."""
        now = time.monotonic()
        with self._lock:
            c = self._counters.get((name, _label_key(labels)))
            if c is None:
                return 0.0
            cutoff = now - window
            if c.updated <= cutoff:
                return 0.0  # idle for the whole window
            base_t, base_v = c.samples[0]
            for t, v in c.samples:
                if t > cutoff:
                    break
                base_t, base_v = t, v
            if base_t <= cutoff:
                # baseline value stands in for the value AT the cutoff
                # (no checkpoint landed between them), so the window is
                # the true denominator — an idle gap before the cutoff
                # must not dilute the current rate
                dt = window
            else:
                # counter younger than the window: rate over its life,
                # floored at the checkpoint resolution so a counter
                # microseconds old cannot report an absurd spike
                dt = max(_RATE_RESOLUTION, now - base_t)
            return (c.value - base_v) / dt

    def lifetime_rate(self, name: str, labels: Optional[dict] = None) -> float:
        """Average rate of a counter since process start (per second)."""
        with self._lock:
            c = self._counters.get((name, _label_key(labels)))
            if c is None or c.value == 0:
                return 0.0
            elapsed = max(1e-9, time.monotonic() - self._created)
            return c.value / elapsed

    def snapshot(self) -> dict[str, float]:
        """Flat counters+gauges dict; labeled series render as
        ``name{k="v",...}`` keys."""
        with self._lock:
            out = {_render_key(n, lk): c.value for (n, lk), c in self._counters.items()}
            out.update(
                {_render_key(n, lk): v for (n, lk), v in self._gauges.items()}
            )
        return out

    def histograms(self) -> dict[str, Histogram]:
        with self._lock:
            return {_render_key(n, lk): h for (n, lk), h in self._hists.items()}

    def flat_sample(self) -> dict[str, float]:
        """One-lock flat sample for the timeline sampler
        (tpunode/timeseries.py): counters + gauges (like :meth:`snapshot`)
        plus each histogram's ``<name>.count``/``<name>.sum`` — the two
        histogram moments that are meaningful as time series (windowed
        deltas give rate and mean; per-bucket rings would be cardinality
        × buckets for no query anyone asks).  A span histogram's
        ``.count`` collides with its legacy shadow counter of the same
        name — they track the same quantity, so the overwrite is a
        no-op."""
        with self._lock:
            out = {
                _render_key(n, lk): c.value
                for (n, lk), c in self._counters.items()
            }
            out.update(
                {_render_key(n, lk): v for (n, lk), v in self._gauges.items()}
            )
            for (n, lk), h in self._hists.items():
                key = _render_key(n, lk)
                out[key + ".count"] = float(h.count)
                out[key + ".sum"] = h.total
        return out

    def render_prometheus(self, prefix: str = "tpunode_") -> str:
        """Prometheus text exposition format (0.0.4).

        The legacy ``span.<name>.seconds``/``.count`` counters are skipped:
        the ``span.<name>`` histogram already exposes ``_sum``/``_count``
        series, and rendering both would emit duplicate sample names
        (``..._count`` twice), which Prometheus rejects."""

        def pname(name: str) -> str:
            return prefix + name.replace(".", "_").replace("-", "_")

        def fmt(v: float) -> str:
            # repr: shortest round-trip text — %g's 6 significant digits
            # would quantize large byte/msg counters between scrapes
            return repr(float(v))

        def is_span_shadow(name: str) -> bool:
            return name.startswith("span.") and (
                name.endswith(".seconds") or name.endswith(".count")
            )

        def esc(v: str) -> str:
            # exposition-format 0.0.4 label-value escaping: backslash,
            # double-quote AND newline (peer addresses and error strings
            # are attacker-influenced; a raw newline would let one forge
            # arbitrary exposition lines)
            return (
                v.replace("\\", "\\\\")
                .replace('"', '\\"')
                .replace("\n", "\\n")
            )

        def plabels(lk: _LabelKey, extra: str = "") -> str:
            parts = [f'{k}="{esc(v)}"' for k, v in lk]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = dict(self._gauges)
            hists = dict(self._hists)
            helps = dict(self._help)
        lines: list[str] = []
        typed: set[str] = set()

        def emit_type(name: str, kind: str) -> None:
            if name not in typed:
                typed.add(name)
                help_ = helps.get(name)
                if help_ is not None:
                    # HELP escaping (0.0.4): backslash and newline only
                    text = help_.replace("\\", "\\\\").replace("\n", "\\n")
                    lines.append(f"# HELP {pname(name)} {text}")
                lines.append(f"# TYPE {pname(name)} {kind}")

        for (name, lk), value in sorted(counters.items()):
            if is_span_shadow(name):
                continue
            emit_type(name, "counter")
            lines.append(f"{pname(name)}{plabels(lk)} {fmt(value)}")
        for (name, lk), value in sorted(gauges.items()):
            emit_type(name, "gauge")
            lines.append(f"{pname(name)}{plabels(lk)} {fmt(value)}")
        for (name, lk), h in sorted(hists.items()):
            emit_type(name, "histogram")
            cum = 0
            for i, c in enumerate(h.counts):
                cum += c
                le = (
                    f"{h.bounds[i]:.9g}" if i < len(h.bounds) else "+Inf"
                )
                le_label = 'le="%s"' % le
                lines.append(
                    f"{pname(name)}_bucket{plabels(lk, le_label)} {cum}"
                )
            lines.append(f"{pname(name)}_sum{plabels(lk)} {fmt(h.total)}")
            lines.append(f"{pname(name)}_count{plabels(lk)} {h.count}")
        return "\n".join(lines) + "\n"

    def telemetry(self) -> dict:
        """The BENCH JSON ``telemetry`` section: span percentiles, the
        batch-occupancy histogram, and structured-event counts.  The
        ``verify.dispatch`` and ``verify.occupancy`` rows are always
        present (empty = count 0) so the artifact shape is stable."""
        with self._lock:
            hists = {_render_key(n, lk): h for (n, lk), h in self._hists.items()}
        spans = {
            name[len("span."):]: h.summary()
            for name, h in hists.items()
            if name.startswith("span.") and "{" not in name
        }
        spans.setdefault("verify.dispatch", Histogram().summary())
        occ = hists.get("verify.occupancy") or Histogram()
        out = {
            "spans": spans,
            "occupancy": dict(occ.summary(), buckets=occ.bucket_counts()),
        }
        try:  # events is a sibling module; avoid a hard import cycle
            from .events import events

            out["events"] = events.counts()
        except Exception:
            out["events"] = {}
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._created = time.monotonic()


# Process-wide registry (tests may construct their own).
metrics = Metrics()
