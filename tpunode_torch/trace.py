"""Tracing and profiling hooks: spans, and a profiler capture of the card.

* :class:`span` — a context manager that times a region into the metrics
  registry: durations land in the ``span.<name>`` histogram (p50/p90/p99
  via ``metrics.histogram("span.<name>").quantile``) plus the
  ``span.<name>.seconds`` / ``.count`` counters.  While a
  :func:`profile_to` capture is active it also enters a
  ``torch.profiler.record_function`` range, so the region shows up named
  on the trace's timeline beside the card's kernels and copies.
* :func:`profile_to` — a ``torch.profiler.profile`` over the CPU and (with
  a card) CUDA activities that writes a Chrome trace into a directory.

The verify path marks its stages ``verify.pack`` (the engine packing item
tuples into rows), ``verify.prepare``, ``verify.transfer``,
``verify.kernel`` and ``verify.readback``; the engine spans each batch as
``verify.dispatch``.

When a request-scoped trace is active (:mod:`tpunode_torch.tracectx`: one
per-block/tx pipeline trace), every span also lands as a child node in
that trace's tree, so the same instrumented regions feed both the
aggregate histograms and the causal per-item view.

Spans are cheap — a slotted context-manager class, two ``perf_counter``
calls, one ContextVar read and one locked registry update, with the
profiler range skipped outside an active capture — so they can wrap the
per-batch hot path (an entry and exit costs what the reference's span
does, pinned by tests/test_torch_support.py).  A disabled registry
(``metrics.disabled``) skips the metric timing entirely.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

from .metrics import metrics
from .tracectx import _ACTIVE as _active_trace

__all__ = ["span", "profile_to", "TRACE_FILE"]

#: The Chrome trace :func:`profile_to` writes into its directory.
TRACE_FILE = "trace.json"

# ``torch.profiler.record_function`` while a profile_to() capture runs,
# else None: spans skip the range outside a capture (entering one costs
# microseconds against the span budget, and records nothing unprofiled).
_record_function = None


# name -> ("span.<name>", "span.<name>.seconds", "span.<name>.count"):
# precomputed so the hot path allocates no strings per span entry.
_span_names: dict[str, tuple[str, str, str]] = {}


def _names(name: str) -> tuple[str, str, str]:
    keys = _span_names.get(name)
    if keys is None:
        keys = _span_names[name] = (
            f"span.{name}",
            f"span.{name}.seconds",
            f"span.{name}.count",
        )
    return keys


class span:
    """``with span("verify.dispatch"): ...`` — see module docstring."""

    __slots__ = ("_name", "_ann", "_t0", "_rec", "_tok")

    def __init__(self, name: str):
        self._name = name
        self._ann = None

    def __enter__(self) -> "span":
        # Active per-item trace (tracectx): record this region as a child
        # span and make it the parent of any nested spans.  One ContextVar
        # read on the no-trace fast path.
        act = _active_trace.get()
        if act is None:
            self._rec = None
        else:
            tr, parent = act
            self._rec = tr.begin(self._name, parent)
            self._tok = _active_trace.set((tr, self._rec.id))
        record_function = _record_function
        if record_function is not None:
            ann = record_function(self._name)
            ann.__enter__()
            self._ann = ann
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dt = time.perf_counter() - self._t0
        if not metrics.disabled:
            keys = _names(self._name)
            metrics.time_span(keys[0], keys[1], keys[2], dt)
        rec = self._rec
        if rec is not None:
            rec.dur = dt
            _active_trace.reset(self._tok)
            self._rec = None
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
            self._ann = None
        return False


@contextlib.contextmanager
def profile_to(directory: Optional[str]) -> Iterator[Optional[str]]:
    """Profile the block into ``directory`` (a no-op when None): a
    ``torch.profiler.profile`` of the CPU and, when a card is present, the
    CUDA activities, whose Chrome trace is written to
    ``<directory>/``:data:`TRACE_FILE` when the block ends.  Yields that
    path (None when not profiling).  Spans entered during the capture, on
    any thread, are ranges on its timeline."""
    global _record_function
    if not directory:
        yield None
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, TRACE_FILE)
    # every thread's ranges, the engine's dispatch threads' too (by
    # default the profiler records the thread that started it only)
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=activities, experimental_config=config) as prof:
        _record_function = torch.profiler.record_function
        try:
            yield path
        finally:
            _record_function = None
    prof.export_chrome_trace(path)
