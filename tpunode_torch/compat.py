"""Runtime compatibility shims.

``asyncio.timeout`` landed in Python 3.11 but the library (actors
``receive_match``, peer ``get_data``/``ping_peer``) and the test suite are
written against it; on a 3.10 interpreter every code path that reaches it
died with ``AttributeError`` (the seed suite's largest failure class).
:func:`timeout` is a faithful-enough backport: it schedules a
``call_later`` that cancels the owning task, and converts the resulting
``CancelledError`` into the builtin ``TimeoutError`` (the 3.11 behavior)
at scope exit.  On 3.11+ it IS ``asyncio.timeout``.

Known divergences from the 3.11 original (acceptable for these uses):
no ``reschedule()``, and the task's cancellation counter is not unwound
(``Task.uncancel`` does not exist on 3.10), so an outer scope that
*also* cancelled the task exactly while the timer fired would see
TimeoutError rather than CancelledError.

:func:`install_asyncio_timeout` patches the shim into the ``asyncio``
namespace so test files written against 3.11 run unchanged on 3.10
(done by tests/conftest.py; library code imports :func:`timeout`
directly and never patches anything at import time).
"""

from __future__ import annotations

import asyncio
from typing import Optional

__all__ = ["timeout", "install_asyncio_timeout"]


if hasattr(asyncio, "timeout"):  # Python >= 3.11
    timeout = asyncio.timeout
else:

    class _Timeout:
        __slots__ = ("_delay", "_task", "_handle", "_expired")

        def __init__(self, delay: Optional[float]):
            self._delay = delay
            self._task: Optional[asyncio.Task] = None
            self._handle = None
            self._expired = False

        async def __aenter__(self) -> "_Timeout":
            self._task = asyncio.current_task()
            if self._delay is not None:
                self._handle = asyncio.get_running_loop().call_later(
                    self._delay, self._on_timeout
                )
            return self

        def _on_timeout(self) -> None:
            # Fires only at an await point inside the scope (single
            # threaded loop), so the cancellation always lands in-scope.
            self._expired = True
            if self._task is not None:
                self._task.cancel()

        async def __aexit__(self, exc_type, exc, tb) -> bool:
            if self._handle is not None:
                self._handle.cancel()
                self._handle = None
            if self._expired and exc_type is asyncio.CancelledError:
                raise TimeoutError() from exc
            return False

    def timeout(delay: Optional[float]) -> "_Timeout":
        """Backport of :func:`asyncio.timeout` (see module docstring)."""
        return _Timeout(delay)


def install_asyncio_timeout() -> None:
    """Make ``asyncio.timeout`` exist on 3.10 (idempotent; no-op on 3.11+)."""
    if not hasattr(asyncio, "timeout"):
        asyncio.timeout = timeout
