"""Named spans over ``torch.profiler.record_function``.

The verify path marks its stages with the reference's span names
(``verify.prepare``, ``verify.transfer``, ``verify.kernel``,
``verify.readback``) so a ``torch.profiler`` trace of the port reads like
the reference's device timeline, plus ``verify.pack``: the engine packing
item tuples into rows, which the reference's engine does not span.  With no
profiler active a span costs one ``record_function`` enter/exit.
"""

from __future__ import annotations

import torch

__all__ = ["span"]


def span(name: str) -> torch.profiler.record_function:
    """``with span("verify.kernel"): ...`` — a profiler range named ``name``."""
    return torch.profiler.record_function(name)
