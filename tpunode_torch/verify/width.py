"""The verify program's window widths: the one Python definition of them.

GLV half-scalars are below ~2^129 (2^135 at the 5-bit range check), so
33 windows of 4 bits or 27 of 5 bits cover them.  The host prep (Python
and native), the plain program and the CUDA launcher all take the width
from here; ``csrc/verify_kernel.cu``'s ``WINDOWS<WB>`` mirrors the map.
"""

from __future__ import annotations

import os

__all__ = ["WINDOW_BITS", "WINDOWS_BY_BITS", "window_bits", "windows"]

WINDOW_BITS = 4  # the default width
WINDOWS_BY_BITS = {4: 33, 5: 27}  # width -> digit rows (window rounds)


def window_bits() -> int:
    """The width the ``TPUNODE_WINDOW_BITS`` knob asks for: 4 (unset) or
    5.  Any other value raises ValueError; it never runs the default."""
    v = os.environ.get("TPUNODE_WINDOW_BITS", "").strip()
    if not v:
        return WINDOW_BITS
    if v not in ("4", "5"):
        raise ValueError(f"TPUNODE_WINDOW_BITS={v!r} not in ('4', '5')")
    return int(v)


def windows(wb: int) -> int:
    """Window rounds at width ``wb``; raises ValueError unless it is 4 or 5."""
    if wb not in WINDOWS_BY_BITS:
        raise ValueError(f"window_bits {wb!r} not in {tuple(WINDOWS_BY_BITS)}")
    return WINDOWS_BY_BITS[wb]
