"""secp256k1 group operations: complete projective formulas in plain PyTorch.

Points are projective ``(X : Y : Z)`` triples stored as one ``(3, 24, B)``
int32 tensor, limb-major like :mod:`.field`; infinity is ``(0 : 1 : 0)``.
The Renes–Costello–Batina complete formulas for a = 0 (RCB'16 Algorithms
7, 8 and 9, b3 = 3·7 = 21) are branch-free and correct for every input
pair, infinity and P = ±Q included; the mixed addition's second operand is
an affine ``(2, 24, B)`` pair, which cannot be infinity.

The bodies are the reference's (``tpunode/verify/curve.py``) op for op,
behind the same ``F=`` namespace seam: the torch field runs them here, and
:mod:`.bounds` replays them over per-limb magnitude bounds to prove int32
headroom.  ``csrc/curve.cuh`` is the device transcription of the lazy
bodies, with the same schedule.
"""

from __future__ import annotations

import torch

from . import field as _field

__all__ = [
    "B3",
    "INFINITY",
    "POINT_FORMS",
    "point_form",
    "check_point_form",
    "make_point",
    "infinity",
    "pt_add",
    "pt_add_mixed",
    "pt_double",
    "pt_select",
]

B3 = 21  # 3 * b for y^2 = x^3 + 7


# The window tables' point form (the reference's curve.POINT_FORMS):
# "projective" tables of 3 coordinates and complete adds, or "affine" tables
# of 2 coordinates, normalised by one batch inversion a lane, and mixed adds.
POINT_FORMS = ("projective", "affine")


def point_form() -> str:
    """The point form the ``TPUNODE_POINT_FORM`` knob asks for: either
    runs; a value outside :data:`POINT_FORMS` raises ValueError."""
    return _field.env_mode("TPUNODE_POINT_FORM", POINT_FORMS, "projective", "1a",
                           runs=POINT_FORMS)


def check_point_form(form: str) -> str:
    """``form`` if it is one of :data:`POINT_FORMS`, else ValueError."""
    if form not in POINT_FORMS:
        raise ValueError(f"point form {form!r} not in {POINT_FORMS}")
    return form


def make_point(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return torch.stack([x, y, z], dim=0)


def _mk(F_ns):
    """The namespace's own point constructor when it has one (the bound
    tracker builds plain lists), :func:`make_point` otherwise."""
    return getattr(F_ns, "make_point", make_point)


INFINITY = make_point(_field.ZERO, _field.ONE, _field.ZERO)  # (3, 24, 1)


def infinity(b: int, device) -> torch.Tensor:
    """Infinity broadcast to ``b`` lanes on ``device``: (3, 24, b)."""
    return INFINITY.to(device).expand(3, _field.NLIMBS, b).contiguous()


def pt_select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``mask ? a : b`` over whole points; mask (B,) broadcasts."""
    return torch.where(mask, a, b)


def pt_add(p, q, F=_field, reduce=None):
    """Complete addition (RCB'16 Algorithm 7, a = 0): 12 muls.  ``reduce``
    pins the reduction discipline ("eager"/"lazy"); None reads
    :func:`field.reduce_mode` (the lazy default)."""
    if (reduce or _field.reduce_mode()) == "lazy":
        return _pt_add_lazy(p, q, F)
    X1, Y1, Z1 = p[0], p[1], p[2]
    X2, Y2, Z2 = q[0], q[1], q[2]
    mul = F.mul

    t0 = F.mul_t(X1, X2)
    t1 = F.mul_t(Y1, Y2)
    t2 = F.mul_t(Z1, Z2)
    t3 = mul(X1 + Y1, X2 + Y2)
    t3 = t3 - (t0 + t1)
    t4 = mul(Y1 + Z1, Y2 + Z2)
    t4 = t4 - (t1 + t2)
    t5 = mul(X1 + Z1, X2 + Z2)
    t5 = t5 - (t0 + t2)  # = X1*Z2 + X2*Z1
    t0_3 = t0 + t0 + t0  # 3*X1*X2
    t2_b3 = F.mul_small_red(t2, B3)
    z3 = t1 + t2_b3
    t1m = t1 - t2_b3
    y3 = F.mul_small_red(t5, B3)
    x3 = mul(t4, y3)
    t2b = mul(t3, t1m)
    x3 = t2b - x3
    y3 = mul(y3, t0_3)
    t1b = mul(t1m, z3)
    y3 = t1b + y3
    t0b = mul(t0_3, t3)
    z3 = mul(z3, t4)
    z3 = z3 + t0b
    return _mk(F)(x3, y3, z3)


def _pt_add_lazy(p, q, F=_field):
    """The lazy-reduction body of :func:`pt_add`: each output coordinate
    accumulates unreduced wides and pays one loose reduction, and shared
    tail operands get one hoisted carry round each."""
    X1, Y1, Z1 = p[0], p[1], p[2]
    X2, Y2, Z2 = q[0], q[1], q[2]
    rw = F.reduce_wide_loose

    t0 = rw(F.mul_t_wide(X1, X2))
    t1 = rw(F.mul_t_wide(Y1, Y2))
    t2 = rw(F.mul_t_wide(Z1, Z2))
    t3 = rw(F.mul_wide(X1 + Y1, X2 + Y2))
    t3 = t3 - (t0 + t1)  # = X1*Y2 + X2*Y1
    t4 = rw(F.mul_wide(Y1 + Z1, Y2 + Z2))
    t4 = t4 - (t1 + t2)
    t5 = rw(F.mul_wide(X1 + Z1, X2 + Z2))
    t5 = t5 - (t0 + t2)  # = X1*Z2 + X2*Z1
    t2_b3 = F.mul_small_red(t2, B3)
    t3 = F.tighten(t3)
    t4 = F.tighten(t4)
    t0_3 = F.tighten(t0 + t0 + t0)  # 3*X1*X2
    z3s = F.tighten(t1 + t2_b3)
    t1m = F.tighten(t1 - t2_b3)
    y3r = F.tighten(F.mul_small_red(t5, B3))  # b3*(X1*Z2 + X2*Z1)
    x3 = rw(F.mul_t_wide(t3, t1m) - F.mul_t_wide(t4, y3r))
    y3 = rw(F.acc_add(F.mul_t_wide(t1m, z3s), F.mul_t_wide(y3r, t0_3)))
    z3 = rw(F.acc_add(F.mul_t_wide(z3s, t4), F.mul_t_wide(t0_3, t3)))
    return _mk(F)(x3, y3, z3)


def pt_add_mixed(p, q, F=_field, reduce=None):
    """Complete mixed addition (RCB'16 Algorithm 8, a = 0): 11 muls, one
    fewer than :func:`pt_add`, because ``q`` is an affine ``(x2, y2)`` pair
    with Z2 = 1.  Complete in ``p``; ``q`` cannot be infinity, so the window
    loop keeps the accumulator for digit 0 instead of adding.  Limb
    contract: p's coordinates <= 2^13, q's <= 2^12 (mul outputs or
    canonical constants, possibly negated).  ``reduce`` as in
    :func:`pt_add`."""
    if (reduce or _field.reduce_mode()) == "lazy":
        return _pt_add_mixed_lazy(p, q, F)
    X1, Y1, Z1 = p[0], p[1], p[2]
    x2, y2 = q[0], q[1]
    mul = F.mul

    t0 = F.mul_t(X1, x2)
    t1 = F.mul_t(Y1, y2)
    t3 = mul(X1 + Y1, x2 + y2)
    t3 = t3 - (t0 + t1)  # = X1*y2 + x2*Y1
    t4 = F.mul_t(y2, Z1)
    t4 = t4 + Y1  # = Y1*Z2 + Y2*Z1 with Z2 = 1
    t5 = F.mul_t(x2, Z1)
    t5 = t5 + X1  # = X1*Z2 + X2*Z1 with Z2 = 1
    t0_3 = t0 + t0 + t0  # 3*X1*X2
    t2_b3 = F.mul_small_red(Z1, B3)  # b3*Z1*Z2 with Z2 = 1
    z3 = t1 + t2_b3
    t1m = t1 - t2_b3
    y3 = F.mul_small_red(t5, B3)
    x3 = mul(t4, y3)
    t2b = mul(t3, t1m)
    x3 = t2b - x3
    y3 = mul(y3, t0_3)
    t1b = mul(t1m, z3)
    y3 = t1b + y3
    t0b = mul(t0_3, t3)
    z3 = mul(z3, t4)
    z3 = z3 + t0b
    return _mk(F)(x3, y3, z3)


def _pt_add_mixed_lazy(p, q, F=_field):
    """The lazy-reduction body of :func:`pt_add_mixed`: the levers of
    :func:`_pt_add_lazy` over the mixed-add algebra (Z2 = 1)."""
    X1, Y1, Z1 = p[0], p[1], p[2]
    x2, y2 = q[0], q[1]
    rw = F.reduce_wide_loose

    t0 = rw(F.mul_t_wide(X1, x2))
    t1 = rw(F.mul_t_wide(Y1, y2))
    t3 = rw(F.mul_wide(X1 + Y1, x2 + y2))
    t3 = t3 - (t0 + t1)  # = X1*y2 + x2*Y1
    t4 = rw(F.mul_t_wide(y2, Z1))
    t4 = t4 + Y1  # = Y1*Z2 + Y2*Z1 with Z2 = 1
    t5 = rw(F.mul_t_wide(x2, Z1))
    t5 = t5 + X1  # = X1*Z2 + X2*Z1 with Z2 = 1
    t2_b3 = F.mul_small_red(Z1, B3)  # b3*Z1*Z2 with Z2 = 1
    t3 = F.tighten(t3)
    t4 = F.tighten(t4)
    t0_3 = F.tighten(t0 + t0 + t0)  # 3*X1*X2
    z3s = F.tighten(t1 + t2_b3)
    t1m = F.tighten(t1 - t2_b3)
    y3r = F.tighten(F.mul_small_red(t5, B3))
    x3 = rw(F.mul_t_wide(t3, t1m) - F.mul_t_wide(t4, y3r))
    y3 = rw(F.acc_add(F.mul_t_wide(t1m, z3s), F.mul_t_wide(y3r, t0_3)))
    z3 = rw(F.acc_add(F.mul_t_wide(z3s, t4), F.mul_t_wide(t0_3, t3)))
    return _mk(F)(x3, y3, z3)


def pt_double(p, F=_field, reduce=None):
    """Complete doubling (RCB'16 Algorithm 9, a = 0): 6 muls + 2 squarings.
    ``reduce`` as in :func:`pt_add`."""
    if (reduce or _field.reduce_mode()) == "lazy":
        return _pt_double_lazy(p, F)
    X, Y, Z = p[0], p[1], p[2]
    mul = F.mul

    t0 = F.sqr_t(Y)
    z3 = t0 * 8  # 8Y^2
    t1 = F.mul_t(Y, Z)
    t2 = F.sqr_t(Z)
    t2 = F.mul_small_red(t2, B3)  # b3*Z^2
    x3 = mul(t2, z3)
    y3 = t0 + t2
    z3 = mul(t1, z3)
    t2_3 = t2 + t2 + t2  # 3*b3*Z^2
    t0 = t0 - t2_3
    y3 = mul(t0, y3)
    y3 = x3 + y3
    t1 = F.mul_t(X, Y)
    x3 = mul(t0, t1)
    x3 = x3 + x3
    return _mk(F)(x3, y3, z3)


def _pt_double_lazy(p, F=_field):
    """The lazy-reduction body of :func:`pt_double`: b3·Z²·8Y² fuses into
    y3's accumulation, and 8Y², b3·Z² and t0 - 3·t2 each get one hoisted
    carry round."""
    X, Y, Z = p[0], p[1], p[2]
    rw = F.reduce_wide_loose

    t0 = rw(F.sqr_t_wide(Y))
    z8 = F.tighten(t0 * 8)  # 8Y^2
    t1 = rw(F.mul_t_wide(Y, Z))
    t2 = F.tighten(F.mul_small_red(rw(F.sqr_t_wide(Z)), B3))  # b3*Z^2
    y3s = t0 + t2
    t0m = F.tighten(t0 - (t2 + t2 + t2))
    z3 = rw(F.mul_t_wide(t1, z8))
    y3 = rw(F.acc_add(F.mul_t_wide(t2, z8), F.mul_t_wide(t0m, y3s)))
    t1b = rw(F.mul_t_wide(X, Y))
    x3 = rw(F.mul_t_wide(t0m, t1b))
    x3 = x3 + x3
    return _mk(F)(x3, y3, z3)
