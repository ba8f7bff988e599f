"""secp256k1 field arithmetic in plain PyTorch: the kernel's plain version.

The same representation and op schedule as the reference field
(``tpunode/verify/field.py``): an element is NLIMBS=24 limbs of RADIX=11
bits in int32, **limb-major** — a batch has shape ``(24, B)``, limb axis 0,
batch axis minor.  Limbs may be loose and negative between operations:
two's-complement ``& MASK`` and arithmetic ``>> RADIX`` keep every carry
round exact, and the top limb keeps its overflow in place.

Every function computes the exact limb vectors the reference computes (not
merely equal mod p) — the CPU tests hold them limb for limb — and the CUDA
kernel's ``csrc/field.cuh`` runs the same carry/fold schedule, so the one
int32 headroom replay in :mod:`.bounds` covers all three.

Only the reference's default formulation is ported: shift-add products,
the half-product square and lazy reduction.  :func:`field_modes` reads the
reference's environment knobs: a value that names no mode raises
ValueError, another of the reference's modes NotImplementedError.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

__all__ = [
    "RADIX",
    "NLIMBS",
    "MASK",
    "P",
    "N",
    "FOLD",
    "ZERO",
    "ONE",
    "to_limbs",
    "from_limbs",
    "MUL_MODES",
    "SQR_MODES",
    "REDUCE_MODES",
    "env_mode",
    "field_modes",
    "reduce_mode",
    "mul",
    "mul_t",
    "sqr",
    "sqr_t",
    "mul_small_red",
    "mul_wide",
    "mul_t_wide",
    "sqr_wide",
    "sqr_t_wide",
    "acc_add",
    "reduce_wide",
    "reduce_wide_loose",
    "tighten",
    "canonical",
    "is_zero",
    "eq",
    "select",
]

RADIX = 11
NLIMBS = 24
MASK = (1 << RADIX) - 1
TOTAL_BITS = RADIX * NLIMBS  # 264

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141

_FN = 4  # limb count of the fold constant


def _limbs_list(v: int, n: int) -> list[int]:
    return [(v >> (RADIX * i)) & MASK for i in range(n)]


def to_limbs(v: int, n: int = NLIMBS) -> np.ndarray:
    """Host: Python int -> little-endian limb vector (int32), shape (n,)."""
    return np.array(_limbs_list(v, n), dtype=np.int32)


def from_limbs(limbs) -> int:
    """Host: limb vector (loose/negative limbs fine) -> Python int.  Takes a
    tensor or array of shape (L,) or (L, 1); the limb axis is axis 0."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    out = 0
    for i, v in enumerate(np.asarray(limbs).reshape(-1).tolist()):
        out += int(v) << (RADIX * i)
    return out


FOLD = _limbs_list((1 << TOTAL_BITS) % P, _FN)  # 2^264 mod p = 256*(2^32+977)
C_LIMBS = _limbs_list((1 << 256) % P, _FN)  # 2^256 mod p = 2^32 + 977
P_LIMBS = _limbs_list(P, NLIMBS)
# A multiple of p added before canonicalizing so negative values turn
# positive: loose values are bounded by |v| < 2^266.
_BIG_LIMBS = _limbs_list(((1 << 267) // P + 1) * P, NLIMBS + 1)

ZERO = torch.zeros((NLIMBS, 1), dtype=torch.int32)
ONE = torch.zeros((NLIMBS, 1), dtype=torch.int32)
ONE[0] = 1


# ---------- mode knobs: the reference's names and values ------------------
# The reference's allowed tuples (tpunode/verify/field.py, curve.py,
# kernel.py), copied: a value outside its tuple names no mode.

MUL_MODES = ("shift_add", "dot_general")
SQR_MODES = ("half", "mul")
REDUCE_MODES = ("eager", "lazy")


def env_mode(var: str, allowed: tuple, default: str, roadmap_item: str,
             runs: tuple = ()) -> str:
    """The value of the reference's mode knob ``var``: ``default`` when
    unset, else the value itself if the port runs it (``default`` and
    ``runs``).  A value outside the reference's ``allowed`` tuple raises
    ValueError, as the reference does; one of the reference's other modes
    raises NotImplementedError naming the ROADMAP item that ports it.
    Never a silent run of the default."""
    v = os.environ.get(var, "").strip().lower()
    if not v:
        return default
    if v not in allowed:
        raise ValueError(f"{var}={v!r} not in {allowed}")
    if v != default and v not in runs:
        raise NotImplementedError(
            f"{var}={v!r}: tpunode_torch does not run it yet; "
            f"ROADMAP.md port queue item {roadmap_item} ports it"
        )
    return v


def field_modes() -> tuple:
    """(mul, sqr, reduce) formulation: the reference's defaults, the only
    ones ported."""
    return (
        env_mode("TPUNODE_FIELD_MUL", MUL_MODES, "shift_add", "1f-ii"),
        env_mode("TPUNODE_FIELD_SQR", SQR_MODES, "half", "1f-i"),
        env_mode("TPUNODE_FIELD_REDUCE", REDUCE_MODES, "lazy", "1c"),
    )


def reduce_mode() -> str:
    return field_modes()[2]


# ---------- limb products ---------------------------------------------------

_PAIRS = {
    "mul": [(i, j) for i in range(NLIMBS) for j in range(NLIMBS)],
    "sqr": [(i, j) for i in range(NLIMBS) for j in range(i, NLIMBS)],
}
_COLS = {"p": P_LIMBS, "big": _BIG_LIMBS}


@functools.lru_cache(maxsize=None)
def _col(name: str, device: torch.device) -> torch.Tensor:
    """Constant limb column ``(L, 1)`` on ``device``, made once."""
    return torch.tensor(_COLS[name], dtype=torch.int32, device=device)[:, None]


@functools.lru_cache(maxsize=None)
def _index(kind: str, device: torch.device) -> tuple:
    """(i rows, j rows, i + j positions, weights) of a pair table."""
    pairs = _PAIRS[kind]
    i = torch.tensor([a for a, _ in pairs], dtype=torch.long, device=device)
    j = torch.tensor([b for _, b in pairs], dtype=torch.long, device=device)
    w = torch.tensor([1 if a == b else 2 for a, b in pairs],
                     dtype=torch.int32, device=device)[:, None]
    return i, j, i + j, w


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Limb convolution (24, B) x (24, B) -> (47, B): the 576 partial
    products summed along anti-diagonals (the reference's shift-add sums,
    so every output limb is the same int32 value)."""
    _, _, pos, _ = _index("mul", a.device)
    prod = a[:, None] * b[None, :]
    prod = prod.reshape((NLIMBS * NLIMBS,) + prod.shape[2:])
    out = a.new_zeros((2 * NLIMBS - 1,) + prod.shape[1:])
    return out.index_add_(0, pos, prod)


def _sqr_conv(a: torch.Tensor) -> torch.Tensor:
    """Half-product square: out[i+j] += (2-δij)·a_i·a_j over i <= j, 300
    partial products; per-position sums equal ``_conv(a, a)``'s."""
    i, j, pos, w = _index("sqr", a.device)
    prod = a[i] * (a[j] * w)
    out = a.new_zeros((2 * NLIMBS - 1,) + a.shape[1:])
    return out.index_add_(0, pos, prod)


def _carry(x: torch.Tensor, rounds: int) -> torch.Tensor:
    """Carry-save rounds.  Exact for negative limbs (arithmetic shift), and
    the top limb keeps its overflow in place — no value is ever dropped."""
    for _ in range(rounds):
        hi = x >> RADIX
        y = x & MASK
        y[1:] += hi[:-1]
        y[-1] += hi[-1] * (1 << RADIX)
        x = y
    return x


def _pad(x: torch.Tensor, n: int) -> torch.Tensor:
    """A new tensor: ``x`` with ``n`` zero limbs appended."""
    return torch.cat([x, x.new_zeros((n,) + x.shape[1:])], dim=0)


def tighten(x: torch.Tensor, rounds: int = 1) -> torch.Tensor:
    return _carry(x, rounds)


def _fold_once(wide: torch.Tensor) -> torch.Tensor:
    """Fold limbs >= NLIMBS back via 2^264 ≡ FOLD (mod p)."""
    hi = wide[NLIMBS:]
    k = hi.shape[0]
    out = _pad(wide[:NLIMBS], max(0, k + _FN - 1 - NLIMBS))
    for i in range(_FN):
        out[i : i + k] += FOLD[i] * hi
    if out.shape[0] > NLIMBS:
        return _fold_once(_carry(_pad(out, 1), 2))
    return out


def _fold_top(x: torch.Tensor) -> torch.Tensor:
    """Carry into a 25th limb, then fold it back via 2^264 ≡ FOLD."""
    x = _carry(_pad(x, 1), 1)
    hi = x[NLIMBS]
    x = x[:NLIMBS]
    for i in range(_FN):
        x[i] += FOLD[i] * hi
    return x


def _tight24(a: torch.Tensor) -> torch.Tensor:
    return _carry(_fold_top(a), 1)


def _reduce_wide(wide: torch.Tensor) -> torch.Tensor:
    """47 loose product limbs -> 24 limbs, every |limb| <= 2^12."""
    wide = _carry(_pad(wide, 1), 2)
    x = _fold_once(wide)
    x = _carry(x, 1)
    return _carry(_fold_top(x), 1)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Modular multiply for loose inputs (the reference's contract:
    |non-top limb| <= 2^19, |top limb| <= 2^15)."""
    return _reduce_wide(_conv(_carry(a, 1), _carry(b, 1)))


def mul_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``mul`` for pre-tight operands (every |limb| <= 2^13)."""
    return _reduce_wide(_conv(a, b))


def sqr(a: torch.Tensor) -> torch.Tensor:
    """Modular square, mul's contract, through the half-product path."""
    return _reduce_wide(_sqr_conv(_carry(a, 1)))


def sqr_t(a: torch.Tensor) -> torch.Tensor:
    """``sqr`` for pre-tight operands (mul_t's contract)."""
    return _reduce_wide(_sqr_conv(a))


def mul_small_red(a: torch.Tensor, k: int) -> torch.Tensor:
    """Scale by a small constant and fold the top limb back."""
    return _fold_top(a * k)


# ---------- lazy-reduction wide API -----------------------------------------
# A wide is the unreduced (47, B) convolution of one product; wides of one
# expression sum limb-wise (acc_add) before the one shared reduction.


def mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _conv(_carry(a, 1), _carry(b, 1))


def mul_t_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _conv(a, b)


def sqr_wide(a: torch.Tensor) -> torch.Tensor:
    return _sqr_conv(_carry(a, 1))


def sqr_t_wide(a: torch.Tensor) -> torch.Tensor:
    return _sqr_conv(a)


def acc_add(*wides: torch.Tensor) -> torch.Tensor:
    out = wides[0]
    for w in wides[1:]:
        out = out + w
    return out


def reduce_wide(wide: torch.Tensor) -> torch.Tensor:
    return _reduce_wide(wide)


def reduce_wide_loose(wide: torch.Tensor) -> torch.Tensor:
    """``reduce_wide`` minus its final carry round: limbs <= ~2^12.3."""
    wide = _carry(_pad(wide, 1), 2)
    x = _fold_once(wide)
    x = _carry(x, 1)
    return _fold_top(x)


# ---------- exact canonicalization & comparisons ----------------------------


def _ge_p(a: torch.Tensor) -> torch.Tensor:
    """Lexicographic a >= p over canonical nonnegative limbs -> (B,) bool."""
    diff = a - _col("p", a.device)
    nz = (diff != 0).to(torch.int32)
    idx = (NLIMBS - 1) - torch.argmax(torch.flip(nz, dims=(0,)), dim=0)
    top = torch.gather(diff, 0, idx[None])[0]
    return torch.where(nz.any(dim=0), top > 0, True)


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Exact representative in [0, p) as nonnegative limbs (input limbs
    |limb| <= 2^13)."""
    x = _tight24(x)
    wide = _pad(x, 1) + _col("big", x.device)
    wide = _carry(wide, NLIMBS + 4)
    # value bits 256+ are limb23 >> 3 and limb24: fold them via 2^256 mod p
    hi = (wide[NLIMBS - 1] >> 3) + wide[NLIMBS] * (1 << 8)
    lo = wide[:NLIMBS].clone()
    lo[NLIMBS - 1] = wide[NLIMBS - 1] & 7
    for i in range(_FN):
        lo[i] += C_LIMBS[i] * hi
    lo = _carry(lo, NLIMBS + 2)  # value < 2p
    p_col = _col("p", x.device)
    for _ in range(2):
        lo = lo - torch.where(_ge_p(lo), p_col, 0)
        lo = _carry(lo, NLIMBS + 1)
    return lo


def is_zero(x: torch.Tensor) -> torch.Tensor:
    """value ≡ 0 (mod p)?  Exact, (B,) bool."""
    return (canonical(x) == 0).all(dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ≡ b (mod p)?  Exact, (B,) bool."""
    return is_zero(a - b)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``mask ? a : b``; mask (B,) broadcasts over the limb axis."""
    return torch.where(mask, a, b)
