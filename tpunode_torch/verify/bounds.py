"""Static per-limb bound tracker: the int32 headroom proof of the port.

Signed overflow is undefined behaviour in C++, and the CUDA kernel runs the
field schedule in raw int32, so this replay is the guard that keeps the
kernel defined.  :class:`BVal` carries an exact worst-case per-limb
magnitude bound (Python ints — no device work); :class:`BoundField`
mirrors every field op's real op sequence on bounds (the carries, folds
and convolutions of :mod:`.field`, which ``csrc/field.cuh`` transcribes
op for op) and checks int32 headroom at every multiply and accumulate.

:func:`audit_formulas` replays the live RCB formulas of :mod:`.curve`
through their ``F=`` seam from the window loop's input bounds and checks
closure: output coordinates must fit back inside the input contract,
because the window loop feeds them back every round.
:func:`audit_window_program` replays the chains of the window program at
one width and point form: the Q table's 2^wb - 2 sequential adds from a
prepped Q, in the affine form its batch inversion (prefix products, the
Fermat ladder, the suffix pass), the λ scaling of its entries, and one
window round of wb doublings and four adds (mixed adds in the affine form).
:func:`assert_formulas_safe` runs both once per reduce mode, width and
point form before the first kernel launch and plain run.  It takes no
table select: the select ("tree" or "onehot") only moves table entries.
The one-hot form adds one entry to zeros (the tree selects it), so it
computes no new sum that can carry, and every limb it returns is a limb
of the table the audit already bounds.

Bound semantics: a bound B means |value| <= B for every input the
contracts allow.  ``x & MASK`` is bounded by MASK, ``x >> RADIX`` by
(B + MASK) >> RADIX (an arithmetic shift of a negative rounds toward -inf),
a convolution by the exact anti-diagonal sums of pairwise bound products.
"""

from __future__ import annotations

from . import field as F

__all__ = [
    "BoundOverflow",
    "BVal",
    "BoundField",
    "audit_formulas",
    "audit_window_program",
    "assert_formulas_safe",
    "COORD_BOUND",
    "AFFINE_BOUND",
]

_INT32_MAX = (1 << 31) - 1
_MASK = F.MASK
_RADIX = F.RADIX
_NLIMBS = F.NLIMBS
_FOLD = list(F.FOLD)
_FN = F._FN

# The window loop's input contract: accumulator and table coordinates are
# sums of at most two reduced products — every |limb| <= 2^13.
COORD_BOUND = 1 << 13
# The mixed add's affine operand: mul outputs or canonical constants,
# possibly negated — every |limb| <= 2^12.
AFFINE_BOUND = 1 << 12


class BoundOverflow(AssertionError):
    """A tracked chain can exceed int32 (or a documented output contract)
    for some contract-legal input."""


def _ck(v: int, what: str) -> int:
    if v > _INT32_MAX:
        raise BoundOverflow(
            f"{what}: worst-case |value| {v} = 2^{v.bit_length() - 1}.x "
            f"exceeds int32 (2^31 - 1)"
        )
    return v


class BVal:
    """A field value known only by per-limb magnitude bounds."""

    __slots__ = ("b",)

    def __init__(self, bounds):
        self.b = tuple(int(x) for x in bounds)

    @classmethod
    def uniform(cls, bound: int, n: int = _NLIMBS) -> "BVal":
        return cls((bound,) * n)

    @property
    def width(self) -> int:
        return len(self.b)

    def max(self) -> int:
        return max(self.b)

    def __add__(self, other: "BVal") -> "BVal":
        if not isinstance(other, BVal):
            return NotImplemented
        if len(self.b) != len(other.b):
            raise ValueError("width mismatch in add")
        return BVal(_ck(a + c, "add") for a, c in zip(self.b, other.b))

    __radd__ = __add__

    def __sub__(self, other: "BVal") -> "BVal":
        return self.__add__(other)  # magnitudes: |a - b| <= |a| + |b|

    __rsub__ = __sub__

    def __mul__(self, k: int) -> "BVal":
        if not isinstance(k, int):
            return NotImplemented
        return BVal(_ck(x * abs(k), "scale") for x in self.b)

    __rmul__ = __mul__


def _carry(x: BVal, rounds: int) -> BVal:
    """field._carry in bound space; the top limb keeps its old bound plus
    the neighbour's carry-in ((x & MASK) + (x >> R << R) == x exactly)."""
    b = list(x.b)
    for _ in range(rounds):
        lo = [_MASK if v else 0 for v in b]
        hi = [(v + _MASK) >> _RADIX for v in b]
        y = [lo[0]] + [
            _ck(lo[i] + hi[i - 1], "carry add") for i in range(1, len(b))
        ]
        y[-1] = _ck(b[-1] + (hi[-2] if len(b) > 1 else 0), "carry top")
        b = y
    return BVal(b)


def _pad(x: BVal, n: int) -> BVal:
    return BVal(x.b + (0,) * n)


def _conv(a: BVal, b: BVal, sqr: bool = False) -> BVal:
    """Anti-diagonal sums of pairwise bound products.  ``sqr`` also checks
    the half-product path's doubled cross partials 2·a_i·a_j."""
    n = len(a.b)
    out = [0] * (2 * n - 1)
    for i in range(n):
        for j in range(n):
            p = _ck(a.b[i] * b.b[j], "conv partial")
            if sqr and i != j:
                _ck(2 * p, "sqr doubled partial")
            out[i + j] = _ck(out[i + j] + p, "conv sum")
    return BVal(out)


def _fold_once(wide: BVal) -> BVal:
    lo = BVal(wide.b[:_NLIMBS])
    hi = wide.b[_NLIMBS:]
    k = len(hi)
    out = list(_pad(lo, max(0, k + _FN - 1 - _NLIMBS)).b)
    for i in range(_FN):
        for j in range(k):
            out[i + j] = _ck(
                out[i + j] + _ck(_FOLD[i] * hi[j], "fold partial"),
                "fold sum",
            )
    o = BVal(out)
    if o.width > _NLIMBS:
        return _fold_once(_carry(_pad(o, 1), 2))
    return o


def _fold_top(x: BVal) -> BVal:
    x = _carry(_pad(x, 1), 1)
    hi = x.b[_NLIMBS]
    b = list(x.b[:_NLIMBS])
    for i in range(_FN):
        b[i] = _ck(b[i] + _ck(_FOLD[i] * hi, "fold_top partial"), "fold_top")
    return BVal(b)


def _reduce_wide(wide: BVal) -> BVal:
    """field._reduce_wide in bound space, asserting its output contract
    (every |limb| <= 2^12)."""
    w = _carry(_pad(wide, 1), 2)
    x = _fold_once(w)
    x = _carry(x, 1)
    out = _carry(_fold_top(x), 1)
    if out.max() > (1 << 12):
        raise BoundOverflow(
            f"reduce_wide output bound {out.max()} exceeds the documented "
            f"|limb| <= 2^12 contract"
        )
    return out


class BoundField:
    """The field namespace over :class:`BVal` — a drop-in for the ``F=``
    parameter of :mod:`.curve`'s formulas."""

    RADIX = _RADIX
    NLIMBS = _NLIMBS
    MASK = _MASK

    def mul(self, a: BVal, b: BVal) -> BVal:
        return _reduce_wide(_conv(_carry(a, 1), _carry(b, 1)))

    def mul_t(self, a: BVal, b: BVal) -> BVal:
        return _reduce_wide(_conv(a, b))

    def sqr(self, a: BVal) -> BVal:
        a = _carry(a, 1)
        return _reduce_wide(_conv(a, a, sqr=True))

    def sqr_t(self, a: BVal) -> BVal:
        return _reduce_wide(_conv(a, a, sqr=True))

    def mul_small_red(self, a: BVal, k: int) -> BVal:
        return _fold_top(a * k)

    def mul_wide(self, a: BVal, b: BVal) -> BVal:
        return _conv(_carry(a, 1), _carry(b, 1))

    def mul_t_wide(self, a: BVal, b: BVal) -> BVal:
        return _conv(a, b)

    def sqr_wide(self, a: BVal) -> BVal:
        a = _carry(a, 1)
        return _conv(a, a, sqr=True)

    def sqr_t_wide(self, a: BVal) -> BVal:
        return _conv(a, a, sqr=True)

    def acc_add(self, *wides: BVal) -> BVal:
        out = wides[0]
        for w in wides[1:]:
            out = out + w
        return out

    def reduce_wide(self, w: BVal) -> BVal:
        return _reduce_wide(w)

    def reduce_wide_loose(self, w: BVal) -> BVal:
        """The tail minus its final carry; output must stay inside the
        window loop's 2^13 coordinate closure."""
        x = _carry(_pad(w, 1), 2)
        x = _fold_once(x)
        x = _carry(x, 1)
        out = _fold_top(x)
        if out.max() > COORD_BOUND:
            raise BoundOverflow(
                f"reduce_wide_loose output bound {out.max()} exceeds the "
                f"documented loose |limb| <= 2^13 contract"
            )
        return out

    def tighten(self, x: BVal, rounds: int = 1) -> BVal:
        return _carry(x, rounds)

    def make_point(self, x: BVal, y: BVal, z: BVal) -> list:
        return [x, y, z]


def _closed(name: str, point: list) -> int:
    """The peak bound of ``point``'s coordinates; raises if it escapes the
    window loop's 2^13 closure."""
    peak = max(v.max() for v in point)
    if peak > COORD_BOUND:
        raise BoundOverflow(
            f"{name} output coordinate bound {peak} escapes the "
            f"window loop's |limb| <= 2^13 closure"
        )
    return peak


def audit_formulas(reduce: "str | None" = None) -> dict:
    """Replay the live pt_add / pt_double / pt_add_mixed bodies from the
    window loop's input bounds (the mixed add's affine operand at 2^12);
    raise :class:`BoundOverflow` if any step can exceed int32 or an output
    coordinate escapes the 2^13 closure.  Returns the peak output bound of
    each formula."""
    from .curve import pt_add, pt_add_mixed, pt_double

    bf = BoundField()
    c = BVal.uniform(COORD_BOUND)
    p = [c, c, c]
    q_aff = [BVal.uniform(AFFINE_BOUND)] * 2
    return {
        name: _closed(name, res)
        for name, res in (
            ("pt_add", pt_add(p, p, F=bf, reduce=reduce)),
            ("pt_double", pt_double(p, F=bf, reduce=reduce)),
            ("pt_add_mixed", pt_add_mixed(p, q_aff, F=bf, reduce=reduce)),
        )
    }


def _audit_inversion(z: BVal, entries: int, bf: BoundField) -> int:
    """The affine Q table's batch inversion in bound space, step for step
    as the kernel runs it: prefix products of the Z column (z bounds
    ``z``), the 4-bit Fermat ladder over the last prefix (16 powers by
    sequential muls; 64 windows of four squarings and a multiply by a
    power, taken at the table's limb-wise peak so no digit is worse), and
    the suffix pass (the entry's inverse, its two coordinates, the running
    inverse).  Every mul and sqr asserts its own output contract; returns
    the peak bound of a normalised coordinate, which must meet the mixed
    add's 2^12 operand contract."""
    one = BVal((1,) + (0,) * (_NLIMBS - 1))
    prefix = [one, one, z]  # prefix[k] = z_2 .. z_k; prefix[1] = 1
    for _ in range(3, entries):
        prefix.append(bf.mul(prefix[-1], z))
    table = [one, prefix[-1]]
    for _ in range(14):
        table.append(bf.mul(table[-1], prefix[-1]))
    power = BVal(max(t.b[i] for t in table) for i in range(_NLIMBS))
    run = one
    for _ in range(64):
        for _ in range(4):
            run = bf.sqr(run)
        run = bf.mul(run, power)
    coord, peak = BVal.uniform(COORD_BOUND), 0
    for k in range(entries - 1, 1, -1):
        zinv = bf.mul(run, prefix[k - 1])
        peak = max(peak, bf.mul(coord, zinv).max())
        run = bf.mul(run, z)
    if peak > AFFINE_BOUND:
        raise BoundOverflow(
            f"affine table entry bound {peak} escapes the mixed add's "
            f"|limb| <= 2^12 operand contract"
        )
    return peak


def audit_window_program(window_bits: int, point_form: str = "projective",
                         reduce: "str | None" = None) -> dict:
    """Replay the window program's chains at ``window_bits`` in
    ``point_form`` through the live formulas: the Q table [Q, 2Q, ..] by
    2^wb - 2 sequential adds of a prepped Q (canonical limbs, Z = 1); in the
    affine form the batch inversion that normalises it; each entry's X
    times β; and one window round (wb doublings, then four adds — mixed
    adds against affine entries in the affine form) from the 2^13 closure.
    Raises :class:`BoundOverflow` if any step can exceed int32 or any
    output coordinate escapes its closure; returns each chain's peak
    output bound."""
    from .curve import check_point_form, pt_add, pt_add_mixed, pt_double

    affine = check_point_form(point_form) == "affine"
    bf = BoundField()
    canon = BVal.uniform(_MASK)
    q1 = [canon, canon, BVal((1,) + (0,) * (_NLIMBS - 1))]
    acc, table_peak = q1, 0
    for k in range(2, 1 << window_bits):
        acc = pt_add(acc, q1, F=bf, reduce=reduce)
        table_peak = max(table_peak, _closed(f"Q table entry {k}", acc))
    out = {"q_table_adds": (1 << window_bits) - 2, "q_table": table_peak}
    if affine:
        table_peak = out["inversion"] = _audit_inversion(
            BVal.uniform(table_peak), 1 << window_bits, bf)
    lam_peak = bf.mul(BVal.uniform(table_peak), canon).max()
    c = BVal.uniform(COORD_BOUND)
    entry = [BVal.uniform(max(table_peak, lam_peak, _MASK))] * (2 if affine else 3)
    acc, round_peak = [c, c, c], 0
    for _ in range(window_bits):
        acc = pt_double(acc, F=bf, reduce=reduce)
        round_peak = max(round_peak, _closed("window doubling", acc))
    add = pt_add_mixed if affine else pt_add
    for _ in range(4):
        acc = add(acc, entry, F=bf, reduce=reduce)
        round_peak = max(round_peak, _closed("window add", acc))
    return {**out, "lambda_x": lam_peak, "window_round": round_peak}


_AUDITED: dict = {}


def assert_formulas_safe(reduce: str, window_bits: int = 4,
                         point_form: str = "projective") -> None:
    """Audit the live formulas and the window program with ``reduce``'s
    bodies at ``window_bits`` and ``point_form`` once per reduce mode,
    width and form (a cached no-op after the first call); raises
    BoundOverflow when a formula breaks headroom.  ``reduce`` is the mode
    the caller runs, never the knob's: a launcher audits what it launches."""
    key = (F.check_reduce(reduce), window_bits, point_form)
    if key not in _AUDITED:
        _AUDITED[key] = (audit_formulas(reduce),
                         audit_window_program(window_bits, point_form, reduce))
