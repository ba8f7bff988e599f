"""Batch secp256k1 verification: host prep, the plain program, dispatch.

Verifies B signatures at once: for each ``(Q, z, r, s)`` compute
``R = u1·G + u2·Q`` and accept iff R is finite and ``x(R) ≡ r (mod n)``
(ECDSA), or ``x(R) = r`` with ``jacobi(y(R)) = 1`` (BCH Schnorr) or
``y(R)`` even (BIP340).  The reference design (``tpunode/verify/kernel.py``):

* **Host prep** (Python ints or the native ``secp_prepare_batch_w``):
  range checks, one batch inversion of every ``s``, the GLV split of each
  scalar into two signed ~128-bit halves, and limb-major digit and limb
  rows.
* **Device program**: Shamir's trick over interleaved windows of the four
  half-scalars against G, λG, Q and λQ (33 windows of 4 bits, or 27 of 5
  bits over 32-entry tables), with complete projective formulas, then the
  projective x-check.  The width travels with the batch: a
  :class:`PreparedBatch` with 33 digit rows is 4-bit, one with 27 is
  5-bit.  The point form is an argument: "projective" tables and complete
  adds, or "affine" tables (one batch inversion a lane) and mixed adds;
  the host prep is the same for both.  So is the reduction of the point
  formulas' products: "lazy" (unreduced products of one coordinate
  accumulate and share one reduction) or "eager" (each product reduced at
  once).  So is the table select: the reference's "tree" or "onehot"
  (``TPUNODE_SELECT16``), the same entry either way.  :func:`verify_core`
  is its plain PyTorch version;
  ``cuda_kernel.verify_blocked`` launches the hand-written CUDA kernel for
  CUDA tensors and runs :func:`verify_core` for CPU ones.
* **Dispatch**: :func:`dispatch_batch_gpu` preps, uploads and launches
  without waiting; :func:`collect_verdicts` reads the verdicts back.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ..trace import span
from . import bounds as _bounds
from . import cuda_kernel
from . import field as F
from .cpu_native import load_native_verifier
from .curve import (
    check_point_form,
    infinity,
    make_point,
    point_form,
    pt_add,
    pt_add_mixed,
    pt_double,
)
from .ecdsa_cpu import CURVE_N, CURVE_P, GENERATOR, Point, point_add
from .raw import RawBatch, pack_items
from .width import WINDOW_BITS, WINDOWS_BY_BITS, window_bits, windows

__all__ = [
    "WINDOW_BITS",
    "WINDOWS_BY_BITS",
    "window_bits",
    "windows",
    "digit_rows_width",
    "SELECT_MODES",
    "POW_LADDER_MODES",
    "select_mode",
    "check_select",
    "window_tables",
    "LAMBDA",
    "BETA",
    "PreparedBatch",
    "kernel_modes",
    "glv_split",
    "prepare_batch",
    "prepare_batch_raw",
    "from_reference",
    "check_reference_tables",
    "select_tree16",
    "select_onehot",
    "verify_core",
    "resolve_device",
    "dispatch_batch_gpu",
    "dispatch_batch_gpu_raw",
    "collect_verdicts",
    "verify_batch_gpu",
]

def digit_rows_width(*digit_rows) -> int:
    """The window width of a batch's digit-row arrays, from their row
    count (33 -> 4, 27 -> 5).  Raises ValueError unless every array has
    the same count and it names a width."""
    rows = {int(np.shape(d)[0]) for d in digit_rows}
    for wb, nwin in WINDOWS_BY_BITS.items():
        if rows == {nwin}:
            return wb
    raise ValueError(
        f"digit rows {sorted(rows)} name no window width "
        f"(all four 33 for 4-bit or 27 for 5-bit)"
    )


# The reference's select and pow-ladder modes (tpunode/verify/kernel.py).
SELECT_MODES = ("tree", "onehot")
POW_LADDER_MODES = ("scan", "unroll")


def select_mode() -> str:
    """The table select the ``TPUNODE_SELECT16`` knob asks for: "tree"
    (unset) or "onehot"; a value outside :data:`SELECT_MODES` raises
    ValueError."""
    return F.env_mode("TPUNODE_SELECT16", SELECT_MODES, "tree", "1d", runs=SELECT_MODES)


def check_select(mode: str) -> str:
    """``mode`` if it is one of :data:`SELECT_MODES`, else ValueError."""
    if mode not in SELECT_MODES:
        raise ValueError(f"select mode {mode!r} not in {SELECT_MODES}")
    return mode


def kernel_modes(width: Optional[int] = None, form: Optional[str] = None,
                 reduce: Optional[str] = None, select: Optional[str] = None) -> tuple:
    """The reference's mode tuple (field + point form + select / ladder /
    window width) for a run at ``width`` in ``form`` with ``reduce`` and
    ``select``: the batch's or the engine's, or the ``TPUNODE_WINDOW_BITS``
    / ``TPUNODE_POINT_FORM`` / ``TPUNODE_FIELD_REDUCE`` /
    ``TPUNODE_SELECT16`` knob's when None.  A width other than 4 or 5, a
    form outside ``curve.POINT_FORMS``, a reduce mode outside
    ``field.REDUCE_MODES``, a select outside :data:`SELECT_MODES` or a knob
    value that names no mode raises ValueError; another of the reference's
    modes that the port does not run yet raises NotImplementedError naming
    its ROADMAP item."""
    if width is None:
        width = window_bits()
    windows(width)
    form = point_form() if form is None else check_point_form(form)
    return F.field_modes(reduce) + (
        form,
        select_mode() if select is None else check_select(select),
        F.env_mode("TPUNODE_POW_LADDER", POW_LADDER_MODES, "scan", "1e"),
        width,
    )


# --- the secp256k1 endomorphism (standard public constants) ---------------
# φ(x, y) = (β·x, y) = λ·(x, y); the lattice basis (a1, b1), (a2, b2) spans
# the kernel of (k1, k2) -> k1 + k2·λ (mod n) with ~128-bit entries.
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
_A1 = 0x3086D221A7D46BCDE86C90E49284EB15
_B1 = -0xE4437ED6010E88286F547FA90ABFE4C3
_A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
_B2 = _A1
# Barrett reciprocals round(2^384 * b2 / n) and round(2^384 * |b1| / n): the
# native prep uses the same formula, so both preps emit identical digits.
_G1 = ((_B2 << 384) + CURVE_N // 2) // CURVE_N
_G2 = ((-_B1 << 384) + CURVE_N // 2) // CURVE_N


def glv_split(k: int) -> tuple[int, int]:
    """Decompose ``k`` (mod n) as ``k1 + k2·λ`` with |k1|, |k2| < ~2^129."""
    k %= CURVE_N
    c1 = (k * _G1 + (1 << 383)) >> 384
    c2 = (k * _G2 + (1 << 383)) >> 384
    return k - c1 * _A1 - c2 * _A2, -c1 * _B1 - c2 * _B2


def _table_np(base: Point, entries: int) -> np.ndarray:
    """Constant table [O, P, 2P, ..] as projective limb points
    (entries, 3, 24)."""
    table = np.zeros((entries, 3, F.NLIMBS), dtype=np.int32)
    table[0, 1, 0] = 1  # (0 : 1 : 0)
    acc = Point(None, None)
    for k in range(1, entries):
        acc = point_add(acc, base)
        table[k, 0] = F.to_limbs(acc.x)
        table[k, 1] = F.to_limbs(acc.y)
        table[k, 2, 0] = 1
    return table


_LAMBDA_G = Point(BETA * GENERATOR.x % CURVE_P, GENERATOR.y)


@functools.lru_cache(maxsize=None)
def window_tables(wb: int, point_form: str = "projective") -> tuple:
    """(G, λG) constant window tables at width ``wb``: numpy int32,
    (2^wb, 3, 24) each, or (2^wb, 2, 24) in the affine form.  Every finite
    entry has Z = 1, so dropping the Z plane is the normalisation; entry 0
    keeps (0, 1), a placeholder the affine window loop never adds."""
    windows(wb)
    tables = _table_np(GENERATOR, 1 << wb), _table_np(_LAMBDA_G, 1 << wb)
    if check_point_form(point_form) == "affine":
        return tuple(np.ascontiguousarray(t[:, :2]) for t in tables)
    return tables


def check_reference_tables(g_table, lg_table) -> None:
    """Raise ValueError unless the reference's constant G / λG window
    tables (numpy, 16 or 32 entries) equal the port's at that width, limb
    for limb."""
    g_table, lg_table = np.asarray(g_table), np.asarray(lg_table)
    wb = len(g_table).bit_length() - 1
    if wb not in WINDOWS_BY_BITS or len(g_table) != 1 << wb:
        raise ValueError(f"a window table of {len(g_table)} entries has no width")
    for name, ref, ours in zip(("G", "λG"), (g_table, lg_table), window_tables(wb)):
        if not np.array_equal(ref, ours):
            raise ValueError(f"{wb}-bit {name} window table differs from the reference's")


# One list drives PreparedBatch's slots, the device_args order (verify_core's
# and the CUDA kernel's argument order) and the 2-D / 1-D split.
_DEVICE_FIELDS = (
    ("d1a", 2),
    ("d1b", 2),
    ("d2a", 2),
    ("d2b", 2),
    ("n1a", 1),
    ("n1b", 1),
    ("n2a", 1),
    ("n2b", 1),
    ("qx", 2),
    ("qy", 2),
    ("r1", 2),
    ("r2", 2),
    ("r2_valid", 1),
    ("host_valid", 1),
    ("schnorr", 1),  # per-lane algorithm: BCH Schnorr instead of ECDSA
    ("bip340", 1),  # per-lane algorithm: BIP340 (taproot) Schnorr
)


class PreparedBatch:
    """Host-prepared device inputs for one batch, limb-major: digit rows
    ``(windows, B)`` int32, limb rows ``(24, B)`` int32, flags ``(B,)``
    bool.  ``device_args`` yields them in :func:`verify_core` order."""

    __slots__ = tuple(name for name, _ in _DEVICE_FIELDS) + ("count",)

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)

    @property
    def device_args(self) -> tuple:
        return tuple(getattr(self, name) for name, _ in _DEVICE_FIELDS)

    @property
    def window_bits(self) -> int:
        """The window width, from the digit-row count (33 -> 4, 27 -> 5)."""
        return digit_rows_width(self.d1a, self.d1b, self.d2a, self.d2b)

    @property
    def schnorr_free(self) -> bool:
        """No lane carries a Schnorr/BIP340 flag, so the variant without the
        acceptance pows is exact.  The one derivation every dispatch uses:
        a wrong True would accept jacobi/parity forgeries."""
        return not (np.any(self.schnorr) or np.any(self.bip340))


def _batch_inverse_mod_n(values: list[int]) -> list[int]:
    """Montgomery batch inversion mod n: one pow() for the whole batch."""
    if not values:
        return []
    prefix = []
    run = 1
    for v in values:
        run = run * v % CURVE_N
        prefix.append(run)
    inv = pow(run, -1, CURVE_N)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = inv * (prefix[i - 1] if i > 0 else 1) % CURVE_N
        inv = inv * values[i] % CURVE_N
    return out


def _ints_to_limbs_np(vals: list[int]) -> np.ndarray:
    """256-bit ints -> (len, 24) int32 limbs, through numpy uint64 shifts."""
    n = len(vals)
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    words = np.frombuffer(buf, dtype="<u8").reshape(n, 4)
    out = np.zeros((n, F.NLIMBS), dtype=np.int32)
    for i in range(F.NLIMBS):
        w, off = divmod(F.RADIX * i, 64)
        lo = words[:, w] >> np.uint64(off)
        if off > 64 - F.RADIX and w + 1 < 4:  # limb straddles a word edge
            lo = lo | (words[:, w + 1] << np.uint64(64 - off))
        out[:, i] = (lo & np.uint64(F.MASK)).astype(np.int32)
    return out


def _ints_to_digits_np(vals: list[int], wb: int = WINDOW_BITS) -> np.ndarray:
    """Ints < 2^(wb·windows) -> (len, windows) int32 ``wb``-bit digits,
    most significant first.  4-bit digits never straddle a 64-bit word
    edge; 5-bit digits do (at bits 60 and 125), and take the next word's
    low bits too."""
    nwin, mask = windows(wb), (1 << wb) - 1
    n = len(vals)
    buf = b"".join(v.to_bytes(24, "little") for v in vals)
    words = np.frombuffer(buf, dtype="<u8").reshape(n, 3)
    out = np.zeros((n, nwin), dtype=np.int32)
    for j in range(nwin):
        w, off = divmod(wb * (nwin - 1 - j), 64)
        lo = words[:, w] >> np.uint64(off)
        if off > 64 - wb and w + 1 < 3:  # digit straddles a word edge
            lo = lo | (words[:, w + 1] << np.uint64(64 - off))
        out[:, j] = (lo & np.uint64(mask)).astype(np.int32)
    return out


def _item_algo(item: tuple) -> Optional[str]:
    if len(item) >= 5 and item[4] in ("schnorr", "bip340"):
        return item[4]
    return None


def prepare_batch(items: Sequence[tuple], pad_to: Optional[int] = None,
                  window_bits: int = WINDOW_BITS) -> PreparedBatch:
    """Host prep in Python: ``(pubkey|None, z, r, s[, "schnorr"|"bip340"])``
    items -> device arrays.  ECDSA items carry the sighash in ``z``;
    Schnorr items carry the precomputed challenge ``e`` (u1 = s, u2 = n - e,
    no inversion).  Invalid-by-inspection items are masked (``host_valid``)
    and keep dummy lanes; ``pad_to`` pads to a fixed batch size;
    ``window_bits`` is the digit width (4 or 5).  The reference
    for :func:`prepare_batch_raw`, which the engine uses."""
    count = len(items)
    size = pad_to or count
    if size < count:
        raise ValueError(f"pad_to={size} < batch of {count}")
    wb, nwin = window_bits, windows(window_bits)
    d = [np.zeros((size, nwin), dtype=np.int32) for _ in range(4)]
    negs = np.zeros((4, size), dtype=bool)
    qx = np.zeros((size, F.NLIMBS), dtype=np.int32)
    qy = np.zeros((size, F.NLIMBS), dtype=np.int32)
    r1 = np.zeros((size, F.NLIMBS), dtype=np.int32)
    r2 = np.zeros((size, F.NLIMBS), dtype=np.int32)
    r2v = np.zeros((size,), dtype=bool)
    hv = np.zeros((size,), dtype=bool)
    sch = np.zeros((size,), dtype=bool)
    b340 = np.zeros((size,), dtype=bool)

    s_vals, s_idx = [], []
    for i, item in enumerate(items):
        q, z, r, s = item[:4]
        if q is None or q.infinity:
            continue
        tag = _item_algo(item)
        if tag is not None:
            if not (0 <= r < CURVE_P and 0 <= s < CURVE_N):
                continue
            hv[i] = True
            (sch if tag == "schnorr" else b340)[i] = True
        else:
            if not (0 < r < CURVE_N and 0 < s < CURVE_N):
                continue
            hv[i] = True
            s_vals.append(s)
            s_idx.append(i)
    inv_by_idx = dict(zip(s_idx, _batch_inverse_mod_n(s_vals)))

    bound = 1 << (wb * nwin)
    idxs: list[int] = []
    half_abs: tuple[list[int], ...] = ([], [], [], [])
    gx, gy, gr1, r2_idx, gr2 = [], [], [], [], []
    for i, item in enumerate(items):
        if not hv[i]:
            continue
        q, z, r, s = item[:4]
        idxs.append(i)
        if sch[i] or b340[i]:
            u1 = s % CURVE_N
            u2 = (CURVE_N - z % CURVE_N) % CURVE_N
        else:
            w = inv_by_idx[i]
            u1 = (z % CURVE_N) * w % CURVE_N
            u2 = r * w % CURVE_N
        for j, k in enumerate(glv_split(u1) + glv_split(u2)):
            if abs(k) >= bound:  # not assert: -O must not strip this guard
                raise ValueError(
                    f"GLV half-scalar out of window range (item {i}, half {j})"
                )
            negs[j, i] = k < 0
            half_abs[j].append(abs(k))
        gx.append(q.x)
        gy.append(q.y)
        gr1.append(r)
        if not (sch[i] or b340[i]) and r + CURVE_N < CURVE_P:
            r2_idx.append(i)
            gr2.append(r + CURVE_N)
    if idxs:
        ii = np.array(idxs)
        for j in range(4):
            d[j][ii] = _ints_to_digits_np(half_abs[j], wb)
        qx[ii] = _ints_to_limbs_np(gx)
        qy[ii] = _ints_to_limbs_np(gy)
        r1[ii] = _ints_to_limbs_np(gr1)
    if r2_idx:
        jj = np.array(r2_idx)
        r2[jj] = _ints_to_limbs_np(gr2)
        r2v[jj] = True

    t = np.ascontiguousarray
    return PreparedBatch(
        d1a=t(d[0].T), d1b=t(d[1].T), d2a=t(d[2].T), d2b=t(d[3].T),
        n1a=t(negs[0]), n1b=t(negs[1]), n2a=t(negs[2]), n2b=t(negs[3]),
        qx=t(qx.T), qy=t(qy.T), r1=t(r1.T), r2=t(r2.T),
        r2_valid=r2v, host_valid=hv, schnorr=sch, bip340=b340,
        count=count,
    )


def prepare_batch_raw(raw: RawBatch, pad_to: Optional[int] = None,
                      window_bits: int = WINDOW_BITS) -> PreparedBatch:
    """Host prep of a packed batch through the native
    ``secp_prepare_batch_w`` (which redoes every range check on the raw
    rows) at ``window_bits`` (4 or 5); output identical to
    :func:`prepare_batch` on the same items."""
    count = len(raw)
    out = load_native_verifier().prepare_batch_arrays(
        raw, pad_to or count, window_bits)
    negs = out["negs"].astype(bool)
    return PreparedBatch(
        d1a=out["d1a"], d1b=out["d1b"], d2a=out["d2a"], d2b=out["d2b"],
        n1a=negs[0], n1b=negs[1], n2a=negs[2], n2b=negs[3],
        qx=out["qx"], qy=out["qy"], r1=out["r1"], r2=out["r2"],
        r2_valid=out["r2_valid"].astype(bool),
        host_valid=out["host_valid"].astype(bool),
        schnorr=out["schnorr"].astype(bool),
        bip340=out["bip340"].astype(bool),
        count=count,
    )


def from_reference(arrays: Sequence[np.ndarray], device) -> tuple:
    """``device_args`` as numpy — the port's or the reference package's
    PreparedBatch, one layout — to tensors on ``device``: digit and limb
    rows int32, flags bool.  Validates count, rank, dtype, batch width and
    the digit rows (33 or 27, the same in all four).  On a card the upload
    is asynchronous, from pinned memory."""
    device = torch.device(device)
    if len(arrays) != len(_DEVICE_FIELDS):
        raise ValueError(f"expected {len(_DEVICE_FIELDS)} arrays, got {len(arrays)}")
    b = np.asarray(arrays[8]).shape[-1]
    nwin = windows(digit_rows_width(*arrays[:4]))
    out = []
    for (name, nd), a in zip(_DEVICE_FIELDS, arrays):
        a = np.ascontiguousarray(a, dtype=np.int32 if nd == 2 else np.bool_)
        rows = nwin if name[0] == "d" else F.NLIMBS
        want = (rows, b) if nd == 2 else (b,)
        if a.shape != want:
            raise ValueError(f"{name}: shape {a.shape}, expected {want}")
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out.append(t)
    return tuple(out)


# ---------- the plain program: verify_core in torch ops ---------------------


@functools.lru_cache(maxsize=None)
def _const_tables(device: torch.device, wb: int, form: str) -> tuple:
    """(G, λG) window tables (2^wb, 3 or 2, 24, 1) on ``device``."""
    return tuple(torch.from_numpy(t)[..., None].to(device)
                 for t in window_tables(wb, form))


@functools.lru_cache(maxsize=None)
def _beta(device: torch.device) -> torch.Tensor:
    """β as a limb column (24, 1, 1) on ``device``."""
    return torch.from_numpy(F.to_limbs(BETA))[:, None, None].to(device)


def _build_q_table(qx: torch.Tensor, qy: torch.Tensor, wb: int,
                   reduce: str = "lazy") -> torch.Tensor:
    """Per-signature table [O, Q, 2Q, .., (2^wb - 1)Q], shape
    (2^wb, 3, 24, B), by 2^wb - 2 sequential complete adds with
    ``reduce``'s bodies (the reference's scan form): 14 at 4-bit, 30 at
    5-bit."""
    one = F.ONE.to(qx.device).expand_as(qx)
    q1 = make_point(qx, qy, one)
    ent = [infinity(qx.shape[1], qx.device), q1]
    acc = q1
    for _ in range(2, 1 << wb):
        acc = pt_add(acc, q1, reduce=reduce)
        ent.append(acc)
    return torch.stack(ent, dim=0)


def _affine_q_table(qx: torch.Tensor, qy: torch.Tensor, wb: int,
                    reduce: str = "lazy") -> torch.Tensor:
    """The Q table in the affine form, (2^wb, 2, 24, B), in the Pallas
    kernel's order (pallas_kernel.py:220-260): the projective chain of
    2^wb - 2 complete adds with ``reduce``'s bodies, each Z set aside
    (the inversion below multiplies with ``F.mul`` in both modes); prefix
    products
    p_k = z_2 .. z_k with p_1 = 1; one Fermat ladder (p_last)^(p-2); then
    from the last entry down to entry 2, z_k^-1 = run · p_{k-1} (at k = 2
    a multiply by p_1 = 1, which changes the limbs but not the value), the
    entry's X and Y times it, and run · z_k.  Entry 0 is the (0, 1)
    placeholder, entry 1 (qx, qy).  A lane whose chain reaches Z ≡ 0 (Q
    off the curve) inverts 0 to 0 and gets garbage entries; its verdict is
    masked by the on-curve check."""
    one = F.ONE.to(qx.device).expand_as(qx)
    q1 = make_point(qx, qy, one)
    ent = [torch.stack([torch.zeros_like(qx), one]), q1[:2]]
    zs = [None, None]
    acc = q1
    for _ in range(2, 1 << wb):
        acc = pt_add(acc, q1, reduce=reduce)
        ent.append(acc[:2])
        zs.append(acc[2])
    prefix = [None, one, zs[2]]
    for k in range(3, 1 << wb):
        prefix.append(F.mul(prefix[-1], zs[k]))
    run = _pow_const(prefix[-1], _PM2_DIGITS)
    for k in range((1 << wb) - 1, 1, -1):
        zinv = F.mul(run, prefix[k - 1])
        ent[k] = torch.stack([F.mul(ent[k][0], zinv), F.mul(ent[k][1], zinv)])
        if k > 2:
            run = F.mul(run, zs[k])
    return torch.stack(ent, dim=0)


def _lambda_table(q_table: torch.Tensor) -> torch.Tensor:
    """λQ multiples from the Q table (either form): φ(kQ) = k·φ(Q), so
    scaling each entry's X by β is all it takes (one field mul an entry,
    one batched call)."""
    beta = _beta(q_table.device)
    lx = F.mul(q_table[:, 0].transpose(0, 1), beta).transpose(0, 1)
    out = q_table.clone()
    out[:, 0] = lx
    return out


def select_tree16(entries: list, digits: torch.Tensor) -> torch.Tensor:
    """Balanced binary select over 2^k table entries: level ``i`` resolves
    digit bit ``i``; ``digits`` (B,) broadcasts against each entry."""
    level = list(entries)
    depth = (len(level) - 1).bit_length()
    if len(level) != 1 << depth:
        raise ValueError("select tree needs 2^k entries")
    for i in range(depth):
        bit = ((digits >> i) & 1) == 1
        level = [
            torch.where(bit, level[2 * j + 1], level[2 * j])
            for j in range(len(level) // 2)
        ]
    return level[0]


def select_onehot(entries: list, digits: torch.Tensor) -> torch.Tensor:
    """One-hot select over table entries: the sum over ``t`` of
    ``where(digits == t, entries[t], 0)`` (the reference's compare and
    accumulate, pallas_kernel._select16's onehot branch).  Exactly one term
    is nonzero for a digit in [0, len(entries)), so the result is the
    entry the tree selects.  ``digits`` (B,) broadcasts against each entry.
    Not an einsum: the card has no int32 or int64 matrix product."""
    out = None
    for t, entry in enumerate(entries):
        term = torch.where(digits == t, entry, 0)
        out = term if out is None else out + term
    return out


_SELECTS = {"tree": select_tree16, "onehot": select_onehot}


def _signed(entry: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """-P = (X, -Y[, Z]) on the lanes where ``neg`` is set: projective and
    affine entries alike."""
    return torch.cat([entry[:1], torch.where(neg, -entry[1:2], entry[1:2]), entry[2:]])


# Constant-exponent digit rows (64 MSB-first 4-bit digits) of the two pows.
# They stay 4-bit at every window width: the exponents are constants that
# have nothing to do with the GLV windows.
_EULER_DIGITS = [((CURVE_P - 1) // 2 >> (4 * (63 - i))) & 0xF for i in range(64)]
_PM2_DIGITS = [((CURVE_P - 2) >> (4 * (63 - i))) & 0xF for i in range(64)]


def _pow_const(t: torch.Tensor, digits: list) -> torch.Tensor:
    """t^e for a constant exponent: [1, t, .., t^15] by sequential muls,
    then 64 windows of 4 squarings and one multiply (the scan form)."""
    one = F.ONE.to(t.device).expand_as(t)
    table = [one, t]
    for _ in range(14):
        table.append(F.mul(table[-1], t))
    acc = one
    for d in digits:
        acc = F.sqr(F.sqr(F.sqr(F.sqr(acc))))
        acc = F.mul(acc, table[d])
    return acc


def verify_core(
    d1a, d1b, d2a, d2b,  # (33|27, B) int32 MSB-first digits of |u1a| .. |u2b|
    n1a, n1b, n2a, n2b,  # (B,) bool: the half-scalar is negative
    qx, qy, r1, r2,  # (24, B) int32 limbs
    r2_valid, host_valid, schnorr, bip340,  # (B,) bool
    *, schnorr_free: bool, point_form: str = "projective", reduce: str = "lazy",
    select: str,
) -> torch.Tensor:
    """The plain PyTorch version of the verify kernel: a (B,) bool verdict
    vector, on the inputs' device.  One program, three algorithms: ECDSA
    checks x(R) ∈ {r, r+n}; BCH Schnorr x(R) = r and jacobi(y(R)) = 1;
    BIP340 x(R) = r and y(R) even.  ``schnorr_free`` (from the host flags,
    :attr:`PreparedBatch.schnorr_free`) skips the two acceptance pows, which
    only Schnorr and BIP340 lanes read.  The window width comes from the
    digit rows (33 -> 4, 27 -> 5).  ``point_form`` "affine" normalises the
    Q table by one batch inversion a lane and adds 2-coordinate entries by
    mixed adds, keeping the accumulator where a digit is 0 (an affine table
    cannot hold infinity); the verdicts equal the projective form's.
    ``reduce`` ("lazy" or "eager") picks the bodies of every point addition
    and doubling, in the Q table and the window loop; the λ scaling, the
    batch inversion, the pows and the final checks use ``F.mul`` /
    ``F.sqr`` in both modes, as the reference does.  The verdicts are the
    same in both.  ``select`` ("tree" or "onehot", required) picks how a
    digit selects its window-table entry: :func:`select_tree16` or
    :func:`select_onehot`; the entry, and so every limb, is the same."""
    wb = digit_rows_width(d1a, d1b, d2a, d2b)
    kernel_modes(wb, point_form, reduce, select)
    _bounds.assert_formulas_safe(reduce, window_bits=wb, point_form=point_form)
    affine = point_form == "affine"
    b, dev = qx.shape[1], qx.device
    g_tab, lg_tab = _const_tables(dev, wb, point_form)
    q_table = (_affine_q_table if affine else _build_q_table)(qx, qy, wb, reduce)
    lq_table = _lambda_table(q_table)
    tables = (
        (list(g_tab), d1a, n1a),
        (list(lg_tab), d1b, n1b),
        (list(q_table), d2a, n2a),
        (list(lq_table), d2b, n2b),
    )
    acc = infinity(b, dev)
    for w in range(windows(wb)):
        for _ in range(wb):
            acc = pt_double(acc, reduce=reduce)
        for entries, digits, neg in tables:
            entry = _signed(_SELECTS[select](entries, digits[w]), neg)
            if affine:
                acc = torch.where(digits[w] == 0, acc, pt_add_mixed(acc, entry, reduce=reduce))
            else:
                acc = pt_add(acc, entry, reduce=reduce)

    X, Y, Z = acc[0], acc[1], acc[2]
    not_inf = ~F.is_zero(Z)
    m1 = F.eq(X, F.mul(r1, Z))
    m2 = F.eq(X, F.mul(r2, Z)) & r2_valid
    if schnorr_free:
        jac_ok = even_ok = torch.ones(b, dtype=torch.bool, device=dev)
    else:
        # jacobi(y) = jacobi(Y·Z): the symbol is multiplicative
        one = F.ONE.to(dev).expand_as(Y)
        jac_ok = F.eq(_pow_const(F.mul(Y, Z), _EULER_DIGITS), one)
        y_aff = F.mul(Y, _pow_const(Z, _PM2_DIGITS))
        even_ok = (F.canonical(y_aff)[0] & 1) == 0
    seven = torch.zeros_like(qx)
    seven[0] = 7
    on_curve = F.eq(F.sqr(qy), F.mul(F.sqr(qx), qx) + seven)
    algo_ok = torch.where(
        bip340, m1 & even_ok, torch.where(schnorr, m1 & jac_ok, m1 | m2)
    )
    return host_valid & on_curve & not_inf & algo_ok


# ---------- dispatch ---------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """The device a run uses: the card unless the caller names the CPU.
    With no card and no explicit CPU request it raises; it never carries
    on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _dispatch_prep(prep: PreparedBatch, device: torch.device, point_form: str,
                   reduce: str, select: str) -> tuple:
    with span("verify.transfer"):
        args = from_reference(prep.device_args, device)
    with span("verify.kernel"):
        return cuda_kernel.verify_blocked(*args, schnorr_free=prep.schnorr_free,
                                          point_form=point_form, reduce=reduce,
                                          select=select), prep.count


def dispatch_batch_gpu(items: Sequence[tuple], pad_to: Optional[int] = None,
                       device=None, window_bits: int = WINDOW_BITS,
                       point_form: str = "projective", reduce: str = "lazy", *,
                       select: str) -> tuple:
    """Host prep + asynchronous launch: returns (verdict tensor, count)
    without waiting for the device; collect with :func:`collect_verdicts`.
    ``window_bits`` is the width (4 or 5), ``point_form`` the form,
    ``reduce`` the point formulas' reduction ("lazy" or "eager"),
    ``select`` the table select ("tree" or "onehot", required)."""
    return dispatch_batch_gpu_raw(pack_items(items), pad_to=pad_to, device=device,
                                  window_bits=window_bits, point_form=point_form,
                                  reduce=reduce, select=select)


def dispatch_batch_gpu_raw(raw: RawBatch, pad_to: Optional[int] = None,
                           device=None, window_bits: int = WINDOW_BITS,
                           point_form: str = "projective", reduce: str = "lazy", *,
                           select: str) -> tuple:
    """:func:`dispatch_batch_gpu` over a packed :class:`RawBatch`."""
    dev = resolve_device(device)
    with span("verify.prepare"):
        prep = prepare_batch_raw(raw, pad_to=pad_to, window_bits=window_bits)
    return _dispatch_prep(prep, dev, point_form, reduce, select)


def collect_verdicts(out: torch.Tensor, count: int) -> list[bool]:
    """Wait for a dispatched batch and return its first ``count`` verdicts."""
    with span("verify.readback"):
        return out[:count].cpu().tolist()


def verify_batch_gpu(items: Sequence[tuple], pad_to: Optional[int] = None,
                     device=None, window_bits: int = WINDOW_BITS,
                     point_form: str = "projective", reduce: str = "lazy", *,
                     select: str) -> list[bool]:
    """End to end: host prep, device verify, readback."""
    if not items:
        return []
    return collect_verdicts(*dispatch_batch_gpu(items, pad_to=pad_to, device=device,
                                                window_bits=window_bits,
                                                point_form=point_form, reduce=reduce,
                                                select=select))
