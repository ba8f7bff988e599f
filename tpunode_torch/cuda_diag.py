"""Probes of the verify kernel's constructs, one CUDA kernel each.

The port's counterparts of eleven of ``benchmarks/mosaic_diag.py``'s Mosaic
probes, in twelve cases, and a thirteenth case for the arithmetic of the
kernel redesigned for the card: a build-and-run check of one construct at a
time, so that a fault of the toolchain or of the code is pinned to that
construct and not only seen in a whole verify kernel.

* ``trivial``: x + 1 over an (8, 128) int32 block of zeros, the toolchain's
  floor; every element must be 1 (the sum 1,024).
* ``field_mul``: ``canonical(mul(a, b))``, the eager point formulas'
  construct.  The reference probe's 256 lanes (two columns of
  ``default_rng(7).integers(0, 2**63)``), then 256 lanes of full-width
  values below p and 256 at ``mul``'s loose input contract (limbs ±2^19,
  the top one ±2^15), which exercise the carry and the fold; every lane
  must equal a·b mod p in canonical limbs.
* ``field_mul_dot``: the same function on the same 768 lanes under the
  reference's ``dot_general`` formulation (``TPUNODE_FIELD_MUL``): the 576
  partial products contracted against the (47, 576) anti-diagonal scatter,
  on the card by ``mma.sync`` on the integer tensor cores
  (``csrc/field_dot.cuh``).  Every lane must equal a·b mod p, and the
  ``field_mul`` probe's output limb for limb.
* ``field_mul_u32``: the same function on the same 768 lanes in the 8-word
  arithmetic of the main path's kernel (``csrc/field_u32.cuh``): the limb
  rows converted to eight 32-bit words on load (mul's loose limbs too), 64
  widening multiplies, the 2^256 ≡ 2^32 + 977 fold and one conditional
  subtraction of p, written back as canonical limbs.  Every lane must equal
  a·b mod p, and the ``field_mul`` probe's output limb for limb; its plain
  version is ``field.mul`` followed by ``canonical``.
* ``lazy_reduce``: ``canonical(reduce_wide_loose(ab + cd))`` over two bare
  convolutions accumulated wide, the lazy point formulas' construct.  The
  reference probe's 256 lanes (four columns of ``default_rng(29)`` values
  below 2^61), then 256 lanes of full-width values below p; every lane must
  equal (ab + cd) mod p.
* ``mixed_add``: one complete mixed addition (``curve.pt_add_mixed``, the
  affine form's window add) of 7G and 11G over 256 lanes; X - x_e·Z and
  Y - y_e·Z must be ≡ 0 (mod p) against host affine addition.
* ``batch_inv``: the affine Q table's batch inversion over 16 entries —
  the column z^1 .. z^14 of one random z a lane (``default_rng(17)``),
  prefix products, one Fermat ladder, the suffix step of entry 15 — and
  z_15 · z_15^-1 must canonicalise to 1 in every lane.
* ``table_build``: the 16-entry power table [1, a, .., a^15] of one a a
  lane (``default_rng(11)``: a in [1, 2^61)) written by dynamic index in a
  loop, the Q table build's construct; every lane must equal a^15 mod p.
* ``pow_descan``: Euler's pow of a quadratic residue a lane
  (``default_rng(19)``) with every digit static, the unrolled ladder's
  construct (``TPUNODE_POW_LADDER=unroll``): the power table by the
  log-depth chain, the first window's entry as the accumulator, then 63
  windows of four squarings and a multiply by a table entry fixed at
  compile time.  Every lane must be 1.
* ``select_tree``: the 16-entry power table [1, t, .., t^15] of one t a
  lane and its entry d by the 4-level select tree, the tree select's
  construct (``default_rng(23)``: t below 2^31, d below 16); every lane
  must equal t^d mod p.
* ``pow_window`` and ``pow_window_smem``: Euler's pow of a quadratic
  residue a lane (``default_rng(13)``) as 64 4-bit windows, each entry
  picked by a one-hot compare-accumulate on a digit read by dynamic index
  from a (2, 64) int32 array, the one-hot select's construct; the digits
  lie in global memory, or are staged in shared memory first.  Every lane
  must be 1.
* ``window5``: a 32-entry per-lane power table of a and a shared (32, 24)
  constant table of g^k (g = 0xC0FFEE), both read by the 5-level tree on
  the lane's digit, the 5-bit windows' constructs (``default_rng(31)``: a
  below 2^31, d below 32); every lane must equal a^d · g^d mod p.

The kernels are ``csrc/diag.cu``, built with the verify kernel
(:func:`tpunode_torch.verify.cuda_kernel.build`); the ``*_plain``
functions are their plain PyTorch versions (:data:`FUNCTIONS` pairs each
wrapper with its plain version).  On a CUDA tensor a wrapper launches its
kernel, with the tensor's card made current, and counts it in
:data:`LAUNCHES`; on a CPU tensor it runs the plain version.  Run::

    python -m tpunode_torch.cuda_diag [--device cpu]

It runs on the card unless the CPU is asked for, prints one JSON line and
exits 1 if a probe fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch

from .verify import cuda_kernel
from .verify import field as F
from .verify.curve import make_point, pt_add_mixed
from .verify.ecdsa_cpu import GENERATOR, point_add, point_mul
from .verify.kernel import (
    _EULER_DIGITS,
    _PM2_DIGITS,
    _pow_const,
    resolve_device,
    select_onehot,
    select_tree16,
)

__all__ = ["LAUNCHES", "LANES", "PROBES", "FUNCTIONS", "trivial", "trivial_plain",
           "field_mul", "field_mul_plain", "field_mul_dot", "field_mul_dot_plain",
           "field_mul_u32",
           "lazy_reduce", "lazy_reduce_plain", "mixed_add",
           "mixed_add_plain", "batch_inv", "batch_inv_plain", "table_build",
           "table_build_plain", "pow_descan", "pow_descan_plain", "select_tree",
           "select_tree_plain", "pow_window", "pow_window_smem", "pow_window_plain", "window5",
           "window5_plain", "descan_calls", "descan_ptx", "mma_ptx", "probe_inputs", "run_probe",
           "run", "main"]

#: Probe kernel launches made in this process, by probe case.
LAUNCHES = {"trivial": 0, "field_mul": 0, "field_mul_dot": 0, "field_mul_u32": 0,
            "lazy_reduce": 0, "mixed_add": 0, "batch_inv": 0, "table_build": 0, "pow_descan": 0, "select_tree": 0,
            "pow_window": 0, "pow_window_smem": 0, "window5": 0}
LANES = 256  # the Mosaic probes' block width
PROBES = tuple(LAUNCHES)
TRIVIAL_SHAPE = (8, 128)  # the Mosaic probe's block
_ENTRIES = 16  # the batch inversion's table, as at 4-bit windows
WINDOW5_G = 0xC0FFEE  # the window5 probe's shared table holds its powers
WINDOW5_ENTRIES = 32


def _check(name: str, *rows: torch.Tensor, limbs: bool = True) -> torch.device:
    """Every argument a contiguous int32 tensor on one device: (24, B) limb
    rows, or (``limbs`` False) blocks of the first one's shape."""
    dev = rows[0].device
    shape = (F.NLIMBS, rows[0].shape[-1]) if limbs else tuple(rows[0].shape)
    for i, t in enumerate(rows):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name} argument {i}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected contiguous int32 {shape} on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_aux(name: str, t: torch.Tensor, shape: tuple, dev: torch.device) -> None:
    """A probe's digit row or constant table: contiguous int32 ``shape`` on
    ``dev``."""
    if (t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"{name} argument: {t.dtype} {tuple(t.shape)} on {t.device}, "
                         f"expected contiguous int32 {shape} on {dev}")


def _lib() -> ctypes.CDLL:
    """The probes' library (built with the verify kernel), bound once."""
    lib = cuda_kernel.load_library("diag")
    if lib.tpn_diag_batch_inv.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn, tensors in (("trivial", 2), ("field_mul", 3), ("field_mul_dot", 3),
                            ("field_mul_u32", 3),
                            ("lazy_reduce", 5), ("mixed_add", 5), ("batch_inv", 2),
                            ("table_build", 2), ("pow_descan", 2), ("select_tree", 3),
                            ("pow_window", 3), ("pow_window_smem", 3), ("window5", 4)):
            getattr(lib, f"tpn_diag_{fn}").argtypes = [vp] * tensors + [ci, vp]
            getattr(lib, f"tpn_diag_{fn}").restype = ci
        lib.tpn_diag_error_string.argtypes = [ci]
        lib.tpn_diag_error_string.restype = ctypes.c_char_p
    return lib


#: Each probe's bound C entry point, looked up once (:func:`_launch`).
_PROBE_FNS: dict = {}


def _launch(name: str, *tensors: torch.Tensor, b: int) -> None:
    """Launch probe ``name``'s kernel over ``b`` lanes, with the tensors'
    card made current, on that card's current stream; raise if the launch
    fails, else count it.  The host path a launch is kept short, since the
    add-one probe is timed beside ``x + 1``: the entry point is looked up
    once, the pointers go to ctypes as integers, the current stream's raw
    handle is read without a stream object, and the card is switched only
    when it is not current already."""
    entry = _PROBE_FNS.get(name)
    if entry is None:
        entry = _PROBE_FNS[name] = getattr(_lib(), f"tpn_diag_{name}")
    dev = tensors[0].device
    ptrs = [t.data_ptr() for t in tensors]
    if torch.cuda.current_device() == dev.index:
        err = entry(*ptrs, b, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = entry(*ptrs, b, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        msg = _lib().tpn_diag_error_string(err).decode()
        raise RuntimeError(f"{name} probe launch failed: {msg} ({err})")
    LAUNCHES[name] += 1


def trivial_plain(x) -> torch.Tensor:
    """x + 1, elementwise."""
    return x + 1


def trivial(x) -> torch.Tensor:
    """:func:`trivial_plain` for a CPU tensor; the probe kernel for a CUDA
    tensor (asynchronous, on the current stream)."""
    if _check("trivial", x, limbs=False).type == "cpu":
        return trivial_plain(x)
    out = torch.empty_like(x)
    _launch("trivial", x, out, b=x.numel())
    return out


def field_mul_plain(a, b) -> torch.Tensor:
    """canonical(mul(a, b)): (24, B)."""
    return F.canonical(F.mul(a, b))


def field_mul(a, b) -> torch.Tensor:
    """:func:`field_mul_plain` for CPU tensors; the probe kernel for CUDA
    tensors (asynchronous, on the current stream)."""
    if _check("field_mul", a, b).type == "cpu":
        return field_mul_plain(a, b)
    out = torch.empty_like(a)
    _launch("field_mul", a, b, out, b=a.shape[-1])
    return out


def field_mul_dot_plain(a, b) -> torch.Tensor:
    """canonical(mul(a, b)) with the convolution as the reference's
    ``dot_general`` contraction (``pallas_field.mul`` under
    ``TPUNODE_FIELD_MUL=dot_general``): (24, B), limb for limb
    :func:`field_mul_plain`'s."""
    return F.canonical(F._reduce_wide(F._conv_dot(F._carry(a, 1), F._carry(b, 1))))


def field_mul_dot(a, b) -> torch.Tensor:
    """:func:`field_mul_dot_plain` for CPU tensors; for CUDA tensors the
    probe kernel whose contraction runs on the tensor cores (asynchronous,
    on the current stream)."""
    if _check("field_mul_dot", a, b).type == "cpu":
        return field_mul_dot_plain(a, b)
    out = torch.empty_like(a)
    _launch("field_mul_dot", a, b, out, b=a.shape[-1])
    return out


def field_mul_u32(a, b) -> torch.Tensor:
    """:func:`field_mul_plain` for CPU tensors, its plain version; for CUDA
    tensors the probe kernel of the 8-word arithmetic (asynchronous, on the
    current stream)."""
    if _check("field_mul_u32", a, b).type == "cpu":
        return field_mul_plain(a, b)
    out = torch.empty_like(a)
    _launch("field_mul_u32", a, b, out, b=a.shape[-1])
    return out


def lazy_reduce_plain(a, b, c, d) -> torch.Tensor:
    """canonical(reduce_wide_loose(mul_t_wide(a, b) + mul_t_wide(c, d))): (24, B)."""
    return F.canonical(F.reduce_wide_loose(F.acc_add(F.mul_t_wide(a, b), F.mul_t_wide(c, d))))


def lazy_reduce(a, b, c, d) -> torch.Tensor:
    """:func:`lazy_reduce_plain` for CPU tensors; the probe kernel for CUDA
    tensors (asynchronous, on the current stream)."""
    if _check("lazy_reduce", a, b, c, d).type == "cpu":
        return lazy_reduce_plain(a, b, c, d)
    out = torch.empty_like(a)
    _launch("lazy_reduce", a, b, c, d, out, b=a.shape[-1])
    return out


def mixed_add_plain(px, py, qx, qy) -> torch.Tensor:
    """(px, py, 1) + (qx, qy) by the plain mixed add: (3, 24, B)."""
    one = F.ONE.to(px.device).expand_as(px)
    return pt_add_mixed(make_point(px, py, one), torch.stack([qx, qy]))


def mixed_add(px, py, qx, qy) -> torch.Tensor:
    """:func:`mixed_add_plain` for CPU tensors; the probe kernel for CUDA
    tensors (asynchronous, on the current stream)."""
    if _check("mixed_add", px, py, qx, qy).type == "cpu":
        return mixed_add_plain(px, py, qx, qy)
    out = torch.empty((3,) + tuple(px.shape), dtype=torch.int32, device=px.device)
    _launch("mixed_add", px, py, qx, qy, out, b=px.shape[-1])
    return out


def batch_inv_plain(z) -> torch.Tensor:
    """canonical(z_15 · z_15^-1) over the column z_k = z^(k-1), by prefix
    products, one Fermat ladder and the suffix step of entry 15: (24, B)."""
    col = [None, None, z]
    for _ in range(3, _ENTRIES):
        col.append(F.mul(col[-1], z))
    prefix = [None, None, z]
    for k in range(3, _ENTRIES):
        prefix.append(F.mul(prefix[-1], col[k]))
    inv = F.mul(_pow_const(prefix[-1], _PM2_DIGITS, ladder="scan", sqr="half",
                           mul="shift_add"), prefix[-2])
    return F.canonical(F.mul(col[-1], inv))


def batch_inv(z) -> torch.Tensor:
    """:func:`batch_inv_plain` for CPU tensors; the probe kernel for CUDA
    tensors (asynchronous, on the current stream)."""
    if _check("batch_inv", z).type == "cpu":
        return batch_inv_plain(z)
    out = torch.empty_like(z)
    _launch("batch_inv", z, out, b=z.shape[-1])
    return out


def table_build_plain(a) -> torch.Tensor:
    """canonical(a^15), the last entry of [1, a, .., a^15] by sequential
    multiplies: (24, B)."""
    return F.canonical(_power_table(a, 16)[15])


def table_build(a) -> torch.Tensor:
    """:func:`table_build_plain` for a CPU tensor; the probe kernel for a
    CUDA tensor (asynchronous, on the current stream)."""
    if _check("table_build", a).type == "cpu":
        return table_build_plain(a)
    out = torch.empty_like(a)
    _launch("table_build", a, out, b=a.shape[-1])
    return out


def pow_descan_plain(t) -> torch.Tensor:
    """canonical(t^((p-1)/2)) by the unrolled ladder (``kernel._pow_const``
    with ``ladder="unroll"``): (24, B)."""
    return F.canonical(_pow_const(t, _EULER_DIGITS, ladder="unroll", sqr="half",
                                  mul="shift_add"))


def pow_descan(t) -> torch.Tensor:
    """:func:`pow_descan_plain` for a CPU tensor; the probe kernel, whose
    digits are compile-time constants, for a CUDA tensor (asynchronous, on
    the current stream)."""
    if _check("pow_descan", t).type == "cpu":
        return pow_descan_plain(t)
    out = torch.empty_like(t)
    _launch("pow_descan", t, out, b=t.shape[-1])
    return out


def _power_table(t: torch.Tensor, entries: int) -> list:
    """[1, t, .., t^(entries-1)] by sequential multiplies."""
    table = [F.ONE.to(t.device).expand_as(t), t]
    for _ in range(2, entries):
        table.append(F.mul(table[-1], t))
    return table


def select_tree_plain(t, d) -> torch.Tensor:
    """canonical(t^d) by the 4-level select tree over [1, t, .., t^15]: (24, B)."""
    return F.canonical(select_tree16(_power_table(t, 16), d))


def select_tree(t, d) -> torch.Tensor:
    """:func:`select_tree_plain` for CPU tensors; the probe kernel for CUDA
    tensors (asynchronous, on the current stream)."""
    dev = _check("select_tree", t)
    _check_aux("select_tree", d, (t.shape[-1],), dev)
    if dev.type == "cpu":
        return select_tree_plain(t, d)
    out = torch.empty_like(t)
    _launch("select_tree", t, d, out, b=t.shape[-1])
    return out


def pow_window_plain(t, digits) -> torch.Tensor:
    """canonical(t^e) for the 64 MSB-first 4-bit digits of e in row 0 of
    ``digits`` (2, 64), each window's entry of [1, t, .., t^15] by the
    one-hot select: (24, B).  The plain version of both pow_window cases."""
    table = _power_table(t, 16)
    acc = table[0]
    for w in range(64):
        acc = F.sqr(F.sqr(F.sqr(F.sqr(acc))))
        acc = F.mul(acc, select_onehot(table, digits[0, w]))
    return F.canonical(acc)


def _pow_window(name: str, t, digits) -> torch.Tensor:
    dev = _check(name, t)
    _check_aux(name, digits, (2, 64), dev)
    if dev.type == "cpu":
        return pow_window_plain(t, digits)
    out = torch.empty_like(t)
    _launch(name, t, digits, out, b=t.shape[-1])
    return out


def pow_window(t, digits) -> torch.Tensor:
    """:func:`pow_window_plain` for CPU tensors; for CUDA tensors the probe
    kernel that reads the digits in global memory (asynchronous, on the
    current stream)."""
    return _pow_window("pow_window", t, digits)


def pow_window_smem(t, digits) -> torch.Tensor:
    """:func:`pow_window_plain` for CPU tensors; for CUDA tensors the probe
    kernel that stages the digits in shared memory (asynchronous, on the
    current stream)."""
    return _pow_window("pow_window_smem", t, digits)


def window5_plain(a, g_table, d) -> torch.Tensor:
    """canonical(a^d · g^d): a's 32-entry power table and the shared
    (32, 24) table ``g_table``, each by the 5-level select tree: (24, B)."""
    mine = select_tree16(_power_table(a, WINDOW5_ENTRIES), d)
    shared = select_tree16([g_table[k][:, None] for k in range(WINDOW5_ENTRIES)], d)
    return F.canonical(F.mul(mine, shared))


def window5(a, g_table, d) -> torch.Tensor:
    """:func:`window5_plain` for CPU tensors; the probe kernel for CUDA
    tensors (asynchronous, on the current stream)."""
    dev = _check("window5", a)
    _check_aux("window5", g_table, (WINDOW5_ENTRIES, F.NLIMBS), dev)
    _check_aux("window5", d, (a.shape[-1],), dev)
    if dev.type == "cpu":
        return window5_plain(a, g_table, d)
    out = torch.empty_like(a)
    _launch("window5", a, g_table, d, out, b=a.shape[-1])
    return out


#: probe case -> (its wrapper, its plain version).
FUNCTIONS = {
    "trivial": (trivial, trivial_plain),
    "field_mul": (field_mul, field_mul_plain),
    "field_mul_dot": (field_mul_dot, field_mul_dot_plain),
    "field_mul_u32": (field_mul_u32, field_mul_plain),
    "lazy_reduce": (lazy_reduce, lazy_reduce_plain),
    "mixed_add": (mixed_add, mixed_add_plain),
    "batch_inv": (batch_inv, batch_inv_plain),
    "table_build": (table_build, table_build_plain),
    "pow_descan": (pow_descan, pow_descan_plain),
    "select_tree": (select_tree, select_tree_plain),
    "pow_window": (pow_window, pow_window_plain),
    "pow_window_smem": (pow_window_smem, pow_window_plain),
    "window5": (window5, window5_plain),
}


def _below_p(rng: np.random.Generator, n: int) -> list:
    """``n`` full-width field values below p."""
    return [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(n)]


def _loose(rng: np.random.Generator, n: int) -> np.ndarray:
    """(24, n) limbs at ``mul``'s loose input contract: non-top limbs in
    ±2^19, the top limb in ±2^15; lane 0 at every upper corner, lane 1 at
    every lower one."""
    x = rng.integers(-(1 << 19), (1 << 19) + 1, size=(F.NLIMBS, n))
    x[-1] = rng.integers(-(1 << 15), (1 << 15) + 1, size=n)
    x[:, 0], x[:, 1] = (1 << 19), -(1 << 19)
    x[-1, 0], x[-1, 1] = (1 << 15), -(1 << 15)
    return x.astype(np.int32)


def probe_inputs(name: str, device, lanes: int = LANES) -> tuple:
    """The probe's inputs on ``device``.  The Mosaic probe's own inputs
    come first, over ``lanes`` lanes: an (8, 128) block of zeros (trivial);
    two columns of ``default_rng(7).integers(0, 2**63)``, then ``lanes``
    lanes of full-width values below p and ``lanes`` at mul's loose
    contract from the same generator (field_mul, field_mul_dot and
    field_mul_u32 alike);
    four columns of ``default_rng(29)`` values below 2^61 (lazy_reduce), then ``lanes``
    lanes of full-width values below p; 7G and 11G broadcast (mixed_add);
    one z in [2, 2^61) a lane from ``default_rng(17)`` (batch_inv); one a
    in [1, 2^61) a lane from ``default_rng(11)`` (table_build); the squares
    of values in [2, 2^61) from ``default_rng(19)`` (pow_descan); t
    below 2^31 and then d below 16 from ``default_rng(23)`` (select_tree);
    the squares of values in [2, 2^61) from ``default_rng(13)`` and the
    (2, 64) digit rows of (p-1)/2 (pow_window, pow_window_smem); a below
    2^31 and then d below 32 from ``default_rng(31)``, with the (32, 24)
    table of ``WINDOW5_G``'s powers (window5)."""
    def limbs(vals) -> np.ndarray:
        return np.stack([F.to_limbs(v) for v in vals], axis=1)

    def cols(vals) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(limbs(vals))).to(device)

    def tensor(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)

    if name == "trivial":
        return (torch.zeros(TRIVIAL_SHAPE, dtype=torch.int32, device=device),)
    if name in ("field_mul", "field_mul_dot", "field_mul_u32"):
        rng = np.random.default_rng(7)
        ref = [[int(rng.integers(0, 2**63)) for _ in range(lanes)] for _ in range(2)]
        full = [_below_p(rng, lanes) for _ in range(2)]
        loose = [_loose(rng, lanes) for _ in range(2)]
        return tuple(tensor(np.concatenate([limbs(r), limbs(f), x], axis=1))
                     for r, f, x in zip(ref, full, loose))
    if name == "lazy_reduce":
        rng = np.random.default_rng(29)
        ref = [[int(rng.integers(0, 2**61)) for _ in range(lanes)] for _ in range(4)]
        return tuple(cols(r + _below_p(rng, lanes)) for r in ref)
    if name == "mixed_add":
        p1, p2 = point_mul(7, GENERATOR), point_mul(11, GENERATOR)
        return tuple(cols([v] * lanes) for v in (p1.x, p1.y, p2.x, p2.y))
    if name == "batch_inv":
        rng = np.random.default_rng(17)
        return (cols([int(rng.integers(2, 2**61)) for _ in range(lanes)]),)
    if name == "table_build":
        rng = np.random.default_rng(11)
        return (cols([int(rng.integers(1, 2**61)) for _ in range(lanes)]),)
    if name in ("select_tree", "window5"):
        rng = np.random.default_rng(23 if name == "select_tree" else 31)
        entries = 16 if name == "select_tree" else WINDOW5_ENTRIES
        av = [int(rng.integers(2, 2**31)) for _ in range(lanes)]
        dv = np.array([int(rng.integers(0, entries)) for _ in range(lanes)])
        if name == "select_tree":
            return cols(av), tensor(dv)
        g = np.stack([F.to_limbs(pow(WINDOW5_G, k, F.P)) for k in range(entries)])
        return cols(av), tensor(g), tensor(dv)
    if name in ("pow_window", "pow_window_smem", "pow_descan"):
        rng = np.random.default_rng(19 if name == "pow_descan" else 13)
        squares = [int(rng.integers(2, 2**61)) ** 2 % F.P for _ in range(lanes)]
        if name == "pow_descan":
            return (cols(squares),)
        return cols(squares), tensor(np.array([_EULER_DIGITS, _EULER_DIGITS]))
    raise ValueError(f"no probe {name!r}: {PROBES}")


def descan_calls() -> dict:
    """The calls of ``sqr`` and ``mul`` in pow_descan's static ladder: 7
    each for the power table, four squarings for each window after the
    first and a multiply for each of those windows whose digit is not 0."""
    return {"sqr": 7 + 4 * 63, "mul": 7 + sum(1 for d in _EULER_DIGITS[1:] if d)}


_PTX_CALL = re.compile(r"\bcall(?:\.uni)?\s+(?:\([^)]*\)\s*,\s*)?(\w+)")
_PTX_MEMORY_LOAD = re.compile(r"\b(?:ldu?|tex|tld4)(?:\.\w+)*?\.(?:const|global|shared)\b")
_PTX_MODULE_DATA = re.compile(r"^\s*(?:\.(?:visible|extern|weak|common)\s+)*\.(?:const|global)\b"
                              r"([^=;]*)", re.M)


def descan_ptx(ptx: str) -> dict:
    """What the PTX of ``csrc/diag.cu`` shows of pow_descan's ladder, the
    function ``tpn::pow_descan<..>``: its calls by callee (``sqr``,
    ``mul``, ``other``), every load from constant, global or shared memory
    in it, and every module-scope ``.const`` or ``.global`` symbol it
    names.  A digit read from memory (a ``__constant__`` or global array)
    shows as one of those loads or symbols; the static ladder has none, and
    its calls equal :func:`descan_calls`.  Raises ValueError if the PTX
    holds no such function."""
    m = re.search(r"\.func\s+(\w*pow_descan\w*)\s*\([^)]*\)[^{;]*\{", ptx)
    if m is None:
        raise ValueError("the PTX holds no definition of tpn::pow_descan")
    end = ptx.find("\n}", m.end())
    body = ptx[m.end():end if end >= 0 else len(ptx)]
    calls = {"sqr": 0, "mul": 0, "other": 0}
    for callee in _PTX_CALL.findall(body):
        kind = re.match(r"_ZN3tpn3(sqr|mul)[EI]", callee)  # mul, or sqr<false>
        calls[kind.group(1) if kind else "other"] += 1
    symbols = set()
    for decl in _PTX_MODULE_DATA.findall(ptx):
        names = re.findall(r"(\w+)\s*(?:\[[^\]]*\])?\s*$", decl.strip())
        symbols.update(names)
    return {"function": m.group(1), "calls": calls,
            "memory_loads": [line.strip() for line in body.splitlines()
                             if _PTX_MEMORY_LOAD.search(line)],
            "data_symbols": sorted(name for name in symbols if name in body)}


_PTX_FUNCTION = re.compile(r"^[ \t]*(?:\.(?:visible|weak|extern)\s+)*\.(entry|func)\s+"
                           r"(?:\([^)]*\)\s*)?(\w+)", re.M)
_PTX_MMA = "mma.sync.aligned.m16n8k32"


def mma_ptx(ptx: str) -> dict:
    """The ``mma.sync.aligned.m16n8k32`` instructions in each function of
    a PTX text: ``{"entries": {name: count}, "funcs": {name: count}}`` over
    every ``.entry`` and ``.func`` it declares or defines, by mangled name.
    In ``csrc/diag.cu`` only ``field_mul_dot_kernel`` runs the tensor
    cores: its entry holds all 48 (the contraction is inlined; they are
    the body of its step loop) and no other function holds one."""
    found = {"entry": {}, "func": {}}
    heads = list(_PTX_FUNCTION.finditer(ptx))
    for head, nxt in zip(heads, heads[1:] + [None]):
        body = ptx[head.end():nxt.start() if nxt else len(ptx)]
        kind, name = head.group(1), head.group(2)
        found[kind][name] = found[kind].get(name, 0) + body.count(_PTX_MMA)
    return {"entries": found["entry"], "funcs": found["func"]}


#: The probes whose host check reads their inputs: how many limb rows lead them.
_LIMB_INPUTS = {"field_mul": 2, "field_mul_dot": 2, "field_mul_u32": 2, "lazy_reduce": 4,
                "table_build": 1, "select_tree": 1, "window5": 1}


def _host_check(name: str, out: torch.Tensor, inputs: tuple = ()) -> int:
    """Lanes (elements for trivial) whose result is wrong, checked with
    Python integers; field_mul, field_mul_dot, field_mul_u32, lazy_reduce,
    table_build, select_tree and window5 read their ``inputs``."""
    out = out.cpu().numpy()
    if name == "trivial":  # the input block is zeros: every element 1, the sum 1,024
        return int((out != 1).sum())
    if name in _LIMB_INPUTS:
        vals = [[F.from_limbs(c[:, i]) for i in range(out.shape[-1])]
                for c in (t.cpu().numpy() for t in inputs[:_LIMB_INPUTS[name]])]
        if name in ("field_mul", "field_mul_dot", "field_mul_u32"):
            want = [a * b for a, b in zip(*vals)]
        elif name == "lazy_reduce":
            want = [a * b + c * d for a, b, c, d in zip(*vals)]
        elif name == "table_build":
            want = [pow(a, 15, F.P) for a in vals[0]]
        else:
            digits = inputs[-1].cpu().tolist()
            g = WINDOW5_G if name == "window5" else 1
            want = [pow(a, d, F.P) * pow(g, d, F.P) for a, d in zip(vals[0], digits)]
        return sum(out[:, i].tolist() != F.to_limbs(v % F.P).tolist()
                   for i, v in enumerate(want))
    if name == "mixed_add":
        e = point_add(point_mul(7, GENERATOR), point_mul(11, GENERATOR))
        return sum(
            (F.from_limbs(out[0, :, i]) - e.x * F.from_limbs(out[2, :, i])) % F.P != 0
            or (F.from_limbs(out[1, :, i]) - e.y * F.from_limbs(out[2, :, i])) % F.P != 0
            for i in range(out.shape[-1]))
    one = F.to_limbs(1)
    return int((out != one[:, None]).any(axis=0).sum())


def run_probe(name: str, device) -> dict:
    """One probe on ``device``: its wrapper on the probe's inputs, checked
    on the host.  A failure is reported in the result, not raised."""
    t0 = time.perf_counter()
    try:
        inputs = probe_inputs(name, device)
        out = FUNCTIONS[name][0](*inputs)
        bad = _host_check(name, out, inputs)
        lanes = out.numel() if name == "trivial" else out.shape[-1]
        res = {"case": name, "ok": bad == 0, "lanes": lanes, "bad_lanes": bad}
    except Exception as e:  # noqa: BLE001 — a probe reports its fault and the next one runs
        res = {"case": name, "ok": False,
               "error": f"{type(e).__name__}: {e}"[:600],
               "traceback": traceback.format_exc()[-2000:]}
    res["s"] = time.perf_counter() - t0
    return res


def run(device: Optional[str] = None) -> dict:
    """Every probe on ``device`` (None: the card; a missing card raises)."""
    dev = resolve_device(device)
    return {"diag": "cuda" if dev.type == "cuda" else "plain",
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "cases": [run_probe(name, dev) for name in PROBES]}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpunode_torch.cuda_diag",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card; cpu runs the plain versions")
    res = run(ap.parse_args(argv).device)
    print(json.dumps(res), flush=True)
    return 0 if all(c["ok"] for c in res["cases"]) else 1


if __name__ == "__main__":
    sys.exit(main())
