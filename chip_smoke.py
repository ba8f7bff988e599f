#!/usr/bin/env python3
"""Smoke test of tpunode_torch on one NVIDIA card (run: ``python3 chip_smoke.py``).

Drives the port's main path — signature batches through ``VerifyEngine``
at the engine's real shapes (``device_batch=32768``, ``batch_size=4096``)
and the hand-written CUDA verify kernel — and checks it:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compiles the kernels from ``tpunode_torch/csrc`` with nvcc
   (``sm_90a``, one nvcc a source, started together) and prints ptxas's
   registers, shared memory, stack frame and spills for each of the verify
   kernel's 32 instantiations (the full and the ``schnorr_free`` variant at
   4-bit and at 5-bit windows, in the projective and the affine point form,
   with lazy and with eager reduction, with the tree and the one-hot table
   select) and for the nine probe kernels;
3. kernel vs plain: 512 adversarial lanes (valid lanes of every algorithm,
   bad s, z = 0, r+n, jacobi and parity twins, pubkeys off the curve, R at
   infinity) through every instantiation; the verdicts must equal the plain
   PyTorch version's on the card (in the same modes, select included) and
   the oracle's, and be the same in both forms, reductions and selects;
4. probes: ``tpunode_torch.cuda_diag.run()`` on the card, with its launch
   counts zeroed just before and read just after — the add-one floor, the
   eager construct (one reduced multiply), the lazy construct (two wide
   products, one loose reduction), the affine form's mixed add and batch
   inversion, the select tree, the one-hot windowed pow with its digits in
   global and in shared memory, and the 5-bit constructs, each against its
   host check — then each probe kernel against its plain version, timed
   beside its bound (and the add-one floor beside ``x + 1``);
5. main path: three chunks through the engine, with launch counts zeroed
   just before and read just after — 32,768 valid ECDSA and BIP340 items
   (the full variant), 4,096 valid ECDSA items (the ``schnorr_free``
   variant, ``batch_size``) and a ragged 1,000-item tail with every eighth
   item corrupted, through the async queue.  The traffic is synthetic
   (Bitcoin-shaped: no BCH Schnorr beside BIP340; the BIP340 share is
   chosen, not measured).  The verdicts must equal the native CPU
   verifier's, and the kernel must have been launched once per chunk at
   the engine's width, form, reduction and select.  The path runs through
   a 4-bit projective lazy tree engine, once more under ``torch.profiler``
   for the device's idle share and the time in each verify span, then
   through an engine of every other (width, form, reduction, select):
   ``window_bits=5``, ``point_form="affine"``, ``field_reduce="eager"``,
   and ``TPUNODE_SELECT16=onehot`` set while the engine is built (the
   engine reads that knob once, at construction); then twice more each
   unprofiled, in turns, for the end-to-end rate (the median of each
   engine's three runs);
6. kernel timing (:func:`kernel_timing`): both variants at 32,768 and 4,096
   lanes with CUDA events, every instantiation in turns (each one-hot one
   beside its tree twin, each eager pair beside the lazy pair of its width
   and form, then back in reverse order) on the same items, beside the
   count-based bound; every instantiation is held against the plain
   version at both lane counts, through one plain call per (variant,
   width, form, reduction) at 32,768 lanes that both selects and both lane
   counts share;
7. campaign: ``tpunode_torch.campaign.run_campaign(256, 2048)`` on the
   card at each width, form, reduction and select — 1,796 adversarial
   items over 21 shapes against the native CPU verifier and each shape's
   required verdict; any mismatch fails.

Every phase prints one JSON line.  The second-to-last line is the
``{"kernels": [...]}`` summary and the last is the ``{"ok": true, ...}``
line.  Any failure raises: the exit code is nonzero and no ``ok`` line is
printed.  Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter

SEED = 0x5EED
ADVERSARIAL_LANES = 512
BLOCK_ITEMS, MEMPOOL_ITEMS, TAIL_ITEMS = 32768, 4096, 1000
TAIL_CORRUPT_EVERY = 8
TIMED_LAUNCHES = 3
BURST_LAUNCHES = 20  # back to back, to read the SM clock under load
# Hopper issues 32-bit integer work on two pipes: the FMA pipe (IMAD, IMUL)
# and the ALU pipe (IADD3, LEA, LOP3, SHF, ISETP), 64 lanes per clock per
# SM each (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0), and its four schedulers dispatch one warp
# instruction each per clock: 128 lanes per clock per SM (NVIDIA H100
# architecture whitepaper, the SM's sub-partitions).
FMA_PIPE_OPS_PER_CLK_PER_SM = 64
ALU_PIPE_OPS_PER_CLK_PER_SM = 64
ISSUE_OPS_PER_CLK_PER_SM = 128
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
CAMPAIGN_BASE, CAMPAIGN_BATCH = 256, 2048  # 1,796 items over 21 shapes
# the pallas_call line of each probe's Mosaic counterpart in benchmarks/mosaic_diag.py
PROBE_PALLAS_LINES = {"trivial": 89, "field_mul": 114, "lazy_reduce": 538, "mixed_add": 300,
                      "batch_inv": 379, "select_tree": 496, "pow_window": 245,
                      "pow_window_smem": 245, "window5": 608}
SELECT_KNOB = "TPUNODE_SELECT16"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ---------- items from the port's own signers -----------------------------


def r_plus_n_items(O, rng: random.Random) -> list:
    """A valid ECDSA item whose x(R) lies in [n, p) — the r+n acceptance
    path — and its corrupted twin: pick R with x >= n, then solve for Q."""
    x = O.CURVE_N + rng.getrandbits(64)
    while True:
        y2 = (x * x * x + 7) % O.CURVE_P
        y = pow(y2, (O.CURVE_P + 1) // 4, O.CURVE_P)
        if y * y % O.CURVE_P == y2:
            break
        x += 1
    r, s, z = x - O.CURVE_N, rng.getrandbits(255) % O.CURVE_N or 1, rng.getrandbits(256)
    w = pow(s, -1, O.CURVE_N)
    u1, u2 = z * w % O.CURVE_N, r * w % O.CURVE_N
    minus_u1g = O.point_mul(O.CURVE_N - u1, O.GENERATOR)
    q = O.point_mul(pow(u2, -1, O.CURVE_N), O.point_add(O.Point(x, y), minus_u1g))
    return [(q, z, r, s), (q, z ^ 1, r, s)]


def adversarial_items(O, rng: random.Random, lanes: int = ADVERSARIAL_LANES) -> list:
    """``lanes`` items; every run of 17 holds each adversarial shape once
    (the first 16 hold all but the r+n path's corrupted twin)."""
    items = []
    while len(items) < lanes:
        priv = rng.getrandbits(256) % O.CURVE_N or 1
        pub = O.point_mul(priv, O.GENERATOR)
        z = rng.getrandbits(256)
        r, s = O.sign(priv, 0, rng.getrandbits(256))
        items.append((pub, 0, r, s))  # z = 0, valid
        r, s = O.sign(priv, z, rng.getrandbits(256))
        items += [(pub, z, r, s), (pub, z, r, s ^ 1),  # valid, bad s
                  (O.Point(5, 7), z, r, s),  # pubkey off the curve
                  (None, z, r, s), (O.Point(None, None), z, r, s),
                  (pub, z, 0, s), (pub, z, r, O.CURVE_N)]  # out of range
        # R = u1·G + u2·Q at infinity: Q = -(z / r)·G
        q = O.point_mul(-z * pow(r, -1, O.CURVE_N) % O.CURVE_N, O.GENERATOR)
        items.append((q, z, r, s))
        r, s = O.sign_schnorr(priv, z, rng.getrandbits(256))
        e = O.schnorr_challenge(r, pub, z)
        # the jacobi twin: R' = -R keeps x(R') = r with jacobi(y(R')) = -1
        items += [(pub, e, r, s, "schnorr"),
                  (pub, O.CURVE_N - e, r, O.CURVE_N - s, "schnorr"),
                  (pub, e ^ 1, r, s, "schnorr")]
        r, s = O.sign_bip340(priv, z, rng.getrandbits(256))
        lifted = O.lift_x(pub.x)
        e = O.bip340_challenge(r, pub.x, z)
        # the parity twin: R' = -R keeps x(R') = r with y(R') odd
        items += [(lifted, e, r, s, "bip340"),
                  (lifted, O.CURVE_N - e, r, O.CURVE_N - s, "bip340"),
                  (lifted, e ^ 1, r, s, "bip340")]
        items += r_plus_n_items(O, rng)
    return items[:lanes]


def btc_pool(O, rng: random.Random, groups: int, bip340: bool) -> list:
    """Valid Bitcoin-shaped items: each group signs three messages with one
    key by ECDSA and, if ``bip340``, one by BIP340 (a key-path spend)."""
    items = []
    for _ in range(groups):
        priv = rng.getrandbits(256) % O.CURVE_N or 1
        pub = O.point_mul(priv, O.GENERATOR)
        for _ in range(3):
            z = rng.getrandbits(256)
            items.append((pub, z, *O.sign(priv, z, rng.getrandbits(256))))
        if bip340:
            z = rng.getrandbits(256)
            r, s = O.sign_bip340(priv, z, rng.getrandbits(256))
            items.append((O.lift_x(pub.x), O.bip340_challenge(r, pub.x, z), r, s, "bip340"))
    return items


def corrupt_every(items: list, every: int) -> list:
    """Every ``every``-th item with its message (or challenge) flipped."""
    return [(it[0], it[1] ^ 1, *it[2:]) if i % every == every - 1 else it
            for i, it in enumerate(items)]


def tile(pool: list, n: int) -> list:
    return (pool * (n // len(pool) + 1))[:n]


# ---------- the count-based bound -----------------------------------------


def _ops(mul: int = 0, alu: int = 0, flex: int = 0) -> Counter:
    return Counter(mul=mul, alu=alu, flex=flex)


def _rep(k: int, ops: Counter) -> Counter:
    return Counter({kind: k * n for kind, n in ops.items()})


def kernel_ops_per_lane(window_bits: int = 4, point_form: str = "projective",
                        reduce: str = "lazy", select: str = "tree") -> dict:
    """int32 operations per lane that the kernel's source (csrc/*.cuh) does
    at ``window_bits`` in ``point_form`` with ``reduce``'s point formulas
    and ``select``'s table select, function by function, by the pipe that
    can issue them on Hopper:

    * ``mul``: a product of two limbs (IMAD, IMUL): FMA pipe only;
    * ``alu``: a mask, a compare, or a right shift with the add that takes
      it (LEA.HI with sign extension does both in one): ALU pipe only;
    * ``flex``: an add or subtract (a three-input sum is one IADD3) or a
      multiply by a constant with its add: either pipe (IADD3 or LEA on the
      ALU, IMAD on the FMA pipe), counted once even where it takes two.

    Moves, loads, stores, branches, address arithmetic and the calls' stack
    traffic are not counted, so the count is a floor.  The one part that
    depends on the data, negating a selected table entry, is added by
    :func:`kernel_ops`.  The width sets the table builds (2^wb - 2 adds,
    2^wb λ multiplies) and the window loop (``windows(wb)`` rounds
    of wb doublings, four adds and four digit masks); the pow ladders are
    4-bit at both widths.  The affine form adds the batch inversion
    (2^wb - 3 prefix multiplies, a Fermat ladder, three multiplies for each
    of the 2^wb - 2 suffix entries and 2^wb - 3 steps of the running
    inverse) and adds by mixed adds, with a digit-0 compare each; every
    window add is counted, a digit 0 included, since a warp issues it
    whenever one of its lanes needs it.  The eager bodies (curve.cuh
    ``*_eager``) reduce every product at once by ``mul``, ``mul_t`` or
    ``sqr_t``; the lazy ones share one loose reduction a coordinate.  The
    tree select is an indexed read (address arithmetic: not counted); the
    one-hot select (``select_entry``) does, for each of the 2^wb entries of
    each of the four selects a window, one compare for its mask and one
    AND-OR (LOP3) a word of the entry: ALU pipe."""
    from tpunode_torch.verify.width import windows as window_rounds

    NL, NW = 24, 47
    windows, entries = window_rounds(window_bits), 1 << window_bits

    def carry(n):  # n-1 masks and n-1 shift-adds
        return _ops(alu=2 * (n - 1))

    fold_top = carry(NL + 1) + _ops(flex=3)  # FOLD's third limb is 0
    conv = _ops(mul=NL * NL)
    sqr_conv = _ops(mul=NL * (NL + 1) // 2, flex=NL)  # and d = a + a
    rwl = (_rep(2, carry(NW + 1)) + _ops(flex=3 * NL) + _rep(2, carry(NL + 4))
           + _ops(flex=3 * 4) + carry(NL) + fold_top)
    tighten = carry(NL)
    mul_small_red = _ops(flex=NL) + fold_top
    mul_wide = _rep(2, carry(NL)) + conv
    mul = mul_wide + rwl + carry(NL)
    sqr = carry(NL) + sqr_conv + rwl + carry(NL)
    mul_t = conv + rwl + carry(NL)
    sqr_t = sqr_conv + rwl + carry(NL)
    tail = (mul_small_red + _rep(2, tighten) + _ops(flex=3 * NL) + _rep(3, tighten)
            + mul_small_red + tighten  # y3r
            + _rep(6, conv) + _ops(flex=3 * NW) + _rep(3, rwl))  # x3, y3, z3
    pt_add = (_rep(3, conv + rwl)  # t0, t1, t2
              + _rep(3, _ops(flex=3 * NL) + mul_wide + rwl)  # t3, t4, t5: sums in, IADD3 out
              + tail)
    pt_add_mixed = (_rep(4, conv + rwl)  # t0, t1, t4, t5
                    + _ops(flex=3 * NL) + mul_wide + rwl  # t3: sums in, IADD3 out
                    + _ops(flex=2 * NL)  # t4 + Y1, t5 + X1
                    + tail)
    pt_double = (sqr_conv + rwl + _ops(flex=NL) + tighten  # t0, 8Y^2
                 + conv + rwl  # t1
                 + sqr_conv + rwl + mul_small_red + tighten  # b3*Z^2
                 + _ops(flex=3 * NL) + tighten  # y3s; t0m is two IADD3s a limb
                 + conv + rwl  # z3
                 + _rep(2, conv) + _ops(flex=NW) + rwl  # y3
                 + _rep(2, conv + rwl)  # t1b, x3
                 + _ops(flex=NL))  # x3 + x3
    if reduce == "eager":
        # t0_3, z3 and t1m; the two b3 scalings; six muls and their three sums
        eager_tail = (_ops(flex=3 * NL) + _rep(2, mul_small_red) + _rep(6, mul)
                      + _ops(flex=3 * NL))
        pt_add = (_rep(3, mul_t)  # t0, t1, t2
                  + _rep(3, _ops(flex=3 * NL) + mul)  # t3, t4, t5: sums in, IADD3 out
                  + eager_tail)
        pt_add_mixed = (_rep(4, mul_t)  # t0, t1, t4, t5
                        + _ops(flex=3 * NL) + mul  # t3: sums in, IADD3 out
                        + _ops(flex=2 * NL)  # t4 + Y1, t5 + X1
                        + eager_tail)
        pt_double = (sqr_t + _ops(flex=NL)  # t0, 8Y^2
                     + mul_t + sqr_t + mul_small_red  # t1, b3*Z^2
                     + mul + _ops(flex=NL) + mul  # x3, y3 = t0 + t2, z3
                     + _ops(flex=2 * NL) + mul + _ops(flex=NL)  # t0 - 3*t2, y3, x3 + y3
                     + mul_t + mul + _ops(flex=NL))  # X*Y, x3, x3 + x3
    canonical = (fold_top + carry(NL) + _ops(flex=NL) + _rep(NL + 4, carry(NL + 1))
                 + _ops(alu=2, flex=3) + _rep(NL + 2, carry(NL))
                 + _rep(2, _ops(alu=2 * NL, flex=NL) + _rep(NL + 1, carry(NL))))
    is_zero = canonical + _ops(alu=NL)
    eq = _ops(flex=NL) + is_zero
    pow_const = _rep(14, mul) + _rep(64, _rep(4, sqr) + mul)
    tables = _rep(entries - 2, pt_add) + _rep(entries, mul)  # Q and λQ tables
    coords = 2 if point_form == "affine" else 3
    if point_form == "affine":
        tables += (_rep(entries - 3, mul) + pow_const  # prefix products, Fermat ladder
                   + _rep(3 * (entries - 2) + entries - 3, mul))  # suffix pass
        window_adds = _rep(4, pt_add_mixed) + _ops(alu=8)  # digit masks, digit-0 compares
    else:
        window_adds = _rep(4, pt_add) + _ops(alu=4)  # digit masks
    if select == "onehot":  # a mask compare an entry, a LOP3 a word of it
        window_adds += _ops(alu=4 * entries * (1 + coords * NL))
    ecdsa = (tables + _rep(windows, _rep(window_bits, pt_double) + window_adds)
             + is_zero + _rep(2, mul + eq) + _rep(2, sqr) + mul + _ops(flex=1) + eq)
    full = ecdsa + mul + pow_const + eq + pow_const + mul + canonical + _ops(alu=1)
    return {"schnorr_free": ecdsa, "full": full, "pt_add": pt_add,
            "pt_add_mixed": pt_add_mixed, "pt_double": pt_double, "mul": mul, "sqr": sqr,
            "mul_t": mul_t, "sqr_t": sqr_t, "reduce_wide_loose": rwl, "pow_const": pow_const,
            "canonical": canonical}


def noinline_calls_per_lane(window_bits: int = 4, point_form: str = "projective",
                            reduce: str = "lazy") -> dict:
    """Calls of the kernel's ``__noinline__`` functions a lane makes (each
    passes its operands through the thread's stack), counted from the
    source as :func:`kernel_ops_per_lane` counts operations: ``mul``,
    ``mul_t``, ``sqr`` and ``sqr_t`` are three calls (with their
    convolution and reduction); the lazy ``pt_add`` 22 (itself, 12
    convolutions, 9 loose reductions), ``pt_add_mixed`` 20, ``pt_double``
    16; the eager ones one and three for each of their 12, 11 and 8
    products: 37, 34, 25; ``pow_const`` 1 + 14 muls + 64 windows of four
    squarings and a mul, ``canonical`` one.  Both table selects are
    inlined: the count is the same for each."""
    from tpunode_torch.verify.width import windows as window_rounds

    windows, entries = window_rounds(window_bits), 1 << window_bits
    mul = sqr = 3
    if reduce == "eager":
        pt_add, pt_add_mixed, pt_double = 1 + 12 * mul, 1 + 11 * mul, 1 + 8 * mul
    else:
        pt_add, pt_add_mixed, pt_double = 22, 20, 16
    pow_const = 1 + 14 * mul + 64 * (4 * sqr + mul)
    tables = (entries - 2) * pt_add + entries * mul
    add = pt_add
    if point_form == "affine":
        tables += (entries - 3) * mul + pow_const + (4 * (entries - 2) - 1) * mul
        add = pt_add_mixed
    tail = 1 + 2 * (mul + 1) + 2 * sqr + mul + 1  # is_zero, m1, m2, on-curve
    ecdsa = tables + windows * (window_bits * pt_double + 4 * add) + tail
    return {"schnorr_free": ecdsa, "full": ecdsa + 2 * (mul + pow_const) + 2}


def kernel_ops(lanes: int, negated: int, schnorr_free: bool, window_bits: int = 4,
               point_form: str = "projective", reduce: str = "lazy",
               select: str = "tree") -> Counter:
    """The kernel's int32 operations for one launch over ``lanes`` lanes
    whose sign flags hold ``negated`` set bits: each set bit negates the Y
    of one selected table entry in each window (33 at 4-bit, 27 at 5)."""
    from tpunode_torch.verify.width import windows

    per_lane = kernel_ops_per_lane(window_bits, point_form, reduce, select)[
        "schnorr_free" if schnorr_free else "full"]
    return _rep(lanes, per_lane) + _ops(flex=negated * windows(window_bits) * 24)


def _tree_ops(entries: int) -> Counter:
    """The probes' branch-free select tree over ``entries`` entries: a mask
    a level (a shift and an AND, then a negate) and, for each of its
    entries - 1 selects, one LOP3 a word for (odd & m) | (even & ~m)."""
    levels = entries.bit_length() - 1
    return _ops(alu=levels * 3 + (entries - 1) * 24)


def probe_ops_per_lane(probe: str) -> Counter:
    """int32 operations per lane (per element for trivial) of a probe kernel
    (csrc/diag.cu), counted as :func:`kernel_ops_per_lane` counts: one add
    (trivial); one ``mul`` and the canonical form (field_mul); two
    convolutions, their 47 sums, one loose reduction and the canonical form
    (lazy_reduce); one lazy mixed add; the batch inversion's 13 column
    and 13 prefix multiplies, the Fermat ladder, the suffix step's two
    multiplies and the canonical form (batch_inv); the 14 table multiplies,
    the 16-entry tree and the canonical form (select_tree); the 14 table
    multiplies, 64 windows of four squarings, a one-hot select (a compare
    and 24 LOP3s an entry) and a multiply, and the canonical form (both
    pow_window cases); or the 30 table multiplies, two 32-entry trees, one
    multiply and the canonical form (window5)."""
    ops = kernel_ops_per_lane()
    if probe == "trivial":
        return _ops(flex=1)
    if probe == "field_mul":
        return ops["mul"] + ops["canonical"]
    if probe == "lazy_reduce":
        return (_ops(mul=2 * 24 * 24, flex=2 * 24 - 1) + ops["reduce_wide_loose"]
                + ops["canonical"])
    if probe == "mixed_add":
        return ops["pt_add_mixed"]
    if probe == "select_tree":
        return _rep(14, ops["mul"]) + _tree_ops(16) + ops["canonical"]
    if probe in ("pow_window", "pow_window_smem"):
        window = _rep(4, ops["sqr"]) + _ops(alu=16 * (1 + 24)) + ops["mul"]
        return _rep(14, ops["mul"]) + _rep(64, window) + ops["canonical"]
    if probe == "window5":
        return _rep(31, ops["mul"]) + _rep(2, _tree_ops(32)) + ops["canonical"]
    return _rep(13 + 13 + 2, ops["mul"]) + ops["pow_const"] + ops["canonical"]


#: Rows of 24 limbs a probe lane reads and writes.
_PROBE_ROWS = {"field_mul": 2 + 1, "lazy_reduce": 4 + 1, "mixed_add": 4 + 3, "batch_inv": 1 + 1,
               "select_tree": 1 + 1, "pow_window": 1 + 1, "pow_window_smem": 1 + 1,
               "window5": 1 + 1}


def probe_bytes(probe: str, lanes: int) -> int:
    """Bytes a probe must move over ``lanes`` lanes (elements for trivial):
    its inputs read once, its output written once (trivial: one int32 in
    and one out an element; the others their limb rows, with select_tree's
    and window5's int32 digit a lane, the pow_window cases' (2, 64) int32
    digit rows, and window5's (32, 24) int32 shared table)."""
    if probe == "trivial":
        return lanes * 2 * 4
    rows = lanes * _PROBE_ROWS[probe] * 24 * 4
    if probe in ("select_tree", "window5"):
        rows += lanes * 4
    if probe in ("pow_window", "pow_window_smem"):
        rows += 2 * 64 * 4
    if probe == "window5":
        rows += 32 * 24 * 4
    return rows


def verify_bytes(lanes: int, window_bits: int = 4, point_form: str = "projective") -> int:
    """Bytes a verify launch must move: its inputs read once (digit rows of
    the width, limb rows, flags and the G / λG tables of the form) and its
    verdicts written once."""
    from tpunode_torch.verify.width import windows

    coords = 2 if point_form == "affine" else 3
    return (lanes * (4 * windows(window_bits) * 4 + 4 * 24 * 4 + 8)
            + 2 * (1 << window_bits) * coords * 24 * 4 + lanes)


def select_bytes(lanes: int, window_bits: int = 4, point_form: str = "projective",
                 select: str = "tree") -> dict:
    """Bytes a launch's window loop reads to select its table entries: the
    per-lane Q / λQ tables in local memory and the block's G / λG in shared
    memory, two selects of each a window.  The tree form reads the selected
    entry, the one-hot form every entry.  Not part of the bound (each input
    is counted once there, as :func:`verify_bytes` counts it): what the
    two selects move beside it."""
    from tpunode_torch.verify.width import windows

    coords = 2 if point_form == "affine" else 3
    read = (1 << window_bits) if select == "onehot" else 1
    per_table = lanes * windows(window_bits) * read * coords * 24 * 4
    return {"local": 2 * per_table, "shared": 2 * per_table}


def least_ms(ops: Counter, nbytes: int, sm_count: int, sm_clock_mhz: float) -> tuple:
    """(least ms, what bounds it): ``ops`` over the card's integer rates —
    each pipe's own and the issue rate of both together — or ``nbytes`` over
    HBM bandwidth, whichever is longer."""
    clocks = max(ops["mul"] / FMA_PIPE_OPS_PER_CLK_PER_SM,
                 ops["alu"] / ALU_PIPE_OPS_PER_CLK_PER_SM,
                 sum(ops.values()) / ISSUE_OPS_PER_CLK_PER_SM)
    ops_s = clocks / (sm_count * sm_clock_mhz * 1e6)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return (ops_s * 1e3, "operations") if ops_s >= bytes_s else (bytes_s * 1e3, "bytes")


def bound_ms(ops: Counter, lanes: int, sm_count: int, sm_clock_mhz: float,
             window_bits: int = 4, point_form: str = "projective") -> tuple:
    """(least ms, what bounds it) for one verify launch over ``lanes``."""
    return least_ms(ops, verify_bytes(lanes, window_bits, point_form), sm_count, sm_clock_mhz)


def timed_ms(torch, fn, repeats: int) -> float:
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def trace_breakdown(path: str) -> dict:
    """From a Chrome trace of one main-path run (``torch.profiler``): the
    window (the ``main_path`` range), the device's busy time inside it (the
    union of its kernels, copies and sets), the verify kernel's launches and
    device time, and the host time in each ``verify.*`` span."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    window = next(e for e in events
                  if e["name"] == "main_path" and e.get("cat") == "user_annotation")
    lo, hi = window["ts"], window["ts"] + window["dur"]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, lo
    for a, b in device:
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    kernels = [e["dur"] for e in events
               if e.get("cat") == "kernel" and "verify_kernel" in e["name"]]
    spans = Counter()
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("verify."):
            spans[e["name"]] += e["dur"] / 1e3
    return {"window_ms": window["dur"] / 1e3, "device_events": len(device),
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1 - busy / window["dur"] if device else None,
            "verify_kernel_launches": len(kernels), "verify_kernel_ms": sum(kernels) / 1e3,
            "span_ms": dict(spans)}


def ptxas_entries(log: str) -> dict:
    """Registers, shared memory, stack frame and spills of each
    instantiation of ``verify_kernel`` in nvcc's ``-Xptxas -v`` output,
    keyed ``"<variant>/w<bits>/<form>/<reduce>/<select>"``
    (``full/w4/projective/lazy/tree`` ..
    ``schnorr_free/w5/affine/eager/onehot``), and of each probe kernel,
    keyed by the probe (``trivial`` .. ``window5``)."""
    found, current = {}, None
    for line in log.splitlines():
        if m := re.search(r"(?:Compiling entry function '|Function properties for )(\w+)",
                          line):
            current = m.group(1)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            found.setdefault(current, {}).update(
                stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        elif m := re.search(r"Used (\d+) registers", line):
            smem = re.search(r"(\d+) bytes smem", line)
            found.setdefault(current, {}).update(
                registers=int(m.group(1)), smem=int(smem.group(1)) if smem else 0)
    out = {}
    for name, info in found.items():
        if m := re.search(r"verify_kernelILb([01])ELi([45])ELb([01])ELb([01])ELb([01])E",
                          name or ""):
            variant = "schnorr_free" if m.group(1) == "1" else "full"
            form = "affine" if m.group(3) == "1" else "projective"
            reduce = "eager" if m.group(4) == "1" else "lazy"
            select = "onehot" if m.group(5) == "1" else "tree"
            out[f"{variant}/w{m.group(2)}/{form}/{reduce}/{select}"] = info
        elif m := re.search(r"(trivial|field_mul|lazy_reduce|mixed_add|batch_inv|select_tree"
                            r"|pow_window_smem|pow_window|window5)_kernel", name or ""):
            out[m.group(1)] = info
    return out


# ---------- the phases ------------------------------------------------------


def instantiations(widths, forms) -> list:
    """Every verify kernel instantiation's (width, form, reduce, select)
    but the variant: the forms in turn, the widths within each, the eager
    pair right after the lazy pair of its width and form, and each one-hot
    instantiation right after its tree twin."""
    return [(wb, form, reduce, select) for form in forms for wb in widths
            for reduce in ("lazy", "eager") for select in ("tree", "onehot")]


@contextlib.contextmanager
def select_knob(value: str):
    """``TPUNODE_SELECT16`` set to ``value`` inside, restored on exit."""
    prev = os.environ.get(SELECT_KNOB)
    os.environ[SELECT_KNOB] = value
    try:
        yield
    finally:
        if prev is None:
            del os.environ[SELECT_KNOB]
        else:
            os.environ[SELECT_KNOB] = prev


def plain_lanes(out, lanes: int):
    """The first ``lanes`` verdicts of a plain output: what a launch over the
    first ``lanes`` items of the same batch must return, since a lane's
    verdict depends on that lane alone."""
    return out[:lanes]


def kernel_timing(cases, kinds, make_args, launch, plain, timed, on_row=None,
                  lane_counts=(BLOCK_ITEMS, MEMPOOL_ITEMS)) -> dict:
    """Phase 6, the kernel alone.  For each ``(variant, items)`` of
    ``cases`` and each lane count, every instantiation of ``kinds`` (from
    :func:`instantiations`) is warmed, timed in turns on the same
    arguments (``kinds``, then back in reverse order), then held against
    the plain version; a difference raises.  The plain version runs once for
    each (variant, width, form, reduce), at the first lane count, which
    must be the largest, in the select of the first kind of that
    (width, form, reduce); every launch of that (variant, width, form,
    reduce), at either select and any lane count, is compared with that
    output's first ``lanes`` lanes (:func:`plain_lanes`: a lane's verdict
    depends on that lane alone, and the select moves no value).  No
    condition skips a comparison: every (variant, lanes, width, form,
    reduce, select) key is compared.

    ``make_args(items, lanes, wb, variant)`` gives ``(args, schnorr_free)``;
    ``launch`` and ``plain``, called ``(args, schnorr_free, form, reduce,
    select)``, give verdict tensors; ``timed(fn, repeats)`` gives ms a
    call.  ``on_row(row, args, schnorr_free)`` adds the card's readings.
    Returns the rows keyed ``(wb, form, reduce, select, variant, lanes)``."""
    if list(lane_counts) != sorted(lane_counts, reverse=True):
        raise ValueError(f"lane counts {lane_counts}: the first must be the largest")
    rows = {}
    widths = tuple(dict.fromkeys(kind[0] for kind in kinds))
    for variant, items in cases:
        shared = {}  # (wb, form, reduce) -> (plain output, ms, its select, its lanes)
        for lanes in lane_counts:
            args = {wb: make_args(items[:lanes], lanes, wb, variant) for wb in widths}
            for wb, form, reduce, select in kinds:  # warm
                launch(*args[wb], form, reduce, select)
            runs = {kind: [] for kind in kinds}
            for kind in kinds + kinds[::-1]:
                wb, form, reduce, select = kind
                runs[kind].append(timed(lambda: launch(*args[wb], form, reduce, select),
                                        TIMED_LAUNCHES))
            for kind in kinds:
                wb, form, reduce, select = kind
                got = launch(*args[wb], form, reduce, select)
                if kind[:3] not in shared:
                    out = [None]
                    ms = timed(lambda: out.__setitem__(
                        0, plain(*args[wb], form, reduce, select)), 1)
                    shared[kind[:3]] = out[0], ms, select, lanes
                out, plain_ms, plain_select, plain_at = shared[kind[:3]]
                err = int((got.int() - plain_lanes(out, lanes).int()).abs().max())
                if err:
                    raise RuntimeError(f"{variant}/w{wb}/{form}/{reduce}/{select}: kernel and "
                                       f"plain version disagree at {lanes} lanes")
                row = {"variant": variant, "lanes": lanes, "window_bits": wb,
                       "point_form": form, "reduce": reduce, "select": select,
                       "ms": sum(runs[kind]) / 2, "ms_runs": runs[kind], "plain_ms": plain_ms,
                       "plain_of": f"{variant}/w{wb}/{form}/{reduce}/{plain_select} at "
                                   f"{plain_at} lanes",
                       "plain_shared": (plain_select, plain_at) != (select, lanes),
                       "max_abs_err": err}
                if on_row is not None:
                    on_row(row, *args[wb])
                rows[(*kind, variant, lanes)] = row
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tpunode_torch import cuda_diag
    from tpunode_torch.campaign import run_campaign
    from tpunode_torch.verify import cuda_kernel
    from tpunode_torch.verify import ecdsa_cpu as O
    from tpunode_torch.verify import kernel as K
    from tpunode_torch.verify.cpu_native import load_native_verifier
    from tpunode_torch.verify.curve import POINT_FORMS
    from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine
    from tpunode_torch.verify.raw import concat_raw, pack_items

    widths, variants = tuple(K.WINDOWS_BY_BITS), cuda_kernel.VARIANTS
    # (4,P,lazy,tree) (4,P,lazy,onehot) (4,P,eager,tree) .. (5,A,eager,onehot)
    kinds = instantiations(widths, POINT_FORMS)

    def reset_launches() -> None:
        for key in cuda_kernel.LAUNCHES:
            cuda_kernel.LAUNCHES[key] = 0

    def name(kind: tuple, variant: str) -> str:
        return f"{variant}/w{kind[0]}/{kind[1]}/{kind[2]}/{kind[3]}"

    # 1. device
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    sm_clock = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    sm_count = props.multi_processor_count
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "sm_count": sm_count, "sm_clock_max_mhz": sm_clock})

    # 2. build: the verify kernel's 32 instantiations and the nine probes
    t0 = time.perf_counter()
    lib_paths = cuda_kernel.build()
    ptxas = ptxas_entries(cuda_kernel.BUILD_LOG)
    want = {name(kind, v) for v in variants for kind in kinds} | set(cuda_diag.PROBES)
    keys = {"registers", "smem", "stack_frame", "spill_stores", "spill_loads"}
    if set(ptxas) != want or any(set(info) != keys for info in ptxas.values()):
        raise RuntimeError(f"ptxas reported {ptxas}, expected {sorted(keys)} for each "
                           f"of {sorted(want)}:\n{cuda_kernel.BUILD_LOG[-4000:]}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: v.rsplit("/", 1)[-1] for k, v in lib_paths.items()},
          "ptxas": ptxas})

    # 3. kernel vs plain version: every instantiation on adversarial lanes,
    #    each against the plain version in its own modes; the verdicts must
    #    be the same in both forms, reductions and selects
    rng = random.Random(SEED)
    max_err = {(*kind, v): 0 for kind in kinds for v in variants}
    adv = adversarial_items(O, rng)
    ecdsa_adv = tile([it for it in adv if len(it) == 4], ADVERSARIAL_LANES)
    cases = [("full", adv, O.verify_batch_cpu(adv)),
             ("schnorr_free", ecdsa_adv, O.verify_batch_cpu(ecdsa_adv))]
    for wb in widths:
        for variant, items, oracle in cases:
            prep = K.prepare_batch_raw(pack_items(items), pad_to=len(items), window_bits=wb)
            if prep.schnorr_free != (variant == "schnorr_free") or prep.window_bits != wb:
                raise RuntimeError(f"{variant}/w{wb}: the batch selects another kernel")
            args = K.from_reference(prep.device_args, "cuda")
            verdicts = {}
            for kind in (kind for kind in kinds if kind[0] == wb):
                _, form, reduce, select = kind
                got = cuda_kernel.verify_blocked(*args, schnorr_free=prep.schnorr_free,
                                                 point_form=form, reduce=reduce, select=select)
                out = [None]
                plain_ms = timed_ms(torch, lambda: out.__setitem__(0, K.verify_core(
                    *args, schnorr_free=prep.schnorr_free, point_form=form, reduce=reduce,
                    select=select)), 1)
                err = int((got.int() - out[0].int()).abs().max())
                max_err[(*kind, variant)] = err
                verdicts[kind[1:]] = got.tolist()
                if err or verdicts[kind[1:]] != oracle:
                    raise RuntimeError(f"{name(kind, variant)}: kernel {err} lanes off the "
                                       f"plain version, oracle agrees: "
                                       f"{verdicts[kind[1:]] == oracle}")
                emit({"phase": "kernel_vs_plain", "variant": variant, "window_bits": wb,
                      "point_form": form, "reduce": reduce, "select": select,
                      "lanes": len(items), "valid": sum(oracle), "max_abs_err": err,
                      "plain_ms": plain_ms,
                      "equals_tree": verdicts[kind[1:]] == verdicts[(form, reduce, "tree")],
                      "equals_lazy": verdicts[kind[1:]] == verdicts[(form, "lazy", select)],
                      "equals_projective": verdicts[kind[1:]]
                      == verdicts[("projective", reduce, select)]})
            if len({tuple(v) for v in verdicts.values()}) != 1:
                raise RuntimeError(f"{variant}/w{wb}: the forms', reductions' or selects' "
                                   f"verdicts differ")

    # 4. the probes: their entry point with the counts zeroed around it, then
    #    each kernel against its plain version and timed (the add-one floor
    #    beside the one PyTorch call that computes it)
    for probe in cuda_diag.PROBES:
        cuda_diag.LAUNCHES[probe] = 0
    diag = cuda_diag.run()
    probe_launches = dict(cuda_diag.LAUNCHES)
    if not all(c["ok"] for c in diag["cases"]) or min(probe_launches.values()) < 1:
        raise RuntimeError(f"probes: {diag['cases']}, launches {probe_launches}")
    probes = {}
    for case in diag["cases"]:
        probe, lanes = case["case"], case["lanes"]
        fn, plain_fn = cuda_diag.FUNCTIONS[probe]
        inputs = cuda_diag.probe_inputs(probe, "cuda")
        got = fn(*inputs)
        plain = [None]
        plain_ms = timed_ms(torch, lambda: plain.__setitem__(0, plain_fn(*inputs)), 1)
        err = int((got - plain[0]).abs().max())
        fn(*inputs)  # warm
        row = {"probe": probe, "lanes": lanes, "launches": probe_launches[probe],
               "host_check_bad_lanes": case["bad_lanes"], "max_abs_err": err,
               "ms": timed_ms(torch, lambda: fn(*inputs), TIMED_LAUNCHES), "plain_ms": plain_ms,
               "library_ms": None}
        if probe == "trivial":
            (x,) = inputs
            x + 1  # warm
            row["library_ms"] = timed_ms(torch, lambda: x + 1, TIMED_LAUNCHES)
        row["bound_ms"], row["bound_by"] = least_ms(
            _rep(lanes, probe_ops_per_lane(probe)), probe_bytes(probe, lanes), sm_count,
            sm_clock)
        if err:
            raise RuntimeError(f"probe {probe}: kernel and plain version differ by {err}")
        probes[probe] = row
        emit({"phase": "probe", "card": card, **row})

    # 5. the main path: the engine at its real shapes, at each width, form,
    #    reduction and select
    block = tile(btc_pool(O, rng, 96, bip340=True), BLOCK_ITEMS)
    mempool = tile(btc_pool(O, rng, 64, bip340=False), MEMPOOL_ITEMS)
    tail = corrupt_every(tile(btc_pool(O, rng, 32, bip340=True), TAIL_ITEMS),
                         TAIL_CORRUPT_EVERY)
    raw = concat_raw([pack_items(block), pack_items(mempool), pack_items(tail)])
    cpu = load_native_verifier().verify_raw(raw)
    if sum(cpu) != len(raw) - TAIL_ITEMS // TAIL_CORRUPT_EVERY:
        raise RuntimeError(f"main path: {sum(cpu)} valid of {len(raw)}, expected every "
                           f"item but the tail's corrupted ones to be valid")

    def main_path(engine) -> list:
        async def submit_tail() -> list:
            async with engine:
                return await engine.verify(tail)

        verdicts = engine.verify_sync(block) + engine.verify_sync(mempool)
        return verdicts + asyncio.run(submit_tail())

    def drive(engine) -> tuple:
        """Zero every launch count, run the main path once through
        ``engine`` and read the counts: (verdicts, seconds, launches by
        variant at the engine's width, form, reduction and select)."""
        kind = (engine.cfg.window_bits, engine.cfg.point_form, engine.cfg.field_reduce,
                engine.select)
        reset_launches()
        t0 = time.perf_counter()
        verdicts = main_path(engine)
        seconds = time.perf_counter() - t0
        launches = dict(cuda_kernel.LAUNCHES)
        mismatches = sum(a != b for a, b in zip(verdicts, cpu))
        if len(verdicts) != len(raw) or mismatches:
            raise RuntimeError(f"main path {kind}: {len(verdicts)} verdicts for {len(raw)} "
                               f"items, {mismatches} mismatches against the native CPU "
                               f"verifier")
        # 32,768 and the tail are full-variant chunks, 4,096 ECDSA schnorr_free
        expect = {key: 0 for key in launches}
        expect[(*kind, "full")], expect[(*kind, "schnorr_free")] = 2, 1
        if launches != expect:
            raise RuntimeError(f"main path {kind} launched {launches}, expected 3 at {kind}")
        return verdicts, seconds, {v: launches[(*kind, v)] for v in variants}

    engines = {}
    for kind in kinds:
        wb, form, reduce, select = kind
        with select_knob(select):  # the engine reads the knob once, here
            engines[kind] = VerifyEngine(VerifyConfig(
                device_batch=BLOCK_ITEMS, batch_size=MEMPOOL_ITEMS, window_bits=wb,
                point_form=form, field_reduce=reduce))
        if engines[kind].select != select:
            raise RuntimeError(f"engine {kind}: built under {SELECT_KNOB}={select}, "
                               f"runs {engines[kind].select}")
    first = kinds[0]  # (4, projective, lazy, tree)
    verdicts, e2e_s, launches0 = drive(engines[first])
    # the first engine's path once more, under the profiler
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function("main_path"):
                traced = main_path(engines[first])
        prof.export_chrome_trace(os.path.join(tmp, "main_path.json"))
        trace = trace_breakdown(os.path.join(tmp, "main_path.json"))
    if traced != verdicts:
        raise RuntimeError("main path: the traced run's verdicts differ from the first run's")
    e2e = {first: [e2e_s]}
    launches = {first: launches0}
    for kind in kinds[1:]:
        got, e2e_s, launches[kind] = drive(engines[kind])
        if got != verdicts:
            raise RuntimeError(f"main path {kind}: verdicts differ from the {first} path's")
        e2e[kind] = [e2e_s]
    # unprofiled end to end, in turns after the counted runs
    for kind in kinds[::-1] + kinds:
        t0 = time.perf_counter()
        if main_path(engines[kind]) != verdicts:
            raise RuntimeError(f"main path {kind}: a repeated run's verdicts differ")
        e2e[kind].append(time.perf_counter() - t0)
    for kind in kinds:
        runs = e2e[kind]
        e2e_s = sorted(runs)[len(runs) // 2]
        emit({"phase": "main_path", "card": card, "window_bits": kind[0],
              "point_form": kind[1], "reduce": kind[2], "select": kind[3], "items": len(raw),
              "valid": sum(cpu), "chunks": 3, "launches": launches[kind], "mismatches": 0,
              "equals_tree_twin": True, "e2e_seconds": e2e_s,
              "e2e_sigs_per_s": len(raw) / e2e_s, "e2e_seconds_runs": runs,
              **({"traced": trace} if kind == first else {})})

    # 6. the kernel alone: both variants at both device shapes, every
    #    instantiation timed in turns (each one-hot one beside its tree twin)
    #    and held against the plain version, one plain call per (variant,
    #    width, form, reduction) at 32,768 lanes
    def make_args(items, lanes, wb, variant) -> tuple:
        prep = K.prepare_batch_raw(pack_items(items), pad_to=lanes, window_bits=wb)
        if prep.schnorr_free != (variant == "schnorr_free"):
            raise RuntimeError(f"{variant}: the batch selects the other variant")
        return K.from_reference(prep.device_args, "cuda"), prep.schnorr_free

    def launch(args, sf, form, reduce, select):
        return cuda_kernel.verify_blocked(*args, schnorr_free=sf, point_form=form,
                                          reduce=reduce, select=select)

    def plain_version(args, sf, form, reduce, select):
        return K.verify_core(*args, schnorr_free=sf, point_form=form, reduce=reduce,
                             select=select)

    def on_row(row, args, sf) -> None:
        wb, form, reduce, select, lanes = (row[k] for k in (
            "window_bits", "point_form", "reduce", "select", "lanes"))
        negated = sum(int(t.sum()) for t in args[4:8])
        row["bound_ms"], row["bound_by"] = bound_ms(
            kernel_ops(lanes, negated, sf, wb, form, reduce, select), lanes, sm_count,
            sm_clock, wb, form)
        row["calls_per_lane"] = noinline_calls_per_lane(wb, form, reduce)[row["variant"]]
        row["select_read_bytes"] = select_bytes(lanes, wb, form, select)
        if lanes == BLOCK_ITEMS:
            for _ in range(BURST_LAUNCHES):
                launch(args, sf, form, reduce, select)
            row["under_load"] = nvidia_smi("clocks.sm,power.draw")
            torch.cuda.synchronize()
        emit({"phase": "kernel_timing", "card": card, **row})

    rows = kernel_timing([("full", block), ("schnorr_free", tile(mempool, BLOCK_ITEMS))],
                         kinds, make_args, launch, plain_version,
                         lambda fn, repeats: timed_ms(torch, fn, repeats), on_row)
    for (*kind, variant, _), row in rows.items():
        key = (*kind, variant)
        max_err[key] = max(max_err[key], row["max_abs_err"])

    # 7. the adversarial campaign on the card, at each width, form,
    #    reduction and select
    for wb, form, reduce, select in kinds:
        with select_knob(select):
            res = run_campaign(CAMPAIGN_BASE, CAMPAIGN_BATCH, window_bits=wb, point_form=form,
                               field_reduce=reduce)
        if (res["mismatches"] or res["kernel"] != "cuda" or res["launches"] < 1
                or res["select"] != select):
            raise RuntimeError(f"campaign w{wb}/{form}/{reduce}/{select}: {res['mismatches']} "
                               f"mismatches on {res['kernel']} ({res['launches']} launches, "
                               f"select {res['select']}): {res['mismatch_detail']}")
        emit({"phase": "campaign", "card": card,
              **{k: res[k] for k in ("window_bits", "point_form", "field_reduce", "select",
                                     "items", "mismatches", "batch", "launches", "gen_s",
                                     "run_s", "tally")}})

    # 8. summary: one entry for each kernel — the verify kernel's 32
    #    instantiations at the main path's 32,768-lane shape (4,096 beside
    #    it), then the nine probe cases
    kernels = []
    for kind in kinds:
        wb, form, reduce, select = kind
        for variant in variants:
            main, small = rows[(*kind, variant, BLOCK_ITEMS)], rows[(*kind, variant, MEMPOOL_ITEMS)]
            kernels.append({
                "name": f"verify_kernel<{variant}, w{wb}, {form}, {reduce}, {select}>",
                "route": "cuda",
                "source": "tpunode_torch/csrc/verify_kernel.cu",
                "replaces": "tpunode/verify/pallas_kernel.py:526",
                "launches": launches[kind][variant],
                "max_abs_err": max_err[(*kind, variant)],
                "ms": main["ms"],
                "plain_ms": main["plain_ms"],
                "plain_of": main["plain_of"],
                "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"],
                "library_ms": None,
                "window_bits": wb,
                "point_form": form,
                "reduce": reduce,
                "select": select,
                "variant": variant,
                "lanes": BLOCK_ITEMS,
                "at_4096": {k: small[k] for k in ("ms", "bound_ms", "plain_ms", "plain_of",
                                                  "max_abs_err")},
            })
    for probe in cuda_diag.PROBES:
        row = probes[probe]
        kernels.append({
            "name": f"cuda_diag.{probe}",
            "route": "cuda",
            "source": "tpunode_torch/csrc/diag.cu",
            "replaces": f"benchmarks/mosaic_diag.py:{PROBE_PALLAS_LINES[probe]}",
            **{k: row[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "lanes")},
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
