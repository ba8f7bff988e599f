#!/usr/bin/env python3
"""Smoke test of tpunode_torch on one NVIDIA card (run: ``python3 chip_smoke.py``).

Drives the port's main path — signature batches through ``VerifyEngine``
at the engine's real shapes (``device_batch=32768``, ``batch_size=4096``)
and the hand-written CUDA verify kernel — and checks it:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compiles the kernels from ``tpunode_torch/csrc`` with nvcc
   (``sm_90a``, one nvcc a source, started together) and prints ptxas's
   registers, shared memory, stack frame and spills for each of the verify
   kernel's eight instantiations (the full and the ``schnorr_free``
   variant at 4-bit and at 5-bit windows, in the projective and the affine
   point form) and for the two probe kernels;
3. kernel vs plain: 512 adversarial lanes (valid lanes of every algorithm,
   bad s, z = 0, r+n, jacobi and parity twins, pubkeys off the curve, R at
   infinity) through both kernel variants at both widths in both forms; the
   verdicts must equal the plain PyTorch version's on the card and the
   oracle's, and the affine kernel's the projective kernel's;
4. probes: ``tpunode_torch.cuda_diag.run()`` on the card, with its launch
   counts zeroed just before and read just after — the mixed add and the
   batch inversion of the affine form, each against its host check — then
   each probe kernel against its plain version, timed beside its bound;
5. main path: three chunks through the engine, with launch counts zeroed
   just before and read just after — 32,768 valid ECDSA and BIP340 items
   (the full variant), 4,096 valid ECDSA items (the ``schnorr_free``
   variant, ``batch_size``) and a ragged 1,000-item tail with every eighth
   item corrupted, through the async queue.  The traffic is synthetic
   (Bitcoin-shaped: no BCH Schnorr beside BIP340; the BIP340 share is
   chosen, not measured).  The verdicts must equal the native CPU
   verifier's, and the kernel must have been launched once per chunk at
   the engine's width and form.  The path runs through a 4-bit projective
   engine, once more under ``torch.profiler`` for the device's idle share
   and the time in each verify span, then through a 5-bit engine
   (``window_bits=5``) and a 4-bit and a 5-bit affine engine
   (``point_form="affine"``), then twice more each unprofiled, in turns,
   for the end-to-end rate (the median of each engine's three runs);
6. kernel timing: both variants at 32,768 and 4,096 lanes with CUDA
   events, the widths and forms in turns (w4 and w5 projective, w4 and w5
   affine, then back in reverse order) on the same items, each also held
   against the plain version, beside the count-based bound;
7. campaign: ``tpunode_torch.campaign.run_campaign(256, 2048)`` on the
   card at each width in each form — 1,796 adversarial items over 21
   shapes against the native CPU verifier and each shape's required
   verdict; any mismatch fails.

Every phase prints one JSON line.  The second-to-last line is the
``{"kernels": [...]}`` summary and the last is the ``{"ok": true, ...}``
line.  Any failure raises: the exit code is nonzero and no ``ok`` line is
printed.  Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import asyncio
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


def kernel_ops_per_lane(window_bits: int = 4, point_form: str = "projective") -> dict:
    """int32 operations per lane that the kernel's source (csrc/*.cuh) does
    at ``window_bits`` in ``point_form``, function by function, by the pipe
    that can issue them on Hopper:

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
    whenever one of its lanes needs it."""
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
    canonical = (fold_top + carry(NL) + _ops(flex=NL) + _rep(NL + 4, carry(NL + 1))
                 + _ops(alu=2, flex=3) + _rep(NL + 2, carry(NL))
                 + _rep(2, _ops(alu=2 * NL, flex=NL) + _rep(NL + 1, carry(NL))))
    is_zero = canonical + _ops(alu=NL)
    eq = _ops(flex=NL) + is_zero
    pow_const = _rep(14, mul) + _rep(64, _rep(4, sqr) + mul)
    tables = _rep(entries - 2, pt_add) + _rep(entries, mul)  # Q and λQ tables
    if point_form == "affine":
        tables += (_rep(entries - 3, mul) + pow_const  # prefix products, Fermat ladder
                   + _rep(3 * (entries - 2) + entries - 3, mul))  # suffix pass
        window_adds = _rep(4, pt_add_mixed) + _ops(alu=8)  # digit masks, digit-0 compares
    else:
        window_adds = _rep(4, pt_add) + _ops(alu=4)  # digit masks
    ecdsa = (tables + _rep(windows, _rep(window_bits, pt_double) + window_adds)
             + is_zero + _rep(2, mul + eq) + _rep(2, sqr) + mul + _ops(flex=1) + eq)
    full = ecdsa + mul + pow_const + eq + pow_const + mul + canonical + _ops(alu=1)
    return {"schnorr_free": ecdsa, "full": full, "pt_add": pt_add,
            "pt_add_mixed": pt_add_mixed, "pt_double": pt_double, "mul": mul, "sqr": sqr,
            "pow_const": pow_const, "canonical": canonical}


def noinline_calls_per_lane(window_bits: int = 4, point_form: str = "projective") -> dict:
    """Calls of the kernel's ``__noinline__`` functions a lane makes (each
    passes its operands through the thread's stack), counted from the
    source as :func:`kernel_ops_per_lane` counts operations: ``mul`` and
    ``sqr`` are three calls (with their convolution and reduction),
    ``pt_add`` 22, ``pt_add_mixed`` 20, ``pt_double`` 16, ``pow_const``
    1 + 14 muls + 64 windows of four squarings and a mul, ``canonical``
    one."""
    from tpunode_torch.verify.width import windows as window_rounds

    windows, entries = window_rounds(window_bits), 1 << window_bits
    mul = sqr = 3
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
               point_form: str = "projective") -> Counter:
    """The kernel's int32 operations for one launch over ``lanes`` lanes
    whose sign flags hold ``negated`` set bits: each set bit negates the Y
    of one selected table entry in each window (33 at 4-bit, 27 at 5)."""
    from tpunode_torch.verify.width import windows

    per_lane = kernel_ops_per_lane(window_bits, point_form)[
        "schnorr_free" if schnorr_free else "full"]
    return _rep(lanes, per_lane) + _ops(flex=negated * windows(window_bits) * 24)


def probe_ops_per_lane(probe: str) -> Counter:
    """int32 operations per lane of a probe kernel (csrc/diag.cu), counted
    as :func:`kernel_ops_per_lane` counts: one mixed add, or the batch
    inversion's 13 column and 13 prefix multiplies, the Fermat ladder, the
    suffix step's two multiplies and the canonical form."""
    ops = kernel_ops_per_lane()
    if probe == "mixed_add":
        return ops["pt_add_mixed"]
    return _rep(13 + 13 + 2, ops["mul"]) + ops["pow_const"] + ops["canonical"]


def probe_bytes(probe: str, lanes: int) -> int:
    """Bytes a probe must move: its limb rows read once, its output written
    once (mixed add: four rows in, a point out; batch inversion: one in,
    one out)."""
    rows = (4 + 3) if probe == "mixed_add" else 2
    return lanes * rows * 24 * 4


def verify_bytes(lanes: int, window_bits: int = 4, point_form: str = "projective") -> int:
    """Bytes a verify launch must move: its inputs read once (digit rows of
    the width, limb rows, flags and the G / λG tables of the form) and its
    verdicts written once."""
    from tpunode_torch.verify.width import windows

    coords = 2 if point_form == "affine" else 3
    return (lanes * (4 * windows(window_bits) * 4 + 4 * 24 * 4 + 8)
            + 2 * (1 << window_bits) * coords * 24 * 4 + lanes)


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
    keyed ``"<variant>/w<bits>/<form>"`` (``full/w4/projective`` ..
    ``schnorr_free/w5/affine``), and of each probe kernel, keyed by the
    probe (``mixed_add``, ``batch_inv``)."""
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
        if m := re.search(r"verify_kernelILb([01])ELi([45])ELb([01])E", name or ""):
            variant = "schnorr_free" if m.group(1) == "1" else "full"
            form = "affine" if m.group(3) == "1" else "projective"
            out[f"{variant}/w{m.group(2)}/{form}"] = info
        elif m := re.search(r"(mixed_add|batch_inv)_kernel", name or ""):
            out[m.group(1)] = info
    return out


# ---------- the phases ------------------------------------------------------


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
    kinds = [(wb, form) for form in POINT_FORMS for wb in widths]  # (4,P) (5,P) (4,A) (5,A)

    def reset_launches() -> None:
        for key in cuda_kernel.LAUNCHES:
            cuda_kernel.LAUNCHES[key] = 0

    # 1. device
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    sm_clock = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    sm_count = props.multi_processor_count
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "sm_count": sm_count, "sm_clock_max_mhz": sm_clock})

    # 2. build: the verify kernel's eight instantiations and the two probes
    t0 = time.perf_counter()
    lib_paths = cuda_kernel.build()
    ptxas = ptxas_entries(cuda_kernel.BUILD_LOG)
    want = {f"{v}/w{wb}/{form}" for v in variants for wb, form in kinds} | set(cuda_diag.PROBES)
    keys = {"registers", "smem", "stack_frame", "spill_stores", "spill_loads"}
    if set(ptxas) != want or any(set(info) != keys for info in ptxas.values()):
        raise RuntimeError(f"ptxas reported {ptxas}, expected {sorted(keys)} for each "
                           f"of {sorted(want)}:\n{cuda_kernel.BUILD_LOG[-4000:]}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: v.rsplit("/", 1)[-1] for k, v in lib_paths.items()},
          "ptxas": ptxas})

    # 3. kernel vs plain version: both variants at both widths in both forms,
    #    adversarial lanes; the affine verdicts must equal the projective ones
    rng = random.Random(SEED)
    max_err = {(wb, form, v): 0 for wb, form in kinds for v in variants}
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
            for form in POINT_FORMS:
                got = cuda_kernel.verify_blocked(*args, schnorr_free=prep.schnorr_free,
                                                 point_form=form)
                plain = K.verify_core(*args, schnorr_free=prep.schnorr_free, point_form=form)
                torch.cuda.synchronize()
                err = int((got.int() - plain.int()).abs().max())
                max_err[(wb, form, variant)] = err
                verdicts[form] = got.tolist()
                if err or verdicts[form] != oracle:
                    raise RuntimeError(f"{variant}/w{wb}/{form}: kernel {err} lanes off the "
                                       f"plain version, oracle agrees: "
                                       f"{verdicts[form] == oracle}")
                emit({"phase": "kernel_vs_plain", "variant": variant, "window_bits": wb,
                      "point_form": form, "lanes": len(items), "valid": sum(oracle),
                      "max_abs_err": err,
                      "equals_projective": verdicts[form] == verdicts["projective"]})
            if verdicts["affine"] != verdicts["projective"]:
                raise RuntimeError(f"{variant}/w{wb}: affine and projective verdicts differ")

    # 4. the probes: their entry point with the counts zeroed around it, then
    #    each kernel against its plain version and timed
    for name in cuda_diag.PROBES:
        cuda_diag.LAUNCHES[name] = 0
    diag = cuda_diag.run()
    probe_launches = dict(cuda_diag.LAUNCHES)
    if not all(c["ok"] for c in diag["cases"]) or min(probe_launches.values()) < 1:
        raise RuntimeError(f"probes: {diag['cases']}, launches {probe_launches}")
    probes = {}
    for case in diag["cases"]:
        name = case["case"]
        fn, plain_fn = {"mixed_add": (cuda_diag.mixed_add, cuda_diag.mixed_add_plain),
                        "batch_inv": (cuda_diag.batch_inv, cuda_diag.batch_inv_plain)}[name]
        inputs = cuda_diag.probe_inputs(name, "cuda")
        got = fn(*inputs)
        plain = [None]
        plain_ms = timed_ms(torch, lambda: plain.__setitem__(0, plain_fn(*inputs)), 1)
        err = int((got - plain[0]).abs().max())
        fn(*inputs)  # warm
        lanes = inputs[0].shape[-1]
        row = {"probe": name, "lanes": lanes, "launches": probe_launches[name],
               "host_check_bad_lanes": case["bad_lanes"], "max_abs_err": err,
               "ms": timed_ms(torch, lambda: fn(*inputs), TIMED_LAUNCHES), "plain_ms": plain_ms}
        row["bound_ms"], row["bound_by"] = least_ms(
            _rep(lanes, probe_ops_per_lane(name)), probe_bytes(name, lanes), sm_count, sm_clock)
        if err:
            raise RuntimeError(f"probe {name}: kernel and plain version differ by {err}")
        probes[name] = row
        emit({"phase": "probe", "card": card, **row})

    # 5. the main path: the engine at its real shapes, at each width and form
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
        variant at the engine's width and form)."""
        wb, form = engine.cfg.window_bits, engine.cfg.point_form
        reset_launches()
        t0 = time.perf_counter()
        verdicts = main_path(engine)
        seconds = time.perf_counter() - t0
        launches = dict(cuda_kernel.LAUNCHES)
        mismatches = sum(a != b for a, b in zip(verdicts, cpu))
        if len(verdicts) != len(raw) or mismatches:
            raise RuntimeError(f"main path w{wb}/{form}: {len(verdicts)} verdicts for "
                               f"{len(raw)} items, {mismatches} mismatches against the "
                               f"native CPU verifier")
        # 32,768 and the tail are full-variant chunks, 4,096 ECDSA schnorr_free
        expect = {key: 0 for key in launches}
        expect[(wb, form, "full")], expect[(wb, form, "schnorr_free")] = 2, 1
        if launches != expect:
            raise RuntimeError(f"main path w{wb}/{form} launched {launches}, expected 3 "
                               f"at w{wb}/{form}")
        return verdicts, seconds, {v: launches[(wb, form, v)] for v in variants}

    engines = {(wb, form): VerifyEngine(VerifyConfig(
        device_batch=BLOCK_ITEMS, batch_size=MEMPOOL_ITEMS, window_bits=wb, point_form=form))
        for wb, form in kinds}
    verdicts, e2e_s, launches4 = drive(engines[(4, "projective")])
    # the 4-bit projective path once more, under the profiler
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function("main_path"):
                traced = main_path(engines[(4, "projective")])
        prof.export_chrome_trace(os.path.join(tmp, "main_path.json"))
        trace = trace_breakdown(os.path.join(tmp, "main_path.json"))
    if traced != verdicts:
        raise RuntimeError("main path: the traced run's verdicts differ from the first run's")
    e2e = {(4, "projective"): [e2e_s]}
    launches = {(4, "projective"): launches4}
    for kind in kinds[1:]:
        got, e2e_s, launches[kind] = drive(engines[kind])
        if got != verdicts:
            raise RuntimeError(f"main path {kind}: verdicts differ from the 4-bit projective "
                               f"path's")
        e2e[kind] = [e2e_s]
    # unprofiled end to end, in turns after the counted runs
    for kind in kinds[::-1] + kinds:
        t0 = time.perf_counter()
        if main_path(engines[kind]) != verdicts:
            raise RuntimeError(f"main path {kind}: a repeated run's verdicts differ")
        e2e[kind].append(time.perf_counter() - t0)
    for wb, form in kinds:
        runs = e2e[(wb, form)]
        e2e_s = sorted(runs)[len(runs) // 2]
        emit({"phase": "main_path", "card": card, "window_bits": wb, "point_form": form,
              "items": len(raw), "valid": sum(cpu), "chunks": 3,
              "launches": launches[(wb, form)], "mismatches": 0, "e2e_seconds": e2e_s,
              "e2e_sigs_per_s": len(raw) / e2e_s, "e2e_seconds_runs": runs,
              **({"traced": trace} if (wb, form) == (4, "projective") else {})})

    # 6. the kernel alone: both variants at both device shapes, the widths and
    #    forms timed in turns on the same items
    rows = {}
    ecdsa = tile(mempool, BLOCK_ITEMS)
    for variant, items in (("full", block), ("schnorr_free", ecdsa)):
        for lanes in (BLOCK_ITEMS, MEMPOOL_ITEMS):
            packed = pack_items(items[:lanes])
            args = {}
            for wb in widths:
                prep = K.prepare_batch_raw(packed, pad_to=lanes, window_bits=wb)
                if prep.schnorr_free != (variant == "schnorr_free"):
                    raise RuntimeError(f"{variant}: the batch selects the other variant")
                args[wb] = K.from_reference(prep.device_args, "cuda")
                sf = prep.schnorr_free
                for form in POINT_FORMS:  # warm
                    cuda_kernel.verify_blocked(*args[wb], schnorr_free=sf, point_form=form)
            runs = {kind: [] for kind in kinds}
            for wb, form in kinds + kinds[::-1]:
                runs[(wb, form)].append(timed_ms(torch, lambda: cuda_kernel.verify_blocked(
                    *args[wb], schnorr_free=sf, point_form=form), TIMED_LAUNCHES))
            for wb, form in kinds:
                row = {"variant": variant, "lanes": lanes, "window_bits": wb,
                       "point_form": form, "ms": sum(runs[(wb, form)]) / 2,
                       "ms_runs": runs[(wb, form)]}
                negated = sum(int(t.sum()) for t in args[wb][4:8])
                row["bound_ms"], row["bound_by"] = bound_ms(
                    kernel_ops(lanes, negated, sf, wb, form), lanes, sm_count, sm_clock,
                    wb, form)
                row["calls_per_lane"] = noinline_calls_per_lane(wb, form)[variant]
                got = cuda_kernel.verify_blocked(*args[wb], schnorr_free=sf, point_form=form)
                plain = [None]
                row["plain_ms"] = timed_ms(torch, lambda: plain.__setitem__(
                    0, K.verify_core(*args[wb], schnorr_free=sf, point_form=form)), 1)
                row["max_abs_err"] = int((got.int() - plain[0].int()).abs().max())
                key = (wb, form, variant)
                max_err[key] = max(max_err[key], row["max_abs_err"])
                if row["max_abs_err"]:
                    raise RuntimeError(f"{variant}/w{wb}/{form}: kernel and plain version "
                                       f"disagree at {lanes} lanes")
                if lanes == BLOCK_ITEMS:
                    for _ in range(BURST_LAUNCHES):
                        cuda_kernel.verify_blocked(*args[wb], schnorr_free=sf, point_form=form)
                    row["under_load"] = nvidia_smi("clocks.sm,power.draw")
                    torch.cuda.synchronize()
                rows[(wb, form, variant, lanes)] = row
                emit({"phase": "kernel_timing", "card": card, **row})

    # 7. the adversarial campaign on the card, at each width in each form
    for wb, form in kinds:
        res = run_campaign(CAMPAIGN_BASE, CAMPAIGN_BATCH, window_bits=wb, point_form=form)
        if res["mismatches"] or res["kernel"] != "cuda" or res["launches"] < 1:
            raise RuntimeError(f"campaign w{wb}/{form}: {res['mismatches']} mismatches on "
                               f"{res['kernel']} ({res['launches']} launches): "
                               f"{res['mismatch_detail']}")
        emit({"phase": "campaign", "card": card,
              **{k: res[k] for k in ("window_bits", "point_form", "items", "mismatches",
                                     "batch", "launches", "gen_s", "run_s", "tally")}})

    # 8. summary: one entry for each kernel — the verify kernel's eight
    #    instantiations at the main path's 32,768-lane shape, then the probes
    kernels = []
    for wb, form in kinds:
        for variant in variants:
            main, small = rows[(wb, form, variant, BLOCK_ITEMS)], rows[(wb, form, variant,
                                                                         MEMPOOL_ITEMS)]
            kernels.append({
                "name": f"verify_kernel<{variant}, w{wb}, {form}>",
                "route": "cuda",
                "source": "tpunode_torch/csrc/verify_kernel.cu",
                "replaces": "tpunode/verify/pallas_kernel.py:526",
                "launches": launches[(wb, form)][variant],
                "max_abs_err": max_err[(wb, form, variant)],
                "ms": main["ms"],
                "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"],
                "library_ms": None,
                "window_bits": wb,
                "point_form": form,
                "variant": variant,
                "lanes": BLOCK_ITEMS,
                "at_4096": {k: small[k] for k in ("ms", "bound_ms", "plain_ms")},
            })
    for name, line in (("mixed_add", 300), ("batch_inv", 379)):
        row = probes[name]
        kernels.append({
            "name": f"cuda_diag.{name}",
            "route": "cuda",
            "source": "tpunode_torch/csrc/diag.cu",
            "replaces": f"benchmarks/mosaic_diag.py:{line}",
            **{k: row[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "lanes")},
            "library_ms": None,
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
