#!/usr/bin/env python3
"""Smoke test of tpunode_torch on one NVIDIA card (run: ``python3 chip_smoke.py``).

Drives the port's main path — signature batches through ``VerifyEngine``
at the engine's real shapes (``device_batch=32768``, ``batch_size=4096``)
and the hand-written CUDA verify kernel — and checks it:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compiles the kernel from ``tpunode_torch/csrc`` with nvcc
   (``sm_90a``) and prints ptxas's registers, shared memory, stack frame
   and spills for each of its four instantiations (the full and the
   ``schnorr_free`` variant at 4-bit and at 5-bit windows);
3. kernel vs plain: 512 adversarial lanes (valid lanes of every algorithm,
   bad s, z = 0, r+n, jacobi and parity twins, pubkeys off the curve, R at
   infinity) through both kernel variants at both widths; the verdicts
   must equal the plain PyTorch version's on the card and the oracle's;
4. main path: three chunks through the engine, with launch counts zeroed
   just before and read just after — 32,768 valid ECDSA and BIP340 items
   (the full variant), 4,096 valid ECDSA items (the ``schnorr_free``
   variant, ``batch_size``) and a ragged 1,000-item tail with every eighth
   item corrupted, through the async queue.  The traffic is synthetic
   (Bitcoin-shaped: no BCH Schnorr beside BIP340; the BIP340 share is
   chosen, not measured).  The verdicts must equal the native CPU
   verifier's, and the kernel must have been launched once per chunk at
   the engine's width.  The path runs through a 4-bit engine, once more
   under ``torch.profiler`` for the device's idle share and the time in
   each verify span, then through a 5-bit engine (``window_bits=5``),
   then four more times unprofiled, the widths in turns, for the end-to-end
   rate (the median of each width's three runs);
5. kernel timing: both variants at 32,768 and 4,096 lanes with CUDA
   events, the two widths in turns (4, 5, 5, 4) on the same items, each
   also held against the plain version, beside the count-based bound at
   its width;
6. campaign: ``tpunode_torch.campaign.run_campaign(256, 2048)`` on the
   card at each width — 1,796 adversarial items over 21 shapes against
   the native CPU verifier and each shape's required verdict; any
   mismatch fails.

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


def kernel_ops_per_lane(window_bits: int = 4) -> dict:
    """int32 operations per lane that the kernel's source (csrc/*.cuh) does
    at ``window_bits``, function by function, by the pipe that can issue
    them on Hopper:

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
    4-bit at both widths."""
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
    pt_add = (_rep(3, conv + rwl)  # t0, t1, t2
              + _rep(3, _ops(flex=3 * NL) + mul_wide + rwl)  # t3, t4, t5: sums in, IADD3 out
              + mul_small_red + _rep(2, tighten) + _ops(flex=3 * NL) + _rep(3, tighten)
              + mul_small_red + tighten  # y3r
              + _rep(6, conv) + _ops(flex=3 * NW) + _rep(3, rwl))  # x3, y3, z3
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
    ecdsa = (_rep(entries - 2, pt_add) + _rep(entries, mul)  # Q and λQ tables
             + _rep(windows, _rep(window_bits, pt_double) + _rep(4, pt_add) + _ops(alu=4))
             + is_zero + _rep(2, mul + eq) + _rep(2, sqr) + mul + _ops(flex=1) + eq)
    full = ecdsa + mul + pow_const + eq + pow_const + mul + canonical + _ops(alu=1)
    return {"schnorr_free": ecdsa, "full": full, "pt_add": pt_add,
            "pt_double": pt_double, "mul": mul, "sqr": sqr}


def kernel_ops(lanes: int, negated: int, schnorr_free: bool, window_bits: int = 4) -> Counter:
    """The kernel's int32 operations for one launch over ``lanes`` lanes
    whose sign flags hold ``negated`` set bits: each set bit negates the Y
    of one selected table entry in each window (33 at 4-bit, 27 at 5)."""
    from tpunode_torch.verify.width import windows

    per_lane = kernel_ops_per_lane(window_bits)["schnorr_free" if schnorr_free else "full"]
    return _rep(lanes, per_lane) + _ops(flex=negated * windows(window_bits) * 24)


def bound_ms(ops: Counter, lanes: int, sm_count: int, sm_clock_mhz: float,
             window_bits: int = 4) -> tuple:
    """(least ms, what bounds it) for one launch: its int32 operations over
    the card's integer rates — each pipe's own and the issue rate of both
    together — or the bytes it must move (its inputs read once: digit rows
    of the width, limb rows, flags and the G / λG tables; its verdicts
    written once) over HBM bandwidth."""
    from tpunode_torch.verify.width import windows

    clocks = max(ops["mul"] / FMA_PIPE_OPS_PER_CLK_PER_SM,
                 ops["alu"] / ALU_PIPE_OPS_PER_CLK_PER_SM,
                 sum(ops.values()) / ISSUE_OPS_PER_CLK_PER_SM)
    ops_s = clocks / (sm_count * sm_clock_mhz * 1e6)
    in_bytes = (lanes * (4 * windows(window_bits) * 4 + 4 * 24 * 4 + 8)
                + 2 * (1 << window_bits) * 3 * 24 * 4)
    bytes_s = (in_bytes + lanes) / HBM_BYTES_PER_S
    return (ops_s * 1e3, "operations") if ops_s >= bytes_s else (bytes_s * 1e3, "bytes")


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
    keyed ``"<variant>/w<bits>"`` (``full/w4`` .. ``schnorr_free/w5``)."""
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
        if m := re.search(r"verify_kernelILb([01])ELi([45])E", name or ""):
            out[f"{'schnorr_free' if m.group(1) == '1' else 'full'}/w{m.group(2)}"] = info
    return out


# ---------- the phases ------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tpunode_torch.campaign import run_campaign
    from tpunode_torch.verify import cuda_kernel
    from tpunode_torch.verify import ecdsa_cpu as O
    from tpunode_torch.verify import kernel as K
    from tpunode_torch.verify.cpu_native import load_native_verifier
    from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine
    from tpunode_torch.verify.raw import concat_raw, pack_items

    widths = tuple(K.WINDOWS_BY_BITS)

    def reset_launches() -> None:
        for wb in widths:
            cuda_kernel.LAUNCHES[wb] = 0

    # 1. device
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    sm_clock = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "sm_count": props.multi_processor_count,
          "sm_clock_max_mhz": sm_clock})

    # 2. build: all four instantiations (two variants x two widths)
    t0 = time.perf_counter()
    lib_path = cuda_kernel.build()
    ptxas = ptxas_entries(cuda_kernel.BUILD_LOG)
    want = {f"{v}/w{wb}" for v in ("full", "schnorr_free") for wb in widths}
    keys = {"registers", "smem", "stack_frame", "spill_stores", "spill_loads"}
    if set(ptxas) != want or any(set(info) != keys for info in ptxas.values()):
        raise RuntimeError(f"ptxas reported {ptxas}, expected {sorted(keys)} for each "
                           f"of {sorted(want)}:\n{cuda_kernel.BUILD_LOG[-4000:]}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": lib_path.rsplit("/", 1)[-1], "ptxas": ptxas})

    # 3. kernel vs plain version, both variants at both widths, adversarial lanes
    rng = random.Random(SEED)
    max_err = dict.fromkeys(widths, 0)
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
            got = cuda_kernel.verify_blocked(*args, schnorr_free=prep.schnorr_free)
            plain = K.verify_core(*args, schnorr_free=prep.schnorr_free)
            torch.cuda.synchronize()
            err = int((got.int() - plain.int()).abs().max())
            max_err[wb] = max(max_err[wb], err)
            if err or got.tolist() != oracle:
                raise RuntimeError(f"{variant}/w{wb}: kernel {err} lanes off the plain "
                                   f"version, oracle agrees: {got.tolist() == oracle}")
            emit({"phase": "kernel_vs_plain", "variant": variant, "window_bits": wb,
                  "lanes": len(items), "valid": sum(oracle), "max_abs_err": err})

    # 4. the main path: the engine at its real shapes, at each width
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
        ``engine`` and read the counts: (verdicts, seconds, launches)."""
        wb = engine.cfg.window_bits
        reset_launches()
        t0 = time.perf_counter()
        verdicts = main_path(engine)
        seconds = time.perf_counter() - t0
        launches = dict(cuda_kernel.LAUNCHES)
        mismatches = sum(a != b for a, b in zip(verdicts, cpu))
        if len(verdicts) != len(raw) or mismatches:
            raise RuntimeError(f"main path w{wb}: {len(verdicts)} verdicts for {len(raw)} "
                               f"items, {mismatches} mismatches against the native CPU "
                               f"verifier")
        if launches != {w: 3 if w == wb else 0 for w in widths}:
            raise RuntimeError(f"main path w{wb} launched {launches}, expected 3 at w{wb}")
        return verdicts, seconds, launches[wb]

    engines = {wb: VerifyEngine(VerifyConfig(device_batch=BLOCK_ITEMS, batch_size=MEMPOOL_ITEMS,
                                             window_bits=wb)) for wb in widths}
    verdicts, e2e_s, launches4 = drive(engines[4])
    # the 4-bit path once more, under the profiler
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function("main_path"):
                traced = main_path(engines[4])
        prof.export_chrome_trace(os.path.join(tmp, "main_path.json"))
        trace = trace_breakdown(os.path.join(tmp, "main_path.json"))
    if traced != verdicts:
        raise RuntimeError("main path: the traced run's verdicts differ from the first run's")
    e2e = {4: [e2e_s]}
    _, e2e_s, launches5 = drive(engines[5])
    e2e[5] = [e2e_s]
    launches = {4: launches4, 5: launches5}
    # unprofiled end to end, the widths in turns (5, 4, 4, 5) after the counted runs
    for wb in (5, 4, 4, 5):
        t0 = time.perf_counter()
        if main_path(engines[wb]) != verdicts:
            raise RuntimeError(f"main path w{wb}: a repeated run's verdicts differ")
        e2e[wb].append(time.perf_counter() - t0)
    for wb in widths:
        e2e_s = sorted(e2e[wb])[len(e2e[wb]) // 2]
        emit({"phase": "main_path", "card": card, "window_bits": wb, "items": len(raw),
              "valid": sum(cpu), "chunks": 3, "launches": launches[wb], "mismatches": 0,
              "e2e_seconds": e2e_s, "e2e_sigs_per_s": len(raw) / e2e_s,
              "e2e_seconds_runs": e2e[wb], **({"traced": trace} if wb == 4 else {})})

    # 5. the kernel alone: both variants at both device shapes, the two widths
    #    timed in turns (4, 5, 5, 4) on the same items
    sm_count = props.multi_processor_count
    shapes = {wb: [] for wb in widths}
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
                cuda_kernel.verify_blocked(*args[wb], schnorr_free=sf)  # warm
            runs = {wb: [] for wb in widths}
            for wb in (4, 5, 5, 4):
                runs[wb].append(timed_ms(
                    torch, lambda: cuda_kernel.verify_blocked(*args[wb], schnorr_free=sf),
                    TIMED_LAUNCHES))
            for wb in widths:
                row = {"variant": variant, "lanes": lanes, "window_bits": wb,
                       "ms": sum(runs[wb]) / len(runs[wb]), "ms_runs": runs[wb]}
                negated = sum(int(t.sum()) for t in args[wb][4:8])
                row["bound_ms"], row["bound_by"] = bound_ms(
                    kernel_ops(lanes, negated, sf, wb), lanes, sm_count, sm_clock, wb)
                got = cuda_kernel.verify_blocked(*args[wb], schnorr_free=sf)
                plain = [None]
                row["plain_ms"] = timed_ms(torch, lambda: plain.__setitem__(
                    0, K.verify_core(*args[wb], schnorr_free=sf)), 1)
                row["max_abs_err"] = int((got.int() - plain[0].int()).abs().max())
                max_err[wb] = max(max_err[wb], row["max_abs_err"])
                if row["max_abs_err"]:
                    raise RuntimeError(f"{variant}/w{wb}: kernel and plain version "
                                       f"disagree at {lanes} lanes")
                if lanes == BLOCK_ITEMS:
                    for _ in range(BURST_LAUNCHES):
                        cuda_kernel.verify_blocked(*args[wb], schnorr_free=sf)
                    row["under_load"] = nvidia_smi("clocks.sm,power.draw")
                    torch.cuda.synchronize()
                shapes[wb].append(row)
                emit({"phase": "kernel_timing", "card": card, **row})

    # 6. the adversarial campaign on the card, at each width
    for wb in widths:
        res = run_campaign(CAMPAIGN_BASE, CAMPAIGN_BATCH, window_bits=wb)
        if res["mismatches"] or res["kernel"] != "cuda" or res["launches"] < 1:
            raise RuntimeError(f"campaign w{wb}: {res['mismatches']} mismatches on "
                               f"{res['kernel']} ({res['launches']} launches): "
                               f"{res['mismatch_detail']}")
        emit({"phase": "campaign", "card": card,
              **{k: res[k] for k in ("window_bits", "items", "mismatches", "batch",
                                     "launches", "gen_s", "run_s", "tally")}})

    # 7. summary: one entry for each width's kernel
    kernels = []
    for wb in widths:
        main = shapes[wb][0]
        kernels.append({
            "name": "verify_blocked" if wb == 4 else f"verify_blocked_w{wb}",
            "route": "cuda",
            "source": "tpunode_torch/csrc/verify_kernel.cu",
            "replaces": "tpunode/verify/pallas_kernel.py:526",
            "launches": launches[wb],
            "max_abs_err": max_err[wb],
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,
            "window_bits": wb,
            "lanes": BLOCK_ITEMS,
            "variant": main["variant"],
            "shapes": [{k: row[k] for k in ("variant", "lanes", "ms", "bound_ms", "plain_ms")
                        if k in row} for row in shapes[wb]],
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
