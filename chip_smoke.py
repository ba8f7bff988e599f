#!/usr/bin/env python3
"""Smoke test of tpunode_torch on one NVIDIA card (run: ``python3 chip_smoke.py``).

Drives the port's main path — signature batches through ``VerifyEngine``
at the engine's real shapes (``device_batch=32768``, ``batch_size=4096``)
and the hand-written CUDA verify kernels — and checks it.  The default mode
tuple (4-bit, projective, lazy, tree, half-product square, shift-add) runs
the 8-word kernel redesigned for the card (``csrc/verify_u32.cu``, library
``verify_u32``), the one-hot eager affine tuples of either width and
square and the tree eager affine 4-bit ones the same arithmetic in
``csrc/verify_u32_modes.cu`` (libraries ``verify_u32_modes_half`` and
``verify_u32_modes_mul`` at 4 bits, ``verify_u32_modes5_half`` and
``verify_u32_modes5_mul`` at 5, ``verify_u32_modes_tree_half`` and
``verify_u32_modes_tree_mul`` for the tree select, one a width, select and
square); every other tuple the radix-11 template
(``csrc/verify_kernel.cu``), whose entries of those seven tuples in
``verify_half`` and ``verify_mul`` stay as the 8-word kernels' yardsticks,
launched by name (:data:`YARDSTICKS`):

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compiles the kernels from ``tpunode_torch/csrc`` with nvcc
   (``sm_90a``, one nvcc a library, started together: the radix-11 verify
   source once for each (multiply, square), the 8-word one once, the
   probes' source once) and prints
   ptxas's registers, shared memory, stack frame and spills for each of the
   verify kernel's 128 instantiations (the full and the ``schnorr_free``
   variant at 4-bit and at 5-bit windows, in the projective and the affine
   point form, with lazy and with eager reduction, with the tree and the
   one-hot table select, with the half-product and the full-product
   square, with the shift-add and the ``dot_general`` multiply) and for
   the thirteen probe kernels, and for the 8-word kernels' two and twelve
   instantiations (with, where the toolkit has ``cuobjdump``, the static
   SASS classes of their kernels, the modes kernels' local and shared
   memory opcodes (LDL.128 apart from LDL) and the classes of the
   ``field_mul_u32`` probe beside :func:`u32_ops_per_lane`'s model), nvcc's
   seconds for each process, reads the
   PTX of the pow_descan probe's ladder (no digit loaded from memory, and
   the calls of the static ladder), the PTX of the full-product library:
   it must name no half-product ``sqr_conv``, while the probes' PTX (half
   product) must call it, the probes' PTX by function:
   ``mma.sync.aligned.m16n8k32`` in ``field_mul_dot_kernel`` and in no
   other function, whose ptxas line must show no spill, and each verify
   library's PTX by function: ``mma.sync.aligned.m16n8k32`` only in the
   ``dot_general`` libraries' ``conv_dot`` (and ``sqr_dot`` in the
   half-product one), none in a shift-add library; and holds the 64
   shift-add instantiations' ptxas lines field for field against the
   committed snapshot ``tpunode_torch/csrc/ptxas_shift_add.json`` (written
   by ``ptxas_snapshot.py`` from the tree before the ``dot_general``
   multiply), where the snapshot's nvcc release and flags are this build's;
3. kernel vs plain: 512 adversarial lanes (valid lanes of every algorithm,
   bad s, z = 0, r+n, jacobi and parity twins, pubkeys off the curve, R at
   infinity) through every instantiation of both multiplies; the verdicts
   must equal the plain PyTorch version's on the card and the oracle's,
   and be the same in every form, reduction, select, square and multiply.
   The default tuple and the eager affine ones of :data:`U32_MODES_KINDS`
   launch their 8-word kernels, and beside each its radix-11 entry by
   name, both against the same shared plain output; each 8-word kernel
   launches once more on 1, 31, 33 and 4,097 lanes of the same items
   (wrapping around), held against those lanes of that output.
   The plain version runs once for each (variant, width, form, reduction)
   at the tree select, the half product and shift-add, and every
   instantiation of that key is held against that output: the selects
   pick the same entry, and ``_sqr_conv(a)``, ``_conv(a, a)`` and the
   ``dot_general`` contractions give the same int32 in every output limb
   (the reference pins it:
   ``tests/test_field.py::test_formulations_bit_identical`` and
   ``tests/test_pallas_kernel.py::test_pallas_field_formulations_bit_identical``),
   so every later limb, and each verdict, is the same.  At the default
   modes, full variant, the plain version runs in its own modes once
   under the one-hot select, once under ``sqr="mul"`` and once under
   ``mul="dot_general"`` for each square, each equal to the shared output,
   the kernel and the oracle, and the ``dot_general`` kernel launches once
   more on the first 33 lanes (a ragged last warp).  Then the plain version
   with the unrolled pow ladders (``TPUNODE_POW_LADDER=unroll``) once for
   each (width, form, reduction), tree select, half product, full variant,
   which must equal that instantiation's verdicts (launched for the unroll
   caller too) and the oracle's: 28 plain calls in all.  The plain
   version needs no kernel, so those 28 calls run ahead, in a thread of
   their own while phase 2's nvcc processes run (:func:`plain_ahead`); phase
   3 reads their outputs, and their ms, taken while nvcc holds the host's
   cores;
4. probes: ``tpunode_torch.cuda_diag.run()`` on the card, with its launch
   counts zeroed just before and read just after — the add-one floor, the
   eager construct (one reduced multiply), the same multiply with its
   convolution contracted on the tensor cores (the reference's
   ``dot_general`` formulation) and in the 8-word arithmetic of the main
   path's kernel (``field_mul_u32``), the lazy construct (two wide
   products, one loose reduction), the affine form's mixed add and batch
   inversion, the table built by dynamic index, the pow ladder with static
   digits, the select tree, the one-hot windowed pow with its digits in
   global and in shared memory, and the 5-bit constructs, each against its
   host check — then each probe kernel against its plain version, timed
   beside its bound (and the add-one floor beside ``x + 1``, both also
   timed on the device alone from a ``torch.profiler`` trace; the
   tensor-core multiply beside its own formulation's bound too), the
   tensor-core multiply's and the 8-word one's outputs equal to the
   shift-add one's, the 8-word one held against the host check at 32,768
   lanes too, the three timed in turns there (:func:`dot_over_shift_add`),
   and the
   static-digit pow timed in turns with the two one-hot ones on the same
   inputs;
5. main path: every engine warms up in its own thread, all at once, and
   must be ready (``device_state``) within :data:`WARMUP_BOUND_S`, before
   its first submission.  Then three chunks through each engine, with
   launch counts zeroed just before and read just after — 32,768 valid
   ECDSA and BIP340 items (the full variant) and 4,096 valid ECDSA items
   (the ``schnorr_free`` variant, ``batch_size``) through ``verify_sync``,
   and a ragged 1,000-item tail with every eighth item corrupted, through
   the async queue (the lane packer, then a dispatch thread, which packs
   it).  The engines are at the port's default ``min_tpu_batch`` of 0, so
   every chunk reaches the card.  The traffic is synthetic (Bitcoin-shaped: no BCH Schnorr beside
   BIP340; the BIP340 share is chosen, not measured).  The verdicts must
   equal the native CPU verifier's; each chunk must be served by the
   device rung (``last_rung == "tpu"``); the engine counts must grow by
   the item count in ``verify.tpu_items`` and by nothing in
   ``verify.cpu_items``, ``verify.failovers`` and
   ``verify.dispatch_errors``; and the kernel must have been launched once
   per chunk at the engine's width, form, reduction, select, square and
   multiply, in the library that tuple routes to (the default tuple: 2 / 1
   in ``verify_u32``, none in ``verify_half``).  The first engine's
   ``stats()`` is printed after its run.  The
   path runs through a 4-bit projective lazy tree engine, once more under
   ``trace.profile_to`` (a ``torch.profiler`` capture of every thread, in
   which the verify spans are ranges) for the device's idle share and the
   time in each verify span, on the caller's thread and off it (the
   tail's ``verify.pack`` must be off it), then through an engine of every other (width, form,
   reduction, select, square): ``window_bits=5``, ``point_form="affine"``,
   ``field_reduce="eager"``, and ``TPUNODE_SELECT16=onehot`` and
   ``TPUNODE_FIELD_SQR=mul`` set while the engine is built (the engine
   reads those knobs once, at construction; each full-product engine right
   after its half-product twin, whose verdicts it must give), and one more
   engine at the default modes built while ``TPUNODE_POW_LADDER=unroll``
   (its launches are counted under the unroll key; it must give its scan
   twin's verdicts), and an engine of each of the 32 built while
   ``TPUNODE_FIELD_MUL=dot_general`` (65 engines); then twice more each
   engine of the default tuple (either ladder), unprofiled, in turns, for
   the end-to-end rate (the median of its runs; every other engine's is
   its one counted run).  Last, the tail alone through one more engine
   that sets the reference's default ``min_tpu_batch`` of 1024, and is
   never warmed: the cpu rung must serve it, with the native verifier's
   verdicts, ``verify.cpu_items`` grown by 1,000 and no kernel launch.
   Then the block-ingest path (:func:`block_ingest_phase`) on the first
   engine: a BTC block (a coinbase and 1,000 transactions of the
   generator's script-type mix, every ninth corrupted; the phase's BCH
   regtest block, ``gen_chain`` with every fourth transaction
   BCH-Schnorr-signed, is cut from this run: :data:`MAIN_BCH_BLOCK_TXS`), as
   its wire bytes through the native parse, the prevout oracle, the
   native extraction, ``verify_raw`` at block priority and ``combine``.
   The extraction must equal the Python path's row for row, the verdicts
   the native CPU verifier's, the per-transaction verdicts
   ``txverify.combine_verdicts``'s, and exactly the corrupted BTC
   transactions must read invalid; the block must be served by the card,
   with launches only in ``verify_u32``; the BTC block runs under the
   profiler (its one run: its rates include the profiler's cost).
   Without ``libtxextract.so`` the phase raises.  Then the node
   (:func:`node_sync_phase`): a port ``Node`` at ``NodeConfig``'s
   defaults with its own default engine (warmed before the counts are
   zeroed), the UTXO set, the IBD planner and the mempool syncs a 4-block
   BCH regtest chain of the mix from an in-memory wire-speaking remote
   (:class:`WireRemote`), then fetches and verifies 64 loose transactions
   the remote announces, every fifth corrupted; ``ChainSynced`` and the
   watermark must reach the tip, every verdict must equal the native CPU
   verifier's (every chain transaction valid), the items must all reach
   the card, with launches only in ``verify_u32``, and nothing may fail
   over, fail or be shed;
6. kernel timing (:func:`kernel_timing`): both variants at 32,768 and 4,096
   lanes with CUDA events, every instantiation in turns (each full-product
   one right after its half-product twin, each one-hot pair beside its
   tree pair, each eager group beside the lazy group of its width and
   form, then back in reverse order) on the same items, beside the
   count-based bound (:func:`verify_bounds`: the half-product square's
   work, the least the function needs, shared by both squares), and each
   full-product one's time over its twin's beside that bound and the
   bound of its own formulation (576 limb products a square, not 300);
   every instantiation is held against the plain
   version at both lane counts, through one plain call per (variant,
   width, form, reduction) at 32,768 lanes that both selects, both squares
   and both lane counts share; each ``dot_general`` instantiation is
   timed in the same turns right after its shift-add twin, one burst of 3
   (:data:`TIMING_BURSTS`), held against the same plain calls, beside the twin's bound and its own
   formulation's (:func:`dot_kernel_bound_ms`), and its
   ``mul_dot_over_shift_add`` ratio; each 8-word kernel is timed in turns
   with its radix-11 yardstick, both bursts there and back
   (``u32_over_radix11`` lines), beside its own count-based bound
   (:func:`u32_bound_ms`) and the radix-11 one, each tree eager affine
   8-word kernel over its one-hot twin, timed in the same turns
   (``tree_over_onehot`` lines, :func:`tree_over_onehot`), and after the
   default tuple's two
   at 32,768 lanes :data:`BURST_LAUNCHES` back to back give the SM clock
   and the power under load;
7. campaign: ``tpunode_torch.campaign.run_campaign(256, 2048)`` on the
   card at each width, form, reduction, select, square and multiply, and
   once more at the default modes under ``TPUNODE_POW_LADDER=unroll`` (65
   campaigns), all on one pool built once — 1,796 adversarial items over 21 shapes
   against the native CPU verifier and each shape's required verdict, each
   campaign's launches in the one library its modes route to (the default
   tuple's, both ladders, in ``verify_u32``; the eager affine ones' in
   ``verify_u32_modes_half`` / ``_mul``, ``verify_u32_modes5_half`` /
   ``_mul`` and ``verify_u32_modes_tree_half`` / ``_mul``) and none of its
   items on
   the cpu rung;
   any mismatch fails.

Every phase prints one JSON line and its seconds when it ends; the
script's total time is printed before the summary.  The second-to-last line is the
``{"kernels": [...]}`` summary and the last is the ``{"ok": true, ...}``
line.  Any failure raises: the exit code is nonzero and no ``ok`` line is
printed.  Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import hashlib
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter

SEED = 0x5EED
ADVERSARIAL_LANES = 512
BLOCK_ITEMS, MEMPOOL_ITEMS, TAIL_ITEMS = 32768, 4096, 1000
WARMUP_BOUND_S = 300  # phase 5: every engine ready within this, or the run fails
TAIL_CORRUPT_EVERY = 8
TIMED_LAUNCHES = 3
# Phase 4's launches of the add-one probe and of x + 1 under torch.profiler,
# for each one's time on the device alone (beside their CUDA-event times,
# which hold the host's time a launch too).
DEVICE_TIMED_LAUNCHES = 20
# The shift-add instantiations' ptxas lines that phase 2 holds this build's
# against (ptxas_snapshot.py's output).
PTXAS_SNAPSHOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tpunode_torch",
                              "csrc", "ptxas_shift_add.json")
# Phase 6's bursts of TIMED_LAUNCHES for each multiply: the shift-add kernel
# in turns there and back, the dot_general one, 4-15x slower, once, right
# after its shift-add twin.
TIMING_BURSTS = {"shift_add": 2, "dot_general": 1}
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
# The tensor cores' dense int8 rate, 1,979 TOPS on the H100 SXM data sheet,
# is 989.5e12 multiply-adds a second: 4,096 an SM a clock at its 132 SMs and
# the 1,830 MHz that the data sheet's tensor rates assume (989.4 TFLOP/s
# dense bf16 is 2,048 an SM a clock there).  mma.sync reaches part of it;
# only wgmma reaches all of it.
TENSOR_INT8_MACS_PER_CLK_PER_SM = 4096
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
CAMPAIGN_BASE, CAMPAIGN_BATCH = 256, 2048  # 1,796 items over 21 shapes
# the pallas_call line of each probe's Mosaic counterpart in benchmarks/mosaic_diag.py
# (field_mul_u32 computes _field_mul's function in the 8-word arithmetic)
PROBE_PALLAS_LINES = {"trivial": 89, "field_mul": 114, "field_mul_dot": 123,
                      "field_mul_u32": 114, "lazy_reduce": 538,
                      "mixed_add": 300, "batch_inv": 379, "table_build": 175, "pow_descan": 440,
                      "select_tree": 496, "pow_window": 245, "pow_window_smem": 245,
                      "window5": 608}
SELECT_KNOB = "TPUNODE_SELECT16"
LADDER_KNOB = "TPUNODE_POW_LADDER"
SQR_KNOB = "TPUNODE_FIELD_SQR"
MUL_KNOB = "TPUNODE_FIELD_MUL"
SQR_MODES = ("half", "mul")
MUL_MODES = ("shift_add", "dot_general")
# The engine and the campaign under the unrolled ladders: the default modes,
# (width, form, reduction, select, ladder, square, multiply).
UNROLL_KIND = (4, "projective", "lazy", "tree", "unroll", "half", "shift_add")
# Phase 3's own plain calls beside the shared ones, each at the default
# (width, form, reduction), full variant: one under the one-hot select and
# one under the full-product square (half-product, tree, shift-add kinds
# otherwise), and one under dot_general for each square.
ONEHOT_PLAIN_KIND = (4, "projective", "lazy", "onehot", "half")
SQR_MUL_PLAIN_KIND = (4, "projective", "lazy", "tree", "mul")
DOT_PLAIN_KINDS = [(4, "projective", "lazy", "tree", sqr) for sqr in SQR_MODES]
DOT_RAGGED_LANES = 33  # phase 3's launch with a ragged last warp, dot_general
LADDER_REPEATS = 10  # launches a timing of the three pow probes in turns
DOT_LANES = 32768  # the tensor-core multiply over the shift-add one, at the engine's width
# The default mode tuple (width, form, reduce, select, sqr) with the shift-add
# multiply runs the 8-word kernel (cuda_kernel.U32_MODES, library verify_u32);
# its radix-11 entry in this library stays the yardstick, launched by name in
# phases 3 and 6 (a launch kind's library field; None: the routed library).
U32_KIND = (4, "projective", "lazy", "tree", "half")
YARDSTICK_LIBRARY = "verify_half"
U32_LANES = (1, 31, 33, 4097)  # phase 3's extra batches of each 8-word kernel
# The eager affine tuples of csrc/verify_u32_modes.cu, one a (width, select,
# square), with the shift-add multiply (cuda_kernel.U32_MODES_TUPLES): the
# one-hot ones at 4 and 5 bits (libraries verify_u32_modes_half / _mul,
# verify_u32_modes5_half / _mul), then the tree ones at 4 bits
# (verify_u32_modes_tree_half / _mul); their radix-11 entries in
# verify_half and verify_mul stay their yardsticks.
U32_MODES_KINDS = (*((wb, "affine", "eager", "onehot", sqr) for wb in (4, 5)
                     for sqr in SQR_MODES),
                   *((4, "affine", "eager", "tree", sqr) for sqr in SQR_MODES))
# Each kind whose shift-add route is an 8-word kernel -> the library of its
# radix-11 yardstick, launched by name in phases 3 and 6.
YARDSTICKS = {U32_KIND: YARDSTICK_LIBRARY,
              **{kind: f"verify_{kind[4]}" for kind in U32_MODES_KINDS}}
# The block_ingest phase's blocks: a coinbase and BLOCK_TXS transactions of
# the generator's mix, every BLOCK_INVALID_EVERY-th one corrupted (~390 KB;
# at 2,000, a full pre-SegWit block, the whole script took 595 s of its
# 600 s budget on an H100 host), and a BCH regtest block of BCH_BLOCK_TXS
# (every fourth transaction BCH-Schnorr-signed).  main() runs the BTC block
# alone since a run of the whole script took 556.9 s on an H100 host (the
# cut order of ROADMAP's ground rules; node_sync still syncs a BCH chain).
BLOCK_TXS, BLOCK_INVALID_EVERY, BLOCK_SEED = 1000, 9, 0xB10C
BCH_BLOCK_TXS = 500
MAIN_BCH_BLOCK_TXS = 0  # main()'s block_ingest: no BCH block
# The node_sync phase: a BCH regtest chain of NODE_BLOCKS blocks of
# NODE_TXS_PER_BLOCK transactions of the mix and a coinbase (260 in all;
# 8 blocks until a run of the whole script took 566.9 s on an H100 host),
# synced by a port Node, then NODE_LOOSE_TXS loose transactions relayed into
# its mempool, every NODE_INVALID_EVERY-th corrupted.
NODE_BLOCKS, NODE_TXS_PER_BLOCK, NODE_LOOSE_TXS = 4, 64, 64
NODE_INVALID_EVERY, NODE_SEED = 5, 0x40DE
NODE_SYNC_TIMEOUT_S = 300
# The fleet phase (6b): (a) the main path's block sharded over every visible
# card, or over two shards of the one card, timed in FLEET_TIMED_RUNS turns
# with the unsharded launch; (a') an engine at VerifyConfig(mesh_devices=2)
# over FLEET_MESH_ITEMS rows; (b) a FLEET_HOSTS-host fleet engine at
# VerifyConfig's defaults: FLEET_SUBMISSIONS keyed submissions of
# FLEET_SUBMISSION_ITEMS rows a round (a round homed on one host is four
# 32,768-lane lanes: an idle peer steals the first two, the host serves the
# rest), a partition of h1 (at most FLEET_PARTITION_ROUNDS rounds until it
# fires, as many for its canary) and its rejoin, waited for up to the
# breaker's cooldown and FLEET_REJOIN_SLACK_S; (c) the node_sync node on
# such an engine.
FLEET_HOSTS = 2
FLEET_SUBMISSIONS, FLEET_SUBMISSION_ITEMS = 8, 16384
FLEET_PARTITION_ROUNDS = 10
FLEET_REJOIN_SLACK_S = 30.0
FLEET_TIMED_RUNS = 3
FLEET_MESH_ITEMS = 8192  # (a') the mesh_devices engine's rows, through verify_raw_sync
# The field_mul_dot probe's int8 multiply-adds a lane: the (48, 576) padded
# scatter against four byte planes of the 576 products, the least the
# dot_general formulation needs for one convolution.
DOT_MACS_PER_LANE = 48 * 576 * 4
# mma.sync.aligned.m16n8k32 in a function that contracts: the body of the
# step loop of csrc/field_dot.cuh's dot_warp, 3 m-tiles x 4 n-tiles x 4
# byte planes (conv_dot and sqr_dot of the dot_general verify libraries,
# field_mul_dot_kernel of the probes).
DOT_MMA_IN_PTX = 3 * 4 * 4


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
                        reduce: str = "lazy", select: str = "tree", sqr: str = "half") -> dict:
    """int32 operations per lane that the kernel's source (csrc/*.cuh) does
    at ``window_bits`` in ``point_form`` with ``reduce``'s point formulas,
    ``select``'s table select and ``sqr``'s square, function by function,
    by the pipe that can issue them on Hopper:

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
    AND-OR (LOP3) a word of the entry: ALU pipe.  A square is the half
    product (300 products and the 24 adds of ``d = a + a``) or, under
    ``sqr="mul"``, the general convolution (576 products)."""
    from tpunode_torch.verify.width import windows as window_rounds

    if sqr not in SQR_MODES:
        raise ValueError(f"sqr mode {sqr!r} not in {SQR_MODES}")
    NL, NW = 24, 47
    windows, entries = window_rounds(window_bits), 1 << window_bits

    def carry(n):  # n-1 masks and n-1 shift-adds
        return _ops(alu=2 * (n - 1))

    fold_top = carry(NL + 1) + _ops(flex=3)  # FOLD's third limb is 0
    conv = _ops(mul=NL * NL)
    # the square's convolution: the half product and d = a + a, or conv(a, a)
    sqr_conv = conv if sqr == "mul" else _ops(mul=NL * (NL + 1) // 2, flex=NL)
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
                            reduce: str = "lazy", sqr: str = "half") -> dict:
    """Calls of the kernel's ``__noinline__`` functions a lane makes (each
    passes its operands through the thread's stack), counted from the
    source as :func:`kernel_ops_per_lane` counts operations: ``mul``,
    ``mul_t``, ``sqr`` and ``sqr_t`` are three calls (with their
    convolution and reduction); the lazy ``pt_add`` 22 (itself, 12
    convolutions, 9 loose reductions), ``pt_add_mixed`` 20, ``pt_double``
    16; the eager ones one and three for each of their 12, 11 and 8
    products: 37, 34, 25; ``pow_const`` 1 + 14 muls + 64 windows of four
    squarings and a mul, ``canonical`` one.  Both table selects are
    inlined: the count is the same for each.  So it is for both squares
    (``sqr``): the full product calls ``conv`` where the half product calls
    ``sqr_conv``, one call for one."""
    from tpunode_torch.verify.width import windows as window_rounds

    if sqr not in SQR_MODES:
        raise ValueError(f"sqr mode {sqr!r} not in {SQR_MODES}")
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
               select: str = "tree", sqr: str = "half") -> Counter:
    """The kernel's int32 operations for one launch over ``lanes`` lanes
    whose sign flags hold ``negated`` set bits: each set bit negates the Y
    of one selected table entry in each window (33 at 4-bit, 27 at 5)."""
    from tpunode_torch.verify.width import windows

    per_lane = kernel_ops_per_lane(window_bits, point_form, reduce, select, sqr)[
        "schnorr_free" if schnorr_free else "full"]
    return _rep(lanes, per_lane) + _ops(flex=negated * windows(window_bits) * 24)


def u32_ops_per_lane(kind: tuple = U32_KIND) -> dict:
    """int32 operations per lane of an 8-word kernel at ``kind`` (width,
    form, reduce, select, sqr): csrc/verify_u32.cu at :data:`U32_KIND`, or
    csrc/verify_u32_modes.cu at one of :data:`U32_MODES_KINDS`, both over
    field_u32.cuh and curve_u32.cuh, function by function, by the pipe that
    issues them, as :func:`kernel_ops_per_lane` counts the radix-11 source:

    * ``mul``: a widening product, ``(uint64_t)a * b`` with a 64-bit addend
      (IMAD.WIDE.U32): two FMA-pipe issues, one for each half;
    * ``flex``: one word of an add or subtract with its carry (IADD3 or
      IADD3.X; a 64-bit sum is two), or a multiply by a small constant;
    * ``alu``: a funnel shift (SHF), a select or mask word (LOP3), a compare.

    ``mul_wide``: 64 products, each row's carry added to the next product
    (two flex) but the first; ``sqr_wide``: 28 cross products, their carries,
    the one-bit doubling of 16 words (SHF) and 8 squares added on the
    diagonal (four flex each); ``reduce_wide``: 8 products by 977 and two
    64-bit adds a column, then ``fold``: two ``add_fold_once`` (a product by
    977, a 64-bit add for each of the first two words and a carried add for
    each of the other six).  ``add`` / ``sub``: a carried word each, then the
    fold of the carry (two ``add_fold_once``) or of the borrow (two
    ``sub_fold_once``: a word each); ``mul_small``: 8 products and the fold;
    ``canonical``: one ``add_fold_once`` and a LOP3 a word.  The point
    formulas as curve_u32.cuh writes them: ``pt_add`` 12 products, 3
    ``mul_small``, 12 ``add``, 5 ``sub``; ``pt_double`` 6 products, 2
    squares, 3 ``mul_small``, 3 ``add``, 1 ``sub``.  A window: 4 doublings,
    4 adds, β·X of λQ's entry, a negation (``sub``) and a select of 8 words
    for each add, 4 digit masks.  ``from_radix11``: 24 limbs shifted into a
    64-bit window (an SHF pair and a 64-bit add each), 8 words out and the
    fold of the top.  Moves, loads, stores, branches and address arithmetic
    are not counted: a floor, as the radix-11 count is.

    At :data:`U32_MODES_KINDS` (verify_u32_modes.cu, either select): the
    eager bodies as curve_u32.cuh writes them, ``pt_add_eager`` 12
    products, 2 ``mul_small``, 14 ``add``, 5 ``sub``; ``pt_add_mixed_eager`` 11
    products, 2 ``mul_small``, 10 ``add``, 3 ``sub``; ``pt_double_eager``
    6 products, 2 squares, 2 ``mul_small``, 5 ``add``, 1 ``sub``; every
    square ``sqr`` or, under ``sqr="mul"``, ``mul``, in the pow ladders too
    (64 4-bit windows at either width).  With E = 2^width entries a table
    (16 or 32): the affine table, E - 2 complete adds, E - 3 prefix
    products, the Fermat ladder and the suffix pass's 3 (E - 2) + E - 3
    products (14, 13 and 55 at 4 bits; 30, 29 and 119 at 5).  A window
    (33 at 4 bits, 27 at 5): ``width`` doublings and, for each of its 4
    mixed adds (every one counted, a digit 0 included, since a warp issues
    it whenever one of its lanes needs it), the select, a negation and a
    select of 8 words, and a digit-0 compare; β·x once (λQ's entry), 4 digit
    masks.  The one-hot select is a compare and a negate for each of the E
    entries' masks and a LOP3 for each of an entry's 16 words; the tree
    select reads the entry of the digit by its index and counts nothing (a
    load and its address)."""
    from tpunode_torch.verify.width import windows

    if kind not in (U32_KIND, *U32_MODES_KINDS):
        raise ValueError(f"no 8-word kernel runs {kind}")
    add_fold_once = _ops(mul=2, flex=2 * 2 + 2 * 6)
    fold = _rep(2, add_fold_once)
    sub_fold_once = _ops(flex=1 + 2 * 8)
    mul_wide = _ops(mul=2 * 64, flex=2 * 7 + 2 * 7 * 7)
    sqr_wide = _ops(mul=2 * (28 + 8), flex=2 * (28 - 7) + 4 * 8, alu=16)
    reduce_wide = _ops(mul=2 * 8, flex=4 * 8) + fold
    mul = mul_wide + reduce_wide
    sqr = sqr_wide + reduce_wide
    add = _ops(flex=2 * 8) + fold
    sub = _ops(flex=2 * 8) + _rep(2, sub_fold_once)
    mul_small = _ops(mul=2 * 8) + fold
    canonical = add_fold_once + _ops(alu=8)
    is_zero = canonical + _ops(alu=8)
    eq = sub + is_zero
    select = _ops(alu=8)
    from_radix11 = _ops(alu=2 * 24, flex=2 * 24 + 2 * 8) + fold
    pt_add = _rep(12, mul) + _rep(3, mul_small) + _rep(12, add) + _rep(5, sub)
    pt_double = _rep(6, mul) + _rep(2, sqr) + _rep(3, mul_small) + _rep(3, add) + sub
    out = {"mul": mul, "sqr": sqr, "add": add, "sub": sub, "mul_small": mul_small,
           "reduce_wide": reduce_wide, "canonical": canonical, "from_radix11": from_radix11}
    if kind != U32_KIND:
        wb, entries = kind[0], 1 << kind[0]
        square = mul if kind[4] == "mul" else sqr
        pt_add = _rep(12, mul) + _rep(2, mul_small) + _rep(14, add) + _rep(5, sub)
        pt_add_mixed = _rep(11, mul) + _rep(2, mul_small) + _rep(10, add) + _rep(3, sub)
        pt_double = _rep(6, mul) + _rep(2, square) + _rep(2, mul_small) + _rep(5, add) + sub
        pow_const = _rep(14, mul) + _rep(64, _rep(4, square) + mul + _ops(alu=3))
        pick = _ops(alu=entries * (2 + 16)) if kind[3] == "onehot" else _ops()
        table = (_rep(entries - 2, pt_add) + _rep(entries - 3, mul)  # chain, prefix
                 + pow_const  # Fermat
                 # suffix: z^-1, x, y an entry, the running inverse
                 + _rep(3 * (entries - 2) + entries - 3, mul))
        window = (_rep(wb, pt_double) + _rep(4, pick + sub + select + pt_add_mixed)
                  + mul + _ops(alu=4 + 4))  # β·x; digit masks, digit-0 compares
        ecdsa = (_rep(2, from_radix11) + table + _rep(windows(wb), window)
                 + is_zero + _rep(2, from_radix11 + mul + eq)
                 + _rep(2, square) + mul + add + eq)
        full = ecdsa + mul + pow_const + eq + pow_const + mul + canonical + _ops(alu=1)
        return {**out, "schnorr_free": ecdsa, "full": full, "pt_add": pt_add,
                "pt_add_mixed": pt_add_mixed, "pt_double": pt_double, "square": square,
                "pow_const": pow_const, "select": pick}
    pow_const = _rep(14, mul) + _rep(64, _rep(4, sqr) + mul + _ops(alu=3))
    window = (_rep(4, pt_double) + _rep(4, pt_add + sub + select) + mul  # β·X
              + _ops(alu=4))  # digit masks
    ecdsa = (_rep(2, from_radix11) + _rep(14, pt_add)  # Q, its table
             + _rep(33, window)
             + is_zero + _rep(2, from_radix11 + mul + eq)  # R finite, x(R) = r or r + n
             + _rep(2, sqr) + mul + add + eq)  # on the curve
    full = ecdsa + mul + pow_const + eq + pow_const + mul + canonical + _ops(alu=1)
    return {**out, "schnorr_free": ecdsa, "full": full, "pt_add": pt_add,
            "pt_double": pt_double, "pow_const": pow_const}


def u32_bound_ms(lanes: int, schnorr_free: bool, sm_count: int, sm_clock_mhz: float,
                 kind: tuple = U32_KIND) -> tuple:
    """(least ms, what bounds it) of one launch of the 8-word kernel at
    ``kind`` over ``lanes``: :func:`u32_ops_per_lane` against the card's
    integer rates, or the launch's bytes (the same inputs as the radix-11
    kernel's at that width and form) over HBM bandwidth."""
    per_lane = u32_ops_per_lane(kind)["schnorr_free" if schnorr_free else "full"]
    return least_ms(_rep(lanes, per_lane), verify_bytes(lanes, kind[0], kind[1]), sm_count,
                    sm_clock_mhz)


def u32_select_bytes(lanes: int, kind: tuple = U32_KIND) -> dict:
    """Bytes an 8-word kernel's window loop reads to select its entries, as
    :func:`select_bytes` counts the radix-11 ones: Q's table for Q and for
    λQ (local memory) and G's and λG's (shared), in each of the kind's
    windows (33 at 4 bits, 27 at 5): entries of 96 B (x, y, z) in the
    projective form, 64 B (x, y) in the affine one; the tree select reads the
    one entry of the digit, the one-hot select all 2^width."""
    from tpunode_torch.verify.width import windows

    wb = kind[0]
    read = (1 << wb) if kind[3] == "onehot" else 1
    per_table = lanes * windows(wb) * read * (64 if kind[1] == "affine" else 96)
    return {"local": 2 * per_table, "shared": 2 * per_table}


def _tree_ops(entries: int) -> Counter:
    """The probes' branch-free select tree over ``entries`` entries: a mask
    a level (a shift and an AND, then a negate) and, for each of its
    entries - 1 selects, one LOP3 a word for (odd & m) | (even & ~m)."""
    levels = entries.bit_length() - 1
    return _ops(alu=levels * 3 + (entries - 1) * 24)


#: The probes of one function, canonical(a·b), in its three formulations.
FIELD_MUL_PROBES = ("field_mul", "field_mul_dot", "field_mul_u32")


def u32_probe_ops_per_lane() -> Counter:
    """int32 operations per lane of the field_mul_u32 probe, counted as
    :func:`u32_ops_per_lane` counts: two conversions from radix-11 rows, one
    8-word multiply, the canonical form, and the 24 limbs written back (a
    shift and a mask each, an OR where a limb spans two words)."""
    ops = u32_ops_per_lane()
    return (_rep(2, ops["from_radix11"]) + ops["mul"] + ops["canonical"]
            + _ops(alu=2 * 24 + 7))


def probe_ops_per_lane(probe: str) -> Counter:
    """int32 operations per lane (per element for trivial) of a probe kernel
    (csrc/diag.cu), counted as :func:`kernel_ops_per_lane` counts: one add
    (trivial); one ``mul`` and the canonical form (field_mul); two
    convolutions, their 47 sums, one loose reduction and the canonical form
    (lazy_reduce); field_mul_dot's and field_mul_u32's are field_mul's, the
    same function (their own formulations' counts are
    :func:`dot_formulation_bound_ms`'s and :func:`u32_probe_ops_per_lane`'s);
    one lazy mixed add; the batch inversion's 13 column
    and 13 prefix multiplies, the Fermat ladder, the suffix step's two
    multiplies and the canonical form (batch_inv); the 14 table multiplies,
    the 16-entry tree and the canonical form (select_tree); the 14 table
    multiplies, 64 windows of four squarings, a one-hot select (a compare
    and 24 LOP3s an entry) and a multiply, and the canonical form (both
    pow_window cases); the 14 table multiplies and the canonical form
    (table_build); the static ladder's squarings and multiplies
    (``cuda_diag.descan_calls``: no select) and the canonical form
    (pow_descan); or the 30 table multiplies, two 32-entry trees, one
    multiply and the canonical form (window5)."""
    from tpunode_torch.cuda_diag import descan_calls

    ops = kernel_ops_per_lane()
    if probe == "trivial":
        return _ops(flex=1)
    if probe in FIELD_MUL_PROBES:
        return ops["mul"] + ops["canonical"]
    if probe == "lazy_reduce":
        return (_ops(mul=2 * 24 * 24, flex=2 * 24 - 1) + ops["reduce_wide_loose"]
                + ops["canonical"])
    if probe == "mixed_add":
        return ops["pt_add_mixed"]
    if probe == "select_tree":
        return _rep(14, ops["mul"]) + _tree_ops(16) + ops["canonical"]
    if probe == "table_build":
        return _rep(14, ops["mul"]) + ops["canonical"]
    if probe == "pow_descan":
        calls = descan_calls()
        return _rep(calls["sqr"], ops["sqr"]) + _rep(calls["mul"], ops["mul"]) + ops["canonical"]
    if probe in ("pow_window", "pow_window_smem"):
        window = _rep(4, ops["sqr"]) + _ops(alu=16 * (1 + 24)) + ops["mul"]
        return _rep(14, ops["mul"]) + _rep(64, window) + ops["canonical"]
    if probe == "window5":
        return _rep(31, ops["mul"]) + _rep(2, _tree_ops(32)) + ops["canonical"]
    return _rep(13 + 13 + 2, ops["mul"]) + ops["pow_const"] + ops["canonical"]


#: Rows of 24 limbs a probe lane reads and writes.
_PROBE_ROWS = {"field_mul": 2 + 1, "field_mul_dot": 2 + 1, "field_mul_u32": 2 + 1,
               "lazy_reduce": 4 + 1, "mixed_add": 4 + 3, "batch_inv": 1 + 1,
               "table_build": 1 + 1, "pow_descan": 1 + 1, "select_tree": 1 + 1,
               "pow_window": 1 + 1, "pow_window_smem": 1 + 1, "window5": 1 + 1}


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


def dot_formulation_bound_ms(lanes: int, sm_count: int, sm_clock_mhz: float) -> tuple:
    """(least ms, what bounds it) of the field_mul_dot probe's own
    formulation over ``lanes``: :func:`least_ms` of the int32 work — the
    ``field_mul`` probe's (576 products on the FMA pipe, the carry rounds,
    the reduction and the canonical form), two byte permutes for each of
    the four plane words of each four products (ALU pipe) and three
    shift-adds to recombine each of the 47 sums' planes — beside the
    tensor cores' time for :data:`DOT_MACS_PER_LANE` int8 multiply-adds a
    lane at :data:`TENSOR_INT8_MACS_PER_CLK_PER_SM` over the run's SMs and
    clock ("tensor"), whichever is longer.  The A fragments the kernel
    builds from indices and its recombination at every k-step are its
    own choice, not counted: a floor."""
    ops = _rep(lanes, probe_ops_per_lane("field_mul") + _ops(alu=2 * 576, flex=3 * 47))
    ms, by = least_ms(ops, probe_bytes("field_mul_dot", lanes), sm_count, sm_clock_mhz)
    tensor_ms = 1e3 * lanes * DOT_MACS_PER_LANE / (
        TENSOR_INT8_MACS_PER_CLK_PER_SM * sm_count * sm_clock_mhz * 1e6)
    return (tensor_ms, "tensor") if tensor_ms > ms else (ms, by)


def bound_ms(ops: Counter, lanes: int, sm_count: int, sm_clock_mhz: float,
             window_bits: int = 4, point_form: str = "projective") -> tuple:
    """(least ms, what bounds it) for one verify launch over ``lanes``."""
    return least_ms(ops, verify_bytes(lanes, window_bits, point_form), sm_count, sm_clock_mhz)


def convolutions_per_lane(window_bits: int = 4, point_form: str = "projective",
                          reduce: str = "lazy") -> dict:
    """Convolutions a lane makes (``conv`` and ``sqr_conv`` calls; under
    dot_general ``conv_dot`` and ``sqr_dot``), by variant: the limb
    products of the full-product program over 576, since each of its
    convolutions makes 576 and nothing else multiplies two limbs.  Both
    squares, both selects and both multiplies make the same number."""
    ops = kernel_ops_per_lane(window_bits, point_form, reduce, "tree", "mul")
    return {v: ops[v]["mul"] // (24 * 24) for v in ("schnorr_free", "full")}


def dot_kernel_bound_ms(lanes: int, negated: int, schnorr_free: bool, window_bits: int,
                        point_form: str, reduce: str, select: str, sqr: str, sm_count: int,
                        sm_clock_mhz: float) -> tuple:
    """(least ms, what bounds it) of a dot_general verify launch's own
    formulation over ``lanes``: :func:`dot_formulation_bound_ms` from one
    contraction to the kernel's count of them (:func:`convolutions_per_lane`)
    — the shift-add kernel's int32 work in ``sqr``'s square, with two byte
    permutes a limb product and three shift-adds to recombine each of a
    contraction's 47 sums (int32 pipes), beside the tensor cores' time for
    :data:`DOT_MACS_PER_LANE` int8 multiply-adds a contraction at
    :data:`TENSOR_INT8_MACS_PER_CLK_PER_SM` over the run's SMs and clock
    ("tensor"), whichever is longer.  A floor, as the probe's is."""
    ops = kernel_ops(lanes, negated, schnorr_free, window_bits, point_form, reduce, select, sqr)
    convs = convolutions_per_lane(window_bits, point_form, reduce)[
        "schnorr_free" if schnorr_free else "full"]
    ops += _ops(alu=2 * ops["mul"], flex=3 * 47 * convs * lanes)
    ms, by = bound_ms(ops, lanes, sm_count, sm_clock_mhz, window_bits, point_form)
    tensor_ms = 1e3 * lanes * convs * DOT_MACS_PER_LANE / (
        TENSOR_INT8_MACS_PER_CLK_PER_SM * sm_count * sm_clock_mhz * 1e6)
    return (tensor_ms, "tensor") if tensor_ms > ms else (ms, by)


def verify_bounds(lanes: int, negated: int, schnorr_free: bool, window_bits: int,
                  point_form: str, reduce: str, select: str, sqr: str, sm_count: int,
                  sm_clock_mhz: float, mul: str = "shift_add", library: str | None = None
                  ) -> dict:
    """A verify launch's bounds.  ``radix11_bound_ms`` counts the radix-11
    formulation's half-product square: both squares and both multiplies
    give the same limbs and verdicts, so an instantiation and its twins of
    the other square or multiply share it.  At 4-bit projective, whose
    inputs the 8-word kernel takes, ``u32_bound_ms`` counts that
    formulation (:func:`u32_bound_ms`), and ``bound_ms`` / ``bound_by``, the
    least work the function needs, are the smaller of the two; so at the
    eager affine tuples of :data:`U32_MODES_KINDS`, where
    ``u32_bound_ms`` is verify_u32_modes.cu's count at that width in the
    row's own square and select and the function's least is the half
    square's count at that width and select; elsewhere the radix-11
    count's.
    ``formulation_bound_ms`` counts what the launch runs: an 8-word
    kernel's count for a tuple routed to one (``library`` None, ``mul``
    "shift_add"), the radix-11 count in the square the
    instantiation runs (under "mul" the full product's 576 limb products,
    not 300; a ``library`` named, the yardstick, the half product) and,
    under ``mul="dot_general"``, its contractions
    (:func:`dot_kernel_bound_ms`)."""
    def at(square: str) -> tuple:
        return bound_ms(kernel_ops(lanes, negated, schnorr_free, window_bits, point_form,
                                   reduce, select, square),
                        lanes, sm_count, sm_clock_mhz, window_bits, point_form)

    ms, by = at("half")
    out = {"radix11_bound_ms": ms}
    if (window_bits, point_form) == U32_KIND[:2]:
        u32_ms, u32_by = u32_bound_ms(lanes, schnorr_free, sm_count, sm_clock_mhz)
        out["u32_bound_ms"] = u32_ms
        if u32_ms < ms:
            ms, by = u32_ms, u32_by
    half_kind = (window_bits, point_form, reduce, select, "half")
    if half_kind in U32_MODES_KINDS:
        # its own square's 8-word count; the function's least, the half square's
        out["u32_bound_ms"] = u32_bound_ms(lanes, schnorr_free, sm_count, sm_clock_mhz,
                                           (*half_kind[:4], sqr))[0]
        u32_ms, u32_by = u32_bound_ms(lanes, schnorr_free, sm_count, sm_clock_mhz, half_kind)
        if u32_ms < ms:
            ms, by = u32_ms, u32_by
    if mul == "dot_general":
        own = dot_kernel_bound_ms(lanes, negated, schnorr_free, window_bits, point_form,
                                  reduce, select, sqr, sm_count, sm_clock_mhz)[0]
    elif (library is None and mul == "shift_add"
          and (window_bits, point_form, reduce, select, sqr) in YARDSTICKS):
        own = out["u32_bound_ms"]
    else:
        own = out["radix11_bound_ms"] if sqr == "half" else at(sqr)[0]
    return {"bound_ms": ms, "bound_by": by, "formulation_bound_ms": own, **out}


def dot_over_shift_add(dot, shift, u32, timed) -> dict:
    """Phase 4's tensor-core and 8-word multiplies beside the shift-add one
    on the same inputs: ``dot``, ``shift`` and ``u32`` launch the
    field_mul_dot, field_mul and field_mul_u32 probe kernels; each is
    warmed once, then timed in turns (dot, shift-add, u32, u32, shift-add,
    dot), ``timed(fn, TIMED_LAUNCHES)`` a burst.  Returns each probe's mean
    ms, its runs, ``ratio`` (dot over shift-add) and ``u32_ratio`` (u32
    over shift-add)."""
    fns = {"field_mul_dot": dot, "field_mul": shift, "field_mul_u32": u32}
    for fn in fns.values():
        fn()
    runs = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        runs[name].append(timed(fns[name], TIMED_LAUNCHES))
    ms = {name: sum(r) / len(r) for name, r in runs.items()}
    return {"ms": ms, "ms_runs": runs, "ratio": ms["field_mul_dot"] / ms["field_mul"],
            "u32_ratio": ms["field_mul_u32"] / ms["field_mul"]}


def timed_ms(torch, fn, repeats: int) -> float:
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def trace_breakdown(path: str, window_name: str = "main_path") -> dict:
    """From a Chrome trace of one main-path run (``torch.profiler``): the
    window (the ``window_name`` range), the device's busy time inside it (the
    union of its kernels, copies and sets), the verify kernel's launches and
    device time (``verify_kernel`` or ``verify_u32_kernel``), and the host
    time in each ``verify.*`` span, with the part of it spent off the
    caller's thread (the engine's dispatch threads)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    window = next(e for e in events
                  if e["name"] == window_name and e.get("cat") == "user_annotation")
    lo, hi = window["ts"], window["ts"] + window["dur"]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, lo
    for a, b in device:
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    kernels = [e["dur"] for e in events  # the radix-11 template's or an 8-word kernel
               if e.get("cat") == "kernel"
               and re.search(r"verify_(?:u32_(?:modes_)?)?kernel", e["name"])]
    spans, off_caller = Counter(), Counter()
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("verify."):
            spans[e["name"]] += e["dur"] / 1e3
            if e.get("tid") != window.get("tid"):
                off_caller[e["name"]] += e["dur"] / 1e3
    return {"window_ms": window["dur"] / 1e3, "device_events": len(device),
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1 - busy / window["dur"] if device else None,
            "verify_kernel_launches": len(kernels), "verify_kernel_ms": sum(kernels) / 1e3,
            "span_ms": dict(spans), "span_ms_off_caller_thread": dict(off_caller)}


def device_kernels(path: str) -> dict:
    """Every device kernel of a Chrome trace (``torch.profiler``): {kernel
    name: [ms of each launch]}."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            out.setdefault(e["name"], []).append(e["dur"] / 1e3)
    return out


def u32_label(kind: tuple) -> str:
    """The 8-word kernel that ``kind`` (one of :data:`YARDSTICKS`) routes
    to: ``u32`` (verify_u32.cu), ``u32_modes/<sqr>`` (verify_u32_modes.cu
    at 4 bits, one-hot), ``u32_modes5/<sqr>`` (at 5 bits) or
    ``u32_modes_tree/<sqr>`` (4 bits, tree)."""
    if kind == U32_KIND:
        return "u32"
    return (f"u32_modes{'5' if kind[0] == 5 else ''}{'_tree' if kind[3] == 'tree' else ''}"
            f"/{kind[4]}")


def u32_ptxas_key(kind: tuple, variant: str) -> str:
    """:func:`ptxas_entries`' key of the 8-word kernel that ``kind`` (one of
    :data:`YARDSTICKS`) routes to, in ``variant``."""
    return f"{variant}/{u32_label(kind)}"


def btc_block_txs(count: int = BLOCK_TXS) -> list:
    """The block_ingest phase's BTC block: a coinbase, then ``count``
    transactions of the generator's mix, two inputs each, every
    :data:`BLOCK_INVALID_EVERY`-th one with its first signature corrupted."""
    from tpunode_torch import txgen

    return [txgen._coinbase(1)] + txgen.gen_mixed_txs(
        count, seed=BLOCK_SEED, inputs_per_tx=2, invalid_every=BLOCK_INVALID_EVERY)


def bch_block_txs(count: int = BCH_BLOCK_TXS) -> list:
    """The block_ingest phase's BCH block: ``gen_chain``'s first regtest
    block over ``count`` transactions of the mix (a header ground to the
    target on top of ``headers.genesis_node``)."""
    from tpunode_torch import txgen
    from tpunode_torch.params import BCH_REGTEST

    return list(txgen.gen_chain(BCH_REGTEST, 1, count, mix=True)[0].txs)


def ingest_block(engine, data: bytes, n_txs: int, bch: bool) -> dict:
    """One block's transaction region through the port's block-ingest
    path, step for step as the reference node takes it: one native parse
    (``ParsedTxRegion``), the prevout rows it lists, resolved by the
    generator's prevout oracle (``txgen.synth_prevout``) where the region
    wants them, the native extraction to ``RawSigItems``, ``verify_raw``
    at block priority, then ``combine`` into per-transaction ``(txid,
    valid, signature verdicts, stats)``.  The native extractor has no
    stand-in here: if ``libtxextract.so`` does not build or load, this
    raises.  Returns the items, the candidate verdicts, the per-transaction
    verdicts and the host milliseconds of each step."""
    from tpunode_torch import txgen
    from tpunode_torch.txextract import ParsedTxRegion

    t0 = time.perf_counter()
    with ParsedTxRegion(data, n_txs) as region:
        t1 = time.perf_counter()
        pv_txids, pv_vouts, pv_wants = region.scan_prevouts(bch)
        ext, ext_scripts = [-1] * len(pv_wants), [None] * len(pv_wants)
        for i in pv_wants.nonzero()[0]:
            ext[i], ext_scripts[i] = txgen.synth_prevout(pv_txids[i].tobytes(),
                                                         int(pv_vouts[i]))
        t2 = time.perf_counter()
        items = region.extract(bch=bch, intra_amounts=n_txs > 1, ext_amounts=ext,
                               ext_scripts=ext_scripts)
    t3 = time.perf_counter()

    async def submit() -> list:
        async with engine:
            return await engine.verify_raw(items, priority="block")

    verdicts = asyncio.run(submit())
    t4 = time.perf_counter()
    per_sig = items.combine(verdicts)
    per_tx = []
    for ti, sl in enumerate(items.sig_slices()):
        vs = tuple(per_sig[sl])
        per_tx.append((items.txid(ti), all(vs), vs, items.stats(ti)))
    return {"items": items, "verdicts": verdicts, "per_tx": per_tx,
            "ms": {"parse": (t1 - t0) * 1e3, "prevout_oracle": (t2 - t1) * 1e3,
                   "extract": (t3 - t2) * 1e3},
            "engine_seconds": t4 - t3}


def plain_extract(data: bytes, n_txs: int, bch: bool) -> tuple:
    """The port's Python extraction of the same region: ``wire.Tx``
    parses, then ``txverify.extract_sig_items`` with the amounts and scripts
    the native path resolves (the in-block outputs for every input, else
    the prevout oracle where the transaction-level gate wants them), as the
    reference node's Python path takes them.  Returns (txs, items, stats)."""
    from tpunode_torch import txgen, txverify
    from tpunode_torch.util import Reader
    from tpunode_torch.wire import Tx

    r = Reader(data)
    txs = [Tx.deserialize(r) for _ in range(n_txs)]
    if r.remaining():
        raise ValueError("trailing bytes after the transaction region")
    block_outs = txverify.intra_block_prevouts(txs) if n_txs > 1 else {}
    items, stats = [], []
    for tx in txs:
        amounts, scripts = {}, {}
        for idx, txin in enumerate(tx.inputs):
            key = (txin.prevout.txid, txin.prevout.index)
            hit = block_outs.get(key)
            if hit is None and txverify.wants_amount(tx, idx, bch):
                hit = txgen.synth_prevout(*key)
            if hit is not None:
                amounts[idx], scripts[idx] = hit
        its, st = txverify.extract_sig_items(tx, prevout_amounts=amounts or None, bch=bch,
                                             prevout_scripts=scripts or None)
        items.extend(its)
        stats.append(st)
    return txs, items, stats


_PRESENT = {"ecdsa": 1, "schnorr": 2, "bip340": 3}


def extraction_mismatches(items, py_items: list, py_stats: list) -> int:
    """Rows and transactions where the native ``RawSigItems`` differ from
    the Python path's items and stats: z (mod n), r and s (0 past 2^256, as
    the native rows hold them), the pubkey, the ``present`` code, the txid
    and input of each row; every ``ExtractStats`` counter of each
    transaction."""
    from tpunode_torch.verify.ecdsa_cpu import CURVE_N

    bad = abs(items.count - len(py_items)) + abs(items.n_txs - len(py_stats))
    for i, (row, it) in enumerate(zip(items.to_verify_items(), py_items)):
        q = row[0]
        got = (row[1], row[2], row[3], None if q is None else (q.x, q.y),
               int(items.present[i]), items.txid(int(items.item_tx[i])),
               int(items.item_input[i]))
        want = (it.z % CURVE_N, it.r if it.r < 2**256 else 0, it.s if it.s < 2**256 else 0,
                None if it.pubkey is None else (it.pubkey.x, it.pubkey.y),
                0 if it.pubkey is None else _PRESENT[it.algo], it.txid, it.input_index)
        bad += got != want
    for ti, st in enumerate(py_stats[: items.n_txs]):
        bad += dataclasses.astuple(items.stats(ti)) != dataclasses.astuple(st)
    return bad


def block_checks(ingest: dict, data: bytes, n_txs: int, bch: bool, cpu_verdicts: list,
                 expect_invalid) -> dict:
    """The block_ingest phase's comparisons for one block: the native
    extraction against the Python path, the candidate verdicts against the
    native CPU verifier's (``cpu_verdicts``), the per-transaction verdicts
    against ``txverify.combine_verdicts`` over the Python items and those
    CPU verdicts, and the transactions read invalid against
    ``expect_invalid(txs, items)``, the indices the block's maker
    corrupted.  Returns the counts and the mismatches of each."""
    from tpunode_torch import txverify

    items, per_tx = ingest["items"], ingest["per_tx"]
    txs, py_items, py_stats = plain_extract(data, n_txs, bch)
    py_per_sig = txverify.combine_verdicts(py_items, cpu_verdicts) if len(
        py_items) == items.count else []
    py_per_tx, at = [], 0
    for st in py_stats:
        py_per_tx.append(tuple(py_per_sig[at:at + st.sigs]))
        at += st.sigs
    invalid = sorted(ti for ti, (_, ok, _, _) in enumerate(per_tx) if not ok)
    expected = sorted(expect_invalid(txs, items))
    return {
        "txs": n_txs, "bytes": len(data), "inputs": int(items.tx_n_inputs.sum()),
        "candidate_items": items.count, "signatures": int(items.tx_sigs.sum()),
        "unsupported_inputs": int(items.tx_unsupported.sum()),
        "invalid_txs": len(invalid),
        "native_vs_plain_mismatches": extraction_mismatches(items, py_items, py_stats),
        "card_vs_cpu_mismatches": (sum(a != b for a, b in zip(ingest["verdicts"], cpu_verdicts))
                                   + abs(len(ingest["verdicts"]) - len(cpu_verdicts))),
        "per_tx_mismatches": (sum(a[2] != b for a, b in zip(per_tx, py_per_tx))
                              + abs(len(per_tx) - len(py_per_tx))
                              + sum(tx.txid != p[0] for tx, p in zip(txs, per_tx))),
        "invalid_vs_corrupted_mismatches": len(set(invalid) ^ set(expected)),
    }


def corrupted_btc_txs(txs: list, items) -> list:
    """The BTC block's transactions that must read invalid: the
    generator's corrupted ones (every :data:`BLOCK_INVALID_EVERY`-th after
    the coinbase) whose corrupted first input was extracted."""
    slices = items.tx_slices()
    return [ti for ti in range(1, len(txs))
            if (ti - 1) % BLOCK_INVALID_EVERY == BLOCK_INVALID_EVERY - 1
            and 0 in items.item_input[slices[ti]]]


def block_ingest_phase(engine, kind: tuple, reset_launches, engine_metrics,
                       btc_txs: int = BLOCK_TXS, bch_txs: int = BCH_BLOCK_TXS) -> tuple:
    """Phase 5c: the BTC block (:func:`btc_block_txs`) and, unless
    ``bch_txs`` is 0, the BCH block (:func:`bch_block_txs`) through
    :func:`ingest_block` on ``engine``, a
    warmed engine of the default tuple ``kind``, with every launch count
    zeroed just before each block and read just after.  Each block must be
    served by the card, grow ``verify.tpu_items`` by its candidate count and
    nothing else, launch only at ``kind`` in ``verify_u32``, and read 0 in
    every comparison of :func:`block_checks`; the BTC block runs under
    ``trace.profile_to``.  Raises on any fault, before anything of it
    is read, when ``libtxextract.so`` does not build or load.  Returns the
    phase's line (without its name) and the launches by variant."""
    from tpunode_torch import txextract
    from tpunode_torch.trace import profile_to, span
    from tpunode_torch.verify import cuda_kernel
    from tpunode_torch.verify.cpu_native import load_native_verifier
    from tpunode_torch.verify.raw import as_raw_batch

    if not txextract.have_native_extract():
        raise RuntimeError("block_ingest: native/build/libtxextract.so does not build or load, "
                           "and this path has no Python stand-in")
    t0 = time.perf_counter()
    blocks = {"btc": (btc_block_txs(btc_txs), False, corrupted_btc_txs)}
    if bch_txs:
        blocks["bch"] = (bch_block_txs(bch_txs), True, lambda txs, items: [])
    generate_s = time.perf_counter() - t0
    cpu_verifier = load_native_verifier()
    rows, launches_by_variant, trace = {}, Counter(), None
    for block_name, (txs, bch, expect_invalid) in blocks.items():
        data = b"".join(tx.serialize() for tx in txs)
        before = engine_metrics()
        reset_launches()
        # the BTC block runs profiled: the window, the device's idle share
        # and the verify spans
        traced = block_name == "btc"
        with tempfile.TemporaryDirectory() as tmp:
            with profile_to(tmp if traced else None) as path:
                with span("block_ingest") if traced else contextlib.nullcontext():
                    ingest = ingest_block(engine, data, len(txs), bch)
            if traced:
                trace = trace_breakdown(path, "block_ingest")
        launches = {key: n for key, n in cuda_kernel.LAUNCHES.items() if n}
        by_library = {key: n for key, n in cuda_kernel.LIBRARY_LAUNCHES.items() if n}
        rung = engine.last_rung
        grew = {name: n - before[name] for name, n in engine_metrics().items()}
        items = ingest["items"]
        row = block_checks(ingest, data, len(txs), bch,
                           cpu_verifier.verify_raw(as_raw_batch(items)), expect_invalid)
        faults = [f"{key} {row[key]}" for key in row if key.endswith("mismatches") and row[key]]
        if rung != "tpu":
            faults.append(f"served by the rung {rung!r}")
        if grew != {"verify.tpu_items": items.count, "verify.cpu_items": 0,
                    "verify.failovers": 0, "verify.dispatch_errors": 0}:
            faults.append(f"the engine's counts grew by {grew}, expected {items.count} device "
                          f"items")
        if not by_library or {lib for lib, _ in by_library} != {cuda_kernel.U32_LIBRARY} or {
                key[:7] for key in launches} != {kind}:
            faults.append(f"launched {launches} ({by_library} by library), expected launches "
                          f"at {kind} in {cuda_kernel.U32_LIBRARY} alone")
        if block_name == "btc" and not row["invalid_txs"]:
            faults.append("no corrupted transaction was extracted")
        if faults:
            raise RuntimeError(f"block_ingest {block_name}: " + "; ".join(faults))
        launches_by_variant.update({variant: n for (_, variant), n in by_library.items()})
        rows[block_name] = {
            **row, "rung": rung, "grew": grew, "profiled": traced, "host_ms": ingest["ms"],
            "engine_seconds": ingest["engine_seconds"],
            "sigs_per_s": row["signatures"] / ingest["engine_seconds"],
            "candidate_items_per_s": row["candidate_items"] / ingest["engine_seconds"],
            "launches_by_library": {f"{lib}/{variant}": n
                                    for (lib, variant), n in by_library.items()}}
    return ({"generate_seconds": generate_s, "blocks": rows, "traced_btc": trace},
            launches_by_variant)


# ---------- the node_sync phase ----------------------------------------------


class _QueuePipe:
    """One side of an in-memory duplex byte pipe: what a node's transport
    (``NodeConfig.connect``) hands its peer session."""

    def __init__(self, inbound: asyncio.Queue, outbound: asyncio.Queue):
        self._in, self._out = inbound, outbound

    async def read_chunk(self) -> bytes:
        return await self._in.get()

    async def write(self, data: bytes) -> None:
        self._out.put_nowait(bytes(data))


class WireRemote:
    """An in-memory remote node that speaks the wire protocol over the
    port's ``wire`` codec: it sends its ``version``, answers ``version``
    with ``verack``, ``ping`` with ``pong``, ``getheaders`` with every
    header of ``blocks``, and ``getdata`` with the blocks and the loose
    transactions asked for (``notfound`` for anything else).
    :meth:`announce` sends one ``inv`` of every loose transaction.  Every
    reply is encoded once, here, outside the timed part."""

    def __init__(self, net, blocks: list, loose: list):
        from tpunode_torch import wire as W

        self.net, self.W = net, W
        self.blocks = {b.header.hash: W.encode_message(net, W.MsgBlock(b)) for b in blocks}
        self.txs = {tx.txid: W.encode_message(net, W.MsgTx(tx)) for tx in loose}
        self.headers = W.encode_message(net, W.MsgHeaders(tuple((b.header, len(b.txs))
                                                                for b in blocks)))
        self.inv = W.encode_message(net, W.MsgInv(tuple(W.InvVector(W.InvType.TX, tx.txid)
                                                        for tx in loose)))
        self.height = len(blocks)
        self.to_node: list = []
        self.served = Counter()

    def announce(self) -> None:
        for q in self.to_node:
            q.put_nowait(self.inv)

    async def _serve(self, to_node: asyncio.Queue, from_node: asyncio.Queue) -> None:
        W, net = self.W, self.net
        from tpunode_torch.params import NODE_NETWORK

        local = W.NetworkAddress.from_host_port("::1", 0, services=NODE_NETWORK)
        to_node.put_nowait(W.encode_message(net, W.MsgVersion(
            version=70012, services=NODE_NETWORK, timestamp=int(time.time()),
            addr_recv=W.NetworkAddress.from_host_port("::1", 0), addr_from=local,
            nonce=random.getrandbits(64), user_agent=b"/chip_smoke:0/",
            start_height=self.height, relay=True)))
        buf = bytearray()
        while True:
            chunk = await from_node.get()
            if not chunk:
                return
            buf += chunk
            while len(buf) >= W.HEADER_SIZE:
                hdr = W.decode_message_header(net, bytes(buf[:W.HEADER_SIZE]))
                if len(buf) < W.HEADER_SIZE + hdr.length:
                    break
                payload = bytes(buf[W.HEADER_SIZE:W.HEADER_SIZE + hdr.length])
                del buf[:W.HEADER_SIZE + hdr.length]
                msg = W.decode_message(net, hdr, payload)
                if isinstance(msg, W.MsgPing):
                    to_node.put_nowait(W.encode_message(net, W.MsgPong(msg.nonce)))
                elif isinstance(msg, W.MsgVersion):
                    to_node.put_nowait(W.encode_message(net, W.MsgVerAck()))
                elif isinstance(msg, W.MsgGetHeaders):
                    to_node.put_nowait(self.headers)
                elif isinstance(msg, W.MsgGetData):
                    missing = []
                    for iv in msg.invs:
                        enc = self.blocks.get(iv.hash) if iv.type in (
                            W.InvType.BLOCK, W.InvType.WITNESS_BLOCK) else self.txs.get(iv.hash)
                        if enc is None:
                            missing.append(iv)
                        else:
                            self.served["block" if iv.hash in self.blocks else "tx"] += 1
                            to_node.put_nowait(enc)
                    if missing:
                        to_node.put_nowait(W.encode_message(net, W.MsgNotFound(tuple(missing))))

    def connect(self, sa):
        """``NodeConfig.connect``: a pipe to this remote, whatever the address."""
        @contextlib.asynccontextmanager
        async def factory():
            to_node, from_node = asyncio.Queue(), asyncio.Queue()
            self.to_node.append(to_node)
            task = asyncio.ensure_future(self._serve(to_node, from_node))
            try:
                yield _QueuePipe(to_node, from_node)
            finally:
                self.to_node.remove(to_node)
                task.cancel()
                with contextlib.suppress(asyncio.CancelledError, Exception):
                    await task

        return factory


def node_chain(n_blocks: int = NODE_BLOCKS, txs_per_block: int = NODE_TXS_PER_BLOCK) -> list:
    """The node_sync phase's chain: ``gen_chain(BCH_REGTEST, ...)`` with the
    script mix (every fourth transaction BCH-Schnorr-signed)."""
    from tpunode_torch import txgen
    from tpunode_torch.params import BCH_REGTEST

    return txgen.gen_chain(BCH_REGTEST, n_blocks, txs_per_block, mix=True)


def loose_txs(count: int = NODE_LOOSE_TXS) -> list:
    """The node_sync phase's loose transactions, relayed after the sync:
    the BCH mix (no taproot, every fourth BCH-Schnorr-signed), every
    :data:`NODE_INVALID_EVERY`-th one with its first signature corrupted."""
    from tpunode_torch import txgen

    return txgen.gen_mixed_txs(count, seed=NODE_SEED, invalid_every=NODE_INVALID_EVERY,
                               schnorr_every=4, taproot=False)


def cpu_tx_verdicts(data: bytes, n_txs: int, intra: bool, verifier) -> tuple:
    """The native extraction of one transaction region, as the node takes
    it (BCH, the prevout oracle ``txgen.synth_prevout`` on the rows the
    region wants, the in-region outputs first when ``intra``), verified by
    the native CPU verifier: (candidates, signatures, {txid: (valid,
    signature verdicts)})."""
    from tpunode_torch import txgen
    from tpunode_torch.txextract import ParsedTxRegion
    from tpunode_torch.verify.raw import as_raw_batch

    with ParsedTxRegion(data, n_txs) as region:
        txids, vouts, wants = region.scan_prevouts(True)
        ext, scripts = [-1] * len(wants), [None] * len(wants)
        for i in wants.nonzero()[0]:
            ext[i], scripts[i] = txgen.synth_prevout(txids[i].tobytes(), int(vouts[i]))
        items = region.extract(bch=True, intra_amounts=intra, ext_amounts=ext,
                               ext_scripts=scripts)
    per_sig = items.combine(verifier.verify_raw(as_raw_batch(items)) if items.count else [])
    out = {}
    for ti, sl in enumerate(items.sig_slices()):
        vs = tuple(per_sig[sl])
        out[items.txid(ti)] = (all(vs), vs)
    return items.count, int(items.tx_sigs.sum()), out


def node_sync_phase(kind: tuple, reset_launches, engine_metrics, verify=None,
                    n_blocks: int = NODE_BLOCKS, txs_per_block: int = NODE_TXS_PER_BLOCK,
                    loose: int = NODE_LOOSE_TXS) -> tuple:
    """Phase 5d: a port ``Node`` at ``NodeConfig``'s defaults (timeline,
    SLOs, flight recorder, watchdog) with its own engine (``verify``,
    default ``VerifyConfig()``: the card, the engine's shapes, the default
    tuple, ``min_tpu_batch`` 0), the UTXO set, the IBD planner
    (``batch_blocks=4``) and the mempool, the prevout oracle
    ``txgen.synth_prevout``, over a :class:`WireRemote` serving
    :func:`node_chain`.  The node syncs the headers, fetches the blocks
    through its planner, extracts each natively, verifies on the card and
    applies the UTXO set; after ``ChainSynced`` the remote announces
    :func:`loose_txs`, which the mempool fetches (``getdata``, ``tx``) and
    verifies.  Every launch count is zeroed just before the node starts and
    read after its verdicts.  Checks, each of which raises: ``ChainSynced``
    at the chain's height and the UTXO watermark there; one ``TxVerdict``
    for each transaction of the chain (a coinbase's with no signature) and
    each loose one, no error among them; every chain verdict valid; every
    verdict equal to the native CPU verifier's over the same extraction,
    and the loose corrupted ones among the invalid; ``verify.tpu_items``
    grown by the candidate count and ``verify.cpu_items``, failovers and
    dispatch errors by 0; no ``VerifyShed``; launches only at ``kind`` in
    ``verify_u32``; the engine's ``last_rung`` "tpu".  Raises before
    anything is built when ``libtxextract.so`` does not build or load.
    Returns the phase's line (without its name) and the launches by
    variant."""
    from tpunode_torch import txextract, txgen
    from tpunode_torch.ibd import IbdConfig
    from tpunode_torch.mempool import MempoolConfig
    from tpunode_torch.metrics import metrics
    from tpunode_torch.node import Node, NodeConfig, TxVerdict, VerifyShed
    from tpunode_torch.actors import Publisher
    from tpunode_torch.chain import ChainSynced
    from tpunode_torch.params import BCH_REGTEST
    from tpunode_torch.store import MemoryKV
    from tpunode_torch.verify import cuda_kernel
    from tpunode_torch.verify.cpu_native import load_native_verifier
    from tpunode_torch.verify.engine import VerifyConfig

    if not txextract.have_native_extract():
        raise RuntimeError("node_sync: native/build/libtxextract.so does not build or load, "
                           "and the node has no Python stand-in")
    t0 = time.perf_counter()
    blocks = node_chain(n_blocks, txs_per_block)
    relayed = loose_txs(loose)
    generate_s = time.perf_counter() - t0
    remote = WireRemote(BCH_REGTEST, blocks, relayed)
    cpu = load_native_verifier()
    want_chain, candidates, signatures = {}, 0, 0
    for b in blocks:
        n, s, got = cpu_tx_verdicts(b"".join(tx.serialize() for tx in b.txs), len(b.txs),
                                    len(b.txs) > 1, cpu)
        candidates, signatures = candidates + n, signatures + s
        want_chain.update(got)
    n, s, want_loose = cpu_tx_verdicts(b"".join(tx.serialize() for tx in relayed),
                                       len(relayed), False, cpu)
    candidates, signatures = candidates + n, signatures + s
    corrupted = {relayed[i].txid for i in range(NODE_INVALID_EVERY - 1, len(relayed),
                                                 NODE_INVALID_EVERY)}
    expected_s = time.perf_counter() - t0 - generate_s
    cfg = NodeConfig(
        net=BCH_REGTEST, store=MemoryKV(), pub=Publisher(name="node-sync", maxsize=None),
        peers=["192.0.2.9:18444"], connect=remote.connect,
        verify=verify if verify is not None else VerifyConfig(),
        prevout_lookup=txgen.synth_prevout, utxo=True,
        ibd=IbdConfig(batch_blocks=4, tick_interval=0.02), mempool=MempoolConfig())
    verdicts, synced, sheds, at = {}, [], [], {}

    async def run():
        # the node's own engine warms up (it starts at construction)
        # before the node starts and before the counts are zeroed: every
        # launch and item counted below is the node's ingest
        node = Node(cfg)
        engine = node.verify_engine
        t_warm = time.perf_counter()
        state = await asyncio.to_thread(engine.wait_warmup, NODE_SYNC_TIMEOUT_S)
        at["warmup_seconds"] = time.perf_counter() - t_warm
        if state != "ready":
            raise RuntimeError(f"node_sync: the node's engine is {state} after its warmup: "
                               f"{engine.stats()['device_error']}")
        at["spans0"] = {k: v for k, v in metrics.flat_sample().items()
                        if k.startswith("span.")}
        at["before"] = engine_metrics()
        reset_launches()
        async with cfg.pub.subscription() as events:
            t_start = time.perf_counter()
            async with node:
                at["engine"] = (engine.cfg.window_bits, engine.cfg.point_form,
                                engine.cfg.field_reduce, engine.select, engine.ladder,
                                engine.cfg.field_sqr, engine.cfg.field_mul)
                async with asyncio.timeout(NODE_SYNC_TIMEOUT_S):
                    while (len(verdicts) < len(want_chain) + len(want_loose)
                           or node.utxo is None or node.utxo.height < len(blocks)):
                        try:
                            ev = await asyncio.wait_for(events.receive(), 0.05)
                        except TimeoutError:
                            continue
                        if isinstance(ev, ChainSynced):
                            synced.append(ev.node.height)
                            at.setdefault("synced", time.perf_counter() - t_start)
                            remote.announce()
                        elif isinstance(ev, TxVerdict):
                            if ev.txid in verdicts:
                                raise RuntimeError(f"node_sync: a second verdict for "
                                                   f"{ev.txid[::-1].hex()}")
                            verdicts[ev.txid] = (ev.valid, tuple(ev.verdicts), ev.error)
                            if len(verdicts) == len(want_chain):
                                at.setdefault("chain_verdicts", time.perf_counter() - t_start)
                        elif isinstance(ev, VerifyShed):
                            sheds.append(ev.dropped_txs)
                at["seconds"] = time.perf_counter() - t_start
                at["watermark"] = node.utxo.height
                at["rung"] = engine.last_rung
                at["stats"] = {k: engine.stats()[k] for k in ("device_state", "breaker",
                                                              "failovers", "lanes", "fleet")
                               if k in engine.stats()}
                at["ibd"] = node.ibd.stats()
                at["mempool"] = {k: node.mempool.stats()[k] for k in ("size", "dedup_hits")}
                at["health"] = node.health()

    asyncio.run(run())
    launches = {key: n for key, n in cuda_kernel.LAUNCHES.items() if n}
    by_library = {key: n for key, n in cuda_kernel.LIBRARY_LAUNCHES.items() if n}
    grew = {name: n - at["before"][name] for name, n in engine_metrics().items()}
    spans0 = at["spans0"]
    spans = {k[len("span."):-len(".seconds")]: (v - spans0.get(k, 0.0)) * 1e3
             for k, v in metrics.flat_sample().items()
             if k.startswith("span.") and k.endswith(".seconds") and v > spans0.get(k, 0.0)}
    chain_bad = sum(verdicts.get(t, (None,))[:2] != w for t, w in want_chain.items())
    loose_bad = sum(verdicts.get(t, (None,))[:2] != w for t, w in want_loose.items())
    invalid_loose = {t for t in want_loose if verdicts.get(t, (True,))[0] is False}
    faults = []
    if synced != [len(blocks)] or at["watermark"] != len(blocks):
        faults.append(f"ChainSynced at {synced} and watermark {at['watermark']}, expected "
                      f"{len(blocks)}")
    if set(verdicts) != set(want_chain) | set(want_loose):
        faults.append(f"{len(verdicts)} verdicts for {len(want_chain)} chain and "
                      f"{len(want_loose)} loose transactions")
    if any(v[2] is not None for v in verdicts.values()):
        faults.append("a verdict carries an error: " + next(
            v[2] for v in verdicts.values() if v[2] is not None))
    if not all(verdicts.get(t, (False,))[0] for t in want_chain):
        faults.append("a chain transaction reads invalid")
    if chain_bad or loose_bad:
        faults.append(f"{chain_bad} chain and {loose_bad} loose verdicts differ from the native "
                      f"CPU verifier's")
    if not invalid_loose or not corrupted >= invalid_loose:
        faults.append(f"{len(invalid_loose)} loose transactions read invalid, expected some, "
                      f"all among the {len(corrupted)} corrupted")
    if grew != {"verify.tpu_items": candidates, "verify.cpu_items": 0, "verify.failovers": 0,
                "verify.dispatch_errors": 0}:
        faults.append(f"the engine's counts grew by {grew}, expected {candidates} device items")
    if sheds:
        faults.append(f"VerifyShed dropped {sum(sheds)} transactions")
    if at["engine"] != kind or not by_library or {lib for lib, _ in by_library} != {
            cuda_kernel.U32_LIBRARY} or {key[:7] for key in launches} != {kind}:
        faults.append(f"engine at {at['engine']} launched {launches} ({by_library} by library), "
                      f"expected launches at {kind} in {cuda_kernel.U32_LIBRARY} alone")
    if at["rung"] != "tpu":
        faults.append(f"the engine's last rung is {at['rung']!r}")
    if faults:
        raise RuntimeError("node_sync: " + "; ".join(faults))
    launches_by_variant = Counter({variant: n for (_, variant), n in by_library.items()})
    return ({"blocks": len(blocks), "chain_txs": len(want_chain), "loose_txs": len(want_loose),
             "candidates": candidates, "signatures": signatures, "verdicts": len(verdicts),
             "invalid_loose": len(invalid_loose), "corrupted_loose": len(corrupted),
             "chain_synced": synced, "watermark": at["watermark"], "rung": at["rung"],
             # every transaction's verdict, to compare one node's with another's
             "verdict_digest": hashlib.sha256(repr(sorted(
                 (txid.hex(), v) for txid, v in verdicts.items())).encode()).hexdigest(),
             "grew": grew, "sheds": 0,
             "launches_by_library": {f"{lib}/{variant}": n
                                     for (lib, variant), n in by_library.items()},
             "generate_seconds": generate_s, "expected_seconds": expected_s,
             "engine_warmup_seconds": at["warmup_seconds"], "sync_seconds": at["seconds"],
             "synced_after_seconds": at.get("synced"),
             "chain_verdicts_after_seconds": at.get("chain_verdicts"),
             "sigs_per_s": signatures / at["seconds"],
             "span_ms": spans, "engine": at["stats"], "ibd": at["ibd"],
             "mempool": at["mempool"], "remote_served": dict(remote.served),
             "health_ok": at["health"]["ok"]},
            launches_by_variant)


def sharded_dispatch_phase(raw, native: list, plain: list, modes: dict,
                           runs: int = FLEET_TIMED_RUNS) -> dict:
    """Phase 6b (a): ``raw`` (the main path's block) through
    ``multichip.dispatch_raw_sharded`` over every visible card, or over two
    shards of the one card (``[cuda:0, cuda:0]``, each shard on a stream of
    its own), held verdict for verdict against the unsharded launch on the
    first card, the plain version's verdicts ``plain`` (phase 6's output at
    these lanes, shared with its launches) and the native verifier's
    ``native``; a mismatch raises.  The sharded launches are counted by
    card and stream (``cuda_kernel.STREAM_LAUNCHES``, cleared just before
    one sharded dispatch): one a shard, each shard on its own stream, or it
    raises.  Then both are timed in turns (``runs`` each), wall time of the
    host prep, upload, launch and readback.  Returns the phase's row."""
    from tpunode_torch.verify import cuda_kernel
    from tpunode_torch.verify import kernel as K
    from tpunode_torch.verify import multichip as MC

    cards = MC.visible_devices()
    mesh = MC.Mesh(cards if len(cards) >= 2 else [cards[0], cards[0]])
    lanes = len(raw)

    def sharded() -> list:
        return K.collect_verdicts(*MC.dispatch_raw_sharded(raw, mesh, **modes))

    def unsharded() -> list:
        return K.collect_verdicts(*K.dispatch_batch_gpu_raw(raw, pad_to=lanes, device=cards[0],
                                                            **modes))

    cuda_kernel.STREAM_LAUNCHES.clear()
    got = sharded()
    by_stream = dict(cuda_kernel.STREAM_LAUNCHES)
    one = unsharded()
    mismatches = {name: sum(a != b for a, b in zip(got, want))
                  for name, want in (("unsharded", one), ("plain", plain), ("native", native))}
    by_device = Counter()
    for (dev, _), n in by_stream.items():
        by_device[dev] += n
    faults = []
    if len(got) != lanes or any(mismatches.values()):
        faults.append(f"{len(got)} verdicts for {lanes} lanes, mismatches {mismatches}")
    if by_device != Counter(str(d) for d in mesh.devices.flat) or len(by_stream) != mesh.size:
        faults.append(f"launched {by_stream} by (card, stream), expected one launch a shard "
                      f"of {mesh}, each on its own stream")
    if faults:
        raise RuntimeError("fleet sharded: " + "; ".join(faults))
    ms = {"sharded": [], "unsharded": []}
    for turn in range(runs):
        for name in (("sharded", "unsharded") if turn % 2 == 0 else ("unsharded", "sharded")):
            t0 = time.perf_counter()
            (sharded if name == "sharded" else unsharded)()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    return {"cards_visible": len(cards), "mesh": [str(d) for d in mesh.devices.flat],
            "lanes": lanes, "lanes_a_shard": lanes // mesh.size, "mismatches": mismatches,
            "launches_by_device": dict(by_device),
            "launches_by_stream": {f"{dev}/{handle:#x}": n
                                   for (dev, handle), n in by_stream.items()},
            "sharded_ms_runs": ms["sharded"], "unsharded_ms_runs": ms["unsharded"],
            "sharded_ms": sorted(ms["sharded"])[len(ms["sharded"]) // 2],
            "unsharded_ms": sorted(ms["unsharded"])[len(ms["unsharded"]) // 2]}


def mesh_engine_phase(raw, native: list, reset_launches, engine_metrics, cfg=None,
                      items: int = FLEET_MESH_ITEMS) -> tuple:
    """Phase 6b (a'): an engine at ``VerifyConfig(mesh_devices=2)`` (``cfg``),
    warmed before the counts are zeroed, verifies the first ``items`` rows
    of ``raw`` (``native`` their verdicts) through ``verify_raw_sync``.
    With two or more cards visible its device rung shards each chunk over
    them; with fewer the mesh fails soft to the engine's one card, never to
    the CPU: a ``verify.mesh`` event with ``state="failed"`` and
    ``stats()["mesh"]["state"] == "failed"``.  Checks, each of which
    raises: that state and event, the verdicts, the rung "tpu",
    ``verify.cpu_items`` +0, launches in ``verify_u32`` alone.  Returns the
    phase's row and the launches by variant."""
    from tpunode_torch.events import events
    from tpunode_torch.verify import cuda_kernel
    from tpunode_torch.verify import engine as E
    from tpunode_torch.verify.multichip import visible_devices

    seq0 = events.seq()
    cfg = cfg or E.VerifyConfig(mesh_devices=FLEET_HOSTS)
    engine = E.VerifyEngine(cfg)
    state = engine.wait_warmup(WARMUP_BOUND_S)
    if state != "ready":
        raise RuntimeError(f"fleet mesh: the engine is {state} after its warmup: "
                           f"{engine.stats()['device_error']}")
    before = engine_metrics()
    reset_launches()
    t0 = time.perf_counter()
    got = engine.verify_raw_sync(raw.slice(0, items))
    seconds = time.perf_counter() - t0
    launches = {key: n for key, n in cuda_kernel.LIBRARY_LAUNCHES.items() if n}
    grew = {name: n - before[name] for name, n in engine_metrics().items()}
    mesh = engine.stats()["mesh"]
    mesh_events = [e for e in events.tail_since(seq0, 100_000) if e["type"] == "verify.mesh"]
    cards = len(visible_devices())
    want = "ready" if cards >= cfg.mesh_devices else "failed"
    mismatches = sum(a != b for a, b in zip(got, native[:items]))
    faults = []
    if len(got) != items or mismatches:
        faults.append(f"{len(got)} verdicts for {items} items, {mismatches} mismatches")
    if mesh["state"] != want or [e["state"] for e in mesh_events] != [want]:
        faults.append(f"{cards} cards visible: mesh {mesh}, events {mesh_events}; expected "
                      f"{want}")
    if engine.last_rung != "tpu" or grew != {"verify.tpu_items": items, "verify.cpu_items": 0,
                                             "verify.failovers": 0,
                                             "verify.dispatch_errors": 0}:
        faults.append(f"rung {engine.last_rung}, counts grew by {grew}")
    if not launches or {lib for lib, _ in launches} != {cuda_kernel.U32_LIBRARY}:
        faults.append(f"launched {launches} by library, expected {cuda_kernel.U32_LIBRARY} alone")
    if faults:
        raise RuntimeError("fleet mesh: " + "; ".join(faults))
    return ({"mesh_devices": cfg.mesh_devices, "cards_visible": cards, "items": items,
             "mismatches": 0, "mesh": mesh,
             "mesh_events": [{k: e[k] for k in e if k not in ("ts", "seq", "type")}
                             for e in mesh_events],
             "rung": engine.last_rung, "grew": grew,
             "launches_by_library": {f"{lib}/{v}": n for (lib, v), n in launches.items()},
             "seconds": seconds},
            Counter({variant: n for (_, variant), n in launches.items()}))


def fleet_engine_phase(raw, native: list, reset_launches, engine_metrics, cfg=None,
                       submissions: int = FLEET_SUBMISSIONS,
                       items: int = FLEET_SUBMISSION_ITEMS) -> tuple:
    """Phase 6b (b): a two-host fleet engine (``cfg``, default
    ``VerifyConfig(mesh_hosts=2)``: the card, the engine's shapes, the
    default tuple), warmed before the counts are zeroed.  Three kinds of
    rounds, each ``submissions`` keyed submissions of ``items`` rows of
    ``raw`` (the main path's items, ``native`` their verdicts):

    1. keys spread over both hosts (rendezvous homes, ``AffinityMap``);
    2. with a ``mesh.dispatch`` partition of ``h1`` armed (one fire), keys
       homed on ``h1``, until the partition fired;
    3. once ``h1`` rejoined (its cooldown, ``BREAKER_COOLDOWN``), keys homed
       on it again, until its breaker's canary closed it.

    Checks, each of which raises: every verdict equal to the native one;
    every lane that left ``h1`` (re-queued in flight: the one the partition
    hit, and one whose dispatch then met ``h1``'s tripped breaker; moved
    from its queue at the deactivation) landed on ``h0``, each exactly once,
    and ``fleet.requeued`` counts exactly those; one host loss; ``h1``
    active again with its breaker "ready"; ``verify.tpu_items`` grown by
    every submitted row, ``verify.cpu_items``, failovers and dispatch
    errors by 0; launches in ``verify_u32`` alone; the hybrid mesh
    "failed" with a ``verify.mesh`` event saying so when fewer than two
    cards are visible (the hosts then run on the engine's one card),
    "ready" otherwise.  Returns the phase's row and the launches by
    variant."""
    from tpunode_torch.chaos import ChaosPlan, chaos
    from tpunode_torch.events import events
    from tpunode_torch.metrics import metrics
    from tpunode_torch.verify import cuda_kernel
    from tpunode_torch.verify import engine as E
    from tpunode_torch.verify.multichip import visible_devices
    from tpunode_torch.verify.sched import AffinityMap, host_names

    cfg = cfg or E.VerifyConfig(mesh_hosts=FLEET_HOSTS)
    hosts = host_names(cfg.mesh_hosts)
    if hosts[:2] != ["h0", "h1"]:
        raise RuntimeError(f"fleet: hosts {hosts}")
    engine = E.VerifyEngine(cfg)
    t0 = time.perf_counter()
    state = engine.wait_warmup(WARMUP_BOUND_S)
    warmup_s = time.perf_counter() - t0
    if state != "ready":
        raise RuntimeError(f"fleet: the engine is {state} after its warmup: "
                           f"{engine.stats()['device_error']}")
    amap = AffinityMap(hosts)
    homed = {h: [k for k in range(64 * submissions) if amap.prefer(k) == h] for h in hosts}
    spread = [homed[hosts[j % 2]][j // 2] for j in range(submissions)]
    seq0 = events.seq()
    losses0 = metrics.get("mesh.host_losses")
    before = engine_metrics()
    reset_launches()
    at = {"rounds": [], "items": 0, "mismatches": 0, "moves": []}

    async def run() -> None:
        async with engine:
            fleet = engine._fleet
            requeue, deactivate = fleet.requeue, fleet.deactivate

            def requeue_spy(host, lane):
                to = requeue(host, lane)
                at["moves"].append((lane, host, to, "in_flight"))
                return to

            def deactivate_spy(host):
                queued = list(fleet._queues[host])
                moved = deactivate(host)
                for lane in queued:
                    to = next((h for h, q in fleet._queues.items()
                               if any(x is lane for x in q)), None)
                    at["moves"].append((lane, host, to, "queued"))
                return moved

            fleet.requeue, fleet.deactivate = requeue_spy, deactivate_spy

            async def round_(name: str, keys: list) -> None:
                first = len(at["rounds"]) * submissions
                parts = []
                for j in range(submissions):
                    lo = (first + j) * items % (len(raw) - items)
                    parts.append((keys[j % len(keys)], lo, lo + items))
                t = time.perf_counter()
                got = await asyncio.gather(*(engine.verify_raw(raw.slice(lo, hi), affinity=k)
                                             for k, lo, hi in parts))
                at["rounds"].append({"round": name, "seconds": time.perf_counter() - t,
                                     "active": fleet.active_hosts()})
                at["items"] += submissions * items
                at["mismatches"] += sum(a != b for g, (_, lo, hi) in zip(got, parts)
                                        for a, b in zip(g, native[lo:hi]))

            await round_("spread", spread)
            at["spread_routed"] = fleet.affinity_routed
            chaos.install(ChaosPlan.parse("seed=3;mesh.dispatch:partition:match=h1,n=1"))
            try:
                for _ in range(FLEET_PARTITION_ROUNDS):
                    await round_("partition", homed["h1"])
                    if metrics.get("mesh.host_losses") > losses0:
                        break
            finally:
                chaos.uninstall()
            t = time.perf_counter()
            while "h1" not in fleet.active_hosts():
                if time.perf_counter() - t > E.BREAKER_COOLDOWN + FLEET_REJOIN_SLACK_S:
                    raise RuntimeError(f"fleet: h1 not back {E.BREAKER_COOLDOWN} s after its "
                                       f"loss: {engine.stats()['fleet']}")
                await asyncio.sleep(0.05)
            at["rejoin_wait_seconds"] = time.perf_counter() - t
            for _ in range(FLEET_PARTITION_ROUNDS):
                await round_("rejoin", homed["h1"])
                if engine._hosts["h1"].breaker.state == "ready":
                    break
            at["stats"] = engine.stats()

    t0 = time.perf_counter()
    asyncio.run(run())
    seconds = time.perf_counter() - t0
    launches = {key: n for key, n in cuda_kernel.LIBRARY_LAUNCHES.items() if n}
    grew = {name: n - before[name] for name, n in engine_metrics().items()}
    stats = at["stats"]
    fleet = stats["fleet"]
    moves = at["moves"]
    losses = metrics.get("mesh.host_losses") - losses0
    mesh_events = [e for e in events.tail_since(seq0, 100_000) if e["type"] == "verify.mesh"]
    cards = len(visible_devices())
    faults = []
    if at["mismatches"]:
        faults.append(f"{at['mismatches']} verdicts differ from the native verifier's")
    if losses != 1 or not 1 <= sum(m[3] == "in_flight" for m in moves) <= E.PIPELINE_DEPTH:
        faults.append(f"{losses} host losses, {moves} moves: expected one partition of h1")
    if (any((m[1], m[2]) != ("h1", "h0") for m in moves)
            or len({id(m[0]) for m in moves}) != len(moves)
            or any(m[0].requeues > 1 for m in moves) or fleet["requeued"] != len(moves)):
        faults.append(f"moves {[(m[1], m[2], m[3], m[0].requeues) for m in moves]}, "
                      f"requeued {fleet['requeued']}: expected each of h1's lanes once onto h0")
    if fleet["active"] != hosts or fleet["breakers"]["h1"] != "ready":
        faults.append(f"after the rejoin: active {fleet['active']}, breakers "
                      f"{fleet['breakers']}")
    if at["spread_routed"] != submissions:
        faults.append(f"{at['spread_routed']} of {submissions} spread submissions routed home")
    if grew != {"verify.tpu_items": at["items"], "verify.cpu_items": 0, "verify.failovers": 0,
                "verify.dispatch_errors": 0}:
        faults.append(f"the engine's counts grew by {grew}, expected {at['items']} device items")
    if not launches or {lib for lib, _ in launches} != {cuda_kernel.U32_LIBRARY}:
        faults.append(f"launched {launches} by library, expected {cuda_kernel.U32_LIBRARY} alone")
    want_hybrid = "ready" if cards >= cfg.mesh_hosts else "failed"
    if fleet["hybrid_state"] != want_hybrid or not any(
            e["state"] == want_hybrid for e in mesh_events):
        faults.append(f"{cards} cards visible: hybrid mesh {fleet['hybrid_state']}, events "
                      f"{mesh_events}; expected {want_hybrid}")
    if faults:
        raise RuntimeError("fleet engine: " + "; ".join(faults))
    return ({"hosts": hosts, "cards_visible": cards, "submissions_a_round": submissions,
             "items_a_submission": items, "items": at["items"], "mismatches": 0,
             "rounds": at["rounds"], "host_losses": losses,
             "moves": [{"from": m[1], "to": m[2], "lane_was": m[3], "items": m[0].total,
                        "requeues": m[0].requeues} for m in moves],
             "rejoin_wait_seconds": at["rejoin_wait_seconds"],
             "steals": fleet["steals"], "requeued": fleet["requeued"],
             "routed": fleet["affinity"]["routed"], "spilled": fleet["affinity"]["spilled"],
             "hybrid_state": fleet["hybrid_state"], "mesh_states": fleet["mesh_states"],
             "mesh_events": [{k: e[k] for k in e if k not in ("ts", "seq", "type")}
                             for e in mesh_events],
             "breakers": fleet["breakers"], "active": fleet["active"],
             "ledger_by_host": stats["ledger"].get("by_host"), "grew": grew,
             "launches_by_library": {f"{lib}/{v}": n for (lib, v), n in launches.items()},
             "warmup_seconds": warmup_s, "seconds": seconds},
            Counter({variant: n for (_, variant), n in launches.items()}))


def ptxas_entries(log: str, mul: str = "shift_add") -> dict:
    """Registers, shared memory, stack frame and spills of each
    instantiation of ``verify_kernel`` in nvcc's ``-Xptxas -v`` output,
    keyed ``"<variant>/w<bits>/<form>/<reduce>/<select>/<sqr>"``
    (``full/w4/projective/lazy/tree/half`` ..
    ``schnorr_free/w5/affine/eager/onehot/mul``), with ``"/dot_general"``
    after it when ``mul`` says the log is a dot_general library's (their
    kernels have the shift-add ones' names), of each instantiation of the
    8-word ``verify_u32_kernel``, keyed ``"<variant>/u32"``, of each of
    ``verify_u32_modes_kernel``, keyed ``"<variant>/u32_modes/<sqr>"`` at 4
    bits and ``"<variant>/u32_modes5/<sqr>"`` at 5 (one-hot),
    ``"<variant>/u32_modes_tree/<sqr>"`` (tree; :func:`u32_label`; a name
    without the select's argument, from a tree before it, is one-hot), and
    of each probe kernel, keyed by the probe (``trivial`` .. ``window5``)."""
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
        if m := re.search(r"verify_kernelILb([01])ELi([45])ELb([01])ELb([01])ELb([01])ELb([01])EE",
                          name or ""):
            variant = "schnorr_free" if m.group(1) == "1" else "full"
            form = "affine" if m.group(3) == "1" else "projective"
            reduce = "eager" if m.group(4) == "1" else "lazy"
            select = "onehot" if m.group(5) == "1" else "tree"
            sqr = "mul" if m.group(6) == "1" else "half"
            suffix = "/dot_general" if mul == "dot_general" else ""
            out[f"{variant}/w{m.group(2)}/{form}/{reduce}/{select}/{sqr}{suffix}"] = info
        elif m := re.search(r"verify_u32_kernelILb([01])EE", name or ""):
            out[f"{'schnorr_free' if m.group(1) == '1' else 'full'}/u32"] = info
        elif m := re.search(
                r"verify_u32_modes_kernelILi([45])ELb([01])ELb([01])E(?:Lb([01])E)?E", name or ""):
            kind = (int(m.group(1)), "affine", "eager", "tree" if m.group(4) == "1" else "onehot",
                    "mul" if m.group(3) == "1" else "half")
            out[u32_ptxas_key(kind, "schnorr_free" if m.group(2) == "1" else "full")] = info
        elif m := re.search(r"(trivial|field_mul_dot|field_mul_u32|field_mul|lazy_reduce"
                            r"|mixed_add|batch_inv|table_build|pow_descan|select_tree"
                            r"|pow_window_smem|pow_window|window5)_kernel", name or ""):
            out[m.group(1)] = info
    return out


def ptxas_vs_snapshot(ptxas: dict, snapshot: dict, nvcc: str, flags) -> dict:
    """The radix-11 shift-add verify entries of ``ptxas`` (:func:`ptxas_entries`'
    keys without ``"/dot_general"``, ``"/u32"`` or ``"/u32_modes/.."``) held field for field against
    ``snapshot``'s (``ptxas_snapshot.py``'s JSON).  ``comparable`` says
    whether the snapshot was built by the same nvcc release (``nvcc``, the
    last line of ``nvcc --version``) with the same ``flags``; ``differ``
    holds each entry whose lines are not the snapshot's.  A snapshot that
    names other entries raises."""
    keys = {key for key in ptxas
            if "/" in key and not key.endswith("/dot_general") and "/u32" not in key}
    if set(snapshot["entries"]) != keys:
        raise RuntimeError(f"the ptxas snapshot names {sorted(snapshot['entries'])}, this "
                           f"build {sorted(keys)}")
    differ = {key: {"snapshot": snapshot["entries"][key], "now": ptxas[key]}
              for key in sorted(keys) if snapshot["entries"][key] != ptxas[key]}
    return {"snapshot_of": snapshot["source"], "nvcc": nvcc, "snapshot_nvcc": snapshot["nvcc"],
            "comparable": (snapshot["nvcc"], list(snapshot["nvcc_flags"])) == (nvcc, list(flags)),
            "entries": len(keys), "equal": len(keys) - len(differ), "differ": differ}


_SASS_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)", re.M)
_SASS_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
#: The classes :func:`sass_classes` sums a function's opcodes into: the
#: widening multiply and its carry adds, the other multiplies and adds, the
#: logic and shifts, local, shared and global memory, and the rest.
SASS_CLASSES = ("IMAD.WIDE", "IMAD.HI", "IMAD.X", "IMAD", "IADD3.X", "IADD3", "LEA", "LOP3",
                "SHF", "ISETP", "SEL", "LDL", "STL", "LDS", "LDG", "other")


def sass_functions(text: str) -> dict:
    """Each function's opcodes in ``cuobjdump -sass`` output: {mangled name:
    Counter of opcodes with their modifiers (``IMAD.WIDE.U32``, ``IADD3.X``)}.
    A static count: a loop's body counts once."""
    heads = list(_SASS_FUNCTION.finditer(text))
    out = {}
    for head, nxt in zip(heads, heads[1:] + [None]):
        body = text[head.end():nxt.start() if nxt else len(text)]
        out[head.group(1)] = Counter(_SASS_OPCODE.findall(body))
    return out


def sass_classes(opcodes: Counter) -> dict:
    """An opcode Counter summed into :data:`SASS_CLASSES`, each opcode into
    the first class that is it or a prefix of it before a dot."""
    out = dict.fromkeys(SASS_CLASSES, 0)
    for op, n in opcodes.items():
        cls = next((c for c in SASS_CLASSES[:-1] if op == c or op.startswith(c + ".")), "other")
        out[cls] += n
    return out


def memory_opcodes(opcodes: Counter) -> dict:
    """The local and shared memory opcodes of an opcode Counter, each with
    its width modifier (``LDL.128``, ``LDL``, ``LDS.64``, ``STL.128``):
    what :func:`sass_classes` sums into LDL, STL and LDS, kept apart."""
    return {op: n for op, n in sorted(opcodes.items())
            if op.split(".")[0] in ("LDL", "STL", "LDS", "STS")}


def cuobjdump_sass(path: str):
    """``cuobjdump -sass`` of the library at ``path``, or None where the
    toolkit has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout


# ---------- the phases ------------------------------------------------------


def instantiations(widths, forms) -> list:
    """Every verify kernel instantiation's (width, form, reduce, select,
    sqr) but the variant: the forms in turn, the widths within each, the
    eager group right after the lazy group of its width and form, the
    one-hot pair right after its tree pair, and each full-product
    instantiation right after its half-product twin."""
    return [(wb, form, reduce, select, sqr) for form in forms for wb in widths
            for reduce in ("lazy", "eager") for select in ("tree", "onehot")
            for sqr in SQR_MODES]


def unroll_plain_keys(kinds) -> list:
    """Phase 3's (width, form, reduction) keys of the plain version under
    the unrolled ladders: one for each such key of ``kinds``, in their
    order, at the tree select and the half product (the ladder touches
    neither)."""
    return list(dict.fromkeys(kind[:3] for kind in kinds))


def with_ladder(kind: tuple, ladder: str, mul: str = "shift_add") -> tuple:
    """An instantiation's (width, form, reduce, select, sqr) as the key of
    an engine or a campaign under ``ladder`` and ``mul``: (width, form,
    reduce, select, ladder, sqr, mul), the order of
    ``cuda_kernel.LAUNCHES``'s keys."""
    return (*kind[:4], ladder, kind[4], mul)


def engine_kinds(kinds) -> list:
    """Phase 5's engines, (width, form, reduction, select, ladder, sqr,
    mul): each of ``kinds`` under the scan ladder and shift-add, with
    :data:`UNROLL_KIND` right after its scan twin, then each of ``kinds``
    under dot_general."""
    out = [with_ladder(kind, "scan") for kind in kinds]
    out.insert(out.index(with_ladder((*UNROLL_KIND[:4], UNROLL_KIND[5]), "scan")) + 1,
               UNROLL_KIND)
    return out + [with_ladder(kind, "scan", "dot_general") for kind in kinds]


def campaign_kinds(kinds) -> list:
    """Phase 7's campaigns: each of ``kinds`` under the scan ladder and
    shift-add, then :data:`UNROLL_KIND`, then each of ``kinds`` under
    dot_general."""
    return ([with_ladder(kind, "scan") for kind in kinds] + [UNROLL_KIND]
            + [with_ladder(kind, "scan", "dot_general") for kind in kinds])


@contextlib.contextmanager
def env_knob(var: str, value: str):
    """The environment variable ``var`` set to ``value`` inside, restored
    on exit."""
    prev = os.environ.get(var)
    os.environ[var] = value
    try:
        yield
    finally:
        if prev is None:
            del os.environ[var]
        else:
            os.environ[var] = prev


def select_knob(value: str):
    """``TPUNODE_SELECT16`` set to ``value`` inside, restored on exit."""
    return env_knob(SELECT_KNOB, value)


def ladder_knob(value: str):
    """``TPUNODE_POW_LADDER`` set to ``value`` inside, restored on exit."""
    return env_knob(LADDER_KNOB, value)


def sqr_knob(value: str):
    """``TPUNODE_FIELD_SQR`` set to ``value`` inside, restored on exit."""
    return env_knob(SQR_KNOB, value)


def mul_knob(value: str):
    """``TPUNODE_FIELD_MUL`` set to ``value`` inside, restored on exit."""
    return env_knob(MUL_KNOB, value)


def tree_over_onehot(rows: dict) -> list:
    """Phase 6's tree eager affine 8-word kernels over their one-hot twins:
    for each tree kind of :data:`U32_MODES_KINDS` and each (variant, lanes)
    of ``rows`` (:func:`kernel_timing`'s, both routed, shift-add, timed in
    the same turns), one line with both mean ms, their runs and ``ratio``,
    tree over one-hot."""
    out = []
    for kind in (k for k in U32_MODES_KINDS if k[3] == "tree"):
        twin = (*kind[:3], "onehot", kind[4])
        for (*rkind, mul, library, variant, lanes), row in rows.items():
            if tuple(rkind) != kind or (mul, library) != ("shift_add", None):
                continue
            onehot = rows[(*twin, mul, None, variant, lanes)]
            out.append({"kind": kind, "variant": variant, "lanes": lanes,
                        "library": row["library"], "onehot_library": onehot["library"],
                        "ms": row["ms"], "ms_runs": row["ms_runs"], "onehot_ms": onehot["ms"],
                        "onehot_ms_runs": onehot["ms_runs"], "ratio": row["ms"] / onehot["ms"],
                        "bound_ms": row["bound_ms"], "u32_bound_ms": row["u32_bound_ms"],
                        "onehot_u32_bound_ms": onehot["u32_bound_ms"]})
    return out


def plain_lanes(out, lanes: int):
    """The first ``lanes`` verdicts of a plain output: what a launch over the
    first ``lanes`` items of the same batch must return, since a lane's
    verdict depends on that lane alone."""
    return out[:lanes]


def kernel_timing(cases, kinds, make_args, launch, plain, timed, on_row=None,
                  lane_counts=(BLOCK_ITEMS, MEMPOOL_ITEMS), plain_outputs=None) -> dict:
    """Phase 6, the kernel alone.  For each ``(variant, items)`` of
    ``cases`` and each lane count, every launch kind of ``kinds`` (width,
    form, reduce, select, sqr, mul, library: :func:`instantiations` with a
    multiply and library None, the routed one; each dot_general one and
    each one launched by name in another library, such as the default
    tuple's radix-11 yardstick, in the run of kinds that starts with its
    routed shift-add twin) is
    warmed (the verdicts of that launch are the ones compared below), then
    timed in turns on the same arguments in
    :data:`TIMING_BURSTS` ``[mul]`` bursts (``kinds`` in order, then back
    in reverse order for those with a second burst), then held against the
    plain version; a difference raises.  The plain version runs once for
    each (variant, width, form, reduce), at the first lane count, which
    must be the largest, in the select and the square of the first kind of
    that (width, form, reduce), shift-add (the dot_general plain program is
    far too slow at width, and it gives the same int32 limbs); every launch
    of that (variant, width, form, reduce), at either select, square,
    multiply, library and any lane count, is compared with that output's
    first ``lanes`` lanes (:func:`plain_lanes`: a lane's verdict depends on
    that lane alone, and no mode moves a value).  No condition skips a
    comparison: every (variant, lanes, width, form, reduce, select, sqr,
    mul, library) key is compared.  A dot_general row also gets
    ``twin_ms``, the first burst of the shift-add kind right before it (the
    yardstick where its run has one: the radix-11 twin), and
    ``mul_dot_over_shift_add``; a row launched by name ``twin_ms``, its
    routed twin's first burst, and ``u32_over_radix11``, the routed twin's
    mean time (the 8-word kernel's, for the yardstick) over its own.

    ``make_args(items, lanes, wb, variant)`` gives ``(args, schnorr_free)``;
    ``launch``, called ``(args, schnorr_free, form, reduce, select, sqr,
    mul, library)``, and ``plain``, called ``(args, schnorr_free, form,
    reduce, select, sqr)``, give verdict tensors; ``timed(fn, repeats)``
    gives ms a call.  ``on_row(row, args, schnorr_free)`` adds the card's
    readings.  ``plain_outputs``, a dict if given, receives each shared
    plain output keyed ``(variant, wb, form, reduce)``.  Returns the rows
    keyed ``(wb, form, reduce, select, sqr, mul, library, variant,
    lanes)``."""
    if list(lane_counts) != sorted(lane_counts, reverse=True):
        raise ValueError(f"lane counts {lane_counts}: the first must be the largest")

    def twin_of(kind: tuple) -> tuple:
        return (*kind[:5], "shift_add", None)

    def follows_twin(i: int, kind: tuple) -> bool:
        twin = twin_of(kind)
        return twin in kinds[:i] and all(k[:5] == kind[:5] for k in kinds[kinds.index(twin):i])

    if any(kind != twin_of(kind) and not follows_twin(i, kind) for i, kind in enumerate(kinds)):
        raise ValueError("each dot_general kind or kind launched by name must come right after "
                         "its shift-add twin")
    order = []
    for turn in range(max(TIMING_BURSTS[kind[5]] for kind in kinds)):
        due = [kind for kind in kinds if TIMING_BURSTS[kind[5]] > turn]
        order += due[::-1] if turn % 2 else due
    rows = {}
    widths = tuple(dict.fromkeys(kind[0] for kind in kinds))
    for variant, items in cases:
        shared = {}  # (wb, form, reduce) -> (plain output, ms, the kind and lanes it ran for)
        for lanes in lane_counts:
            args = {wb: make_args(items[:lanes], lanes, wb, variant) for wb in widths}
            # warm: each kind's verdicts, held against the plain version below
            warm = {kind: launch(*args[kind[0]], *kind[1:]) for kind in kinds}
            runs = {kind: [] for kind in kinds}
            for kind in order:
                wb, form, reduce, select, sqr, mul, library = kind
                runs[kind].append(timed(lambda: launch(*args[wb], form, reduce, select, sqr,
                                                       mul, library), TIMED_LAUNCHES))
            for i, kind in enumerate(kinds):
                wb, form, reduce, select, sqr, mul, library = kind
                got = warm[kind]
                if kind[:3] not in shared:
                    out = [None]
                    ms = timed(lambda: out.__setitem__(
                        0, plain(*args[wb], form, reduce, select, sqr)), 1)
                    shared[kind[:3]] = out[0], ms, kind, lanes
                    if plain_outputs is not None:
                        plain_outputs[(variant, *kind[:3])] = out[0]
                out, plain_ms, plain_kind, plain_at = shared[kind[:3]]
                err = int((got.int() - plain_lanes(out, lanes).int()).abs().max())
                if err:
                    raise RuntimeError(f"{variant}/w{wb}/{form}/{reduce}/{select}/{sqr}/{mul}"
                                       f"{'/' + library if library else ''}: "
                                       f"kernel and plain version disagree at {lanes} lanes")
                ms = sum(runs[kind]) / len(runs[kind])
                row = {"variant": variant, "lanes": lanes, "window_bits": wb,
                       "point_form": form, "reduce": reduce, "select": select, "sqr": sqr,
                       "mul": mul, "library": library, "ms": ms, "ms_runs": runs[kind],
                       "plain_ms": plain_ms,
                       "plain_of": f"{variant}/w{wb}/{form}/{reduce}/{'/'.join(plain_kind[3:5])}"
                                   f" at {plain_at} lanes",
                       "plain_shared": (plain_kind, plain_at) != (kind, lanes),
                       "max_abs_err": err}
                if mul == "dot_general":  # over the shift-add kind right before it
                    twin = next(k for k in reversed(kinds[:i]) if k[5] == "shift_add")
                    row["twin_ms"] = runs[twin][0]
                    row["mul_dot_over_shift_add"] = ms / row["twin_ms"]
                elif library is not None:  # the routed twin over this one
                    twin = runs[twin_of(kind)]
                    row["twin_ms"] = twin[0]
                    row["u32_over_radix11"] = sum(twin) / len(twin) / ms
                if on_row is not None:
                    on_row(row, *args[wb])
                rows[(*kind, variant, lanes)] = row
    return rows


def plain_modes(kinds, wb: int, variant: str) -> list:
    """The plain calls :func:`kernel_vs_plain` makes for ``kinds`` at width
    ``wb`` in ``variant``, as (form, reduce, select, ladder, sqr, mul): the
    shared call of each (form, reduction) at the tree select, the scan
    ladder, the half product and shift-add; in the full variant, at the
    width of :data:`ONEHOT_PLAIN_KIND`, the own calls of it, of
    :data:`SQR_MUL_PLAIN_KIND` and of :data:`DOT_PLAIN_KINDS`, and then each
    :func:`unroll_plain_keys` key's under the unrolled ladders."""
    calls = [(form, reduce, "tree", "scan", "half", "shift_add")
             for form, reduce in dict.fromkeys(kind[1:3] for kind in kinds if kind[0] == wb)]
    if variant != "full":
        return calls
    if wb == ONEHOT_PLAIN_KIND[0]:
        calls += [(*kind[1:4], "scan", kind[4], mul) for kind, mul in (
            (ONEHOT_PLAIN_KIND, "shift_add"), (SQR_MUL_PLAIN_KIND, "shift_add"),
            *((kind, "dot_general") for kind in DOT_PLAIN_KINDS))]
    return calls + [(form, reduce, "tree", "unroll", "half", "shift_add")
                    for width, form, reduce in unroll_plain_keys(kinds) if width == wb]


def plain_ahead(cases, kinds, make_args, plain, timed) -> dict:
    """Every plain call of :func:`kernel_vs_plain` for ``cases`` and
    ``kinds`` (:func:`plain_modes`), run ahead with its arguments: the plain
    version needs no kernel, so main() runs this while the kernels build.
    Returns {(width, variant, *modes): (output, ms)}; the ms are taken while
    nvcc holds the host's cores."""
    out = {}
    for wb in dict.fromkeys(kind[0] for kind in kinds):
        for variant, items, _ in cases:
            args, sf = make_args(items, wb, variant)
            for modes in plain_modes(kinds, wb, variant):
                got = [None]
                ms = timed(lambda: got.__setitem__(0, plain(args, sf, *modes)), 1)
                out[(wb, variant, *modes)] = got[0], ms
    return out


def kernel_vs_plain(cases, kinds, make_args, launch, plain, timed, emit_row,
                    yardstick=None, u32_lanes=(), ahead=None) -> tuple:
    """Phase 3, every instantiation of both multiplies against the plain
    version and the oracle.  For each width and each ``(variant, items,
    oracle)`` of ``cases``, every instantiation of ``kinds`` (from
    :func:`instantiations`) at that width is launched once on the same
    arguments, shift-add and then dot_general.  The plain version runs once
    for each (form, reduction) at the tree select and the half product,
    shift-add (the first kind of that key in ``kinds``), and every
    instantiation of that key, of either select, square and multiply, is
    held against that output: the selects pick the same entry, and the
    squares and the multiplies give the same int32 in every output limb
    (the reference pins it: ``tests/test_field.py::test_formulations_bit_identical``
    and ``tests/test_pallas_kernel.py::test_pallas_field_formulations_bit_identical``),
    so every later limb and each verdict is the same.  In the full variant,
    at the default (width, form, reduction), the plain version runs in its
    own modes once under the one-hot select (:data:`ONEHOT_PLAIN_KIND`),
    once under ``sqr="mul"`` (:data:`SQR_MUL_PLAIN_KIND`) and once under
    ``mul="dot_general"`` for each square (:data:`DOT_PLAIN_KINDS`), each
    equal to the shared output, the kernel and the oracle; the dot_general
    kernel launches once more on the first :data:`DOT_RAGGED_LANES` items
    (a ragged last warp) against those lanes of the shared output; and the
    plain version with the unrolled ladders runs once for each of the
    (width, form, reduction) keys of :func:`unroll_plain_keys`, tree select, half
    product, against the kernel launched for the unroll caller and the
    oracle.  Where ``yardstick`` is given, a ``{kind: library}`` dict
    (:data:`YARDSTICKS`: each kind whose route runs an 8-word kernel, and
    the radix-11 library of its yardstick), each such kind of ``kinds`` also launches
    shift-add by name in its library (the radix-11 yardstick), held
    against the same shared output, and
    its routed 8-word kernel launches once more on each lane count of
    ``u32_lanes``: the batch's items from its first non-ECDSA one on in the
    full variant (from the first in ``schnorr_free``), wrapping around,
    held against those lanes of the shared output (a lane's verdict depends
    on its item alone) and of the oracle.  Every verdict list must equal
    the oracle's, and all of one (width, variant) each other.  A difference
    raises.

    ``make_args(items, wb, variant)`` gives ``(args, schnorr_free)``;
    ``launch``, called ``(args, schnorr_free, form, reduce, select, ladder,
    sqr, mul, library)`` (library None: the routed one), and ``plain``,
    called the same without ``library``, give verdict tensors; ``timed(fn,
    repeats)`` gives ms a call; ``emit_row(row)`` prints a row.  A plain
    call whose key is in ``ahead`` (:func:`plain_ahead`'s dict) is not made
    again: its output and ms are read from there.  Returns
    ``({(*kind, variant, mul, library): max_abs_err}, plain calls)``."""
    max_err, plain_calls = {}, 0
    yardsticks = yardstick or {}
    ahead = ahead or {}

    def run_plain(args, sf, wb, variant, modes) -> tuple:
        """The plain version's output at ``modes`` (:func:`plain_modes`'
        fields) and its ms: read from ``ahead``, or run here."""
        nonlocal plain_calls
        plain_calls += 1
        if (wb, variant, *modes) in ahead:
            return ahead[(wb, variant, *modes)]
        out = [None]
        ms = timed(lambda: out.__setitem__(0, plain(args, sf, *modes)), 1)
        return out[0], ms

    def own_plain(args, sf, kind, mul, twin, got, oracle, phase, items) -> None:
        _, form, reduce, select, sqr = kind
        out, plain_ms = run_plain(args, sf, kind[0], "full",
                                  (form, reduce, select, "scan", sqr, mul))
        same = bool((out == twin).all())
        label = f"plain full/w{kind[0]}/{form}/{reduce}/{select}/{sqr}/{mul}"
        if not (same and out.tolist() == got == oracle):
            raise RuntimeError(f"{label}: equals the shared plain output: {same}, the kernel: "
                               f"{out.tolist() == got}, the oracle: "
                               f"{out.tolist() == oracle}")
        emit_row({"phase": phase, "variant": "full", "window_bits": kind[0],
                  "point_form": form, "reduce": reduce, "select": select, "sqr": sqr,
                  "mul": mul, "lanes": len(items), "valid": sum(oracle), "plain_ms": plain_ms,
                  "equals_shared_plain": True, "equals_kernel": True, "equals_oracle": True})

    for wb in dict.fromkeys(kind[0] for kind in kinds):
        for variant, items, oracle in cases:
            args, sf = make_args(items, wb, variant)
            verdicts, plain_outs = {}, {}
            for kind in (kind for kind in kinds if kind[0] == wb):
                _, form, reduce, select, sqr = kind
                plain_ms = None  # every kind of a (form, reduce) shares its first one's output
                if kind[1:3] not in plain_outs:
                    plain_outs[kind[1:3]], plain_ms = run_plain(
                        args, sf, wb, variant, (form, reduce, "tree", "scan", "half", "shift_add"))
                named = [("shift_add", yardsticks[kind])] if kind in yardsticks else []
                for mul, library in [(mul, None) for mul in MUL_MODES] + named:
                    got = launch(args, sf, form, reduce, select, "scan", sqr, mul, library)
                    err = int((got.int() - plain_outs[kind[1:3]].int()).abs().max())
                    max_err[(*kind, variant, mul, library)] = err
                    verdicts[(*kind[1:], mul, library)] = got.tolist()
                    label = (f"{variant}/w{wb}/{form}/{reduce}/{select}/{sqr}/{mul}"
                             f"{'/' + library if library else ''}")
                    if err or verdicts[(*kind[1:], mul, library)] != oracle:
                        raise RuntimeError(f"{label}: kernel {err} lanes off the plain version, "
                                           f"oracle agrees: "
                                           f"{verdicts[(*kind[1:], mul, library)] == oracle}")
                    emit_row({"phase": "kernel_vs_plain", "variant": variant, "window_bits": wb,
                              "point_form": form, "reduce": reduce, "select": select,
                              "sqr": sqr, "mul": mul, "library": library, "lanes": len(items),
                              "valid": sum(oracle), "max_abs_err": err,
                              "plain_ms": plain_ms if (mul, library) == ("shift_add", None)
                              else None,
                              "plain_of": f"{variant}/w{wb}/{form}/{reduce}/tree/half/shift_add",
                              "equals_oracle": True})
            if len({tuple(v) for v in verdicts.values()}) != 1:
                raise RuntimeError(f"{variant}/w{wb}: the forms', reductions', selects', "
                                   f"squares' or multiplies' verdicts differ")
            for ykind in (k for k in yardsticks if k[0] == wb and k in kinds):
                _, form, reduce, select, sqr = ykind
                label = u32_label(ykind)
                first = next((i for i, it in enumerate(items) if len(it) > 4), 0) if (
                    variant == "full") else 0
                for lanes in u32_lanes:
                    idx = [(first + i) % len(items) for i in range(lanes)]
                    few, few_sf = make_args([items[i] for i in idx], wb, variant)
                    got = launch(few, few_sf, form, reduce, select, "scan", sqr, "shift_add",
                                 None)
                    want = plain_outs[(form, reduce)][idx]
                    err = int((got.int() - want.int()).abs().max())
                    if err or got.tolist() != [oracle[i] for i in idx]:
                        raise RuntimeError(f"{variant}/{label} at {lanes} lanes: {err} lanes off "
                                           f"the plain version")
                    key = (*ykind, variant, "shift_add", None)
                    max_err[key] = max(err, max_err[key])
                    emit_row({"phase": "u32_lanes", "kernel": label, "variant": variant,
                              "window_bits": wb,
                              "point_form": form, "reduce": reduce, "select": select,
                              "sqr": sqr, "mul": "shift_add", "lanes": lanes,
                              "valid": sum(oracle[i] for i in idx), "max_abs_err": err,
                              "plain_of": f"{variant}/w{wb}/{form}/{reduce}/tree/half/shift_add"
                                          f" at {len(items)} lanes", "equals_oracle": True})
            if variant != "full":
                continue
            if wb == ONEHOT_PLAIN_KIND[0]:
                owns = [(ONEHOT_PLAIN_KIND, "shift_add", "plain_onehot_vs_kernel"),
                        (SQR_MUL_PLAIN_KIND, "shift_add", "plain_sqr_mul_vs_kernel")]
                owns += [(kind, "dot_general", "plain_dot_vs_kernel") for kind in DOT_PLAIN_KINDS]
                for kind, mul, phase in owns:
                    own_plain(args, sf, kind, mul, plain_outs[kind[1:3]],
                              verdicts[(*kind[1:], mul, None)], oracle, phase, items)
                # a ragged last warp: the dot kernel on the first lanes alone
                _, form, reduce, select, sqr = DOT_PLAIN_KINDS[0]
                few, few_sf = make_args(items[:DOT_RAGGED_LANES], wb, variant)
                got = launch(few, few_sf, form, reduce, select, "scan", sqr, "dot_general",
                             None)
                want = plain_lanes(plain_outs[(form, reduce)], DOT_RAGGED_LANES)
                err = int((got.int() - want.int()).abs().max())
                if err or got.tolist() != oracle[:DOT_RAGGED_LANES]:
                    raise RuntimeError(f"dot_general at {DOT_RAGGED_LANES} lanes: {err} lanes "
                                       f"off the plain version")
                key = (*DOT_PLAIN_KINDS[0], variant, "dot_general", None)
                max_err[key] = max(err, max_err[key])
                emit_row({"phase": "dot_ragged_warp", "variant": variant, "window_bits": wb,
                          "point_form": form, "reduce": reduce, "select": select, "sqr": sqr,
                          "mul": "dot_general", "lanes": DOT_RAGGED_LANES, "max_abs_err": err,
                          "equals_oracle": True})
            for key in (key for key in unroll_plain_keys(kinds) if key[0] == wb):
                _, form, reduce = key
                out, plain_ms = run_plain(args, sf, wb, variant,
                                          (form, reduce, "tree", "unroll", "half", "shift_add"))
                got = launch(args, sf, form, reduce, "tree", "unroll", "half", "shift_add",
                             None)
                plain_v, kernel_v = out.tolist(), got.tolist()
                if not plain_v == kernel_v == verdicts[(form, reduce, "tree", "half",
                                                        "shift_add", None)] == oracle:
                    raise RuntimeError(f"unroll full/w{wb}/{form}/{reduce}: the plain version "
                                       f"equals the kernel: {plain_v == kernel_v}, the oracle: "
                                       f"{plain_v == oracle}")
                emit_row({"phase": "plain_unroll_vs_kernel", "variant": variant,
                          "window_bits": wb, "point_form": form, "reduce": reduce,
                          "select": "tree", "sqr": "half", "mul": "shift_add", "ladder": "unroll",
                          "lanes": len(items), "valid": sum(oracle),
                          "max_abs_err": int((got.int() - out.int()).abs().max()),
                          "plain_ms": plain_ms, "equals_kernel": True, "equals_oracle": True})
    return max_err, plain_calls


def run_campaigns(kinds, make_pool, run, on_result) -> int:
    """Phase 7: ``make_pool()`` once, then ``run(CAMPAIGN_BASE,
    CAMPAIGN_BATCH, ..., pool=pool)`` (``campaign.run_campaign``) for each
    of :func:`campaign_kinds` ``(kinds)``, its select and ladder through
    their knobs (the engine reads them), its width, form, reduction,
    square and multiply through the config; ``on_result(res)`` takes each
    result.  A mismatch, a campaign without a launch or one that ran other
    modes raises.  Returns the number of campaigns."""
    pool = make_pool()
    done = 0
    for kind in campaign_kinds(kinds):
        wb, form, reduce, select, ladder, sqr, mul = kind
        with select_knob(select), ladder_knob(ladder):
            res = run(CAMPAIGN_BASE, CAMPAIGN_BATCH, window_bits=wb, point_form=form,
                      field_reduce=reduce, field_sqr=sqr, pool=pool, field_mul=mul)
        ran = tuple(res[k] for k in ("window_bits", "point_form", "field_reduce", "select",
                                     "ladder", "field_sqr", "field_mul"))
        if res["mismatches"] or res["launches"] < 1 or ran != kind:
            raise RuntimeError(f"campaign {kind}: {res['mismatches']} mismatches, "
                               f"{res['launches']} launches, ran {ran}: "
                               f"{res['mismatch_detail']}")
        on_result(res)
        done += 1
    return done


def main() -> int:
    started = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tpunode_torch import cuda_diag
    from tpunode_torch.campaign import SEED as CAMPAIGN_SEED
    from tpunode_torch.campaign import build_pool, run_campaign
    from tpunode_torch.verify import cuda_kernel
    from tpunode_torch.verify import ecdsa_cpu as O
    from tpunode_torch.verify import kernel as K
    from tpunode_torch.verify.cpu_native import load_native_verifier
    from tpunode_torch.verify.curve import POINT_FORMS
    from tpunode_torch.metrics import metrics
    from tpunode_torch.trace import profile_to, span
    from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine
    from tpunode_torch.verify.raw import concat_raw, pack_items

    widths, variants = tuple(K.WINDOWS_BY_BITS), cuda_kernel.VARIANTS
    # (4,P,lazy,tree,half) (4,P,lazy,tree,mul) (4,P,lazy,onehot,half) .. (5,A,eager,onehot,mul)
    kinds = instantiations(widths, POINT_FORMS)

    def reset_launches() -> None:
        for key in cuda_kernel.LAUNCHES:
            cuda_kernel.LAUNCHES[key] = 0
        for key in cuda_kernel.LIBRARY_LAUNCHES:
            cuda_kernel.LIBRARY_LAUNCHES[key] = 0
        cuda_kernel.STREAM_LAUNCHES.clear()

    def name(kind: tuple, variant: str, mul: str = "shift_add") -> str:
        suffix = "/dot_general" if mul == "dot_general" else ""
        return f"{variant}/w{kind[0]}/{kind[1]}/{kind[2]}/{kind[3]}/{kind[4]}{suffix}"

    phase_seconds, lap = {}, [started]

    def phase_done(phase: str) -> None:
        """Print the seconds since the previous phase ended."""
        now = time.perf_counter()
        phase_seconds[phase] = now - lap[0]
        lap[0] = now
        emit({"phase": "phase_seconds", "of": phase, "seconds": phase_seconds[phase],
              "total_seconds": now - started})

    # 1. device
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    sm_clock = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    sm_count = props.multi_processor_count
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "sm_count": sm_count, "sm_clock_max_mhz": sm_clock})
    phase_done("device")

    # phase 3's adversarial lanes and its plain calls, which need no kernel:
    # made in a thread of their own while the kernels build (phase 2)
    def adv_args(items, wb, variant) -> tuple:
        prep = K.prepare_batch_raw(pack_items(items), pad_to=len(items), window_bits=wb)
        if prep.schnorr_free != (variant == "schnorr_free") or prep.window_bits != wb:
            raise RuntimeError(f"{variant}/w{wb}: the batch selects another kernel")
        return K.from_reference(prep.device_args, "cuda"), prep.schnorr_free

    def plain_mode(args, sf, form, reduce, select, ladder, sqr, mul):
        # no autograd bookkeeping: the host-bound plain program runs a third faster
        with torch.inference_mode():
            return K.verify_core(*args, schnorr_free=sf, point_form=form, reduce=reduce,
                             select=select, ladder=ladder, sqr=sqr, mul=mul)

    def timed(fn, repeats: int) -> float:
        return timed_ms(torch, fn, repeats)

    ahead = {}

    def run_ahead() -> None:
        try:
            t_ahead = time.perf_counter()
            rng = random.Random(SEED)
            adv = adversarial_items(O, rng)
            ecdsa_adv = tile([it for it in adv if len(it) == 4], ADVERSARIAL_LANES)
            cases = [("full", adv, O.verify_batch_cpu(adv)),
                     ("schnorr_free", ecdsa_adv, O.verify_batch_cpu(ecdsa_adv))]
            plain = plain_ahead(cases, kinds, adv_args, plain_mode, timed)
            ahead.update(rng=rng, cases=cases, plain=plain,
                         seconds=time.perf_counter() - t_ahead)
        except BaseException as exc:  # raised again in phase 3
            ahead["error"] = exc

    ahead_thread = threading.Thread(target=run_ahead, name="plain-ahead", daemon=True)
    ahead_thread.start()

    # 2. build: the verify kernel's 128 instantiations and the twelve probes,
    #    the probes' PTX, where the static ladder must load no digit and only
    #    the tensor-core multiply may run mma.sync, the full-product
    #    library's, which must name no half-product square, and each verify
    #    library's, where only the dot_general ones may run mma.sync
    t0 = time.perf_counter()
    verify_libs = cuda_kernel.VERIFY_LIBRARIES
    lib_paths = cuda_kernel.build(ptx=("diag", *verify_libs.values()))
    ptxas = ptxas_entries(cuda_kernel.BUILD_LOGS["diag"])
    for (mul, _), lib in verify_libs.items():
        ptxas.update(ptxas_entries(cuda_kernel.BUILD_LOGS[lib], mul))
    ptxas.update(ptxas_entries(cuda_kernel.BUILD_LOGS[cuda_kernel.U32_LIBRARY]))
    for lib in cuda_kernel.U32_MODES_LIBRARIES.values():
        ptxas.update(ptxas_entries(cuda_kernel.BUILD_LOGS[lib]))
    want = ({name(kind, v, mul) for v in variants for kind in kinds for mul in MUL_MODES}
            | {u32_ptxas_key(kind, v) for kind in YARDSTICKS for v in variants}
            | set(cuda_diag.PROBES))
    keys = {"registers", "smem", "stack_frame", "spill_stores", "spill_loads"}
    if set(ptxas) != want or any(set(info) != keys for info in ptxas.values()):
        raise RuntimeError(f"ptxas reported {ptxas}, expected {sorted(keys)} for each "
                           f"of {sorted(want)}:\n"
                           f"{''.join(cuda_kernel.BUILD_LOGS.values())[-4000:]}")
    with open(lib_paths["diag"] + ".ptx") as f:
        diag_ptx = f.read()
    descan = cuda_diag.descan_ptx(diag_ptx)
    if (descan["memory_loads"] or descan["data_symbols"]
            or descan["calls"] != {**cuda_diag.descan_calls(), "other": 0}):
        raise RuntimeError(f"pow_descan's PTX: {descan}, expected no memory load and the "
                           f"calls {cuda_diag.descan_calls()}")
    with open(lib_paths["verify_mul"] + ".ptx") as f:
        squares = {"verify_mul": cuda_kernel.sqr_ptx(f.read()),
                   "diag": cuda_kernel.sqr_ptx(diag_ptx)}
    if (squares["verify_mul"]["sqr_conv_lines"] or not squares["verify_mul"]["conv_calls"]
            or not squares["diag"]["sqr_conv_calls"]):
        raise RuntimeError(f"squares in the PTX: {squares}; the full-product library must name "
                           f"no sqr_conv and call conv, the probes' must call sqr_conv")
    mma = cuda_diag.mma_ptx(diag_ptx)
    holders = {name: n for kind in mma.values() for name, n in kind.items() if n}
    dot_entry = [name for name in mma["entries"] if "field_mul_dot_kernel" in name]
    dot_build = ptxas["field_mul_dot"]
    if (len(dot_entry) != 1 or list(holders) != dot_entry
            or holders[dot_entry[0]] != DOT_MMA_IN_PTX):
        raise RuntimeError(f"mma.sync.aligned.m16n8k32 in the probes' PTX: {holders}, expected "
                           f"{DOT_MMA_IN_PTX} in field_mul_dot_kernel alone; entries "
                           f"{sorted(mma['entries'])}")
    if dot_build["spill_stores"] or dot_build["spill_loads"]:
        raise RuntimeError(f"field_mul_dot_kernel spills: {dot_build}")
    emit({"phase": "field_mul_dot_build", "ptxas": dot_build,
          "mma_in_field_mul_dot_kernel": holders[dot_entry[0]],
          "diag_entries_without_mma": len(mma["entries"]) - 1,
          "diag_funcs_without_mma": len(mma["funcs"])})
    # the verify libraries: every mma in a dot_general library's contraction
    # functions (conv_dot, and sqr_dot in the half-product one), the step
    # loop's 48 each, and none in any function of a shift-add library
    verify_mma = {}
    for (mul, sqr), lib in verify_libs.items():
        with open(lib_paths[lib] + ".ptx") as f:
            found = cuda_diag.mma_ptx(f.read())
        held = verify_mma[lib] = {fn: n for kind in found.values() for fn, n in kind.items()
                                  if n}
        # the mangled names' heads: tpn::conv_dot, tpn::sqr_dot
        want_fns = {"_ZN3tpn8conv_dotE"} | ({"_ZN3tpn7sqr_dotE"} if sqr == "half" else set())
        if mul == "shift_add" and held:
            raise RuntimeError(f"mma.sync.aligned.m16n8k32 in {lib}'s PTX: {held}")
        heads = sorted(w for fn in held for w in want_fns if fn.startswith(w))
        if mul == "dot_general" and (heads != sorted(want_fns) or len(held) != len(want_fns)
                                     or set(held.values()) != {DOT_MMA_IN_PTX}):
            raise RuntimeError(f"mma.sync.aligned.m16n8k32 in {lib}'s PTX: {held}, expected "
                               f"{DOT_MMA_IN_PTX} in each of {sorted(want_fns)} and nowhere "
                               f"else")
    # the 64 shift-add entries against the snapshot of the tree before dot_general
    with open(PTXAS_SNAPSHOT) as f:
        held = ptxas_vs_snapshot(ptxas, json.load(f), cuda_kernel.nvcc_version(),
                                 cuda_kernel.NVCC_FLAGS)
    emit({"phase": "ptxas_vs_snapshot", **held})
    if held["comparable"] and held["differ"]:
        raise RuntimeError(f"shift-add ptxas lines differ from {held['snapshot_of']}'s: "
                           f"{held['differ']}")
    # the 8-word kernels keep every value in registers or their stack frame:
    # no instantiation may spill
    u32_spills = {key: info for key, info in ptxas.items()
                  if "/u32" in key and (info["spill_stores"] or info["spill_loads"])}
    if u32_spills:
        raise RuntimeError(f"8-word kernels spill: {u32_spills}")
    # the 8-word kernel: its ptxas lines, and the static SASS of its kernels
    # and of the probe's multiply beside the operation model's count
    u32_sass = cuobjdump_sass(lib_paths[cuda_kernel.U32_LIBRARY])
    probe_sass = cuobjdump_sass(lib_paths["diag"])
    model = u32_ops_per_lane()
    emit({"phase": "u32_build", "ptxas": {v: ptxas[f"{v}/u32"] for v in variants},
          "sass_classes": "no cuobjdump in this toolkit" if u32_sass is None else {
              fn: sass_classes(ops) for fn, ops in sass_functions(u32_sass).items()
              if "verify_u32_kernel" in fn},
          "probe_sass_classes": "no cuobjdump in this toolkit" if probe_sass is None else {
              fn: sass_classes(ops) for fn, ops in sass_functions(probe_sass).items()
              if "field_mul_u32_kernel" in fn or "field_mul_kernel" in fn},
          "model_mul": dict(model["mul"]), "model_sqr": dict(model["sqr"]),
          "model_probe": dict(u32_probe_ops_per_lane())})
    # the eager affine tuples' 8-word kernels (one-hot and tree): their
    # ptxas lines, the static SASS of their kernels with the local and shared
    # memory opcodes by width, and the model's count a lane
    modes_sass = [cuobjdump_sass(lib_paths[lib])
                  for lib in cuda_kernel.U32_MODES_LIBRARIES.values()]
    modes_sass = None if None in modes_sass else "".join(modes_sass)
    modes_fns = {} if modes_sass is None else {
        fn: ops for fn, ops in sass_functions(modes_sass).items()
        if "verify_u32_modes_kernel" in fn}
    emit({"phase": "u32_modes_build",
          "ptxas": {key: ptxas[key] for key in (u32_ptxas_key(kind, v)
                                                for kind in U32_MODES_KINDS for v in variants)},
          "sass_classes": "no cuobjdump in this toolkit" if modes_sass is None else {
              fn: sass_classes(ops) for fn, ops in modes_fns.items()},
          "sass_memory": "no cuobjdump in this toolkit" if modes_sass is None else {
              fn: memory_opcodes(ops) for fn, ops in modes_fns.items()},
          "model": {u32_ptxas_key(kind, v): dict(u32_ops_per_lane(kind)[v])
                    for kind in U32_MODES_KINDS for v in variants}})
    dot_entries = {key: info for key, info in ptxas.items() if key.endswith("/dot_general")}
    emit({"phase": "verify_mma_ptx", "mma_by_function": verify_mma,
          "dot_general_ptxas": dot_entries,
          "dot_general_spills": {key: info["spill_stores"] + info["spill_loads"]
                                 for key, info in dot_entries.items()
                                 if info["spill_stores"] or info["spill_loads"]}})
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": dict(cuda_kernel.BUILD_SECONDS),
          "libraries": {k: v.rsplit("/", 1)[-1] for k, v in lib_paths.items()},
          "ptxas": ptxas, "pow_descan_ptx": descan, "sqr_ptx": squares})
    phase_done("build")

    # 3. kernel vs plain version: every instantiation of both multiplies on
    #    adversarial lanes against the shared plain output of its (form,
    #    reduction) and a few plain calls in their own modes, those calls
    #    made ahead during the build; the verdicts must be the same in every
    #    mode
    t0 = time.perf_counter()
    ahead_thread.join()
    ahead_wait_s = time.perf_counter() - t0
    if "error" in ahead:
        raise RuntimeError("phase 3's plain calls, run ahead, failed") from ahead["error"]
    rng = ahead["rng"]  # phase 5 draws its pools from it next, as it always did

    def launch_mode(args, sf, form, reduce, select, ladder, sqr, mul, library):
        modes = dict(schnorr_free=sf, point_form=form, reduce=reduce, select=select,
                     ladder=ladder, sqr=sqr, mul=mul)
        if library is None:  # the route
            return cuda_kernel.verify_blocked(*args, **modes)
        return cuda_kernel.verify_with(library, *args, **modes)  # by name: the yardstick

    max_err, plain_calls = kernel_vs_plain(
        ahead["cases"], kinds, adv_args, launch_mode, plain_mode, timed, emit,
        yardstick=YARDSTICKS, u32_lanes=U32_LANES, ahead=ahead["plain"])
    emit({"phase": "kernel_vs_plain_summary", "instantiations": len(max_err),
          "plain_calls": plain_calls, "plain_calls_ahead": len(ahead["plain"]),
          "plain_ahead_seconds": ahead["seconds"], "ahead_wait_seconds": ahead_wait_s})
    phase_done("kernel_vs_plain")

    # 4. the probes: their entry point with the counts zeroed around it, then
    #    each kernel against its plain version and timed (the add-one floor
    #    beside the one PyTorch call that computes it), and the tensor-core
    #    multiply against the shift-add one, in limbs and in time
    for probe in cuda_diag.PROBES:
        cuda_diag.LAUNCHES[probe] = 0
    diag = cuda_diag.run()
    probe_launches = dict(cuda_diag.LAUNCHES)
    if not all(c["ok"] for c in diag["cases"]) or min(probe_launches.values()) < 1:
        raise RuntimeError(f"probes: {diag['cases']}, launches {probe_launches}")
    probes, probe_outs = {}, {}
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
            # the device's own time a launch of each, from one profiler trace
            # of both: the probe's kernel by its name, x + 1's every other one
            with tempfile.TemporaryDirectory() as tmp:
                with profile_to(tmp) as path:
                    for call in (lambda: fn(*inputs), lambda: x + 1):
                        for _ in range(DEVICE_TIMED_LAUNCHES):
                            call()
                    torch.cuda.synchronize()
                kernels = device_kernels(path)
            for key, mine in (("device", True), ("library_device", False)):
                runs = {k: v for k, v in kernels.items() if ("trivial_kernel" in k) == mine}
                row[f"{key}_ms"] = (sum(map(sum, runs.values()))
                                    / max(1, sum(map(len, runs.values()))))
                row[f"{key}_kernels"] = {k: len(v) for k, v in runs.items()}
        row["bound_ms"], row["bound_by"] = least_ms(
            _rep(lanes, probe_ops_per_lane(probe)), probe_bytes(probe, lanes), sm_count,
            sm_clock)
        if probe in FIELD_MUL_PROBES:  # one function: the least of its formulations
            u32_ms, u32_by = least_ms(_rep(lanes, u32_probe_ops_per_lane()),
                                      probe_bytes(probe, lanes), sm_count, sm_clock)
            row["radix11_bound_ms"], row["u32_bound_ms"] = row["bound_ms"], u32_ms
            if u32_ms < row["bound_ms"]:
                row["bound_ms"], row["bound_by"] = u32_ms, u32_by
        if probe == "field_mul_u32":
            row["formulation_bound_ms"] = row["u32_bound_ms"]
        if probe == "field_mul_dot":
            row["formulation_bound_ms"], row["formulation_bound_by"] = dot_formulation_bound_ms(
                lanes, sm_count, sm_clock)
        probe_outs[probe] = got
        if err:
            raise RuntimeError(f"probe {probe}: kernel and plain version differ by {err}")
        probes[probe] = row
        emit({"phase": "probe", "card": card, **row})
    # the tensor-core multiply: the shift-add one's limbs on the probe's
    # lanes, then both timed in turns at the engine's width on those lanes
    # tiled
    if not torch.equal(probe_outs["field_mul_dot"], probe_outs["field_mul"]):
        raise RuntimeError("probes: field_mul_dot's output differs from field_mul's")
    if not torch.equal(probe_outs["field_mul_u32"], probe_outs["field_mul"]):
        raise RuntimeError("probes: field_mul_u32's output differs from field_mul's")
    a_dot, b_dot = cuda_diag.probe_inputs("field_mul_dot", "cuda")
    tiled = torch.arange(DOT_LANES, device=a_dot.device) % a_dot.shape[-1]
    a_dot, b_dot = a_dot[:, tiled].contiguous(), b_dot[:, tiled].contiguous()
    if not torch.equal(cuda_diag.field_mul_dot(a_dot, b_dot), cuda_diag.field_mul(a_dot, b_dot)):
        raise RuntimeError(f"probes: field_mul_dot differs from field_mul at {DOT_LANES} lanes")
    u32_out = cuda_diag.field_mul_u32(a_dot, b_dot)
    u32_bad = cuda_diag._host_check("field_mul_u32", u32_out, (a_dot, b_dot))
    if u32_bad or not torch.equal(u32_out, cuda_diag.field_mul(a_dot, b_dot)):
        raise RuntimeError(f"probes: field_mul_u32 at {DOT_LANES} lanes: {u32_bad} lanes off "
                           f"the host check, or differs from field_mul")
    turns = dot_over_shift_add(lambda: cuda_diag.field_mul_dot(a_dot, b_dot),
                               lambda: cuda_diag.field_mul(a_dot, b_dot),
                               lambda: cuda_diag.field_mul_u32(a_dot, b_dot),
                               lambda fn, repeats: timed_ms(torch, fn, repeats))
    dot_bound, dot_by = least_ms(_rep(DOT_LANES, probe_ops_per_lane("field_mul_dot")),
                                 probe_bytes("field_mul_dot", DOT_LANES), sm_count, sm_clock)
    form_ms, form_by = dot_formulation_bound_ms(DOT_LANES, sm_count, sm_clock)
    u32_ms, u32_by = least_ms(_rep(DOT_LANES, u32_probe_ops_per_lane()),
                              probe_bytes("field_mul_u32", DOT_LANES), sm_count, sm_clock)
    emit({"phase": "mul_dot_over_shift_add", "card": card, "lanes": DOT_LANES,
          "launches_each": 2 + 2 * TIMED_LAUNCHES, "outputs_equal": True, **turns,
          "bound_ms": min(dot_bound, u32_ms), "bound_by": dot_by if dot_bound < u32_ms else u32_by,
          "radix11_bound_ms": dot_bound, "formulation_bound_ms": form_ms,
          "formulation_bound_by": form_by, "u32_bound_ms": u32_ms, "u32_bound_by": u32_by,
          "u32_host_check_bad_lanes": u32_bad})
    # the static-digit pow in turns with the two one-hot ones, on its inputs
    (t_in,) = cuda_diag.probe_inputs("pow_descan", "cuda")
    digits = cuda_diag.probe_inputs("pow_window", "cuda")[1]
    ladders = {"pow_descan": lambda: cuda_diag.pow_descan(t_in),
               "pow_window": lambda: cuda_diag.pow_window(t_in, digits),
               "pow_window_smem": lambda: cuda_diag.pow_window_smem(t_in, digits)}
    outs = [fn() for fn in ladders.values()]
    if not all(torch.equal(o, outs[0]) for o in outs):
        raise RuntimeError("pow ladders: the static and the one-hot pows differ")
    ladder_runs = {probe: [] for probe in ladders}
    for probe in list(ladders) + list(ladders)[::-1]:
        ladder_runs[probe].append(timed_ms(torch, ladders[probe], LADDER_REPEATS))
    ladder_ms = {probe: sum(runs) / len(runs) for probe, runs in ladder_runs.items()}
    emit({"phase": "pow_ladders", "card": card, "lanes": t_in.shape[-1],
          "launches_each": 2 * LADDER_REPEATS, "ms": ladder_ms, "ms_runs": ladder_runs,
          "descan_over_window": ladder_ms["pow_descan"] / ladder_ms["pow_window"],
          "descan_over_window_smem": ladder_ms["pow_descan"] / ladder_ms["pow_window_smem"]})
    phase_done("probes")

    # 5. the main path: the engine at its real shapes, at each width, form,
    #    reduction, select, square and multiply
    block = tile(btc_pool(O, rng, 96, bip340=True), BLOCK_ITEMS)
    mempool = tile(btc_pool(O, rng, 64, bip340=False), MEMPOOL_ITEMS)
    tail = corrupt_every(tile(btc_pool(O, rng, 32, bip340=True), TAIL_ITEMS),
                         TAIL_CORRUPT_EVERY)
    raw = concat_raw([pack_items(block), pack_items(mempool), pack_items(tail)])
    cpu = load_native_verifier().verify_raw(raw)
    if sum(cpu) != len(raw) - TAIL_ITEMS // TAIL_CORRUPT_EVERY:
        raise RuntimeError(f"main path: {sum(cpu)} valid of {len(raw)}, expected every "
                           f"item but the tail's corrupted ones to be valid")

    check_s = [0.0]  # the rung and metric reads of every main-path run

    def main_path(engine) -> list:
        """The block and the mempool through ``verify_sync``, the tail
        through the async queue (the lane packer and a dispatch thread);
        each must be served by the device rung, "tpu"."""
        async def submit_tail() -> list:
            async with engine:
                return await engine.verify(tail)

        verdicts, rungs = [], []
        for part in (block, mempool):
            verdicts += engine.verify_sync(part)
            t0 = time.perf_counter()
            rungs.append(engine.last_rung)
            check_s[0] += time.perf_counter() - t0
        verdicts += asyncio.run(submit_tail())
        t0 = time.perf_counter()
        rungs.append(engine.last_rung)
        if rungs != ["tpu"] * 3:
            raise RuntimeError(f"main path: block, mempool and tail served by the rungs {rungs}, "
                               f"not the device's: {engine.stats()['breaker']}")
        check_s[0] += time.perf_counter() - t0
        return verdicts

    ENGINE_METRICS = ("verify.tpu_items", "verify.cpu_items", "verify.failovers",
                      "verify.dispatch_errors")

    def engine_metrics() -> dict:
        return {name: metrics.get(name) for name in ENGINE_METRICS}

    def drive(engine) -> tuple:
        """Zero every launch count, run the main path once through
        ``engine`` and read the counts: (verdicts, seconds, launches by
        variant at the engine's width, form, reduction, select, ladder,
        square and multiply, launches by library and variant).  The launches
        must all be at the engine's modes and in the library they route to
        (``cuda_kernel.kernel_library``: ``verify_u32`` for the default
        tuple, none in ``verify_half``)."""
        kind = (engine.cfg.window_bits, engine.cfg.point_form, engine.cfg.field_reduce,
                engine.select, engine.ladder, engine.cfg.field_sqr, engine.cfg.field_mul)
        if engine.device_state != "ready":
            raise RuntimeError(f"main path {kind}: device {engine.device_state} at the first "
                               f"submission")
        before = engine_metrics()
        reset_launches()
        t0 = time.perf_counter()
        verdicts = main_path(engine)
        seconds = time.perf_counter() - t0
        launches = dict(cuda_kernel.LAUNCHES)
        by_library = dict(cuda_kernel.LIBRARY_LAUNCHES)
        t0 = time.perf_counter()
        grew = {name: n - before[name] for name, n in engine_metrics().items()}
        if grew != {"verify.tpu_items": len(raw), "verify.cpu_items": 0,
                    "verify.failovers": 0, "verify.dispatch_errors": 0}:
            raise RuntimeError(f"main path {kind}: the engine's counts grew by {grew}, expected "
                               f"{len(raw)} device items and no cpu item, failover or error")
        check_s[0] += time.perf_counter() - t0
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
        library = cuda_kernel.kernel_library(*kind[:4], *kind[5:])
        expect = {key: 0 for key in by_library}
        expect[(library, "full")], expect[(library, "schnorr_free")] = 2, 1
        if by_library != expect:
            raise RuntimeError(f"main path {kind} launched {by_library} by library, expected 3 "
                               f"in {library}")
        return (verdicts, seconds, {v: launches[(*kind, v)] for v in variants},
                {lib: {v: by_library[(lib, v)] for v in variants}
                 for lib in dict.fromkeys(k[0] for k in by_library)})

    ekinds = engine_kinds(kinds)
    engines = {}
    for kind in ekinds:
        wb, form, reduce, select, ladder, sqr, mul = kind
        # the engine reads the select, the ladder and (field_sqr and
        # field_mul None) the square and the multiply once, here; every
        # chunk of the main path, the 1,000-item tail too, goes to the card
        # (the default min_tpu_batch, 0)
        with select_knob(select), ladder_knob(ladder), sqr_knob(sqr), mul_knob(mul):
            engines[kind] = VerifyEngine(VerifyConfig(
                device_batch=BLOCK_ITEMS, batch_size=MEMPOOL_ITEMS, window_bits=wb,
                point_form=form, field_reduce=reduce))
        built = (engines[kind].select, engines[kind].ladder, engines[kind].cfg.field_sqr,
                 engines[kind].cfg.field_mul)
        if built != (select, ladder, sqr, mul):
            raise RuntimeError(f"engine {kind}: built under {SELECT_KNOB}={select}, "
                               f"{LADDER_KNOB}={ladder}, {SQR_KNOB}={sqr} and {MUL_KNOB}={mul}, "
                               f"runs {built}")
    # every engine warms up in its own thread, all at once; each must be
    # ready before its first submission
    t0 = time.perf_counter()
    for kind, engine in engines.items():
        state = engine.wait_warmup(max(0.0, WARMUP_BOUND_S - (time.perf_counter() - t0)))
        if state != "ready":
            raise RuntimeError(f"engine {kind}: device {state} {WARMUP_BOUND_S} s into the "
                               f"warmup: {engine.stats()['device_error']}")
    emit({"phase": "engine_warmup", "engines": len(engines),
          "seconds": time.perf_counter() - t0,
          "device_kinds": sorted({e.stats()["device_kind"] for e in engines.values()})})
    phase_done("engine_warmup")
    first = ekinds[0]  # (4, projective, lazy, tree, scan, half, shift_add)
    verdicts, e2e_s, launches0, libraries0 = drive(engines[first])
    emit({"phase": "engine_stats", "kind": first, "stats": engines[first].stats()})
    # the first engine's path once more, profiled: spans are annotated
    with tempfile.TemporaryDirectory() as tmp:
        with profile_to(tmp) as path:
            with span("main_path"):
                traced = main_path(engines[first])
        trace = trace_breakdown(path)
    if "verify.pack" not in trace["span_ms_off_caller_thread"]:
        raise RuntimeError("main path: the tail's verify.pack did not run in a dispatch thread")
    if traced != verdicts:
        raise RuntimeError("main path: the traced run's verdicts differ from the first run's")
    e2e = {first: [e2e_s]}
    launches, library_launches = {first: launches0}, {first: libraries0}
    for kind in ekinds[1:]:
        got, e2e_s, launches[kind], library_launches[kind] = drive(engines[kind])
        if got != verdicts:
            raise RuntimeError(f"main path {kind}: verdicts differ from the {first} path's")
        e2e[kind] = [e2e_s]
    # unprofiled end to end, in turns after the counted runs: the default
    # tuple's engines twice (every other one ran its counted run only)
    default = [kind for kind in ekinds if (*kind[:4], *kind[5:]) == (*U32_KIND, "shift_add")]
    for kind in default[::-1] + default:
        t0 = time.perf_counter()
        if main_path(engines[kind]) != verdicts:
            raise RuntimeError(f"main path {kind}: a repeated run's verdicts differ")
        e2e[kind].append(time.perf_counter() - t0)

    def median(runs: list) -> float:
        return sorted(runs)[len(runs) // 2]

    for kind in ekinds:
        runs = e2e[kind]
        e2e_s = median(runs)
        # an unroll engine's scan twin, a mul one's half, a dot_general one's shift-add
        twin = (*kind[:4], "scan", "half", "shift_add") if kind[6] == "shift_add" else (
            *kind[:6], "shift_add")
        emit({"phase": "main_path", "card": card, "window_bits": kind[0],
              "point_form": kind[1], "reduce": kind[2], "select": kind[3], "ladder": kind[4],
              "sqr": kind[5], "mul": kind[6], "items": len(raw), "valid": sum(cpu),
              "chunks": 3, "launches": launches[kind],
              "library_launches": {lib: n for lib, n in library_launches[kind].items()
                                   if any(n.values())},
              "library_launches_verify_half": library_launches[kind]["verify_half"],
              "mismatches": 0,
              "equals_tree_twin": True, "equals_scan_twin": True, "equals_half_twin": True,
              "equals_shift_add_twin": True,
              "e2e_seconds": e2e_s, "e2e_sigs_per_s": len(raw) / e2e_s,
              "e2e_seconds_runs": runs,
              **({"twin_e2e_seconds": median(e2e[twin])} if kind != twin else {}),
              **({"traced": trace} if kind == first else {})})
    emit({"phase": "main_path_checks", "rung_and_metric_read_seconds": check_s[0]})
    phase_done("main_path")

    # 5b. the tail alone through an engine whose caller sets the
    #     reference's default min_tpu_batch, 1024: the 1,000 items go to
    #     the cpu rung, and no kernel launches (the engine is never warmed)
    floor_engine = VerifyEngine(VerifyConfig(min_tpu_batch=1024, warmup=False))

    async def floor_tail() -> list:
        async with floor_engine:
            return await floor_engine.verify(tail)

    before = engine_metrics()
    reset_launches()
    t0 = time.perf_counter()
    got = asyncio.run(floor_tail())
    tail_s = time.perf_counter() - t0
    grew = {name: n - before[name] for name, n in engine_metrics().items()}
    launched = sum(cuda_kernel.LAUNCHES.values()) + sum(cuda_kernel.LIBRARY_LAUNCHES.values())
    if got != cpu[-TAIL_ITEMS:]:
        raise RuntimeError("min_tpu_batch tail: verdicts differ from the native CPU verifier's")
    if floor_engine.last_rung != "cpu" or launched or grew != {
            "verify.tpu_items": 0, "verify.cpu_items": TAIL_ITEMS, "verify.failovers": 0,
            "verify.dispatch_errors": 0}:
        raise RuntimeError(f"min_tpu_batch tail: served by {floor_engine.last_rung} with "
                           f"{launched} launches and counts grown by {grew}; expected the cpu "
                           f"rung, {TAIL_ITEMS} cpu items and no launch")
    emit({"phase": "min_tpu_batch_tail", "card": card, "items": TAIL_ITEMS,
          "min_tpu_batch": floor_engine.cfg.min_tpu_batch,
          "rung": floor_engine.last_rung, "launches": launched, "grew": grew,
          "mismatches": 0, "seconds": tail_s})
    phase_done("min_tpu_batch_tail")

    # 5c. block ingest: a BTC block's wire bytes through the native
    #     extraction, the default-tuple engine (verify_u32) and combine,
    #     against the Python extraction and the native CPU verifier
    ingest_row, ingest_launches = block_ingest_phase(engines[first], first, reset_launches,
                                                     engine_metrics,
                                                     bch_txs=MAIN_BCH_BLOCK_TXS)
    emit({"phase": "block_ingest", "card": card, **ingest_row})
    phase_done("block_ingest")

    # 5d. node sync: a port Node syncs a chain from a wire-speaking remote
    #     (headers, IBD planner, native extraction, its own default engine on
    #     the card, the UTXO set), then verifies relayed mempool transactions
    node_row, node_launches = node_sync_phase(first, reset_launches, engine_metrics)
    emit({"phase": "node_sync", "card": card, **node_row})
    phase_done("node_sync")

    # 6. the kernel alone: both variants at both device shapes, every
    #    instantiation timed in turns (each full-product one right after its
    #    half-product twin, each dot_general one right after its shift-add
    #    twin) and held against the plain version, one plain call per
    #    (variant, width, form, reduction) at 32,768 lanes
    def make_args(items, lanes, wb, variant) -> tuple:
        prep = K.prepare_batch_raw(pack_items(items), pad_to=lanes, window_bits=wb)
        if prep.schnorr_free != (variant == "schnorr_free"):
            raise RuntimeError(f"{variant}: the batch selects the other variant")
        return K.from_reference(prep.device_args, "cuda"), prep.schnorr_free

    def launch(args, sf, form, reduce, select, sqr, mul, library):
        return launch_mode(args, sf, form, reduce, select, "scan", sqr, mul, library)

    def plain_version(args, sf, form, reduce, select, sqr):
        return plain_mode(args, sf, form, reduce, select, "scan", sqr, "shift_add")

    def on_row(row, args, sf) -> None:
        wb, form, reduce, select, sqr, mul, named, lanes = (row[k] for k in (
            "window_bits", "point_form", "reduce", "select", "sqr", "mul", "library", "lanes"))
        negated = sum(int(t.sum()) for t in args[4:8])
        row.update(verify_bounds(lanes, negated, sf, wb, form, reduce, select, sqr, sm_count,
                                 sm_clock, mul, named))
        row["library"] = named or cuda_kernel.kernel_library(wb, form, reduce, select, sqr, mul)
        if row["library"] in (cuda_kernel.U32_LIBRARY, *cuda_kernel.U32_MODES_LIBRARIES.values()):
            # an 8-word kernel: no call, Q's table read for λQ too
            row["calls_per_lane"] = 0
            row["select_read_bytes"] = u32_select_bytes(lanes, (wb, form, reduce, select, sqr))
        else:
            row["calls_per_lane"] = noinline_calls_per_lane(wb, form, reduce, sqr)[
                row["variant"]]
            row["convolutions_per_lane"] = convolutions_per_lane(wb, form, reduce)[
                row["variant"]]
            row["select_read_bytes"] = select_bytes(lanes, wb, form, select)
        if lanes == BLOCK_ITEMS and (wb, form, reduce, select, sqr, mul) == (
                *U32_KIND, "shift_add"):  # the 8-word kernel and its yardstick
            for _ in range(BURST_LAUNCHES):
                launch(args, sf, form, reduce, select, sqr, mul, named)
            row["under_load"] = nvidia_smi("clocks.sm,power.draw")
            torch.cuda.synchronize()
        emit({"phase": "kernel_timing", "card": card, **row})

    # each kind with both multiplies, routed; an 8-word kernel's radix-11
    # yardstick, by name, right after it, timed in turns with it, then
    # dot_general
    timing_kinds = [launch_kind for kind in kinds for launch_kind in (
        [(*kind, "shift_add", None), (*kind, "shift_add", YARDSTICKS[kind]),
         (*kind, "dot_general", None)] if kind in YARDSTICKS
        else [(*kind, mul, None) for mul in MUL_MODES])]
    plain_outputs = {}  # phase 6b's plain verdicts of the block
    rows = kernel_timing([("full", block), ("schnorr_free", tile(mempool, BLOCK_ITEMS))],
                         timing_kinds, make_args, launch, plain_version,
                         lambda fn, repeats: timed_ms(torch, fn, repeats), on_row,
                         plain_outputs=plain_outputs)
    for (*kind, mul, library, variant, _), row in rows.items():
        key = (*kind, variant, mul, library)
        max_err[key] = max(max_err[key], row["max_abs_err"])
    # each 8-word kernel over its radix-11 yardstick, in turns, with both bounds
    for (*kind, mul, library, variant, lanes), row in rows.items():
        if library is None:
            continue
        u32 = rows[(*kind, mul, None, variant, lanes)]
        emit({"phase": "u32_over_radix11", "card": card, "kind": kind,
              "library": u32["library"], "radix11_library": library,
              "variant": variant, "lanes": lanes,
              "ms": u32["ms"], "ms_runs": u32["ms_runs"], "radix11_ms": row["ms"],
              "radix11_ms_runs": row["ms_runs"], "ratio": row["u32_over_radix11"],
              "bound_ms": u32["bound_ms"], "bound_by": u32["bound_by"],
              "u32_bound_ms": u32["u32_bound_ms"], "radix11_bound_ms": u32["radix11_bound_ms"],
              "u32_over_own_bound": u32["ms"] / u32["u32_bound_ms"],
              "radix11_over_own_bound": row["ms"] / row["radix11_bound_ms"],
              "ptxas": ptxas[u32_ptxas_key(tuple(kind), variant)],
              "radix11_ptxas": ptxas[name(kind, variant)],
              **({"under_load": u32["under_load"], "radix11_under_load": row["under_load"]}
                 if "under_load" in u32 else {})})
    # each tree eager affine 8-word kernel over its one-hot twin, in turns
    for line in tree_over_onehot(rows):
        emit({"phase": "tree_over_onehot", "card": card, **line,
              "ptxas": ptxas[u32_ptxas_key(line["kind"], line["variant"])],
              "onehot_ptxas": ptxas[u32_ptxas_key((*line["kind"][:3], "onehot",
                                                   line["kind"][4]), line["variant"])]})
    # each dot_general instantiation over its shift-add twin, in turns
    for (*kind, mul, _, variant, lanes), row in rows.items():
        if mul != "dot_general":
            continue
        emit({"phase": "mul_dot_over_shift_add", "card": card, "variant": variant,
              "lanes": lanes, "window_bits": kind[0], "point_form": kind[1],
              "reduce": kind[2], "select": kind[3], "sqr": kind[4], "ms": row["ms"],
              "twin_ms": row["twin_ms"], "ratio": row["mul_dot_over_shift_add"],
              "bound_ms": row["bound_ms"], "formulation_bound_ms": row["formulation_bound_ms"],
              "convolutions_per_lane": row["convolutions_per_lane"]})
    # each full-product instantiation over its half-product twin, times and bounds
    for (*kind, mul, _, variant, lanes), row in rows.items():
        if kind[4] != "mul" or mul != "shift_add":
            continue
        # the half twin in the row's formulation: a radix-11 row's is the
        # yardstick where the half kind routes to an 8-word kernel
        half_kind = (*kind[:4], "half")
        radix11 = row["library"] in cuda_kernel.VERIFY_LIBRARIES.values()
        half = rows[(*half_kind, mul, YARDSTICKS.get(half_kind) if radix11 else None, variant,
                     lanes)]
        emit({"phase": "sqr_mul_over_half", "card": card, "library": row["library"],
              "half_library": half["library"], "variant": variant, "lanes": lanes,
              "window_bits": kind[0], "point_form": kind[1], "reduce": kind[2],
              "select": kind[3], "ms": row["ms"], "half_ms": half["ms"],
              "ratio": row["ms"] / half["ms"], "bound_ms": row["bound_ms"],
              "formulation_bound_ms": row["formulation_bound_ms"],
              "formulation_over_bound": row["formulation_bound_ms"] / row["bound_ms"],
              "calls_per_lane": row["calls_per_lane"],
              "half_calls_per_lane": half["calls_per_lane"]})
    phase_done("kernel_timing")

    # 6b. the fleet: (a) the block sharded over the cards (or two shards of
    #     the one card), against the unsharded launch, phase 6's plain
    #     verdicts of it and the native verifier; (a') an engine asking for
    #     a two-card mesh, which fails soft to the one card (or shards over
    #     two); (b) a two-host fleet
    #     engine through a partition of h1 and its rejoin; (c) the node_sync
    #     node on a two-host fleet engine, its verdicts equal to node_sync's
    u32_modes = dict(zip(("window_bits", "point_form", "reduce", "select", "sqr"), U32_KIND),
                     ladder="scan", mul="shift_add")
    sharded_row = sharded_dispatch_phase(
        pack_items(block), cpu[:BLOCK_ITEMS],
        plain_outputs[("full", *U32_KIND[:3])].cpu().tolist(), u32_modes)
    emit({"phase": "fleet", "part": "sharded", "card": card, **sharded_row})
    mesh_row, mesh_launches = mesh_engine_phase(raw, cpu, reset_launches, engine_metrics)
    emit({"phase": "fleet", "part": "mesh", "card": card, **mesh_row})
    fleet_row, fleet_launches = fleet_engine_phase(raw, cpu, reset_launches, engine_metrics)
    emit({"phase": "fleet", "part": "engine", "card": card, **fleet_row})
    fleet_node_row, fleet_node_launches = node_sync_phase(
        first, reset_launches, engine_metrics, verify=VerifyConfig(mesh_hosts=FLEET_HOSTS))
    if fleet_node_row["verdict_digest"] != node_row["verdict_digest"]:
        raise RuntimeError("fleet node: its verdicts differ from node_sync's")
    node_fleet = fleet_node_row["engine"].get("fleet") or {}
    if not node_fleet.get("affinity", {}).get("routed"):
        raise RuntimeError(f"fleet node: no submission routed by its key: {node_fleet}")
    emit({"phase": "fleet", "part": "node", "card": card, "equals_node_sync": True,
          **fleet_node_row})
    fleet_launches = mesh_launches + fleet_launches + fleet_node_launches
    phase_done("fleet")

    # 7. the adversarial campaign on the card, at each width, form,
    #    reduction, select, square and multiply, and under the unrolled
    #    ladders, all on one pool
    def make_pool():
        t0 = time.perf_counter()
        pool = build_pool(CAMPAIGN_BASE, random.Random(CAMPAIGN_SEED))
        emit({"phase": "campaign_pool", "items": len(pool[0]),
              "gen_s": time.perf_counter() - t0})
        return pool

    def run_counted(*args, **kwargs) -> dict:
        """run_campaign, with the launches it made by library and the items
        the cpu rung took."""
        before = dict(cuda_kernel.LIBRARY_LAUNCHES)
        cpu_before = metrics.get("verify.cpu_items")
        res = run_campaign(*args, **kwargs)
        res["library_launches"] = {lib: n - before[(lib, v)] for (lib, v), n in
                                   cuda_kernel.LIBRARY_LAUNCHES.items() if n != before[(lib, v)]}
        res["cpu_items"] = metrics.get("verify.cpu_items") - cpu_before
        return res

    def on_campaign(res) -> None:
        if res["kernel"] != "cuda":
            raise RuntimeError(f"campaign ran on {res['kernel']}, not the card")
        library = cuda_kernel.kernel_library(*(res[k] for k in (
            "window_bits", "point_form", "field_reduce", "select", "field_sqr", "field_mul")))
        if set(res["library_launches"]) != {library} or res["cpu_items"]:
            raise RuntimeError(f"campaign {res['window_bits']}/{res['point_form']}/.. ran in "
                               f"{res['library_launches']} with {res['cpu_items']} items on the "
                               f"cpu rung, expected {library} alone and none")
        emit({"phase": "campaign", "card": card, "library": library,
              **{k: res[k] for k in ("window_bits", "point_form", "field_reduce", "select",
                                     "ladder", "field_sqr", "field_mul", "items", "mismatches",
                                     "batch", "launches", "library_launches", "cpu_items",
                                     "run_s", "tally")}})

    run_campaigns(kinds, make_pool, run_counted, on_campaign)
    phase_done("campaign")

    # 8. summary: one entry for each kernel — the 8-word kernels' two and
    #    twelve instantiations and the radix-11 template's 128 at the main
    #    path's 32,768-lane shape (4,096 beside it), then the thirteen probe
    #    cases.  Launches are the main path's by library: the default tuple's
    #    in verify_u32, the eager affine ones' in verify_u32_modes_*,
    #    verify_u32_modes5_* and verify_u32_modes_tree_*, none in their
    #    radix-11 entries.
    kernels = []
    for mul in MUL_MODES:
        for *kind, _, named in (k for k in timing_kinds if k[5] == mul):
            wb, form, reduce, select, sqr = kind
            for variant in variants:
                main = rows[(*kind, mul, named, variant, BLOCK_ITEMS)]
                small = rows[(*kind, mul, named, variant, MEMPOOL_ITEMS)]
                library = main["library"]
                engine = with_ladder(kind, "scan", mul)
                if library == cuda_kernel.U32_LIBRARY:
                    label = f"verify_u32_kernel<{variant}>"
                    source = ("tpunode_torch/csrc/verify_u32.cu (+ csrc/field_u32.cuh, "
                              "csrc/curve_u32.cuh)")
                elif library in cuda_kernel.U32_MODES_LIBRARIES.values():
                    label = (f"verify_u32_modes_kernel<{variant}, w{wb}, affine, eager, "
                             f"{select}, {sqr}>")
                    source = ("tpunode_torch/csrc/verify_u32_modes.cu (+ csrc/field_u32.cuh, "
                              "csrc/curve_u32.cuh)")
                else:
                    label = (f"verify_kernel<{variant}, w{wb}, {form}, {reduce}, {select}, "
                             f"{sqr}{', dot_general' if mul == 'dot_general' else ''}>")
                    source = "tpunode_torch/csrc/verify_kernel.cu"
                entry = {
                    "name": label,
                    "route": "cuda",
                    "source": source,
                    "replaces": "tpunode/verify/pallas_kernel.py:526",
                    "library": library,
                    "launches": library_launches[engine][library][variant],
                    "launches_by_ladder": {
                        ladder: library_launches[with_ladder(kind, ladder, mul)][library][
                            variant]
                        for ladder in K.POW_LADDER_MODES
                        if with_ladder(kind, ladder, mul) in library_launches},
                    "max_abs_err": max_err[(*kind, variant, mul, named)],
                    "ms": main["ms"],
                    "plain_ms": main["plain_ms"],
                    "plain_of": main["plain_of"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"],
                    "formulation_bound_ms": main["formulation_bound_ms"],
                    "library_ms": None,
                    "window_bits": wb,
                    "point_form": form,
                    "reduce": reduce,
                    "select": select,
                    "sqr": sqr,
                    "mul": mul,
                    "variant": variant,
                    "lanes": BLOCK_ITEMS,
                    "at_4096": {k: small[k] for k in ("ms", "bound_ms", "formulation_bound_ms",
                                                      "plain_ms", "plain_of", "max_abs_err")},
                }
                if mul == "dot_general":
                    entry["source"] += " (+ csrc/field_dot.cuh)"
                    entry["mul_dot_over_shift_add"] = main["mul_dot_over_shift_add"]
                    entry["at_4096"]["mul_dot_over_shift_add"] = small["mul_dot_over_shift_add"]
                if library == cuda_kernel.U32_LIBRARY:
                    entry["launches_block_ingest"] = ingest_launches[variant]
                    entry["launches_node"] = node_launches[variant]
                    entry["launches_fleet"] = fleet_launches[variant]
                if named is not None:
                    entry["u32_over_radix11"] = main["u32_over_radix11"]
                    entry["at_4096"]["u32_over_radix11"] = small["u32_over_radix11"]
                if "u32_bound_ms" in main and library in (
                        cuda_kernel.U32_LIBRARY, *cuda_kernel.U32_MODES_LIBRARIES.values()):
                    entry["u32_bound_ms"] = main["u32_bound_ms"]
                    entry["at_4096"]["u32_bound_ms"] = small["u32_bound_ms"]
                kernels.append(entry)
    for probe in cuda_diag.PROBES:
        row = probes[probe]
        kernels.append({
            "name": f"cuda_diag.{probe}",
            "route": "cuda",
            "source": "tpunode_torch/csrc/diag.cu",
            "replaces": f"benchmarks/mosaic_diag.py:{PROBE_PALLAS_LINES[probe]}",
            **{k: row[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "lanes")},
            **({"formulation_bound_ms": row["formulation_bound_ms"]}
               if "formulation_bound_ms" in row else {}),
            **({k: row[k] for k in ("device_ms", "library_device_ms")}
               if probe == "trivial" else {}),
        })
    emit({"phase": "total", "seconds": time.perf_counter() - started,
          "phase_seconds": phase_seconds})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
