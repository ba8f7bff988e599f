"""The adversarial campaign: the port's verify path against the native CPU
verifier and each shape's required verdict.

The port's counterpart of ``benchmarks/campaign.py``, with the same pool
from the same seed: randomized valid signatures of all three algorithms
plus their adversarial shapes (21 in all):

* message and signature bit-flips (``z ^ 1``, ``s ^ 1``);
* ``s -> n - s`` twins (valid for ECDSA, invalid for BCH Schnorr and
  BIP340);
* ``r = x + n`` aliasing (ECDSA accepts through the x+n branch);
* boundary values ``r = p - 1``, ``s = n - 1``, ``r = 0``, ``s = 0``;
* absent, infinite and off-curve pubkeys;
* non-canonical-nonce Schnorr and BIP340 twins, where x(R) matches and only
  the jacobi symbol or the parity of y(R) rejects.

A mode of the verify kernel is eligible for dispatch only with zero
mismatches over the full pool (``n_base = 256``: 1,796 items).  The pool
goes through a :class:`VerifyEngine` with ``batch_size = device_batch =
batch``, on the card unless the CPU is asked for (then the kernel's plain
PyTorch version runs).  Run::

    python -m tpunode_torch.campaign [n_base] [batch] [--window-bits 4|5]
        [--point-form projective|affine] [--field-reduce lazy|eager]
        [--device cpu]

The square comes from ``TPUNODE_FIELD_SQR`` ("half" or "mul") and the
multiply from ``TPUNODE_FIELD_MUL`` ("shift_add" or "dot_general"), as the
reduction does when ``--field-reduce`` is not given.

The table select and the pow ladders' form have no flag, as in the
reference's campaign: the engine takes the ``TPUNODE_SELECT16`` and
``TPUNODE_POW_LADDER`` knobs' values when it is built, so the one-hot
select runs as ``TPUNODE_SELECT16=onehot python -m tpunode_torch.campaign``
and the unrolled ladders as ``TPUNODE_POW_LADDER=unroll python -m
tpunode_torch.campaign``.  It prints one JSON line, with the select and the
ladder it ran under ``"select"`` and ``"ladder"``, and exits 1 on any
mismatch.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from typing import Optional

import torch

from .verify import cuda_kernel
from .verify.cpu_native import load_native_verifier
from .verify.curve import POINT_FORMS
from .verify.ecdsa_cpu import (
    CURVE_N,
    CURVE_P,
    GENERATOR,
    Point,
    bip340_challenge,
    jacobi,
    lift_x,
    point_mul,
    schnorr_challenge,
    sign,
    sign_bip340,
    sign_schnorr,
)
from .verify.engine import VerifyConfig, VerifyEngine
from .verify.field import REDUCE_MODES
from .verify.raw import pack_items

__all__ = ["SEED", "build_pool", "run_campaign", "main"]

SEED = 0xCA4


def build_pool(n_base: int, rng: random.Random) -> tuple[list, list, list]:
    """(items, shapes, expects): the adversarial pool of verify items, the
    shape that produced each, and each shape's required verdict.  Item for
    item the reference's pool from the same ``rng`` state."""
    items, shapes, expects = [], [], []

    def add(item, shape, expect_valid):
        items.append(item)
        shapes.append(shape)
        expects.append(expect_valid)

    def nonce_with(pred):
        while True:
            k = rng.getrandbits(256) % CURVE_N or 1
            R = point_mul(k, GENERATOR)
            if pred(R):
                return k, R

    for i in range(n_base):
        priv = rng.getrandbits(256) % CURVE_N or 1
        pub = point_mul(priv, GENERATOR)
        z = rng.getrandbits(256)
        algo = i % 3
        if algo == 0:  # ECDSA + mutations
            r, s = sign(priv, z, rng.getrandbits(256) % CURVE_N or 1)
            add((pub, z, r, s), "ecdsa-valid", True)
            add((pub, z ^ 1, r, s), "ecdsa-zflip", False)
            add((pub, z, r, s ^ 1), "ecdsa-sflip", False)
            add((pub, z, r, CURVE_N - s), "ecdsa-neg-s", True)
            if r + CURVE_N < CURVE_P:  # x(R) < p - n: ~2^-129 for a random R
                add((pub, z, r + CURVE_N, s), "ecdsa-r-alias", True)
            add((pub, z, CURVE_P - 1, s), "ecdsa-r-boundary", False)
            add((pub, z, r, CURVE_N - 1), "ecdsa-s-boundary", False)
            add((pub, z, 0, s), "ecdsa-r0", False)
            add((pub, z, r, 0), "ecdsa-s0", False)
            add((None, z, r, s), "ecdsa-no-pub", False)
            add((Point(None, None), z, r, s), "ecdsa-inf-pub", False)
            add((Point(5, 7), z, r, s), "ecdsa-off-curve", False)
        elif algo == 1:  # BCH Schnorr + mutations
            r, s = sign_schnorr(priv, z, rng.getrandbits(256))
            e = schnorr_challenge(r, pub, z)
            add((pub, e, r, s, "schnorr"), "schnorr-valid", True)
            add((pub, e ^ 1, r, s, "schnorr"), "schnorr-eflip", False)
            add((pub, e, r, s ^ 1, "schnorr"), "schnorr-sflip", False)
            add((pub, e, r, CURVE_N - s, "schnorr"), "schnorr-neg-s", False)
            k, R = nonce_with(lambda R: jacobi(R.y) != 1)
            e2 = schnorr_challenge(R.x, pub, z)
            add((pub, e2, R.x, (k + e2 * priv) % CURVE_N, "schnorr"),
                "schnorr-jacobi-twin", False)
        else:  # BIP340 + mutations
            d = priv if pub.y % 2 == 0 else CURVE_N - priv
            r, s = sign_bip340(priv, z, rng.getrandbits(256))
            e = bip340_challenge(r, pub.x, z)
            pub340 = lift_x(pub.x)
            add((pub340, e, r, s, "bip340"), "bip340-valid", True)
            add((pub340, e ^ 1, r, s, "bip340"), "bip340-eflip", False)
            add((pub340, e, r, s ^ 1, "bip340"), "bip340-sflip", False)
            add((pub340, e, r, CURVE_N - s, "bip340"), "bip340-neg-s", False)
            k, R = nonce_with(lambda R: R.y % 2 != 0)
            e2 = bip340_challenge(R.x, pub.x, z)
            add((pub340, e2, R.x, (k + e2 * d) % CURVE_N, "bip340"),
                "bip340-parity-twin", False)
    return items, shapes, expects


def run_campaign(n_base: int, batch: int, window_bits: Optional[int] = None,
                 device: Optional[str] = None, point_form: Optional[str] = None,
                 field_reduce: Optional[str] = None, field_sqr: Optional[str] = None,
                 pool: Optional[tuple] = None, field_mul: Optional[str] = None) -> dict:
    """Build the pool from :data:`SEED` and send it through a verify engine
    at ``window_bits`` in ``point_form`` with ``field_reduce``,
    ``field_sqr`` and ``field_mul`` (None: the knobs') and the
    ``TPUNODE_SELECT16`` knob's select and ``TPUNODE_POW_LADDER`` knob's
    ladder on ``device`` (None: the card).  Each verdict is compared with the native CPU verifier's and
    with its shape's required verdict.  ``pool``, when given, is
    ``build_pool(n_base, random.Random(SEED))`` made once by a caller that
    runs many campaigns; it is used as it is (``gen_s`` is then None).
    Returns the result dict; ``mismatches`` must be 0."""
    gen_s = None
    if pool is None:
        t0 = time.perf_counter()
        pool = build_pool(n_base, random.Random(SEED))
        gen_s = time.perf_counter() - t0
    items, shapes, expects = pool

    engine = VerifyEngine(VerifyConfig(batch_size=batch, device_batch=batch, device=device,
                                       window_bits=window_bits, point_form=point_form,
                                       field_reduce=field_reduce, field_sqr=field_sqr,
                                       field_mul=field_mul))
    kind = (engine.cfg.window_bits, engine.cfg.point_form, engine.cfg.field_reduce,
            engine.select, engine.ladder, engine.cfg.field_sqr, engine.cfg.field_mul)
    launches = cuda_kernel.launch_count(*kind)
    t0 = time.perf_counter()
    got = engine.verify_sync(items)
    run_s = time.perf_counter() - t0
    launches = cuda_kernel.launch_count(*kind) - launches
    oracle = load_native_verifier().verify_raw(pack_items(items))

    mismatches = []
    tally: dict[str, list[int]] = {}
    for i, (g, e, want, shape) in enumerate(zip(got, oracle, expects, shapes)):
        accepted, total = tally.get(shape, [0, 0])
        tally[shape] = [accepted + g, total + 1]
        if g != e or g != want:
            mismatches.append({"index": i, "shape": shape, "device": g,
                               "oracle": e, "required": want})
    on_card = engine.device.type == "cuda"
    return {
        "items": len(items),
        "mismatches": len(mismatches),
        "mismatch_detail": mismatches[:10],
        "kernel": "cuda" if on_card else "plain",
        "device": torch.cuda.get_device_name(engine.device) if on_card else "cpu",
        "window_bits": kind[0],
        "point_form": kind[1],
        "field_reduce": kind[2],
        "select": kind[3],
        "ladder": kind[4],
        "field_sqr": kind[5],
        "field_mul": kind[6],
        "batch": batch,
        "launches": launches,
        "gen_s": gen_s,
        "run_s": run_s,
        "oracle": "native-cpp",
        "tally": {k: {"accepted": v[0], "total": v[1]} for k, v in sorted(tally.items())},
    }


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpunode_torch.campaign",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("n_base", nargs="?", type=int, default=256,
                    help="base signatures; the pool holds about 7 items per base")
    ap.add_argument("batch", nargs="?", type=int, default=2048,
                    help="the engine's batch_size and device_batch")
    ap.add_argument("--window-bits", type=int, choices=(4, 5), default=None,
                    help="window width (default: TPUNODE_WINDOW_BITS, else 4)")
    ap.add_argument("--point-form", choices=POINT_FORMS, default=None,
                    help="point form (default: TPUNODE_POINT_FORM, else projective)")
    ap.add_argument("--field-reduce", choices=REDUCE_MODES, default=None,
                    help="reduction of the point formulas' products "
                         "(default: TPUNODE_FIELD_REDUCE, else lazy)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card; cpu runs the kernel's plain version")
    args = ap.parse_args(argv)
    res = run_campaign(args.n_base, args.batch, window_bits=args.window_bits,
                       device=args.device, point_form=args.point_form,
                       field_reduce=args.field_reduce)
    print(json.dumps(res), flush=True)
    return 1 if res["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
