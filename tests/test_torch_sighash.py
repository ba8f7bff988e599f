"""The port's sighash digests against the reference's: legacy, BIP143 (and
BCH's FORKID form), BIP341 keypath and script path, and tapleaf hashes, under
every hashtype, on generated transactions."""

from __future__ import annotations

import dataclasses
import random

import pytest

from benchmarks import txgen as RG
from tpunode import sighash as RS
from tpunode import wire as RW
from tpunode_torch import sighash as S
from tpunode_torch import util as U
from tpunode_torch import wire as W

BASES = (S.SIGHASH_ALL, S.SIGHASH_NONE, S.SIGHASH_SINGLE)
HASHTYPES = [base | acp | fork for base in BASES for acp in (0, S.SIGHASH_ANYONECANPAY)
             for fork in (0, S.SIGHASH_FORKID)]
# BIP341's valid set and some it refuses
TAP_HASHTYPES = [0x00, 0x01, 0x02, 0x03, 0x81, 0x82, 0x83, 0x04, 0x41, 0x80, 0xC1]


def _pairs() -> list:
    """(reference Tx, port Tx) over the same bytes: the generator's mix at
    three inputs, given a second output so that SIGHASH_SINGLE has an
    output for input 1 and none for input 2."""
    rng = random.Random(3)
    out = []
    for tx in RG.gen_mixed_txs(8, seed=0x5161, inputs_per_tx=3):
        extra = RW.TxOut(rng.randrange(1, 10**8), rng.randbytes(rng.choice((22, 25, 34))))
        ref = dataclasses.replace(tx, outputs=tx.outputs + (extra,),
                                  locktime=rng.getrandbits(32))
        ours = W.Tx.deserialize(U.Reader(ref.serialize()))
        assert ours.serialize() == ref.serialize()
        out.append((ref, ours))
    return out


PAIRS = _pairs()


def test_hashtype_constants_are_the_reference_ones():
    names = ("SIGHASH_ALL", "SIGHASH_NONE", "SIGHASH_SINGLE", "SIGHASH_FORKID",
             "SIGHASH_ANYONECANPAY", "SIGHASH_DEFAULT")
    assert [getattr(S, n) for n in names] == [getattr(RS, n) for n in names]


@pytest.mark.parametrize("hashtype", HASHTYPES, ids=lambda h: f"{h:#04x}")
def test_legacy_digest(hashtype):
    rng = random.Random(hashtype)
    for ref, ours in PAIRS:
        for i in range(len(ref.inputs)):
            code = rng.randbytes(rng.choice((0, 25, 71)))
            got = S.legacy_sighash(ours, i, code, hashtype)
            assert got == RS.legacy_sighash(ref, i, code, hashtype)
    # SIGHASH_SINGLE past the outputs signs the digest 1
    if hashtype & 0x1F == S.SIGHASH_SINGLE:
        assert S.legacy_sighash(PAIRS[0][1], 2, b"", hashtype) == 1


@pytest.mark.parametrize("hashtype", HASHTYPES, ids=lambda h: f"{h:#04x}")
def test_bip143_digest(hashtype):
    rng = random.Random(hashtype + 1)
    for ref, ours in PAIRS:
        for i in range(len(ref.inputs)):
            code = rng.randbytes(rng.choice((25, 71, 105)))
            amount = rng.randrange(0, 21 * 10**14)
            assert S.bip143_sighash(ours, i, code, amount, hashtype) == RS.bip143_sighash(
                ref, i, code, amount, hashtype)


@pytest.mark.parametrize("hashtype", TAP_HASHTYPES, ids=lambda h: f"{h:#04x}")
@pytest.mark.parametrize("path", ["keypath", "script", "keypath_annex", "script_annex"])
def test_bip341_digest(hashtype, path):
    rng = random.Random(hashtype * 7 + len(path))
    for ref, ours in PAIRS:
        n = len(ref.inputs)
        amounts = [rng.randrange(0, 21 * 10**14) for _ in range(n)]
        scripts = [b"\x51\x20" + rng.randbytes(32) for _ in range(n)]
        leaf = S.tapleaf_hash(b"\x20" + rng.randbytes(32) + b"\xac") if "script" in path else None
        annex = b"\x50" + rng.randbytes(rng.randrange(0, 40)) if "annex" in path else None
        for i in range(n):
            got = S.bip341_sighash(ours, i, amounts, scripts, hashtype, annex=annex,
                                   leaf_hash=leaf)
            want = RS.bip341_sighash(ref, i, amounts, scripts, hashtype, annex=annex,
                                     leaf_hash=leaf)
            assert got == want
            assert (got is None) == (not S.valid_taproot_hashtype(hashtype)
                                     or (hashtype & 3 == S.SIGHASH_SINGLE and i >= 2))
    assert S.valid_taproot_hashtype(hashtype) == RS.valid_taproot_hashtype(hashtype)


@pytest.mark.parametrize("leaf_version", [0xC0, 0xC2, 0xFE])
def test_tapleaf_hash(leaf_version):
    rng = random.Random(leaf_version)
    for size in (0, 1, 34, 75, 252, 253, 520):
        script = rng.randbytes(size)
        assert S.tapleaf_hash(script, leaf_version) == RS.tapleaf_hash(script, leaf_version)
    assert S.tapleaf_hash(b"\x51") == RS.tapleaf_hash(b"\x51")
