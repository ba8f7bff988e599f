"""The port's transaction layer (``txverify``) and its five oracle parsers
against the reference's.

The same wire bytes go through both packages' ``extract_sig_items``, with
and without prevout amounts, with ``bch`` off and on: equal items and equal
``ExtractStats``, on every template the extraction knows and on the
malformed shapes of the reference's multisig, taproot and P2PK/P2WSH tests.
``msig_match`` and ``combine_verdicts`` see every verdict pattern of every
m-of-n with n <= 3.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import random

import pytest

from benchmarks import txgen as RG
from tests.test_multisig import _mk_msig_tx
from tests.test_p2pk_wsh import make_p2pk_spend, make_wsh_single_spend
from tests.test_taproot import make_scriptpath_spend, make_taproot_spend
from tests.test_torch_wire import plain
from tpunode import txverify as RT
from tpunode.verify import ecdsa_cpu as RO
from tpunode_torch import txverify as T
from tpunode_torch import util as U
from tpunode_torch import wire as W
from tpunode_torch.verify import ecdsa_cpu as O


def _garbled_msig():
    tx, _ = _mk_msig_tx(2, 3, [0, 1], segwit=False)
    script = tx.inputs[0].script
    garbled = b"\x00" + RG._push(b"\x30" + b"\xee" * 70) + script[2 + script[1]:]
    return dataclasses.replace(tx, inputs=(dataclasses.replace(tx.inputs[0], script=garbled),))


def _retaproot(tx, *stacks):
    return dataclasses.replace(tx, witnesses=tuple(stacks))


def template_cases() -> dict:
    """name -> (reference Tx, prevout amounts, prevout scripts): every
    template, and the malformed shapes the reference's template tests
    build."""
    cases = {}
    for kind in [k for _, k in RG._MIX] + ["p2pkh-schnorr"]:
        base = "p2pkh" if kind == "p2pkh-schnorr" else kind
        txs = RG.gen_mixed_txs(2, seed=0x77, mix=[(1.01, base)], invalid_every=2,
                               schnorr_every=1 if kind == "p2pkh-schnorr" else 0)
        for t, tx in enumerate(txs):
            amounts, scripts = {}, {}
            for i, txin in enumerate(tx.inputs):
                amounts[i], scripts[i] = RG.synth_prevout(txin.prevout.txid, txin.prevout.index)
            cases[f"mix-{kind}-{'bad' if t else 'ok'}"] = (tx, amounts, scripts)
    for t, tx in enumerate(RG.gen_signed_txs(4, seed=9, segwit_every=2, invalid_every=3)):
        cases[f"signed-{t}"] = (tx, {0: 1_000_000 + t}, None)
    for segwit, wrap in ((False, False), (True, False), (True, True)):
        for signers in ([0, 1], [0, 2], [1, 2], [2, 0]):
            tx, _ = _mk_msig_tx(2, 3, signers, segwit, wrap_p2sh=wrap)
            amount = RG.synth_amount(tx.inputs[0].prevout.txid, tx.inputs[0].prevout.index)
            cases[f"msig-2of3-{segwit}-{wrap}-{signers}"] = (tx, {0: amount}, None)
    tx, _ = _mk_msig_tx(3, 5, [0, 2, 4], segwit=False)
    cases["msig-3of5"] = (tx, None, None)
    tx, _ = _mk_msig_tx(2, 3, [0, 1], segwit=False, bch=True)
    cases["msig-bch-forkid"] = (tx, {0: RG.synth_amount(tx.inputs[0].prevout.txid, 1)}, None)
    cases["msig-garbage-sig"] = (_garbled_msig(), None, None)
    tx, amounts, scripts = make_taproot_spend([21, 22], hashtypes=[0x00, 0x83], n_outputs=2)
    cases["taproot-keypath"] = (tx, amounts, scripts)
    sig = tx.witnesses[0][0]
    cases["taproot-65-zero-hashtype"] = (_retaproot(tx, (sig + b"\x00",), tx.witnesses[1]),
                                         amounts, scripts)
    cases["taproot-hashtype-04"] = (_retaproot(tx, (sig[:64] + b"\x04",), tx.witnesses[1]),
                                    amounts, scripts)
    cases["taproot-63-bytes"] = (_retaproot(tx, (sig[:63],), tx.witnesses[1]), amounts, scripts)
    cases["taproot-empty-sig"] = (_retaproot(tx, (b"",), tx.witnesses[1]), amounts, scripts)
    cases["taproot-script-shape"] = (
        _retaproot(tx, (b"\x01", b"\x51", b"\xc0" + b"\x02" * 32), tx.witnesses[1]),
        amounts, scripts)
    cases["taproot-off-curve-key"] = (tx, amounts, {0: b"\x51\x20" + (5).to_bytes(32, "big"),
                                                    1: scripts[1]})
    tx3, amounts3, scripts3 = make_taproot_spend([1, 2, 3], hashtypes=[1, 1, 1], n_outputs=2)
    cases["taproot-single-no-output"] = (
        _retaproot(tx3, tx3.witnesses[0], tx3.witnesses[1], (tx3.witnesses[2][0][:64] + b"\x03",)),
        amounts3, scripts3)
    tx, amounts, scripts = make_taproot_spend([31], annexes=[b"\x50\x01\x02"])
    cases["taproot-annex"] = (tx, amounts, scripts)
    tx, amounts, scripts, _ = make_scriptpath_spend([401, 402], annexes=[None, b"\x50\xaa"])
    cases["tapscript-single-key"] = (tx, amounts, scripts)
    w0 = tx.witnesses[0]
    cases["tapscript-bad-leaf-version"] = (
        _retaproot(tx, (w0[0], w0[1], b"\xc2" + w0[2][1:]), tx.witnesses[1]), amounts, scripts)
    cases["tapscript-short-control"] = (
        _retaproot(tx, (w0[0], w0[1], w0[2][:20]), tx.witnesses[1]), amounts, scripts)
    cases["tapscript-two-key-leaf"] = (
        _retaproot(tx, (w0[0], w0[1] + b"\x51", w0[2]), tx.witnesses[1]), amounts, scripts)
    for corrupt in (False, True):
        tx, amounts, scripts = make_p2pk_spend(corrupt=corrupt)
        cases[f"p2pk-{corrupt}"] = (tx, amounts, scripts)
    for nested in (False, True):
        tx, amounts, scripts = make_wsh_single_spend(nested=nested)
        cases[f"wsh-single-{nested}"] = (tx, amounts, scripts)
    tx, amounts, scripts = make_wsh_single_spend()
    for i, wit1 in enumerate((b"\x51\x51\x51", b"\x21" + b"\x02" * 33 + b"\xad", b"\x00" * 40)):
        cases[f"wsh-nonmatching-{i}"] = (_retaproot(tx, (tx.witnesses[0][0], wit1)),
                                         amounts, scripts)
    coinbase = RG._coinbase(7)
    cases["coinbase"] = (coinbase, None, None)
    return cases


CASES = template_cases()


def port_tx(tx):
    """The port's Tx over the reference Tx's wire bytes."""
    raw = tx.serialize()
    out = W.Tx.deserialize(U.Reader(raw))
    assert out.serialize() == raw
    return out


@pytest.mark.parametrize("bch", [False, True])
@pytest.mark.parametrize("with_amounts", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_extract_sig_items_equals_the_reference(name, with_amounts, bch):
    tx, amounts, scripts = CASES[name]
    amounts = amounts if with_amounts else None
    ours = T.extract_sig_items(port_tx(tx), prevout_amounts=amounts, bch=bch,
                               prevout_scripts=scripts)
    ref = RT.extract_sig_items(tx, prevout_amounts=amounts, bch=bch, prevout_scripts=scripts)
    assert plain(ours) == plain(ref)
    items = ours[0]
    verdicts = O.verify_batch_cpu([it.verify_item for it in items])
    assert verdicts == RO.verify_batch_cpu([it.verify_item for it in ref[0]])
    assert T.combine_verdicts(items, verdicts) == RT.combine_verdicts(ref[0], verdicts)
    assert len(T.combine_verdicts(items, verdicts)) == ours[1].sigs
    ptx = port_tx(tx)
    for i in range(len(tx.inputs)):
        assert T.wants_amount(ptx, i, bch) == RT.wants_amount(tx, i, bch)
        assert T.needs_prevout(ptx, i) == RT.needs_prevout(tx, i)


def test_templates_extract_and_verify_as_built():
    """The generator's good transactions verify and its corrupted ones do
    not, through the port alone."""
    for name, (tx, amounts, scripts) in CASES.items():
        if not name.startswith("mix-") or "unsupported" in name:
            continue
        bch = "schnorr" in name
        items, stats = T.extract_sig_items(port_tx(tx), prevout_amounts=amounts, bch=bch,
                                           prevout_scripts=scripts)
        assert stats.extracted == stats.total_inputs == 2, name
        per_sig = T.combine_verdicts(items, O.verify_batch_cpu([i.verify_item for i in items]))
        assert all(per_sig) == name.endswith("-ok"), name


def test_intra_block_maps_and_template_predicates():
    txs = [CASES[n][0] for n in sorted(CASES)]
    ours = [port_tx(t) for t in txs]
    assert T.intra_block_amounts(ours) == RT.intra_block_amounts(txs)
    assert T.intra_block_prevouts(ours) == RT.intra_block_prevouts(txs)
    rng = random.Random(5)
    scripts = [b"", b"\x51\x20" + rng.randbytes(32), b"\x51\x20" + rng.randbytes(31),
               b"\x21" + b"\x02" * 33 + b"\xac", b"\x41" + b"\x04" * 65 + b"\xac",
               b"\x20" + rng.randbytes(32) + b"\xac", b"\x20" + rng.randbytes(32) + b"\xad",
               RG._msig_script(2, [b"\x02" * 33] * 3), rng.randbytes(40)]
    for s in scripts:
        assert T.is_p2tr(s) == RT.is_p2tr(s)
        assert T.is_p2pk(s) == RT.is_p2pk(s)
        assert T.is_single_key_tapscript(s) == RT.is_single_key_tapscript(s)
        assert T._parse_multisig(s) == RT._parse_multisig(s)
        assert T._parse_pushes(s) == RT._parse_pushes(s)
        assert T._hash160(s) == RT._hash160(s)
        assert T._p2pkh_script_code(s[:33]) == RT._p2pkh_script_code(s[:33])


def _patterns(m: int, n: int):
    pairs = [(i, j) for i in range(m) for j in range(n)]
    for bits in itertools.product((False, True), repeat=len(pairs)):
        yield dict(zip(pairs, bits))


MOFN = [(m, n) for n in (1, 2, 3) for m in range(1, n + 1)]


@pytest.mark.parametrize("m,n", MOFN)
def test_msig_match_on_every_verdict_pattern(m, n):
    for ok in _patterns(m, n):
        assert T.msig_match(m, n, lambda i, j: ok[(i, j)]) == RT.msig_match(
            m, n, lambda i, j: ok[(i, j)])


@pytest.mark.parametrize("m,n", MOFN)
def test_combine_verdicts_on_every_verdict_pattern(m, n):
    """Candidates laid out as the extraction lays them (sig i against keys
    i..n-m+i), beside a single-sig item on either side."""
    txid = bytes(32)
    single = (None, 1, 2, 3, txid, 0)
    pairs = [(i, j) for i in range(m) for j in range(i, n - m + i + 1)]
    for cls, mod in ((T.SigItem, T), (RT.SigItem, RT)):
        items = ([cls(*single)] + [cls(None, 0, 0, 0, txid, 1, i, j, m, n) for i, j in pairs]
                 + [cls(*single[:5], 2)])
        got = [mod.combine_verdicts(items, v)
               for v in itertools.product((False, True), repeat=len(items))]
        if mod is T:
            ours = got
    assert ours == got
    assert all(len(v) == m + 2 for v in ours)


def _pubkey_encodings():
    rng = random.Random(11)
    out = []
    for k in (1, 2, 7, O.CURVE_N - 1, rng.getrandbits(256) % O.CURVE_N):
        P = O.point_mul(k, O.GENERATOR)
        x, y = P.x.to_bytes(32, "big"), P.y.to_bytes(32, "big")
        out += [bytes([2 + (P.y & 1)]) + x, bytes([3 - (P.y & 1)]) + x, b"\x04" + x + y,
                b"\x04" + x + (O.CURVE_P - P.y).to_bytes(32, "big"),
                b"\x06" + x + y, b"\x04" + x + ((P.y + 1) % O.CURVE_P).to_bytes(32, "big"),
                b"\x02" + x[:31], b"\x04" + x + y + b"\x00", b"\x05" + x]
    out += [b"", b"\x02" + O.CURVE_P.to_bytes(32, "big"), b"\x02" + (5).to_bytes(32, "big"),
            b"\x04" + O.CURVE_P.to_bytes(32, "big") + bytes(32), b"\x02" + b"\xff" * 32]
    return out


def test_decode_pubkey_on_valid_and_invalid_encodings():
    for blob in _pubkey_encodings():
        assert plain(O.decode_pubkey(blob)) == plain(RO.decode_pubkey(blob)), blob.hex()


def _der_encodings():
    rng = random.Random(12)
    out = []
    for _ in range(20):
        r, s = rng.getrandbits(256), rng.getrandbits(rng.choice((8, 128, 256)))
        der = RG._der(r, s)
        out += [der, der[:-1], der + b"\x00", b"\x31" + der[1:], der[:2] + b"\x03" + der[3:],
                der[:1] + bytes([der[1] + 1]) + der[2:]]
    out += [b"", b"\x30\x06\x02\x01\x01\x02\x01\x01", b"\x30\x06\x02\x05\x01\x02\x01\x01",
            b"\x30\x08\x02\x02\x00\x01\x02\x02\x00\x01", b"\x30" * 9,
            b"\x30\x07\x02\x01\x01\x02\x02\x01", b"\x30\x06\x02\x00\x02\x02\x01\x01"]
    return out


def test_parse_der_signature_on_valid_and_invalid_encodings():
    for blob in _der_encodings():
        assert O.parse_der_signature(blob) == RO.parse_der_signature(blob), blob.hex()


def test_tagged_hash_equals_the_reference():
    for tag in (b"BIP0340/challenge", b"TapLeaf", b"TapSighash", b""):
        for data in (b"", b"\x00" * 64, bytes(range(200))):
            assert O.tagged_hash(tag, data) == RO.tagged_hash(tag, data)
            th = hashlib.sha256(tag).digest()
            assert O.tagged_hash(tag, data) == hashlib.sha256(th + th + data).digest()


def test_verify_schnorr_and_verify_bip340_on_valid_and_invalid_signatures():
    rng = random.Random(13)
    for _ in range(4):
        priv = rng.getrandbits(256) % O.CURVE_N or 1
        m = rng.getrandbits(256)
        P = O.point_mul(priv, O.GENERATOR)
        r, s = O.sign_schnorr(priv, m, rng.getrandbits(256))
        cases = [(P, m, r, s), (P, m ^ 1, r, s), (P, m, r, (s + 1) % O.CURVE_N),
                 (P, m, O.CURVE_P, s), (P, m, r, O.CURVE_N), (None, m, r, s),
                 (O.INFINITY, m, r, s)]
        for pk, mm, rr, ss in cases:
            rpk = None if pk is None else RO.Point(pk.x, pk.y)
            assert O.verify_schnorr(pk, mm, rr, ss) == RO.verify_schnorr(rpk, mm, rr, ss)
        assert O.verify_schnorr(P, m, r, s)
        r, s = O.sign_bip340(priv, m, rng.getrandbits(256))
        for x, mm, rr, ss in [(P.x, m, r, s), (P.x, m ^ 1, r, s), (P.x, m, r, s ^ 1),
                              (5, m, r, s), (O.CURVE_P, m, r, s), (P.x, m, O.CURVE_P, s),
                              (P.x, m, r, O.CURVE_N)]:
            assert O.verify_bip340(x, mm, rr, ss) == RO.verify_bip340(x, mm, rr, ss)
        assert O.verify_bip340(P.x, m, r, s)
