"""Transaction signature hashes (what ECDSA actually signs).

The reference doesn't compute sighashes itself (haskoin-core does, for its
wallet side); the verify engine needs them to turn raw transactions into
(pubkey, digest, signature) triples.  Implements:

* the legacy (pre-segwit) sighash algorithm, including the historical
  SIGHASH_SINGLE out-of-range "hash = 1" quirk,
* BIP143 (segwit v0) digests, given the input amount,
* the BCH variant (BIP143-style with FORKID, used by Bitcoin Cash),
* BIP341 (taproot, segwit v1) digests, given EVERY input's prevout
  amount and scriptPubKey (keypath spends sign over the whole prevout
  set — the structural reason taproot extraction needs the extended
  prevout oracle).

Script handling is deliberately minimal: ``script_code`` is supplied by the
caller (txverify.py derives it for the standard templates).
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

from .util import double_sha256, write_varstr
from .wire import Tx, TxIn, TxOut

__all__ = [
    "SIGHASH_ALL",
    "SIGHASH_NONE",
    "SIGHASH_SINGLE",
    "SIGHASH_ANYONECANPAY",
    "SIGHASH_FORKID",
    "SIGHASH_DEFAULT",
    "legacy_sighash",
    "bip143_sighash",
    "bip341_sighash",
    "tapleaf_hash",
    "valid_taproot_hashtype",
]

SIGHASH_ALL = 0x01
SIGHASH_NONE = 0x02
SIGHASH_SINGLE = 0x03
SIGHASH_FORKID = 0x40  # BCH
SIGHASH_ANYONECANPAY = 0x80
SIGHASH_DEFAULT = 0x00  # BIP341: 64-byte signature, ALL semantics


def legacy_sighash(tx: Tx, index: int, script_code: bytes, hashtype: int) -> int:
    """Pre-segwit digest, as an integer (big-endian interpretation of the
    double-SHA256), matching what goes into ECDSA as ``z``."""
    base = hashtype & 0x1F
    if base == SIGHASH_SINGLE and index >= len(tx.outputs):
        # Historical quirk: out-of-range SIGHASH_SINGLE signs the digest "1".
        return 1

    inputs = []
    if hashtype & SIGHASH_ANYONECANPAY:
        src = [tx.inputs[index]]
        inputs = [TxIn(src[0].prevout, script_code, src[0].sequence)]
    else:
        for i, txin in enumerate(tx.inputs):
            script = script_code if i == index else b""
            seq = txin.sequence
            if i != index and base in (SIGHASH_NONE, SIGHASH_SINGLE):
                seq = 0
            inputs.append(TxIn(txin.prevout, script, seq))

    if base == SIGHASH_NONE:
        outputs: tuple[TxOut, ...] = ()
    elif base == SIGHASH_SINGLE:
        outputs = tuple(
            TxOut(-1 & 0xFFFFFFFFFFFFFFFF, b"") if i < index else tx.outputs[i]
            for i in range(index + 1)
        )
    else:
        outputs = tx.outputs

    stripped = Tx(
        version=tx.version,
        inputs=tuple(inputs),
        outputs=outputs,
        locktime=tx.locktime,
    )
    preimage = stripped.serialize(include_witness=False) + hashtype.to_bytes(
        4, "little"
    )
    return int.from_bytes(double_sha256(preimage), "big")


def bip143_sighash(
    tx: Tx,
    index: int,
    script_code: bytes,
    amount: int,
    hashtype: int,
) -> int:
    """Segwit v0 digest (BIP143); also the BCH replay-protected algorithm
    when ``hashtype`` carries SIGHASH_FORKID."""
    base = hashtype & 0x1F
    anyonecanpay = bool(hashtype & SIGHASH_ANYONECANPAY)

    if anyonecanpay:
        hash_prevouts = b"\x00" * 32
    else:
        hash_prevouts = double_sha256(
            b"".join(i.prevout.serialize() for i in tx.inputs)
        )
    if anyonecanpay or base in (SIGHASH_NONE, SIGHASH_SINGLE):
        hash_sequence = b"\x00" * 32
    else:
        hash_sequence = double_sha256(
            b"".join(i.sequence.to_bytes(4, "little") for i in tx.inputs)
        )
    if base not in (SIGHASH_NONE, SIGHASH_SINGLE):
        hash_outputs = double_sha256(b"".join(o.serialize() for o in tx.outputs))
    elif base == SIGHASH_SINGLE and index < len(tx.outputs):
        hash_outputs = double_sha256(tx.outputs[index].serialize())
    else:
        hash_outputs = b"\x00" * 32

    txin = tx.inputs[index]
    preimage = (
        tx.version.to_bytes(4, "little")
        + hash_prevouts
        + hash_sequence
        + txin.prevout.serialize()
        + write_varstr(script_code)
        + amount.to_bytes(8, "little")
        + txin.sequence.to_bytes(4, "little")
        + hash_outputs
        + tx.locktime.to_bytes(4, "little")
        + hashtype.to_bytes(4, "little")
    )
    return int.from_bytes(double_sha256(preimage), "big")


def _tagged_hash(tag: bytes, data: bytes) -> bytes:
    th = hashlib.sha256(tag).digest()
    return hashlib.sha256(th + th + data).digest()


def valid_taproot_hashtype(hashtype: int) -> bool:
    """BIP341's valid hash_type set: 0x00 (default) or base 1..3, with or
    without ANYONECANPAY.  Anything else makes the spend invalid."""
    return hashtype in (0x00, 0x01, 0x02, 0x03, 0x81, 0x82, 0x83)


def tapleaf_hash(script: bytes, leaf_version: int = 0xC0) -> bytes:
    """BIP341 TapLeaf hash: tagged_hash("TapLeaf", version ∥ varstr(script))
    — the script-path sighash (BIP342) commits to the executed leaf."""
    return _tagged_hash(
        b"TapLeaf", bytes([leaf_version]) + write_varstr(script)
    )


def bip341_sighash(
    tx: Tx,
    index: int,
    amounts: Sequence[int],
    scripts: Sequence[bytes],
    hashtype: int = SIGHASH_DEFAULT,
    annex: Optional[bytes] = None,
    leaf_hash: Optional[bytes] = None,
) -> Optional[int]:
    """Taproot (segwit v1) signature message, per BIP341's SigMsg:
    KEYPATH (``ext_flag = 0``) when ``leaf_hash`` is None, SCRIPT-path
    (``ext_flag = 1``, BIP342 extension: tapleaf hash ∥ key_version 0 ∥
    codesep position 0xFFFFFFFF) when the executed leaf's
    :func:`tapleaf_hash` is supplied.

    ``amounts``/``scripts`` are the spent outputs' values and
    scriptPubKeys for ALL of ``tx``'s inputs, in input order (with
    ANYONECANPAY only entry ``index`` is consulted).  ``annex`` is the
    raw annex WITHOUT its 0x50 prefix stripped (i.e. the full witness
    element), or None.  All hashes are single SHA-256 (unlike
    legacy/BIP143's double).

    Returns the digest as an int, or None when the spend is structurally
    invalid under BIP341 (invalid hash_type, or SIGHASH_SINGLE with no
    matching output) — the caller turns None into an auto-invalid item,
    matching consensus "validation failure", not "unsupported".
    """
    if not valid_taproot_hashtype(hashtype):
        return None
    base = hashtype & 3
    anyonecanpay = bool(hashtype & SIGHASH_ANYONECANPAY)
    if base == SIGHASH_SINGLE and index >= len(tx.outputs):
        return None  # BIP341: invalid (no legacy "hash = 1" quirk)

    msg = bytearray()
    msg.append(hashtype)
    msg += tx.version.to_bytes(4, "little")
    msg += tx.locktime.to_bytes(4, "little")
    if not anyonecanpay:
        msg += hashlib.sha256(
            b"".join(i.prevout.serialize() for i in tx.inputs)
        ).digest()
        msg += hashlib.sha256(
            b"".join(int(a).to_bytes(8, "little") for a in amounts)
        ).digest()
        msg += hashlib.sha256(
            b"".join(write_varstr(s) for s in scripts)
        ).digest()
        msg += hashlib.sha256(
            b"".join(i.sequence.to_bytes(4, "little") for i in tx.inputs)
        ).digest()
    if base not in (SIGHASH_NONE, SIGHASH_SINGLE):
        msg += hashlib.sha256(
            b"".join(o.serialize() for o in tx.outputs)
        ).digest()
    ext_flag = 0 if leaf_hash is None else 1
    msg.append(ext_flag * 2 + (1 if annex is not None else 0))  # spend_type
    txin = tx.inputs[index]
    if anyonecanpay:
        msg += txin.prevout.serialize()
        msg += int(amounts[index]).to_bytes(8, "little")
        msg += write_varstr(scripts[index])
        msg += txin.sequence.to_bytes(4, "little")
    else:
        msg += index.to_bytes(4, "little")
    if annex is not None:
        msg += hashlib.sha256(write_varstr(annex)).digest()
    if base == SIGHASH_SINGLE:
        msg += hashlib.sha256(tx.outputs[index].serialize()).digest()
    if leaf_hash is not None:
        # BIP342 sighash extension (key_version 0; no OP_CODESEPARATOR in
        # the templates this engine extracts, so the position is the
        # "none executed" sentinel)
        msg += leaf_hash
        msg.append(0x00)
        msg += (0xFFFFFFFF).to_bytes(4, "little")
    return int.from_bytes(
        _tagged_hash(b"TapSighash", b"\x00" + bytes(msg)), "big"
    )
