"""Persistent UTXO store behind the prevout-oracle seam.

The node's verify paths need prevout data — satoshi amount and
scriptPubKey — for BIP143 (P2WPKH / BCH FORKID) and BIP341 (taproot)
digests.  Intra-block spends resolve from the block itself and unconfirmed
parents from the mempool; everything *confirmed* used to require the
embedder's ``NodeConfig.prevout_lookup``.  :class:`UtxoStore` fills that
gap with a durable UTXO set over any :class:`~tpunode_torch.store.KVStore`
(the node wires it over a ``Namespaced`` view of its main store, so one
crash-consistent LogKV holds headers and UTXOs side by side).

Crash consistency contract:

* block connect applies every spend + create **and** the block-height
  watermark in ONE atomic ``write_batch`` — a record-level-atomic log
  (LogKV v2) therefore never persists half a block;
* the watermark is monotone: :meth:`apply` refuses heights at or below it,
  so a crash-then-replay of the same block stream is idempotent (the
  re-delivered blocks are skipped, counted in ``utxo.skipped``);
* lookups never see a partially-connected block: the in-memory index the
  store serves reads from is only mutated by the same atomic batch.

Reorg support: every connect also writes a per-block UNDO
record — the spent prevouts' old values, the created keys and the prior
watermark — in the SAME atomic batch, retained for the newest
``undo_depth`` blocks (default 100).  :meth:`disconnect` pops the tip
block by replaying its undo record (again one atomic batch), so a reorg
at or beneath the watermark unwinds cleanly to the fork point instead of
going loudly stale; ``utxo.reorg_stale`` remains the fallback for reorgs
deeper than the retained undo depth.  Disconnect followed by re-connect
round-trips the UTXO set bit-identically (pinned by tests/test_torch_store.py).

Block connect has two producers: :meth:`apply_block` parses wire ``Tx``
objects in Python (the reference path), and :meth:`apply_ops_blob`
consumes the C++ extractor's one-pass delta blob
(``ParsedTxRegion.utxo_ops``) so the Python per-tx parse leaves block
ingest entirely (node._apply_block_utxo).

Schema (within the namespaced view): ``b"o" + txid + vout_le32`` ->
``amount_le64 + scriptPubKey``; ``b"!wm"`` -> ``height_le64 + block_hash``;
``b"U" + height_le64`` -> undo record.
"""

from __future__ import annotations

import struct
from typing import Iterable, Optional, Sequence

from .events import events
from .metrics import metrics
from .store import BatchOp, KVStore, delete_op, put_op

__all__ = ["UtxoStore", "UTXO_NAMESPACE", "UNDO_DEPTH_DEFAULT"]

#: The namespace the node mounts the UTXO set under on its main store.
UTXO_NAMESPACE = b"u/"

#: Default per-block UNDO retention: reorgs up to this deep beneath the
#: watermark disconnect cleanly; deeper ones fall back to reorg_stale.
UNDO_DEPTH_DEFAULT = 100

_WM_KEY = b"!wm"
_OUT_PREFIX = b"o"
_UNDO_PREFIX = b"U"
_AMOUNT = struct.Struct("<q")
_WM = struct.Struct("<q")
_U32 = struct.Struct("<I")
_ZERO_TXID = b"\x00" * 32

# ops-blob record header (shared with native/txextract txx_utxo_ops_h and
# the native kvstore's v1 batch ABI): op(u8) klen(u32le) vlen(u32le)
_REC = struct.Struct("<BII")
_OP_PUT = 1
_OP_DEL = 2


def _okey(txid: bytes, vout: int) -> bytes:
    return _OUT_PREFIX + txid + vout.to_bytes(4, "little")


def _ukey(height: int) -> bytes:
    return _UNDO_PREFIX + _WM.pack(height)


class UtxoStore:
    """A persistent UTXO set + block-height watermark over a KV store."""

    def __init__(self, kv: KVStore, undo_depth: int = UNDO_DEPTH_DEFAULT):
        self._kv = kv
        self.undo_depth = max(0, int(undo_depth))
        wm = kv.get(_WM_KEY)
        if wm is None:
            self._height, self._block_hash = -1, None
        else:
            self._height = _WM.unpack_from(wm)[0]
            self._block_hash = wm[_WM.size :] or None
        if self._height >= 0:
            metrics.set_gauge("utxo.height", float(self._height))

    # -- prevout oracle ------------------------------------------------------

    @property
    def height(self) -> int:
        """The watermark: every block at or below this height is fully
        applied (−1 = empty store)."""
        return self._height

    @property
    def block_hash(self) -> Optional[bytes]:
        return self._block_hash

    def lookup(self, txid: bytes, vout: int) -> Optional[tuple[int, bytes]]:
        """The prevout-oracle callable (``NodeConfig.prevout_lookup``
        shape): ``(amount, scriptPubKey)`` or None."""
        raw = self._kv.get(_okey(txid, vout))
        if raw is None:
            return None  # unknown or already spent
        return _AMOUNT.unpack_from(raw)[0], raw[_AMOUNT.size :]

    # -- block connect -------------------------------------------------------

    def apply(
        self,
        height: int,
        block_hash: bytes,
        spends: Iterable[tuple[bytes, int]],
        creates: Iterable[tuple[bytes, int, int, bytes]],
    ) -> bool:
        """Connect one block's UTXO delta atomically.

        ``spends`` are ``(txid, vout)`` outpoints consumed; ``creates`` are
        ``(txid, vout, amount, script)`` outputs born.  Everything lands in
        ONE ``write_batch`` together with the advanced watermark (and the
        block's UNDO record), so the store can never hold half a block.
        Heights at or below the watermark are refused (idempotent
        crash-replay); contiguity is the CALLER's job — skipping a height
        would strand that block's delta below the watermark forever (the
        node enforces watermark+1-only connects, ``node._apply_block_utxo``).

        Returns True when applied, False when skipped as already-persisted.
        """
        if height <= self._height:
            metrics.inc("utxo.skipped")
            return False
        ops: list[BatchOp] = []
        created_keys: list[bytes] = []
        spent_pairs: list[tuple[bytes, bytes]] = []
        for txid, vout, amount, script in creates:
            key = _okey(txid, vout)
            ops.append(put_op(key, _AMOUNT.pack(amount) + script))
            created_keys.append(key)
        want_undo = self.undo_depth > 0  # pre-spend reads are undo-only
        n_spent = 0
        for txid, vout in spends:
            key = _okey(txid, vout)
            if want_undo:
                old = self._kv.get(key)
                if old is not None:
                    spent_pairs.append((key, old))
            ops.append(delete_op(key))
            n_spent += 1
        return self._commit(
            height, block_hash, ops, spent_pairs, created_keys,
            len(created_keys), n_spent,
        )

    def apply_block(self, height: int, block_hash: bytes, txs: Sequence) -> bool:
        """Connect a block from parsed tx objects (wire.Tx/LazyTx shape:
        ``.txid``, ``.inputs[].prevout.{txid,index}``,
        ``.outputs[].{value,script}``).  Creates are emitted before spends
        *per the whole block*, and write_batch applies ops in order, so a
        same-block child spending a parent's output nets out correctly."""
        if height <= self._height:
            metrics.inc("utxo.skipped")
            return False
        creates: list[tuple[bytes, int, int, bytes]] = []
        spends: list[tuple[bytes, int]] = []
        for tx in txs:
            txid = tx.txid
            for vout, out in enumerate(tx.outputs):
                creates.append((txid, vout, out.value, out.script))
            for txin in tx.inputs:
                prev = txin.prevout
                if prev.txid == _ZERO_TXID:
                    continue  # coinbase input spends nothing
                spends.append((prev.txid, prev.index))
        applied = self.apply(height, block_hash, spends, creates)
        if applied:
            events.emit(
                "utxo.block", height=height, created=len(creates),
                spent=len(spends),
            )
        return applied

    def apply_ops_blob(
        self, height: int, block_hash: bytes, blob: bytes,
        created: int, spent: int,
    ) -> bool:
        """Connect a block from the C++ extractor's one-pass delta blob
        (``ParsedTxRegion.utxo_ops`` — creates then spends in v1 record
        format): the hot-path twin of :meth:`apply_block` with
        zero Python per-tx work.  Bit-identical final state (pinned by
        tests/test_torch_store.py)."""
        if height <= self._height:
            metrics.inc("utxo.skipped")
            return False
        ops: list[BatchOp] = []
        created_keys: list[bytes] = []
        spent_pairs: list[tuple[bytes, bytes]] = []
        want_undo = self.undo_depth > 0  # pre-spend reads are undo-only
        pos = 0
        n = len(blob)
        while pos < n:
            op, klen, vlen = _REC.unpack_from(blob, pos)
            pos += _REC.size
            key = blob[pos : pos + klen]
            pos += klen
            if op == _OP_PUT:
                ops.append(("put", key, blob[pos : pos + vlen]))
                pos += vlen
                created_keys.append(key)
            elif op == _OP_DEL:
                if want_undo:
                    old = self._kv.get(key)
                    if old is not None:
                        spent_pairs.append((key, old))
                ops.append(("del", key, b""))
            else:
                raise ValueError(f"bad op {op} in utxo ops blob")
        applied = self._commit(
            height, block_hash, ops, spent_pairs, created_keys,
            created, spent,
        )
        if applied:
            events.emit(
                "utxo.block", height=height, created=created, spent=spent,
            )
        return applied

    def _commit(
        self,
        height: int,
        block_hash: bytes,
        ops: list[BatchOp],
        spent_pairs: list[tuple[bytes, bytes]],
        created_keys: list[bytes],
        created: int,
        spent: int,
    ) -> bool:
        """One atomic connect: delta + undo record + watermark."""
        if self.undo_depth > 0:
            ops.append(put_op(
                _ukey(height),
                self._pack_undo(
                    self._height, self._block_hash, spent_pairs,
                    created_keys,
                ),
            ))
            expired = height - self.undo_depth
            if expired >= 0:
                ops.append(delete_op(_ukey(expired)))
        ops.append(put_op(_WM_KEY, _WM.pack(height) + block_hash))
        self._kv.write_batch(ops)
        self._height, self._block_hash = height, block_hash
        metrics.set_gauge("utxo.height", float(height))
        metrics.inc("utxo.applied")
        metrics.inc("utxo.created", created)
        metrics.inc("utxo.spent", spent)
        return True

    # -- per-block UNDO -------------------------------------------

    @staticmethod
    def _pack_undo(
        prior_height: int,
        prior_hash: Optional[bytes],
        spent_pairs: list[tuple[bytes, bytes]],
        created_keys: list[bytes],
    ) -> bytes:
        """Undo record: the exact prior watermark (height + hash), the
        spent keys with their pre-spend values, the created keys —
        everything disconnect needs to restore the exact prior state."""
        ph = prior_hash or b""
        parts = [_WM.pack(prior_height), _U32.pack(len(ph)), ph,
                 _U32.pack(len(spent_pairs))]
        for key, val in spent_pairs:
            parts.append(_U32.pack(len(key)) + key)
            parts.append(_U32.pack(len(val)) + val)
        parts.append(_U32.pack(len(created_keys)))
        for key in created_keys:
            parts.append(_U32.pack(len(key)) + key)
        return b"".join(parts)

    def undo_available(self, height: Optional[int] = None) -> bool:
        """Is the undo record for ``height`` (default: the tip) retained?"""
        h = self._height if height is None else height
        return h >= 0 and self._kv.get(_ukey(h)) is not None

    def disconnect(self) -> bool:
        """Disconnect the tip block by replaying its undo record in ONE
        atomic batch: created outputs deleted, spent outputs restored with
        their pre-spend values, the watermark rolled back to the exact
        prior (height, hash) the record carries.

        Returns False — leaving the store untouched — when the tip has no
        retained undo record (reorg deeper than ``undo_depth``: the
        loudly-stale fallback is the caller's next move)."""
        if self._height < 0:
            return False
        raw = self._kv.get(_ukey(self._height))
        if raw is None:
            metrics.inc("utxo.undo_missing")
            return False
        pos = 0
        prior_height = _WM.unpack_from(raw, pos)[0]
        pos += _WM.size
        phlen = _U32.unpack_from(raw, pos)[0]
        pos += _U32.size
        prior_hash = raw[pos : pos + phlen] or None
        pos += phlen
        n_spent = _U32.unpack_from(raw, pos)[0]
        pos += _U32.size
        restores: list[tuple[bytes, bytes]] = []
        for _ in range(n_spent):
            klen = _U32.unpack_from(raw, pos)[0]
            pos += _U32.size
            key = raw[pos : pos + klen]
            pos += klen
            vlen = _U32.unpack_from(raw, pos)[0]
            pos += _U32.size
            restores.append((key, raw[pos : pos + vlen]))
            pos += vlen
        n_created = _U32.unpack_from(raw, pos)[0]
        pos += _U32.size
        ops: list[BatchOp] = []
        for _ in range(n_created):
            klen = _U32.unpack_from(raw, pos)[0]
            pos += _U32.size
            ops.append(delete_op(raw[pos : pos + klen]))
            pos += klen
        for key, val in restores:
            ops.append(put_op(key, val))
        ops.append(delete_op(_ukey(self._height)))
        if prior_height >= 0:
            ops.append(put_op(
                _WM_KEY, _WM.pack(prior_height) + (prior_hash or b"")
            ))
        else:
            ops.append(delete_op(_WM_KEY))
        self._kv.write_batch(ops)
        disconnected = self._height
        self._height = prior_height
        self._block_hash = prior_hash if prior_height >= 0 else None
        metrics.set_gauge("utxo.height", float(max(prior_height, -1)))
        metrics.inc("utxo.disconnected")
        events.emit(
            "utxo.undo", height=disconnected,
            restored=len(restores), removed=n_created,
        )
        return True

    def snapshot(self) -> dict[bytes, bytes]:
        """Every unspent output row (test/bit-identity probe; the undo
        round-trip and native-vs-python connect pins compare these)."""
        return dict(self._kv.scan_prefix(_OUT_PREFIX))

    def stats(self) -> dict:
        return {
            "enabled": True,
            "height": self._height,
            "undo_depth": self.undo_depth,
            "applied": metrics.get("utxo.applied"),
            "skipped": metrics.get("utxo.skipped"),
            "created": metrics.get("utxo.created"),
            "spent": metrics.get("utxo.spent"),
            "disconnected": metrics.get("utxo.disconnected"),
        }
