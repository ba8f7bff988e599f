"""The port's util, params, wire and headers against the reference's.

The same bytes go through both packages: every field decodes equal and
re-serialises to the same bytes.  Messages of every type in ``wire.py``,
transactions of every script kind of the generator's mix, blocks from
``gen_chain``, varints and ``Reader`` at their boundaries, bits and
targets, merkle roots, each ``Network`` and its genesis node.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest

from benchmarks import txgen as RG
from tpunode import headers as RH
from tpunode import params as RP
from tpunode import util as RU
from tpunode import wire as RW
from tpunode_torch import headers as H
from tpunode_torch import params as P
from tpunode_torch import txgen as G
from tpunode_torch import util as U
from tpunode_torch import wire as W

NETWORKS = ("BTC", "BTC_TEST", "BTC_REGTEST", "BCH", "BCH_TEST", "BCH_REGTEST")
MIX_KINDS = [kind for _, kind in RG._MIX]


def plain(obj):
    """``obj`` as nested tuples of class names, field names and values, so
    that objects of the two packages compare equal when their fields do."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple((f.name, plain(getattr(obj, f.name))) for f in dataclasses.fields(obj)))
    if type(obj).__name__ == "LazyBlock":
        return ("LazyBlock", plain(obj.header), obj.tx_count, obj.raw_txs, plain(obj.txs))
    if type(obj).__name__ == "LazyTx":
        return ("LazyTx", obj.raw, plain(obj._parsed()))
    if isinstance(obj, (tuple, list)):
        return tuple(plain(x) for x in obj)
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return (obj.dtype.str, obj.shape, obj.tobytes())
    return obj


@pytest.mark.parametrize("name", NETWORKS)
def test_network_equal_field_for_field(name):
    ours, ref = getattr(P, name), getattr(RP, name)
    assert plain(ours) == plain(ref)
    assert (ours.retarget_interval, ours.pow_limit_bits) == (
        ref.retarget_interval, ref.pow_limit_bits)
    assert P.NETWORKS.keys() == RP.NETWORKS.keys()
    assert (P.NODE_NETWORK, P.NODE_WITNESS, P.PROTOCOL_VERSION) == (
        RP.NODE_NETWORK, RP.NODE_WITNESS, RP.PROTOCOL_VERSION)


@pytest.mark.parametrize("name", NETWORKS)
def test_genesis_node_equal_for_each_network(name):
    ours, ref = H.genesis_node(getattr(P, name)), RH.genesis_node(getattr(RP, name))
    assert plain(ours) == plain(ref)
    assert ours.header.serialize() == ref.header.serialize()
    assert ours.hash == ref.hash and ours.serialize() == ref.serialize()
    assert plain(H.BlockNode.deserialize(ref.serialize())) == plain(ref)


@pytest.mark.parametrize("n", [0, 1, 0xFC, 0xFD, 0xFE, 0xFFFF, 0x10000, 0xFFFFFFFF,
                               0x100000000, 2**64 - 1])
def test_varint_and_reader_at_the_boundaries(n):
    data = U.write_varint(n)
    assert data == RU.write_varint(n)
    assert U.Reader(data + b"\x07").varint() == RU.Reader(data).varint() == n
    blob = bytes(range(256)) * (1 + n % 3)
    if n <= 0x10000:
        assert U.write_varstr(blob[: n % 300]) == RU.write_varstr(blob[: n % 300])
    with pytest.raises(ValueError):
        U.Reader(data[:-1]).varint()
    with pytest.raises(ValueError):
        RU.Reader(data[:-1]).varint()


def test_reader_reads_exactly_and_raises_on_truncation():
    data = bytes(range(40))
    for mod in (U, RU):
        r = mod.Reader(data)
        got = (r.u8(), r.u16be(), r.u32(), r.u64(), r.read(3), r.peek(2), r.remaining())
        if mod is U:
            ours = got
        else:
            assert got == ours
        r.read(r.remaining())
        with pytest.raises(ValueError):
            r.u8()
    blob = b"\x00" + b"\xfd\x00\x01" + b"\x03abc"
    assert U.read_varint(blob, 1) == RU.read_varint(blob, 1) == (256, 4)
    assert U.read_varstr(blob, 4) == RU.read_varstr(blob, 4) == (b"abc", 8)


@pytest.mark.parametrize("bits", [0x1D00FFFF, 0x207FFFFF, 0x1B0404CB, 0x03123456, 0x04923456,
                                  0x01003456, 0x02008000, 0x18009645, 0x170331DB])
def test_bits_and_target_both_ways(bits):
    target = U.bits_to_target(bits)
    assert target == RU.bits_to_target(bits)
    assert U.target_to_bits(target) == RU.target_to_bits(target)
    assert U.header_work(bits) == RU.header_work(bits)
    rng = random.Random(bits)
    for _ in range(20):
        t = rng.getrandbits(rng.randrange(1, 256))
        assert U.target_to_bits(t) == RU.target_to_bits(t)
    h = rng.randbytes(32)
    assert U.hash_to_hex(h) == RU.hash_to_hex(h)
    assert U.hex_to_hash(U.hash_to_hex(h)) == h
    assert U.double_sha256(h) == RU.double_sha256(h) and U.sha256(h) == RU.sha256(h)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 13])
def test_merkle_root(n):
    rng = random.Random(n)
    ids = [rng.randbytes(32) for _ in range(n)]
    assert W.build_merkle_root(ids) == RW.build_merkle_root(ids)


def _messages(w, p):
    """One message of each type the codec names, with the same values in
    either package."""
    rng = random.Random(7)
    na = w.NetworkAddress.from_host_port("10.1.2.3", 8333, services=p.NODE_NETWORK)
    na6 = w.NetworkAddress.from_host_port("2001:db8::7", 18444)
    inv = tuple(w.InvVector(t, rng.randbytes(32))
                for t in (w.InvType.TX, w.InvType.BLOCK, w.InvType.WITNESS_TX))
    header = w.BlockHeader(0x20000000, rng.randbytes(32), rng.randbytes(32), 1_600_000_000,
                           0x207FFFFF, 42)
    tx = w.Tx(2, (w.TxIn(w.OutPoint(rng.randbytes(32), 3), b"\x51", 0xFFFFFFFE),),
              (w.TxOut(12_345, b"\x00\x14" + rng.randbytes(20)),), 99,
              witnesses=((b"\x30" * 71, b"\x02" * 33),))
    locator = tuple(rng.randbytes(32) for _ in range(3))
    return [
        w.MsgVersion(p.PROTOCOL_VERSION, p.NODE_NETWORK, 1_700_000_000, na, na6, 0xDEADBEEF,
                     b"/x:1/", 800_000, False),
        w.MsgVersion(60000, 0, 1, na, na, 1, b"", 0),
        w.MsgVerAck(),
        w.MsgPing(2**63 + 5),
        w.MsgPong(17),
        w.MsgAddr(((1_700_000_000, na), (1_700_000_001, na6))),
        w.MsgInv(inv),
        w.MsgGetData(inv[:2]),
        w.MsgNotFound(inv[2:]),
        w.MsgGetBlocks(p.PROTOCOL_VERSION, locator, b"\x00" * 32),
        w.MsgGetHeaders(p.PROTOCOL_VERSION, locator, rng.randbytes(32)),
        w.MsgHeaders(((header, 0), (header, 0))),
        w.MsgBlock(w.Block(header, (tx, tx))),
        w.MsgTx(tx),
        w.MsgGetAddr(),
        w.MsgMempool(),
        w.MsgSendHeaders(),
        w.MsgFeeFilter(1000),
        w.MsgReject(b"tx", 0x10, b"bad-txns", rng.randbytes(32)),
        w.MsgOther("sendcmpct", b"\x00" + (1).to_bytes(8, "little")),
    ]


@pytest.mark.parametrize("i", range(len(_messages(RW, RP))),
                         ids=[f"{type(m).__name__}{i}" for i, m in enumerate(_messages(RW, RP))])
def test_every_message_type_round_trips_through_both_packages(i):
    ours, ref = _messages(W, P)[i], _messages(RW, RP)[i]
    data = RW.encode_message(RP.BTC, ref)
    assert W.encode_message(P.BTC, ours) == data
    hdr = W.decode_message_header(P.BTC, data[: W.HEADER_SIZE])
    assert plain(hdr) == plain(RW.decode_message_header(RP.BTC, data[: RW.HEADER_SIZE]))
    got = W.decode_message(P.BTC, hdr, data[W.HEADER_SIZE:])
    want = RW.decode_message(RP.BTC, RW.decode_message_header(RP.BTC, data[:24]), data[24:])
    assert plain(got) == plain(want)
    assert W.encode_message(P.BTC, got) == data


def test_decode_errors_match():
    data = RW.encode_message(RP.BTC, RW.MsgPing(1))
    with pytest.raises(W.DecodeError):
        W.decode_message_header(P.BCH, data[:24])
    hdr = W.decode_message_header(P.BTC, data[:24])
    for payload in (data[24:-1], data[24:-1] + b"\x01"):
        with pytest.raises(W.DecodeError):
            W.decode_message(P.BTC, hdr, payload)
    with pytest.raises(W.DecodeError):
        W.MessageHeader.deserialize(data[:10])
    bad = RW.MessageHeader(RP.BTC.magic, "ping", 3, RU.double_sha256(b"abc")[:4])
    with pytest.raises(W.DecodeError):
        W.decode_message(P.BTC, W.MessageHeader.deserialize(bad.serialize()), b"abc")
    with pytest.raises(RW.DecodeError):
        RW.decode_message(RP.BTC, RW.MessageHeader.deserialize(bad.serialize()), b"abc")


@pytest.mark.parametrize("kind", MIX_KINDS + ["p2pkh-schnorr"])
def test_transactions_of_every_mix_kind(kind):
    mix = [(1.01, "p2pkh" if kind == "p2pkh-schnorr" else kind)]
    ref = RG.gen_mixed_txs(3, seed=11, mix=mix, schnorr_every=1 if kind == "p2pkh-schnorr" else 0)
    for tx in ref:
        raw = tx.serialize()
        r = U.Reader(raw + b"tail")
        ours = W.Tx.deserialize(r)
        assert r.remaining() == 4
        assert ours.raw == raw
        assert plain(ours) == plain(RW.Tx.deserialize(RU.Reader(raw)))
        assert (ours.txid, ours.wtxid, ours.has_witness) == (tx.txid, tx.wtxid, tx.has_witness)
        assert ours.serialize() == raw
        assert ours.serialize(include_witness=False) == tx.serialize(include_witness=False)
        lazy = W.LazyTx(raw)
        assert lazy == ours and lazy.txid == tx.txid and hash(lazy) == hash(ours)


@pytest.mark.parametrize("net", ["BTC_REGTEST", "BCH_REGTEST"])
def test_blocks_of_gen_chain_decode_and_connect_in_both_packages(net):
    ours_net, ref_net = getattr(P, net), getattr(RP, net)
    ref = RG.gen_chain(ref_net, 2, 5, mix=True)
    ours = G.gen_chain(ours_net, 2, 5, mix=True)
    assert [b.serialize() for b in ours] == [b.serialize() for b in ref]
    data = b"".join(b.serialize() for b in ref)
    r = U.Reader(data)
    got = [W.Block.deserialize(r) for _ in ref]
    assert r.remaining() == 0
    rr = RU.Reader(data)
    assert plain(got) == plain([RW.Block.deserialize(rr) for _ in ref])
    for block in got:
        assert W.build_merkle_root([t.txid for t in block.txs]) == block.header.merkle
        payload = block.serialize()
        hdr = W.decode_message_header(ours_net, W.encode_message(
            ours_net, W.MsgBlock(block))[:24])
        lazy = W.decode_message(ours_net, hdr, payload).block
        assert lazy == block and lazy.serialize() == payload and lazy.raw_txs == block.raw_txs
    now = ref[-1].header.timestamp + 3600
    store, rstore = H.MemoryHeaderStore(ours_net), RH.MemoryHeaderStore(ref_net)
    nodes, best = H.connect_blocks(store, ours_net, now, [b.header for b in got])
    rnodes, rbest = RH.connect_blocks(rstore, ref_net, now, [b.header for b in ref])
    assert plain(nodes) == plain(rnodes) and plain(best) == plain(rbest)
    assert best.height == 2
    store.add_headers(nodes)
    store.set_best(best)
    rstore.add_headers(rnodes)
    rstore.set_best(rbest)
    assert H.block_locator(store, best) == RH.block_locator(rstore, rbest)
    assert H.median_time_past(store, best) == RH.median_time_past(rstore, rbest)
    orphan = dataclasses.replace(got[1].header, prev=b"\x01" * 32)
    with pytest.raises(H.BadHeaders, match="does not connect"):
        H.connect_blocks(H.MemoryHeaderStore(ours_net), ours_net, now, [orphan])
    late = dataclasses.replace(got[0].header, timestamp=ours_net.genesis.timestamp)
    with pytest.raises(H.BadHeaders, match="MTP"):
        H.connect_blocks(H.MemoryHeaderStore(ours_net), ours_net, now, [late])
