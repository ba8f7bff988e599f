"""The port's workload generator (``txgen``) and ``seenlru`` against the
reference's: the same seeds give byte-identical transactions and blocks,
the prevout oracle gives the same amounts and scripts, and the LRU the same
answers and evictions under the same operations."""

from __future__ import annotations

import os
import random

import pytest

from benchmarks import txgen as RG
from tpunode import params as RP
from tpunode import seenlru as RL
from tpunode_torch import params as P
from tpunode_torch import seenlru as L
from tpunode_torch import txgen as G
from tpunode_torch.headers import MemoryHeaderStore, connect_blocks


def _bytes(txs) -> list:
    return [tx.serialize() for tx in txs]


@pytest.mark.parametrize("kwargs", [
    {}, {"inputs_per_tx": 1, "seed": 5}, {"invalid_every": 3},
    {"segwit_every": 2, "invalid_every": 4}, {"inputs_per_tx": 3, "segwit_every": 3}],
    ids=["default", "one-input", "invalid", "segwit", "three-inputs"])
def test_gen_signed_txs_byte_identical(kwargs):
    assert _bytes(G.gen_signed_txs(8, **kwargs)) == _bytes(RG.gen_signed_txs(8, **kwargs))


@pytest.mark.parametrize("kwargs", [
    {}, {"invalid_every": 4}, {"mix": "taproot_heavy", "seed": 9},
    {"schnorr_every": 4, "taproot": False}, {"inputs_per_tx": 1, "schnorr_every": 2,
                                             "taproot": False, "invalid_every": 3}],
    ids=["mix", "invalid", "taproot-heavy", "bch", "bch-one-input"])
def test_gen_mixed_txs_byte_identical(kwargs):
    ours, ref = dict(kwargs), dict(kwargs)
    if kwargs.get("mix") == "taproot_heavy":
        ours["mix"], ref["mix"] = G._MIX_TAPROOT_HEAVY, RG._MIX_TAPROOT_HEAVY
    assert G._MIX == RG._MIX and G._MIX_TAPROOT_HEAVY == RG._MIX_TAPROOT_HEAVY
    assert _bytes(G.gen_mixed_txs(16, **ours)) == _bytes(RG.gen_mixed_txs(16, **ref))


@pytest.mark.parametrize("net,kwargs", [
    ("BTC_REGTEST", {}), ("BTC_REGTEST", {"mix": True}), ("BCH_REGTEST", {"mix": True}),
    ("BTC_REGTEST", {"segwit_every": 3}), ("BCH_REGTEST", {"inputs_per_tx": 1})],
    ids=["btc", "btc-mix", "bch-mix", "btc-segwit", "bch-one-input"])
def test_gen_chain_byte_identical_and_connects(net, kwargs):
    ours = G.gen_chain(getattr(P, net), 2, 4, **kwargs)
    ref = RG.gen_chain(getattr(RP, net), 2, 4, **kwargs)
    assert [b.serialize() for b in ours] == [b.serialize() for b in ref]
    last = ours[-1].header.timestamp + 600
    nodes, best = connect_blocks(MemoryHeaderStore(getattr(P, net)), getattr(P, net), last,
                                 [b.header for b in ours])
    assert best.height == 2 and [n.hash for n in nodes] == [b.header.hash for b in ours]


def test_gen_chain_refuses_what_the_reference_refuses():
    for mod, net in ((G, P.BTC_REGTEST), (RG, RP.BTC_REGTEST)):
        with pytest.raises(ValueError):
            mod.gen_chain(net, 1, 4, mix=True, segwit_every=2)
        with pytest.raises(ValueError, match="would start a block"):
            mod.gen_chain(net, 2, 3, segwit_every=4)


def test_gen_chain_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setattr(G, "_CACHE_DIR", str(tmp_path))
    first = G.gen_chain(P.BTC_REGTEST, 2, 3, cache="chain.bin", mix=True)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("chain-fabfb5da-2x3-i2-s1bd-mix4")
    again = G.gen_chain(P.BTC_REGTEST, 2, 3, cache="chain.bin", mix=True)
    assert [b.serialize() for b in again] == [b.serialize() for b in first]
    (tmp_path / files[0]).write_bytes(b"\x00" * 10)  # a corrupt cache is made anew
    assert [b.serialize() for b in G.gen_chain(P.BTC_REGTEST, 2, 3, cache="chain.bin",
                                               mix=True)] == [b.serialize() for b in first]


def test_cache_dir_is_the_port_own_and_ignored_by_git():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert G._CACHE_DIR == os.path.join(repo, "tpunode_torch", "txgen_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert "tpunode_torch/txgen_cache/" in f.read().split()


def test_synth_prevout_and_synth_amount_equal():
    rng = random.Random(0x5E)
    kinds = set()
    for _ in range(400):
        txid, vout = rng.randbytes(32), rng.randrange(8)
        assert G.synth_amount(txid, vout) == RG.synth_amount(txid, vout)
        got = G.synth_prevout(txid, vout)
        assert got == RG.synth_prevout(txid, vout)
        kinds.add((G._synth_is_p2tr(txid, vout), G._synth_is_p2pk(txid, vout)))
        assert G._synth_tap_priv(txid, vout) == RG._synth_tap_priv(txid, vout)
    assert kinds == {(True, False), (False, True), (False, False)}


def _lru_ops(mod, seed: int, pinned: bool) -> list:
    """A seeded sequence of operations on a bounded LRU; returns every
    answer and the state after each step."""
    rng = random.Random(seed)
    lru = mod.SeenLru(8, pinned=(lambda e: e % 5 == 0) if pinned else None)
    out = []
    for step in range(600):
        key = rng.randrange(24).to_bytes(2, "big")
        op = rng.randrange(7)
        if op <= 2:
            out.append(("insert", lru.insert(key, rng.randrange(100))))
        elif op == 3:
            out.append(("alias", lru.alias(b"a" + key, rng.randrange(24).to_bytes(2, "big"))))
        elif op == 4:
            out.append(("lookup", lru.lookup(b"a" + key), lru.lookup(key), lru.resolve(b"a" + key),
                        lru.get(key), key in lru))
        elif op == 5 and key in lru:
            lru.touch(key)
        else:
            out.append(("pop", lru.pop(key), lru.drop_alias(b"a" + key)))
        out.append((step, len(lru), list(lru), list(lru.items()), list(lru.values())))
    return out


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seenlru_answers_as_the_reference(seed, pinned):
    assert _lru_ops(L, seed, pinned) == _lru_ops(RL, seed, pinned)


def test_seenlru_all_pinned_stops_at_twice_its_bound():
    for mod in (L, RL):
        lru = mod.SeenLru(4, pinned=lambda e: True)
        evicted = [lru.insert(bytes([i]), i) for i in range(12)]
        assert len(lru) == 8 and sum(map(len, evicted)) == 4
