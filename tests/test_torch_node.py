"""The port's ``Node`` against the reference's, over ``tests/fakenet.py``.

Each comparison runs one scenario through a reference node and a port node
over the same fake remote and compares what the nodes publish (the
``ChainSynced`` heights and hashes, every ``TxVerdict``'s txid, verdicts and
extraction counts, the ``VerifyShed`` counts) and the stores they leave,
row for row and, for ``LogKV``, file for file.  A store that either node
wrote opens in the other, which resumes from the UTXO watermark and fetches
nothing below it.  The reference's own node tests (``tests/test_node.py``)
also run against the port.  The engines are on the CPU (``backend="cpu"``
or ``"oracle"``); a port node that asks for the card with no card, or
whose native extractor is missing, raises.
"""

import asyncio
import contextlib
import os

import pytest

import tests.test_node as ref_node
import tpunode as R
import tpunode.node as R_node
import tpunode.verify.engine as R_engine
import tpunode_torch as P
import tpunode_torch.native as P_native
import tpunode_torch.node as P_node
import tpunode_torch.txextract as P_txextract
import tpunode_torch.verify.engine as P_engine
from benchmarks.txgen import gen_chain, gen_mixed_txs, synth_prevout
from tests.fakenet import dummy_peer_connect, poll_until
from tests.fixtures import all_blocks
from tests.test_torch_store import port_reference_tests

_PORTED = port_reference_tests(ref_node)
globals().update(_PORTED)


@pytest.fixture(autouse=True)
def _native_extract_gate(monkeypatch):
    """Four reference tests skip unless ``node._native_extract_available()``
    holds.  The port's node has no such gate: it requires the native
    extractor and raises at start without it.  The same question is
    answered here by the extractor itself."""
    monkeypatch.setattr(P_node, "_native_extract_available",
                        P_txextract.have_native_extract, raising=False)


NET = R.BCH_REGTEST
PKGS = {"ref": (R, R_node, R_engine), "port": (P, P_node, P_engine)}


def _row(ev):
    """A published event, without its peer object."""
    name = type(ev).__name__
    if name == "TxVerdict":
        s = ev.stats
        return (name, ev.txid, ev.valid, tuple(ev.verdicts), ev.error,
                (s.total_inputs, s.extracted, s.coinbase, s.unsupported))
    if name in ("ChainSynced", "ChainBestBlock"):
        return (name, ev.node.height, ev.node.hash)
    if name == "VerifyShed":
        return (name, ev.dropped_txs)
    return (name,)


@contextlib.asynccontextmanager
async def _node(pkg, store, blocks, *, backend="cpu", **kw):
    T, N, E = PKGS[pkg]
    pub = T.Publisher(name=f"{pkg}-node", maxsize=None)
    cfg = T.NodeConfig(
        net=T.BCH_REGTEST, store=T.Namespaced(store, b"node:"), pub=pub,
        peers=["[::1]:17486"], discover=False, stats_interval=0,
        connect=lambda sa: dummy_peer_connect(NET, blocks),
        verify=E.VerifyConfig(backend=backend, max_wait=0.0) if backend else None,
        **kw,
    )
    async with pub.subscription() as events:
        async with T.Node(cfg) as node:
            yield node, events


async def _collect(events, rows, done, timeout=30.0):
    async with asyncio.timeout(timeout):
        while not done(rows):
            rows.append(_row(await events.receive()))


def _verdicts(rows) -> dict:
    return {r[1]: r for r in rows if r[0] == "TxVerdict"}


def _msg(pkg, kind, obj):
    """A wire message of ``pkg`` rebuilt from ``obj``'s wire bytes."""
    W = __import__(PKGS[pkg][0].__name__ + ".wire", fromlist=["MsgTx"])
    U = __import__(PKGS[pkg][0].__name__ + ".util", fromlist=["Reader"])
    cls = W.MsgBlock if kind == "block" else W.MsgTx
    return cls.deserialize_payload(U.Reader(obj.serialize()))


async def _scenario(pkg, name, tmp_path):
    T = PKGS[pkg][0]
    chain = gen_chain(NET, 4, 12, seed=0x40DE, mix=True)
    if name == "sync":
        store = T.MemoryKV()
        rows = []
        async with _node(pkg, store, all_blocks(), backend=None) as (node, ev):
            await _collect(ev, rows, lambda r: any(x[0] == "ChainSynced" for x in r))
        return [r for r in rows if r[0] == "ChainSynced"], sorted(store.scan_prefix(b""))
    if name == "pushed_blocks":
        store = T.MemoryKV()
        rows = []
        n = sum(len(b.txs) for b in chain)
        async with _node(pkg, store, chain, utxo=True,
                         prevout_lookup=synth_prevout) as (node, ev):
            await _collect(ev, rows, lambda r: any(x[0] == "ChainSynced" for x in r))
            peer = node.peer_mgr.get_peers()[0].peer
            for b in chain:
                node._peer_pub.publish(T.PeerMessage(peer, _msg(pkg, "block", b)))
            await _collect(ev, rows, lambda r: len(_verdicts(r)) == n)
            await poll_until(lambda: node.utxo.height == len(chain), what="utxo")
        return sorted(_verdicts(rows).values()), sorted(store.scan_prefix(b""))
    if name == "ibd_logkv":
        path = str(tmp_path / pkg / "node.log")
        os.makedirs(os.path.dirname(path))
        store = T.LogKV(path)
        rows = []
        n = sum(len(b.txs) for b in chain)
        async with _node(pkg, store, chain, utxo=True, prevout_lookup=synth_prevout,
                         ibd=T.IbdConfig(batch_blocks=2, tick_interval=0.02)) as (node, ev):
            await _collect(ev, rows, lambda r: len(_verdicts(r)) == n)
            await poll_until(lambda: node.utxo.height == len(chain), what="utxo")
        contents = sorted(store.scan_prefix(b""))
        store.close()
        synced = [r for r in rows if r[0] == "ChainSynced"]
        return synced, sorted(_verdicts(rows).values()), contents
    if name in ("pushed_txs", "pushed_txs_oracle"):
        txs = gen_mixed_txs(24, seed=0x7A5, invalid_every=5)
        rows = []
        backend = "oracle" if name.endswith("oracle") else "cpu"
        async with _node(pkg, T.MemoryKV(), all_blocks(), backend=backend,
                         prevout_lookup=synth_prevout) as (node, ev):
            await _collect(ev, rows, lambda r: any(x[0] == "ChainSynced" for x in r))
            peer = node.peer_mgr.get_peers()[0].peer
            for tx in txs:
                node._peer_pub.publish(T.PeerMessage(peer, _msg(pkg, "tx", tx)))
            await _collect(ev, rows, lambda r: len(_verdicts(r)) == len(txs))
        return sorted(_verdicts(rows).values())
    raise AssertionError(name)


@pytest.mark.parametrize("name", ["sync", "pushed_blocks", "ibd_logkv", "pushed_txs",
                                  "pushed_txs_oracle"])
async def test_both_nodes_publish_the_same_and_store_the_same(name, tmp_path):
    ref = await _scenario("ref", name, tmp_path)
    port = await _scenario("port", name, tmp_path)
    assert ref == port
    if name == "sync":
        assert [r[1] for r in port[0]] == [15]
    if name.startswith("pushed_txs"):
        valid = [r[2] for r in port]
        assert any(valid) and not all(valid)
    if name == "ibd_logkv":
        assert [r[1] for r in port[0]] == [4]


async def test_logkv_files_of_a_header_sync_are_the_same(tmp_path):
    files = {}
    for pkg in ("ref", "port"):
        T = PKGS[pkg][0]
        d = tmp_path / pkg
        d.mkdir()
        store = T.LogKV(str(d / "node.log"))
        rows = []
        async with _node(pkg, store, all_blocks(), backend=None) as (node, ev):
            await _collect(ev, rows, lambda r: any(x[0] == "ChainSynced" for x in r))
        store.close()
        files[pkg] = {p.name: p.read_bytes() for p in d.iterdir()}
    assert files["ref"] == files["port"]


async def test_verify_shed_counts_are_the_same(monkeypatch):
    txs = gen_mixed_txs(10, seed=0x5ED)
    out = {}
    for pkg in ("ref", "port"):
        T, N, _ = PKGS[pkg]
        monkeypatch.setattr(N.Node, "MAX_TX_ACCUM", 4)
        rows = []
        async with _node(pkg, T.MemoryKV(), all_blocks()) as (node, ev):
            await _collect(ev, rows, lambda r: any(x[0] == "ChainSynced" for x in r))
            peer = node.peer_mgr.get_peers()[0].peer
            for tx in txs:
                node._peer_pub.publish(T.PeerMessage(peer, _msg(pkg, "tx", tx)))
            await _collect(ev, rows, lambda r: len(_verdicts(r)) + sum(
                x[1] for x in r if x[0] == "VerifyShed") == len(txs))
        out[pkg] = (sum(x[1] for x in rows if x[0] == "VerifyShed"),
                    sorted(_verdicts(rows)))
    assert out["ref"] == out["port"]
    assert out["port"][0] > 0


@pytest.mark.parametrize("first", ["ref", "port"])
async def test_a_store_restarts_in_the_other_package(first, tmp_path):
    """One package's node syncs five blocks into a ``LogKV``; the other's
    restarts on the directory with eight blocks served, resumes from the
    watermark, fetches only the three new blocks and verifies only their
    transactions."""
    second = "port" if first == "ref" else "ref"
    chain = gen_chain(NET, 8, 4, seed=0x4E57, mix=True)
    path = str(tmp_path / "node.log")
    ibd = dict(utxo=True, prevout_lookup=synth_prevout)
    for pkg, blocks in ((first, chain[:5]), (second, chain)):
        T = PKGS[pkg][0]
        store = T.LogKV(path)
        rows = []
        n = sum(len(b.txs) for b in (blocks[5:] if pkg == second else blocks))
        async with _node(pkg, store, blocks, ibd=T.IbdConfig(batch_blocks=2, tick_interval=0.02),
                         **ibd) as (node, ev):
            if pkg == second:
                assert node.utxo.height == 5  # the watermark, read at construction
            await _collect(ev, rows, lambda r: len(_verdicts(r)) == n)
            await poll_until(lambda: node.utxo.height == len(blocks), what="utxo")
            fetched = node.ibd.stats()["fetched_blocks"]
        store.close()
        if pkg == second:
            assert fetched == 3
            want = {tx.txid for b in chain[5:] for tx in b.txs}
            assert set(_verdicts(rows)) == want
    # and the store reads the same in both packages
    seen = []
    for T in (R, P):
        s = T.LogKV(path)
        seen.append(sorted(s.scan_prefix(b"")))
        s.close()
    assert seen[0] == seen[1]


async def test_a_node_without_the_native_extractor_raises_at_start(monkeypatch, tmp_path):
    monkeypatch.setattr(P_txextract, "_lib", None)
    monkeypatch.setattr(P_txextract, "_load_failed", False)
    monkeypatch.setattr(P_txextract, "_LIB_PATH", str(tmp_path / "missing" / "libtxextract.so"))
    monkeypatch.setattr(P_native, "ensure_native_lib", lambda path, src: path)
    with pytest.raises(RuntimeError, match="native tx extractor"):
        async with _node("port", P.MemoryKV(), all_blocks()):
            pass


@pytest.mark.parametrize("backend", ["auto", "tpu"])
def test_a_node_that_asks_for_the_card_raises_with_no_card(backend):
    import torch

    if torch.cuda.is_available():
        pytest.skip("needs a host with no card")
    cfg = P.NodeConfig(net=P.BCH_REGTEST, store=P.MemoryKV(), pub=P.Publisher(),
                       verify=P_engine.VerifyConfig(backend=backend))
    with pytest.raises(RuntimeError):
        P.Node(cfg)
    if backend == "auto":
        assert P_engine.VerifyConfig().backend == "auto"  # the default asks for the card
