"""The port's IBD planner, mempool and watchdog against the reference's.

The comparisons run one scenario through a reference ``Node`` and a port
``Node`` over the same fake remote (``tests/fakenet.py``): the same
generated chain fetched by the IBD planner, the same transactions relayed
into the mempool (some with a corrupted signature), the same stall fed to
the watchdog.  They compare the per-transaction verdicts, the UTXO sets,
the planner's counters and the stall events.  The reference's own tests of
these modules (``tests/test_ibd.py``, ``tests/test_mempool.py``,
``tests/test_watchdog.py``) also run against the port; the node's engines
are on the CPU (``backend="cpu"`` or ``"oracle"``).
"""

import asyncio
import contextlib

import pytest

import tests.test_ibd as ref_ibd
import tests.test_mempool as ref_mempool
import tests.test_watchdog as ref_watchdog
import tpunode as R
import tpunode.verify.engine as R_engine
import tpunode_torch as P
import tpunode_torch.verify.engine as P_engine
from benchmarks.txgen import gen_chain, gen_signed_txs, synth_prevout
from tests.fakenet import TxRelay, dummy_peer_connect, poll_until
from tests.fixtures import all_blocks
from tests.test_torch_store import port_function, port_imports, port_reference_tests

_PORTED = {}
for _mod in (ref_ibd, ref_mempool, ref_watchdog):
    for _name, _fn in port_reference_tests(_mod).items():
        assert _name not in _PORTED, f"two reference tests named {_name}"
        _PORTED[_name] = _fn
globals().update(_PORTED)

PKGS = {"ref": (R, R_engine), "port": (P, P_engine)}


@contextlib.asynccontextmanager
async def _node(pkg, connect, peers=("[::1]:17486",), **kw):
    T, E = PKGS[pkg]
    pub = T.Publisher(name=f"{pkg}-ingest", maxsize=None)
    cfg = T.NodeConfig(net=T.BCH_REGTEST, store=T.MemoryKV(), pub=pub,
                       peers=list(peers), discover=False, connect=connect,
                       stats_interval=0, **kw)
    async with pub.subscription() as events:
        async with T.Node(cfg) as node:
            yield node, events


def _verdict_row(v) -> tuple:
    return (v.txid, v.valid, tuple(v.verdicts), v.error,
            v.stats.total_inputs, v.stats.extracted, v.stats.coinbase,
            v.stats.unsupported)


async def _ibd_run(pkg, blocks, backend):
    T, E = PKGS[pkg]
    verdicts, repeats = {}, []
    n_txs = sum(len(b.txs) for b in blocks)
    async with _node(
        pkg, lambda sa: dummy_peer_connect(R.BCH_REGTEST, blocks),
        verify=E.VerifyConfig(backend=backend, max_wait=0.005),
        prevout_lookup=synth_prevout, utxo=True,
        ibd=T.IbdConfig(batch_blocks=4, tick_interval=0.02),
    ) as (node, events):
        async def watch():
            while True:
                ev = await events.receive()
                if isinstance(ev, T.TxVerdict):
                    if ev.txid in verdicts:
                        repeats.append(ev.txid)
                    verdicts[ev.txid] = _verdict_row(ev)

        # a test observer, cancelled below
        task = asyncio.ensure_future(watch())  # asyncsan: disable=raw-spawn
        try:
            await poll_until(
                lambda: node.utxo.height == len(blocks) and len(verdicts) == n_txs,
                timeout=30, what="ibd sync and verdicts",
            )
        finally:
            task.cancel()
        assert repeats == [], "one verdict a transaction"
        st = node.ibd.stats()
        return (verdicts, node.utxo.snapshot(), node.utxo.height,
                (st["fetched_blocks"], st["watermark"], st["target"]))


@pytest.mark.parametrize("backend", ["cpu", "oracle"])
async def test_ibd_sync_of_a_generated_chain_is_alike(backend):
    blocks = gen_chain(R.BCH_REGTEST, 6, 10, seed=0x1BD7, mix=True)
    ref = await _ibd_run("ref", blocks, backend)
    port = await _ibd_run("port", blocks, backend)
    assert ref == port
    assert port[2] == 6 and port[3] == (6, 6, 6)
    rows = port[0].values()
    assert all(r[1] for r in rows) and all(r[3] is None for r in rows)


async def _relay_run(pkg, relays):
    T, E = PKGS[pkg]
    M = __import__(T.__name__ + ".mempool", fromlist=["MempoolConfig"])

    def connect(sa):
        return dummy_peer_connect(R.BCH_REGTEST, all_blocks(), relay=relays.get(sa[1]))

    want = {t.txid for r in relays.values() for t in r.txs + r.push}
    seen = {}
    async with _node(
        pkg, connect, peers=[f"[::1]:{port}" for port in relays],
        verify=E.VerifyConfig(backend="cpu", max_wait=0.0),
        mempool=M.MempoolConfig(tick_interval=0.05),
        prevout_lookup=synth_prevout,
    ) as (node, events):
        async with asyncio.timeout(30):
            while want - set(seen):
                ev = await events.receive()
                if isinstance(ev, T.TxVerdict):
                    seen[ev.txid] = _verdict_row(ev)
        st = node.mempool.stats()
    return seen, st["size"], st["dedup_hits"]


async def test_relayed_transactions_get_the_same_verdicts():
    """Some announced and served, some pushed, two of them both: every
    unique transaction verified once, invalid signatures among them."""
    txs = gen_signed_txs(12, inputs_per_tx=2, seed=0x7E1A, invalid_every=4,
                         segwit_every=3)
    relays = {17701: TxRelay(txs[:8], announce=True, mode="serve", push=txs[6:])}
    ref = await _relay_run("ref", relays)
    port = await _relay_run("port", relays)
    assert ref == port
    valid = [r[1] for r in port[0].values()]
    assert len(valid) == 12 and any(valid) and not all(valid)


@pytest.mark.parametrize("case", ["loop_lag", "mailbox", "dispatch"])
async def test_watchdog_reports_the_same_stall(case):
    out = []
    for T in (R, P):
        wdm = __import__(T.__name__ + ".watchdog", fromlist=["Watchdog"])
        log = T.EventLog()
        mb = T.Mailbox(name="chain")

        class Engine:
            def dispatch_inflight_seconds(self):
                return 3.0

        wd = wdm.Watchdog(
            wdm.WatchdogConfig(lag_threshold=0.5, mailbox_age_threshold=0.01,
                               dispatch_stall_threshold=1.0),
            mailboxes=[mb], engine=Engine() if case == "dispatch" else None, log_=log)
        if case == "mailbox":
            mb.send("stuck")
            await asyncio.sleep(0.05)
        got = wd.check(lag=1.25 if case == "loop_lag" else 0.0)
        again = wd.check(lag=1.5 if case == "loop_lag" else 0.0)
        out.append(([(e["type"], e["kind"]) for e in got], again, log.counts(),
                    sorted(wd.snapshot())))
    assert out[0] == out[1]
    assert out[1][0] and out[1][1] == []


async def test_the_reference_harness_rebinds_to_the_port():
    """``ibd_node`` of the reference's IBD tests, rebound, builds a port
    node: the harness the ported tests above run through."""
    harness = port_function(ref_ibd.ibd_node)
    with port_imports():
        async with harness(P.MemoryKV(), all_blocks()) as (node, _):
            assert type(node) is P.Node
            assert type(node.cfg.ibd) is P.IbdConfig
            await poll_until(lambda: node.utxo.height == 15, what="ibd watermark")
