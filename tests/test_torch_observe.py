"""The port's asyncsan, timeseries, slo and blackbox against the reference's.

The comparisons feed both packages the same registry activity, the same
observations and the same trigger events at the same explicit timestamps,
and compare the series, the burn rates and budgets, and the bundles.  The
reference's own tests (``tests/test_asyncsan.py``, ``tests/test_timeseries.py``,
``tests/test_slo.py``, ``tests/test_blackbox.py``) also run against the
port, less the tests of what the port leaves out:

* the environment switches ``TPUNODE_ASYNCSAN``, ``TPUNODE_ASYNCSAN_SLOW``,
  ``TPUNODE_NO_TSDB`` and ``TPUNODE_NO_SLO``, which nothing in the port
  sets (the threshold is ``asyncsan.SLOW_CALLBACK_DURATION``; the
  arguments stay: ``Timeline(disabled=)``, ``SloEvaluator(disabled=)``,
  ``NodeConfig.timeline_interval=0``, ``NodeConfig.slos=None``);
The engine's fields that are module constants of the port's engine
(``pipeline_depth``, ``breaker_cooldown``) reach those constants
(``port_reference_tests(..., engine_fields=True)``), so the reference's
fleet and ledger tests run on the port as written.

Port versions of the tests left out follow the ported ones, and port
variants of two ported tests beside them: the ledger at the port's
default pipeline depth, and the breaker opened by device failures.
"""

import asyncio
import contextlib
import time

import pytest

import tests.test_asyncsan as ref_asyncsan
import tests.test_blackbox as ref_blackbox
import tests.test_slo as ref_slo
import tests.test_timeseries as ref_timeseries
import tpunode as R
import tpunode.blackbox as R_bb
import tpunode.slo as R_slo
import tpunode.timeseries as R_ts
import tpunode_torch as P
import tpunode_torch.asyncsan as P_asyncsan
import tpunode_torch.blackbox as P_bb
import tpunode_torch.slo as P_slo
import tpunode_torch.timeseries as P_ts
from tests.fakenet import dummy_peer_connect, poll_until
from tests.fixtures import all_blocks
from tests.test_torch_store import port_reference_tests
from tpunode_torch.chaos import chaos as _port_chaos

_EXCLUDE = {
    ref_asyncsan: {
        "test_enabled_env_gate",  # TPUNODE_ASYNCSAN
        "test_install_wires_debug_mode",  # reads slow_callback_duration()
        "test_slow_callback_threshold_env_read_at_install",  # TPUNODE_ASYNCSAN_SLOW
        "test_node_sanitizers_catch_injected_block_and_leak",  # TPUNODE_ASYNCSAN
    },
    ref_timeseries: {"test_env_off_switch"},  # TPUNODE_NO_TSDB
    ref_slo: {"test_off_switch_env_and_none"},  # TPUNODE_NO_SLO
    ref_blackbox: set(),
}
_PORTED = {}
for _mod, _skip in _EXCLUDE.items():
    for _name, _fn in port_reference_tests(_mod, exclude=_skip, engine_fields=True).items():
        assert _name not in _PORTED, f"two reference tests named {_name}"
        _PORTED[_name] = _fn
globals().update(_PORTED)


@pytest.fixture(autouse=True)
def _chaos_clean():
    """The reference's slo fixture over the port's chaos registry."""
    _port_chaos.uninstall()
    yield
    _port_chaos.uninstall()


# ---------------------------------------------------------------------------
# port versions of the reference tests left out above


async def test_install_wires_debug_mode():
    loop = asyncio.get_running_loop()
    try:
        P_asyncsan.install()
        assert loop.get_debug() is True
        assert loop.slow_callback_duration == P_asyncsan.SLOW_CALLBACK_DURATION == 0.1
    finally:
        loop.set_debug(False)


def test_off_switches_are_arguments():
    reg = P.Metrics(disabled=False)
    assert P_ts.Timeline(registry=reg).disabled is False
    assert P_ts.Timeline(registry=reg, disabled=True).disabled is True
    ev = P_slo.SloEvaluator(defs=None, registry=reg, log_=P.EventLog())
    assert ev.disabled and ev.tick() == 0
    assert ev.snapshot()["enabled"] is False
    ev2 = P_slo.SloEvaluator(registry=reg, log_=P.EventLog(), disabled=True)
    assert ev2.tick() == 0
    assert not P_slo.SloEvaluator(registry=reg, log_=P.EventLog()).disabled


async def test_per_class_latency_and_ledger_conservation_at_the_default_depth():
    """The reference's test at the port engine's default pipeline depth
    (its ``PIPELINE_DEPTH`` constant, 2, the reference test's field value),
    with no field set."""
    from tests.test_engine import make_items
    from tpunode_torch.metrics import metrics
    from tpunode_torch.verify import engine as E

    assert E.PIPELINE_DEPTH == 2
    metrics.reset()
    async with E.VerifyEngine(
        E.VerifyConfig(backend="oracle", max_wait=0.0, batch_size=32)
    ) as eng:
        bulk_items, bulk_exp = make_items(128, tamper_every=8)
        mp_items, mp_exp = make_items(32, tamper_every=4)
        blk_items, blk_exp = make_items(16, tamper_every=2)
        got_bulk, got_mp, got_blk = await asyncio.gather(
            eng.verify(bulk_items, priority="bulk"),
            eng.verify(mp_items, priority="mempool"),
            eng.verify(blk_items, priority="block"),
        )
        assert (got_bulk, got_mp, got_blk) == (bulk_exp, mp_exp, blk_exp)
        ledger = eng.ledger()
    meds = {}
    for p in ("block", "mempool", "bulk"):
        h = metrics.histogram("node.verdict_latency", labels={"priority": p})
        assert h is not None and h.count > 0, f"no latency for {p}"
        meds[p] = h.quantile(0.5)
    assert meds["block"] <= meds["bulk"]
    by_class = ledger["by_class"]
    assert {c: by_class[c]["items"] for c in ("block", "mempool", "bulk")} == {
        "block": 16, "mempool": 32, "bulk": 128}
    assert 0.999 <= sum(c["share"] for c in by_class.values()) <= 1.001
    assert ledger["charged_seconds"] == pytest.approx(ledger["busy_seconds"], rel=0.05)
    assert ledger["busy_seconds"] > 0.0


def test_breaker_opened_by_a_failure_with_breaker_stats_source_no_deadlock():
    """The reference's regression through the port's breaker, opened by a
    device failure (``record_failure``) as well as by the fleet's
    ``trip``."""
    import threading

    from tpunode_torch.verify.engine import CircuitBreaker

    br = CircuitBreaker(threshold=1, window=30.0, cooldown=5.0)
    rec = P_bb.FlightRecorder(P_bb.FlightRecorderConfig(min_interval=0.0),
                              sources={"breaker": br.stats})
    rec.attach()
    try:
        t = threading.Thread(target=lambda: br.record_failure("device gone"))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive(), "deadlocked building the bundle"
        (bundle,) = rec.records(1)
        assert bundle["reason"] == "verify.breaker"
        assert bundle["breaker"]["state"] == "open"
    finally:
        rec.detach()


async def test_node_stall_is_attributed_and_leak_reported():
    """A port node over the fake network: a blocking call on the loop is a
    ``watchdog.stall`` event whose frames name the blocker (the loop
    attributor from ``asyncsan``, installed by the embedder), and a
    supervised task the node does not own is an ``asyncsan.task_leak``
    event at shutdown."""
    from tpunode_torch.actors import spawn_supervised
    from tpunode_torch.events import events

    events.reset()
    pub = P.Publisher(name="san-events")
    cfg = P.NodeConfig(net=P.BCH_REGTEST, store=P.MemoryKV(), pub=pub,
                       peers=["[::1]:18333"],
                       connect=lambda sa: dummy_peer_connect(R.BCH_REGTEST, all_blocks()),
                       stats_interval=0, watchdog_interval=0.05)
    loop = asyncio.get_running_loop()
    attributor = P_asyncsan.LoopAttributor()
    try:
        P_asyncsan.install()
        attributor.start()
        async with pub.subscription():
            async with P.Node(cfg) as node:
                node._watchdog.attributor = attributor
                await asyncio.sleep(0.15)
                leaked = spawn_supervised(asyncio.sleep(30), name="leaky-test-task")
                time.sleep(0.9)  # a blocking call on the loop
                await poll_until(
                    lambda: any(e.get("kind") == "event_loop"
                                for e in events.tail(50, type="watchdog.stall")),
                    what="attributed watchdog.stall")
                ev = [e for e in events.tail(50, type="watchdog.stall")
                      if e.get("kind") == "event_loop"][-1]
                assert ev["lag_seconds"] >= 0.5
                assert any("test_torch_observe" in f for f in ev.get("blocked_frames", ()))
        leaks = events.tail(50, type="asyncsan.task_leak")
        assert any(e["task"] == "leaky-test-task" for e in leaks), leaks
        leaked.cancel()
    finally:
        attributor.stop()
        loop.set_debug(False)


# ---------------------------------------------------------------------------
# the same activity through both packages

PKGS = {"ref": (R, R_ts, R_slo, R_bb), "port": (P, P_ts, P_slo, P_bb)}


def _activity(reg, step: int) -> None:
    reg.inc("peer.msgs_in", 3 + step)
    reg.set_gauge("chain.height", float(step))
    reg.observe("peer.rtt", 0.25 * (step + 1))
    reg.inc("sched.host_depth", step, labels={"host": "h%d" % (step % 2)})


@pytest.mark.parametrize("tiers", [((1, 100),), ((1, 4), (3, 10))], ids=["one", "two"])
def test_timeline_series_are_alike(tiers):
    out = []
    for T, TS, _, _ in PKGS.values():
        reg = T.Metrics(disabled=False)
        tl = TS.Timeline(interval=1.0, registry=reg, tiers=tiers, disabled=False)
        for step in range(12):
            _activity(reg, step)
            tl.tick(now=100.0 + step)
        names = sorted(tl.names())
        out.append((names, {n: tl.series(n) for n in names},
                    tl.window(105.0, 110.0), tl.fleet_history(), tl.stats()))
    assert out[0] == out[1]


@pytest.mark.parametrize("bad", [0, 30, 120])
def test_slo_burn_is_alike(bad):
    out = []
    for T, _, SL, _ in PKGS.values():
        reg, log = T.Metrics(disabled=False), T.EventLog()
        ev = SL.SloEvaluator(SL.DEFAULT_SLOS, registry=reg, log_=log, disabled=False)
        t0 = 1000.0
        for i in range(200):
            reg.observe("node.verdict_latency", 1e-3, labels={"priority": "block"})
        ev.tick(now=t0)
        for i in range(bad):
            reg.observe("node.verdict_latency", 3.0, labels={"priority": "block"})
        ev.tick(now=t0 + 1)
        reg.set_gauge("watchdog.stalled", 1.0)
        ev.tick(now=t0 + 2)
        burns = [(e["slo"], e["window"], e["burn"]) for e in log.tail(200)
                 if e["type"] == "slo.burn"]
        out.append((burns, ev.burning(), ev.burning("fast"), ev.snapshot()))
    assert out[0] == out[1]


def test_flight_bundles_are_alike(tmp_path):
    out = []
    for pkg, (T, TS, _, BB) in PKGS.items():
        reg, log = T.Metrics(disabled=False), T.EventLog()
        tl = TS.Timeline(interval=1.0, registry=reg, disabled=False)
        for step in range(5):
            _activity(reg, step)
            tl.tick(now=200.0 + step)
        rec = BB.FlightRecorder(
            BB.FlightRecorderConfig(dir=str(tmp_path / pkg), min_interval=60.0),
            timeline=tl, log_=log, sources={"health": lambda: {"ok": True}})
        rec.attach()
        try:
            log.emit("peer.connect", peer="a:1")
            log.emit("watchdog.stall", kind="event_loop", lag_seconds=1.5)
            log.emit("verify.breaker", **{"from": "degraded", "to": "open"})
            (bundle,) = rec.records()
            stats = rec.stats()
        finally:
            rec.detach()
        keys = sorted(bundle)
        files = sorted(p.name.split("-")[0] for p in (tmp_path / pkg).iterdir())
        out.append((keys, bundle["reason"], bundle["trigger"]["kind"],
                    bundle["health"], [e["type"] for e in bundle["events"]],
                    stats["dumps"], stats["suppressed"], files))
    assert out[0] == out[1]
    assert out[1][5] == 1 and out[1][6] == 1


async def test_attributor_names_the_blocker_alike():
    got = []
    for AS in (__import__("tpunode.asyncsan", fromlist=["x"]), P_asyncsan):
        att = AS.LoopAttributor(threshold=0.05, interval=0.01)
        att.start()
        try:
            await asyncio.sleep(0.05)
            time.sleep(0.3)
            await asyncio.sleep(0.05)
            last = att.last_blocked()
        finally:
            att.stop()
        got.append(last["frames"][0].split(" in ")[-1] if last else None)
    assert got[0] == got[1] == "test_attributor_names_the_blocker_alike"
