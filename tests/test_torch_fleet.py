"""The port's fleet — ``sched.FleetDispatcher``, ``sched.AffinityMap``, the
engine's host fleet and mesh rung, the node's fleet branches — against the
reference's.

The reference's own scheduler tests (``tests/test_sched.py``: the packer, the
fleet dispatcher, affinity, the engine pipeline and fleet, the pipeline
chaos) run against the port, rebound by ``port_reference_tests``; the
``VerifyConfig`` fields that are module constants of the port's engine
(``pipeline_depth``, ``breaker_threshold``, ``breaker_cooldown``,
``fleet_queue``) reach those constants (``engine_fields=True``).  Left out,
with port versions below:

* ``test_pipeline_depth_one_is_serial_and_identical``: its last lines hold
  ``VerifyConfig`` to reject ``pipeline_depth=0``; the port has no such
  field (the depth is ``PIPELINE_DEPTH``);
* ``test_fleet_engine_verdict_conservation``: its last lines hold
  ``VerifyConfig`` to reject ``fleet_queue=0``; the port has no such field
  (the per-host queue cap is ``FLEET_QUEUE``);
* ``test_fleet_engine_steals_from_blocked_host``,
  ``test_fleet_shutdown_cancels_queued_and_inflight`` and
  ``test_idle_host_steals_misaffined_lane``: their spies pass the
  reference's ``backend=`` on to ``_dispatch_multi``, which the port's does
  not take (no caller forces a rung);
* ``test_engine_mesh_gating``: it counts JAX's devices; the port counts
  ``multichip.visible_devices``;
* ``test_fleet_chip_loss_shrinks_then_canary_regrows``,
  ``test_fleet_chip_loss_regrows_without_breaker_open``,
  ``test_fleet_mesh_shrink_soak`` and
  ``test_pipeline_chaos_device_loss_drains_inflight``: their simulated
  device patches the reference's kernel entry points, and where a device
  batch fails the reference re-runs it on the CPU while the port raises to
  its waiters (no CPU path stands in for the card).

Then the same seeded scenarios run through both packages and compare: the
fleet dispatcher's assign / cut / take / steal / requeue / deactivate
sequences, the rendezvous routes, and both nodes over ``tests/fakenet.py``
with ``mesh_hosts=2`` (verdicts and stores).  Last, a CPU rehearsal of
``chip_smoke.py``'s fleet phase.
"""

import asyncio
import collections
import importlib
import random
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
import tests.test_sched as ref_sched
import tpunode as R
import tpunode_torch as P
import tpunode_torch.node as P_node
import tpunode_torch.txextract as P_txextract
from benchmarks.txgen import gen_chain, gen_mixed_txs, synth_prevout
from tests.fakenet import dummy_peer_connect, poll_until
from tests.fixtures import all_blocks
from tests.test_engine import make_items
from tests.test_torch_store import port_reference_tests
from tpunode_torch.actors import task_registry
from tpunode_torch.chaos import ChaosPlan, chaos
from tpunode_torch.metrics import metrics
from tpunode_torch.verify import engine as E
from tpunode_torch.verify import multichip as MC
from tpunode_torch.verify.cpu_native import load_native_verifier
from tpunode_torch.verify.sched import AffinityMap, host_names

torch.set_num_threads(1)

_EXCLUDE = {
    "test_pipeline_depth_one_is_serial_and_identical",  # pipeline_depth=0 check
    "test_fleet_engine_verdict_conservation",  # fleet_queue=0 check
    "test_fleet_engine_steals_from_blocked_host",  # _dispatch_multi(backend=)
    "test_fleet_shutdown_cancels_queued_and_inflight",  # _dispatch_multi(backend=)
    "test_idle_host_steals_misaffined_lane",  # _dispatch_multi(backend=)
    "test_engine_mesh_gating",  # jax.devices
    "test_fleet_chip_loss_shrinks_then_canary_regrows",  # CPU failover, jax
    "test_fleet_chip_loss_regrows_without_breaker_open",  # CPU failover, jax
    "test_fleet_mesh_shrink_soak",  # the reference kernel's entry points
    "test_pipeline_chaos_device_loss_drains_inflight",  # CPU failover
}
_PORTED = port_reference_tests(ref_sched, exclude=_EXCLUDE, engine_fields=True)
globals().update(_PORTED)


@pytest.fixture(autouse=True)
def _native_extract_gate(monkeypatch):
    """The reference's fakenet acceptance skips unless
    ``node._native_extract_available()`` holds; the port's node requires the
    native extractor, so the extractor itself answers."""
    monkeypatch.setattr(P_node, "_native_extract_available",
                        P_txextract.have_native_extract, raising=False)


@pytest.fixture
def chaos_off():
    yield
    chaos.uninstall()


def test_every_reference_scheduler_test_is_ported_or_has_a_port_version():
    names = {n for n in vars(ref_sched) if n.startswith("test_")}
    assert names == set(_PORTED) | _EXCLUDE
    assert _EXCLUDE <= set(globals())


# ---------------------------------------------------------------------------
# port versions of the reference tests left out above


async def test_pipeline_depth_one_is_serial_and_identical(monkeypatch):
    """The A/B baseline at ``PIPELINE_DEPTH`` 1: one lane at a time, the
    same verdicts (the port has no ``pipeline_depth`` field to reject)."""
    monkeypatch.setattr(E, "PIPELINE_DEPTH", 1)
    items, expected = make_items(20, tamper_every=4)
    async with E.VerifyEngine(E.VerifyConfig(backend="cpu", batch_size=8, max_wait=0.0)) as eng:
        seen = []
        orig = eng._dispatch_multi

        def spy(payloads, target=None):
            seen.append(eng.dispatch_inflight())
            return orig(payloads, target)

        eng._dispatch_multi = spy
        assert await eng.verify(items) == expected
        assert eng.stats()["pipeline_depth"] == 1
    assert seen and max(seen) == 1
    assert not hasattr(E.VerifyConfig(backend="cpu", warmup=False), "pipeline_depth")


async def test_fleet_engine_verdict_conservation(monkeypatch):
    """``mesh_hosts=4`` on the cpu rung: odd-sized concurrent submissions
    slice across lanes dispatched by four host workers — every waiter gets
    exactly its own items' verdicts and the fleet stats surface (the port
    has no ``fleet_queue`` field to reject)."""
    metrics.reset()
    monkeypatch.setattr(E, "PIPELINE_DEPTH", 1)
    sizes = [3, 9, 1, 7, 5, 2, 11, 4]
    batches = [make_items(n, tamper_every=3) for n in sizes]
    async with E.VerifyEngine(E.VerifyConfig(backend="cpu", batch_size=8, max_wait=0.02,
                                             mesh_hosts=4, warmup=False)) as eng:
        got = await asyncio.gather(*(eng.verify(items) for items, _ in batches))
        st = eng.stats()["fleet"]
    for (items, expected), out in zip(batches, got):
        assert out == expected
    assert st["hosts"] == 4 and len(st["active"]) == 4
    assert metrics.get("sched.lanes") >= 2
    assert metrics.get("verify.items") == sum(sizes)
    assert task_registry.report_leaks() == []
    with pytest.raises(ValueError, match="mesh_hosts"):
        E.VerifyConfig(backend="cpu", warmup=False, mesh_hosts=1)
    assert not hasattr(E.VerifyConfig(backend="cpu", warmup=False, mesh_hosts=2),
                       "fleet_queue")


def _wedge(eng, gate: threading.Event, only: str = "") -> None:
    """Wedge ``eng``'s dispatches on ``gate``: those of the host ``only``,
    or every one."""
    orig = eng._dispatch_multi

    def wedged(payloads, target=None, host=None):
        if not only or (host is not None and host.name == only):
            gate.wait(10)
        return orig(payloads, target, host=host)

    eng._dispatch_multi = wedged


def _steal_config(monkeypatch):
    monkeypatch.setattr(E, "PIPELINE_DEPTH", 1)
    return E.VerifyConfig(backend="cpu", batch_size=4, max_wait=0.0, mesh_hosts=2,
                          warmup=False)


async def test_fleet_engine_steals_from_blocked_host(monkeypatch):
    """Work stealing end to end: with h0's dispatch wedged, its queued lanes
    are stolen and served by h1 — throughput degrades to the healthy host
    instead of queueing behind the sick one."""
    metrics.reset()
    gate = threading.Event()
    async with E.VerifyEngine(_steal_config(monkeypatch)) as eng:
        _wedge(eng, gate, "h0")
        batches = [make_items(4, tamper_every=3) for _ in range(8)]
        futs = [asyncio.ensure_future(eng.verify(items)) for items, _ in batches]
        # h1 drains everything stealable while h0 wedges on (at most) its one
        # in-flight lane
        deadline = time.monotonic() + 10
        while sum(f.done() for f in futs) < len(futs) - 1:
            assert time.monotonic() < deadline, "h1 failed to steal"
            await asyncio.sleep(0.01)
        assert eng._fleet.steals >= 1
        gate.set()
        got = await asyncio.gather(*futs)
    for (items, expected), out in zip(batches, got):
        assert out == expected
    assert metrics.get("sched.steals") >= 1


async def test_fleet_shutdown_cancels_queued_and_inflight(monkeypatch):
    """Engine exit with a wedged fleet cancels the in-flight lanes' futures
    and those of lanes still in host queues — no waiter hangs, no task
    leaks, and late deliveries into cancelled futures are no-ops."""
    gate = threading.Event()
    eng = E.VerifyEngine(_steal_config(monkeypatch))
    futs = []
    async with eng:
        _wedge(eng, gate)
        for _ in range(8):
            items, _ = make_items(4)
            futs.append(asyncio.ensure_future(eng.verify(items)))
        while eng.dispatch_inflight() < 2:
            await asyncio.sleep(0.005)
        await asyncio.sleep(0.05)  # let the scheduler queue the rest
    gate.set()  # unblock the abandoned dispatch threads
    for f in futs:
        with pytest.raises(asyncio.CancelledError):
            await f
    assert task_registry.report_leaks() == []


async def test_idle_host_steals_misaffined_lane(monkeypatch):
    """Affinity is a placement hint, not a fence: with h1 wedged, lanes homed
    to h1 by their keys are stolen and served by idle h0 — verdicts still
    conserve and the steal counters move."""
    metrics.reset()
    gate = threading.Event()
    amap = AffinityMap(host_names(2))
    h1_keys = [k for k in range(200) if amap.prefer(k) == "h1"]
    assert len(h1_keys) >= 8
    async with E.VerifyEngine(_steal_config(monkeypatch)) as eng:
        _wedge(eng, gate, "h1")
        batches = [make_items(4, tamper_every=3) for _ in range(8)]
        futs = [asyncio.ensure_future(eng.verify(items, affinity=k))
                for k, (items, _) in zip(h1_keys, batches)]
        # every lane was homed to the wedged host; h0 must steal through the
        # backlog while h1 wedges on (at most) its one in-flight lane
        deadline = time.monotonic() + 10
        while sum(f.done() for f in futs) < len(futs) - 1:
            assert time.monotonic() < deadline, "h0 never stole"
            await asyncio.sleep(0.01)
        assert eng._fleet.steals >= 1
        assert eng._fleet.host_steals["h0"] >= 1
        # the keys routed home (h1 stayed active); stealing isn't a spill
        assert eng._fleet.affinity_routed == len(batches)
        assert eng._fleet.affinity_spilled == 0
        gate.set()
        got = await asyncio.gather(*futs)
    for (items, expected), out in zip(batches, got):
        assert out == expected
    assert task_registry.report_leaks() == []


def test_engine_mesh_gating(monkeypatch):
    """``mesh_devices``: off by default; a usable mesh is built lazily and
    once; with fewer cards than asked it fails soft — a ``verify.mesh``
    event with ``state="failed"``, ``stats()`` says so, and the device rung
    keeps its one card."""
    from tpunode_torch.events import events

    eng = E.VerifyEngine(E.VerifyConfig(backend="cpu", warmup=False))
    assert eng._mesh() is None and "mesh" not in eng.stats()
    eight = [torch.device("cuda", i) for i in range(8)]
    monkeypatch.setattr(E, "visible_devices", lambda device=None: list(eight))
    monkeypatch.setattr(MC, "visible_devices", lambda device=None: list(eight))
    eng2 = E.VerifyEngine(E.VerifyConfig(backend="cpu", warmup=False, mesh_devices=2))
    mesh = eng2._mesh()
    assert mesh is not None and mesh.devices.size == 2
    assert [d.index for d in mesh.devices.flat] == [0, 1]
    assert eng2._mesh() is mesh
    seq = events.seq()
    eng3 = E.VerifyEngine(E.VerifyConfig(backend="cpu", warmup=False, mesh_devices=4))
    monkeypatch.setattr(E, "visible_devices", lambda device=None: eight[:1])
    assert eng3._mesh() is None
    assert eng3._mesh_state == "failed"
    assert eng3._mesh() is None  # tried once, never again
    evs = [e for e in events.tail_since(seq, 100) if e["type"] == "verify.mesh"]
    assert [e["state"] for e in evs] == ["failed"] and "1 device(s) visible" in evs[0]["error"]
    assert eng3.stats()["mesh"] == {"devices": 4, "state": "failed", "shape": None}


def _fake_card(monkeypatch, seen: list):
    """A device rung whose launches compute real verdicts with the native
    verifier, single-card or sharded, recording (host mesh width) per
    launch: the fleet tests run the genuine device rung, per-host breakers
    engaged, without the plain program's cost.  The warmup is the test
    seam's stub."""
    monkeypatch.setattr(E.VerifyEngine, "_warmup_fn",
                        staticmethod(lambda bs, db=0, **k: "cuda:chaos-sim"))

    native = load_native_verifier()

    def single(chunk, pad_to=None, device=None, **modes):
        seen.append(1)
        return native.verify_raw(chunk), len(chunk)

    def sharded(raw, mesh, pad_to=None, kernel="auto", **modes):
        seen.append(mesh.size)
        return native.verify_raw(raw), len(raw)

    monkeypatch.setattr(E, "dispatch_batch_gpu_raw", single)
    monkeypatch.setattr(E, "dispatch_raw_sharded", sharded)
    monkeypatch.setattr(E, "collect_verdicts", lambda out, count: out[:count])
    eight = [torch.device("cuda", i) for i in range(8)]
    monkeypatch.setattr(E, "visible_devices", lambda device=None: list(eight))
    monkeypatch.setattr(MC, "visible_devices", lambda device=None: list(eight))


async def _chip_loss(monkeypatch, threshold: int, seed: int):
    seen = []
    _fake_card(monkeypatch, seen)
    monkeypatch.setattr(E, "BREAKER_THRESHOLD", threshold)
    monkeypatch.setattr(E, "BREAKER_COOLDOWN", 0.05)
    monkeypatch.setattr(E, "PIPELINE_DEPTH", 1)
    chaos.install(ChaosPlan.parse(f"seed={seed};mesh.dispatch:device_loss:match=h0:tpu,n=1"))
    failed = []
    async with E.VerifyEngine(E.VerifyConfig(device="cpu", batch_size=8, device_batch=8,
                                             max_wait=0.0, mesh_hosts=2)) as eng:
        assert eng.wait_warmup(5) == "ready"
        h0 = eng._hosts["h0"]
        shrunk = False
        opened = set()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            items, expected = make_items(8, tamper_every=3)
            try:
                assert await eng.verify(items) == expected
            except RuntimeError as e:  # the port: the lost chunk's waiters learn it
                failed.append(str(e))
            if h0.chips == 2:
                shrunk = True
                opened.add(h0.breaker.state)
            if shrunk and h0.chips == 4:
                break
            await asyncio.sleep(0.01)
        return eng, h0, shrunk, failed, opened, seen


async def test_fleet_chip_loss_shrinks_then_canary_regrows(monkeypatch, threadsan_armed,
                                                           chaos_off):
    """A device loss on one multi-card host halves its sub-mesh while the
    other host keeps its row; the failed lane fails its own waiters (the
    reference re-runs it on the CPU); the breaker's canary close re-grows
    the sub-mesh."""
    eng, h0, shrunk, failed, _, seen = await _chip_loss(monkeypatch, 1, 5)
    assert shrunk, "device loss never shrank h0's sub-mesh"
    assert h0.chips == 4, "canary close never re-grew the mesh"
    assert eng._hosts["h1"].chips in (0, 4)
    assert len(failed) == 1
    assert metrics.get("mesh.shrinks") >= 1 and metrics.get("mesh.regrows") >= 1
    assert seen and set(seen) <= {2, 4}  # every launch over a host's sub-mesh
    assert threadsan_armed.lock_cycles == 0, threadsan_armed.findings
    assert threadsan_armed.lock_reentries == 0, threadsan_armed.findings


async def test_fleet_chip_loss_regrows_without_breaker_open(monkeypatch, threadsan_armed,
                                                            chaos_off):
    """At the default threshold a single device loss only degrades the
    host's breaker: the shrink still re-grows after the cooldown."""
    eng, h0, shrunk, failed, opened, _ = await _chip_loss(monkeypatch, 3, 6)
    assert shrunk and h0.chips == 4
    assert opened <= {"degraded", "ready"}
    assert h0.breaker.opens == 0 and eng.breaker.opens == 0
    assert len(failed) == 1
    assert threadsan_armed.lock_cycles == 0, threadsan_armed.findings
    assert threadsan_armed.lock_reentries == 0, threadsan_armed.findings


async def test_fleet_mesh_shrink_soak(monkeypatch, threadsan_armed, chaos_off):
    """8 fleet hosts under staged partitions on the device rung: the active
    set shrinks 8 -> ... -> 1 (h0 is never partitioned) while traffic flows
    and re-grows to 8 as the canaries clear; every unique item one clean
    verdict, no task leaks, no lock disorder."""
    from tpunode_torch.events import events as _events

    seen = []
    _fake_card(monkeypatch, seen)
    monkeypatch.setattr(E, "BREAKER_THRESHOLD", 2)
    monkeypatch.setattr(E, "BREAKER_COOLDOWN", 0.05)
    monkeypatch.setattr(E, "PIPELINE_DEPTH", 1)
    monkeypatch.setattr(E, "FLEET_QUEUE", 1)
    plan = ";".join(
        ["seed=1337"]
        + [f"mesh.dispatch:partition:match=h{i},n=14" for i in (4, 5, 6, 7)]
        + [f"mesh.dispatch:partition:match=h{i},after=2,n=12" for i in (2, 3)]
        + ["mesh.dispatch:partition:match=h1,after=4,n=10"]
    )
    chaos.install(ChaosPlan.parse(plan))
    sizes: list = []
    unsub = _events.subscribe(
        lambda ev: sizes.append(ev["active_hosts"])
        if ev.get("type") in ("mesh.host_down", "mesh.host_up") else None)
    try:
        async with E.VerifyEngine(E.VerifyConfig(device="cpu", batch_size=8, device_batch=8,
                                                 max_wait=0.002, mesh_hosts=8)) as eng:
            assert eng.wait_warmup(5) == "ready"
            deadline = time.monotonic() + 40
            while time.monotonic() < deadline:
                batches = [make_items(6, tamper_every=3) for _ in range(10)]
                got = await asyncio.gather(*(eng.verify(i) for i, _ in batches))
                for (items, expected), out in zip(batches, got):
                    assert out == expected
                if sizes and min(sizes) == 1 and len(eng._fleet.active_hosts()) == 8:
                    break
            assert sizes and min(sizes) == 1, sorted(set(sizes))
            assert len(set(sizes)) >= 3
            assert len(eng._fleet.active_hosts()) == 8
            assert eng._fleet.requeued >= 1 and eng.dispatch_inflight() == 0
    finally:
        unsub()
    assert task_registry.report_leaks() == []
    assert threadsan_armed.lock_cycles == 0, threadsan_armed.findings
    assert threadsan_armed.lock_reentries == 0, threadsan_armed.findings


async def test_pipeline_chaos_device_loss_drains_inflight(monkeypatch, chaos_off):
    """Device losses landing mid-pipeline (two lanes in flight) fail just
    the submissions of their lanes — the reference re-runs them on the CPU
    — while every other waiter gets its verdicts; the breaker opens on the
    repeated loss (then "auto" batches are refused) and recovers to ready
    once the plan is exhausted; nothing is stranded."""
    seen = []
    _fake_card(monkeypatch, seen)
    monkeypatch.setattr(E, "BREAKER_THRESHOLD", 2)
    monkeypatch.setattr(E, "BREAKER_COOLDOWN", 0.2)
    chaos.install(ChaosPlan.parse("seed=77;engine.dispatch:device_loss:match=tpu,after=1,n=3"))
    outcomes = collections.Counter()
    failovers = metrics.get("verify.failovers")
    async with E.VerifyEngine(E.VerifyConfig(device="cpu", max_wait=0.005, batch_size=16,
                                             device_batch=16)) as eng:
        assert eng.wait_warmup(5) == "ready"

        async def one(items, expected):
            try:
                got = await eng.verify(items)
            except RuntimeError:
                outcomes["failed"] += 1
                return
            assert got == expected
            outcomes["ok"] += 1

        deadline = time.monotonic() + 20
        while eng.breaker.opens < 1 and time.monotonic() < deadline:
            await asyncio.gather(*(one(*make_items(6, tamper_every=3)) for _ in range(10)))
        assert eng.breaker.opens >= 1, chaos.stats()
        items, expected = make_items(4, tamper_every=2)
        deadline = time.monotonic() + 20
        while eng.breaker.state != "ready" and time.monotonic() < deadline:
            await one(items, expected)
            await asyncio.sleep(0.05)
        assert eng.breaker.state == "ready"
        assert eng.dispatch_inflight() == 0
    assert outcomes["failed"] >= 3 and outcomes["ok"] >= 1
    assert metrics.get("verify.failovers") == failovers  # nothing below the device rung


# ---------------------------------------------------------------------------
# the same seeded scenarios through both packages


def sched(pkg: str):
    return importlib.import_module(f"{pkg}.verify.sched")


def _lane(lane) -> tuple:
    if lane is None:
        return None
    return tuple((sub.priority, sub.n, lo, hi) for sub, lo, hi in lane.slices), lane.requeues


async def _dispatcher_scenario(pkg: str, seed: int) -> list:
    """A seeded stream of pushes (keyed or not), cuts, takes with and
    without stealing, in-flight requeues, deactivations and activations
    over a 4-host dispatcher; each step's outcome and the counters."""
    S = sched(pkg)
    rng = random.Random(seed)
    loop = asyncio.get_running_loop()
    hosts = S.host_names(4)
    f = S.FleetDispatcher(hosts, max_queue=2)
    inflight: list = []
    out = []
    for step in range(300):
        op = rng.choice(["push", "push", "cut", "cut", "take", "take", "requeue",
                         "deactivate", "activate"])
        if op == "push":
            key = rng.getrandbits(64) if rng.random() < 0.7 else None
            sub = S.Submission(list(range(rng.randint(1, 9))), loop.create_future(), None,
                               rng.choice(S.PRIORITIES), enqueued=float(step), affinity=key)
            f.push(sub)
            res = key
        elif op == "cut":
            lane, host = f.cut_next(rng.choice([4, 8]))
            res = (_lane(lane), host)
        elif op == "take":
            h = rng.choice(hosts)
            lane = f.take(h, steal=rng.random() < 0.7)
            if lane is not None:
                inflight.append((h, lane))
            res = (h, _lane(lane))
        elif op == "requeue" and inflight:
            h, lane = inflight.pop(rng.randrange(len(inflight)))
            res = (h, f.requeue(h, lane), _lane(lane))
        elif op == "deactivate":
            res = f.deactivate(rng.choice(hosts))
        elif op == "activate":
            h = rng.choice(hosts)
            f.activate(h)
            res = h
        else:
            res = None
        out.append((op, res, f.steals, f.requeued, f.affinity_routed, f.affinity_spilled,
                    f.host_depths(), f.feed_depths(), f.active_hosts(), f.depths(),
                    f.has_room(), f.feedable(), f.uncut_pending(), f.pending()))
    out.append(("end", f.feed_idle(), dict(f.host_steals), len(f.drain_lanes()),
                len(f.drain_submissions())))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
async def test_fleet_dispatcher_sequences_match_the_reference(seed):
    ref = await _dispatcher_scenario("tpunode", seed)
    port = await _dispatcher_scenario("tpunode_torch", seed)
    assert port == ref
    ops = collections.Counter(step[0] for step in port)
    assert ops["cut"] and ops["take"] and port[-2][2] > 0  # steals happened


@pytest.mark.parametrize("hosts", [2, 3, 8])
def test_affinity_routes_match_the_reference_bit_for_bit(hosts):
    rng = np.random.default_rng(hosts)
    keys = [int(k) for k in rng.integers(0, 2**63, size=4000, dtype=np.int64)]
    keys += [0, 1, 2**64 - 1, 2**64, -1]
    names = sched("tpunode_torch").host_names(hosts)
    assert names == sched("tpunode").host_names(hosts)
    ours, ref = sched("tpunode_torch").AffinityMap(names), sched("tpunode").AffinityMap(names)
    assert ours._seed == ref._seed
    for k in keys:
        assert ours.prefer(k) == ref.prefer(k)
        active = names[1:] if k % 2 else names[:-1]
        assert ours.route(k, active) == ref.route(k, active)
        assert sched("tpunode_torch")._mix64(k) == sched("tpunode")._mix64(k)
    for txid in (bytes(range(32)), bytes(32), b"\xff" * 32):
        assert (sched("tpunode_torch").affinity_key(txid)
                == sched("tpunode").affinity_key(txid))


async def _fleet_engine_scenario(pkg: str) -> dict:
    """Keyed and keyless submissions through a 2-host fleet engine on the
    cpu rung, then a partition of h1 and its rejoin: the verdicts, the
    routed and spilled counts and the ledger's hosts."""
    Eng = importlib.import_module(f"{pkg}.verify.engine")
    ch = importlib.import_module(f"{pkg}.chaos")
    kw = dict(backend="cpu", batch_size=8, max_wait=0.005, mesh_hosts=2, warmup=False)
    if pkg == "tpunode":
        kw.update(pipeline_depth=2, breaker_cooldown=0.1)
    saved = E.BREAKER_COOLDOWN
    E.BREAKER_COOLDOWN = 0.1
    try:
        batches = [make_items(5, tamper_every=3) for _ in range(12)]
        out = {}
        async with Eng.VerifyEngine(Eng.VerifyConfig(**kw)) as eng:
            got = await asyncio.gather(*(eng.verify(i, affinity=k if k % 3 else None)
                                         for k, (i, _) in enumerate(batches)))
            out["verdicts"] = got == [e for _, e in batches]
            out["routed"] = eng._fleet.affinity_routed
            out["spilled"] = eng._fleet.affinity_spilled
            out["homes"] = [eng.route_host(k) for k in range(12)]
            ch.chaos.install(ch.ChaosPlan.parse("seed=3;mesh.dispatch:partition:match=h1,n=1"))
            try:
                for _ in range(20):
                    got = await asyncio.gather(*(eng.verify(i, affinity=k)
                                                 for k, (i, _) in enumerate(batches)))
                    assert got == [e for _, e in batches]
                    if not eng._hosts["h1"].breaker.state == "ready":
                        break
            finally:
                ch.chaos.uninstall()
            out["lost"] = eng._hosts["h1"].breaker.opens
            await poll_until(lambda: len(eng._fleet.active_hosts()) == 2, what="rejoin")
            out["ledger_hosts"] = set(eng.ledger()["by_host"]) <= {"h0", "h1"}
            out["stats_keys"] = sorted(k for k in eng.stats()["fleet"]
                                       if k not in ("hybrid_state", "mesh_states"))
        return out
    finally:
        E.BREAKER_COOLDOWN = saved


async def test_fleet_engines_route_and_recover_alike():
    ref = await _fleet_engine_scenario("tpunode")
    port = await _fleet_engine_scenario("tpunode_torch")
    assert port == ref
    assert port["verdicts"] and port["routed"] == 8 and port["lost"] == 1


@pytest.mark.parametrize("gate", ["worker", "pick"])
async def test_a_host_with_its_breaker_held_open_leaves_its_lanes_to_its_peer(monkeypatch,
                                                                           gate):
    """``h1``'s breaker held open while ``h0`` is healthy: every lane homed on
    ``h1`` is served on ``h0``'s card at once, and ``h1`` stays active, is
    never lost and launches nothing.  ``worker``: ``h1``'s workers sit out
    and ``h0`` steals the lanes; ``pick``: ``h1``'s workers take lanes
    until the first refusal, and its refusing breaker hands each to ``h0``
    through the requeue.  A lane that waited for ``h1``'s breaker would take
    ``WARMUP_TIMEOUT``."""
    seen = []
    _fake_card(monkeypatch, seen)
    monkeypatch.setattr(E, "BREAKER_COOLDOWN", 3600.0)
    monkeypatch.setattr(E, "WARMUP_TIMEOUT", 30.0)
    if gate == "pick":
        # the breaker refuses only once h1's workers hold lanes (as when it
        # opens on another lane's failure): h1 takes lanes until a refusal
        sits_out = E.VerifyEngine._sits_out
        monkeypatch.setattr(E.VerifyEngine, "_sits_out",
                            lambda self, hs: bool(self._fleet.requeued) and sits_out(self, hs))
    losses0 = metrics.get("mesh.host_losses")
    errors0 = metrics.get("verify.dispatch_errors")
    async with E.VerifyEngine(E.VerifyConfig(device="cpu", batch_size=8, device_batch=8,
                                             max_wait=0.0, mesh_hosts=2)) as eng:
        assert eng.wait_warmup(5) == "ready"
        h1 = eng._hosts["h1"]
        h1.breaker.trip("held open")
        keys = [k for k in range(64) if eng.route_host(k) == "h1"][:8]
        assert len(keys) == 8
        batches = [make_items(8, tamper_every=3) for _ in keys]
        t0 = time.monotonic()
        got = await asyncio.gather(*(eng.verify(items, affinity=k)
                                     for k, (items, _) in zip(keys, batches)))
        seconds = time.monotonic() - t0
        assert got == [expected for _, expected in batches]
        assert seconds < 5.0, seconds
        assert h1.breaker.state == "open" and eng._fleet.active_hosts() == ["h0", "h1"]
        assert set(eng.ledger()["by_host"]) == {"h0"}
        moved = eng._fleet.requeued + eng._fleet.steals
        if gate == "pick":
            assert eng._fleet.requeued >= 1
        assert moved >= 1
    assert metrics.get("mesh.host_losses") == losses0
    assert metrics.get("verify.dispatch_errors") == errors0
    assert seen and task_registry.report_leaks() == []


# -- both nodes over the fake network with a fleet engine ---------------------------


NET = R.BCH_REGTEST
PKGS = {"ref": R, "port": P}


def _row(ev):
    name = type(ev).__name__
    if name == "TxVerdict":
        return (name, ev.txid, ev.valid, tuple(ev.verdicts), ev.error)
    if name == "ChainSynced":
        return (name, ev.node.height, ev.node.hash)
    return (name,)


async def _fleet_node_scenario(pkg: str, name: str) -> tuple:
    T = PKGS[pkg]
    Eng = importlib.import_module(f"{T.__name__}.verify.engine")
    chain = gen_chain(NET, 4, 12, seed=0x40DE, mix=True)
    txs = gen_mixed_txs(24, seed=0x7A5, invalid_every=5)
    store = T.MemoryKV()
    pub = T.Publisher(name=f"{pkg}-fleet-node", maxsize=None)
    kw = dict(prevout_lookup=synth_prevout, extract_workers=4)
    if name == "ibd":
        kw.update(utxo=True, ibd=T.IbdConfig(batch_blocks=2, tick_interval=0.02))
    cfg = T.NodeConfig(
        net=T.BCH_REGTEST, store=T.Namespaced(store, b"node:"), pub=pub,
        peers=["[::1]:17486"], discover=False, stats_interval=0,
        connect=lambda sa: dummy_peer_connect(NET, chain if name == "ibd" else all_blocks()),
        verify=Eng.VerifyConfig(backend="cpu", max_wait=0.0, mesh_hosts=2), **kw)
    rows = []
    n = sum(len(b.txs) for b in chain) if name == "ibd" else len(txs)
    async with pub.subscription() as events:
        async with T.Node(cfg) as node:
            assert node._fleet_affine() and node._extract_pools is not None
            async with asyncio.timeout(60):
                while not any(r[0] == "ChainSynced" for r in rows):
                    rows.append(_row(await events.receive()))
                if name == "txs":
                    peer = node.peer_mgr.get_peers()[0].peer
                    for tx in txs:
                        W = importlib.import_module(f"{T.__name__}.wire")
                        U = importlib.import_module(f"{T.__name__}.util")
                        node._peer_pub.publish(T.PeerMessage(
                            peer, W.MsgTx.deserialize_payload(U.Reader(tx.serialize()))))
                while sum(r[0] == "TxVerdict" for r in rows) < n:
                    rows.append(_row(await events.receive()))
            if name == "ibd":
                await poll_until(lambda: node.utxo.height == len(chain), what="utxo")
            fleet = node._fleet_now()
            pools = sorted(node._extract_pools)
            routed = fleet["affinity"]["routed"]
    verdicts = sorted(r for r in rows if r[0] == "TxVerdict")
    return verdicts, sorted(store.scan_prefix(b"")), routed > 0, pools


@pytest.mark.parametrize("name", ["txs", "ibd"])
async def test_both_fleet_nodes_publish_the_same_and_store_the_same(name):
    """A node on a 2-host fleet engine: its mempool drains group by target
    host (one affinity-keyed submission a host, extracted in that host's
    pool slice), its blocks verify on their block hash's home host, and
    the per-key gates stand in for the global ones — with the same
    verdicts and the same store as the reference's node."""
    ref = await _fleet_node_scenario("ref", name)
    port = await _fleet_node_scenario("port", name)
    assert port[:2] == ref[:2]
    assert port[2] and ref[2]
    assert port[3] == ref[3] and set(port[3]) <= {"h0", "h1"}
    assert port[3] or name == "ibd"  # blocks extract in the shared pool
    valid = [r[2] for r in port[0]]
    assert any(valid) and (name == "ibd" or not all(valid))


def test_the_nodes_fleet_gates_follow_the_engine():
    """``_ingest_pressure_key`` and ``_ibd_pressure_key`` ask the engine's
    ``host_pressured``; the global ingest gate trips only when every
    active host is pressured; without a fleet they are the global gates."""
    cfg = P.NodeConfig(net=P.BCH_REGTEST, store=P.MemoryKV(), pub=P.Publisher(),
                       verify=E.VerifyConfig(backend="cpu", mesh_hosts=2, warmup=False))
    node = P.Node(cfg)
    eng = node.verify_engine
    key = bytes(range(32))
    host = eng.route_host(int.from_bytes(key[:8], "little"))
    assert node._affine_host(key) == host in ("h0", "h1")
    assert not node._ingest_pressure_key(key) and not node._ibd_pressure_key(key)
    assert not node._ingest_pressure()
    pressured = {host}
    eng.host_pressured = lambda k: eng.route_host(k) in pressured
    assert node._ingest_pressure_key(key) and node._ibd_pressure_key(key)
    eng.hosts_all_pressured = lambda: pressured == {"h0", "h1"}
    assert not node._ingest_pressure()
    pressured.add("h1" if host == "h0" else "h0")
    assert node._ingest_pressure()
    plain = P.Node(P.NodeConfig(net=P.BCH_REGTEST, store=P.MemoryKV(), pub=P.Publisher(),
                                verify=E.VerifyConfig(backend="cpu", warmup=False)))
    assert not plain._fleet_affine() and plain._fleet_now() == {"enabled": False}
    assert not plain._ibd_pressure_key(key) and plain._affinity(lambda: key) is None
    assert node._affinity(lambda: key) == int.from_bytes(key[:8], "little")


# ---------------------------------------------------------------------------
# chip_smoke.py's fleet phase, rehearsed on the CPU


def _phase_counts():
    from tpunode_torch.verify import cuda_kernel

    def reset_launches():
        for counts in (cuda_kernel.LAUNCHES, cuda_kernel.LIBRARY_LAUNCHES):
            for key in counts:
                counts[key] = 0
        cuda_kernel.STREAM_LAUNCHES.clear()

    def engine_metrics():
        return {name: metrics.get(name) for name in (
            "verify.tpu_items", "verify.cpu_items", "verify.failovers", "verify.dispatch_errors")}

    return reset_launches, engine_metrics


def test_fleet_engine_phase_reads_every_check(monkeypatch):
    """The fleet engine phase at a small size, its device rung the native
    verifier counting a ``verify_u32`` launch per chunk as the card's
    would, on one card (the hybrid mesh fails soft) and on eight: the
    partition requeues h1's lanes onto h0 once each, h1 rejoins, and every
    check reads; a rung that launches nothing fails the phase."""
    from tpunode_torch.verify import cuda_kernel
    from tpunode_torch.verify.raw import pack_items

    saved = dict(cuda_kernel.LAUNCHES), dict(cuda_kernel.LIBRARY_LAUNCHES)
    seen = []
    _fake_card(monkeypatch, seen)
    monkeypatch.setattr(E, "BREAKER_COOLDOWN", 0.2)
    single, sharded = E.dispatch_batch_gpu_raw, E.dispatch_raw_sharded

    def counted(fn):
        def launch(*args, **kw):
            cuda_kernel.LIBRARY_LAUNCHES[(cuda_kernel.U32_LIBRARY, "full")] += 1
            return fn(*args, **kw)
        return launch

    monkeypatch.setattr(E, "dispatch_batch_gpu_raw", counted(single))
    monkeypatch.setattr(E, "dispatch_raw_sharded", counted(sharded))
    items, native = make_items(64, tamper_every=5)
    raw = pack_items(items)
    cfg = E.VerifyConfig(device="cpu", batch_size=16, device_batch=16, mesh_hosts=2)
    try:
        for cards in (1, 8):
            devs = [torch.device("cuda", i) for i in range(cards)]
            monkeypatch.setattr(E, "visible_devices", lambda device=None: list(devs))
            monkeypatch.setattr(MC, "visible_devices", lambda device=None: list(devs))
            row, launches = chip_smoke.fleet_engine_phase(raw, native, *_phase_counts(),
                                                          cfg=cfg, submissions=8, items=8)
            assert row["hybrid_state"] == ("failed" if cards == 1 else "ready")
            assert row["host_losses"] == 1 and row["active"] == ["h0", "h1"]
            assert row["requeued"] == len(row["moves"]) >= 1
            assert {(m["from"], m["to"]) for m in row["moves"]} == {("h1", "h0")}
            assert row["breakers"]["h1"] == "ready" and launches["full"] >= 3
            assert row["grew"]["verify.tpu_items"] == row["items"] and row["routed"] >= 8
        monkeypatch.setattr(E, "dispatch_batch_gpu_raw", single)
        monkeypatch.setattr(E, "dispatch_raw_sharded", sharded)
        with pytest.raises(RuntimeError, match="fleet engine: .*launched"):
            chip_smoke.fleet_engine_phase(raw, native, *_phase_counts(), cfg=cfg,
                                          submissions=8, items=8)
    finally:
        cuda_kernel.LAUNCHES.update(saved[0])
        cuda_kernel.LIBRARY_LAUNCHES.update(saved[1])


def test_sharded_dispatch_phase_reads_every_check(monkeypatch):
    """The fleet phase's sharded part on the CPU: one visible device, so two
    shards of it; each shard's plain program counted by (device, call) as
    the card's launches are by (card, stream); the verdicts against the
    unsharded run, the plain verdicts and the oracle; a wrong plain verdict
    fails the phase, and so does a shard that launches nothing."""
    from tpunode_torch.verify import cuda_kernel
    from tpunode_torch.verify.raw import pack_items

    monkeypatch.setattr(MC, "visible_devices", lambda device=None: [torch.device("cpu")])
    monkeypatch.setattr(MC, "_FN_CACHE", {})
    core = MC.verify_core
    calls = iter(range(1, 1000))

    def counted(*args, **kw):
        cuda_kernel.STREAM_LAUNCHES[(str(args[8].device), next(calls))] += 1
        return core(*args, **kw)

    monkeypatch.setattr(MC, "verify_core", counted)
    items, native = make_items(6, tamper_every=3)
    modes = dict(window_bits=4, point_form="projective", reduce="lazy", select="tree",
                 ladder="scan", sqr="half", mul="shift_add")
    row = chip_smoke.sharded_dispatch_phase(pack_items(items), native, native, modes, runs=1)
    assert row["mesh"] == ["cpu", "cpu"] and row["lanes_a_shard"] == 3
    assert row["mismatches"] == {"unsharded": 0, "plain": 0, "native": 0}
    assert row["launches_by_device"] == {"cpu": 2} and len(row["launches_by_stream"]) == 2
    assert len(row["sharded_ms_runs"]) == len(row["unsharded_ms_runs"]) == 1
    wrong = [not v for v in native]
    with pytest.raises(RuntimeError, match="fleet sharded: .*plain"):
        chip_smoke.sharded_dispatch_phase(pack_items(items), native, wrong, modes, runs=1)
    monkeypatch.setattr(MC, "verify_core", core)
    monkeypatch.setattr(MC, "_FN_CACHE", {})
    with pytest.raises(RuntimeError, match="fleet sharded: launched"):
        chip_smoke.sharded_dispatch_phase(pack_items(items), native, native, modes, runs=1)


def test_mesh_engine_phase_reads_every_check(monkeypatch):
    """The fleet phase's ``mesh_devices`` part on a fake card: with one card
    the mesh fails soft (one ``verify.mesh`` event, ``stats()`` says
    "failed") and the chunk runs on the card; with eight it is "ready" and
    the chunk is sharded; a rung that launches nothing fails the phase."""
    from tpunode_torch.verify import cuda_kernel
    from tpunode_torch.verify.raw import pack_items

    saved = dict(cuda_kernel.LIBRARY_LAUNCHES)
    seen = []
    _fake_card(monkeypatch, seen)
    single, sharded = E.dispatch_batch_gpu_raw, E.dispatch_raw_sharded

    def counted(fn):
        def launch(*args, **kw):
            cuda_kernel.LIBRARY_LAUNCHES[(cuda_kernel.U32_LIBRARY, "full")] += 1
            return fn(*args, **kw)
        return launch

    monkeypatch.setattr(E, "dispatch_batch_gpu_raw", counted(single))
    monkeypatch.setattr(E, "dispatch_raw_sharded", counted(sharded))
    items, native = make_items(24, tamper_every=5)
    raw = pack_items(items)
    cfg = E.VerifyConfig(device="cpu", batch_size=8, device_batch=16, mesh_devices=2)
    try:
        for cards, state in ((1, "failed"), (8, "ready")):
            devs = [torch.device("cuda", i) for i in range(cards)]
            monkeypatch.setattr(E, "visible_devices", lambda device=None: list(devs))
            monkeypatch.setattr(MC, "visible_devices", lambda device=None: list(devs))
            del seen[:]
            row, launches = chip_smoke.mesh_engine_phase(raw, native, *_phase_counts(),
                                                         cfg=cfg, items=20)
            assert row["mesh"]["state"] == state and [e["state"] for e in
                                                      row["mesh_events"]] == [state]
            assert row["rung"] == "tpu" and launches["full"] == 2
            assert set(seen) == ({1} if cards == 1 else {2})
        monkeypatch.setattr(E, "dispatch_batch_gpu_raw", single)
        monkeypatch.setattr(E, "dispatch_raw_sharded", sharded)
        with pytest.raises(RuntimeError, match="fleet mesh: launched"):
            chip_smoke.mesh_engine_phase(raw, native, *_phase_counts(), cfg=cfg, items=20)
    finally:
        cuda_kernel.LIBRARY_LAUNCHES.update(saved)
