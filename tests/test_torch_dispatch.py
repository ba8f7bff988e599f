"""The port's dispatch engine against the reference's: the backend ladder,
the circuit breaker, ``min_tpu_batch`` routing, the background warmup, the
cost ledger and ``stats()``.  Where the reference gives work to the CPU in
the card's place (a failed device batch, a warming or failed device, an
open breaker), the port's tests hold it to raising or waiting instead.

Scenarios that need no device run on both packages, parametrised over
``tpunode`` and ``tpunode_torch``: the reference engine on its cpu and
oracle rungs, the port's the same, and their outcomes must be equal.
Where the device rung is in play the port runs it on the plain program
(``device="cpu"``), with the reference's test seam standing in for the
warmup where a test needs the device ready at once.  A test that arms a
package's chaos registry disarms it in ``finally``.
"""

import asyncio
import importlib
import random
import sys
import threading
import time

import pytest
import torch

from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import engine as E

torch.set_num_threads(1)

PACKAGES = ["tpunode", "tpunode_torch"]


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def engine_mod(pkg: str):
    return mod(pkg, "verify.engine")


def _items(pkg: str, n: int, tamper_every: int = 0, seed: int = 7) -> tuple:
    """``n`` ECDSA items of ``pkg``'s own oracle types, every
    ``tamper_every``-th one invalid, and their verdicts."""
    O = mod(pkg, "verify.ecdsa_cpu")
    rng = random.Random(seed)
    items, expect = [], []
    for i in range(n):
        priv = rng.randrange(1, O.CURVE_N)
        z = rng.randrange(1, O.CURVE_N)
        r, s = O.sign(priv, z, rng.randrange(1, O.CURVE_N))
        bad = bool(tamper_every) and i % tamper_every == 0
        items.append((O.point_mul(priv, O.GENERATOR), z ^ 1 if bad else z, r, s))
        expect.append(not bad)
    return items, expect


class _Events:
    """The ``verify.*`` events a package emitted from now on."""

    def __init__(self, pkg: str):
        self.log = mod(pkg, "events").events
        self.seq = self.log.seq()

    def of(self, type_: str) -> list:
        return [e for e in self.log.tail_since(self.seq, 10_000) if e["type"] == type_]


def _counts(pkg: str) -> dict:
    m = mod(pkg, "metrics").metrics
    return {name: m.get(name) for name in ("verify.failovers", "verify.dispatch_errors",
                                           "verify.cpu_items", "verify.oracle_items",
                                           "verify.tpu_items")}


def _grew(pkg: str, before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts(pkg).items()}


def _ready_port_engine(monkeypatch, **kw) -> E.VerifyEngine:
    """A port engine whose device rung (the plain program) is ready at
    once: the warmup is the test seam's stub."""
    monkeypatch.setattr(E.VerifyEngine, "_warmup_fn", staticmethod(lambda bs, db=0, **k: "cpu"))
    cfg = dict(device="cpu", batch_size=8, device_batch=8, max_wait=0.0)
    engine = E.VerifyEngine(E.VerifyConfig(**{**cfg, **kw}))
    assert engine.wait_warmup(30) == "ready"
    return engine


# -- the ladder -----------------------------------------------------------------


async def _ladder_scenario(pkg: str, backend: str) -> dict:
    """Three async batches on ``backend`` with the first two failing on the
    cpu rung (chaos): they fail over to the oracle, reported."""
    ch = mod(pkg, "chaos")
    E_ = engine_mod(pkg)
    items, expect = _items(pkg, 4, tamper_every=3)
    events = _Events(pkg)
    before = _counts(pkg)
    ch.chaos.install(ch.ChaosPlan.parse("seed=7;engine.dispatch:error:match=cpu,n=2"))
    try:
        eng = E_.VerifyEngine(E_.VerifyConfig(backend=backend, max_wait=0.0, warmup=False))
        verdicts, rungs = [], []
        async with eng:
            for _ in range(3):
                verdicts.append(await asyncio.wait_for(eng.verify(items), 60) == expect)
                rungs.append(eng.last_rung)
    finally:
        ch.chaos.uninstall()
    return {
        "verdicts": verdicts,
        "rungs": rungs,
        "grew": _grew(pkg, before),
        "failovers": [(e["source"], e["target"]) for e in events.of("verify.failover")],
        "failures": [e["backend"] for e in events.of("verify.failure")],
        "dispatched": [e["backend"] for e in events.of("verify.dispatch")],
    }


@pytest.mark.parametrize("backend", ["cpu", "oracle"])
@pytest.mark.parametrize("pkg", PACKAGES)
async def test_ladder_rungs_and_failovers_under_chaos_match_the_reference(pkg, backend):
    got = await _ladder_scenario(pkg, backend)
    assert got == await _ladder_scenario("tpunode", backend)
    assert got["verdicts"] == [True] * 3
    if backend == "cpu":
        assert got["rungs"] == ["oracle", "oracle", "cpu"]
        assert got["failovers"] == [("cpu", "oracle")] * 2
        assert got["grew"]["verify.failovers"] == got["grew"]["verify.dispatch_errors"] == 2
        assert (got["grew"]["verify.cpu_items"], got["grew"]["verify.oracle_items"]) == (4, 8)
    else:  # the chaos plan names the cpu rung only
        assert got["rungs"] == ["oracle"] * 3 and got["failovers"] == []


async def test_device_rung_failure_raises_to_the_waiters_and_is_reported(monkeypatch):
    """A device-rung failure (a kernel that fails to launch) fails the
    batch's waiters: nothing on the CPU stands in for the card.  It is
    reported, as the reference reports a failure: a ``verify.failure``
    event, a dispatch error and a breaker failure, with no failover.  The
    next batch is the device's again."""
    engine = _ready_port_engine(monkeypatch)
    items, expect = _items("tpunode_torch", 4, tamper_every=2)
    real = E.dispatch_batch_gpu_raw
    fail = [True]

    def dispatch(raw, **kw):
        if fail[0]:
            fail[0] = False
            raise RuntimeError("verify kernel launch failed (verify_u32): no kernel image (209)")
        return real(raw, **kw)

    monkeypatch.setattr(E, "dispatch_batch_gpu_raw", dispatch)
    events = _Events("tpunode_torch")
    before = _counts("tpunode_torch")
    async with engine:
        with pytest.raises(RuntimeError, match="verify kernel launch failed"):
            await asyncio.wait_for(engine.verify(items), 60)
        state = engine.breaker_state
        assert await asyncio.wait_for(engine.verify(items), 60) == expect
    assert (state, engine.last_rung, engine.breaker_state) == ("degraded", "tpu", "ready")
    assert events.of("verify.failover") == []
    failures = events.of("verify.failure")
    assert [(e["where"], e["backend"]) for e in failures] == [("dispatch", "tpu")]
    assert "verify kernel launch failed" in failures[0]["error"]
    grew = _grew("tpunode_torch", before)
    assert (grew["verify.failovers"], grew["verify.dispatch_errors"]) == (0, 1)
    assert (grew["verify.cpu_items"], grew["verify.oracle_items"], grew["verify.tpu_items"]) == (
        0, 0, 4)
    assert [e["to"] for e in events.of("verify.breaker")] == ["degraded", "ready"]


def test_device_rung_under_chaos_device_loss_raises(monkeypatch):
    """The port's ladder reads its own chaos registry: an injected device
    loss on the "tpu" rung reaches the caller, and the next batch is the
    device's."""
    from tpunode_torch.chaos import ChaosDeviceLoss, ChaosPlan, chaos

    engine = _ready_port_engine(monkeypatch)
    items, expect = _items("tpunode_torch", 3)
    chaos.install(ChaosPlan.parse("seed=1;engine.dispatch:device_loss:match=tpu,n=1"))
    try:
        with pytest.raises(ChaosDeviceLoss):
            engine.verify_sync(items)
        assert engine.verify_sync(items) == expect and engine.last_rung == "tpu"
    finally:
        chaos.uninstall()
    assert engine.breaker.stats()["last_error"] is None  # the success closed it


@pytest.mark.parametrize("backend, tried", [("auto", ["tpu"]), ("tpu", ["tpu"]),
                                            ("cpu", ["cpu", "oracle"]), ("oracle", ["oracle"])])
def test_a_failed_batch_goes_down_its_backends_ladder_only(monkeypatch, backend, tried):
    """The cpu rung fails over to the oracle, as the reference's does; the
    device rung has no rung below it, so a forced "tpu" backend never
    reaches the oracle and "auto" never reaches the CPU."""
    if backend in ("auto", "tpu"):
        engine = _ready_port_engine(monkeypatch, backend=backend)
    else:
        engine = E.VerifyEngine(E.VerifyConfig(backend=backend))
    seen = []

    def broken(rung, payloads, total):
        seen.append(rung)
        raise RuntimeError(f"{rung} down")

    monkeypatch.setattr(engine, "_run_backend", broken)
    with pytest.raises(RuntimeError, match=f"{tried[-1]} down"):  # the last rung's error
        engine.verify_sync(_items("tpunode_torch", 2)[0])
    assert seen == tried


# -- the breaker ----------------------------------------------------------------


def _breaker_scenario(pkg: str) -> dict:
    br = engine_mod(pkg).CircuitBreaker(threshold=2, window=30.0, cooldown=0.05)
    trail = [br.state]

    def step(what):
        out = what()
        trail.append((br.state, out))

    step(br.allow_device)
    step(lambda: br.record_failure("e1"))
    step(br.allow_device)
    step(lambda: br.record_failure("e2"))
    step(br.allow_device)  # open: no device until the cooldown
    time.sleep(0.06)
    step(br.allow_device)  # the canary
    step(br.allow_device)  # one canary only
    step(lambda: br.record_failure("e3"))  # a failed canary re-opens
    time.sleep(0.06)
    step(br.allow_device)
    step(br.record_success)  # closes
    step(br.record_success)
    stats = br.stats()
    return {"trail": trail, "opens": br.opens, "closes": br.closes,
            "stats": {k: v for k, v in stats.items() if k != "open_age_seconds"}}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_breaker_transitions_match_the_reference(pkg):
    got = _breaker_scenario(pkg)
    assert got == _breaker_scenario("tpunode")
    states = [s if isinstance(s, str) else s[0] for s in got["trail"]]
    assert states == ["ready", "ready", "degraded", "degraded", "open", "open", "probing",
                      "probing", "open", "probing", "ready", "ready"]
    assert (got["opens"], got["closes"]) == (2, 1)


# -- routing and warmup ---------------------------------------------------------


def _stub(value=None, exc=None, hang=None):
    def warmup(bs, db=0, **kw):
        if hang is not None:
            hang.wait(30)
        if exc is not None:
            raise exc
        return value
    return staticmethod(warmup)


def _routing_scenario(pkg: str, monkeypatch) -> dict:
    """``_pick``'s starting rung by batch size on a ready device, at the
    reference's default ``min_tpu_batch`` of 1024 (which the port's caller
    sets: the port's default is 0)."""
    E_ = engine_mod(pkg)
    cfg = {"device": "cpu", "min_tpu_batch": 1024} if pkg == "tpunode_torch" else {}
    monkeypatch.setattr(E_.VerifyEngine, "_warmup_fn", _stub("x:fake"))
    eng = E_.VerifyEngine(E_.VerifyConfig(batch_size=64, device_batch=128, **cfg))
    eng._warmup_done.wait(30)
    ready = [eng._pick(n) for n in (1, 1023, 1024, 10**6)]
    state_ready = (eng.device_state, eng.breaker_state, eng._lane_target())
    for _ in range(3):
        eng.breaker.record_failure("down")
    return {"ready": ready, "state_ready": state_ready, "opened_below": eng._pick(1023),
            "breaker_state": eng.breaker_state}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_min_tpu_batch_routing_matches_the_reference(pkg, monkeypatch):
    got = _routing_scenario(pkg, monkeypatch)
    assert got == _routing_scenario("tpunode", monkeypatch)
    assert got["ready"] == ["cpu", "cpu", "tpu", "tpu"] and got["opened_below"] == "cpu"
    assert got["state_ready"] == ("ready", "ready", 128) and got["breaker_state"] == "open"


def test_a_batch_for_the_card_waits_for_its_warmup(monkeypatch):
    """Where the reference serves "auto" batches on the cpu rung while the
    device warms up, the port's wait for the warmup and go to the card."""
    hang = threading.Event()
    monkeypatch.setattr(E.VerifyEngine, "_warmup_fn", _stub("cpu", hang=hang))
    eng = E.VerifyEngine(E.VerifyConfig(device="cpu", batch_size=64, device_batch=128))
    assert eng.device_state == "warming" and eng._lane_target() == 64
    timer = threading.Timer(0.2, hang.set)
    timer.start()
    t0 = time.monotonic()
    assert eng._pick(1) == "tpu" and time.monotonic() - t0 >= 0.15
    assert eng.device_state == "ready" and eng._lane_target() == 128
    timer.join(5)


def test_an_open_breaker_refuses_the_card_and_sends_nothing_to_the_cpu(monkeypatch):
    """Where the reference serves "auto" batches on the cpu rung while its
    breaker is open, the port's raise, reported as a failure to pick."""
    engine = _ready_port_engine(monkeypatch)
    for _ in range(E.BREAKER_THRESHOLD):
        engine.breaker.record_failure("verify kernel launch failed")
    events = _Events("tpunode_torch")
    before = _counts("tpunode_torch")
    with pytest.raises(RuntimeError, match="circuit breaker open: verify kernel launch failed"):
        engine.verify_sync(_items("tpunode_torch", 1)[0])
    assert [(e["where"], e["backend"]) for e in events.of("verify.failure")] == [
        ("pick", "auto")]
    grew = _grew("tpunode_torch", before)
    assert grew["verify.dispatch_errors"] == 1
    assert grew["verify.cpu_items"] == grew["verify.oracle_items"] == 0


def test_the_default_min_tpu_batch_routes_nothing_to_the_cpu(monkeypatch):
    """At the port's default ``min_tpu_batch`` of 0 an "auto" engine loads
    no native verifier, and every batch, of any size, is the card's."""
    engine = _ready_port_engine(monkeypatch, batch_size=64, device_batch=128)
    assert engine.cfg.min_tpu_batch == 0 and engine._cpu is None
    assert [engine._pick(n) for n in (1, 1023, 10**6)] == ["tpu"] * 3
    with pytest.raises(ValueError, match="min_tpu_batch"):
        E.VerifyConfig(min_tpu_batch=-1)


@pytest.mark.parametrize("backend, expect_calls, grew", [
    ("auto", [(8, 8)], (8, 3)), ("tpu", [(8, 8), (3, 4)], (11, 0))])
def test_short_chunks_go_to_the_cpu_rung_below_min_tpu_batch(monkeypatch, backend,
                                                             expect_calls, grew):
    """On the device rung of "auto", a chunk shorter than the caller's
    ``min_tpu_batch`` is served by the native verifier; a forced "tpu"
    backend sends it to the device all the same."""
    items, expect = _items("tpunode_torch", 11, tamper_every=4)
    calls = []
    real = E.dispatch_batch_gpu_raw

    def dispatch(raw, **kw):
        calls.append((len(raw), kw["pad_to"]))
        return real(raw, **kw)

    monkeypatch.setattr(E, "dispatch_batch_gpu_raw", dispatch)
    engine = _ready_port_engine(monkeypatch, backend=backend, batch_size=4, min_tpu_batch=4)
    before = _counts("tpunode_torch")
    assert engine._run_tpu([items]) == expect
    counts = _grew("tpunode_torch", before)
    assert calls == expect_calls
    assert (counts["verify.tpu_items"], counts["verify.cpu_items"]) == grew


def _big_shape_scenario(pkg: str, monkeypatch) -> dict:
    E_ = engine_mod(pkg)
    cfg = {"device": "cpu"} if pkg == "tpunode_torch" else {}
    monkeypatch.setattr(E_.VerifyEngine, "_warmup_fn",
                        _stub(exc=E_.BigShapeFailed("x:fake", "RuntimeError: out of memory")))
    seen = _Events(pkg)
    conf = E_.VerifyConfig(batch_size=64, device_batch=4096, **cfg)
    eng = E_.VerifyEngine(conf)
    eng._warmup_done.wait(30)
    stats = eng.stats()
    return {"state": eng.device_state, "device_batch": eng._device_batch,
            "cfg_device_batch": conf.device_batch, "kind": stats["device_kind"],
            "stats_batch": stats["device_batch"], "lane_target": eng._lane_target(),
            "events": [(e["state"], e.get("degraded_batch")) for e in seen.of("verify.device")]}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_big_shape_failure_degrades_device_batch_like_the_reference(pkg, monkeypatch):
    got = _big_shape_scenario(pkg, monkeypatch)
    assert got == _big_shape_scenario("tpunode", monkeypatch)
    assert got == {"state": "ready", "device_batch": 64, "cfg_device_batch": 4096,
                   "kind": "x:fake", "stats_batch": 64, "lane_target": 64,
                   "events": [("ready", 64)]}


def _failed_warmup_scenario(pkg: str, monkeypatch) -> dict:
    E_ = engine_mod(pkg)
    port = pkg == "tpunode_torch"
    cfg = {"device": "cpu"} if port else {"warmup_retry": 0.05}
    if port:  # the reference's config fields are the port's module constants
        monkeypatch.setattr(E_, "WARMUP_RETRY", 0.05)
    tries = []

    def boom(bs, db=0, **kw):
        tries.append(bs)
        raise RuntimeError("no device")

    monkeypatch.setattr(E_.VerifyEngine, "_warmup_fn", staticmethod(boom))
    eng = E_.VerifyEngine(E_.VerifyConfig(batch_size=8, device_batch=8, **cfg))
    eng._warmup_done.wait(30)
    first = (eng.device_state, eng.stats()["device_error"])
    time.sleep(0.06)
    try:  # re-probes, still fails
        picked = eng._pick(10**6)
    except RuntimeError as e:
        picked = str(e)
    eng._warmup_done.wait(30)
    if port:
        monkeypatch.setattr(E_, "WARMUP_RETRY", 60.0)
        monkeypatch.setattr(E_, "WARMUP_TIMEOUT", 5.0)
        cfg = {"device": "cpu"}
    else:
        cfg = {"warmup_timeout": 5}
    forced = E_.VerifyEngine(E_.VerifyConfig(backend="tpu", batch_size=8, device_batch=8,
                                             **cfg))
    with pytest.raises(RuntimeError, match="tpu backend unavailable: RuntimeError: no device"):
        forced.verify_sync(_items(pkg, 1)[0])
    return {"first": first, "picked": picked, "tries": len(tries), "state": eng.device_state}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_failed_warmup_reprobes_and_the_device_backends_raise(pkg, monkeypatch):
    """A failed warmup is re-probed after the retry interval, as the
    reference's is, and a forced "tpu" backend raises on both.  Where the
    reference serves "auto" on the cpu rung meanwhile, the port's raises."""
    got = _failed_warmup_scenario(pkg, monkeypatch)
    ref = _failed_warmup_scenario("tpunode", monkeypatch)
    assert {k: v for k, v in got.items() if k != "picked"} == {
        k: v for k, v in ref.items() if k != "picked"}
    assert ref["picked"] == "cpu"
    assert {**got, "picked": None} == {"first": ("failed", "RuntimeError: no device"),
                                       "picked": None, "tries": 3, "state": "failed"}
    if pkg == "tpunode_torch":
        assert got["picked"] == "tpu backend unavailable: RuntimeError: no device"


def test_real_warmup_runs_both_shapes_in_a_thread_and_holds_the_oracle(monkeypatch):
    shapes, threads = [], set()
    real = E.VerifyEngine._dispatch_chunk

    def spy(self, chunk, pad_to):
        shapes.append((len(chunk), pad_to))
        threads.add(threading.current_thread().name)
        return real(self, chunk, pad_to)

    monkeypatch.setattr(E.VerifyEngine, "_dispatch_chunk", spy)
    engine = E.VerifyEngine(E.VerifyConfig(device="cpu", batch_size=4, device_batch=16))
    assert engine.wait_warmup(120) == "ready"
    assert shapes == [(4, 4), (8, 16)] and threads == {"verify-warmup"}
    assert engine.stats()["device_kind"] == "cpu"


# -- no card, no stand-in ---------------------------------------------------------


def test_no_card_raises_for_the_device_backends_and_cpu_backends_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("auto", "tpu"):
        with pytest.raises(RuntimeError, match="CUDA"):
            E.VerifyEngine(E.VerifyConfig(backend=backend))
    items, expect = _items("tpunode_torch", 3, tamper_every=2)
    for backend in ("cpu", "oracle"):
        engine = E.VerifyEngine(E.VerifyConfig(backend=backend))
        assert engine.device is None and engine.device_state == "cold"
        assert engine.verify_sync(items) == expect and engine.last_rung == backend
    with pytest.raises(ValueError, match="backend"):
        E.VerifyConfig(backend="gpu")


# -- stats and the ledger ---------------------------------------------------------


async def _stats_scenario(pkg: str) -> dict:
    E_ = engine_mod(pkg)
    items, expect = _items(pkg, 6, tamper_every=5)
    eng = E_.VerifyEngine(E_.VerifyConfig(backend="cpu", max_wait=0.05, warmup=False))
    async with eng:
        got = await asyncio.wait_for(asyncio.gather(
            eng.verify(items[:2], priority="block"),
            eng.verify(items[2:5], priority="mempool", tenant="wallet"),
            eng.verify(items[5:], affinity=42)), 60)
        depth = eng.queue_depth()
        inflight = (eng.dispatch_inflight(), eng.dispatch_inflight_seconds())
    stats = eng.stats()
    ledger = eng.ledger()
    by_class = ledger["by_class"]
    return {
        "verdicts": [v for part in got for v in part] == expect,
        "stats_keys": sorted(stats),
        "breaker_keys": sorted(stats["breaker"]),
        "backlog": stats["backlog"],
        "depth": depth,
        "inflight": inflight,
        "ledger_keys": sorted(ledger),
        "classes": {p: (c["items"], sorted(c["rungs"])) for p, c in by_class.items()},
        "tenants": {t: v["items"] for t, v in ledger["by_tenant"].items()},
        "conserved": abs(ledger["busy_seconds"] - ledger["charged_seconds"]) <= 1e-5,
        "share": round(sum(c["share"] for c in by_class.values()), 2),
        "last_rung": eng.last_rung,
        "device_state": stats["device_state"],
    }


@pytest.mark.parametrize("pkg", PACKAGES)
async def test_stats_and_ledger_shape_match_the_reference(pkg):
    got = await _stats_scenario(pkg)
    assert got == await _stats_scenario("tpunode")
    assert got["verdicts"] and got["last_rung"] == "cpu" and got["device_state"] == "cold"
    assert got["classes"] == {"block": (2, ["cpu"]), "mempool": (3, ["cpu"]),
                              "bulk": (1, ["cpu"])}
    assert got["tenants"] == {"wallet": 3, "": 3} and got["conserved"] and got["share"] == 1.0
    assert {"ledger", "breaker", "backlog", "pipeline_depth", "failovers"} <= set(
        got["stats_keys"])


# -- the packed-row helpers the oracle rung needs ---------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_raw_batch_to_tuples_and_duck_typed_rows_match_the_reference(pkg):
    raw_mod = mod(pkg, "verify.raw")
    O = mod(pkg, "verify.ecdsa_cpu")
    items, expect = _items(pkg, 3, tamper_every=2)
    pub = items[0][0]
    items += [(None, 1, 2, 3), (pub, 5, 0, 1), (pub, 5, 7, 9, "schnorr"),
              (pub, 5, 7, 9, "bip340")]
    raw = raw_mod.pack_items(items)
    tuples = raw.to_tuples()
    view = [(None if t[0] is None else (t[0].x, t[0].y), *t[1:]) for t in tuples]
    ref_raw = mod("tpunode", "verify.raw")
    ref = ref_raw.pack_items(_items("tpunode", 3, tamper_every=2)[0] + [
        (None, 1, 2, 3), (pub, 5, 0, 1), (pub, 5, 7, 9, "schnorr"), (pub, 5, 7, 9, "bip340")])
    ref_view = [(None if t[0] is None else (t[0].x, t[0].y), *t[1:]) for t in ref.to_tuples()]
    assert view == ref_view
    assert view[3] == view[4] == (None, 0, 0, 0)  # degenerate rows
    assert [len(t) for t in tuples[5:]] == [5, 5] and tuples[6][4] == "bip340"
    assert O.verify_batch_cpu(tuples)[:3] == expect

    class Rows:  # a native extractor's row arrays
        px, py, z, r, s = raw.px, raw.py, raw.z, raw.r, raw.s
        present = list(raw.present)

    duck = raw_mod.as_raw_batch(Rows())
    assert isinstance(duck, raw_mod.RawBatch) and duck.present.dtype.name == "uint8"
    assert duck.to_tuples() == tuples and raw_mod.as_raw_batch(raw) is raw


@pytest.mark.parametrize("n", [1, 80, 257])
def test_cpu_rung_gives_the_reference_verdicts(n):
    from tpunode.verify.cpu_native import load_native_verifier as ref_loader
    from tpunode_torch.verify.cpu_native import load_native_verifier
    from tpunode_torch.verify.raw import pack_items

    items, expect = _items("tpunode_torch", n, tamper_every=7)
    raw = pack_items(items)
    assert load_native_verifier().verify_raw(raw) == expect == ref_loader().verify_raw(raw)
    engine = E.VerifyEngine(E.VerifyConfig(backend="cpu"))
    assert engine.verify_sync(items) == expect and engine.last_rung == "cpu"


# -- the launch counts ---------------------------------------------------------------


def test_launch_counts_lose_no_increment_across_threads():
    """Engine lanes launch from several dispatch threads: the counts are
    updated under a lock, so 8 threads counting at once lose nothing."""
    key = (*cuda_kernel.U32_MODES, )
    library, per_thread = cuda_kernel.U32_LIBRARY, 4000
    launches = dict(cuda_kernel.LAUNCHES)
    by_library = dict(cuda_kernel.LIBRARY_LAUNCHES)
    start = threading.Barrier(8)

    def count():
        start.wait(30)
        for i in range(per_thread):
            cuda_kernel.count_launch(library, key, "scan", i % 2 == 0)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=count) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        wb, form, reduce, select, sqr, mul = key
        for variant in cuda_kernel.VARIANTS:
            full = (wb, form, reduce, select, "scan", sqr, mul, variant)
            assert cuda_kernel.LAUNCHES[full] - launches[full] == 8 * per_thread // 2
            assert (cuda_kernel.LIBRARY_LAUNCHES[(library, variant)]
                    - by_library[(library, variant)]) == 8 * per_thread // 2
    finally:
        sys.setswitchinterval(interval)
        cuda_kernel.LAUNCHES.update(launches)
        cuda_kernel.LIBRARY_LAUNCHES.update(by_library)
