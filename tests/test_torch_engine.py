"""The port's verify engine on the CPU: chunking, warmup, modes, devices.

Small shapes stand in for the engine's real ones (``batch_size=4096``,
``device_batch=32768``): the chunking rule is the same at any size.
"""

import asyncio
import threading

import pytest
import torch

from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import engine as E
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.ecdsa_cpu import verify_batch_cpu
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

# The reference's knob values that the port ran last (each raised
# NotImplementedError until its ROADMAP port-queue item was done), with
# their place in the mode tuple.
MODE_KNOBS = {
    "TPUNODE_FIELD_MUL": ("dot_general", 0),
}
# Every knob of the mode tuple, with a value that names no mode.
UNKNOWN_MODES = {
    "TPUNODE_FIELD_MUL": "bogus",
    "TPUNODE_FIELD_SQR": "half2",
    "TPUNODE_FIELD_REDUCE": "lazier",
    "TPUNODE_POINT_FORM": "affine2",
    "TPUNODE_SELECT16": "x",
    "TPUNODE_POW_LADDER": "unrol",
}


@pytest.fixture(scope="module")
def warm():
    return E.warmup_items()


class _ReadyEngine(E.VerifyEngine):
    """An engine whose warmup (the test seam) only reports the device
    ready, so no warmup batch reaches a test's spies."""

    _warmup_fn = staticmethod(lambda bs, db=0, **kw: "cpu")


def _cpu_engine(batch_size=8, device_batch=8, warmup=False, **kw):
    """A device-rung engine on the plain program.  With ``warmup`` the
    real warmup runs and is waited for; without, the stub's."""
    cls = E.VerifyEngine if warmup else _ReadyEngine
    engine = cls(E.VerifyConfig(device="cpu", warmup=True,
                                batch_size=batch_size, device_batch=device_batch, **kw))
    assert engine.wait_warmup(120) in ("ready", "failed")
    return engine


def _recording_dispatch(monkeypatch, compute: bool):
    """Record each chunk's (size, pad); run it for real or return zeros."""
    calls = []
    real = E.dispatch_batch_gpu_raw

    def dispatch(raw, pad_to=None, device=None, window_bits=None, point_form=None,
                 reduce=None, select=None, ladder=None, sqr=None, mul=None):
        calls.append((len(raw), pad_to))
        if compute:
            return real(raw, pad_to=pad_to, device=device, window_bits=window_bits,
                        point_form=point_form, reduce=reduce, select=select,
                        ladder=ladder, sqr=sqr, mul=mul)
        return torch.zeros(pad_to, dtype=torch.bool), len(raw)

    monkeypatch.setattr(E, "dispatch_batch_gpu_raw", dispatch)
    return calls


def test_chunks_verify_through_the_plain_program(monkeypatch, warm):
    items, expect = warm
    items, expect = items + items[:3], expect + expect[:3]
    calls = _recording_dispatch(monkeypatch, compute=True)
    assert _cpu_engine(batch_size=4, device_batch=8).verify_sync(items) == expect
    assert calls == [(8, 8), (3, 4)]


@pytest.mark.parametrize("n, chunks", [
    (1, [(1, 4)]), (4, [(4, 4)]), (5, [(5, 8)]), (8, [(8, 8)]),
    (9, [(8, 8), (1, 4)]), (21, [(8, 8), (8, 8), (5, 8)]),
])
def test_chunk_at_device_batch_and_pad_tails_to_batch_size(monkeypatch, warm, n, chunks):
    calls = _recording_dispatch(monkeypatch, compute=False)
    items = (warm[0] * 3)[:n]
    assert len(_cpu_engine(batch_size=4, device_batch=8).verify_sync(items)) == n
    assert calls == chunks


def test_config_keeps_device_batch_at_least_batch_size():
    cfg = E.VerifyConfig(batch_size=64, device_batch=16, device="cpu")
    assert cfg.device_batch == 64
    assert (E.VerifyConfig().batch_size, E.VerifyConfig().device_batch) == (4096, 32768)
    with pytest.raises(ValueError):
        E.VerifyConfig(batch_size=0)


def test_warmup_checks_the_oracle_and_raises_on_mismatch(monkeypatch, warm):
    """The background warmup holds its verdicts against the oracle: on a
    mismatch the device is ``failed`` and the forced device rung raises
    with the warmup's error."""
    items, expect = warm
    assert expect == verify_batch_cpu(items) and any(expect) and not all(expect)
    assert _cpu_engine(warmup=True).device_state == "ready"  # the plain program agrees
    monkeypatch.setattr(E, "warmup_items", lambda: (items, [not v for v in expect]))
    engine = _cpu_engine(warmup=True)
    assert engine.device_state == "failed" and "oracle" in engine.stats()["device_error"]
    with pytest.raises(RuntimeError, match="oracle"):
        engine.verify_sync(items)


@pytest.mark.parametrize("knob", sorted(MODE_KNOBS))
def test_non_default_mode_raises(monkeypatch, knob):
    """No knob value of the reference raises any more: the last of them
    builds a CPU engine that reports it, as the mode tuple does."""
    value, index = MODE_KNOBS[knob]
    monkeypatch.setenv(knob, value)
    engine = _cpu_engine()
    assert engine.modes()[index] == K.kernel_modes()[index] == value
    assert engine.cfg.field_mul == value


@pytest.mark.parametrize("ladder", ["scan", "unroll"])
def test_ladder_knob_is_read_once_at_construction_and_passed_down(monkeypatch, warm, ladder):
    """TPUNODE_POW_LADDER runs both of its values: an engine built under it
    keeps it as ``engine.ladder``, reports it in its modes and passes it to
    every dispatch, down to the plain program; a later change of the
    environment, even to a value that names no mode, reaches no built
    engine."""
    ladders = []
    real = K.verify_core

    def spy(*args, schnorr_free, point_form, reduce, select, ladder, sqr, mul):
        ladders.append(ladder)
        return real(*args, schnorr_free=schnorr_free, point_form=point_form, reduce=reduce,
                    select=select, ladder=ladder, sqr=sqr, mul=mul)

    monkeypatch.setattr(K, "verify_core", spy)
    monkeypatch.setenv("TPUNODE_POW_LADDER", ladder)
    assert K.pow_ladder_mode() == ladder and K.kernel_modes()[5] == ladder
    engine = _cpu_engine(warmup=True)  # one shape, 8 lanes
    assert engine.ladder == ladder and engine.modes()[5] == ladder and ladders == [ladder]
    monkeypatch.setenv("TPUNODE_POW_LADDER", "unrol")
    items, expect = warm
    assert engine.verify_sync(items) == expect and ladders == [ladder] * 2
    monkeypatch.delenv("TPUNODE_POW_LADDER")
    assert _cpu_engine().ladder == "scan" and K.kernel_modes()[5] == "scan"
    assert K.kernel_modes(4, "projective", "lazy", "tree", "unroll")[5] == "unroll"


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_sqr_knob_and_config_field_are_read_once_and_passed_down(monkeypatch, warm, sqr):
    """TPUNODE_FIELD_SQR runs both of its values: VerifyConfig.field_sqr
    takes the knob when None, at construction, and its own value over the
    knob's; the engine reports it in its modes and passes it to every
    dispatch, down to the plain program; a later change of the
    environment, even to a value that names no mode, reaches no built
    engine."""
    sqrs = []
    real = K.verify_core

    def spy(*args, schnorr_free, point_form, reduce, select, ladder, sqr, mul):
        sqrs.append(sqr)
        return real(*args, schnorr_free=schnorr_free, point_form=point_form, reduce=reduce,
                    select=select, ladder=ladder, sqr=sqr, mul=mul)

    monkeypatch.setattr(K, "verify_core", spy)
    monkeypatch.setenv("TPUNODE_FIELD_SQR", sqr)
    assert K.kernel_modes()[1] == sqr
    engine = _cpu_engine(warmup=True)  # one shape, 8 lanes
    assert engine.cfg.field_sqr == sqr and engine.modes()[1] == sqr and sqrs == [sqr]
    monkeypatch.setenv("TPUNODE_FIELD_SQR", "full")
    items, expect = warm
    assert engine.verify_sync(items) == expect and sqrs == [sqr] * 2
    other = "half" if sqr == "mul" else "mul"
    monkeypatch.setenv("TPUNODE_FIELD_SQR", sqr)
    assert _cpu_engine(field_sqr=other).verify_sync(items[:2]) == expect[:2]
    assert sqrs == [sqr] * 2 + [other]
    monkeypatch.delenv("TPUNODE_FIELD_SQR")
    assert E.VerifyConfig().field_sqr == "half" and K.kernel_modes()[1] == "half"


@pytest.mark.parametrize("knob", sorted(UNKNOWN_MODES))
def test_knob_value_naming_no_mode_raises_value_error(monkeypatch, knob):
    """As the reference's field._env_mode: a value outside the knob's tuple
    is a ValueError naming the knob, from the mode tuple and the engine."""
    monkeypatch.setenv(knob, UNKNOWN_MODES[knob])
    with pytest.raises(ValueError, match=knob):
        K.kernel_modes()
    with pytest.raises(ValueError, match=knob):
        _cpu_engine()


def test_point_form_knob_runs_affine_and_the_config_wins(monkeypatch):
    monkeypatch.setenv("TPUNODE_POINT_FORM", "affine")
    assert E.VerifyConfig().point_form == "affine"
    assert K.kernel_modes()[3] == "affine"
    assert _cpu_engine().cfg.point_form == "affine"
    assert E.VerifyConfig(point_form="projective").point_form == "projective"
    assert K.kernel_modes(4, "projective")[3] == "projective"
    monkeypatch.setenv("TPUNODE_POINT_FORM", "projective")
    assert E.VerifyConfig(point_form="affine").point_form == "affine"
    monkeypatch.delenv("TPUNODE_POINT_FORM")
    assert E.VerifyConfig().point_form == "projective"
    with pytest.raises(ValueError, match="point form"):
        E.VerifyConfig(point_form="affine2")
    with pytest.raises(ValueError, match="point form"):
        K.kernel_modes(4, "jacobian")


def test_reduce_knob_runs_eager_and_the_config_wins(monkeypatch):
    """TPUNODE_FIELD_REDUCE=eager runs: the engine takes it when its config
    names no reduction, dispatches it, and kernel_modes reports it; the
    config's own value wins over the knob, and the mode of a call wins in
    kernel_modes."""
    reduces = []
    real = K.verify_core

    def spy(*args, schnorr_free, point_form, reduce, select, ladder, sqr, mul):
        reduces.append(reduce)
        return real(*args, schnorr_free=schnorr_free, point_form=point_form, reduce=reduce,
                    select=select, ladder=ladder, sqr=sqr, mul=mul)

    monkeypatch.setattr(K, "verify_core", spy)
    monkeypatch.setenv("TPUNODE_FIELD_REDUCE", "eager")
    assert K.kernel_modes()[2] == "eager"
    engine = _cpu_engine(warmup=True)
    assert engine.cfg.field_reduce == "eager" and reduces == ["eager"]  # one shape, 8 lanes
    items, expect = E.warmup_items()
    assert engine.verify_sync(items) == expect and reduces == ["eager"] * 2
    assert E.VerifyConfig(field_reduce="lazy").field_reduce == "lazy"
    assert K.kernel_modes(4, "projective", "lazy")[2] == "lazy"
    monkeypatch.setenv("TPUNODE_FIELD_REDUCE", "lazy")
    assert E.VerifyConfig(field_reduce="eager").field_reduce == "eager"
    monkeypatch.delenv("TPUNODE_FIELD_REDUCE")
    assert E.VerifyConfig().field_reduce == "lazy" and K.kernel_modes()[2] == "lazy"
    assert K.kernel_modes(5, "affine", "eager")[2:4] == ("eager", "affine")


def test_reduce_value_naming_no_mode_raises_value_error(monkeypatch):
    """The config, the mode tuple and the launcher each refuse a reduction
    outside field.REDUCE_MODES; none runs the default in its place.  The
    config has a field for the multiply formulation, as for its square."""
    monkeypatch.delenv("TPUNODE_FIELD_REDUCE", raising=False)
    with pytest.raises(ValueError, match="reduce mode"):
        E.VerifyConfig(field_reduce="bogus")
    with pytest.raises(ValueError, match="reduce mode"):
        K.kernel_modes(4, "projective", "Eager")
    items = E.warmup_items()[0]
    args = K.from_reference(K.prepare_batch_raw(pack_items(items[:4])).device_args, "cpu")
    with pytest.raises(ValueError, match="reduce mode"):
        cuda_kernel.verify_blocked(*args, schnorr_free=False, reduce="eagre", select="tree",
                                   ladder="scan", sqr="half", mul="shift_add")
    with pytest.raises(ValueError, match="reduce mode"):
        K.verify_batch_gpu(items[:4], device="cpu", reduce="", select="tree", ladder="scan",
                           sqr="half", mul="shift_add")
    assert "field_mul" in E.VerifyConfig.__dataclass_fields__
    assert "field_sqr" in E.VerifyConfig.__dataclass_fields__


@pytest.mark.parametrize("value", ["6", "3", "five"])
def test_window_bits_outside_4_and_5_raises(monkeypatch, value):
    monkeypatch.setenv("TPUNODE_WINDOW_BITS", value)
    with pytest.raises(ValueError, match="TPUNODE_WINDOW_BITS"):
        K.kernel_modes()
    with pytest.raises(ValueError, match="TPUNODE_WINDOW_BITS"):
        _cpu_engine()
    monkeypatch.delenv("TPUNODE_WINDOW_BITS")
    with pytest.raises(ValueError, match="window_bits"):
        E.VerifyConfig(device="cpu", window_bits=int(value) if value.isdigit() else value)


def test_default_modes_are_the_reference_defaults(monkeypatch):
    for knob in (*UNKNOWN_MODES, "TPUNODE_WINDOW_BITS"):
        monkeypatch.delenv(knob, raising=False)
    assert K.kernel_modes() == ("shift_add", "half", "lazy", "projective", "tree", "scan", 4)
    assert E.VerifyConfig().window_bits == 4
    assert K.kernel_modes(5)[-1] == 5  # the width in effect, not the knob's
    for wb in ("4", "5"):
        monkeypatch.setenv("TPUNODE_WINDOW_BITS", wb)
        assert K.kernel_modes()[-1] == E.VerifyConfig().window_bits == int(wb)
    assert E.VerifyConfig(window_bits=4).window_bits == 4  # the config's own width wins


def test_default_device_without_a_card_raises(monkeypatch, warm):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def plain_must_not_run(*a, **kw):
        raise AssertionError("the plain version ran for a device that was not the CPU")

    monkeypatch.setattr(K, "verify_core", plain_must_not_run)
    launches = dict(cuda_kernel.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA"):
        E.VerifyEngine(E.VerifyConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        E.VerifyEngine(E.VerifyConfig(warmup=False))
    with pytest.raises(RuntimeError, match="CUDA"):
        E.VerifyEngine(E.VerifyConfig(backend="tpu", warmup=False))
    with pytest.raises(RuntimeError, match="CUDA"):
        K.verify_batch_gpu(warm[0], select="tree", ladder="scan", sqr="half", mul="shift_add")
    assert cuda_kernel.LAUNCHES == launches


async def test_async_submissions_coalesce_into_one_lane(monkeypatch, warm):
    items, expect = warm
    engine = _cpu_engine(max_wait=0.5)
    runs = []
    real = engine._run_tpu
    monkeypatch.setattr(engine, "_run_tpu",
                        lambda payloads: runs.append(sum(map(len, payloads))) or real(payloads))
    async with engine:
        a, b, empty = await asyncio.wait_for(asyncio.gather(
            engine.verify(items[:3]), engine.verify_raw(pack_items(items[3:])),
            engine.verify([])), timeout=60)
    assert (a, b, empty) == (expect[:3], expect[3:], [])
    assert runs == [len(items)]


async def test_async_failure_reaches_every_waiter(monkeypatch, warm):
    engine = _cpu_engine(max_wait=0.2)

    def broken(payloads):
        raise RuntimeError("device fault")

    monkeypatch.setattr(engine, "_run_tpu", broken)
    async with engine:
        got = await asyncio.wait_for(asyncio.gather(
            engine.verify(warm[0][:2]), engine.verify(warm[0][2:]), return_exceptions=True),
            timeout=60)
    assert [str(e) for e in got] == ["device fault", "device fault"]
    with pytest.raises(RuntimeError, match="not started"):
        await asyncio.wait_for(engine.verify(warm[0]), timeout=5)


async def test_async_verify_packs_off_the_event_loop(monkeypatch, warm):
    """``await engine.verify(items)`` queues the tuples as they are; the
    dispatch thread packs them into rows, so a large submission never
    blocks the event loop.  ``verify_sync`` packs in its caller's thread,
    as the reference's does.  The verdicts are the oracle's either way."""
    items, expect = warm
    threads = []
    real = E.as_raw_batch

    def spy(obj):
        threads.append(threading.get_ident())
        return real(obj)

    monkeypatch.setattr(E, "as_raw_batch", spy)
    engine = _cpu_engine(max_wait=0.0)
    loop_thread = threading.get_ident()
    async with engine:
        got = await asyncio.wait_for(engine.verify(items), timeout=60)
    assert got == expect == verify_batch_cpu(items)
    assert threads and loop_thread not in threads
    threads.clear()
    assert engine.verify_sync(items) == expect
    assert threads == [threading.get_ident()]
