"""The port's verify engine on the CPU: chunking, warmup, modes, devices.

Small shapes stand in for the engine's real ones (``batch_size=4096``,
``device_batch=32768``): the chunking rule is the same at any size.
"""

import asyncio

import pytest
import torch

from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import engine as E
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.ecdsa_cpu import verify_batch_cpu
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

MODE_KNOBS = {
    "TPUNODE_FIELD_MUL": "dot_general",
    "TPUNODE_FIELD_SQR": "mul",
    "TPUNODE_FIELD_REDUCE": "eager",
    "TPUNODE_POINT_FORM": "affine",
    "TPUNODE_SELECT16": "onehot",
    "TPUNODE_POW_LADDER": "unroll",
}


@pytest.fixture(scope="module")
def warm():
    return E.warmup_items()


def _cpu_engine(batch_size=8, device_batch=8, warmup=False, **kw):
    return E.VerifyEngine(E.VerifyConfig(device="cpu", warmup=warmup, batch_size=batch_size,
                                         device_batch=device_batch, **kw))


def _recording_dispatch(monkeypatch, compute: bool):
    """Record each chunk's (size, pad); run it for real or return zeros."""
    calls = []
    real = E.dispatch_batch_gpu_raw

    def dispatch(raw, pad_to=None, device=None, window_bits=None):
        calls.append((len(raw), pad_to))
        if compute:
            return real(raw, pad_to=pad_to, device=device, window_bits=window_bits)
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
    items, expect = warm
    assert expect == verify_batch_cpu(items) and any(expect) and not all(expect)
    _cpu_engine(warmup=True)  # the plain program agrees with the oracle
    monkeypatch.setattr(E, "warmup_items", lambda: (items, [not v for v in expect]))
    with pytest.raises(RuntimeError, match="oracle"):
        _cpu_engine(warmup=True)


@pytest.mark.parametrize("knob", sorted(MODE_KNOBS))
def test_non_default_mode_raises(monkeypatch, knob):
    monkeypatch.setenv(knob, MODE_KNOBS[knob])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _cpu_engine()
    with pytest.raises(NotImplementedError, match=knob):
        K.kernel_modes()


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
    for knob in (*MODE_KNOBS, "TPUNODE_WINDOW_BITS"):
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
        K.verify_batch_gpu(warm[0])
    assert cuda_kernel.LAUNCHES == launches


async def test_async_submissions_coalesce_into_one_lane(monkeypatch, warm):
    items, expect = warm
    engine = _cpu_engine(max_wait=0.5)
    runs = []
    real = engine._run_gpu
    monkeypatch.setattr(engine, "_run_gpu", lambda raw: runs.append(len(raw)) or real(raw))
    async with engine:
        a, b, empty = await asyncio.wait_for(asyncio.gather(
            engine.verify(items[:3]), engine.verify_raw(pack_items(items[3:])),
            engine.verify([])), timeout=60)
    assert (a, b, empty) == (expect[:3], expect[3:], [])
    assert runs == [len(items)]


async def test_async_failure_reaches_every_waiter(monkeypatch, warm):
    engine = _cpu_engine(max_wait=0.2)

    def broken(raw):
        raise RuntimeError("device fault")

    monkeypatch.setattr(engine, "_run_gpu", broken)
    async with engine:
        got = await asyncio.wait_for(asyncio.gather(
            engine.verify(warm[0][:2]), engine.verify(warm[0][2:]), return_exceptions=True),
            timeout=60)
    assert [str(e) for e in got] == ["device fault", "device fault"]
    with pytest.raises(RuntimeError, match="not started"):
        await asyncio.wait_for(engine.verify(warm[0]), timeout=5)
