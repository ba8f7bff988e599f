"""The port's affine point form against the reference's, at 5-bit windows.

The 5-bit counterpart of test_torch_affine.py (full variant): 32-entry
affine tables, a 30-entry batch inversion, 27 rounds of mixed adds.  The
reference's window width and point form are process globals
(``kernel.set_kernel_modes``, ``curve.set_point_form``); every use of them
here goes through :func:`reference_modes`, which restores both in
``finally``.  The reference's Pallas kernel runs once, in interpret mode, in
a module fixture.  Verdicts are booleans and limbs integers: tolerance zero.
"""

import contextlib
import random

import pytest
import torch

import chip_smoke
from tests.test_torch_affine import (
    check_affine_table,
    port_verdicts,
    reference_affine_verdicts,
    run_campaign_cli,
    table_points,
)
from tpunode.verify import curve as RC
from tpunode.verify import kernel as RK
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine

torch.set_num_threads(1)

LANES = 16


@contextlib.contextmanager
def reference_modes(wb: int, form: str):
    """The reference package at window width ``wb`` in point form ``form``,
    both restored on exit."""
    prev_width = RK.set_kernel_modes(window_bits=wb)[2]
    try:
        prev_form = RC.set_point_form(form)
        try:
            yield
        finally:
            RC.set_point_form(prev_form)
    finally:
        RK.set_kernel_modes(window_bits=prev_width)


@pytest.fixture(scope="module")
def items():
    return chip_smoke.adversarial_items(O, random.Random(0xAF5), lanes=LANES)


@pytest.fixture(scope="module")
def ref_full(items):
    with reference_modes(5, "affine"):
        return reference_affine_verdicts(items, schnorr_free=False)


def test_reference_modes_restore_the_globals():
    before = (RK.window_bits(), RC.point_form())
    with pytest.raises(RuntimeError):
        with reference_modes(5, "affine"):
            assert (RK.window_bits(), RC.point_form()) == (5, "affine")
            raise RuntimeError
    assert (RK.window_bits(), RC.point_form()) == before


def test_affine_q_table_matches_the_pallas_order_at_5_bit():
    """32 entries: a 30-entry Z column, 29 prefix products, 30 suffix
    steps, entry 2's multiply by one included."""
    with reference_modes(5, "affine"):
        check_affine_table(table_points(random.Random(0x7A5), 3), 5)


def test_batch_is_5_bit_and_covers_every_lane_kind(items, ref_full):
    prep = K.prepare_batch(items, pad_to=LANES, window_bits=5)
    assert prep.window_bits == 5 and not prep.schnorr_free
    assert ref_full == O.verify_batch_cpu(items)
    assert {it[4] for it in items if len(it) == 5} == {"schnorr", "bip340"}
    assert any(ref_full) and not all(ref_full)


def test_plain_affine_verify_matches_reference_kernel_at_5_bit(items, ref_full):
    got = port_verdicts(items, 5, "affine")
    assert got == ref_full == port_verdicts(items, 5, "projective") == O.verify_batch_cpu(items)


def test_affine_engine_at_5_bit_on_the_cpu(items, ref_full, monkeypatch):
    monkeypatch.setenv("TPUNODE_WINDOW_BITS", "4")
    monkeypatch.setenv("TPUNODE_POINT_FORM", "projective")
    rows = []
    real = K.verify_core

    def spy(*args, schnorr_free, point_form, reduce, select, ladder, sqr, mul):
        rows.append((args[0].shape[0], point_form))
        return real(*args, schnorr_free=schnorr_free, point_form=point_form, reduce=reduce,
                    select=select, ladder=ladder, sqr=sqr, mul=mul)

    monkeypatch.setattr(K, "verify_core", spy)
    monkeypatch.setattr(VerifyEngine, "_warmup_fn",
                        staticmethod(lambda bs, db=0, **kw: "cpu"))  # no warmup batch
    engine = VerifyEngine(VerifyConfig(device="cpu", window_bits=5, point_form="affine",
                                       warmup=False, batch_size=LANES, device_batch=LANES))
    assert engine.verify_sync(items) == ref_full
    assert rows == [(27, "affine")]


def test_campaign_cli_in_the_affine_form_at_5_bit():
    res = run_campaign_cli(5)
    assert (res["mismatches"], res["items"], res["window_bits"], res["point_form"]) == (
        0, 21, 5, "affine")
