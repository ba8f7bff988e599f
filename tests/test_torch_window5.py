"""The port's 5-bit window mode against the reference's, at zero tolerance.

Digits, signs and limbs are integers and verdicts are booleans, so every
comparison is exact.  The reference's window width is a process global
(``kernel.set_kernel_modes``); every use of it here goes through
:func:`reference_width`, which restores it in ``finally``.  The reference's
Pallas kernel runs once, in interpret mode, in a module fixture.  The CUDA
kernel's 5-bit instantiations are held against the plain version in
test_torch_cuda.py.
"""

import contextlib
import ctypes
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from tpunode.verify import kernel as RK
from tpunode.verify import raw as RR
from tpunode.verify.pallas_kernel import verify_blocked as ref_verify_blocked
from tpunode_torch.verify import bounds as B
from tpunode_torch.verify import cpu_native, cuda_kernel
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

LANES = 16
PAD = 96
FIELDS = [name for name, _ in K._DEVICE_FIELDS]


@contextlib.contextmanager
def reference_width(wb: int):
    """The reference package at window width ``wb``, restored on exit."""
    prev = RK.set_kernel_modes(window_bits=wb)
    try:
        yield
    finally:
        RK.set_kernel_modes(window_bits=prev[2])


def _assert_same(ref, got):
    assert got.count == ref.count and got.schnorr_free == ref.schnorr_free
    for name, a, b in zip(FIELDS, ref.device_args, got.device_args):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


@pytest.fixture(scope="module")
def batch():
    """(items, the port's 5-bit prep, the reference kernel's 5-bit
    verdicts): the reference runs once, in interpret mode."""
    items = chip_smoke.adversarial_items(O, random.Random(0xBA7C), lanes=LANES)
    prep = K.prepare_batch_raw(pack_items(items), pad_to=LANES, window_bits=5)
    with reference_width(5):
        ref_prep = RK.prepare_batch(items, pad_to=LANES, native=False)
        out = ref_verify_blocked(*(jnp.asarray(a) for a in ref_prep.device_args),
                                 interpret=True, block=8)
        ref = [bool(v) for v in np.asarray(out)]
    return items, prep, ref


@pytest.fixture(scope="module")
def items():
    rng = random.Random(0x5B17)
    btc = chip_smoke.corrupt_every(chip_smoke.btc_pool(O, rng, 6, bip340=True), 2)
    return chip_smoke.adversarial_items(O, rng, lanes=68) + btc


def test_batch_is_5_bit_and_covers_every_lane_kind(batch):
    items, prep, ref = batch
    assert prep.window_bits == 5 and prep.d1a.shape == (27, LANES)
    assert ref == O.verify_batch_cpu(items)
    assert {it[4] for it in items if len(it) == 5} == {"schnorr", "bip340"}
    assert prep.r2_valid.any() and not prep.host_valid.all()
    assert any(ref) and not all(ref)


def test_python_prep_bit_identical_to_reference(items):
    with reference_width(5):
        ref = RK.prepare_batch(items, pad_to=PAD, native=False)
    got = K.prepare_batch(items, pad_to=PAD, window_bits=5)
    assert got.window_bits == 5
    _assert_same(ref, got)


def test_native_prep_bit_identical_to_reference(items):
    with reference_width(5):
        ref_native = RK.prepare_batch_raw(RR.pack_items(items), pad_to=PAD)
        ref_python = RK.prepare_batch(items, pad_to=PAD, native=False)
    got = K.prepare_batch_raw(pack_items(items), pad_to=PAD, window_bits=5)
    _assert_same(ref_native, got)
    _assert_same(ref_python, got)


def test_digits_that_straddle_word_edges_match_reference():
    """5-bit digits cover bits 60-64 and 125-129, across 64-bit words."""
    rng = random.Random(0x60)
    edges = [0x1F << 60, 0x1F << 125, (0x1F << 60) | (0x1F << 125), 1 << 64, 1 << 128,
             (1 << 135) - 1, 0b10101 << 60, 0b01011 << 125]
    vals = edges + [rng.getrandbits(135) for _ in range(24)]
    got = K._ints_to_digits_np(vals, 5)
    with reference_width(5):
        assert np.array_equal(got, RK._ints_to_digits_np(vals))
    want = [[(v >> (5 * (26 - j))) & 31 for j in range(27)] for v in vals]
    assert got.tolist() == want


def test_window_tables_match_reference():
    with reference_width(5):
        g5, lg5 = (np.asarray(t) for t in RK.window_tables()[:2])
    assert g5.shape == lg5.shape == (32, 3, 24)
    K.check_reference_tables(g5, lg5)
    for name, ours, ref in zip(("G", "λG"), K.window_tables(5), (g5, lg5)):
        assert np.array_equal(ours, ref), name
    bad = g5.copy()
    bad[31, 1, 7] += 1
    with pytest.raises(ValueError, match="5-bit G"):
        K.check_reference_tables(bad, lg5)
    with pytest.raises(ValueError):
        K.check_reference_tables(g5, np.asarray(RK.LG_TABLE))  # λG of the other width


def test_plain_verify_blocked_matches_reference_kernel(batch):
    _, prep, ref = batch
    launches = dict(cuda_kernel.LAUNCHES)
    args = K.from_reference(prep.device_args, "cpu")
    got = cuda_kernel.verify_blocked(*args, schnorr_free=prep.schnorr_free, select="tree",
                                     ladder="scan", sqr="half", mul="shift_add")
    assert got.dtype == torch.bool and got.tolist() == ref
    assert cuda_kernel.LAUNCHES == launches  # a CPU tensor never reaches the kernel


def test_schnorr_free_variant_matches_full_on_ecdsa_lanes(batch):
    items, _, _ = batch
    ecdsa = [it for it in items if len(it) == 4][:8]
    prep = K.prepare_batch(ecdsa, window_bits=5)
    assert prep.schnorr_free and prep.window_bits == 5
    args = K.from_reference(prep.device_args, "cpu")
    pruned = cuda_kernel.verify_blocked(*args, schnorr_free=True, select="tree", ladder="scan", sqr="half",
                                        mul="shift_add")
    full = cuda_kernel.verify_blocked(*args, schnorr_free=False, select="tree", ladder="scan", sqr="half",
                                      mul="shift_add")
    assert pruned.tolist() == full.tolist() == O.verify_batch_cpu(ecdsa)


def test_engine_slice_matches_reference_kernel(batch, monkeypatch):
    """The engine's own width wins over the knob: the width travels with
    the batch, so no global can flip between prep and dispatch."""
    items, _, ref = batch
    monkeypatch.setenv("TPUNODE_WINDOW_BITS", "4")
    rows = []
    real = K.verify_core

    def spy(*args, schnorr_free, point_form, reduce, select, ladder, sqr, mul):
        rows.append(args[0].shape[0])
        return real(*args, schnorr_free=schnorr_free, point_form=point_form, reduce=reduce,
                    select=select, ladder=ladder, sqr=sqr, mul=mul)

    monkeypatch.setattr(K, "verify_core", spy)
    monkeypatch.setattr(VerifyEngine, "_warmup_fn",
                        staticmethod(lambda bs, db=0, **kw: "cpu"))  # no warmup batch
    engine = VerifyEngine(VerifyConfig(device="cpu", window_bits=5, warmup=False,
                                       batch_size=LANES, device_batch=LANES))
    assert engine.verify_sync(items) == ref
    assert engine.verify_raw_sync(pack_items(items)) == ref
    assert rows == [27, 27]


def test_digit_rows_of_one_width_with_the_other_raise(batch):
    items, prep5, _ = batch
    prep4 = K.prepare_batch_raw(pack_items(items), pad_to=LANES, window_bits=4)
    mixed = list(prep4.device_args)
    mixed[2] = prep5.d2a  # 27 rows among 33-row digit arrays
    with pytest.raises(ValueError, match="digit rows"):
        K.from_reference(mixed, "cpu")
    args = list(K.from_reference(prep4.device_args, "cpu"))
    args[2] = torch.from_numpy(prep5.d2a)
    with pytest.raises(ValueError, match="digit rows"):
        cuda_kernel.verify_blocked(*args, schnorr_free=False, select="tree", ladder="scan", sqr="half",
                                   mul="shift_add")
    with pytest.raises(ValueError, match="digit rows"):
        K.verify_core(*args, schnorr_free=False, select="tree", ladder="scan", sqr="half",
                      mul="shift_add")
    with pytest.raises(ValueError, match="digit rows"):
        K.digit_rows_width(np.zeros((32, 4)))


def test_other_widths_raise():
    items = chip_smoke.btc_pool(O, random.Random(6), 1, bip340=False)
    for wb in (3, 6):
        with pytest.raises(ValueError):
            K.prepare_batch(items, window_bits=wb)
        with pytest.raises(ValueError):
            K.prepare_batch_raw(pack_items(items), window_bits=wb)
        with pytest.raises(ValueError):
            cpu_native.load_native_verifier().prepare_batch_arrays(pack_items(items), 4, wb)
        with pytest.raises(ValueError):
            K.window_tables(wb)


def test_native_library_without_the_width_aware_prep_raises(monkeypatch):
    class Fn:
        pass

    class OldLibrary:  # has secp_verify_batch, lacks secp_prepare_batch_w
        def __init__(self, path):
            self.secp_verify_batch = Fn()

    monkeypatch.setattr(ctypes, "CDLL", OldLibrary)
    with pytest.raises(RuntimeError, match="make -C native"):
        cpu_native.NativeVerifier("libsecp_cpu.so")


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
def test_bound_replay_covers_the_30_add_table_chain(reduce):
    """Replay the 5-bit Q table's 30 sequential adds, the λ scaling and a
    window round of 5 doublings: every step stays inside int32 and every
    coordinate inside the 2^13 closure, and the chain's peak is the
    per-formula closure's own pt_add peak."""
    got = B.audit_window_program(5, reduce=reduce)
    assert got["q_table_adds"] == 30
    assert max(got["q_table"], got["lambda_x"], got["window_round"]) <= B.COORD_BOUND
    per_formula = B.audit_formulas(reduce)
    assert got["q_table"] <= per_formula["pt_add"]
    assert got["window_round"] == max(per_formula["pt_add"], per_formula["pt_double"])
    assert B.audit_window_program(4, reduce=reduce)["q_table_adds"] == 14
    B.assert_formulas_safe(reduce, window_bits=5)
    assert (reduce, 5, "projective", "scan") in B._AUDITED
