"""The port's host prep against the reference: bit-identical device arrays.

``prepare_batch`` (Python) and ``prepare_batch_raw`` (native
``secp_prepare_batch``) must give the reference's ``device_args`` exactly,
on adversarial items of every algorithm; the constant window tables and the
GLV / limb / digit helpers must equal the reference's.
"""

import random

import numpy as np
import pytest
import torch

import chip_smoke
from tpunode.verify import kernel as RK
from tpunode.verify import raw as RR
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify import raw as R

torch.set_num_threads(1)

PAD = 96
FIELDS = [name for name, _ in K._DEVICE_FIELDS]


@pytest.fixture(scope="module")
def items():
    rng = random.Random(0x9E9)
    btc = chip_smoke.corrupt_every(chip_smoke.btc_pool(O, rng, 6, bip340=True), 2)
    return chip_smoke.adversarial_items(O, rng, lanes=68) + btc


def _assert_same(ref, got):
    assert got.count == ref.count
    assert got.schnorr_free == ref.schnorr_free
    for name, a, b in zip(FIELDS, ref.device_args, got.device_args):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


def test_python_prep_bit_identical_to_reference(items):
    _assert_same(RK.prepare_batch(items, pad_to=PAD, native=False),
                 K.prepare_batch(items, pad_to=PAD))


def test_native_raw_prep_bit_identical_to_reference(items):
    _assert_same(RK.prepare_batch_raw(RR.pack_items(items), pad_to=PAD),
                 K.prepare_batch_raw(R.pack_items(items), pad_to=PAD))


def test_python_and_native_prep_agree_and_flag_the_variant(items):
    _assert_same(K.prepare_batch(items, pad_to=PAD),
                 K.prepare_batch_raw(R.pack_items(items), pad_to=PAD))
    ecdsa = [it for it in items if len(it) == 4]
    assert K.prepare_batch(ecdsa).schnorr_free
    assert not K.prepare_batch(items).schnorr_free
    with pytest.raises(ValueError):
        K.prepare_batch(items, pad_to=len(items) - 1)


def test_pack_items_matches_reference(items):
    ref, got = RR.pack_items(items), R.pack_items(items)
    for name in ("px", "py", "z", "r", "s", "present"):
        assert np.array_equal(getattr(ref, name), getattr(got, name)), name
    both = R.concat_raw([got.slice(0, 5), got.slice(5, len(got))])
    assert np.array_equal(both.present, got.present) and len(both) == len(items)


def test_constant_tables_match_reference():
    K.check_reference_tables(np.asarray(RK.G_TABLE), np.asarray(RK.LG_TABLE))
    bad = np.asarray(RK.G_TABLE).copy()
    bad[3, 0, 5] += 1
    with pytest.raises(ValueError):
        K.check_reference_tables(bad, np.asarray(RK.LG_TABLE))


def test_glv_split_and_conversions_match_reference():
    rng = random.Random(0x61)
    ks = [0, 1, O.CURVE_N - 1, K.LAMBDA] + [rng.getrandbits(256) for _ in range(32)]
    for k in ks:
        assert K.glv_split(k) == RK.glv_split(k)
        k1, k2 = K.glv_split(k)
        assert (k1 + k2 * K.LAMBDA - k) % O.CURVE_N == 0
    vals = [rng.getrandbits(256) for _ in range(16)]
    assert np.array_equal(K._ints_to_limbs_np(vals), RK._ints_to_limbs_np(vals))
    halves = [rng.getrandbits(130) for _ in range(16)]
    assert np.array_equal(K._ints_to_digits_np(halves), RK._ints_to_digits_np(halves))
    ss = [rng.getrandbits(256) % O.CURVE_N or 1 for _ in range(9)]
    assert K._batch_inverse_mod_n(ss) == RK._batch_inverse_mod_n(ss)


def test_from_reference_converts_and_validates(items):
    ref = RK.prepare_batch(items, pad_to=PAD, native=False)
    args = K.from_reference(ref.device_args, "cpu")
    for (name, nd), t, a in zip(K._DEVICE_FIELDS, args, ref.device_args):
        assert t.dtype == (torch.int32 if nd == 2 else torch.bool), name
        assert np.array_equal(t.numpy(), np.asarray(a)), name
    with pytest.raises(ValueError):
        K.from_reference(ref.device_args[:-1], "cpu")
    short = list(ref.device_args)
    short[0] = short[0][:-1]
    with pytest.raises(ValueError):
        K.from_reference(short, "cpu")
