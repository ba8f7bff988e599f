"""The port's plain field (tpunode_torch.verify.field) against the reference.

Every op must return the reference's exact limb vectors — not merely equal
mod p — on contract-edge operands: canonical values, negative loose limbs
(a - b), reduced products, and products scaled by 8 (a fat top limb).  The
reference is both ``tpunode.verify.field`` and the Pallas kernel's
``tpunode.verify.pallas_field``.  Integers, so the tolerance is zero.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpunode.verify import field as RF
from tpunode.verify import pallas_field as RPF
from tpunode_torch.verify import field as F

torch.set_num_threads(1)

B = 8
rng = random.Random(0xF1E1D)


def _limbs(vals) -> np.ndarray:
    return np.stack([F.to_limbs(v) for v in vals], axis=1)


@pytest.fixture(scope="module")
def operands() -> dict:
    """Named (24, B) int32 operand sets and the contract each satisfies:
    "t" = mul_t's (every |limb| <= 2^13), "m" = mul's (non-top <= 2^19,
    top <= 2^15)."""
    a = [rng.getrandbits(256) % F.P for _ in range(B)]
    b = [rng.getrandbits(256) % F.P for _ in range(B)]
    canon = _limbs(a)
    neg = _limbs([3] * B) - _limbs(b)
    prod = np.asarray(RF.mul(jnp.asarray(canon), jnp.asarray(_limbs(b))))
    nprng = np.random.default_rng(0xF1E1D)
    loose = nprng.integers(-(1 << 13), 1 << 13, size=(24, B), dtype=np.int32)
    return {
        "canonical": ("t", canon),
        "negative": ("t", neg.astype(np.int32)),
        "product": ("t", prod),
        "loose": ("t", loose),
        "fat_top": ("m", prod * 8),
    }


def _pairs(operands, contract):
    """Each admissible operand set against itself and against the next."""
    arrs = [a for c, a in operands.values() if contract == "m" or c == "t"]
    return list(zip(arrs, arrs)) + list(zip(arrs, arrs[1:] + arrs[:1]))


def _both(ref_fn, port_fn, *arrays):
    ref = np.asarray(ref_fn(*(jnp.asarray(a) for a in arrays)))
    got = port_fn(*(torch.from_numpy(np.array(a)) for a in arrays)).numpy()
    return ref, got


BINARY = {"mul": "m", "mul_t": "t", "mul_wide": "m", "mul_t_wide": "t"}
UNARY = {"sqr": "m", "sqr_t": "t", "sqr_wide": "m", "sqr_t_wide": "t",
         "canonical": "t", "tighten": "m"}


@pytest.mark.parametrize("name", sorted(BINARY))
@pytest.mark.parametrize("ref", [RF, RPF], ids=["field", "pallas_field"])
def test_binary_op_matches_reference(operands, name, ref):
    for a, b in _pairs(operands, BINARY[name]):
        want, got = _both(getattr(ref, name), getattr(F, name), a, b)
        assert got.dtype == np.int32 and np.array_equal(want, got), name


@pytest.mark.parametrize("name", sorted(UNARY))
@pytest.mark.parametrize("ref", [RF, RPF], ids=["field", "pallas_field"])
def test_unary_op_matches_reference(operands, name, ref):
    for contract, a in operands.values():
        if UNARY[name] == "t" and contract != "t":
            continue
        want, got = _both(getattr(ref, name), getattr(F, name), a)
        assert np.array_equal(want, got), name


@pytest.mark.parametrize("ref", [RF, RPF], ids=["field", "pallas_field"])
def test_mul_small_red_matches_reference(operands, ref):
    for _, a in operands.values():
        for k in (21, 8, 3):
            want, got = _both(lambda x: ref.mul_small_red(x, k),
                              lambda x: F.mul_small_red(x, k), a)
            assert np.array_equal(want, got)


@pytest.mark.parametrize("ref", [RF, RPF], ids=["field", "pallas_field"])
@pytest.mark.parametrize("tail", ["reduce_wide", "reduce_wide_loose"])
def test_lazy_wide_api_matches_reference(operands, ref, tail):
    """Accumulated wides (sums and differences of products) reduce to the
    reference's limbs through both tails."""
    pairs = _pairs(operands, "t")
    for (a, b), (c, d) in zip(pairs, pairs[1:] + pairs[:1]):
        w_ref = ref.acc_add(ref.mul_t_wide(jnp.asarray(a), jnp.asarray(b)),
                            ref.sqr_t_wide(jnp.asarray(c)))
        w_ref = w_ref - ref.mul_t_wide(jnp.asarray(d), jnp.asarray(a))
        ta, tb, tc, td = (torch.from_numpy(np.array(x)) for x in (a, b, c, d))
        w = F.acc_add(F.mul_t_wide(ta, tb), F.sqr_t_wide(tc)) - F.mul_t_wide(td, ta)
        assert np.array_equal(np.asarray(w_ref), w.numpy())
        want = np.asarray(getattr(ref, tail)(w_ref))
        assert np.array_equal(want, getattr(F, tail)(w).numpy())


@pytest.mark.parametrize("ref", [RF, RPF], ids=["field", "pallas_field"])
def test_is_zero_and_eq_match_reference(operands, ref):
    canon = operands["canonical"][1]
    p_plus = canon + _limbs([F.P] * B)  # ≡ canon (mod p), loose limbs
    zero_ish = _limbs([F.P] * B) - _limbs([0] * B)
    for a, b in ((canon, p_plus), (canon, operands["negative"][1]), (zero_ish, canon)):
        want, got = _both(ref.eq, F.eq, a, b)
        assert np.array_equal(want.reshape(-1), got)
        want, got = _both(ref.is_zero, F.is_zero, a)
        assert np.array_equal(want.reshape(-1), got)
    assert F.eq(torch.from_numpy(canon), torch.from_numpy(p_plus)).all()
    assert F.is_zero(torch.from_numpy(zero_ish)).all()


def test_select_and_limb_conversion_match_reference(operands):
    a, b = operands["canonical"][1], operands["negative"][1]
    mask = np.array([i % 3 == 0 for i in range(B)])
    want = np.asarray(RF.select(jnp.asarray(mask), jnp.asarray(a), jnp.asarray(b)))
    got = F.select(torch.from_numpy(mask), torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(want, got.numpy())
    for v in (0, 1, F.P - 1, (1 << 256) - 1, rng.getrandbits(256)):
        assert np.array_equal(RF.to_limbs(v), F.to_limbs(v))
        assert F.from_limbs(F.to_limbs(v)) == v == RF.from_limbs(RF.to_limbs(v))
    assert F.from_limbs(torch.from_numpy(b[:, 0])) == RF.from_limbs(b[:, 0])
    assert F.FOLD == [int(x) for x in np.asarray(RF.FOLD)]
