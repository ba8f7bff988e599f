"""The port's point formulas and bound replay against the reference.

``pt_add`` / ``pt_double`` (lazy and eager bodies) must return the
reference curve's exact limbs on random points, P+P, P+(-P), infinity and
loose representations with negative limbs; the port's int32 headroom
replay must pass and agree with the reference's.  Integers: tolerance zero.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpunode.verify import bounds as RB
from tpunode.verify import curve as RC
from tpunode_torch.verify import bounds as B
from tpunode_torch.verify import curve as C
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import field as F

torch.set_num_threads(1)

rng = random.Random(0xC0FE)


def _col(v: int) -> np.ndarray:
    return F.to_limbs(v % F.P)


def _loose(v: int) -> np.ndarray:
    """The limbs of ``v`` written loose: limbs(v + k) - limbs(k)."""
    k = rng.getrandbits(255)
    return F.to_limbs((v + k) % (1 << 264)) - F.to_limbs(k)


def _proj(pt: O.Point, loose: bool = False) -> list:
    """Projective limbs of ``pt`` under a random scale λ: (xλ, yλ, λ)."""
    if pt.infinity:
        return [_col(0), _col(1), _col(0)]
    lam = rng.getrandbits(256) % F.P or 1
    enc = _loose if loose else _col
    return [enc(pt.x * lam % F.P), enc(pt.y * lam % F.P), enc(lam)]


@pytest.fixture(scope="module")
def lanes():
    """Lane-batched (p, q) point pairs and the affine sums they must give."""
    p_pt = O.point_mul(rng.getrandbits(256), O.GENERATOR)
    q_pt = O.point_mul(rng.getrandbits(256), O.GENERATOR)
    neg_p = O.Point(p_pt.x, O.CURVE_P - p_pt.y)
    inf = O.INFINITY
    cases = [(p_pt, q_pt, False), (p_pt, p_pt, False), (p_pt, neg_p, False),
             (inf, p_pt, False), (p_pt, inf, False), (inf, inf, False),
             (p_pt, q_pt, True), (q_pt, q_pt, True)]
    ps = [_proj(a, loose) for a, _, loose in cases]
    qs = [_proj(b, loose) for _, b, loose in cases]

    def stack(pts):
        return np.stack([np.stack([pt[c] for pt in pts], axis=1) for c in range(3)])

    sums = [O.point_add(a, b) for a, b, _ in cases]
    doubles = [O.point_add(a, a) for a, _, _ in cases]
    return stack(ps).astype(np.int32), stack(qs).astype(np.int32), sums, doubles


def _affine(pt: np.ndarray, lane: int) -> O.Point:
    x, y, z = (F.from_limbs(pt[c, :, lane]) % F.P for c in range(3))
    if z == 0:
        return O.INFINITY
    zi = pow(z, -1, F.P)
    return O.Point(x * zi % F.P, y * zi % F.P)


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
def test_pt_add_matches_reference(lanes, reduce):
    p, q, sums, _ = lanes
    want = np.asarray(RC.pt_add(jnp.asarray(p), jnp.asarray(q), reduce=reduce))
    got = C.pt_add(torch.from_numpy(p), torch.from_numpy(q), reduce=reduce).numpy()
    assert np.array_equal(want, got)
    assert [_affine(got, i) for i in range(len(sums))] == sums


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
def test_pt_double_matches_reference(lanes, reduce):
    p, _, _, doubles = lanes
    want = np.asarray(RC.pt_double(jnp.asarray(p), reduce=reduce))
    got = C.pt_double(torch.from_numpy(p), reduce=reduce).numpy()
    assert np.array_equal(want, got)
    assert [_affine(got, i) for i in range(len(doubles))] == doubles


def test_infinity_and_select_match_reference(lanes):
    assert np.array_equal(np.asarray(RC.INFINITY), C.INFINITY.numpy())
    assert np.array_equal(C.infinity(3, "cpu").numpy(),
                          np.broadcast_to(np.asarray(RC.INFINITY), (3, 24, 3)))
    p, q, _, _ = lanes
    mask = np.arange(p.shape[-1]) % 2 == 0
    want = np.asarray(RC.pt_select(jnp.asarray(mask), jnp.asarray(p), jnp.asarray(q)))
    got = C.pt_select(torch.from_numpy(mask), torch.from_numpy(p), torch.from_numpy(q))
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
def test_bound_replay_passes_and_matches_reference(reduce):
    B.assert_formulas_safe(reduce)
    ref = RB.audit_formulas(reduce)
    assert B.audit_formulas(reduce) == ref  # pt_add, pt_double and pt_add_mixed


def test_bound_replay_catches_overflow():
    wide = B.BVal.uniform(1 << 16)  # outside mul_t's |limb| <= 2^13 contract
    with pytest.raises(B.BoundOverflow):
        B.BoundField().mul_t(wide, wide)
    fat = B.BVal.uniform(1 << 30, 47)
    with pytest.raises(B.BoundOverflow):
        B.BoundField().acc_add(fat, fat)
