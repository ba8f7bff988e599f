"""The port's full-product square (``TPUNODE_FIELD_SQR=mul``) on the CPU.

Under "mul" every square of the reference (``tpunode/verify/field.py``
``_square_conv``, ``pallas_field.py`` likewise) is the general convolution
``conv(a, a)`` in place of the half product ``_sqr_conv(a)``: the same sum
in every output limb, so no verdict can tell the two apart.  The checks
here are therefore both limb checks and structural ones:

* the four square functions of ``field.field_ns("shift_add", "mul")`` limb
  for limb against the reference's under ``set_field_modes(sqr="mul")``
  (called eagerly, restored in ``finally``) and the port's "half" output;
* the plain program under ``sqr="mul"``, every square it makes held limb
  for limb against the half product of the same operand (so every later
  value is the half program's), its verdicts against the oracle;
* a spy that attributes each convolution to the square site that made it:
  under "mul" no ``_sqr_conv`` runs anywhere, and each site makes as many
  ``conv(a, a)`` as it made ``_sqr_conv`` under "half";
* the knob, the config field, the campaign and the bounds audit.

Inputs come from seeds through numpy.  Limbs are integers and verdicts
booleans: tolerance zero.
"""

import contextlib
import random
import sys
from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from tpunode.verify import field as RF
from tpunode.verify import pallas_field as RPF
from tpunode_torch import campaign as C
from tpunode_torch.verify import bounds as B
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import engine as E
from tpunode_torch.verify import field as F
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

LANES = 17  # one of each adversarial shape
SQUARES = ("sqr", "sqr_t", "sqr_wide", "sqr_t_wide")


@contextlib.contextmanager
def reference_sqr(mode: str):
    """The reference field with its square ``mode``, restored on exit."""
    prev = RF.set_field_modes(sqr=mode)[1]
    try:
        yield
    finally:
        RF.set_field_modes(sqr=prev)


@pytest.fixture(scope="module")
def operands() -> list:
    """(24, 8) int32 operand sets at both square contracts: canonical
    values, negative loose limbs, and limbs at +-2^13."""
    rng = np.random.default_rng(0x5C12)
    canon = np.stack([F.to_limbs(int(v) % F.P) for v in rng.integers(1, 2**62, 8)], axis=1)
    neg = np.stack([F.to_limbs(3)] * 8, axis=1) - canon
    loose = rng.integers(-(1 << 13), (1 << 13) + 1, size=(24, 8))
    loose[:, 0], loose[:, 1] = 1 << 13, -(1 << 13)
    return [np.ascontiguousarray(x, dtype=np.int32) for x in (canon, neg, loose)]


@pytest.fixture(scope="module")
def items():
    return chip_smoke.adversarial_items(O, random.Random(0x5C13), lanes=LANES)


def _args(items, wb=4):
    prep = K.prepare_batch_raw(pack_items(items), pad_to=len(items), window_bits=wb)
    assert not prep.schnorr_free
    return K.from_reference(prep.device_args, "cpu")


@pytest.mark.parametrize("name", SQUARES)
@pytest.mark.parametrize("ref", [RF, RPF], ids=["field", "pallas_field"])
def test_square_functions_match_the_reference_under_mul(operands, ref, name):
    """Limb for limb the reference's full-product square, and the port's
    own half-product output."""
    full = getattr(F.field_ns("shift_add", "mul"), name)
    for a in operands:
        with reference_sqr("mul"):
            want = np.asarray(getattr(ref, name)(jnp.asarray(a)))
        got = full(torch.from_numpy(a.copy())).numpy()
        assert got.dtype == np.int32 and np.array_equal(got, want), name
        assert np.array_equal(got, getattr(F, name)(torch.from_numpy(a.copy())).numpy())
    assert RF.sqr_mode() == "half"  # restored
    assert F.field_ns("shift_add", "half") is F
    a, b = (torch.from_numpy(x.copy()) for x in operands[:2])
    assert torch.equal(F.field_ns("shift_add", "mul").mul(a, b), F.mul(a, b))


class _Spy:
    """Counts ``_conv`` and ``_sqr_conv`` calls by the square site that made
    them (the first frame out from the call that names a site), and holds
    every full-product square ``_conv(a, a)`` limb for limb against the
    half product of the same operand."""

    SITES = {"_pt_double_lazy": "doubling", "pt_double": "doubling",
             "_pow_table": "pow table", "_pow_const": "pow", "verify_core": "on-curve"}

    def __init__(self, monkeypatch):
        self.conv, self.sqr_conv = F._conv, F._sqr_conv
        self.half, self.full, self.products = Counter(), Counter(), 0
        monkeypatch.setattr(F, "_conv", self._conv_spy)
        monkeypatch.setattr(F, "_sqr_conv", self._sqr_conv_spy)

    def _site(self) -> str:
        frame = sys._getframe(2)
        while frame is not None:
            site = self.SITES.get(frame.f_code.co_name)
            if site == "pow":
                digits = frame.f_locals["digits"]
                return "Euler pow" if digits is K._EULER_DIGITS else "p-2 pow"
            if site is not None:
                return site
            frame = frame.f_back
        return "elsewhere"

    def _conv_spy(self, a, b):
        out = self.conv(a, b)
        if a is b:
            assert torch.equal(out, self.sqr_conv(a))
            self.full[self._site()] += 1
        else:
            self.products += 1
        return out

    def _sqr_conv_spy(self, a):
        self.half[self._site()] += 1
        return self.sqr_conv(a)


# every (width, form, reduction) under the tree select and the scan ladders,
# then the one-hot select and the unrolled ladders at the default key
PROGRAMS = [(wb, form, reduce, "tree", "scan") for wb in (4, 5)
            for form in ("projective", "affine") for reduce in ("lazy", "eager")]
PROGRAMS += [(4, "projective", "lazy", "onehot", "scan"), (4, "projective", "lazy", "tree",
                                                             "unroll")]


@pytest.mark.parametrize("window_bits, point_form, reduce, select, ladder", PROGRAMS,
                         ids=["-".join(map(str, p)) for p in PROGRAMS])
def test_full_product_program_is_the_half_program(monkeypatch, items, window_bits, reduce,
                                                 point_form, select, ladder):
    """verify_core(sqr="mul"): every square is conv(a, a) and equals the
    half product of its operand limb for limb, so every later limb and each
    verdict is the half program's; no _sqr_conv runs; the verdicts are the
    oracle's."""
    spy = _Spy(monkeypatch)
    args = _args(items, window_bits)
    got = K.verify_core(*args, schnorr_free=False, point_form=point_form, reduce=reduce,
                        select=select, ladder=ladder, sqr="mul", mul="shift_add")
    assert got.tolist() == O.verify_batch_cpu(items)
    assert not spy.half and "elsewhere" not in spy.full
    sites = {"doubling", "Euler pow", "p-2 pow", "on-curve"}
    assert set(spy.full) == sites | ({"pow table"} if ladder == "unroll" else set())


@pytest.mark.parametrize("reduce, ladder", [("lazy", "unroll"), ("eager", "scan")])
def test_spy_finds_every_square_site_in_both_squares(monkeypatch, items, reduce, ladder):
    """The half program calls _sqr_conv at every square site — the
    doublings (of the window loop, and of the unrolled Q table) in both
    reductions, both acceptance pows, the affine table's Fermat pow, the
    unrolled pow table, the on-curve check — and the full-product program
    calls it nowhere, making conv(a, a) as often at each site; the other
    products are the same; the verdicts are the same and the oracle's."""
    args = _args(items)
    runs = {}
    for sqr in ("half", "mul"):
        with monkeypatch.context() as m:
            spy = _Spy(m)
            out = K.verify_core(*args, schnorr_free=False, point_form="affine", reduce=reduce,
                                select="tree", ladder=ladder, sqr=sqr, mul="shift_add").tolist()
            runs[sqr] = out, spy.half, spy.full, spy.products
    (half_out, half, none, half_products), (mul_out, no_half, full, mul_products) = (
        runs["half"], runs["mul"])
    sites = {"doubling", "Euler pow", "p-2 pow", "on-curve"}
    assert set(half) == sites | ({"pow table"} if ladder == "unroll" else set())
    assert all(n > 0 for n in half.values()) and not none and not no_half
    assert full == half and mul_products == half_products
    assert half_out == mul_out == O.verify_batch_cpu(items)


def test_bounds_audit_covers_the_full_product_square():
    """conv(a, a) at the square's contracts (every |limb| <= 2^13 for
    sqr_t, mul's for sqr) has the sums of the half product, which the audit
    already bounds with its doubled cross partials checked too: the same
    bounds, and no new key in the audit."""
    bf = B.BoundField()
    tight, loose = B.BVal.uniform(1 << 13), B.BVal((1 << 19,) * 23 + (1 << 15,))
    assert B._conv(tight, tight).b == B._conv(tight, tight, sqr=True).b
    assert bf.mul_t(tight, tight).b == bf.sqr_t(tight).b
    assert bf.mul(loose, loose).b == bf.sqr(loose).b
    with pytest.raises(B.BoundOverflow, match="sqr doubled partial"):
        B._conv(B.BVal.uniform(1 << 15), B.BVal.uniform(1 << 15), sqr=True)
    B.assert_formulas_safe("lazy")
    assert all(len(key) == 4 for key in B._AUDITED)  # (reduce, width, form, ladder)


def test_sqr_knob_config_field_and_modes(monkeypatch):
    """TPUNODE_FIELD_SQR runs both values; a value that names no mode is a
    ValueError naming the knob; a square outside SQR_MODES is refused by
    the config, the mode tuple and the plain program; the multiply's other
    mode runs beside either square."""
    monkeypatch.delenv("TPUNODE_FIELD_SQR", raising=False)
    assert F.sqr_mode() == "half" and K.kernel_modes()[1] == "half"
    monkeypatch.setenv("TPUNODE_FIELD_SQR", "mul")
    assert F.sqr_mode() == "mul" and K.kernel_modes()[1] == "mul"
    assert E.VerifyConfig(device="cpu").field_sqr == "mul"
    assert E.VerifyConfig(device="cpu", field_sqr="half").field_sqr == "half"
    assert K.kernel_modes(4, "projective", "lazy", "tree", "scan", "half")[1] == "half"
    monkeypatch.setenv("TPUNODE_FIELD_SQR", "full")
    with pytest.raises(ValueError, match="TPUNODE_FIELD_SQR"):
        F.sqr_mode()
    monkeypatch.delenv("TPUNODE_FIELD_SQR")
    for bad in ("Mul", "", "dot_general"):
        with pytest.raises(ValueError, match="sqr mode"):
            F.check_sqr(bad)
        with pytest.raises(ValueError, match="sqr mode"):
            E.VerifyConfig(device="cpu", field_sqr=bad)
        with pytest.raises(ValueError, match="sqr mode"):
            F.field_ns("shift_add", bad)
    with pytest.raises(ValueError, match="sqr mode"):
        K.kernel_modes(4, "projective", "lazy", "tree", "scan", "half2")
    monkeypatch.setenv("TPUNODE_FIELD_MUL", "dot_general")
    assert K.kernel_modes(sqr="mul")[:2] == ("dot_general", "mul")
    assert E.VerifyConfig(device="cpu", field_sqr="mul").field_mul == "dot_general"


def test_campaign_runs_the_full_product_square_on_one_pool():
    """run_campaign(field_sqr="mul") on the CPU: 0 mismatches over the 21
    shapes, reported under its square; a pool built once and passed in
    gives the same result, without a build time of its own."""
    pool = C.build_pool(3, random.Random(C.SEED))
    res = C.run_campaign(3, 32, device="cpu", field_sqr="mul", pool=pool)
    assert (res["mismatches"], res["items"], res["field_sqr"], res["kernel"]) == (
        0, 21, "mul", "plain")
    assert res["gen_s"] is None and res["launches"] == 0
    assert C.run_campaign(3, 32, device="cpu", field_sqr="half")["tally"] == res["tally"]
