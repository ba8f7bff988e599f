"""The port's ``dot_general`` multiply (``TPUNODE_FIELD_MUL=dot_general``) on the CPU.

Under "dot_general" every convolution of the reference (``tpunode/verify/field.py``
``_convolve`` / ``_square_conv``, ``pallas_field.py`` likewise) is the
contraction of its partial products against the anti-diagonal scatter:
``_conv_dot`` for a product, ``_sqr_dot`` (300 pairs, weighted 2 off the
diagonal) for the half-product square, ``_conv_dot(a, a)`` for the full
one.  Each gives the shift-add sums in every output limb, so no verdict can
tell the formulations apart; the checks here are limb checks and
structural ones:

* the port's ``_sqr_dot`` limb for limb against the reference's
  ``field._sqr_dot`` and ``pallas_field._sqr_dot`` (evaluated eagerly) and
  the port's ``_sqr_conv``, at the corners of the loose contract;
* the eight products of each of the four ``field.field_ns(mul, sqr)``
  namespaces against the shift-add module's and the reference's under
  ``set_field_modes(mul=, sqr=)`` (restored in ``finally``);
* the plain program under ``mul="dot_general"`` at 8 lanes in every
  (width, form, reduction, select, square), full variant: every value it
  canonicalises limb for limb the shift-add program's, its verdicts the
  oracle's, with no shift-add convolution called;
* the 4-bit projective lazy program against the reference's Pallas kernel
  in interpret mode under ``dot_general`` (the file's one interpret trace);
* the knob, the config field and the campaign.

The CUDA kernel's dot_general instantiations are held against the plain
version in test_torch_hostcc.py (host C++) and test_torch_cuda.py (card).
Inputs come from seeds through numpy.  Limbs are integers and verdicts
booleans: tolerance zero.
"""

import contextlib
import random
from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from tpunode.verify import field as RF
from tpunode.verify import kernel as RK
from tpunode.verify import pallas_field as RPF
from tpunode.verify.pallas_kernel import verify_blocked as ref_verify_blocked
from tpunode_torch import campaign as C
from tpunode_torch import cuda_diag
from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import engine as E
from tpunode_torch.verify import field as F
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

LANES = 8
PRODUCTS = ("mul", "mul_t", "mul_wide", "mul_t_wide")
SQUARES = ("sqr", "sqr_t", "sqr_wide", "sqr_t_wide")
CONVOLUTIONS = ("_conv", "_sqr_conv", "_conv_dot", "_sqr_dot")


@contextlib.contextmanager
def reference_modes(mul: str, sqr: str):
    """The reference field with its multiply ``mul`` and square ``sqr``,
    restored on exit."""
    prev = RF.set_field_modes(mul=mul, sqr=sqr)
    try:
        yield
    finally:
        RF.set_field_modes(mul=prev[0], sqr=prev[1])


@pytest.fixture(scope="module")
def operands() -> dict:
    """(24, 40) int32 operand pairs at each product's contract: "loose" at
    mul's (non-top limbs ±2^19, the top ±2^15, lanes 0 and 1 at its
    corners), "tight" at mul_t's (every limb ±2^13, lanes 0 and 1 at +2^13
    and -2^13)."""
    rng = np.random.default_rng(0xD07)
    tight = rng.integers(-(1 << 13), (1 << 13) + 1, size=(2, 24, 40))
    tight[:, :, 0], tight[:, :, 1] = 1 << 13, -(1 << 13)
    return {"loose": [torch.from_numpy(cuda_diag._loose(rng, 40)) for _ in range(2)],
            "tight": [torch.from_numpy(np.ascontiguousarray(t, dtype=np.int32))
                      for t in tight]}


@pytest.fixture(scope="module")
def items():
    """8 of the 17 adversarial shapes, every algorithm among them: a valid
    ECDSA item, a pubkey off the curve, R at infinity, a valid BCH Schnorr
    item and its jacobi twin, a valid BIP340 item and its parity twin, and
    the r+n path."""
    adv = chip_smoke.adversarial_items(O, random.Random(0xD0D07), lanes=17)
    return [adv[i] for i in (1, 3, 8, 9, 10, 12, 13, 15)]


def _args(items, wb=4) -> tuple:
    prep = K.prepare_batch_raw(pack_items(items), pad_to=len(items), window_bits=wb)
    assert not prep.schnorr_free
    return K.from_reference(prep.device_args, "cpu")


class _Trace:
    """Counts the four convolutions' calls and keeps every value the
    program canonicalises (every comparison and the parity read go through
    ``field.canonical``)."""

    def __init__(self, monkeypatch):
        self.calls, self.canonical = Counter(), []
        for name in CONVOLUTIONS:
            monkeypatch.setattr(F, name, self._counted(name, getattr(F, name)))
        real = F.canonical
        monkeypatch.setattr(F, "canonical",
                            lambda x: (self.canonical.append(x.clone()), real(x))[1])

    def _counted(self, name, fn):
        def spy(*args):
            self.calls[name] += 1
            return fn(*args)
        return spy


# ---------- the half-product square's contraction ---------------------------


def test_sqr_dot_equals_the_references_and_the_half_product():
    """``_sqr_dot`` limb for limb against the reference's two ``_sqr_dot``
    and the port's ``_sqr_conv`` on carried loose operands with the
    contract's corners (top limbs ±2^15, the rest -256 and 2^11 + 255, one
    lane all negative), and its scatter the reference's."""
    rng = np.random.default_rng(0x5D07)
    a = F._carry(torch.from_numpy(cuda_diag._loose(rng, 40)), 1)
    hi, lo, top = (1 << 11) + 255, -256, 1 << 15
    for lane, (x, tx) in enumerate([(hi, top), (lo, -top), (lo, top)], start=2):
        a[:-1, lane], a[-1, lane] = x, tx
    a = a.contiguous()
    got = F._sqr_dot(a)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2 * F.NLIMBS - 1, 40)
    assert torch.equal(got, F._sqr_conv(a)) and torch.equal(got, F._conv(a, a))
    assert np.array_equal(got.numpy(), np.asarray(RF._sqr_dot(jnp.asarray(a.numpy()))))
    assert np.array_equal(got.numpy(), np.asarray(RPF._sqr_dot(jnp.asarray(a.numpy()))))
    scatter = F._sqr_scatter(torch.device("cpu"))
    assert np.array_equal(scatter.numpy(), np.asarray(RF._SQR_SCATTER))
    assert F._sqr_scatter(torch.device("cpu")) is scatter  # made once a device
    wide = F._carry(torch.from_numpy(cuda_diag._loose(rng, 2 * F._DOT_CHUNK + 3)), 1)
    assert torch.equal(F._sqr_dot(wide), F._sqr_conv(wide))  # across chunks


# ---------- the four namespaces ---------------------------------------------


@pytest.mark.parametrize("sqr", ["half", "mul"])
@pytest.mark.parametrize("mul", ["shift_add", "dot_general"])
def test_namespace_products_match_shift_add_and_the_reference(operands, mul, sqr):
    """The eight products of ``field_ns(mul, sqr)`` at their contracts, limb
    for limb the shift-add module's and the reference's (``field`` and
    ``pallas_field``) under the same modes; only the (shift_add, half)
    namespace is the module itself, and the namespace's convolutions are
    the mode's."""
    fns = F.field_ns(mul, sqr)
    assert (fns is F) == ((mul, sqr) == ("shift_add", "half"))
    for name in PRODUCTS + SQUARES:
        a, b = operands["tight" if "_t" in name else "loose"]
        args = (a, b) if name in PRODUCTS else (a,)
        got = getattr(fns, name)(*args)
        assert torch.equal(got, getattr(F, name)(*args)), name
        for ref in (RF, RPF):
            with reference_modes(mul, sqr):
                want = np.asarray(getattr(ref, name)(*(jnp.asarray(x.numpy()) for x in args)))
            assert np.array_equal(got.numpy(), want), (name, ref.__name__)
    assert RF.field_modes()[:2] == ("shift_add", "half")  # restored


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_namespace_calls_only_its_own_convolutions(operands, monkeypatch, sqr):
    """Under dot_general no shift-add convolution runs: a multiply calls
    ``_conv_dot``, a square ``_sqr_dot`` (half) or ``_conv_dot(a, a)``."""
    trace = _Trace(monkeypatch)
    fns = F.field_ns("dot_general", sqr)
    a, b = operands["loose"]
    fns.mul(a, b)
    fns.sqr(a)
    want = {"_conv_dot": 2} if sqr == "mul" else {"_conv_dot": 1, "_sqr_dot": 1}
    assert dict(trace.calls) == want


# ---------- the plain program -------------------------------------------------


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
def test_plain_dot_program_equals_the_shift_add_one(items, monkeypatch, window_bits,
                                                    point_form, reduce):
    """verify_core(mul="dot_general") at 8 lanes in both selects and both
    squares, full variant: every value it canonicalises limb for limb the
    shift-add program's (tree, half), so every limb before it is the same;
    its verdicts the oracle's; no ``_conv`` or ``_sqr_conv`` call, and as
    many contractions as the shift-add program makes convolutions.  The
    programs run under ``torch.inference_mode`` (a third less dispatch
    time; the values are the same)."""
    args = _args(items, window_bits)
    runs = {}
    for select, sqr, mul in [("tree", "half", "shift_add")] + [
            (select, sqr, "dot_general") for select in K.SELECT_MODES for sqr in F.SQR_MODES]:
        with monkeypatch.context() as m, torch.inference_mode():
            trace = _Trace(m)
            out = K.verify_core(*args, schnorr_free=False, point_form=point_form,
                                reduce=reduce, select=select, ladder="scan", sqr=sqr, mul=mul)
        runs[(select, sqr, mul)] = out.tolist(), trace
    base_out, base = runs.pop(("tree", "half", "shift_add"))
    assert base_out == O.verify_batch_cpu(items)
    total = base.calls["_conv"] + base.calls["_sqr_conv"]
    assert not base.calls["_conv_dot"] and not base.calls["_sqr_dot"]
    for (select, sqr, mul), (out, trace) in runs.items():
        assert out == base_out, (select, sqr)
        assert len(trace.canonical) == len(base.canonical)
        assert all(torch.equal(x, y) for x, y in zip(trace.canonical, base.canonical))
        assert not trace.calls["_conv"] and not trace.calls["_sqr_conv"]
        assert trace.calls["_conv_dot"] + trace.calls["_sqr_dot"] == total
        assert bool(trace.calls["_sqr_dot"]) == (sqr == "half")


def test_plain_dot_program_matches_the_reference_kernel_in_interpret_mode(items):
    """The reference's Pallas kernel under ``set_field_modes(mul=
    "dot_general", sqr="half")``, 4-bit projective lazy, full variant, in
    interpret mode, verdict for verdict against the port's plain program in
    those modes (through the wrapper, a CPU tensor) and the oracle."""
    with reference_modes("dot_general", "half"):
        prep = RK.prepare_batch(items, pad_to=LANES, native=False)
        ref = ref_verify_blocked(*(jnp.asarray(a) for a in prep.device_args), interpret=True,
                                 block=LANES, schnorr_free=False, point_form="projective")
    assert RF.field_modes()[:2] == ("shift_add", "half")  # restored
    launches = dict(cuda_kernel.LAUNCHES)
    got = cuda_kernel.verify_blocked(*_args(items), schnorr_free=False, select="tree",
                                     ladder="scan", sqr="half", mul="dot_general")
    assert cuda_kernel.LAUNCHES == launches  # a CPU tensor never reaches the kernel
    ref = [bool(v) for v in np.asarray(ref)]
    assert got.tolist() == ref == O.verify_batch_cpu(items)
    assert any(ref) and not all(ref)


# ---------- the knob, the config and the campaign ----------------------------


@pytest.mark.parametrize("mul", ["shift_add", "dot_general"])
def test_mul_knob_and_config_field(monkeypatch, mul):
    """``VerifyConfig(device="cpu", field_mul=...)`` runs both values and
    the engine reports and passes them; None reads ``TPUNODE_FIELD_MUL``;
    a value that names no mode raises ValueError from the knob, the config,
    the mode tuple and the plain program."""
    monkeypatch.delenv("TPUNODE_FIELD_MUL", raising=False)
    assert E.VerifyConfig(device="cpu").field_mul == F.mul_mode() == "shift_add"
    seen = []
    real = K.verify_core

    def spy(*args, mul, **kw):
        seen.append(mul)
        return real(*args, mul=mul, **kw)

    monkeypatch.setattr(K, "verify_core", spy)
    engine = E.VerifyEngine(E.VerifyConfig(device="cpu", warmup=True, batch_size=LANES,
                                           device_batch=LANES, field_mul=mul))
    assert engine.wait_warmup(120) == "ready"
    assert engine.cfg.field_mul == mul and engine.modes()[0] == mul and seen == [mul]
    monkeypatch.setenv("TPUNODE_FIELD_MUL", mul)
    assert E.VerifyConfig(device="cpu").field_mul == mul and K.kernel_modes()[0] == mul
    other = "shift_add" if mul == "dot_general" else "dot_general"
    assert E.VerifyConfig(device="cpu", field_mul=other).field_mul == other  # the config wins
    monkeypatch.setenv("TPUNODE_FIELD_MUL", "dot")
    with pytest.raises(ValueError, match="TPUNODE_FIELD_MUL"):
        F.mul_mode()
    with pytest.raises(ValueError, match="TPUNODE_FIELD_MUL"):
        E.VerifyConfig(device="cpu")
    monkeypatch.delenv("TPUNODE_FIELD_MUL")
    for bad in ("dot", "", "Shift_add"):
        with pytest.raises(ValueError, match="mul mode"):
            E.VerifyConfig(device="cpu", field_mul=bad)
        with pytest.raises(ValueError, match="mul mode"):
            K.kernel_modes(mul=bad)
        with pytest.raises(ValueError, match="mul mode"):
            F.field_ns(bad, "half")


def test_campaign_runs_dot_general_on_one_pool():
    """run_campaign(field_mul="dot_general") on the CPU: 0 mismatches over
    the 21 shapes, reported under its multiply, the shift-add campaign's
    tally."""
    pool = C.build_pool(3, random.Random(C.SEED))
    res = C.run_campaign(3, 32, device="cpu", pool=pool, field_mul="dot_general")
    assert (res["mismatches"], res["items"], res["field_mul"], res["kernel"]) == (
        0, 21, "dot_general", "plain")
    assert res["launches"] == 0
    assert C.run_campaign(3, 32, device="cpu", pool=pool)["tally"] == res["tally"]
