"""The port's unrolled pow ladders against the reference's, and the two
ladder-layer probes' plain versions against the reference probe bodies.

Under ``TPUNODE_POW_LADDER=unroll`` the reference's XLA program
(``tpunode/verify/kernel.py``) builds the pow table and the Q table by
log-depth chains and runs the 64 pow windows with static digits; its Pallas
kernel, and the port's CUDA kernel, keep the one ladder form.  The
reference's ladder, width and reduction are process globals
(``kernel.set_kernel_modes``, ``field.set_field_modes``), read when its
programs are traced; every use of them here goes through
:func:`reference_modes`, which restores them in ``finally``.  The
reference's whole unrolled program is never jitted (its XLA compile is the
cost the knob's default avoids): its ladder functions run eagerly, one
field operation or point formula jitted at a time (:func:`jit_ops`), which
changes no limb, since every operation is exact int32 arithmetic.  Inputs
come from seeds through numpy.  Limbs are integers and verdicts booleans:
tolerance zero on every limb and verdict.
"""

import contextlib
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from tpunode.verify import curve as RC
from tpunode.verify import field as RF
from tpunode.verify import kernel as RK
from tpunode.verify import pallas_field as PF
from tpunode_torch import cuda_diag
from tpunode_torch.campaign import run_campaign
from tpunode_torch.verify import bounds as B
from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import field as F
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

LANES = 17  # one of each adversarial shape


@contextlib.contextmanager
def reference_modes(ladder: str, wb: int = 4, reduce: str = "lazy"):
    """The reference package with ``ladder`` at width ``wb`` and reduction
    ``reduce``, all three restored on exit."""
    prev = RK.set_kernel_modes(pow_ladder=ladder, window_bits=wb)
    try:
        prev_reduce = RF.set_field_modes(reduce=reduce)[2]
        try:
            yield
        finally:
            RF.set_field_modes(reduce=prev_reduce)
    finally:
        RK.set_kernel_modes(pow_ladder=prev[1], window_bits=prev[2])


class _JitField:
    """The reference field module with ``mul`` and ``sqr`` jitted one call
    at a time; every other name is the module's."""

    def __init__(self):
        self.mul, self.sqr = jax.jit(RF.mul), jax.jit(RF.sqr)

    def __getattr__(self, name):
        return getattr(RF, name)


_FORMULAS: dict = {}


@contextlib.contextmanager
def jit_ops(reduce: str = "lazy"):
    """Inside a :func:`reference_modes` context of reduction ``reduce``:
    the reference kernel module's field and point formulas jitted one
    operation at a time (traced under ``reduce``, cached per reduction),
    restored on exit."""
    if reduce not in _FORMULAS:
        _FORMULAS[reduce] = (jax.jit(lambda p, q: RC.pt_add(p, q)),
                             jax.jit(lambda p: RC.pt_double(p)))
    if "field" not in _FORMULAS:
        _FORMULAS["field"] = _JitField()
    saved = RK.F, RK.pt_add, RK.pt_double
    RK.F = _FORMULAS["field"]
    RK.pt_add, RK.pt_double = _FORMULAS[reduce]
    try:
        yield
    finally:
        RK.F, RK.pt_add, RK.pt_double = saved


def _limb_cols(vals) -> np.ndarray:
    return np.stack([F.to_limbs(v % F.P) for v in vals], axis=1).astype(np.int32)


def _canon(x) -> list:
    """Each lane of a (24, B) limb array as a field value."""
    c = F.canonical(torch.as_tensor(np.asarray(x)))
    return [F.from_limbs(c[:, i]) for i in range(c.shape[-1])]


@pytest.fixture(scope="module")
def items():
    return chip_smoke.adversarial_items(O, random.Random(0x1AD), lanes=LANES)


@pytest.fixture(scope="module")
def points():
    rng = random.Random(0x1AE)
    return [O.point_mul(rng.getrandbits(256) % O.CURVE_N or 1, O.GENERATOR) for _ in range(3)]


# ---------- the pow ladders ----------------------------------------------------


@pytest.mark.parametrize("exponent", ["euler", "pm2"])
@pytest.mark.parametrize("ladder", ["scan", "unroll"])
def test_pow_const_matches_the_reference_in_both_ladders(ladder, exponent):
    """_pow_table and _pow_const limb for limb the reference's in its own
    ladder mode, for both constant exponents, on full-width values; and
    t^e mod p in value.  The unrolled table is the reference's log-depth
    _pow_table; the scan table, its sequential chain."""
    digits = {"euler": K._EULER_DIGITS, "pm2": K._PM2_DIGITS}[exponent]
    e = {"euler": (F.P - 1) // 2, "pm2": F.P - 2}[exponent]
    rng = np.random.default_rng(0x1AF + len(exponent))
    vals = [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(3)]
    t = _limb_cols(vals)
    with reference_modes(ladder), jit_ops():
        ref = np.asarray(RK._pow_const(jnp.asarray(t), np.array(digits, dtype=np.int32)))
        ref_table = [np.asarray(x) for x in RK._pow_table(jnp.asarray(t))]
    table = K._pow_table(torch.from_numpy(t), ladder=ladder, sqr="half", mul="shift_add")
    got = K._pow_const(torch.from_numpy(t), digits, ladder=ladder, sqr="half",
                       mul="shift_add").numpy()
    assert np.array_equal(got, ref)
    assert _canon(got) == [pow(v, e, F.P) for v in vals]
    if ladder == "unroll":
        assert all(np.array_equal(np.broadcast_to(r, t.shape), x.numpy())
                   for r, x in zip(ref_table, table))
    else:
        assert _canon(table[15].numpy()) == [pow(v, 15, F.P) for v in vals]
        assert np.array_equal(table[3].numpy(), F.mul(table[2], table[1]).numpy())


def test_unrolled_pow_equals_the_scan_pow_in_value():
    """The two ladders build the same powers and the same pow in value (the
    unrolled table squares where the scan table multiplies); a ladder that
    names no mode is refused."""
    vals = [0xC0FFEE ** 5, 3 ** 200]
    t = torch.from_numpy(_limb_cols(vals))
    scan = K._pow_table(t, ladder="scan", sqr="half", mul="shift_add")
    unroll = K._pow_table(t, ladder="unroll", sqr="half", mul="shift_add")
    assert [_canon(x.numpy()) for x in scan] == [_canon(x.numpy()) for x in unroll] == [
        [pow(v, k, F.P) for v in vals] for k in range(16)]
    assert _canon(K._pow_const(t, K._PM2_DIGITS, ladder="unroll", sqr="half",
                               mul="shift_add").numpy()) == [
        pow(v, F.P - 2, F.P) for v in vals]
    with pytest.raises(ValueError, match="pow ladder mode"):
        K._pow_const(t, K._EULER_DIGITS, ladder="unrolled", sqr="half", mul="shift_add")


# ---------- the Q tables -------------------------------------------------------


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
def test_unrolled_q_table_matches_the_reference_at_both_widths(points, reduce):
    """_build_q_table(ladder="unroll", sqr="half") limb for limb the reference's
    unrolled table (7 doublings and 7 adds at 4-bit, 15 and 15 at 5-bit),
    Z included, with the reduction's bodies; entry k is k·Q in value, and
    its limbs differ from the scan chain's."""
    qx, qy = _limb_cols([q.x for q in points]), _limb_cols([q.y for q in points])
    for wb in (4, 5):
        with reference_modes("unroll", wb, reduce), jit_ops(reduce):
            ref = np.asarray(RK._build_q_table(jnp.asarray(qx), jnp.asarray(qy)))
        got = K._build_q_table(torch.from_numpy(qx), torch.from_numpy(qy), wb, reduce,
                               ladder="unroll", sqr="half", mul="shift_add").numpy()
        assert got.shape == ref.shape == (1 << wb, 3, 24, len(points))
        assert np.array_equal(got, ref)
        scan = K._build_q_table(torch.from_numpy(qx), torch.from_numpy(qy), wb, reduce,
                                ladder="scan", sqr="half", mul="shift_add").numpy()
        assert np.array_equal(got[:2], scan[:2]) and not np.array_equal(got[2], scan[2])
        for k in (2, 3, (1 << wb) - 1):
            for i, q in enumerate(points):
                x, z = F.from_limbs(got[k, 0, :, i]), F.from_limbs(got[k, 2, :, i])
                assert x % F.P == O.point_mul(k, q).x * z % F.P


@pytest.mark.parametrize("wb, reduce", [(4, "lazy"), (5, "eager")])
def test_unrolled_affine_table_takes_its_chain_from_the_unrolled_build(points, monkeypatch,
                                                                       wb, reduce):
    """_affine_q_table(ladder="unroll", sqr="half") normalises the projective chain of
    _build_q_table in the same ladder, Z included, which is limb for limb
    the reference's unrolled table; its entries are k·Q in affine limbs."""
    chains = []
    real = K._build_q_table

    def spy(qx, qy, wb, reduce="lazy", *, ladder, sqr, mul):
        chains.append((ladder, real(qx, qy, wb, reduce, ladder=ladder, sqr=sqr, mul=mul)))
        return chains[-1][1]

    monkeypatch.setattr(K, "_build_q_table", spy)
    qx, qy = _limb_cols([q.x for q in points]), _limb_cols([q.y for q in points])
    got = K._affine_q_table(torch.from_numpy(qx), torch.from_numpy(qy), wb, reduce,
                            ladder="unroll", sqr="half", mul="shift_add").numpy()
    with reference_modes("unroll", wb, reduce), jit_ops(reduce):
        ref = np.asarray(RK._build_q_table(jnp.asarray(qx), jnp.asarray(qy)))
    ((ladder, chain),) = chains
    assert ladder == "unroll" and np.array_equal(chain.numpy(), ref)
    assert got.shape == (1 << wb, 2, 24, len(points))
    for k in range(1, 1 << wb):
        kq = [O.point_mul(k, q) for q in points]
        assert _canon(got[k, 0]) == [p.x for p in kq] and _canon(got[k, 1]) == [p.y for p in kq]


# ---------- the whole plain program ----------------------------------------------


@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("reduce", ["lazy", "eager"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
def test_unrolled_program_equals_the_scan_program_and_the_oracle(monkeypatch, items,
                                                                 window_bits, reduce,
                                                                 point_form):
    """verify_core(ladder="unroll", sqr="half") in every (width, form, reduction), full
    variant, verdict for verdict the scan program's and the oracle's; the
    Q table and every pow of the unroll run take the unrolled ladder."""
    ladders = []
    real_table, real_pows = K._build_q_table, K._pow_table

    def table(*args, ladder, **kw):
        ladders.append(("table", ladder))
        return real_table(*args, ladder=ladder, **kw)

    def pows(t, *, ladder, sqr, mul):
        ladders.append(("pow", ladder))
        return real_pows(t, ladder=ladder, sqr=sqr, mul=mul)

    monkeypatch.setattr(K, "_build_q_table", table)
    monkeypatch.setattr(K, "_pow_table", pows)
    prep = K.prepare_batch_raw(pack_items(items), pad_to=LANES, window_bits=window_bits)
    assert not prep.schnorr_free
    args = K.from_reference(prep.device_args, "cpu")
    launches = dict(cuda_kernel.LAUNCHES)
    got = {ladder: cuda_kernel.verify_blocked(*args, schnorr_free=False, point_form=point_form,
                                              reduce=reduce, select="tree",
                                              ladder=ladder, sqr="half", mul="shift_add").tolist()
           for ladder in ("unroll", "scan")}
    assert cuda_kernel.LAUNCHES == launches  # a CPU tensor never reaches the kernel
    assert got["unroll"] == got["scan"] == O.verify_batch_cpu(items)
    unroll = ladders[:ladders.index(("table", "scan"))]
    pows_run = 3 if point_form == "affine" else 2  # + the batch inversion's
    assert unroll == [("table", "unroll")] + [("pow", "unroll")] * pows_run


def test_ladder_knob_and_the_modes(monkeypatch, items):
    """TPUNODE_POW_LADDER runs both values; a value that names no mode is a
    ValueError naming the knob; a ladder argument outside POW_LADDER_MODES
    is refused by the mode tuple, the plain program and the launcher, and
    the launcher takes no default ladder."""
    monkeypatch.delenv("TPUNODE_POW_LADDER", raising=False)
    assert K.pow_ladder_mode() == "scan" and K.kernel_modes()[5] == "scan"
    monkeypatch.setenv("TPUNODE_POW_LADDER", "unroll")
    assert K.pow_ladder_mode() == "unroll" and K.kernel_modes()[5] == "unroll"
    assert K.kernel_modes(4, "projective", "lazy", "tree", "scan")[5] == "scan"
    monkeypatch.setenv("TPUNODE_POW_LADDER", "descan")
    with pytest.raises(ValueError, match="TPUNODE_POW_LADDER"):
        K.pow_ladder_mode()
    monkeypatch.delenv("TPUNODE_POW_LADDER")
    with pytest.raises(ValueError, match="pow ladder mode"):
        K.check_ladder("Unroll")
    with pytest.raises(ValueError, match="pow ladder mode"):
        K.kernel_modes(4, "projective", "lazy", "tree", "")
    prep = K.prepare_batch_raw(pack_items(items[:4]), pad_to=4)
    args = K.from_reference(prep.device_args, "cpu")
    for bad in ("unrol", "SCAN"):
        with pytest.raises(ValueError, match="pow ladder mode"):
            cuda_kernel.verify_blocked(*args, schnorr_free=False, select="tree", ladder=bad, sqr="half",
                                       mul="shift_add")
        with pytest.raises(ValueError, match="pow ladder mode"):
            K.verify_core(*args, schnorr_free=False, select="tree", ladder=bad, sqr="half",
                          mul="shift_add")
    with pytest.raises(TypeError, match="ladder"):
        cuda_kernel.verify_blocked(*args, schnorr_free=False, select="tree")
    with pytest.raises(TypeError, match="ladder"):
        K.verify_batch_gpu(items[:4], device="cpu", select="tree")
    assert {key[4] for key in cuda_kernel.LAUNCHES} == set(K.POW_LADDER_MODES)
    assert cuda_kernel.launch_count(4, "projective", "lazy", "tree", "unroll", "half",
                                    "shift_add") == 0


def test_campaign_under_the_unroll_knob(monkeypatch):
    monkeypatch.setenv("TPUNODE_POW_LADDER", "unroll")
    res = run_campaign(3, 32, device="cpu")
    assert (res["mismatches"], res["items"], res["ladder"], res["kernel"]) == (
        0, 21, "unroll", "plain")
    assert (res["window_bits"], res["point_form"], res["field_reduce"], res["select"]) == (
        4, "projective", "lazy", "tree")


# ---------- the bounds audit ----------------------------------------------------


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
def test_bound_replay_covers_the_unrolled_ladders(monkeypatch, reduce):
    """The audit replays the ladder it is given: the unrolled Q table's
    doublings and adds and, in the affine form, the unrolled Fermat ladder,
    every step inside int32 and every coordinate inside its closure; the
    cache keys on the ladder."""
    for wb in (4, 5):
        half = (1 << (wb - 1)) - 1
        got = B.audit_window_program(wb, "affine", reduce, "unroll")
        assert (got["q_table_doublings"], got["q_table_adds"]) == (half, half)
        assert got["inversion"] <= B.AFFINE_BOUND
        assert max(got["q_table"], got["lambda_x"], got["window_round"]) <= B.COORD_BOUND
        scan = B.audit_window_program(wb, "projective", reduce)
        assert (scan["q_table_doublings"], scan["q_table_adds"]) == (0, (1 << wb) - 2)
        assert got["q_table"] <= max(B.audit_formulas(reduce)[f] for f in ("pt_add", "pt_double"))
    monkeypatch.setattr(B, "_AUDITED", {})
    B.assert_formulas_safe(reduce, window_bits=4, ladder="unroll")
    B.assert_formulas_safe(reduce, window_bits=4)
    assert set(B._AUDITED) == {(reduce, 4, "projective", "unroll"),
                               (reduce, 4, "projective", "scan")}
    with pytest.raises(ValueError, match="pow ladder mode"):
        B.audit_window_program(4, "projective", reduce, "unrolled")


# ---------- the two ladder-layer probes ------------------------------------------


def test_table_build_probe_matches_the_reference_probe():
    """The reference probe's own inputs (default_rng(11): a in [1, 2^61))
    through its body, the PF.mul chain tab[k] = tab[k-1]·a, k = 2 .. 15, and
    canonical(tab[15]); every lane a^15 mod p."""
    (a,) = cuda_diag.probe_inputs("table_build", "cpu", lanes=8)
    rng = np.random.default_rng(11)
    av = [int(rng.integers(1, 2**61)) for _ in range(8)]
    assert [F.from_limbs(a[:, i]) for i in range(8)] == av
    mul = jax.jit(PF.mul)
    tab = [None, jnp.asarray(a.numpy())]
    for k in range(2, 16):
        tab.append(mul(tab[k - 1], tab[1]))
    ref = np.asarray(PF.canonical(tab[15]))
    got = cuda_diag.table_build(a)
    assert np.array_equal(got.numpy(), ref)
    assert cuda_diag._host_check("table_build", got, (a,)) == 0
    bad = got.clone()
    bad[2, 6] += 1
    assert cuda_diag._host_check("table_build", bad, (a,)) == 1


def test_pow_descan_probe_matches_the_reference_unrolled_pow():
    """The reference probe's quadratic residues (default_rng(19)) through
    the reference's unrolled _pow_const(t, _EULER_DIGITS): limb for limb
    the plain version's canonical output, 1 in every lane; the static
    ladder's calls are counted from the same digits."""
    (t,) = cuda_diag.probe_inputs("pow_descan", "cpu", lanes=8)
    rng = np.random.default_rng(19)
    assert [F.from_limbs(t[:, i]) for i in range(8)] == [
        int(rng.integers(2, 2**61)) ** 2 % F.P for _ in range(8)]
    with reference_modes("unroll"), jit_ops():
        ref = np.asarray(RF.canonical(RK._pow_const(jnp.asarray(t.numpy()), RK._EULER_DIGITS)))
    got = cuda_diag.pow_descan(t)
    assert np.array_equal(got.numpy(), ref) and (ref == F.to_limbs(1)[:, None]).all()
    assert cuda_diag._host_check("pow_descan", got, (t,)) == 0
    assert cuda_diag.descan_calls() == {"sqr": 7 + 4 * 63, "mul": 7 + 63}  # no zero digit
    assert 0 not in K._EULER_DIGITS and 0 not in K._PM2_DIGITS
    with pytest.raises(ValueError):
        cuda_diag.pow_descan(t[:, :4].clone()[:23])
    assert cuda_diag.PROBES.index("table_build") < cuda_diag.PROBES.index("pow_descan")


def test_descan_ptx_reads_calls_and_digit_loads():
    """The PTX reading of phase 2 on a hand-written module: the ladder
    function's calls by callee, and a digit read from a __constant__ array
    shown both as a load and as a module symbol; the kernel's own global
    loads are not the ladder's."""
    calls = "".join("\tcall.uni \n\t_ZN3tpn3sqrEPiPKi, \n\t(\n\tparam0, \n\tparam1\n\t);\n"
                    for _ in range(3))
    calls += "\tcall.uni _ZN3tpn3mulEPiPKiS2_, (param0, param1, param2);\n"
    head = (".const .align 1 .b8 _ZN3tpn12EULER_DIGITSE[64] = {7, 15};\n"
            ".func _ZN3tpn10pow_descanILy1EEEvPiPKi(\n\t.param .b64 p0,\n\t.param .b64 p1\n)\n;\n")
    body = (".func _ZN3tpn10pow_descanILy1EEEvPiPKi(\n\t.param .b64 p0,\n\t.param .b64 p1\n)\n"
            "{\n\tld.param.u64 %rd1, [p0];\n\tld.u32 %r1, [%rd2];\n" + calls + "\tret;\n\n}\n")
    kernel = (".visible .entry _ZN3tpn17pow_descan_kernelEPKiPii(\n)\n{\n"
              "\tld.global.u32 %r1, [%rd1];\n}\n")
    got = cuda_diag.descan_ptx(head + body + kernel)
    assert got == {"function": "_ZN3tpn10pow_descanILy1EEEvPiPKi",
                   "calls": {"sqr": 3, "mul": 1, "other": 0}, "memory_loads": [],
                   "data_symbols": []}
    bad = body.replace("ld.u32 %r1, [%rd2];", "ld.const.u8 %rs1, [_ZN3tpn12EULER_DIGITSE+5];")
    got = cuda_diag.descan_ptx(head + bad + kernel)
    assert got["memory_loads"] == ["ld.const.u8 %rs1, [_ZN3tpn12EULER_DIGITSE+5];"]
    assert got["data_symbols"] == ["_ZN3tpn12EULER_DIGITSE"]
    with pytest.raises(ValueError, match="pow_descan"):
        cuda_diag.descan_ptx(head + kernel)
