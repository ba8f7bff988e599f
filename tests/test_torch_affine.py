"""The port's affine point form against the reference's, at 4-bit windows.

Limbs and digits are integers and verdicts booleans, so every comparison
is exact.  The reference's Pallas kernel runs in interpret mode, once per
variant, in module fixtures; the point form is passed to it explicitly, so
no reference global is changed.  The CUDA kernel's affine instantiations
are held against the plain version in test_torch_cuda.py; the 5-bit form
is test_torch_affine5.py.
"""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from tpunode.verify import bounds as RB
from tpunode.verify import curve as RC
from tpunode.verify import field as RF
from tpunode.verify import kernel as RK
from tpunode.verify.pallas_kernel import verify_blocked as ref_verify_blocked
from tpunode_torch import cuda_diag
from tpunode_torch.verify import bounds as B
from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import curve as C
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import field as F
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LANES = 16


# ---------- helpers shared with test_torch_affine5.py ------------------------


def _limb_cols(vals) -> np.ndarray:
    """Python ints -> (24, len) int32 limb rows."""
    return np.stack([F.to_limbs(v % F.P) for v in vals], axis=1).astype(np.int32)


@jax.jit
def _ref_ladder_pm2(t):
    """t^(p-2) as the Pallas kernel computes it (pallas_kernel.py:189-212):
    16 powers by sequential muls, 64 windows of four squarings and a mul,
    with the reference's field."""
    one = jnp.broadcast_to(RF.ONE, t.shape)
    table = [one, t]
    for _ in range(14):
        table.append(RF.mul(table[-1], t))
    table = jnp.stack(table)

    def window(acc, d):
        acc = RF.sqr(RF.sqr(RF.sqr(RF.sqr(acc))))
        return RF.mul(acc, table[d]), None

    return jax.lax.scan(window, one, jnp.asarray(K._PM2_DIGITS, dtype=jnp.int32))[0]


def pallas_order_affine_table(qx: np.ndarray, qy: np.ndarray) -> np.ndarray:
    """The Pallas kernel's affine Q table (pallas_kernel.py:220-260) with
    the reference's field and formulas, at the reference's active width:
    the scan-form projective chain, prefix products with p_1 = 1, one
    Fermat ladder, the suffix pass (its multiply by p_1 at entry 2
    included).  (2^wb, 2, 24, B) int32."""
    proj = RK._build_q_table(jnp.asarray(qx), jnp.asarray(qy))
    ent_n = proj.shape[0]
    one = jnp.broadcast_to(RF.ONE, proj.shape[-2:])
    zs = [None, None] + [proj[k, 2] for k in range(2, ent_n)]
    prefix = [None, one, zs[2]]
    for k in range(3, ent_n):
        prefix.append(RF.mul(prefix[-1], zs[k]))
    run = _ref_ladder_pm2(prefix[-1])
    ent = [None] * ent_n
    ent[0] = jnp.stack([jnp.zeros_like(one), one])
    ent[1] = proj[1, :2]
    for k in range(ent_n - 1, 1, -1):
        zinv = RF.mul(run, prefix[k - 1])
        ent[k] = jnp.stack([RF.mul(proj[k, 0], zinv), RF.mul(proj[k, 1], zinv)])
        run = RF.mul(run, zs[k])
    return np.asarray(jnp.stack(ent))


def table_points(rng: random.Random, n: int) -> list:
    """``n`` pubkeys on the curve, then one off it (5, 7)."""
    return [O.point_mul(rng.getrandbits(256) % O.CURVE_N or 1, O.GENERATOR)
            for _ in range(n)] + [O.Point(5, 7)]


def check_affine_table(points: list, wb: int) -> None:
    """The port's affine Q table at ``wb``: limb for limb the Pallas order
    on every lane whose Q is on the curve, and k·Q at entry k."""
    qx, qy = _limb_cols([q.x for q in points]), _limb_cols([q.y for q in points])
    got = K._affine_q_table(torch.from_numpy(qx), torch.from_numpy(qy), wb,
                            ladder="scan", sqr="half", mul="shift_add").numpy()
    ref = pallas_order_affine_table(qx, qy)
    assert got.shape == ref.shape == (1 << wb, 2, 24, len(points))
    on_curve = [i for i, q in enumerate(points) if q.on_curve()]
    assert np.array_equal(got[..., on_curve], ref[..., on_curve])
    for i in on_curve:
        acc = O.Point(None, None)
        for k in range(1, 1 << wb):
            acc = O.point_add(acc, points[i])
            assert F.from_limbs(got[k, 0, :, i]) % F.P == acc.x, (k, i)
            assert F.from_limbs(got[k, 1, :, i]) % F.P == acc.y, (k, i)
    assert got[0, :, :, 0].tolist() == [[0] * 24, [1] + [0] * 23]


def reference_affine_verdicts(items: list, schnorr_free: bool) -> list:
    """The reference's Pallas kernel in the affine form, interpret mode, at
    its active width."""
    prep = RK.prepare_batch(items, pad_to=len(items), native=False)
    assert prep.schnorr_free == schnorr_free
    out = ref_verify_blocked(*(jnp.asarray(a) for a in prep.device_args), interpret=True,
                             block=8, schnorr_free=schnorr_free, point_form="affine")
    return [bool(v) for v in np.asarray(out)]


def port_verdicts(items: list, wb: int, point_form: str) -> list:
    prep = K.prepare_batch_raw(pack_items(items), pad_to=len(items), window_bits=wb)
    launches = dict(cuda_kernel.LAUNCHES)
    args = K.from_reference(prep.device_args, "cpu")
    got = cuda_kernel.verify_blocked(*args, schnorr_free=prep.schnorr_free,
                                     point_form=point_form, select="tree", ladder="scan", sqr="half",
                                     mul="shift_add")
    assert cuda_kernel.LAUNCHES == launches  # a CPU tensor never reaches the kernel
    return got.tolist()


def run_campaign_cli(wb: int) -> dict:
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "tpunode_torch.campaign", "3", "32", "--window-bits", str(wb),
         "--point-form", "affine", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


# ---------- fixtures ---------------------------------------------------------


@pytest.fixture(scope="module")
def items():
    return chip_smoke.adversarial_items(O, random.Random(0xBA7C), lanes=LANES)


@pytest.fixture(scope="module")
def ecdsa(items):
    return [it for it in items if len(it) == 4][:8]


@pytest.fixture(scope="module")
def ref_full(items):
    return reference_affine_verdicts(items, schnorr_free=False)


@pytest.fixture(scope="module")
def ref_schnorr_free(ecdsa):
    return reference_affine_verdicts(ecdsa, schnorr_free=True)


# ---------- the mixed add ----------------------------------------------------


def _mixed_cases(rng: np.random.Generator) -> tuple:
    """(p, q) limb stacks over lanes: seeded projective p with a random Z
    against seeded affine q (some negated), then p = O, p = q, p = -q and
    p = q with another Z (the same x)."""
    ks = [int(v) for v in rng.integers(1, 2**62, size=8)]
    pts = [O.point_mul(k, O.GENERATOR) for k in ks]
    qs = [O.point_mul(k + 12345, O.GENERATOR) for k in ks]
    zs = [int(v) for v in rng.integers(2, 2**62, size=len(pts) + 3)]
    q0 = qs[0]
    p_rows = [(p.x * z, p.y * z, z) for p, z in zip(pts, zs)] + [
        (0, 1, 0),  # O
        (q0.x * zs[-3], q0.y * zs[-3], zs[-3]),  # q, another Z
        (q0.x, -q0.y, 1),  # -q
        (q0.x * zs[-2], q0.y * zs[-2], zs[-2]),  # q again: the same x
    ]
    q_rows = [(q.x, q.y) for q in qs] + [(q0.x, q0.y)] * 4
    p = np.stack([_limb_cols(c) for c in zip(*p_rows)])
    q = np.stack([_limb_cols(c) for c in zip(*q_rows)])
    q[1][:, [0, 3, 6]] *= -1  # negated limbs, as a signed select gives them
    return p, q


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
def test_pt_add_mixed_matches_reference_limb_for_limb(reduce):
    p, q = _mixed_cases(np.random.default_rng(0xAFF))
    got = C.pt_add_mixed(torch.from_numpy(p), torch.from_numpy(q), reduce=reduce).numpy()
    ref = np.asarray(RC.pt_add_mixed(jnp.asarray(p), jnp.asarray(q), reduce=reduce))
    assert got.dtype == np.int32 and np.array_equal(got, ref)


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
def test_pt_add_mixed_is_the_group_law_at_o_and_plus_minus_q(reduce):
    p, q = _mixed_cases(np.random.default_rng(0xAFF))
    got = C.pt_add_mixed(torch.from_numpy(p), torch.from_numpy(q), reduce=reduce).numpy()

    def affine(lane):
        x, y, z = (F.from_limbs(got[c, :, lane]) % F.P for c in range(3))
        if z == 0:
            return None
        zi = pow(z, -1, F.P)
        return x * zi % F.P, y * zi % F.P

    q0 = (F.from_limbs(q[0, :, -1]) % F.P, F.from_limbs(q[1, :, -1]) % F.P)
    dbl = O.point_add(O.Point(*q0), O.Point(*q0))
    assert affine(8) == q0  # O + q
    assert affine(9) == affine(11) == (dbl.x, dbl.y)  # q + q
    assert affine(10) is None  # -q + q
    for lane in range(8):  # the generic lanes against the oracle's affine add
        pz = F.from_limbs(p[2, :, lane])
        pa = O.Point(F.from_limbs(p[0, :, lane]) * pow(pz, -1, F.P) % F.P,
                     F.from_limbs(p[1, :, lane]) * pow(pz, -1, F.P) % F.P)
        qa = O.Point(F.from_limbs(q[0, :, lane]) % F.P, F.from_limbs(q[1, :, lane]) % F.P)
        want = O.point_add(pa, qa)
        assert affine(lane) == (want.x, want.y), lane


# ---------- the affine tables --------------------------------------------------


def test_affine_window_tables_drop_the_z_plane():
    for wb in (4, 5):
        g, lg = K.window_tables(wb, "affine")
        pg, plg = K.window_tables(wb)
        assert g.shape == lg.shape == (1 << wb, 2, 24)
        assert np.array_equal(g, pg[:, :2]) and np.array_equal(lg, plg[:, :2])
        assert (pg[1:, 2, 0] == 1).all() and not pg[1:, 2, 1:].any()  # Z = 1 dropped
    assert np.array_equal(K.window_tables(4, "affine")[0], np.asarray(RK.G_TABLE_AFF))
    assert np.array_equal(K.window_tables(4, "affine")[1], np.asarray(RK.LG_TABLE_AFF))
    with pytest.raises(ValueError, match="point form"):
        K.window_tables(4, "jacobian")


def test_affine_q_table_matches_the_pallas_order():
    check_affine_table(table_points(random.Random(0x7AB), 5), 4)


def test_affine_q_table_equals_the_reference_xla_table_mod_p():
    points = table_points(random.Random(0x7AC), 4)[:4]
    qx, qy = _limb_cols([q.x for q in points]), _limb_cols([q.y for q in points])
    got = K._affine_q_table(torch.from_numpy(qx), torch.from_numpy(qy), 4, ladder="scan", sqr="half",
                            mul="shift_add")
    ref = RK._normalize_q_table(RK._build_q_table(jnp.asarray(qx), jnp.asarray(qy)))
    ref = torch.from_numpy(np.array(ref))
    for k in range(16):
        for c in range(2):
            assert torch.equal(F.canonical(got[k, c]), F.canonical(ref[k, c])), (k, c)


def test_affine_q_table_entry_2_takes_the_multiply_by_one():
    """Entry 2's inverse is run · p_1 with p_1 = 1, as in the Pallas kernel:
    the port holds those limbs, and the XLA table's (which skips the
    multiply) only mod p."""
    points = table_points(random.Random(0x7AD), 3)[:3]
    qx, qy = _limb_cols([q.x for q in points]), _limb_cols([q.y for q in points])
    got = K._affine_q_table(torch.from_numpy(qx), torch.from_numpy(qy), 4,
                            ladder="scan", sqr="half", mul="shift_add")[2].numpy()
    proj = RK._build_q_table(jnp.asarray(qx), jnp.asarray(qy))
    prefix = proj[2, 2]
    for k in range(3, 16):
        prefix = RF.mul(prefix, proj[k, 2])
    run = _ref_ladder_pm2(prefix)
    for k in range(15, 2, -1):
        run = RF.mul(run, proj[k, 2])  # entering entry 2: run = z_2^-1
    zinv = RF.mul(run, jnp.broadcast_to(RF.ONE, run.shape))
    want = np.stack([np.asarray(RF.mul(proj[2, c], zinv)) for c in range(2)])
    assert np.array_equal(got, want)
    xla = np.array(RK._normalize_q_table(proj)[2])
    for c in range(2):
        assert torch.equal(F.canonical(torch.from_numpy(got[c])),
                           F.canonical(torch.from_numpy(xla[c])))
    double = [O.point_add(q, q) for q in points]
    assert [F.from_limbs(got[0, :, i]) % F.P for i in range(3)] == [d.x for d in double]


# ---------- bounds --------------------------------------------------------------


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
def test_bound_replay_of_the_mixed_add_equals_the_reference(reduce):
    got = B.audit_formulas(reduce)
    assert got["pt_add_mixed"] == RB.audit_formulas(reduce)["pt_add_mixed"]
    assert got == RB.audit_formulas(reduce)


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
def test_bound_replay_covers_the_affine_window_program(window_bits, reduce):
    got = B.audit_window_program(window_bits, "affine", reduce)
    assert got["inversion"] <= B.AFFINE_BOUND
    assert max(got["q_table"], got["lambda_x"], got["window_round"]) <= B.COORD_BOUND
    per_formula = B.audit_formulas(reduce)
    assert got["window_round"] == max(per_formula["pt_double"], per_formula["pt_add_mixed"])
    B.assert_formulas_safe(reduce, window_bits=window_bits, point_form="affine")
    assert (reduce, window_bits, "affine", "scan") in B._AUDITED
    with pytest.raises(ValueError, match="point form"):
        B.audit_window_program(window_bits, "jacobian", reduce)


def test_bound_replay_catches_an_affine_operand_past_its_contract(monkeypatch):
    monkeypatch.setattr(B, "AFFINE_BOUND", 1 << 10)
    with pytest.raises(B.BoundOverflow, match="affine table entry"):
        B.audit_window_program(4, "affine", "lazy")


# ---------- the plain program against the reference kernel --------------------


def test_batch_covers_every_lane_kind(items, ref_full):
    assert ref_full == O.verify_batch_cpu(items)
    assert {it[4] for it in items if len(it) == 5} == {"schnorr", "bip340"}
    assert any(ref_full) and not all(ref_full)
    assert any(it[0] is not None and not it[0].on_curve() for it in items)


def test_plain_affine_verify_matches_reference_kernel(items, ref_full):
    got = port_verdicts(items, 4, "affine")
    assert got == ref_full == port_verdicts(items, 4, "projective") == O.verify_batch_cpu(items)


def test_plain_affine_schnorr_free_matches_reference_kernel(ecdsa, ref_schnorr_free):
    got = port_verdicts(ecdsa, 4, "affine")
    assert got == ref_schnorr_free == port_verdicts(ecdsa, 4, "projective")
    assert got == O.verify_batch_cpu(ecdsa)


def test_affine_engine_on_the_cpu_matches_reference_kernel(items, ref_full, monkeypatch):
    """The engine's form travels to every dispatch; the knob is read only
    when the config names no form."""
    forms = []
    real = K.verify_core

    def spy(*args, schnorr_free, point_form, reduce, select, ladder, sqr, mul):
        forms.append(point_form)
        return real(*args, schnorr_free=schnorr_free, point_form=point_form, reduce=reduce,
                    select=select, ladder=ladder, sqr=sqr, mul=mul)

    monkeypatch.setattr(K, "verify_core", spy)
    monkeypatch.setenv("TPUNODE_POINT_FORM", "affine")
    engine = VerifyEngine(VerifyConfig(device="cpu", batch_size=8, device_batch=LANES))
    assert engine.cfg.point_form == "affine" and forms == ["affine"] * 2  # warmup
    assert engine.verify_sync(items) == ref_full
    monkeypatch.setenv("TPUNODE_POINT_FORM", "projective")
    assert engine.verify_raw_sync(pack_items(items)) == ref_full
    assert forms == ["affine"] * 4


def test_campaign_cli_in_the_affine_form():
    res = run_campaign_cli(4)
    assert (res["mismatches"], res["items"], res["window_bits"], res["point_form"]) == (
        0, 21, 4, "affine")
    assert res["kernel"] == "plain"


def test_wrapper_rejects_a_point_form_it_lacks(items):
    prep = K.prepare_batch_raw(pack_items(items[:4]))
    args = K.from_reference(prep.device_args, "cpu")
    with pytest.raises(ValueError, match="point form"):
        cuda_kernel.verify_blocked(*args, schnorr_free=False, point_form="jacobian", select="tree",
                                   ladder="scan", sqr="half", mul="shift_add")
    with pytest.raises(ValueError, match="point form"):
        K.verify_batch_gpu(items[:4], device="cpu", point_form="Affine", select="tree",
                           ladder="scan", sqr="half", mul="shift_add")


# ---------- the two probes' plain versions -------------------------------------


def test_probes_run_their_plain_versions_on_the_cpu():
    launches = dict(cuda_diag.LAUNCHES)
    res = cuda_diag.run("cpu")
    assert res["diag"] == "plain" and res["device"] == "cpu"
    assert [(c["case"], c["ok"], c["bad_lanes"], c["lanes"]) for c in res["cases"]] == [
        ("trivial", True, 0, 1024), ("field_mul", True, 0, 768), ("field_mul_dot", True, 0, 768),
        ("lazy_reduce", True, 0, 512), ("mixed_add", True, 0, 256), ("batch_inv", True, 0, 256), ("table_build", True, 0, 256),
        ("pow_descan", True, 0, 256), ("select_tree", True, 0, 256),
        ("pow_window", True, 0, 256), ("pow_window_smem", True, 0, 256), ("window5", True, 0, 256)]
    assert cuda_diag.LAUNCHES == launches


def test_mixed_add_probe_matches_reference_formula():
    inputs = cuda_diag.probe_inputs("mixed_add", "cpu", lanes=4)
    got = cuda_diag.mixed_add(*inputs).numpy()
    px, py, qx, qy = (jnp.asarray(t.numpy()) for t in inputs)
    one = jnp.broadcast_to(RF.ONE, px.shape)
    ref = np.asarray(RC.pt_add_mixed(jnp.stack([px, py, one]), jnp.stack([qx, qy])))
    assert np.array_equal(got, ref)


def test_batch_inv_probe_inverts_every_lane_and_catches_a_wrong_one():
    (z,) = cuda_diag.probe_inputs("batch_inv", "cpu", lanes=8)
    out = cuda_diag.batch_inv(z)
    assert out.tolist() == np.repeat(F.to_limbs(1)[:, None], 8, axis=1).tolist()
    bad = out.clone()
    bad[0, 3] = 2
    assert cuda_diag._host_check("batch_inv", bad) == 1
    wrong = cuda_diag.mixed_add(*cuda_diag.probe_inputs("mixed_add", "cpu", lanes=2))
    wrong[0, 5, 1] += 1
    assert cuda_diag._host_check("mixed_add", wrong) == 1


def test_probe_cli_without_a_card_exits_nonzero_and_with_cpu_prints_one_line():
    env = {**os.environ, "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "tpunode_torch.cuda_diag"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"cases"' not in proc.stdout
    proc = subprocess.run([sys.executable, "-m", "tpunode_torch.cuda_diag", "--device", "cpu"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    (line,) = proc.stdout.strip().splitlines()
    assert all(c["ok"] for c in json.loads(line)["cases"])


def test_probe_wrappers_reject_malformed_arguments():
    (z,) = cuda_diag.probe_inputs("batch_inv", "cpu", lanes=4)
    with pytest.raises(ValueError):
        cuda_diag.batch_inv(z.to(torch.int64))
    with pytest.raises(ValueError):
        cuda_diag.batch_inv(z[:-1])
    with pytest.raises(ValueError):
        cuda_diag.mixed_add(z, z, z, z[:, :2])
