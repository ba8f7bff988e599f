"""The port's eager reduction against the reference's, and the three
field-layer probes' plain versions.

Under ``TPUNODE_FIELD_REDUCE=eager`` every product of the point formulas is
reduced at once.  The reference's reduction mode is a process global
(``field.set_field_modes``), read when its programs are traced; every use of
it here goes through :func:`reference_eager`, which restores it, and the
reference's window width, in ``finally``.  The reference's Pallas kernel
runs in interpret mode in two module fixtures: 4-bit projective and 5-bit
affine, both full variant, on the 16-lane adversarial set of
test_torch_affine.py.  Limbs are integers and verdicts booleans: tolerance
zero.  The CUDA kernel's eager instantiations are held against the plain
version in test_torch_cuda.py (card) and test_torch_hostcc.py (host C++).
"""

import contextlib
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
from jax.experimental import pallas as pl

import chip_smoke
from tests.test_torch_affine import (
    _limb_cols,
    pallas_order_affine_table,
    reference_affine_verdicts,
    table_points,
)
from tpunode.verify import field as RF
from tpunode.verify import kernel as RK
from tpunode.verify import pallas_field as PF
from tpunode.verify.pallas_kernel import verify_blocked as ref_verify_blocked
from tpunode_torch import cuda_diag
from tpunode_torch.verify import bounds as B
from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import field as F
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LANES = 16


@contextlib.contextmanager
def reference_eager(wb: int = 4):
    """The reference package with eager reduction at window width ``wb``,
    both restored on exit."""
    prev_width = RK.set_kernel_modes(window_bits=wb)[2]
    try:
        prev_reduce = RF.set_field_modes(reduce="eager")[2]
        try:
            yield
        finally:
            RF.set_field_modes(reduce=prev_reduce)
    finally:
        RK.set_kernel_modes(window_bits=prev_width)


@pytest.fixture(scope="module")
def items():
    return chip_smoke.adversarial_items(O, random.Random(0xBA7C), lanes=LANES)


@pytest.fixture(scope="module")
def ref_w4_projective(items):
    """The reference's Pallas kernel, eager, 4-bit projective, full variant."""
    with reference_eager(4):
        prep = RK.prepare_batch(items, pad_to=LANES, native=False)
        out = ref_verify_blocked(*(jnp.asarray(a) for a in prep.device_args), interpret=True,
                                 block=8, schnorr_free=False, point_form="projective")
        return [bool(v) for v in np.asarray(out)]


@pytest.fixture(scope="module")
def ref_w5_affine(items):
    """The reference's Pallas kernel, eager, 5-bit affine, full variant."""
    with reference_eager(5):
        return reference_affine_verdicts(items, schnorr_free=False)


def _port(items: list, wb: int, form: str) -> list:
    """The port's plain program in the eager reduction, through the
    launcher's CPU path."""
    prep = K.prepare_batch_raw(pack_items(items), pad_to=len(items), window_bits=wb)
    args = K.from_reference(prep.device_args, "cpu")
    return cuda_kernel.verify_blocked(*args, schnorr_free=prep.schnorr_free, point_form=form,
                                      reduce="eager", select="tree", ladder="scan", sqr="half",
                                      mul="shift_add").tolist()


# ---------- the plain program against the reference kernel --------------------


def test_reference_fixtures_ran_the_eager_program(items, ref_w4_projective, ref_w5_affine):
    assert ref_w4_projective == ref_w5_affine == O.verify_batch_cpu(items)
    assert RF.reduce_mode() == "lazy" and RK.window_bits() == 4  # restored
    assert any(ref_w4_projective) and not all(ref_w4_projective)


def test_plain_eager_w4_projective_matches_reference_kernel(items, ref_w4_projective):
    launches = dict(cuda_kernel.LAUNCHES)
    assert _port(items, 4, "projective") == ref_w4_projective
    assert cuda_kernel.LAUNCHES == launches  # a CPU tensor never reaches the kernel


def test_plain_eager_w5_affine_matches_reference_kernel(items, ref_w5_affine):
    assert _port(items, 5, "affine") == ref_w5_affine


@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
@pytest.mark.parametrize("ecdsa_only", [False, True], ids=["full", "schnorr_free"])
def test_plain_eager_matches_the_oracle(items, ecdsa_only, window_bits, point_form):
    """Every width, form and variant; the ECDSA-only batch selects
    ``schnorr_free``."""
    batch = [it for it in items if len(it) == 4][:8] if ecdsa_only else items
    prep = K.prepare_batch_raw(pack_items(batch), pad_to=len(batch), window_bits=window_bits)
    assert prep.schnorr_free == ecdsa_only
    args = K.from_reference(prep.device_args, "cpu")
    got = K.verify_core(*args, schnorr_free=ecdsa_only, point_form=point_form, reduce="eager",
                        select="tree", ladder="scan", sqr="half", mul="shift_add")
    assert got.tolist() == O.verify_batch_cpu(batch)


def test_cpu_launcher_audits_the_eager_bounds(items, monkeypatch):
    """The launcher replays the bounds of the mode it runs, not the knob's."""
    monkeypatch.setattr(B, "_AUDITED", {})
    monkeypatch.setenv("TPUNODE_FIELD_REDUCE", "lazy")
    prep = K.prepare_batch_raw(pack_items(items[:4]), pad_to=4, window_bits=5)
    args = K.from_reference(prep.device_args, "cpu")
    cuda_kernel.verify_blocked(*args, schnorr_free=False, point_form="affine", reduce="eager",
                               select="tree", ladder="scan", sqr="half", mul="shift_add")
    assert set(B._AUDITED) == {("eager", 5, "affine", "scan")}
    with pytest.raises(ValueError, match="reduce mode"):
        B.assert_formulas_safe("bogus")


# ---------- the Q tables -------------------------------------------------------


def test_eager_projective_q_table_matches_reference():
    points = table_points(random.Random(0xEA6), 4)
    qx, qy = _limb_cols([q.x for q in points]), _limb_cols([q.y for q in points])
    got = K._build_q_table(torch.from_numpy(qx), torch.from_numpy(qy), 4, "eager",
                           ladder="scan", sqr="half", mul="shift_add").numpy()
    lazy = K._build_q_table(torch.from_numpy(qx), torch.from_numpy(qy), 4, "lazy",
                            ladder="scan", sqr="half", mul="shift_add").numpy()
    with reference_eager(4):
        ref = np.asarray(RK._build_q_table(jnp.asarray(qx), jnp.asarray(qy)))
    assert got.shape == ref.shape == (16, 3, 24, len(points))
    assert np.array_equal(got, ref)
    assert not np.array_equal(got, lazy)  # the same points, other limbs


def test_eager_affine_q_table_matches_the_pallas_order():
    points = table_points(random.Random(0xEA7), 4)
    qx, qy = _limb_cols([q.x for q in points]), _limb_cols([q.y for q in points])
    got = K._affine_q_table(torch.from_numpy(qx), torch.from_numpy(qy), 4, "eager",
                            ladder="scan", sqr="half", mul="shift_add").numpy()
    with reference_eager(4):
        ref = pallas_order_affine_table(qx, qy)
    on_curve = [i for i, q in enumerate(points) if q.on_curve()]
    assert np.array_equal(got[..., on_curve], ref[..., on_curve])
    for i in on_curve:
        acc = O.Point(None, None)
        for k in range(1, 16):
            acc = O.point_add(acc, points[i])
            assert F.from_limbs(got[k, 0, :, i]) % F.P == acc.x, (k, i)


# ---------- the engine and the campaign ---------------------------------------


def test_eager_engine_on_the_cpu_matches_reference_kernel(items, ref_w4_projective,
                                                          monkeypatch):
    reduces = []
    real = K.verify_core

    def spy(*args, schnorr_free, point_form, reduce, select, ladder, sqr, mul):
        reduces.append(reduce)
        return real(*args, schnorr_free=schnorr_free, point_form=point_form, reduce=reduce,
                    select=select, ladder=ladder, sqr=sqr, mul=mul)

    monkeypatch.setattr(K, "verify_core", spy)
    monkeypatch.delenv("TPUNODE_FIELD_REDUCE", raising=False)
    engine = VerifyEngine(VerifyConfig(field_reduce="eager", device="cpu", batch_size=8,
                                       device_batch=LANES))
    assert engine.verify_sync(items) == ref_w4_projective
    assert reduces == ["eager"] * 3  # warmup at 8 and 16 lanes, then the batch


def test_campaign_cli_with_eager_reduction():
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "tpunode_torch.campaign", "3", "32", "--field-reduce", "eager",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    (line,) = proc.stdout.strip().splitlines()
    res = json.loads(line)
    assert (res["mismatches"], res["items"], res["field_reduce"], res["kernel"]) == (
        0, 21, "eager", "plain")
    assert (res["window_bits"], res["point_form"]) == (4, "projective")


def test_campaign_cli_refuses_an_unknown_reduction():
    proc = subprocess.run(
        [sys.executable, "-m", "tpunode_torch.campaign", "3", "32", "--field-reduce", "eagre",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "--field-reduce" in proc.stderr


# ---------- the three field-layer probes ---------------------------------------


def _pallas(body, *cols):
    """``body`` over ``cols`` in a Pallas kernel, interpret mode, as the
    reference probes run it."""
    def kernel(*refs):
        refs[-1][...] = body(*(r[...] for r in refs[:-1]))

    out_shape = jax.ShapeDtypeStruct(cols[0].shape, jnp.int32)
    return np.asarray(pl.pallas_call(kernel, out_shape=out_shape, interpret=True)(
        *(jnp.asarray(c.numpy()) for c in cols)))


def test_trivial_probe_matches_the_reference_probe():
    (x,) = cuda_diag.probe_inputs("trivial", "cpu")
    assert tuple(x.shape) == (8, 128) and not x.any()
    got = cuda_diag.trivial(x)
    assert np.array_equal(got.numpy(), _pallas(lambda v: v + 1, x))
    assert int(got.sum()) == 8 * 128 and cuda_diag._host_check("trivial", got) == 0
    bad = got.clone()
    bad[3, 7] = 2
    assert cuda_diag._host_check("trivial", bad) == 1


def test_field_mul_probe_matches_the_reference_probe():
    """The reference probe's own lanes first (default_rng(7), below 2^63),
    then full-width values below p and limbs at mul's loose contract."""
    a, b = cuda_diag.probe_inputs("field_mul", "cpu", lanes=8)
    assert tuple(a.shape) == (24, 24)
    rng = np.random.default_rng(7)
    av = [int(rng.integers(0, 2**63)) for _ in range(8)]
    assert [F.from_limbs(a[:, i]) for i in range(8)] == av
    assert int(a[:, 8:16].abs().max()) < 1 << 11 and int(a[:, 16:].abs().max()) == 1 << 19
    assert int(a[-1, 16:].abs().max()) == 1 << 15 and int(a[:, 16:].min()) < 0
    got = cuda_diag.field_mul(a, b)
    assert np.array_equal(got.numpy(), _pallas(lambda x, y: PF.canonical(PF.mul(x, y)), a, b))
    assert cuda_diag._host_check("field_mul", got, (a, b)) == 0
    bad = got.clone()
    bad[0, 20] += 1
    assert cuda_diag._host_check("field_mul", bad, (a, b)) == 1


def test_lazy_reduce_probe_matches_the_reference_probe():
    """The reference probe's own lanes first (default_rng(29), below 2^61),
    then full-width values below p."""
    cols = cuda_diag.probe_inputs("lazy_reduce", "cpu", lanes=8)
    assert len(cols) == 4 and tuple(cols[0].shape) == (24, 16)
    rng = np.random.default_rng(29)
    first = [int(rng.integers(0, 2**61)) for _ in range(8)]
    assert [F.from_limbs(cols[0][:, i]) for i in range(8)] == first
    got = cuda_diag.lazy_reduce(*cols)

    def body(a, b, c, d):
        return PF.canonical(PF.reduce_wide_loose(PF.acc_add(PF.mul_t_wide(a, b),
                                                            PF.mul_t_wide(c, d))))

    assert np.array_equal(got.numpy(), _pallas(body, *cols))
    assert cuda_diag._host_check("lazy_reduce", got, cols) == 0
    bad = got.clone()
    bad[5, 12] ^= 1
    assert cuda_diag._host_check("lazy_reduce", bad, cols) == 1


def test_probe_wrappers_pair_with_their_plain_versions_on_the_cpu():
    assert tuple(cuda_diag.FUNCTIONS) == cuda_diag.PROBES == (
        "trivial", "field_mul", "field_mul_dot", "lazy_reduce", "mixed_add", "batch_inv",
        "table_build", "pow_descan", "select_tree", "pow_window", "pow_window_smem", "window5")
    launches = dict(cuda_diag.LAUNCHES)
    for name, (fn, plain) in cuda_diag.FUNCTIONS.items():
        inputs = cuda_diag.probe_inputs(name, "cpu", lanes=4)
        assert torch.equal(fn(*inputs), plain(*inputs)), name
    assert cuda_diag.LAUNCHES == launches
    with pytest.raises(ValueError):
        cuda_diag.trivial(torch.zeros((8, 128), dtype=torch.int64))
    with pytest.raises(ValueError):
        cuda_diag.field_mul(*(t[:, :3] for t in cuda_diag.probe_inputs("field_mul", "cpu", 4)))
