"""The port's one-hot table select against the reference's, and the three
select-layer probes' plain versions against the reference probe bodies.

Under ``TPUNODE_SELECT16=onehot`` a digit picks its window-table entry by a
compare and accumulate over every entry instead of the 4- or 5-level tree.
The reference's select mode is a process global (``kernel.set_kernel_modes``),
read when its programs are traced; every use of it here goes through
:func:`reference_onehot`, which restores it in ``finally``.  The reference's
Pallas kernel runs in interpret mode once, in a module fixture: 4-bit
projective lazy, full variant, on the 16-lane adversarial set of
test_torch_kernel.py (all three algorithms, corrupted items among them).
Inputs come from seeds through numpy.  Limbs are integers and verdicts
booleans: tolerance zero on every limb and verdict.  The CUDA kernel's
one-hot instantiations are held against the plain version in
test_torch_cuda.py (card) and test_torch_hostcc.py (host C++).
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
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from tpunode.verify import kernel as RK
from tpunode.verify import pallas_field as PF
from tpunode.verify.pallas_kernel import verify_blocked as ref_verify_blocked
from tpunode_torch import cuda_diag
from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import engine as E
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import field as F
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LANES = 16


@contextlib.contextmanager
def reference_onehot():
    """The reference package with the one-hot select, restored on exit."""
    prev = RK.set_kernel_modes(select="onehot")[0]
    try:
        yield
    finally:
        RK.set_kernel_modes(select=prev)


@pytest.fixture(scope="module")
def items():
    return chip_smoke.adversarial_items(O, random.Random(0xBA7C), lanes=LANES)


@pytest.fixture(scope="module")
def ref_onehot(items):
    """The reference's Pallas kernel with the one-hot select, 4-bit
    projective lazy, full variant."""
    with reference_onehot():
        prep = RK.prepare_batch(items, pad_to=LANES, native=False)
        out = ref_verify_blocked(*(jnp.asarray(a) for a in prep.device_args), interpret=True,
                                 block=8, schnorr_free=False, point_form="projective")
        return [bool(v) for v in np.asarray(out)]


# ---------- the select itself --------------------------------------------------


@pytest.mark.parametrize("shared", [False, True], ids=["per_lane", "constant"])
@pytest.mark.parametrize("coords", [3, 2], ids=["projective", "affine"])
@pytest.mark.parametrize("entries", [16, 32])
def test_select_onehot_matches_the_reference(entries, coords, shared):
    """kernel.select_onehot against the reference's _select_entry_onehot on
    a per-lane (T, C, L, B) table or a constant (T, C, L) one, whose entries
    the port keeps as (C, L, 1) columns; every digit in [0, T) occurs."""
    rng = np.random.default_rng(0x0E + entries + coords + shared)
    b = 2 * entries
    shape = (entries, coords, 24) + (() if shared else (b,))
    table = rng.integers(-(1 << 20), 1 << 20, size=shape).astype(np.int32)
    digits = rng.permutation(np.arange(b) % entries).astype(np.int32)
    ref = np.asarray(RK._select_entry_onehot(jnp.asarray(table), jnp.asarray(digits)))
    t = torch.from_numpy(table)
    entries_ = [e[..., None] for e in t] if shared else list(t)
    got = K.select_onehot(entries_, torch.from_numpy(digits))
    assert got.dtype == torch.int32 and tuple(got.shape) == (coords, 24, b)
    assert np.array_equal(got.numpy(), ref)
    assert torch.equal(got, K.select_tree16(entries_, torch.from_numpy(digits)))


# ---------- the plain program against the reference kernel --------------------


def test_reference_fixture_ran_the_onehot_program(items, ref_onehot):
    assert ref_onehot == O.verify_batch_cpu(items)
    assert RK.select_mode() == "tree"  # restored
    assert any(ref_onehot) and not all(ref_onehot)
    assert {it[4] for it in items if len(it) == 5} == {"schnorr", "bip340"}


def test_plain_onehot_matches_reference_kernel(items, ref_onehot):
    prep = K.prepare_batch_raw(pack_items(items), pad_to=LANES)
    args = K.from_reference(prep.device_args, "cpu")
    launches = dict(cuda_kernel.LAUNCHES)
    got = cuda_kernel.verify_blocked(*args, schnorr_free=prep.schnorr_free, select="onehot",
                                     ladder="scan", sqr="half", mul="shift_add")
    assert got.tolist() == ref_onehot
    assert cuda_kernel.LAUNCHES == launches  # a CPU tensor never reaches the kernel


# ---------- the knob -----------------------------------------------------------


def _record_dispatch(monkeypatch) -> list:
    """Record each dispatch's select; return zeros without computing."""
    selects = []

    def dispatch(raw, pad_to=None, device=None, window_bits=None, point_form=None,
                 reduce=None, select=None, ladder=None, sqr=None, mul=None):
        selects.append(select)
        return torch.zeros(pad_to, dtype=torch.bool), len(raw)

    monkeypatch.setattr(E, "dispatch_batch_gpu_raw", dispatch)
    return selects


def test_select_knob_runs_onehot_through_the_mode_tuple_and_the_engine(items, ref_onehot,
                                                                       monkeypatch):
    """TPUNODE_SELECT16=onehot runs: kernel_modes reports it, and an engine
    built under it reports it and runs the one-hot plain program, whose
    verdicts equal the reference's."""
    monkeypatch.setenv("TPUNODE_SELECT16", "onehot")
    assert K.select_mode() == "onehot" and K.kernel_modes()[4] == "onehot"
    assert K.kernel_modes(4, "projective", "lazy", "tree")[4] == "tree"  # the call's wins
    selects = []
    real = K.verify_core

    def spy(*args, schnorr_free, point_form, reduce, select, ladder, sqr, mul):
        selects.append(select)
        return real(*args, schnorr_free=schnorr_free, point_form=point_form, reduce=reduce,
                    select=select, ladder=ladder, sqr=sqr, mul=mul)

    monkeypatch.setattr(K, "verify_core", spy)
    monkeypatch.setattr(E.VerifyEngine, "_warmup_fn",
                        staticmethod(lambda bs, db=0, **kw: "cpu"))  # no warmup batch
    engine = E.VerifyEngine(E.VerifyConfig(device="cpu", warmup=False, batch_size=LANES,
                                           device_batch=LANES))
    assert engine.select == "onehot" and engine.modes()[4] == "onehot"
    assert engine.verify_sync(items) == ref_onehot and selects == ["onehot"]
    monkeypatch.delenv("TPUNODE_SELECT16")
    assert K.select_mode() == "tree" and K.kernel_modes()[4] == "tree"


def test_engine_keeps_the_select_it_was_built_with(monkeypatch, items):
    """The engine reads the knob once, at construction: a later change of
    the environment, even to a value that names no mode, reaches no built
    engine."""
    selects = _record_dispatch(monkeypatch)
    monkeypatch.setattr(E.VerifyEngine, "_warmup_fn",
                        staticmethod(lambda bs, db=0, **kw: "cpu"))  # no warmup batch
    monkeypatch.setenv("TPUNODE_SELECT16", "onehot")
    onehot = E.VerifyEngine(E.VerifyConfig(device="cpu", warmup=False, batch_size=4,
                                           device_batch=8))
    monkeypatch.delenv("TPUNODE_SELECT16")
    tree = E.VerifyEngine(E.VerifyConfig(device="cpu", warmup=False, batch_size=4,
                                         device_batch=8))
    monkeypatch.setenv("TPUNODE_SELECT16", "onehot")
    onehot.verify_sync(items[:10])
    tree.verify_sync(items[:3])
    assert selects == ["onehot", "onehot", "tree"]
    monkeypatch.setenv("TPUNODE_SELECT16", "bogus")
    onehot.verify_raw_sync(pack_items(items[:2]))
    assert selects[-1] == "onehot" and (onehot.select, tree.select) == ("onehot", "tree")
    with pytest.raises(ValueError, match="TPUNODE_SELECT16"):
        E.VerifyEngine(E.VerifyConfig(device="cpu", warmup=False))


def test_select_naming_no_mode_is_refused(items):
    """A select outside SELECT_MODES raises ValueError in the mode tuple, the
    plain program and the launcher before any work; the launcher takes no
    default select."""
    with pytest.raises(ValueError, match="select mode"):
        K.check_select("Onehot")
    with pytest.raises(ValueError, match="select mode"):
        K.kernel_modes(4, "projective", "lazy", "one-hot")
    prep = K.prepare_batch_raw(pack_items(items[:4]), pad_to=4)
    args = K.from_reference(prep.device_args, "cpu")
    for bad in ("2", "", "TREE"):
        with pytest.raises(ValueError, match="select mode"):
            cuda_kernel.verify_blocked(*args, schnorr_free=False, select=bad, ladder="scan", sqr="half",
                                       mul="shift_add")
        with pytest.raises(ValueError, match="select mode"):
            K.verify_core(*args, schnorr_free=False, select=bad, ladder="scan", sqr="half",
                          mul="shift_add")
    with pytest.raises(TypeError, match="select"):
        cuda_kernel.verify_blocked(*args, schnorr_free=False)
    assert cuda_kernel._SELECT_CODES == {"tree": 0, "onehot": 1}
    assert {key[3] for key in cuda_kernel.LAUNCHES} == set(K.SELECT_MODES)
    assert len(cuda_kernel.LAUNCHES) == 256  # 128 instantiations, each for both ladders


def test_campaign_cli_under_the_onehot_knob():
    env = {**os.environ, "OMP_NUM_THREADS": "1", "TPUNODE_SELECT16": "onehot"}
    proc = subprocess.run(
        [sys.executable, "-m", "tpunode_torch.campaign", "3", "32", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    (line,) = proc.stdout.strip().splitlines()
    res = json.loads(line)
    assert (res["mismatches"], res["items"], res["select"], res["kernel"]) == (
        0, 21, "onehot", "plain")
    assert (res["window_bits"], res["point_form"], res["field_reduce"]) == (4, "projective",
                                                                           "lazy")


# ---------- the three select-layer probes --------------------------------------


def _one(b: int):
    return jnp.concatenate([jnp.ones((1, b), jnp.int32), jnp.zeros((F.NLIMBS - 1, b), jnp.int32)],
                           axis=0)


def _tree(entries: list, d):
    level = list(entries)
    for i in range(len(level).bit_length() - 1):
        bit = ((d >> i) & 1) == 1
        level = [jnp.where(bit, level[2 * j + 1], level[2 * j]) for j in range(len(level) // 2)]
    return level[0]


def _build(tab_ref, t, entries: int) -> None:
    """The reference probes' power table: pl.ds stores in a fori_loop."""
    tab_ref[0] = _one(t.shape[-1])
    tab_ref[1] = t

    def build(k, c):
        tab_ref[pl.ds(k, 1)] = PF.mul(tab_ref[pl.ds(k - 1, 1)][0], t)[None]
        return c

    lax.fori_loop(2, entries, build, 0)


def _reference_select_tree(t: torch.Tensor, d: torch.Tensor) -> np.ndarray:
    """mosaic_diag._select_tree's kernel body, interpret mode."""
    b = t.shape[-1]

    def kernel(a_ref, d_ref, o_ref, tab_ref):
        _build(tab_ref, a_ref[...], 16)
        o_ref[...] = PF.canonical(_tree([tab_ref[tv] for tv in range(16)], d_ref[...]))

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(tuple(t.shape), jnp.int32),
        scratch_shapes=[pltpu.VMEM((16, F.NLIMBS, b), jnp.int32)], interpret=True,
    )(jnp.asarray(t.numpy()), jnp.asarray(d.numpy()[None])))


def _reference_pow_window(t: torch.Tensor, digits: torch.Tensor) -> np.ndarray:
    """mosaic_diag._pow_window_impl's kernel body, interpret mode, digits in
    the SMEM block spec."""
    b = t.shape[-1]

    def kernel(a_ref, dig_ref, o_ref, powtab_ref):
        _build(powtab_ref, a_ref[...], 16)

        def window(w, pacc):
            pacc = PF.sqr(PF.sqr(PF.sqr(PF.sqr(pacc))))
            d = dig_ref[0, w]
            sel = None
            for tv in range(16):
                contrib = jnp.where(d == tv, powtab_ref[tv], 0)
                sel = contrib if sel is None else sel + contrib
            return PF.mul(pacc, sel)

        o_ref[...] = PF.canonical(lax.fori_loop(0, 64, window, _one(b)))

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(tuple(t.shape), jnp.int32),
        in_specs=[pl.BlockSpec(tuple(t.shape)), pl.BlockSpec((2, 64), memory_space=pltpu.SMEM)],
        scratch_shapes=[pltpu.VMEM((16, F.NLIMBS, b), jnp.int32)], interpret=True,
    )(jnp.asarray(t.numpy()), jnp.asarray(digits.numpy())))


def _reference_window5(a: torch.Tensor, g: torch.Tensor, d: torch.Tensor) -> np.ndarray:
    """mosaic_diag._window5's kernel body, interpret mode, with the shared
    (32, L, 1) table."""
    b = a.shape[-1]

    def kernel(a_ref, g_ref, d_ref, o_ref, tab_ref):
        _build(tab_ref, a_ref[...], 32)
        dv = d_ref[...]
        mine = _tree([tab_ref[tv] for tv in range(32)], dv)
        shared = _tree([g_ref[tv] for tv in range(32)], dv)
        o_ref[...] = PF.canonical(PF.mul(mine, shared))

    gtab = g.numpy()[..., None]
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(tuple(a.shape), jnp.int32),
        in_specs=[pl.BlockSpec(tuple(a.shape)), pl.BlockSpec(gtab.shape), pl.BlockSpec((1, b))],
        scratch_shapes=[pltpu.VMEM((32, F.NLIMBS, b), jnp.int32)], interpret=True,
    )(jnp.asarray(a.numpy()), jnp.asarray(gtab), jnp.asarray(d.numpy()[None])))


def test_select_tree_probe_matches_the_reference_probe():
    """The reference probe's own inputs (default_rng(23): t below 2^31,
    then d below 16)."""
    t, d = cuda_diag.probe_inputs("select_tree", "cpu", lanes=8)
    rng = np.random.default_rng(23)
    av = [int(rng.integers(2, 2**31)) for _ in range(8)]
    assert [F.from_limbs(t[:, i]) for i in range(8)] == av
    assert d.tolist() == [int(rng.integers(0, 16)) for _ in range(8)]
    got = cuda_diag.select_tree(t, d)
    assert np.array_equal(got.numpy(), _reference_select_tree(t, d))
    assert cuda_diag._host_check("select_tree", got, (t, d)) == 0
    bad = got.clone()
    bad[0, 3] += 1
    assert cuda_diag._host_check("select_tree", bad, (t, d)) == 1


def test_pow_window_probes_match_the_reference_probe():
    """Both cases: the reference probe's quadratic residues
    (default_rng(13)) and the digits of (p-1)/2 in both rows; every lane
    canonicalises to 1 (Euler's criterion)."""
    t, digits = cuda_diag.probe_inputs("pow_window", "cpu", lanes=8)
    rng = np.random.default_rng(13)
    assert [F.from_limbs(t[:, i]) for i in range(8)] == [
        int(rng.integers(2, 2**61)) ** 2 % F.P for _ in range(8)]
    exp = (F.P - 1) // 2
    assert digits.tolist() == [[(exp >> (4 * (63 - w))) & 0xF for w in range(64)]] * 2
    ref = _reference_pow_window(t, digits)
    for case in ("pow_window", "pow_window_smem"):
        inputs = cuda_diag.probe_inputs(case, "cpu", lanes=8)
        got = cuda_diag.FUNCTIONS[case][0](*inputs)
        assert np.array_equal(got.numpy(), ref), case
        assert cuda_diag._host_check(case, got, inputs) == 0
    assert (ref == F.to_limbs(1)[:, None]).all()


def test_window5_probe_matches_the_reference_probe():
    """The reference probe's own inputs (default_rng(31): a below 2^31, then
    d below 32) and its shared table of 0xC0FFEE's powers."""
    a, g, d = cuda_diag.probe_inputs("window5", "cpu", lanes=8)
    assert tuple(g.shape) == (32, 24)
    assert [F.from_limbs(g[k]) for k in range(32)] == [pow(0xC0FFEE, k, F.P) for k in range(32)]
    got = cuda_diag.window5(a, g, d)
    assert np.array_equal(got.numpy(), _reference_window5(a, g, d))
    assert cuda_diag._host_check("window5", got, (a, g, d)) == 0
    bad = got.clone()
    bad[7, 5] ^= 1
    assert cuda_diag._host_check("window5", bad, (a, g, d)) == 1


def test_new_probe_wrappers_check_their_arguments():
    t, d = cuda_diag.probe_inputs("select_tree", "cpu", lanes=4)
    with pytest.raises(ValueError):
        cuda_diag.select_tree(t, d[:3])
    with pytest.raises(ValueError):
        cuda_diag.select_tree(t, d.to(torch.int64))
    t, digits = cuda_diag.probe_inputs("pow_window", "cpu", lanes=4)
    with pytest.raises(ValueError):
        cuda_diag.pow_window_smem(t, digits[:1])
    a, g, d = cuda_diag.probe_inputs("window5", "cpu", lanes=4)
    with pytest.raises(ValueError):
        cuda_diag.window5(a, g[:16], d)
    assert cuda_diag.PROBES[-4:] == ("select_tree", "pow_window", "pow_window_smem", "window5")
