"""The CUDA sources compiled as host C++ under UBSan, against the plain version.

``tpunode_torch/csrc/host_check.cpp`` wraps the kernel's field and curve
functions, its window-table select, seven probe lanes, the field_mul_dot
probe's warps and their tensor-core contraction (``csrc/field_dot.cuh``,
the mma emulated a warp at a time) and the per-lane program
``verify_lane`` (both squares) in a plain C interface, and counts each
lane's calls of the convolutions (``conv``, ``sqr_conv``, ``conv_dot``,
``sqr_dot``).  The module fixture builds it twice, side by side, with
``g++ -O1 -fsanitize=undefined -fno-sanitize-recover=all`` into a
temporary directory, so a signed overflow or a shift out of range in the
card's code aborts the test process: as it is (shift_add), and under
``-DTPN_MUL_DOT=1``, where every convolution is the dot_general
contraction's per-lane form (the byte-plane split, the plane sums and the
recombination; a warp's mma is emulated only in the probe's contraction).
Inputs come from seeds through numpy.  Limbs are integers and verdicts
booleans, so every comparison is exact: ``mul_t``, ``sqr_t`` and the three
point formulas in both reductions and both squares limb for limb, the
one-hot select against the indexed read for every digit, the sixteen tree
instantiations of ``verify_lane`` (both widths, forms, reductions and
variants) against the plain version verdict for verdict on 16 adversarial
lanes, each one-hot instantiation against its tree twin, each
full-product tree instantiation against the plain version under
``sqr="mul"`` with, per lane, no ``sqr_conv`` call and as many ``conv``
calls as its half twin makes of both, the count of
``chip_smoke.kernel_ops_per_lane``; and the dot_general build's field and
point functions and its 4-bit lazy tree instantiations, both forms and
both squares, against the plain version under ``mul="dot_general"``, with
no shift-add convolution called and as many contractions as the shift-add
build makes convolutions.
"""

import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tpunode_torch import cuda_diag
from tpunode_torch.verify import bounds as B
from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import curve as C
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import field as F
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "tpunode_torch" / "csrc"
GXX_FLAGS = ("-std=c++17", "-O1", "-Wall", "-Wno-unknown-pragmas", "-fsanitize=undefined",
             "-fno-sanitize-recover=all", "-shared", "-fPIC")
LANES = 16


@pytest.fixture(scope="module")
def builds(tmp_path_factory) -> dict:
    """host_check.cpp built under UBSan twice, side by side: {0: the
    shift-add build, 1: the dot_general one (``-DTPN_MUL_DOT=1``)}."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    out = tmp_path_factory.mktemp("hostcc")
    procs = {mul_dot: subprocess.Popen(
        [gxx, *GXX_FLAGS, f"-DTPN_MUL_DOT={mul_dot}", "-o",
         str(out / f"libtpn_host_check_{mul_dot}.so"), str(CSRC / "host_check.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for mul_dot in (0, 1)}
    libs = {}
    for mul_dot, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        assert "warning" not in err, err
        libs[mul_dot] = ctypes.CDLL(str(out / f"libtpn_host_check_{mul_dot}.so"))
        assert libs[mul_dot].tpn_host_mul_dot() == mul_dot
    return libs


@pytest.fixture(scope="module")
def lib(builds):
    return builds[0]


@pytest.fixture(scope="module")
def dot_lib(builds):
    """The dot_general build: every convolution is field_dot.cuh's
    conv_dot or sqr_dot in its per-lane host form."""
    return builds[1]


def _ptrs(*tensors):
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def _limbs(rng: np.random.Generator, shape: tuple, bound: int) -> torch.Tensor:
    """Signed limbs in [-bound, bound], int32; lane 0 at +bound and lane 1
    at -bound in every limb."""
    x = rng.integers(-bound, bound + 1, size=shape)
    x[..., 0], x[..., 1] = bound, -bound
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


def test_mul_t_and_sqr_t_match_the_plain_version(lib):
    """At their contract's edge, |limb| <= 2^13, limb for limb; sqr_t in
    both squares, against the plain version's namespace of each."""
    rng = np.random.default_rng(0x40C1)
    a, b = _limbs(rng, (24, 64), 1 << 13), _limbs(rng, (24, 64), 1 << 13)
    out = torch.empty_like(a)
    lib.tpn_host_mul_t(*_ptrs(a, b, out), 64)
    assert torch.equal(out, F.mul_t(a, b))
    for code, sqr in enumerate(cuda_kernel._SQR_CODES):
        lib.tpn_host_sqr_t(*_ptrs(a, out), 64, code)
        assert torch.equal(out, F.field_ns("shift_add", sqr).sqr_t(a))
        assert torch.equal(out, F.sqr_t(a))


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
def test_point_formulas_match_the_plain_version(lib, reduce):
    """pt_add, pt_double and pt_add_mixed at the window loop's contracts
    (coordinates to ±2^13, the mixed add's affine operand to ±2^12) and on
    real points, limb for limb."""
    rng = np.random.default_rng(0x40C2)
    n = 48
    p, q = _limbs(rng, (3, 24, n), B.COORD_BOUND), _limbs(rng, (3, 24, n), B.COORD_BOUND)
    aff = _limbs(rng, (2, 24, n), B.AFFINE_BOUND)
    pts = [O.point_mul(int(k), O.GENERATOR) for k in rng.integers(1, 2**62, size=16)]
    real = torch.from_numpy(np.stack([
        np.stack([F.to_limbs(pt.x) for pt in pts], axis=1),
        np.stack([F.to_limbs(pt.y) for pt in pts], axis=1),
        np.stack([F.to_limbs(1)] * len(pts), axis=1)]).astype(np.int32))
    p, q, aff = (torch.cat([t, real[: t.shape[0]]], dim=-1).contiguous() for t in (p, q, aff))
    n, eager = p.shape[-1], int(reduce == "eager")
    out = torch.empty_like(p)
    lib.tpn_host_pt_add(*_ptrs(p, q, out), n, eager)
    assert torch.equal(out, C.pt_add(p, q, reduce=reduce))
    for code, sqr in enumerate(cuda_kernel._SQR_CODES):
        lib.tpn_host_pt_double(*_ptrs(p, out), n, eager, code)
        assert torch.equal(out, C.pt_double(p, F=F.field_ns("shift_add", sqr), reduce=reduce))
    lib.tpn_host_pt_add_mixed(*_ptrs(p, aff, out), n, eager)
    assert torch.equal(out, C.pt_add_mixed(p, aff, reduce=reduce))


@pytest.mark.parametrize("probe", ["field_mul", "field_mul_dot", "lazy_reduce", "table_build",
                                   "pow_descan", "select_tree", "pow_window", "window5"])
def test_probe_lanes_match_the_plain_version_and_host_check(lib, probe):
    inputs = cuda_diag.probe_inputs(probe, "cpu", lanes=32)
    out = torch.empty_like(inputs[0])
    getattr(lib, f"tpn_host_{probe}")(*_ptrs(*inputs, out), inputs[0].shape[-1])
    assert torch.equal(out, cuda_diag.FUNCTIONS[probe][1](*inputs))
    assert cuda_diag._host_check(probe, out, inputs) == 0


@pytest.mark.parametrize("lanes", [1, 31, 33, 45])
def test_tensor_core_contraction_emulated_by_warps(lib, lanes):
    """field_dot.cuh's warp contraction, its mma emulated over the warp's
    fragments by the same index maps, in warps of 32 with the last one
    padded: the (47, B) sums equal the plain ``_conv``'s, and in the
    half-product square ``_sqr_conv``'s, on carried operands at the
    contract's corners (top·top = ±2^30, all-negative lanes), and the
    probe's output equals its plain version's on the probe's loose lanes,
    corners first."""
    rng = np.random.default_rng(0x40C4 + lanes)
    hi, lo, top = (1 << 11) + 255, -256, 1 << 15
    a = F._carry(torch.from_numpy(cuda_diag._loose(rng, max(lanes, 2))), 1)[:, :lanes]
    b = F._carry(torch.from_numpy(cuda_diag._loose(rng, max(lanes, 2))), 1)[:, :lanes]
    for lane, (x, y, tx, ty) in enumerate([(hi, hi, top, top), (hi, lo, top, -top),
                                           (lo, lo, -top, -top)]):
        if lane < lanes:
            a[:-1, lane], b[:-1, lane], a[-1, lane], b[-1, lane] = x, y, tx, ty
    a, b = a.contiguous(), b.contiguous()
    wide = torch.zeros((47, lanes), dtype=torch.int32)
    for half, want in ((0, F._conv(a, b)), (1, F._sqr_conv(a))):
        lib.tpn_host_conv_dot(*_ptrs(a, b, wide), lanes, half)
        assert torch.equal(wide, want), half
    x, y = cuda_diag.probe_inputs("field_mul_dot", "cpu", lanes=max(lanes, 2))
    x, y = (t[:, 2 * x.shape[-1] // 3:][:, :lanes].contiguous() for t in (x, y))
    out = torch.zeros_like(x)
    lib.tpn_host_field_mul_dot(*_ptrs(x, y, out), lanes)
    assert torch.equal(out, cuda_diag.field_mul_dot_plain(x, y))


@pytest.fixture(scope="module")
def items():
    return chip_smoke.adversarial_items(O, random.Random(0x40C3), lanes=LANES)


def _host_verify(lib, args, schnorr_free, window_bits, point_form, reduce, select="tree",
                 sqr="half", counts=None):
    """(status, verdicts) of the host-compiled verify_lane over ``args``;
    each lane's calls of conv, sqr_conv, conv_dot and sqr_dot into
    ``counts`` (B, 4) int64 when given."""
    tables = cuda_kernel._g_tables(torch.device("cpu"), window_bits, point_form)
    out = torch.zeros(args[8].shape[-1], dtype=torch.bool)
    err = lib.tpn_host_verify(*_ptrs(tables, *args, out), out.shape[0], int(schnorr_free),
                              window_bits, C.POINT_FORMS.index(point_form),
                              cuda_kernel._REDUCE_CODES[reduce],
                              cuda_kernel._SELECT_CODES[select], cuda_kernel._SQR_CODES[sqr],
                              None if counts is None else ctypes.c_void_p(counts.data_ptr()))
    return err, out.tolist()


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
@pytest.mark.parametrize("ecdsa_only", [False, True], ids=["full", "schnorr_free"])
def test_verify_lane_matches_the_plain_version(lib, items, ecdsa_only, window_bits,
                                               point_form, reduce):
    """Every lane kind in the full variant, the ECDSA lanes in
    ``schnorr_free``."""
    batch = [it for it in items if len(it) == 4] if ecdsa_only else items
    prep = K.prepare_batch_raw(pack_items(batch), pad_to=len(batch), window_bits=window_bits)
    assert prep.schnorr_free == ecdsa_only
    args = K.from_reference(prep.device_args, "cpu")
    err, got = _host_verify(lib, args, ecdsa_only, window_bits, point_form, reduce)
    plain = K.verify_core(*args, schnorr_free=ecdsa_only, point_form=point_form,
                          reduce=reduce, select="tree", ladder="scan", sqr="half", mul="shift_add")
    assert err == 0 and got == plain.tolist() == O.verify_batch_cpu(batch)


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
@pytest.mark.parametrize("ecdsa_only", [False, True], ids=["full", "schnorr_free"])
def test_onehot_verify_lane_matches_the_tree_one(lib, items, ecdsa_only, window_bits,
                                                 point_form, reduce):
    """Each one-hot instantiation verdict for verdict against its tree twin
    (held against the plain version above) and the oracle."""
    batch = [it for it in items if len(it) == 4] if ecdsa_only else items
    prep = K.prepare_batch_raw(pack_items(batch), pad_to=len(batch), window_bits=window_bits)
    args = K.from_reference(prep.device_args, "cpu")
    tree = _host_verify(lib, args, ecdsa_only, window_bits, point_form, reduce, "tree")
    onehot = _host_verify(lib, args, ecdsa_only, window_bits, point_form, reduce, "onehot")
    assert onehot == tree == (0, O.verify_batch_cpu(batch))


@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("entries", [16, 32])
def test_select_entry_onehot_equals_the_indexed_read(lib, entries, point_form):
    """select_entry over one table of random limbs (negative ones too), for
    every digit in [0, entries), in both entry layouts: the one-hot form's
    masked OR returns the indexed entry limb for limb."""
    coords = 2 if point_form == "affine" else 3
    rng = np.random.default_rng(0x5E1 + entries + coords)
    table = _limbs(rng, (entries, coords, 24), 1 << 20)
    digits = torch.from_numpy(rng.permutation(entries).astype(np.int32))
    got = {}
    for onehot in (0, 1):
        out = torch.zeros((entries, coords, 24), dtype=torch.int32)
        assert lib.tpn_host_select(*_ptrs(table, digits, out), entries, entries,
                                   int(point_form == "affine"), onehot) == 0
        got[onehot] = out
    assert torch.equal(got[0], table[digits.long()]) and torch.equal(got[1], got[0])
    assert lib.tpn_host_select(*_ptrs(table, digits, out), entries, 8, 0, 1) == 1


def test_verify_refuses_an_instantiation_it_lacks(lib, items):
    prep = K.prepare_batch_raw(pack_items(items[:2]), pad_to=2)
    args = K.from_reference(prep.device_args, "cpu")
    tables = cuda_kernel._g_tables(torch.device("cpu"), 4, "projective")
    out = torch.zeros(2, dtype=torch.bool)
    # no such width; no such form; no such reduce; no such select; no such square
    for wb, form, reduce, select, sqr in ((6, 0, 0, 0, 0), (4, 2, 0, 0, 0), (4, 0, 2, 0, 0),
                                          (4, 0, 0, 2, 0), (4, 0, 0, 0, 2)):
        assert lib.tpn_host_verify(*_ptrs(tables, *args, out), 2, 0, wb, form, reduce,
                                   select, sqr, None) == 1


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
@pytest.mark.parametrize("ecdsa_only", [False, True], ids=["full", "schnorr_free"])
def test_full_product_verify_lane_matches_the_plain_version(lib, items, ecdsa_only, window_bits,
                                                            point_form, reduce):
    """Each full-product tree instantiation against the plain version under
    sqr="mul" and the oracle, verdict for verdict; per lane it calls
    sqr_conv 0 times and conv as often as its half-product twin calls conv
    and sqr_conv together.  In the projective form that is the count of
    chip_smoke.kernel_ops_per_lane (576 products a conv, 300 a sqr_conv);
    the affine form skips the 11 convolutions of a mixed add for each zero
    digit of the lane."""
    batch = [it for it in items if len(it) == 4] if ecdsa_only else items
    prep = K.prepare_batch_raw(pack_items(batch), pad_to=len(batch), window_bits=window_bits)
    args = K.from_reference(prep.device_args, "cpu")
    counts = {sqr: torch.zeros((len(batch), 4), dtype=torch.int64) for sqr in ("half", "mul")}
    got = {sqr: _host_verify(lib, args, ecdsa_only, window_bits, point_form, reduce, "tree",
                             sqr, counts[sqr]) for sqr in ("half", "mul")}
    plain = K.verify_core(*args, schnorr_free=ecdsa_only, point_form=point_form, reduce=reduce,
                          select="tree", ladder="scan", sqr="mul", mul="shift_add")
    assert got["mul"] == got["half"] == (0, plain.tolist()) == (0, O.verify_batch_cpu(batch))
    conv, sqr_conv = counts["mul"][:, 0], counts["mul"][:, 1]
    assert not sqr_conv.any() and (counts["half"][:, 1] > 0).all()
    assert torch.equal(conv, counts["half"].sum(dim=1))
    assert not counts["half"][:, 2:].any() and not counts["mul"][:, 2:].any()  # no dot call
    variant = "schnorr_free" if ecdsa_only else "full"
    model = {sqr: chip_smoke.kernel_ops_per_lane(window_bits, point_form, reduce, "tree", sqr)[
        variant]["mul"] for sqr in ("half", "mul")}
    skipped = torch.zeros(len(batch), dtype=torch.int64)
    if point_form == "affine":
        skipped = 11 * sum((torch.as_tensor(d) == 0).sum(dim=0) for d in prep.device_args[:4])
    assert torch.equal(576 * conv, model["mul"] - 576 * skipped)
    assert torch.equal(576 * counts["half"][:, 0] + 300 * counts["half"][:, 1],
                       model["half"] - 576 * skipped)


# ---------- the dot_general build (-DTPN_MUL_DOT=1) ---------------------------


def test_dot_build_field_and_point_formulas_match_the_plain_version(dot_lib):
    """mul_t, sqr_t (both squares) and the three point formulas (both
    reductions, both squares) of the dot_general build at their contracts,
    limb for limb the plain version's namespace under dot_general."""
    rng = np.random.default_rng(0x40D1)
    a, b = _limbs(rng, (24, 64), 1 << 13), _limbs(rng, (24, 64), 1 << 13)
    out = torch.empty_like(a)
    dot_lib.tpn_host_mul_t(*_ptrs(a, b, out), 64)
    assert torch.equal(out, F.field_ns("dot_general", "half").mul_t(a, b))
    for code, sqr in enumerate(cuda_kernel._SQR_CODES):
        dot_lib.tpn_host_sqr_t(*_ptrs(a, out), 64, code)
        assert torch.equal(out, F.field_ns("dot_general", sqr).sqr_t(a))
    n = 32
    p, q = _limbs(rng, (3, 24, n), B.COORD_BOUND), _limbs(rng, (3, 24, n), B.COORD_BOUND)
    aff = _limbs(rng, (2, 24, n), B.AFFINE_BOUND)
    out = torch.empty_like(p)
    for eager, reduce in enumerate(("lazy", "eager")):
        for code, sqr in enumerate(cuda_kernel._SQR_CODES):
            dot_lib.tpn_host_pt_double(*_ptrs(p, out), n, eager, code)
            assert torch.equal(out, C.pt_double(p, F=F.field_ns("dot_general", sqr),
                                                reduce=reduce))
        fns = F.field_ns("dot_general", "half")  # the adds make no square
        dot_lib.tpn_host_pt_add(*_ptrs(p, q, out), n, eager)
        assert torch.equal(out, C.pt_add(p, q, F=fns, reduce=reduce))
        dot_lib.tpn_host_pt_add_mixed(*_ptrs(p, aff, out), n, eager)
        assert torch.equal(out, C.pt_add_mixed(p, aff, F=fns, reduce=reduce))


@pytest.mark.parametrize("sqr", ["half", "mul"])
@pytest.mark.parametrize("point_form", ["projective", "affine"])
def test_dot_build_verify_lane_matches_the_plain_version(lib, dot_lib, items, point_form, sqr):
    """The 4-bit lazy tree instantiations of the dot_general build, full
    variant, verdict for verdict against the plain version under
    mul="dot_general" and the oracle (in the affine form lanes whose digit
    is 0 beside lanes that add: a lane is a warp of its own here, so the
    converged path keeps acc where the digit is 0); per lane no conv or
    sqr_conv call, and as many conv_dot and sqr_dot calls as the shift-add
    build makes conv and sqr_conv calls."""
    prep = K.prepare_batch_raw(pack_items(items), pad_to=len(items), window_bits=4)
    args = K.from_reference(prep.device_args, "cpu")
    counts = {mul: torch.zeros((len(items), 4), dtype=torch.int64) for mul in (0, 1)}
    got = {mul: _host_verify(build, args, False, 4, point_form, "lazy", "tree", sqr, counts[mul])
           for mul, build in ((0, lib), (1, dot_lib))}
    plain = K.verify_core(*args, schnorr_free=False, point_form=point_form, reduce="lazy",
                          select="tree", ladder="scan", sqr=sqr, mul="dot_general")
    assert got[1] == got[0] == (0, plain.tolist()) == (0, O.verify_batch_cpu(items))
    assert not counts[1][:, :2].any() and not counts[0][:, 2:].any()
    assert torch.equal(counts[1][:, 2:], counts[0][:, :2])
    assert (counts[1][:, 2] > 0).all() and ((counts[1][:, 3] > 0) == (sqr == "half")).all()
    if point_form == "affine":
        zero = sum((torch.as_tensor(d) == 0).sum(dim=0) for d in prep.device_args[:4])
        assert (zero > 0).any()  # digit-0 lanes ran the converged path
