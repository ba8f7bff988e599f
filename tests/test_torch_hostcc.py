"""The CUDA sources compiled as host C++ under UBSan, against the plain version.

``tpunode_torch/csrc/host_check.cpp`` wraps the kernel's field and curve
functions, its window-table select, five probe lanes and the per-lane
program ``verify_lane`` in a plain C interface.  The module fixture builds it with ``g++ -O1
-fsanitize=undefined -fno-sanitize-recover=all`` into a temporary
directory, so a signed overflow or a shift out of range in the card's code
aborts the test process.  Inputs come from seeds through numpy.  Limbs are
integers and verdicts booleans, so every comparison is exact: ``mul_t``,
``sqr_t`` and the three point formulas in both reductions limb for limb,
the one-hot select against the indexed read for every digit, the sixteen
tree instantiations of ``verify_lane`` (both widths, forms, reductions and
variants) against the plain version verdict for verdict on 16 adversarial
lanes, and each one-hot instantiation against its tree twin.
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
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    out = tmp_path_factory.mktemp("hostcc") / "libtpn_host_check.so"
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(out), str(CSRC / "host_check.cpp")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "warning" not in proc.stderr, proc.stderr
    return ctypes.CDLL(str(out))


def _ptrs(*tensors):
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def _limbs(rng: np.random.Generator, shape: tuple, bound: int) -> torch.Tensor:
    """Signed limbs in [-bound, bound], int32; lane 0 at +bound and lane 1
    at -bound in every limb."""
    x = rng.integers(-bound, bound + 1, size=shape)
    x[..., 0], x[..., 1] = bound, -bound
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


def test_mul_t_and_sqr_t_match_the_plain_version(lib):
    """At their contract's edge, |limb| <= 2^13, limb for limb."""
    rng = np.random.default_rng(0x40C1)
    a, b = _limbs(rng, (24, 64), 1 << 13), _limbs(rng, (24, 64), 1 << 13)
    out = torch.empty_like(a)
    lib.tpn_host_mul_t(*_ptrs(a, b, out), 64)
    assert torch.equal(out, F.mul_t(a, b))
    lib.tpn_host_sqr_t(*_ptrs(a, out), 64)
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
    lib.tpn_host_pt_double(*_ptrs(p, out), n, eager)
    assert torch.equal(out, C.pt_double(p, reduce=reduce))
    lib.tpn_host_pt_add_mixed(*_ptrs(p, aff, out), n, eager)
    assert torch.equal(out, C.pt_add_mixed(p, aff, reduce=reduce))


@pytest.mark.parametrize("probe", ["field_mul", "lazy_reduce", "select_tree", "pow_window",
                                   "window5"])
def test_probe_lanes_match_the_plain_version_and_host_check(lib, probe):
    inputs = cuda_diag.probe_inputs(probe, "cpu", lanes=32)
    out = torch.empty_like(inputs[0])
    getattr(lib, f"tpn_host_{probe}")(*_ptrs(*inputs, out), inputs[0].shape[-1])
    assert torch.equal(out, cuda_diag.FUNCTIONS[probe][1](*inputs))
    assert cuda_diag._host_check(probe, out, inputs) == 0


@pytest.fixture(scope="module")
def items():
    return chip_smoke.adversarial_items(O, random.Random(0x40C3), lanes=LANES)


def _host_verify(lib, args, schnorr_free, window_bits, point_form, reduce, select="tree"):
    """(status, verdicts) of the host-compiled verify_lane over ``args``."""
    tables = cuda_kernel._g_tables(torch.device("cpu"), window_bits, point_form)
    out = torch.zeros(args[8].shape[-1], dtype=torch.bool)
    err = lib.tpn_host_verify(*_ptrs(tables, *args, out), out.shape[0], int(schnorr_free),
                              window_bits, C.POINT_FORMS.index(point_form),
                              cuda_kernel._REDUCE_CODES[reduce],
                              cuda_kernel._SELECT_CODES[select])
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
                          reduce=reduce, select="tree")
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
    # no such width; no such form; no such reduce; no such select
    for wb, form, reduce, select in ((6, 0, 0, 0), (4, 2, 0, 0), (4, 0, 2, 0), (4, 0, 0, 2)):
        assert lib.tpn_host_verify(*_ptrs(tables, *args, out), 2, 0, wb, form, reduce,
                                   select) == 1
