"""The port's ``dot_general`` contraction and the ``field_mul_dot`` probe's
plain version against the reference.

The reference's ``TPUNODE_FIELD_MUL=dot_general`` computes each limb
convolution as the 576 partial products contracted against a (47, 576)
anti-diagonal scatter (``field._conv_dot``, ``pallas_field._conv_dot``).
The port's plain ``field._mul_scatter`` and ``field._conv_dot`` are held
against both, limb for limb, and the probe's plain version against the
reference probe's kernel body (``benchmarks/mosaic_diag.py:123``) in
interpret mode.  The reference's field modes are a process global, read
when a program is traced: :func:`reference_dot` restores them in
``finally``.  Inputs come from seeds through numpy; limbs are integers, so
every comparison is exact.  The CUDA kernel is held against the plain
version in test_torch_hostcc.py (host C++) and test_torch_cuda.py (card).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from tpunode.verify import field as RF
from tpunode.verify import pallas_field as PF
from tpunode_torch import cuda_diag
from tpunode_torch.verify import field as F

torch.set_num_threads(1)

CPU = torch.device("cpu")


@contextlib.contextmanager
def reference_dot():
    """The reference's multiply under ``dot_general`` (half-product
    square) inside, its modes restored on exit."""
    prev = RF.field_modes()
    try:
        RF.set_field_modes(mul="dot_general", sqr="half")
        yield
    finally:
        RF.set_field_modes(mul=prev[0], sqr=prev[1])


def contraction_inputs(seed: int, lanes: int = 40) -> tuple:
    """(24, lanes) carried operands: ``mul``'s loose inputs after its carry
    round (lanes 0 and 1 at the corners), then three lanes at the carried
    contract's own corners: top limbs ±2^15 so that top·top is +2^30 and
    -2^30, the others at -256 and 2^11 + 255, and one lane all negative in
    both operands."""
    rng = np.random.default_rng(seed)
    a = F._carry(torch.from_numpy(cuda_diag._loose(rng, lanes)), 1)
    b = F._carry(torch.from_numpy(cuda_diag._loose(rng, lanes)), 1)
    hi, lo, top = (1 << 11) + 255, -256, 1 << 15
    for lane, (x, y, tx, ty) in enumerate([(hi, hi, top, top), (hi, lo, top, -top),
                                           (lo, lo, -top, -top)], start=2):
        a[:-1, lane], b[:-1, lane], a[-1, lane], b[-1, lane] = x, y, tx, ty
    return a.contiguous(), b.contiguous()


def test_mul_scatter_is_the_references():
    s = F._mul_scatter(CPU)
    assert s.dtype == torch.int32 and tuple(s.shape) == (2 * F.NLIMBS - 1, F.NLIMBS * F.NLIMBS)
    assert np.array_equal(s.numpy(), np.asarray(RF._MUL_SCATTER))
    assert np.array_equal(s.numpy(), np.asarray(PF._mul_scatter()))
    assert int(s.sum()) == F.NLIMBS * F.NLIMBS  # every pair lands exactly once
    for col, (i, j) in enumerate(RF._MUL_PAIRS):
        assert s[i + j, col] == 1
    assert F._mul_scatter(CPU) is s  # made once a device


@pytest.mark.parametrize("seed", [0xD07, 0xD08, 0xD09])
def test_conv_dot_equals_conv_and_the_references(seed):
    a, b = contraction_inputs(seed)
    assert int(a[-1, 2]) * int(b[-1, 2]) == 1 << 30
    assert int(a[-1, 3]) * int(b[-1, 3]) == -(1 << 30)
    assert int(a[:, 4].max()) < 0 and int(b[:, 4].max()) < 0
    got = F._conv_dot(a, b)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2 * F.NLIMBS - 1, a.shape[-1])
    assert torch.equal(got, F._conv(a, b))
    ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    assert np.array_equal(got.numpy(), np.asarray(RF._conv_dot(ja, jb)))
    assert np.array_equal(got.numpy(), np.asarray(PF._conv_dot(ja, jb)))


@pytest.mark.parametrize("lanes", [5, F._DOT_CHUNK - 1, F._DOT_CHUNK, F._DOT_CHUNK + 1,
                                   2 * F._DOT_CHUNK + 88])
def test_plain_contraction_is_the_same_chunked_or_not(lanes):
    """``_conv_dot`` contracts :data:`F._DOT_CHUNK` lanes at a time: lane
    counts below, at and past one chunk, and past two, give ``_conv``'s
    limbs.  Its int32 sums wrap in any order."""
    a, b = contraction_inputs(0xC4, lanes)
    assert torch.equal(F._conv_dot(a, b), F._conv(a, b))
    # row 2 sums pairs (0, 2), (1, 1), (2, 0), in that column order: the
    # first two products already leave int32 together, the whole sum does not.
    m = 46340  # m * m < 2^31 <= 2 * m * m
    x = torch.zeros((F.NLIMBS, 2), dtype=torch.int32)
    y = torch.zeros((F.NLIMBS, 2), dtype=torch.int32)
    x[:3] = torch.tensor([[m, -m], [m, -m], [-m, m]])
    y[:3] = m
    assert F._conv_dot(x, y)[2].tolist() == [m * m, -m * m]


def test_field_mul_dot_plain_matches_the_reference_probe_in_interpret_mode():
    """The probe's inputs (the reference's own lanes, then full-width and
    loose ones) through ``mosaic_diag._field_mul``'s kernel body under
    ``dot_general``, in interpret mode."""
    a, b = cuda_diag.probe_inputs("field_mul_dot", "cpu", lanes=32)
    assert tuple(a.shape) == (24, 96)
    got = cuda_diag.field_mul_dot_plain(a, b)

    def mul_kernel(a_ref, b_ref, o_ref):
        o_ref[...] = PF.canonical(PF.mul(a_ref[...], b_ref[...]))

    with reference_dot():
        ref = np.asarray(pl.pallas_call(
            mul_kernel, out_shape=jax.ShapeDtypeStruct(tuple(a.shape), jnp.int32),
            interpret=True)(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
    assert RF.field_modes()[0] == "shift_add"
    assert np.array_equal(got.numpy(), ref)
    assert torch.equal(got, cuda_diag.field_mul_plain(a, b))
    assert torch.equal(cuda_diag.field_mul_dot(a, b), got)  # a CPU tensor: the plain version
    assert cuda_diag._host_check("field_mul_dot", got, (a, b)) == 0
    bad = got.clone()
    bad[3, 40] += 1
    assert cuda_diag._host_check("field_mul_dot", bad, (a, b)) == 1


def test_field_mul_dot_refuses_malformed_arguments_on_the_cpu():
    a, b = cuda_diag.probe_inputs("field_mul_dot", "cpu", lanes=4)
    launches = dict(cuda_diag.LAUNCHES)
    for bad in (a.to(torch.int64), a[:, :5], a.t().contiguous().t()):
        with pytest.raises(ValueError):
            cuda_diag.field_mul_dot(bad, b)
    assert cuda_diag.LAUNCHES == launches
    assert cuda_diag.PROBES.index("field_mul_dot") == cuda_diag.PROBES.index("field_mul") + 1


def test_dot_general_knob_still_raises_naming_its_roadmap_item(monkeypatch):
    """The knob's dot_general runs now (it raised NotImplementedError
    naming ROADMAP 1f-ii until the verify kernel took it): the field modes
    report it; a value that names no mode still raises ValueError."""
    monkeypatch.setenv("TPUNODE_FIELD_MUL", "dot_general")
    assert F.field_modes()[0] == F.mul_mode() == "dot_general"
    assert F.field_modes(mul="shift_add")[0] == "shift_add"  # the call's wins
    monkeypatch.setenv("TPUNODE_FIELD_MUL", "dot")
    with pytest.raises(ValueError, match="TPUNODE_FIELD_MUL"):
        F.field_modes()


def test_mma_ptx_finds_the_tensor_core_instructions_by_function():
    ptx = "\n".join([
        ".visible .entry _ZN3tpn14trivial_kernelEPKiPii(",
        "\t.param .u64 p0", ")", "{", "\tadd.s32 %r1, %r2, 1;", "}",
        ".func  (.param .b32 func_retval0) _ZN3tpn9canonicalEPiPKi(",
        "\t.param .b64 p0", ");",
        ".visible .entry _ZN3tpn20field_mul_dot_kernelEPKiS1_Pii(", ")", "{",
        "\tmma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%r1, %r2, %r3, %r4}, {%r5}, "
        "{%r6}, {%r7};",
        "\tmma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%r1, %r2, %r3, %r4}, {%r5}, "
        "{%r6}, {%r7};",
        "\tcall.uni _ZN3tpn9canonicalEPiPKi, (p0);", "}",
        ".func _ZN3tpn9canonicalEPiPKi(", "\t.param .b64 p0", ")", "{",
        "\tmul.lo.s32 %r1, %r2, %r3;", "}"])
    assert cuda_diag.mma_ptx(ptx) == {
        "entries": {"_ZN3tpn14trivial_kernelEPKiPii": 0,
                    "_ZN3tpn20field_mul_dot_kernelEPKiS1_Pii": 2},
        "funcs": {"_ZN3tpn9canonicalEPiPKi": 0}}
