"""The one-hot lazy affine 5-bit ``dot_general`` tuples on the 8-word
arithmetic: 5-bit windows, affine, lazy, one-hot select, ``dot_general``,
with the half-product or the full-product square
(``csrc/verify_u32_modes.cu``'s ``verify_u32_modes_kernel`` under
``DotMul``, ``csrc/field_u32_dot.cuh``'s contraction; libraries
``verify_u32_dot5_half`` and ``verify_u32_dot5_mul``, built under
``-DTPN_WB=5 -DTPN_U32_DOT=1``).

The host harness ``tpunode_torch/csrc/host_u32_modes.cpp`` exports the
contraction's host forms, the lazy point formulas under it and the per-lane
program as ``tpn_u32d*``; the module fixture builds it once under UBSan
(``lib``, shared with ``tests/test_torch_u32_modes.py``).  The contraction,
a warp's 32 threads emulated stage by stage through the fragment maps and
one lane's byte sums, is held word for word against ``mul_wide`` /
``sqr_wide`` and Python integers at the carries' edges; the mixed add
under it against the group law, the port's plain lazy chain and the
reference's ``_pt_add_mixed_lazy``; the per-lane program against the port's plain
``verify_core`` at these modes, the reference's
``tpunode.verify.kernel.verify_core`` run on the CPU op by op at these
modes, and the oracle.  Routing is checked by a spy on the library loader,
and chip_smoke.py's count, bound, ptxas keys, phase-3 launches and phase-6
lines at these tuples against stubs.  The ``gpu``-marked cases run the
kernels on a card.  Words, limbs and verdicts are integers: every
comparison is exact.
"""

import contextlib
import ctypes
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_u32_modes import (  # noqa: F401  (lib: the harness fixture)
    CSRC, P, SQR_CODE, TOP, _affine, _int, _limbs, _o, _plain_ints, _ptr, _pts, _random,
    _real_points, _scaled, _scan, _spy_loader, _words, lib)
from tpunode.verify import curve as RC
from tpunode.verify import field as RF
from tpunode.verify import kernel as RK
from tpunode_torch import cuda_diag
from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import curve as C
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import field as F
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

MODES = {sqr: (5, "affine", "lazy", "onehot", sqr, "dot_general") for sqr in ("half", "mul")}
LIBRARY = {"half": "verify_u32_dot5_half", "mul": "verify_u32_dot5_mul"}
KINDS = {sqr: modes for sqr, modes in MODES.items()}  # chip_smoke's kinds (the multiply sixth)
YARDSTICK = {"half": "verify_dot_half", "mul": "verify_dot_mul"}
EAGER = {sqr: (5, "affine", "eager", "onehot", sqr) for sqr in ("half", "mul")}


# ---------- the contraction -------------------------------------------------------


def _edges(rng: np.random.Generator) -> list:
    """96 values: the carries' edges (0, 1, p - 1, p, 2^256 - 1, all-ones and
    single words, 2^255), then random values below 2^256."""
    vals = [0, 1, 2, P - 1, P, P + 1, TOP - 1, 1 << 255, (1 << 32) - 1, (1 << 224) - 1]
    vals += [0xFFFFFFFF << (32 * i) for i in range(8)] + [TOP - 1 - (1 << (32 * i))
                                                          for i in range(8)]
    return vals + _random(rng, 96 - len(vals))


def _contract(lib, x: list, y: list, half: bool, form: int, reduced: bool) -> np.ndarray:
    out = np.zeros((len(x), 8 if reduced else 16), np.uint32)
    assert lib.tpn_u32d_contract(_ptr(_words(x)), _ptr(_words(y)), _ptr(out), len(x),
                                 int(half), form, int(reduced)) == 0
    return out


@pytest.mark.parametrize("form", ["warp", "lane"])
@pytest.mark.parametrize("half", [False, True])
def test_contraction_equals_mul_wide_and_sqr_wide_word_for_word(lib, half, form):
    """The product's 16 words from the tensor-core contraction — a warp's 32
    threads through the shared-memory rows and the emulated mma fragments,
    or one lane's byte sums — equal mul_wide's (sqr_wide's for the half
    square, its cross products at the scatter entry 2) word for word and the
    Python product; reduced, reduce_wide's words.  Operands at the carries'
    edges (all-ones words, p - 1, 2^256 - 1) against each other and random
    ones, three warps of them."""
    rng = np.random.default_rng(0xD07 + 2 * half)
    x = _edges(rng)
    y = x[::-1] if not half else x
    code = {"warp": 0, "lane": 1}[form]
    wide = _contract(lib, x, y, half, code, False)
    assert np.array_equal(wide, _contract(lib, x, y, half, 2, False))
    assert [_int(row) for row in wide] == [a * b for a, b in zip(x, y)]
    reduced = _contract(lib, x, y, half, code, True)
    assert np.array_equal(reduced, _contract(lib, x, y, half, 2, True))
    assert [_int(row) % P for row in reduced] == [a * b % P for a, b in zip(x, y)]


def test_contraction_counts_its_host_calls_and_refuses_other_arguments(lib):
    """dot_lane, the per-lane program's product, counts its calls by square;
    another form, square or a warp form over a partial warp is refused."""
    calls = (ctypes.c_uint64 * 2)()
    lib.tpn_u32d_calls(calls)
    x = _random(np.random.default_rng(0xD08), 32)
    _contract(lib, x, x, False, 1, True)
    _contract(lib, x[:5], x[:5], True, 1, True)
    _contract(lib, x, x, True, 0, True)  # the warp form is not the program's product
    lib.tpn_u32d_calls(calls)
    assert list(calls) == [32, 5]
    out = np.zeros((32, 16), np.uint32)
    words = _words(x)
    for half, form, n in ((0, 3, 32), (2, 1, 32), (0, 0, 31), (1, -1, 32)):
        assert lib.tpn_u32d_contract(_ptr(words), _ptr(words), _ptr(out), n, half, form, 0) == 1


def test_schedule_covers_each_product_once_in_24_and_16_steps():
    """The header's schedule, read back from its note: 48 mma a warp's
    multiply (two m-tiles x 24 k-steps), 32 its half square; the probe's
    PTX holds one m-tile's 24 (chip_smoke.U32_DOT_MMA_IN_PTX)."""
    text = (CSRC / "field_u32_dot.cuh").read_text()
    assert "Plan<false>::STEPS == 24 && Plan<true>::STEPS == 16" in text
    assert chip_smoke.U32_DOT_MMA_IN_PTX == 24
    assert chip_smoke.u32_dot_ops_per_lane(False)["mma"] == 2 * 24
    assert chip_smoke.u32_dot_ops_per_lane(True)["mma"] == 2 * 16


# ---------- the lazy formulas under the contraction -------------------------------


@contextlib.contextmanager
def _reference_field(sqr: str):
    """The reference field at lazy reduction, dot_general and ``sqr``,
    restored in ``finally``."""
    prev = RF.set_field_modes(mul="dot_general", sqr=sqr, reduce="lazy")
    try:
        yield
    finally:
        RF.set_field_modes(mul=prev[0], sqr=prev[1], reduce=prev[2])


@pytest.mark.parametrize("formula", ["pt_add_mixed_lazy", "pt_add", "pt_double_half",
                                     "pt_double_mul"])
def test_lazy_formula_matches_python_integers_plain_chain_and_reference(lib, formula):
    """Each lazy body, every product contracted (dot_lane), on real points
    (Z scaled; with themselves, their negatives, infinity and another point)
    against the group law in Python integers, and on those and random
    coordinates below 2^256 against the port's plain lazy formula under
    dot_general, coordinate for coordinate mod p; the mixed add
    (pt_add_mixed_eager, the lazy tuple's one mixed add: the same products
    and sums as the reference's lazy body) also against the reference's
    _pt_add_mixed_lazy on the CPU."""
    rng = np.random.default_rng(0xD1 + len(formula))
    reals = _real_points(rng, 6)
    zs = [v % P or 1 for v in _random(rng, 6)]
    mixed = formula == "pt_add_mixed_lazy"
    ps, qs = [], []
    for pt, z in zip(reals, zs):
        if mixed:
            for q in (pt, O.Point(pt.x, P - pt.y), reals[0]):
                ps.append(_scaled(pt, z))
                qs.append((q.x, q.y, 1))
        else:
            for q in (_scaled(pt, 3), (pt.x, P - pt.y, 1), (0, 1, 0), _scaled(reals[0], 5)):
                ps.append(_scaled(pt, z))
                qs.append(q)
    if mixed:
        ps.append((0, 1, 0))
        qs.append((reals[1].x, reals[1].y, 1))
    n_real = len(ps)
    for _ in range(12):
        ps.append(tuple(_random(rng, 3)))
        qs.append(tuple(_random(rng, 3)))
    op = {"pt_add_mixed_lazy": 0, "pt_add": 1}.get(formula, 2)
    sqr = "mul" if formula == "pt_double_mul" else "half"
    p, q = _pts(ps), _pts(qs, 2 if mixed else 3)
    out = np.zeros_like(p)
    assert lib.tpn_u32d_point(_ptr(p), _ptr(q), _ptr(out), len(ps), op, SQR_CODE[sqr]) == 0
    got = [tuple(_int(c) % P for c in pt) for pt in out]

    def from_pt(pt):
        aff = _affine(pt)
        return O.INFINITY if aff is None else O.Point(*aff)

    for g, a, b in zip(got[:n_real], ps, qs):
        want = O.point_double(from_pt(a)) if op == 2 else O.point_add(from_pt(a), from_pt(b))
        assert _affine(g) == _o(want)
    fns = F.field_ns("dot_general", sqr)
    if mixed:
        plain = C.pt_add_mixed(_limbs(ps), _limbs(qs, 2), F=fns, reduce="lazy")
        with _reference_field(sqr):
            ref = RC._pt_add_mixed_lazy(jnp.asarray(_limbs(ps).numpy()),
                                        jnp.asarray(_limbs(qs, 2).numpy()))
        assert got == _plain_ints(torch.from_numpy(np.array(ref)))
    elif op == 1:
        plain = C.pt_add(_limbs(ps), _limbs(qs), F=fns, reduce="lazy")
    else:
        plain = C.pt_double(_limbs(ps), F=fns, reduce="lazy")
    assert got == _plain_ints(plain)
    assert lib.tpn_u32d_point(_ptr(p), _ptr(q), _ptr(out), len(ps), 3, 0) == 1
    assert lib.tpn_u32d_point(_ptr(p), _ptr(q), _ptr(out), len(ps), 0, 2) == 1


# ---------- the per-lane program ---------------------------------------------------


@pytest.fixture(scope="module")
def items():
    """33 adversarial items (every shape of chip_smoke.adversarial_items),
    every eighth one corrupted."""
    adv = chip_smoke.adversarial_items(O, random.Random(0xD5), lanes=33)
    return chip_smoke.corrupt_every(adv, 8)


class _LazyJitField:
    """The reference field module with its products, wide products and
    reductions jitted one call at a time (traced under the active field
    modes); every other name is the module's."""

    def __init__(self):
        for name in ("mul", "sqr", "mul_t", "sqr_t", "mul_wide", "mul_t_wide", "sqr_wide",
                     "sqr_t_wide", "reduce_wide", "reduce_wide_loose", "tighten", "canonical",
                     "is_zero", "eq"):
            setattr(self, name, jax.jit(getattr(RF, name)))
        self.mul_small_red = jax.jit(RF.mul_small_red, static_argnums=(1,))

    def __getattr__(self, name):
        return getattr(RF, name)


@contextlib.contextmanager
def lazy_dot_reference(sqr: str):
    """The reference's ``verify_core`` at (5, affine, lazy, onehot, ``sqr``,
    dot_general), run op by op on the CPU: its modes set, its scans and
    conds as Python loops and branches over concrete values, and its field
    products and reductions jitted one at a time (the affine table's batch
    inversion too, whose field is a default argument).  Every mode and every
    swapped name is restored in ``finally``."""
    prev_kernel = RK.set_kernel_modes(select="onehot", window_bits=5)
    prev_field = RF.set_field_modes(mul="dot_general", sqr=sqr, reduce="lazy")
    prev_form = RC.set_point_form("affine")
    saved = RK.lax, RK.F, RK.pt_add, RK.pt_double, RK.pt_add_mixed, RK._normalize_q_table
    try:
        jf = _LazyJitField()
        RK._normalize_q_table = lambda table: saved[5](table, F=jf)
        RK.lax = types.SimpleNamespace(scan=_scan, cond=lambda p, t, f: t() if bool(p) else f())
        RK.F = jf
        RK.pt_add = lambda p, q: RC.pt_add(p, q, F=jf)
        RK.pt_double = lambda p: RC.pt_double(p, F=jf)
        RK.pt_add_mixed = lambda p, q: RC.pt_add_mixed(p, q, F=jf)
        assert RK.kernel_modes() == ("dot_general", sqr, "lazy", "affine", "onehot", "scan", 5)
        yield
    finally:
        (RK.lax, RK.F, RK.pt_add, RK.pt_double, RK.pt_add_mixed,
         RK._normalize_q_table) = saved
        RC.set_point_form(prev_form)
        RF.set_field_modes(mul=prev_field[0], sqr=prev_field[1], reduce=prev_field[2])
        RK.set_kernel_modes(select=prev_kernel[0], window_bits=prev_kernel[2])


@pytest.fixture(scope="module", params=["half", "mul"])
def reference(request, items):
    """The reference's verify_core on the CPU at the lazy dot_general 5-bit
    tuple of the square ``sqr`` over the 33 items: (sqr, its verdicts)."""
    sqr = request.param
    with lazy_dot_reference(sqr):
        prep = RK.prepare_batch(items, pad_to=len(items), native=False)
        assert prep.device_args[0].shape[0] == 27
        out = RK.verify_core(*(jnp.asarray(a) for a in prep.device_args))
        verdicts = [bool(v) for v in np.asarray(out)]
    assert RK.kernel_modes() == ("shift_add", "half", "lazy", "projective", "tree", "scan", 4)
    return sqr, verdicts


def _host_verify(lib, args, schnorr_free: bool, sqr: str) -> list:
    tables = cuda_kernel._g_tables(torch.device("cpu"), 5, "affine")
    out = torch.zeros(args[8].shape[-1], dtype=torch.bool)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (tables, *args, out)]
    assert lib.tpn_u32d5_verify(*ptrs, out.shape[0], int(schnorr_free), SQR_CODE[sqr]) == 0
    return out.tolist()


@pytest.mark.parametrize("variant", ["full", "schnorr_free"])
def test_verify_lane_matches_plain_reference_and_oracle(lib, items, reference, variant):
    """verify_lane at the lazy dot_general tuple of each square, every
    product dot_lane's, at B = 1 and 33: each lane's verdict the port's
    plain verify_core's at those modes on the 33-lane batch (a lane's
    verdict depends on its item alone), the reference's verify_core's there
    (its one program is the full variant's; the schnorr_free batch's items
    are the full batch's ECDSA ones) and the oracle's; every product of the
    program ran through the contraction, the squares in the chosen square."""
    sqr, ref = reference
    ref_by_item = dict(zip(map(id, items), ref))
    batch = items if variant == "full" else chip_smoke.tile(
        [it for it in items if len(it) == 4], 33)
    prep = K.prepare_batch_raw(pack_items(batch), pad_to=33, window_bits=5)
    assert prep.schnorr_free == (variant == "schnorr_free") and prep.window_bits == 5
    _, form, reduce, select, _, mul = MODES[sqr]
    with torch.inference_mode():
        plain = K.verify_core(*K.from_reference(prep.device_args, "cpu"),
                              schnorr_free=prep.schnorr_free, point_form=form, reduce=reduce,
                              select=select, ladder="scan", sqr=sqr, mul=mul).tolist()
    oracle = O.verify_batch_cpu(batch)
    assert plain == [ref_by_item[id(it)] for it in batch] == oracle
    assert 0 < sum(oracle) < len(oracle)
    calls = (ctypes.c_uint64 * 2)()
    for b in (1, 33):
        prep = K.prepare_batch_raw(pack_items(batch[:b]), pad_to=b, window_bits=5)
        lib.tpn_u32d_calls(calls)
        got = _host_verify(lib, K.from_reference(prep.device_args, "cpu"),
                           variant == "schnorr_free", sqr)
        assert got == plain[:b], b
        lib.tpn_u32d_calls(calls)
        assert calls[0] > 2500 * b and (calls[1] > 500 * b) == (sqr == "half"), list(calls)


def test_verify_refuses_another_square_code(lib, items):
    prep = K.prepare_batch_raw(pack_items(items[:1]), pad_to=1, window_bits=5)
    args = K.from_reference(prep.device_args, "cpu")
    tables = cuda_kernel._g_tables(torch.device("cpu"), 5, "affine")
    out = torch.zeros(1, dtype=torch.bool)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (tables, *args, out)]
    assert lib.tpn_u32d5_verify(*ptrs, 1, 0, 2) == 1


# ---------- routing, by a spy on the library loader ---------------------------


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_launch_loads_the_dot_library_alone_with_the_square_code(monkeypatch, sqr):
    """The lazy dot_general 5-bit tuple of each square routes to its own
    8-word library, which loads at the launch and runs
    tpn_verify_u32_modes with the square's code; its radix-11 library
    (verify_dot_<sqr>) never loads."""
    loaded, libs = _spy_loader(monkeypatch)
    modes, name = MODES[sqr], LIBRARY[sqr]
    assert cuda_kernel.kernel_library(*modes) == name
    assert cuda_kernel.U32_MODES_LIBRARIES[modes] == name and modes in cuda_kernel.U32_MODES_TUPLES
    load, codes = cuda_kernel._entry(name, modes)
    assert loaded == [] and codes == (SQR_CODE[sqr],)
    cuda_kernel._launch(name, load, [None] * 18, 7, False, codes, None)
    assert loaded == [name]
    lib = libs[name]
    assert lib.tpn_verify_u32_modes.calls == [(*[None] * 18, 7, 0, SQR_CODE[sqr], None)]
    assert not lib.tpn_verify_blocked.calls and not lib.tpn_verify_u32.calls


def test_exactly_the_two_dot_tuples_route_to_the_new_libraries():
    """Of every mode tuple, the two lazy affine one-hot 5-bit dot_general
    ones go to the new libraries; the other 30 dot_general tuples stay on
    their radix-11 library, and every other tuple goes where it did."""
    routed = {}
    for wb in (4, 5):
        for form in ("projective", "affine"):
            for reduce in ("lazy", "eager"):
                for select in ("tree", "onehot"):
                    for sqr in ("half", "mul"):
                        for mul in ("shift_add", "dot_general"):
                            modes = (wb, form, reduce, select, sqr, mul)
                            routed[modes] = cuda_kernel.kernel_library(*modes)
    assert {m: n for m, n in routed.items() if n in LIBRARY.values()} == {
        MODES[s]: LIBRARY[s] for s in LIBRARY}
    dots = [m for m in routed if m[5] == "dot_general" and m not in MODES.values()]
    assert len(dots) == 30 and all(routed[m] == YARDSTICK[m[4]] for m in dots)
    assert sum(n.startswith("verify_u32") for n in routed.values()) == 11
    assert routed[cuda_kernel.U32_MODES] == "verify_u32"


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_failed_build_or_launch_of_the_dot_library_raises_without_fallback(monkeypatch, sqr):
    name = LIBRARY[sqr]
    load, codes = cuda_kernel._entry(name, MODES[sqr])
    loaded, _ = _spy_loader(monkeypatch, fail=(name,))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_kernel._launch(name, load, [None] * 18, 7, False, codes, None)
    assert loaded == [name]  # never the radix-11 library, nor the eager one
    loaded, _ = _spy_loader(monkeypatch, ret=1)
    with pytest.raises(RuntimeError, match=f"launch failed \\({name}\\): invalid"):
        cuda_kernel._launch(name, load, [None] * 18, 7, False, codes, None)
    assert loaded == [name]


def test_entry_refuses_the_dot_libraries_at_other_modes(monkeypatch):
    """Before anything loads: each new library runs its own tuple alone (not
    the eager twin, the 4-bit one, the tree select, the projective form,
    shift-add or the other square), the eager 5-bit library refuses the
    lazy dot_general tuple, and the radix-11 entries of the new tuples stay
    in verify_dot_half and verify_dot_mul (the yardsticks), audited as
    radix-11."""
    loaded, _ = _spy_loader(monkeypatch)
    audited = []
    monkeypatch.setattr(cuda_kernel._bounds, "assert_formulas_safe",
                        lambda *a, **k: audited.append((a, k)))
    for sqr, name in LIBRARY.items():
        other = "mul" if sqr == "half" else "half"
        for modes in (cuda_kernel.U32_MODES, (5, "affine", "eager", "onehot", sqr, "dot_general"),
                      (5, "affine", "eager", "onehot", sqr, "shift_add"),
                      (4, "affine", "lazy", "onehot", sqr, "dot_general"),
                      (5, "affine", "lazy", "tree", sqr, "dot_general"),
                      (5, "projective", "lazy", "onehot", sqr, "dot_general"),
                      (5, "affine", "lazy", "onehot", sqr, "shift_add"), MODES[other]):
            with pytest.raises(ValueError, match="runs the modes"):
                cuda_kernel._entry(name, modes)
        with pytest.raises(ValueError, match="runs the modes"):
            cuda_kernel._entry(f"verify_u32_modes5_{sqr}", MODES[sqr])
    assert cuda_kernel._entry("verify_dot_half", MODES["half"])[1] == (5, 1, 0, 1, 0, 1)
    assert cuda_kernel._entry("verify_dot_mul", MODES["mul"])[1][4] == 1
    assert len(audited) == 2 and loaded == []


def test_dot_libraries_build_from_the_same_source_and_are_counted():
    """One source, one library a tuple: the new ones under -DTPN_WB=5
    -DTPN_U32_DOT=1 beside the square's -DTPN_SQR_MUL, each counted by
    library; the source refuses another value of the macro and any other
    select or form under it, and launches the one verify_u32_modes_kernel
    under it, its multiply chosen by the macro; the
    contraction's header is hashed with the others."""
    for sqr, name in LIBRARY.items():
        assert cuda_kernel._LIBRARIES[name] == (
            "verify_u32_modes.cu", ("TPN_WB=5", "TPN_U32_DOT=1", f"TPN_SQR_MUL={SQR_CODE[sqr]}"))
        assert {(name, v) for v in cuda_kernel.VARIANTS} <= set(cuda_kernel.LIBRARY_LAUNCHES)
    assert "field_u32_dot.cuh" in cuda_kernel._HEADERS
    src = (CSRC / "verify_u32_modes.cu").read_text()
    assert "#if TPN_U32_DOT != 0 && TPN_U32_DOT != 1" in src
    assert "#if TPN_U32_DOT && (TPN_SELECT_TREE || TPN_POINT_PROJECTIVE)" in src
    assert "std::conditional<TPN_U32_DOT == 1, dot::DotMul<SQR_MUL>, ShiftAdd<SQR_MUL>>" in src
    assert "static_assert(kU32ModesThreads == 32 * tpn::u32::dot::BLOCK_WARPS," in src
    assert "__global__" not in src.split("verify_u32_modes_kernel(VerifyArgs")[1]
    assert "#if TPN_U32_DOT\n" not in src
    assert '#include "field_u32_dot.cuh"' in src
    assert "TPN_MUL_DOT" not in src  # field.cuh's macro, the radix-11 libraries'


# ---------- chip_smoke.py's phases for the new kernels, against stubs -------------


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_u32_dot5_op_count_follows_the_kernel_structure(sqr):
    """u32_ops_per_lane at the lazy dot_general tuple: every product and
    square the contraction's count (u32_dot_ops_per_lane: its widening
    products, mma, shared-memory staging and carries), the lazy bodies'
    order (pt_add 12 products, 3 mul_small, 12 add, 5 sub; the mixed add 11
    products and a 24-word select keeping the accumulator on a digit 0;
    pt_double 6 products, 2 squares, 3 mul_small, 3 add, 1 sub) over the
    affine 5-bit program's structure; its full variant's bound at 32,768
    lanes 2.19 ms (half square) and 2.22 ms (full product) at 132 SMs and
    1,980 MHz, above the same products' shift-add count."""
    kind = KINDS[sqr]
    assert kind in chip_smoke.U32_MODES_KINDS
    ops, rep = chip_smoke.u32_ops_per_lane(kind), chip_smoke._rep
    shift = chip_smoke.u32_ops_per_lane(kind[:5])  # the same products, shift-add
    assert ops["mul"] == chip_smoke.u32_dot_ops_per_lane(False)
    assert ops["sqr"] == chip_smoke.u32_dot_ops_per_lane(True)
    assert ops["square"] == (ops["mul"] if sqr == "mul" else ops["sqr"])
    assert ops["pt_add"] == (rep(12, ops["mul"]) + rep(3, ops["mul_small"])
                             + rep(12, ops["add"]) + rep(5, ops["sub"]))
    assert ops["pt_add_mixed"] == (rep(11, ops["mul"]) + rep(2, ops["mul_small"])
                                   + rep(10, ops["add"]) + rep(3, ops["sub"])
                                   + chip_smoke._ops(alu=24))
    assert ops["pt_double"] == (rep(6, ops["mul"]) + rep(2, ops["square"])
                                + rep(3, ops["mul_small"]) + rep(3, ops["add"]) + ops["sub"])
    assert shift["pt_double"] == (rep(6, shift["mul"]) + rep(2, shift["square"])
                                  + rep(3, shift["mul_small"]) + rep(3, shift["add"])
                                  + shift["sub"])
    assert ops["full"]["mma"] > 0 and shift["full"]["mma"] == 0
    ms, by = chip_smoke.u32_bound_ms(32768, False, 132, 1980.0, kind)
    assert by == "operations" and round(ms, 2) == {"half": 2.19, "mul": 2.22}[sqr]
    assert chip_smoke.u32_bound_ms(32768, False, 132, 1980.0, kind[:5])[0] < ms
    with pytest.raises(ValueError, match="no 8-word kernel"):
        chip_smoke.u32_ops_per_lane((5, "affine", "lazy", "tree", sqr, "dot_general"))


def test_u32_dot5_bound_is_its_own_count_and_the_functions_least():
    """verify_bounds at the new tuples: the routed launch's formulation its
    own 8-word count in its square (the contraction's), the function's bound
    the half square's 8-word shift-add count of the same products (below
    the radix-11 one), the yardstick's formulation the radix-11 dot_general
    count; the lazy shift-add rows of the tuple, radix-11, share the
    function's bound."""
    sm, clock = 132, 1980.0
    for sf in (False, True):
        least = chip_smoke.u32_bound_ms(32768, sf, sm, clock, (5, "affine", "lazy", "onehot",
                                                                "half"))[0]
        for sqr, kind in KINDS.items():
            own = chip_smoke.u32_bound_ms(32768, sf, sm, clock, kind)[0]
            routed = chip_smoke.verify_bounds(32768, 0, sf, *kind[:5], sm, clock, "dot_general")
            assert routed["bound_ms"] == least < own < routed["radix11_bound_ms"]
            assert routed["u32_bound_ms"] == routed["formulation_bound_ms"] == own
            yard = chip_smoke.verify_bounds(32768, 0, sf, *kind[:5], sm, clock, "dot_general",
                                            chip_smoke.YARDSTICKS[kind])
            assert yard["bound_ms"] == least and yard["formulation_bound_ms"] == (
                chip_smoke.dot_kernel_bound_ms(32768, 0, sf, *kind[:5], sm, clock)[0])
            shift = chip_smoke.verify_bounds(32768, 0, sf, *kind[:5], sm, clock)
            assert shift["bound_ms"] == least and shift["formulation_bound_ms"] > least
    assert chip_smoke.u32_select_bytes(1, KINDS["half"][:5]) == {
        "local": 2 * 27 * 32 * 64, "shared": 2 * 27 * 32 * 64}


def test_ptxas_entries_key_the_dot_kernel_and_the_probe():
    """verify_u32_modes_kernel's instantiations in a dot_general library's
    log key u32_dot5/<sqr>, and the same names in an eager library's log
    the eager 5-bit ones' u32_modes5/<sqr>; the new probe keys
    field_mul_u32_dot, apart from field_mul_u32 and field_mul_dot; the
    snapshot of the radix-11 lines skips them all."""
    def entry(name, regs, stack):
        return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {name}\n"
                f"    {stack} bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
                f"ptxas info    : Used {regs} registers, used 1 barriers, 35520 bytes smem\n")

    log = "".join(entry(f"_ZN3tpn3u325modes23verify_u32_modes_kernelILi5ELb{sf}ELb{sq}ELb0ELb0E"
                        f"EEvNS1_10VerifyArgsEPKi", 250 + 2 * sf + sq, 4608)
                  for sf in (0, 1) for sq in (0, 1))
    got = chip_smoke.ptxas_entries(log, "dot_general")
    log = entry("_ZN3tpn3u325modes23verify_u32_modes_kernelILi5ELb0ELb0ELb0ELb0EEEvNS1_10"
                "VerifyArgsEPKi", 233, 4608)
    for probe in ("field_mul_u32_dot", "field_mul_u32", "field_mul_dot"):
        log += entry(f"_ZN3tpn{len(probe) + 7}{probe}_kernelEPKiS1_Pii", 70, 0)
    got.update(chip_smoke.ptxas_entries(log))
    assert set(got) == {f"{v}/u32_dot5/{s}" for v in ("full", "schnorr_free")
                        for s in ("half", "mul")} | {"full/u32_modes5/half", "field_mul_u32_dot",
                                                     "field_mul_u32", "field_mul_dot"}
    assert got["schnorr_free/u32_dot5/mul"] == {
        "registers": 253, "smem": 35520, "stack_frame": 4608, "spill_stores": 0,
        "spill_loads": 0}
    assert [chip_smoke.u32_ptxas_key(kind, "full") for kind in KINDS.values()] == [
        "full/u32_dot5/half", "full/u32_dot5/mul"]
    assert chip_smoke.YARDSTICKS[KINDS["half"]] == "verify_dot_half"
    assert chip_smoke.YARDSTICKS[KINDS["mul"]] == "verify_dot_mul"
    snap = {"source": "x", "nvcc": "n", "nvcc_flags": [], "entries": {}}
    assert chip_smoke.ptxas_vs_snapshot(got, snap, "n", [])["entries"] == 0


def _stub_phase3(kinds, wrong=None):
    items = [("e", i, 1, 1) if i != 5 else ("e", i, 1, 1, "bip340") for i in range(40)]
    oracle = [i % 4 == 1 for i in range(40)]
    launched, rows = [], []

    def make_args(batch, wb, variant):
        return list(batch), variant == "schnorr_free"

    def verdicts(args):
        return torch.tensor([oracle[it[1]] for it in args])

    def launch(args, sf, form, reduce, select, ladder, sqr, mul, library):
        launched.append((len(args), form, reduce, select, sqr, mul, library))
        out = verdicts(args)
        if wrong is not None and wrong(len(args), reduce, sqr, mul, library):
            out[-1] = ~out[-1]
        return out

    def plain(args, sf, form, reduce, select, ladder, sqr, mul):
        return verdicts(args)

    def timer(fn, repeats):
        fn()
        return 1.0

    max_err, _ = chip_smoke.kernel_vs_plain([("full", items, oracle)], kinds, make_args, launch,
                                            plain, timer, rows.append,
                                            yardstick=chip_smoke.YARDSTICKS,
                                            u32_lanes=(1, 31))
    return launched, rows, max_err


def test_kernel_vs_plain_launches_the_dot_yardsticks_and_lane_counts():
    """Phase 3 at 5 bits, affine: each new tuple launches dot_general by
    name in its radix-11 library beside its routed launch, against the
    shared output, and its routed kernel once more on each extra lane count
    under dot_general (rows labelled u32_dot5/<sqr>), beside the eager
    8-word kernels' shift-add ones; a wrong lane there raises."""
    kinds = chip_smoke.instantiations((5,), ("affine",))
    launched, rows, max_err = _stub_phase3(kinds)
    assert [x[1:] for x in launched if x[6] is not None] == [
        ("affine", "lazy", "onehot", "half", "dot_general", "verify_dot_half"),
        ("affine", "lazy", "onehot", "mul", "dot_general", "verify_dot_mul"),
        ("affine", "eager", "onehot", "half", "shift_add", "verify_half"),
        ("affine", "eager", "onehot", "mul", "shift_add", "verify_mul")]
    lanes = [(r["kernel"], r["mul"], r["lanes"]) for r in rows if r["phase"] == "u32_lanes"]
    assert lanes == [(f"u32_modes5/{s}", "shift_add", n) for s in ("half", "mul")
                     for n in (1, 31)] + [(f"u32_dot5/{s}", "dot_general", n)
                                           for s in ("half", "mul") for n in (1, 31)]
    for kind in KINDS.values():
        assert (*kind[:5], "full", "dot_general", chip_smoke.YARDSTICKS[kind]) in max_err
        assert (*kind[:5], "full", "dot_general", None) in max_err
    with pytest.raises(RuntimeError, match="u32_dot5/mul at 31 lanes"):
        _stub_phase3(kinds, wrong=lambda n, reduce, sqr, mul, library: (
            n == 31 and sqr == "mul" and library is None and mul == "dot_general"))


def _rows(forms_ms: dict) -> dict:
    """kernel_timing rows of the 5-bit affine one-hot kinds: each (reduce,
    sqr, mul, library) a ms, runs [ms, ms]."""
    rows = {}
    for (reduce, mul, library), base in forms_ms.items():
        for sqr in ("half", "mul"):
            for variant in ("full", "schnorr_free"):
                for lanes in (32768, 4096):
                    ms = base * (lanes / 32768)
                    lib = library(sqr) if callable(library) else library
                    rows[(5, "affine", reduce, "onehot", sqr, mul, lib, variant, lanes)] = {
                        "ms": ms, "ms_runs": [ms, ms], "bound_ms": 1.3,
                        "u32_bound_ms": 2.2 if reduce == "lazy" else 1.4,
                        "library": lib or f"lib_{reduce}_{mul}_{sqr}"}
    return rows


def test_dot_over_eager_twin_pairs_each_dot_row_with_its_eager_twin():
    """Phase 6's over_eager_twin lines: one a (square, variant, lanes), the
    routed lazy dot_general 8-word row over its routed eager shift-add
    8-word twin's, from the same turns; the yardsticks and the lazy
    shift-add rows are not paired, and the projective and tree lines stay
    their kinds' alone."""
    rows = _rows({("lazy", "dot_general", None): 7.0,
                  ("lazy", "dot_general", lambda s: f"verify_dot_{s}"): 136.0,
                  ("lazy", "shift_add", None): 21.0, ("eager", "shift_add", None): 3.5,
                  ("eager", "shift_add", lambda s: f"verify_{s}"): 27.0,
                  ("eager", "dot_general", None): 120.0})
    lines = chip_smoke.dot_over_eager_twin(rows)
    assert len(lines) == 8
    assert {(ln["kind"], ln["variant"], ln["lanes"]) for ln in lines} == {
        (KINDS[s], v, n) for s in ("half", "mul") for v in ("full", "schnorr_free")
        for n in (32768, 4096)}
    for ln in lines:
        assert ln["eager_kind"] == EAGER[ln["kind"][4]]
        assert ln["ratio"] == pytest.approx(2.0)
        assert (ln["library"], ln["eager_library"]) == (
            f"lib_lazy_dot_general_{ln['kind'][4]}", f"lib_eager_shift_add_{ln['kind'][4]}")
        assert ln["u32_bound_ms"] > ln["eager_u32_bound_ms"]
    assert chip_smoke.projective_over_affine(rows) == chip_smoke.tree_over_onehot(rows) == []


def test_timing_bursts_give_the_8_word_dot_kernels_two_and_the_radix11_ones_one():
    """The routed new kinds are timed there and back (two bursts), as fast
    as the shift-add ones; their radix-11 yardsticks and every other
    dot_general kind once; shift-add twice."""
    for sqr in ("half", "mul"):
        kind = (5, "affine", "lazy", "onehot", sqr)
        assert chip_smoke.timing_bursts((*kind, "dot_general", None)) == 2
        assert chip_smoke.timing_bursts((*kind, "dot_general", YARDSTICK[sqr])) == 1
        assert chip_smoke.timing_bursts((*kind, "shift_add", None)) == 2
        assert chip_smoke.timing_bursts((5, "affine", "lazy", "tree", sqr, "dot_general",
                                         None)) == 1


def test_kernel_timing_times_the_dot_kernel_with_its_yardstick_in_turns():
    """Phase 6 over the 5-bit affine lazy one-hot kinds with main()'s launch
    kinds: the routed dot_general kernel right after its shift-add twin,
    its radix-11 yardstick by name right after it; under timing_bursts the
    new kernel runs there and back, the yardstick once; the yardstick row
    gets u32_over_radix11 (the routed 8-word kernel's mean over its own)
    and both dot rows mul_dot_over_shift_add over the shift-add kind right
    before them; every launch is held against the shared plain output."""
    kinds = [(5, "affine", "lazy", "onehot", sqr) for sqr in ("half", "mul")]
    timing = [lk for kind in kinds for mul in chip_smoke.MUL_MODES for lk in (
        [(*kind, mul, None), (*kind, mul, chip_smoke.YARDSTICKS[chip_smoke.u32_kind(kind, mul)])]
        if chip_smoke.u32_kind(kind, mul) in chip_smoke.YARDSTICKS else [(*kind, mul, None)])]
    assert timing[:3] == [(*kinds[0], "shift_add", None), (*kinds[0], "dot_general", None),
                          (*kinds[0], "dot_general", "verify_dot_half")]
    bursts = []
    speed = {("shift_add", None): 21.0, ("dot_general", None): 7.0,
             ("dot_general", "verify_dot_half"): 136.0, ("dot_general", "verify_dot_mul"): 138.0}

    def launch(args, sf, form, reduce, select, sqr, mul, library):
        bursts.append((sqr, mul, library))
        return torch.arange(args[0]) % 3 == 0

    def timer(fn, repeats):
        fn()
        return 1.0 if repeats == 1 else speed[bursts[-1][1:]]

    rows = chip_smoke.kernel_timing([("full", list(range(64)))], timing,
                                    lambda items, lanes, wb, v: ((lanes,), False), launch,
                                    lambda args, sf, *m: torch.arange(args[0]) % 3 == 0, timer,
                                    lane_counts=(64,), bursts=chip_smoke.timing_bursts)
    for sqr, kind in zip(("half", "mul"), kinds):
        new = rows[(*kind, "dot_general", None, "full", 64)]
        yard = rows[(*kind, "dot_general", YARDSTICK[sqr], "full", 64)]
        assert new["ms_runs"] == [7.0, 7.0] and len(yard["ms_runs"]) == 1
        assert new["mul_dot_over_shift_add"] == pytest.approx(7.0 / 21.0)
        assert yard["u32_over_radix11"] == pytest.approx(7.0 / speed[("dot_general",
                                                                       YARDSTICK[sqr])])
        assert yard["twin_ms"] == 7.0 and yard["shift_add_twin_ms"] == 21.0
        assert new["twin_ms"] == 21.0 and new["max_abs_err"] == yard["max_abs_err"] == 0


def test_timing_plain_calls_run_ahead_and_are_read_back():
    """Phase 6's 16 plain calls made ahead (timing_plain_ahead: the first
    kind of each (width, form, reduce), at the first lane count, arguments
    made once a width) are read back by kernel_timing, which makes no plain
    call of its own and gives the rows it gives without them."""
    kinds = [(*kind, mul, None) for kind in chip_smoke.instantiations((4, 5),
                                                                      ("projective", "affine"))
             for mul in ("shift_add", "dot_general")]
    assert chip_smoke.timing_plain_keys(kinds) == [
        (wb, form, reduce, "tree", "half") for form in ("projective", "affine")
        for wb in (4, 5) for reduce in ("lazy", "eager")]
    made, planned = [], []

    def make_args(items, lanes, wb, variant):
        made.append((variant, wb, lanes))
        return (lanes, wb), variant == "schnorr_free"

    def plain(args, sf, form, reduce, select, sqr):
        planned.append((args[1], form, reduce, select, sqr))
        return torch.arange(args[0]) % 3 == 0

    def timer(fn, repeats):
        fn()
        return float(repeats)

    cases = [("full", list(range(64))), ("schnorr_free", list(range(64)))]
    ahead = chip_smoke.timing_plain_ahead(cases, kinds, make_args, plain, timer, lanes=64)
    assert len(ahead) == len(planned) == 16 and len(made) == 4
    assert set(ahead) == {(v, *key, 64) for v in ("full", "schnorr_free")
                          for key in chip_smoke.timing_plain_keys(kinds)}

    def launch(args, sf, form, reduce, select, sqr, mul, library):
        return torch.arange(args[0]) % 3 == 0

    rows = {}
    for given in (ahead, None):
        planned.clear()
        rows[given is None] = chip_smoke.kernel_timing(cases, kinds, make_args, launch, plain,
                                                       timer, lane_counts=(64, 8), ahead=given)
        assert len(planned) == (16 if given is None else 0)
    assert rows[True] == rows[False]


def test_probe_of_the_contraction_is_counted_and_bounded():
    """The field_mul_u32_dot probe: one of the probes, the function of
    field_mul (the same plain version, inputs and host check), its own
    formulation's count the contraction's; its Mosaic counterpart the
    dot_general probe; timed in turns with the three other multiplies."""
    assert "field_mul_u32_dot" in cuda_diag.PROBES and "field_mul_u32_dot" in cuda_diag.LAUNCHES
    assert cuda_diag.FUNCTIONS["field_mul_u32_dot"][1] is cuda_diag.field_mul_plain
    assert chip_smoke.PROBE_PALLAS_LINES["field_mul_u32_dot"] == 123
    assert "field_mul_u32_dot" in chip_smoke.FIELD_MUL_PROBES
    assert chip_smoke.probe_bytes("field_mul_u32_dot", 768) == 768 * 3 * 96
    dot, plain = chip_smoke.u32_probe_ops_per_lane(dot=True), chip_smoke.u32_probe_ops_per_lane()
    assert dot - plain == chip_smoke.u32_dot_ops_per_lane(False) - chip_smoke.u32_ops_per_lane()[
        "mul"]
    a, b = cuda_diag.probe_inputs("field_mul_u32_dot", "cpu")
    got = cuda_diag.field_mul_u32_dot(a, b)
    assert torch.equal(got, cuda_diag.field_mul_plain(a, b))
    assert cuda_diag._host_check("field_mul_u32_dot", got, (a, b)) == 0
    calls = []

    def timed(fn, repeats):
        fn()
        return {"dot": 4.0, "shift": 2.0, "u32": 1.0, "u32_dot": 1.5}[calls[-1]]

    got = chip_smoke.dot_over_shift_add(*(lambda c=c: calls.append(c)
                                          for c in ("dot", "shift", "u32")), timed,
                                        lambda: calls.append("u32_dot"))
    assert calls == ["dot", "shift", "u32", "u32_dot", "dot", "shift", "u32", "u32_dot",
                     "u32_dot", "u32", "shift", "dot"]
    assert got["u32_dot_ratio"] == pytest.approx(1.5) and got["ratio"] == pytest.approx(2.0)


# ---------- on a card ------------------------------------------------------------


@pytest.fixture(scope="module")
def card_items():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return chip_smoke.corrupt_every(
        chip_smoke.adversarial_items(O, random.Random(0xD9), lanes=200), 8)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 31, 33, 200])
@pytest.mark.parametrize("variant", ["full", "schnorr_free"])
@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_u32_dot5_kernel_on_card_matches_plain_and_radix11(card_items, sqr, variant, lanes):
    """The routed lazy dot_general 5-bit tuple launches its library; its
    verdicts equal the plain version's, the oracle's and the radix-11
    dot_general entry's by name."""
    batch = card_items if variant == "full" else chip_smoke.tile(
        [it for it in card_items if len(it) == 4], 200)
    batch = batch[:lanes]
    prep = K.prepare_batch_raw(pack_items(batch), pad_to=lanes, window_bits=5)
    args = K.from_reference(prep.device_args, "cuda")
    _, form, reduce, select, _, mul = MODES[sqr]
    modes = dict(schnorr_free=variant == "schnorr_free", point_form=form, reduce=reduce,
                 select=select, ladder="scan", sqr=sqr, mul=mul)
    counts = dict(cuda_kernel.LIBRARY_LAUNCHES)
    got = cuda_kernel.verify_blocked(*args, **modes)
    counts[(LIBRARY[sqr], variant)] += 1
    assert cuda_kernel.LIBRARY_LAUNCHES == counts
    radix11 = cuda_kernel.verify_with(YARDSTICK[sqr], *args, **modes)
    plain = K.verify_core(*args, **modes)
    assert got.tolist() == radix11.tolist() == plain.tolist() == O.verify_batch_cpu(batch)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 31, 33, 768, 4097])
def test_field_mul_u32_dot_matches_plain_version_and_the_other_probes(card_items, lanes):
    """The warp-collective probe at a ragged last warp: the probe's inputs
    tiled, limb for limb its plain version's, field_mul_u32's and the host
    check's."""
    a, b = cuda_diag.probe_inputs("field_mul_u32_dot", "cuda")
    idx = (torch.arange(lanes, device=a.device) + 512) % a.shape[-1]
    a, b = a[:, idx].contiguous(), b[:, idx].contiguous()
    launches = dict(cuda_diag.LAUNCHES)
    got = cuda_diag.field_mul_u32_dot(a, b)
    launches["field_mul_u32_dot"] += 1
    assert cuda_diag.LAUNCHES == launches
    assert got.device.type == "cuda" and torch.equal(got, cuda_diag.field_mul_plain(a, b))
    assert torch.equal(got, cuda_diag.field_mul_u32(a, b))
    assert cuda_diag._host_check("field_mul_u32_dot", got, (a, b)) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_engine_on_card_at_the_dot_tuple_runs_on_verify_u32_dot5(card_items, sqr):
    with chip_smoke.select_knob("onehot"), chip_smoke.sqr_knob(sqr), \
            chip_smoke.mul_knob("dot_general"):
        engine = VerifyEngine(VerifyConfig(batch_size=64, device_batch=128, window_bits=5,
                                           point_form="affine", field_reduce="lazy"))
    assert engine.wait_warmup(600) == "ready"  # its launches are not the test's
    counts = dict(cuda_kernel.LIBRARY_LAUNCHES)
    assert engine.verify_sync(card_items) == O.verify_batch_cpu(card_items)
    counts[(LIBRARY[sqr], "full")] += 2  # 128 + a 72-item tail padded to 128
    assert cuda_kernel.LIBRARY_LAUNCHES == counts
