"""The one-hot eager affine 5-bit tuples on the 8-word arithmetic: 5-bit
windows, affine, eager, one-hot select, shift-add, with the half-product or
the full-product square (``csrc/verify_u32_modes.cu`` at ``WB = 5``;
libraries ``verify_u32_modes5_half`` and ``verify_u32_modes5_mul``, built
under ``-DTPN_WB=5``).

The host harness ``tpunode_torch/csrc/host_u32_modes.cpp`` exports the
5-bit table, selects, G tables and per-lane program as ``tpn_u32m5_*``; the
module fixture builds it once under UBSan (``lib``, shared with
``tests/test_torch_u32_modes.py``).  The 32-entry affine table is held
against Python modular inverses of the plain projective chain and against
k·Q; the 32-way one-hot select (Q's from entry 0 up, λQ's from entry 31
down, G's from shared memory) against the tree select; the per-lane program
against the port's plain ``verify_core`` at these modes, the reference's
``tpunode.verify.kernel.verify_core`` run on the CPU op by op at these
modes, and the oracle.  Routing is checked by a spy on the library loader,
and chip_smoke.py's count, bound and phase-3 launches at these tuples
against stubs.  The ``gpu``-marked cases run the kernel on a card.  Words,
limbs and verdicts are integers: every comparison is exact.
"""

import ctypes
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from tests.test_torch_u32_modes import (  # noqa: F401  (lib: the harness fixture)
    CSRC, P, SQR_CODE, _int, _o, _ptr, _real_points, _spy_loader, _words, lib, reference_modes)
from tpunode.verify import kernel as RK
from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import field as F
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

MODES = {sqr: (5, "affine", "eager", "onehot", sqr, "shift_add") for sqr in ("half", "mul")}
LIBRARY = {"half": "verify_u32_modes5_half", "mul": "verify_u32_modes5_mul"}
SOURCE = {"local": 0, "shared": 1, "local_down": 2}  # tpn_u32m5_select's source


# ---------- the affine table and the one-hot select -------------------------------


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_affine_table_matches_python_inverses_and_k_q(lib, sqr):
    """Entry k of the 32-entry affine table is the plain projective chain's
    entry k (eager bodies) times Python's modular inverse of its Z, and
    k·Q; entry 0 is the (0, 1) placeholder.  Q at full-width coordinates,
    and one Q given by its representatives plus p."""
    rng = np.random.default_rng(0xAF5)
    qs = [(pt.x, pt.y) for pt in _real_points(rng, 4)]
    qs.append(tuple(v + P if v + P < 1 << 256 else v for v in qs[0]))
    q = np.ascontiguousarray(np.stack([_words(pt) for pt in qs]))
    out = np.zeros((len(qs), 32, 2, 8), np.uint32)
    lib.tpn_u32m5_affine_table(_ptr(q), _ptr(out), len(qs), SQR_CODE[sqr])
    qx = torch.from_numpy(np.stack([F.to_limbs(x % P) for x, _ in qs], axis=1).astype(np.int32))
    qy = torch.from_numpy(np.stack([F.to_limbs(y % P) for _, y in qs], axis=1).astype(np.int32))
    proj = K._build_q_table(qx, qy, 5, "eager", ladder="scan", sqr=sqr, mul="shift_add").numpy()
    for i, (x, y) in enumerate(qs):
        got = [tuple(_int(c) % P for c in out[i, k]) for k in range(32)]
        assert got[0] == (0, 1)
        for k in range(1, 32):
            X, Y, Z = (F.from_limbs(proj[k, c, :, i]) % P for c in range(3))
            zi = pow(Z, -1, P)
            assert got[k] == (X * zi % P, Y * zi % P), (i, k)
            assert got[k] == _o(O.point_mul(k, O.Point(x % P, y % P))), (i, k)


@pytest.mark.parametrize("source", ["local", "shared", "local_down"])
def test_onehot_select_matches_the_tree_select(lib, source):
    """The 32-way one-hot select of every digit, and digits with bits above
    the fifth (masked as the kernel masks them), over random tables: the
    words of the entry the plain tree select picks, from the Q select (entry
    0 up, 16-byte loads), the λQ one (entry 31 down) and the G / λG one
    (shared memory, 17-word stride)."""
    rng = np.random.default_rng(0x5E5 + SOURCE[source])
    digits = np.array(list(range(32)) + [32 + 3, 0x7FFFFFF5, -1], dtype=np.int32)
    n = len(digits)
    tables = rng.integers(0, 2**32, size=(n, 32, 2, 8), dtype=np.uint32)
    out = np.zeros((n, 2, 8), np.uint32)
    assert lib.tpn_u32m5_select(_ptr(tables), _ptr(digits), _ptr(out), n, SOURCE[source]) == 0
    entries = [torch.from_numpy(tables[:, k].astype(np.int64)).permute(1, 2, 0)
               for k in range(32)]
    tree = K.select_tree16(entries, torch.from_numpy(digits.astype(np.int64) & 31))
    assert np.array_equal(out, tree.permute(2, 0, 1).numpy().astype(np.uint32))
    assert lib.tpn_u32m5_select(_ptr(tables), _ptr(digits), _ptr(out), n, 3) == 1


def test_g_tables_convert_to_the_affine_window_tables(lib):
    """G's and λG's 32-entry affine rows as a block converts them: each
    entry's words equal to the prep's limbs mod p."""
    rows = cuda_kernel._g_tables(torch.device("cpu"), 5, "affine")
    assert tuple(rows.shape) == (2, 32, 2, 24)
    out = np.zeros((2, 32, 2, 8), np.uint32)
    lib.tpn_u32m5_g_tables(ctypes.c_void_p(rows.data_ptr()), _ptr(out))
    limbs = rows.numpy()
    for t in range(2):
        for k in range(32):
            for c in range(2):
                assert _int(out[t, k, c]) % P == F.from_limbs(limbs[t, k, c]) % P


# ---------- the per-lane program ---------------------------------------------------


@pytest.fixture(scope="module")
def items():
    """33 adversarial items (every shape of chip_smoke.adversarial_items),
    every eighth one corrupted."""
    adv = chip_smoke.adversarial_items(O, random.Random(0x32B), lanes=33)
    return chip_smoke.corrupt_every(adv, 8)


@pytest.fixture(scope="module", params=["half", "mul"])
def reference(request, items):
    """The reference's verify_core on the CPU at the 5-bit tuple of the
    square ``sqr`` over the 33 items: (sqr, its verdicts)."""
    sqr = request.param
    with reference_modes(sqr, wb=5):
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
    assert lib.tpn_u32m5_verify(*ptrs, out.shape[0], int(schnorr_free), SQR_CODE[sqr]) == 0
    return out.tolist()


@pytest.mark.parametrize("variant", ["full", "schnorr_free"])
def test_verify_lane_matches_plain_reference_and_oracle(lib, items, reference, variant):
    """verify_lane at 5 bits at B = 1, 31 and 33 at the tuple of each
    square: each lane's verdict the port's plain verify_core's at those
    modes on the 33-lane batch (a lane's verdict depends on its item
    alone), the reference's verify_core's there (its one program is the full
    variant's; the schnorr_free batch's items are the full batch's ECDSA
    ones) and the oracle's."""
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
    for b in (1, 31, 33):
        prep = K.prepare_batch_raw(pack_items(batch[:b]), pad_to=b, window_bits=5)
        got = _host_verify(lib, K.from_reference(prep.device_args, "cpu"),
                           variant == "schnorr_free", sqr)
        assert got == plain[:b], b


def test_verify_refuses_another_square_code(lib, items):
    prep = K.prepare_batch_raw(pack_items(items[:1]), pad_to=1, window_bits=5)
    args = K.from_reference(prep.device_args, "cpu")
    tables = cuda_kernel._g_tables(torch.device("cpu"), 5, "affine")
    out = torch.zeros(1, dtype=torch.bool)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (tables, *args, out)]
    assert lib.tpn_u32m5_verify(*ptrs, 1, 0, 2) == 1


# ---------- routing, by a spy on the library loader ---------------------------


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_launch_loads_the_5_bit_library_alone_with_the_square_code(monkeypatch, sqr):
    """The 5-bit tuple of each square routes to its own library, which loads
    at the launch and runs tpn_verify_u32_modes with the square's code."""
    loaded, libs = _spy_loader(monkeypatch)
    modes, name = MODES[sqr], LIBRARY[sqr]
    assert cuda_kernel.kernel_library(*modes) == name
    load, codes = cuda_kernel._entry(name, modes)
    assert loaded == [] and codes == (SQR_CODE[sqr],)
    cuda_kernel._launch(name, load, [None] * 18, 7, False, codes, None)
    assert loaded == [name]
    lib = libs[name]
    assert lib.tpn_verify_u32_modes.calls == [(*[None] * 18, 7, 0, SQR_CODE[sqr], None)]
    assert not lib.tpn_verify_blocked.calls and not lib.tpn_verify_u32.calls


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_failed_build_or_launch_of_the_5_bit_library_raises_without_fallback(monkeypatch,
                                                                              sqr):
    name = LIBRARY[sqr]
    load, codes = cuda_kernel._entry(name, MODES[sqr])
    loaded, _ = _spy_loader(monkeypatch, fail=(name,))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_kernel._launch(name, load, [None] * 18, 7, False, codes, None)
    assert loaded == [name]  # never the radix-11 library, nor the 4-bit one
    loaded, _ = _spy_loader(monkeypatch, ret=1)
    with pytest.raises(RuntimeError, match=f"launch failed \\({name}\\): invalid"):
        cuda_kernel._launch(name, load, [None] * 18, 7, False, codes, None)
    assert loaded == [name]


def test_entry_refuses_the_5_bit_libraries_at_other_modes(monkeypatch):
    """Before anything loads: each 5-bit library runs its own tuple alone
    (not the 4-bit one, the other square, the tree select or dot_general);
    the radix-11 entries of the 5-bit tuples stay in verify_half and
    verify_mul (the yardsticks), audited as radix-11."""
    loaded, _ = _spy_loader(monkeypatch)
    audited = []
    monkeypatch.setattr(cuda_kernel._bounds, "assert_formulas_safe",
                        lambda *a, **k: audited.append((a, k)))
    for sqr, name in LIBRARY.items():
        other = "mul" if sqr == "half" else "half"
        for modes in (cuda_kernel.U32_MODES, (4, "affine", "eager", "onehot", sqr, "shift_add"),
                      (5, "affine", "eager", "tree", sqr, "shift_add"),
                      (5, "affine", "lazy", "onehot", sqr, "shift_add"),
                      (5, "affine", "eager", "onehot", sqr, "dot_general"), MODES[other]):
            with pytest.raises(ValueError, match="runs the modes"):
                cuda_kernel._entry(name, modes)
        with pytest.raises(ValueError, match="runs the modes"):
            cuda_kernel._entry(f"verify_u32_modes_{sqr}", MODES[sqr])
    assert cuda_kernel._entry("verify_half", MODES["half"])[1][:4] == (5, 1, 1, 1)
    assert cuda_kernel._entry("verify_mul", MODES["mul"])[1][4] == 1
    assert len(audited) == 2 and loaded == []


def test_5_bit_libraries_build_from_the_same_source_and_are_counted():
    """One source, one library a (width, form, select, square): the 5-bit ones
    under -DTPN_WB=5 beside the square's -DTPN_SQR_MUL, each counted by
    library; the source refuses another width."""
    for sqr, name in LIBRARY.items():
        assert cuda_kernel._LIBRARIES[name] == ("verify_u32_modes.cu",
                                                ("TPN_WB=5", f"TPN_SQR_MUL={SQR_CODE[sqr]}"))
        assert cuda_kernel.U32_MODES_LIBRARIES[MODES[sqr]] == name
        assert {(name, v) for v in cuda_kernel.VARIANTS} <= set(cuda_kernel.LIBRARY_LAUNCHES)
    src = (CSRC / "verify_u32_modes.cu").read_text()
    assert "#if TPN_WB != 4 && TPN_WB != 5" in src
    assert ("verify_u32_modes_kernel<kU32ModesWindowBits, SCHNORR_FREE, kU32ModesSqrMul,\n"
            in src)


# ---------- chip_smoke.py's phases for the 5-bit kernel, against stubs -------------


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_u32_modes5_op_count_follows_the_kernel_structure(sqr):
    """u32_ops_per_lane at the 5-bit tuple: the affine table 30 complete
    adds, 29 prefix and 119 suffix products and a Fermat ladder; a window 5
    doublings and 4 mixed adds each with a one-hot select over 32 entries of
    16 words; 27 windows; the pow ladders 4-bit as at 4 bits.  Its full
    variant's count at 32,768 lanes: 1.37 ms (half square) and 1.45 ms (full
    product) at 132 SMs and 1,980 MHz."""
    kind = (5, "affine", "eager", "onehot", sqr)
    assert kind in chip_smoke.U32_MODES_KINDS
    ops, rep = chip_smoke.u32_ops_per_lane(kind), chip_smoke._rep
    four = chip_smoke.u32_ops_per_lane((4, *kind[1:]))
    for name in ("pt_add_mixed", "pt_double", "pow_const", "square", "mul", "pt_add"):
        assert ops[name] == four[name], name
    assert ops["select"] == chip_smoke._ops(alu=32 * (2 + 16))
    square = ops["square"]
    window = (rep(5, ops["pt_double"]) + rep(4, ops["select"] + ops["sub"]
                                             + chip_smoke._ops(alu=8) + ops["pt_add_mixed"])
              + ops["mul"] + chip_smoke._ops(alu=4 + 4))
    table = rep(30, ops["pt_add"]) + rep(29 + 119, ops["mul"]) + ops["pow_const"]
    ecdsa = (rep(2, ops["from_radix11"]) + table + rep(27, window)
             + ops["canonical"] + chip_smoke._ops(alu=8)
             + rep(2, ops["from_radix11"] + ops["mul"] + ops["sub"] + ops["canonical"]
                   + chip_smoke._ops(alu=8))
             + rep(2, square) + ops["mul"] + ops["add"] + ops["sub"] + ops["canonical"]
             + chip_smoke._ops(alu=8))
    assert ops["schnorr_free"] == ecdsa
    for count in (ops, four):  # the full variant's two pow ladders, the same at either width
        count["extra"] = count["full"].copy()
        count["extra"].subtract(count["schnorr_free"])
    assert +ops["extra"] == +four["extra"]
    ms, by = chip_smoke.u32_bound_ms(32768, False, 132, 1980.0, kind)
    assert by == "operations" and round(ms, 2) == {"half": 1.37, "mul": 1.45}[sqr]


def test_kernel_vs_plain_launches_the_5_bit_yardsticks_and_lane_counts():
    """Phase 3 at 5 bits: each 5-bit tuple launches shift-add by name in its
    radix-11 library beside its routed launch, against the shared output,
    and its routed kernel once more on each extra lane count (rows labelled
    u32_modes5/<sqr>); a wrong lane there raises."""
    kinds = chip_smoke.instantiations((5,), ("affine",))
    items = [("e", i, 1, 1) if i != 5 else ("e", i, 1, 1, "bip340") for i in range(40)]
    oracle = [i % 4 == 1 for i in range(40)]
    launched, rows = [], []

    def make_args(batch, wb, variant):
        return list(batch), variant == "schnorr_free"

    def verdicts(args):
        return torch.tensor([oracle[it[1]] for it in args])

    def launch(args, sf, form, reduce, select, ladder, sqr, mul, library):
        launched.append((len(args), reduce, select, sqr, mul, library))
        return verdicts(args)

    def plain(args, sf, form, reduce, select, ladder, sqr, mul):
        return verdicts(args)

    def timer(fn, repeats):
        fn()
        return 1.0

    max_err, _ = chip_smoke.kernel_vs_plain([("full", items, oracle)], kinds, make_args, launch,
                                            plain, timer, rows.append,
                                            yardstick=chip_smoke.YARDSTICKS,
                                            u32_lanes=(1, 31))
    assert [x[1:] for x in launched if x[5] is not None and x[4] == "shift_add"] == [
        ("eager", "onehot", "half", "shift_add", "verify_half"),
        ("eager", "onehot", "mul", "shift_add", "verify_mul")]
    assert [(r["kernel"], r["lanes"]) for r in rows
            if r["phase"] == "u32_lanes" and r["mul"] == "shift_add"] == [
        ("u32_modes5/half", 1), ("u32_modes5/half", 31), ("u32_modes5/mul", 1),
        ("u32_modes5/mul", 31)]
    for kind in (kind for kind in chip_smoke.U32_MODES_KINDS
                 if kind[:3] == (5, "affine", "eager")):
        assert (*kind, "full", "shift_add", chip_smoke.YARDSTICKS[kind]) in max_err

    def wrong(args, sf, form, reduce, select, ladder, sqr, mul, library):
        out = verdicts(args)
        if len(args) == 31 and sqr == "half" and library is None and select == "onehot":
            out[-1] = ~out[-1]
        return out

    with pytest.raises(RuntimeError, match="u32_modes5/half at 31 lanes"):
        chip_smoke.kernel_vs_plain([("full", items, oracle)], kinds, make_args, wrong, plain,
                                   timer, rows.append, yardstick=chip_smoke.YARDSTICKS,
                                   u32_lanes=(31,))


# ---------- on a card ------------------------------------------------------------


@pytest.fixture(scope="module")
def card_items():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return chip_smoke.corrupt_every(
        chip_smoke.adversarial_items(O, random.Random(0x32E), lanes=200), 8)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 31, 33, 200])
@pytest.mark.parametrize("variant", ["full", "schnorr_free"])
@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_u32_modes5_kernel_on_card_matches_plain_and_radix11(card_items, sqr, variant, lanes):
    """The routed 5-bit tuple launches its library; its verdicts equal the
    plain version's, the oracle's and the radix-11 entry's by name."""
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
    radix11 = cuda_kernel.verify_with(cuda_kernel.VERIFY_LIBRARIES[(mul, sqr)], *args, **modes)
    plain = K.verify_core(*args, **modes)
    assert got.tolist() == radix11.tolist() == plain.tolist() == O.verify_batch_cpu(batch)


@pytest.mark.gpu
@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_engine_on_card_at_the_5_bit_tuple_runs_on_verify_u32_modes5(card_items, sqr):
    with chip_smoke.select_knob("onehot"), chip_smoke.sqr_knob(sqr):
        engine = VerifyEngine(VerifyConfig(batch_size=64, device_batch=128, window_bits=5,
                                           point_form="affine", field_reduce="eager"))
    assert engine.wait_warmup(600) == "ready"  # its launches are not the test's
    counts = dict(cuda_kernel.LIBRARY_LAUNCHES)
    assert engine.verify_sync(card_items) == O.verify_batch_cpu(card_items)
    counts[(LIBRARY[sqr], "full")] += 2  # 128 + a 72-item tail padded to 128
    assert cuda_kernel.LIBRARY_LAUNCHES == counts
