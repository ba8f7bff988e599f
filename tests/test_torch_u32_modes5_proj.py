"""The one-hot eager projective 5-bit tuples on the 8-word arithmetic: 5-bit
windows, projective, eager, one-hot select, shift-add, with the
half-product or the full-product square (``csrc/verify_u32_modes.cu`` at
``WB = 5`` with the point form a template argument; libraries
``verify_u32_modes5_proj_half`` and ``verify_u32_modes5_proj_mul``, built
under ``-DTPN_WB=5 -DTPN_POINT_PROJECTIVE=1``).

The host harness ``tpunode_torch/csrc/host_u32_modes.cpp`` exports the
projective 5-bit table, selects, G tables and per-lane program as
``tpn_u32mp5_*``; the module fixture builds it once under UBSan (``lib``,
shared with ``tests/test_torch_u32_modes.py``).  The 32-entry projective
table [O, Q .. 31Q] is held against k·Q and against the port's plain chain
coordinate for coordinate; the 32-way one-hot select over 24-word entries
(Q's and λQ's in one walk, G's from shared memory at the 25-word stride)
against the port's ``select_onehot`` and the
reference's ``_select_entry_onehot`` for every digit; the per-lane program
against the port's plain ``verify_core`` at these modes, the reference's
``tpunode.verify.kernel.verify_core`` run on the CPU op by op at these
modes, and the oracle.  Routing is checked by a spy on the library loader,
and chip_smoke.py's count, bound, ptxas keys and phase-3 launches at these
tuples against stubs, u32_modes_ab.py's choice of libraries against source
trees.  The ``gpu``-marked cases run the kernel on a card.  Words, limbs and
verdicts are integers: every comparison is exact.
"""

import ctypes
import random
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from tests.test_torch_u32_modes import (  # noqa: F401  (lib: the harness fixture)
    CSRC, P, SQR_CODE, _affine, _int, _o, _ptr, _real_points, _spy_loader, _words, lib,
    reference_modes)
from tpunode.verify import kernel as RK
from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import field as F
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine
from tpunode_torch.verify.raw import pack_items

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import u32_modes_ab  # noqa: E402

torch.set_num_threads(1)

MODES = {sqr: (5, "projective", "eager", "onehot", sqr, "shift_add") for sqr in ("half", "mul")}
LIBRARY = {"half": "verify_u32_modes5_proj_half", "mul": "verify_u32_modes5_proj_mul"}
SOURCE = {"local_q": 0, "shared": 1, "local_lq": 2}  # tpn_u32mp5_select's source
KINDS = {sqr: modes[:5] for sqr, modes in MODES.items()}  # chip_smoke's kinds


# ---------- the projective table and the one-hot select ---------------------------


def test_projective_table_matches_k_q_and_the_plain_chain(lib):
    """Entry k of the 32-entry projective table is k·Q (entry 0 infinity,
    (0, 1, 0)), and coordinate for coordinate mod p the port's plain eager
    chain (_build_q_table: the same complete adds in the same order).  Q at
    full-width coordinates, and one Q given by its representatives plus
    p."""
    rng = np.random.default_rng(0x9E5)
    qs = [(pt.x, pt.y) for pt in _real_points(rng, 4)]
    qs.append(tuple(v + P if v + P < 1 << 256 else v for v in qs[0]))
    q = np.ascontiguousarray(np.stack([_words(pt) for pt in qs]))
    out = np.zeros((len(qs), 32, 3, 8), np.uint32)
    lib.tpn_u32mp5_table(_ptr(q), _ptr(out), len(qs))
    qx = torch.from_numpy(np.stack([F.to_limbs(x % P) for x, _ in qs], axis=1).astype(np.int32))
    qy = torch.from_numpy(np.stack([F.to_limbs(y % P) for _, y in qs], axis=1).astype(np.int32))
    plain = K._build_q_table(qx, qy, 5, "eager", ladder="scan", sqr="half",
                             mul="shift_add").numpy()
    for i, (x, y) in enumerate(qs):
        got = [tuple(_int(c) % P for c in out[i, k]) for k in range(32)]
        assert got[0] == (0, 1, 0)
        for k in range(1, 32):
            assert got[k] == tuple(F.from_limbs(plain[k, c, :, i]) % P for c in range(3)), (i, k)
            assert _affine(got[k]) == _o(O.point_mul(k, O.Point(x % P, y % P))), (i, k)


@pytest.mark.parametrize("source", ["local_q", "shared", "local_lq"])
def test_onehot_select_matches_the_port_and_the_reference(lib, source):
    """The 32-way one-hot select over 24-word entries of every digit, and
    digits with bits above the fifth (masked as the kernel masks them), over
    random tables: the words of the port's select_onehot and of the
    reference's _select_entry_onehot, from the one walk that picks Q's and
    λQ's entries (16-byte loads; Q's of the digit with λQ's of its
    complement, and λQ's of the digit with Q's of its complement) and from
    the G / λG select (shared memory, 25-word stride)."""
    rng = np.random.default_rng(0x9E6 + SOURCE[source])
    digits = np.array(list(range(32)) + [32 + 7, 0x7FFFFFE1, -1], dtype=np.int32)
    n = len(digits)
    tables = rng.integers(0, 2**32, size=(n, 32, 3, 8), dtype=np.uint32)
    out = np.zeros((n, 3, 8), np.uint32)
    assert lib.tpn_u32mp5_select(_ptr(tables), _ptr(digits), _ptr(out), n, SOURCE[source]) == 0
    masked = digits.astype(np.int64) & 31
    entries = [torch.from_numpy(tables[:, k].astype(np.int64)).permute(1, 2, 0)
               for k in range(32)]
    port = K.select_onehot(entries, torch.from_numpy(masked))
    assert np.array_equal(out, port.permute(2, 0, 1).numpy().astype(np.uint32))
    # the reference's (T, C, L, B) table in int32 words: one nonzero term a lane
    ref = RK._select_entry_onehot(jnp.asarray(tables.view(np.int32).transpose(1, 2, 3, 0)),
                                  jnp.asarray(masked.astype(np.int32)))
    assert np.array_equal(out, np.asarray(ref).view(np.uint32).transpose(2, 0, 1))
    assert lib.tpn_u32mp5_select(_ptr(tables), _ptr(digits), _ptr(out), n, 3) == 1


def test_g_tables_convert_to_the_projective_window_tables(lib):
    """G's and λG's 32-entry projective rows as a block converts them: each
    entry's words equal to the prep's limbs mod p."""
    rows = cuda_kernel._g_tables(torch.device("cpu"), 5, "projective")
    assert tuple(rows.shape) == (2, 32, 3, 24)
    out = np.zeros((2, 32, 3, 8), np.uint32)
    lib.tpn_u32mp5_g_tables(ctypes.c_void_p(rows.data_ptr()), _ptr(out))
    limbs = rows.numpy()
    for t in range(2):
        for k in range(32):
            for c in range(3):
                assert _int(out[t, k, c]) % P == F.from_limbs(limbs[t, k, c]) % P


# ---------- the per-lane program ---------------------------------------------------


@pytest.fixture(scope="module")
def items():
    """33 adversarial items (every shape of chip_smoke.adversarial_items),
    every eighth one corrupted."""
    adv = chip_smoke.adversarial_items(O, random.Random(0x9E7), lanes=33)
    return chip_smoke.corrupt_every(adv, 8)


@pytest.fixture(scope="module", params=["half", "mul"])
def reference(request, items):
    """The reference's verify_core on the CPU at the projective 5-bit tuple
    of the square ``sqr`` over the 33 items: (sqr, its verdicts)."""
    sqr = request.param
    with reference_modes(sqr, wb=5, form="projective"):
        prep = RK.prepare_batch(items, pad_to=len(items), native=False)
        assert prep.device_args[0].shape[0] == 27
        out = RK.verify_core(*(jnp.asarray(a) for a in prep.device_args))
        verdicts = [bool(v) for v in np.asarray(out)]
    assert RK.kernel_modes() == ("shift_add", "half", "lazy", "projective", "tree", "scan", 4)
    return sqr, verdicts


def _host_verify(lib, args, schnorr_free: bool, sqr: str) -> list:
    tables = cuda_kernel._g_tables(torch.device("cpu"), 5, "projective")
    out = torch.zeros(args[8].shape[-1], dtype=torch.bool)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (tables, *args, out)]
    assert lib.tpn_u32mp5_verify(*ptrs, out.shape[0], int(schnorr_free), SQR_CODE[sqr]) == 0
    return out.tolist()


@pytest.mark.parametrize("variant", ["full", "schnorr_free"])
def test_verify_lane_matches_plain_reference_and_oracle(lib, items, reference, variant):
    """verify_lane at 5 bits, projective, at B = 1, 31 and 33 at the tuple
    of each square: each lane's verdict the port's plain verify_core's at
    those modes on the 33-lane batch (a lane's verdict depends on its item
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
    tables = cuda_kernel._g_tables(torch.device("cpu"), 5, "projective")
    out = torch.zeros(1, dtype=torch.bool)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (tables, *args, out)]
    assert lib.tpn_u32mp5_verify(*ptrs, 1, 0, 2) == 1


# ---------- routing, by a spy on the library loader ---------------------------


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_launch_loads_the_projective_library_alone_with_the_square_code(monkeypatch, sqr):
    """The projective 5-bit tuple of each square routes to its own library,
    which loads at the launch and runs tpn_verify_u32_modes with the
    square's code; its radix-11 library never loads."""
    loaded, libs = _spy_loader(monkeypatch)
    modes, name = MODES[sqr], LIBRARY[sqr]
    assert cuda_kernel.kernel_library(*modes) == name
    assert cuda_kernel.U32_MODES_LIBRARIES[modes] == name
    load, codes = cuda_kernel._entry(name, modes)
    assert loaded == [] and codes == (SQR_CODE[sqr],)
    cuda_kernel._launch(name, load, [None] * 18, 7, False, codes, None)
    assert loaded == [name]
    lib = libs[name]
    assert lib.tpn_verify_u32_modes.calls == [(*[None] * 18, 7, 0, SQR_CODE[sqr], None)]
    assert not lib.tpn_verify_blocked.calls and not lib.tpn_verify_u32.calls


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_failed_build_or_launch_of_the_projective_library_raises_without_fallback(
        monkeypatch, sqr):
    name = LIBRARY[sqr]
    load, codes = cuda_kernel._entry(name, MODES[sqr])
    loaded, _ = _spy_loader(monkeypatch, fail=(name,))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_kernel._launch(name, load, [None] * 18, 7, False, codes, None)
    assert loaded == [name]  # never the radix-11 library, nor the affine one
    loaded, _ = _spy_loader(monkeypatch, ret=1)
    with pytest.raises(RuntimeError, match=f"launch failed \\({name}\\): invalid"):
        cuda_kernel._launch(name, load, [None] * 18, 7, False, codes, None)
    assert loaded == [name]


def test_entry_refuses_the_projective_libraries_at_other_modes(monkeypatch):
    """Before anything loads: each projective library runs its own tuple
    alone (not the affine 5-bit one, the 4-bit projective one, the tree
    select, lazy reduction, dot_general or the other square), an affine
    library refuses the projective tuple, and the radix-11 entries of the
    projective tuples stay in verify_half and verify_mul (the yardsticks),
    audited as radix-11."""
    loaded, _ = _spy_loader(monkeypatch)
    audited = []
    monkeypatch.setattr(cuda_kernel._bounds, "assert_formulas_safe",
                        lambda *a, **k: audited.append((a, k)))
    for sqr, name in LIBRARY.items():
        other = "mul" if sqr == "half" else "half"
        for modes in (cuda_kernel.U32_MODES, (5, "affine", "eager", "onehot", sqr, "shift_add"),
                      (4, "projective", "eager", "onehot", sqr, "shift_add"),
                      (5, "projective", "eager", "tree", sqr, "shift_add"),
                      (5, "projective", "lazy", "onehot", sqr, "shift_add"),
                      (5, "projective", "eager", "onehot", sqr, "dot_general"), MODES[other]):
            with pytest.raises(ValueError, match="runs the modes"):
                cuda_kernel._entry(name, modes)
        for affine in (f"verify_u32_modes5_{sqr}", f"verify_u32_modes_{sqr}"):
            with pytest.raises(ValueError, match="runs the modes"):
                cuda_kernel._entry(affine, MODES[sqr])
    assert cuda_kernel._entry("verify_half", MODES["half"])[1] == (5, 0, 1, 1, 0, 0)
    assert cuda_kernel._entry("verify_mul", MODES["mul"])[1][4] == 1
    assert len(audited) == 2 and loaded == []


def test_projective_libraries_build_from_the_same_source_and_are_counted():
    """One source, one library a (width, form, select, square): the
    projective ones under -DTPN_WB=5 -DTPN_POINT_PROJECTIVE=1 beside the
    square's -DTPN_SQR_MUL, each counted by library; the source refuses
    another form value and passes the form to the kernel; the six affine
    libraries keep their flags."""
    for sqr, name in LIBRARY.items():
        assert cuda_kernel._LIBRARIES[name] == (
            "verify_u32_modes.cu",
            ("TPN_WB=5", "TPN_POINT_PROJECTIVE=1", f"TPN_SQR_MUL={SQR_CODE[sqr]}"))
        assert {(name, v) for v in cuda_kernel.VARIANTS} <= set(cuda_kernel.LIBRARY_LAUNCHES)
    affine = {name: cuda_kernel._LIBRARIES[name][1]
              for key, name in cuda_kernel.U32_MODES_LIBRARIES.items()
              if key[1:3] == ("affine", "eager")}
    assert affine == {
        "verify_u32_modes_half": ("TPN_SQR_MUL=0",), "verify_u32_modes_mul": ("TPN_SQR_MUL=1",),
        "verify_u32_modes5_half": ("TPN_WB=5", "TPN_SQR_MUL=0"),
        "verify_u32_modes5_mul": ("TPN_WB=5", "TPN_SQR_MUL=1"),
        "verify_u32_modes_tree_half": ("TPN_SELECT_TREE=1", "TPN_SQR_MUL=0"),
        "verify_u32_modes_tree_mul": ("TPN_SELECT_TREE=1", "TPN_SQR_MUL=1")}
    src = (CSRC / "verify_u32_modes.cu").read_text()
    assert "#if TPN_POINT_PROJECTIVE != 0 && TPN_POINT_PROJECTIVE != 1" in src
    assert "constexpr bool kU32ModesProjective = TPN_POINT_PROJECTIVE == 1;" in src
    assert "kU32ModesTree, kU32ModesProjective>" in src


# ---------- chip_smoke.py's phases for the projective kernel, against stubs --------


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_u32_modes5_proj_op_count_follows_the_kernel_structure(sqr):
    """u32_ops_per_lane at the projective tuple: the table 30 complete adds
    and no inversion; a window 5 doublings and 4 complete adds, each with a
    one-hot select over 32 entries of 24 words, on every digit; 27
    windows; the pow ladders as the affine 5-bit kernel's.  Its full
    variant's count at 32,768 lanes: 1.33 ms (half square) and 1.39 ms
    (full product) at 132 SMs and 1,980 MHz."""
    kind = KINDS[sqr]
    assert kind in chip_smoke.U32_MODES_KINDS
    ops, rep = chip_smoke.u32_ops_per_lane(kind), chip_smoke._rep
    affine = chip_smoke.u32_ops_per_lane((5, "affine", *kind[2:]))
    for name in ("pt_add", "pt_double", "pow_const", "square", "mul", "pt_add_mixed"):
        assert ops[name] == affine[name], name
    assert ops["pt_add"] == (rep(12, ops["mul"]) + rep(2, ops["mul_small"])
                             + rep(14, ops["add"]) + rep(5, ops["sub"]))
    assert ops["select"] == chip_smoke._ops(alu=32 * (2 + 24))
    square = ops["square"]
    window = (rep(5, ops["pt_double"]) + rep(4, ops["select"] + ops["sub"]
                                             + chip_smoke._ops(alu=8) + ops["pt_add"])
              + ops["mul"] + chip_smoke._ops(alu=4))
    ecdsa = (rep(2, ops["from_radix11"]) + rep(30, ops["pt_add"]) + rep(27, window)
             + ops["canonical"] + chip_smoke._ops(alu=8)
             + rep(2, ops["from_radix11"] + ops["mul"] + ops["sub"] + ops["canonical"]
                   + chip_smoke._ops(alu=8))
             + rep(2, square) + ops["mul"] + ops["add"] + ops["sub"] + ops["canonical"]
             + chip_smoke._ops(alu=8))
    assert ops["schnorr_free"] == ecdsa
    for count in (ops, affine):  # the full variant's two pow ladders, the same in either form
        count["extra"] = count["full"].copy()
        count["extra"].subtract(count["schnorr_free"])
    assert +ops["extra"] == +affine["extra"]
    # about verify_u32's field products: 30 adds of 12, 27 x (5 x 8 + 4 x 12)
    assert ops["full"]["mul"] == {"half": 486300, "mul": 530204}[sqr]
    ms, by = chip_smoke.u32_bound_ms(32768, False, 132, 1980.0, kind)
    assert by == "operations" and round(ms, 2) == {"half": 1.33, "mul": 1.39}[sqr]


def test_u32_modes5_proj_bound_is_its_own_count_and_the_functions_least():
    """verify_bounds at the projective tuples: u32_bound_ms in the row's own
    square, the function's bound the half square's 8-word count (below the
    radix-11 one), the routed launch's formulation its own count, the
    yardstick's the radix-11 count in its square; the select reads 96-byte
    entries, Q's table once a window (one walk for Q and λQ)."""
    sm, clock = 132, 1980.0
    for sf in (False, True):
        half = chip_smoke.u32_bound_ms(32768, sf, sm, clock, KINDS["half"])[0]
        full_product = chip_smoke.u32_bound_ms(32768, sf, sm, clock, KINDS["mul"])[0]
        assert half < full_product
        for sqr, kind in KINDS.items():
            routed = chip_smoke.verify_bounds(32768, 0, sf, *kind, sm, clock)
            assert routed["bound_ms"] == half < routed["radix11_bound_ms"] / 2
            assert routed["u32_bound_ms"] == routed["formulation_bound_ms"] == (
                half if sqr == "half" else full_product)
            yard = chip_smoke.verify_bounds(32768, 0, sf, *kind, sm, clock, "shift_add",
                                            chip_smoke.YARDSTICKS[kind])
            assert yard["bound_ms"] == half and yard["formulation_bound_ms"] > half
    assert chip_smoke.u32_select_bytes(1, KINDS["half"]) == {
        "local": 27 * 32 * 96, "shared": 2 * 27 * 32 * 96}


def test_ptxas_entries_key_the_projective_kernel():
    """The kernel's fifth template argument (the form) keys the projective
    instantiations u32_modes5_proj/<sqr>; names of four arguments stay
    affine and those of three one-hot."""
    def entry(args, regs):
        name = f"_ZN3tpn3u325modes23verify_u32_modes_kernelI{args}EEvNS1_10VerifyArgsEPKi"
        return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {name}\n"
                f"    3072 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
                f"ptxas info    : Used {regs} registers, used 1 barriers, 6400 bytes smem\n")

    log = "".join(entry(f"Li5ELb{sf}ELb{sq}ELb0ELb1E", 220 + 2 * sf + sq)
                  for sf in (0, 1) for sq in (0, 1))
    log += entry("Li5ELb0ELb0ELb0ELb0E", 233) + entry("Li4ELb1ELb1ELb1E", 218)
    got = chip_smoke.ptxas_entries(log)
    assert set(got) == {f"{v}/u32_modes5_proj/{s}" for v in ("full", "schnorr_free")
                        for s in ("half", "mul")} | {"full/u32_modes5/half",
                                                     "schnorr_free/u32_modes_tree/mul"}
    assert got["schnorr_free/u32_modes5_proj/mul"] == {
        "registers": 223, "smem": 6400, "stack_frame": 3072, "spill_stores": 0,
        "spill_loads": 0}
    assert [chip_smoke.u32_ptxas_key(kind, "full") for kind in KINDS.values()] == [
        "full/u32_modes5_proj/half", "full/u32_modes5_proj/mul"]
    assert chip_smoke.YARDSTICKS[KINDS["half"]] == "verify_half"
    assert chip_smoke.YARDSTICKS[KINDS["mul"]] == "verify_mul"


def test_kernel_vs_plain_launches_the_projective_yardsticks_and_lane_counts():
    """Phase 3 at 5 bits, projective: each projective tuple launches
    shift-add by name in its radix-11 library beside its routed launch,
    against the shared output, and its routed kernel once more on each extra
    lane count (rows labelled u32_modes5_proj/<sqr>); a wrong lane there
    raises."""
    kinds = chip_smoke.instantiations((5,), ("projective",))
    items = [("e", i, 1, 1) if i != 5 else ("e", i, 1, 1, "bip340") for i in range(40)]
    oracle = [i % 4 == 1 for i in range(40)]
    launched, rows = [], []

    def make_args(batch, wb, variant):
        return list(batch), variant == "schnorr_free"

    def verdicts(args):
        return torch.tensor([oracle[it[1]] for it in args])

    def launch(args, sf, form, reduce, select, ladder, sqr, mul, library):
        launched.append((len(args), form, reduce, select, sqr, mul, library))
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
    assert [x[1:] for x in launched if x[6] is not None] == [
        ("projective", "eager", "onehot", "half", "shift_add", "verify_half"),
        ("projective", "eager", "onehot", "mul", "shift_add", "verify_mul")]
    assert [(r["kernel"], r["lanes"]) for r in rows if r["phase"] == "u32_lanes"] == [
        ("u32_modes5_proj/half", 1), ("u32_modes5_proj/half", 31),
        ("u32_modes5_proj/mul", 1), ("u32_modes5_proj/mul", 31)]
    for kind in KINDS.values():
        assert (*kind, "full", "shift_add", chip_smoke.YARDSTICKS[kind]) in max_err

    def wrong(args, sf, form, reduce, select, ladder, sqr, mul, library):
        out = verdicts(args)
        if len(args) == 31 and sqr == "mul" and library is None and reduce == "eager":
            out[-1] = ~out[-1]
        return out

    with pytest.raises(RuntimeError, match="u32_modes5_proj/mul at 31 lanes"):
        chip_smoke.kernel_vs_plain([("full", items, oracle)], kinds, make_args, wrong, plain,
                                   timer, rows.append, yardstick=chip_smoke.YARDSTICKS,
                                   u32_lanes=(31,))


def test_ab_times_the_projective_libraries_only_against_a_tree_that_builds_them(tmp_path):
    """u32_modes_ab.py's libraries: a tree whose source names
    TPN_POINT_PROJECTIVE builds all eight; a tree from before the projective
    form (its source without that macro) the six affine ones, and one from
    before the tree select too the four one-hot affine ones."""
    both = u32_modes_ab.shared_libraries(str(ROOT))
    assert both == cuda_kernel.U32_MODES_LIBRARIES
    assert both[MODES["half"]] == LIBRARY["half"]
    src = (CSRC / "verify_u32_modes.cu").read_text()
    (tmp_path / "tpunode_torch" / "csrc").mkdir(parents=True)
    older = tmp_path / "tpunode_torch" / "csrc" / "verify_u32_modes.cu"
    older.write_text("\n".join(line for line in src.splitlines()
                               if "TPN_POINT_PROJECTIVE" not in line))
    assert u32_modes_ab.shared_libraries(str(tmp_path)) == {
        key: lib for key, lib in both.items() if key[1] == "affine"}
    older.write_text("\n".join(line for line in src.splitlines()
                               if "TPN_POINT_PROJECTIVE" not in line
                               and "TPN_SELECT_TREE" not in line))
    assert u32_modes_ab.shared_libraries(str(tmp_path)) == {
        key: lib for key, lib in both.items() if (key[1], key[3]) == ("affine", "onehot")}


def test_projective_over_affine_pairs_each_projective_row_with_its_twin():
    """Phase 6's projective_over_affine lines: one a (square, variant,
    lanes), the routed shift-add projective row over its routed affine
    twin's, from the same turns; the yardstick and dot_general rows are not
    paired, and the tree lines stay the tree kinds' alone."""
    rows = {}
    for form, base in (("projective", 3.0), ("affine", 4.0)):
        for sqr in ("half", "mul"):
            for variant in ("full", "schnorr_free"):
                for lanes in (32768, 4096):
                    for mul, library, scale in (("shift_add", None, 1.0),
                                                ("shift_add", f"verify_{sqr}", 7.0),
                                                ("dot_general", None, 30.0)):
                        ms = base * scale * (lanes / 32768)
                        rows[(5, form, "eager", "onehot", sqr, mul, library, variant,
                              lanes)] = {"ms": ms, "ms_runs": [ms, ms], "bound_ms": 1.3,
                                         "u32_bound_ms": 1.33 if form == "projective" else 1.4,
                                         "library": library or f"lib_{form}_{sqr}"}
    lines = chip_smoke.projective_over_affine(rows)
    assert len(lines) == 8
    assert {(ln["kind"], ln["variant"], ln["lanes"]) for ln in lines} == {
        (KINDS[s], v, n) for s in ("half", "mul") for v in ("full", "schnorr_free")
        for n in (32768, 4096)}
    for ln in lines:
        assert ln["affine_kind"] == (5, "affine", *ln["kind"][2:])
        assert ln["ratio"] == pytest.approx(0.75)
        assert ln["ms_runs"] == [ln["ms"]] * 2 and ln["affine_ms_runs"] == [ln["affine_ms"]] * 2
        assert (ln["library"], ln["affine_library"]) == (f"lib_projective_{ln['kind'][4]}",
                                                         f"lib_affine_{ln['kind'][4]}")
        assert ln["u32_bound_ms"] < ln["affine_u32_bound_ms"]
    assert chip_smoke.tree_over_onehot(rows) == []


# ---------- on a card ------------------------------------------------------------


@pytest.fixture(scope="module")
def card_items():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return chip_smoke.corrupt_every(
        chip_smoke.adversarial_items(O, random.Random(0x9E8), lanes=200), 8)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 31, 33, 200])
@pytest.mark.parametrize("variant", ["full", "schnorr_free"])
@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_u32_modes5_proj_kernel_on_card_matches_plain_and_radix11(card_items, sqr, variant,
                                                                  lanes):
    """The routed projective 5-bit tuple launches its library; its verdicts
    equal the plain version's, the oracle's and the radix-11 entry's by
    name."""
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
def test_engine_on_card_at_the_projective_tuple_runs_on_verify_u32_modes5_proj(card_items,
                                                                                sqr):
    with chip_smoke.select_knob("onehot"), chip_smoke.sqr_knob(sqr):
        engine = VerifyEngine(VerifyConfig(batch_size=64, device_batch=128, window_bits=5,
                                           point_form="projective", field_reduce="eager"))
    assert engine.wait_warmup(600) == "ready"  # its launches are not the test's
    counts = dict(cuda_kernel.LIBRARY_LAUNCHES)
    assert engine.verify_sync(card_items) == O.verify_batch_cpu(card_items)
    counts[(LIBRARY[sqr], "full")] += 2  # 128 + a 72-item tail padded to 128
    assert cuda_kernel.LIBRARY_LAUNCHES == counts
