"""The tree eager affine 4-bit tuple on the 8-word arithmetic: 4-bit windows,
affine, eager, tree select, shift-add, with the half-product or the
full-product square (``csrc/verify_u32_modes.cu`` with ``TREE``; libraries
``verify_u32_modes_tree_half`` and ``verify_u32_modes_tree_mul``, built
under ``-DTPN_SELECT_TREE=1``).

The host harness ``tpunode_torch/csrc/host_u32_modes.cpp`` exports the tree
select's reads and the per-lane program as ``tpn_u32mt_*``; the module
fixture builds it once under UBSan (``lib``, shared with
``tests/test_torch_u32_modes.py``).  The reads of Q's, λQ's, G's and λG's
entries are held against the reference's and the port's ``select_tree16``
for every digit; the per-lane program against the port's plain
``verify_core`` at these modes, the reference's
``tpunode.verify.kernel.verify_core`` run on the CPU op by op at (4, affine,
eager, tree) and the oracle.  Routing is checked by a spy on the library
loader, and chip_smoke.py's count, bound, ptxas keys, phase-3 launches and
phase-6 tree / one-hot lines against stubs.  The ``gpu``-marked cases run
the kernel on a card.  Words, limbs and verdicts are integers: every
comparison is exact.
"""

import ctypes
import random
from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from tests.test_torch_u32_modes import (  # noqa: F401  (lib: the harness fixture)
    CSRC, P, SQR_CODE, _int, _ptr, _spy_loader, lib, reference_modes)
from tpunode.verify import kernel as RK
from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

MODES = {sqr: (4, "affine", "eager", "tree", sqr, "shift_add") for sqr in ("half", "mul")}
LIBRARY = {"half": "verify_u32_modes_tree_half", "mul": "verify_u32_modes_tree_mul"}
ONEHOT_LIBRARY = {"half": "verify_u32_modes_half", "mul": "verify_u32_modes_mul"}
SOURCE = {"q": 0, "g": 1, "lg": 2, "lq": 3}  # tpn_u32mt_select's source


# ---------- the tree select's reads ------------------------------------------------


@pytest.mark.parametrize("source", list(SOURCE))
def test_tree_reads_match_select_tree16(lib, source):
    """The tree select's read of every digit, and digits with bits above the
    fourth (masked as the kernel masks them), over random tables: the words
    of the entry the reference's select_tree16 (15 wheres, one digit bit a
    level) and the port's pick, read as Q's entry (16-byte loads of the
    lane's table), G's and λG's (shared memory, 17-word stride, tables t 0
    and t 1) and λQ's (Q's entry, x·β mod p); another source is refused."""
    rng = np.random.default_rng(0x7EE + SOURCE[source])
    digits = np.array(list(range(16)) + [16 + 3, 0x7FFFFFF5, -1, -16], dtype=np.int32)
    n = len(digits)
    tables = rng.integers(0, 2**32, size=(n, 16, 2, 8), dtype=np.uint32)
    out = np.zeros((n, 2, 8), np.uint32)
    assert lib.tpn_u32mt_select(_ptr(tables), _ptr(digits), _ptr(out), n, SOURCE[source]) == 0
    ref = np.asarray(RK.select_tree16([jnp.asarray(tables[:, k]) for k in range(16)],
                                      jnp.asarray(digits & 15)[:, None, None]))
    port = K.select_tree16([torch.from_numpy(tables[:, k].astype(np.int64)).permute(1, 2, 0)
                            for k in range(16)], torch.from_numpy(digits.astype(np.int64) & 15))
    assert np.array_equal(ref, port.permute(2, 0, 1).numpy().astype(np.uint32))
    assert np.array_equal(ref, tables[np.arange(n), digits & 15])
    if source == "lq":
        assert np.array_equal(out[:, 1], ref[:, 1])
        assert [_int(x) % P for x in out[:, 0]] == [_int(x) * K.BETA % P for x in ref[:, 0]]
    else:
        assert np.array_equal(out, ref)
    assert lib.tpn_u32mt_select(_ptr(tables), _ptr(digits), _ptr(out), n, 4) == 1


# ---------- the per-lane program ---------------------------------------------------


@pytest.fixture(scope="module")
def items():
    """33 adversarial items (every shape of chip_smoke.adversarial_items),
    every eighth one corrupted."""
    adv = chip_smoke.adversarial_items(O, random.Random(0x7EEE), lanes=33)
    return chip_smoke.corrupt_every(adv, 8)


@pytest.fixture(scope="module", params=["half", "mul"])
def reference(request, items):
    """The reference's verify_core on the CPU at (4, affine, eager, tree) in
    the square ``sqr`` over the 33 items: (sqr, its verdicts); its modes
    restored after."""
    sqr = request.param
    with reference_modes(sqr, select="tree"):
        prep = RK.prepare_batch(items, pad_to=len(items), native=False)
        out = RK.verify_core(*(jnp.asarray(a) for a in prep.device_args))
        verdicts = [bool(v) for v in np.asarray(out)]
    assert RK.kernel_modes() == ("shift_add", "half", "lazy", "projective", "tree", "scan", 4)
    return sqr, verdicts


def _host_verify(lib, args, schnorr_free: bool, sqr: str, tree: bool = True) -> list:
    tables = cuda_kernel._g_tables(torch.device("cpu"), 4, "affine")
    out = torch.zeros(args[8].shape[-1], dtype=torch.bool)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (tables, *args, out)]
    verify = lib.tpn_u32mt_verify if tree else lib.tpn_u32m_verify
    assert verify(*ptrs, out.shape[0], int(schnorr_free), SQR_CODE[sqr]) == 0
    return out.tolist()


@pytest.mark.parametrize("variant", ["full", "schnorr_free"])
def test_verify_lane_matches_plain_reference_and_oracle(lib, items, reference, variant):
    """verify_lane with the tree select at B = 1, 31 and 33 at the tuple of
    each square: each lane's verdict the port's plain verify_core's at those
    modes on the 33-lane batch (a lane's verdict depends on its item alone),
    the reference's verify_core's at (4, affine, eager, tree) (its one
    program is the full variant's; the schnorr_free batch's items are the
    full batch's ECDSA ones), the oracle's, and the one-hot program's."""
    sqr, ref = reference
    ref_by_item = dict(zip(map(id, items), ref))
    batch = items if variant == "full" else chip_smoke.tile(
        [it for it in items if len(it) == 4], 33)
    prep = K.prepare_batch_raw(pack_items(batch), pad_to=33, window_bits=4)
    assert prep.schnorr_free == (variant == "schnorr_free")
    _, form, reduce, select, _, mul = MODES[sqr]
    with torch.inference_mode():
        plain = K.verify_core(*K.from_reference(prep.device_args, "cpu"),
                              schnorr_free=prep.schnorr_free, point_form=form, reduce=reduce,
                              select=select, ladder="scan", sqr=sqr, mul=mul).tolist()
    oracle = O.verify_batch_cpu(batch)
    assert plain == [ref_by_item[id(it)] for it in batch] == oracle
    assert 0 < sum(oracle) < len(oracle)
    for b in (1, 31, 33):
        prep = K.prepare_batch_raw(pack_items(batch[:b]), pad_to=b, window_bits=4)
        args = K.from_reference(prep.device_args, "cpu")
        got = _host_verify(lib, args, variant == "schnorr_free", sqr)
        assert got == plain[:b] == _host_verify(lib, args, variant == "schnorr_free", sqr,
                                                tree=False), b


def test_verify_refuses_another_square_code(lib, items):
    prep = K.prepare_batch_raw(pack_items(items[:1]), pad_to=1, window_bits=4)
    args = K.from_reference(prep.device_args, "cpu")
    tables = cuda_kernel._g_tables(torch.device("cpu"), 4, "affine")
    out = torch.zeros(1, dtype=torch.bool)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (tables, *args, out)]
    for sqr in (2, -1):
        assert lib.tpn_u32mt_verify(*ptrs, 1, 0, sqr) == 1


# ---------- routing, by a spy on the library loader ---------------------------


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_launch_loads_the_tree_library_alone_with_the_square_code(monkeypatch, sqr):
    """The tree tuple of each square routes to its own library under either
    ladder's caller, which loads at the launch and runs
    tpn_verify_u32_modes with the square's code."""
    loaded, libs = _spy_loader(monkeypatch)
    modes, name = MODES[sqr], LIBRARY[sqr]
    assert cuda_kernel.kernel_library(*modes) == name
    assert cuda_kernel.U32_MODES_LIBRARIES[modes] == name
    load, codes = cuda_kernel._entry(name, modes)
    assert loaded == [] and codes == (SQR_CODE[sqr],)
    cuda_kernel._launch(name, load, [None] * 18, 7, True, codes, None)
    assert loaded == [name]
    lib = libs[name]
    assert lib.tpn_verify_u32_modes.calls == [(*[None] * 18, 7, 1, SQR_CODE[sqr], None)]
    assert not lib.tpn_verify_blocked.calls and not lib.tpn_verify_u32.calls


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_failed_build_or_launch_of_the_tree_library_raises_without_fallback(monkeypatch, sqr):
    name = LIBRARY[sqr]
    load, codes = cuda_kernel._entry(name, MODES[sqr])
    loaded, _ = _spy_loader(monkeypatch, fail=(name,))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_kernel._launch(name, load, [None] * 18, 7, False, codes, None)
    assert loaded == [name]  # never the radix-11 library, nor the one-hot twin
    loaded, _ = _spy_loader(monkeypatch, ret=1)
    with pytest.raises(RuntimeError, match=f"launch failed \\({name}\\): invalid"):
        cuda_kernel._launch(name, load, [None] * 18, 7, False, codes, None)
    assert loaded == [name]


def test_entry_refuses_the_tree_libraries_at_other_modes(monkeypatch):
    """Before anything loads: each tree library runs its own tuple alone
    (not its one-hot twin, the 5-bit tree, lazy, projective, dot_general or
    the other square), and no other library runs the tree tuple; the
    radix-11 entries of the tree tuples stay in verify_half and verify_mul
    (the yardsticks), audited as radix-11; the 5-bit tree tuple still routes
    to radix-11."""
    loaded, _ = _spy_loader(monkeypatch)
    audited = []
    monkeypatch.setattr(cuda_kernel._bounds, "assert_formulas_safe",
                        lambda *a, **k: audited.append((a, k)))
    for sqr, name in LIBRARY.items():
        other = "mul" if sqr == "half" else "half"
        for modes in (cuda_kernel.U32_MODES, (4, "affine", "eager", "onehot", sqr, "shift_add"),
                      (5, "affine", "eager", "tree", sqr, "shift_add"),
                      (4, "affine", "lazy", "tree", sqr, "shift_add"),
                      (4, "projective", "eager", "tree", sqr, "shift_add"),
                      (4, "affine", "eager", "tree", sqr, "dot_general"), MODES[other]):
            with pytest.raises(ValueError, match="runs the modes"):
                cuda_kernel._entry(name, modes)
        for lib in (ONEHOT_LIBRARY[sqr], f"verify_u32_modes5_{sqr}", "verify_u32"):
            with pytest.raises(ValueError, match="runs the modes"):
                cuda_kernel._entry(lib, MODES[sqr])
        assert cuda_kernel.kernel_library(5, "affine", "eager", "tree", sqr, "shift_add") == (
            f"verify_{sqr}")
    assert cuda_kernel._entry("verify_half", MODES["half"])[1][:4] == (4, 1, 1, 0)
    assert cuda_kernel._entry("verify_mul", MODES["mul"])[1][4] == 1
    assert len(audited) == 2 and loaded == []


def test_tree_libraries_build_from_the_same_source_and_are_counted():
    """One source, one library a (width, select, square): the tree ones
    under -DTPN_SELECT_TREE=1 beside the square's -DTPN_SQR_MUL, 4-bit only
    (a library is built only where a tuple routes), each counted by library;
    the source refuses another select value."""
    for sqr, name in LIBRARY.items():
        defines = ("TPN_SELECT_TREE=1", f"TPN_SQR_MUL={SQR_CODE[sqr]}")
        assert cuda_kernel._LIBRARIES[name] == ("verify_u32_modes.cu", defines)
        assert {(name, v) for v in cuda_kernel.VARIANTS} <= set(cuda_kernel.LIBRARY_LAUNCHES)
    trees = [key for key in cuda_kernel.U32_MODES_LIBRARIES if key[3] == "tree"]
    assert trees == [MODES["half"], MODES["mul"]]
    src = (CSRC / "verify_u32_modes.cu").read_text()
    assert "#if TPN_SELECT_TREE != 0 && TPN_SELECT_TREE != 1" in src
    assert "constexpr bool kU32ModesTree = TPN_SELECT_TREE == 1;" in src
    assert "verify_u32_modes_kernel<kU32ModesWindowBits, SCHNORR_FREE, kU32ModesSqrMul,\n" in src


# ---------- chip_smoke.py's phases for the tree kernel, against stubs --------------


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_u32_modes_tree_op_count_drops_the_onehot_masks(sqr):
    """u32_ops_per_lane at the tree tuple: its one-hot twin's count but the
    selects' masked ORs (16 entries x (a compare, a negate and 16 LOP3s), 4
    selects a window, 33 windows), which the tree select's read by index
    does not have; every formula's count is the twin's.  Its full variant's
    count at 32,768 lanes: 1.30 ms (half square) and 1.38 ms (full product)
    at 132 SMs and 1,980 MHz, below the twin's 1.34 / 1.42."""
    kind = (4, "affine", "eager", "tree", sqr)
    twin = (4, "affine", "eager", "onehot", sqr)
    assert kind in chip_smoke.U32_MODES_KINDS and chip_smoke.YARDSTICKS[kind] == f"verify_{sqr}"
    ops, onehot = chip_smoke.u32_ops_per_lane(kind), chip_smoke.u32_ops_per_lane(twin)
    for name in ("pt_add_mixed", "pt_double", "pow_const", "square", "mul", "pt_add"):
        assert ops[name] == onehot[name], name
    assert ops["select"] == Counter() and onehot["select"] == chip_smoke._ops(alu=16 * 18)
    masks = chip_smoke._rep(33 * 4, onehot["select"])
    for variant in ("schnorr_free", "full"):
        assert ops[variant] + masks == onehot[variant]
    ms = {s: chip_smoke.u32_bound_ms(32768, False, 132, 1980.0, s)[0] for s in (kind, twin)}
    assert round(ms[kind], 2) == {"half": 1.30, "mul": 1.38}[sqr] and ms[kind] < ms[twin]


def test_u32_modes_tree_bound_and_select_bytes():
    """verify_bounds at the tree tuple: its own half-square 8-word count as
    the function's bound (below the radix-11 one), its own square's as the
    routed launch's formulation; the yardstick's formulation the radix-11
    count.  The select reads one 64-byte entry a Q and a λQ select (and a G
    and a λG one), not 16."""
    sm, clock = 132, 1980.0
    for sf in (False, True):
        half, _ = chip_smoke.u32_bound_ms(32768, sf, sm, clock, (4, "affine", "eager", "tree",
                                                                  "half"))
        for sqr in ("half", "mul"):
            kind = (4, "affine", "eager", "tree", sqr)
            own, by = chip_smoke.u32_bound_ms(32768, sf, sm, clock, kind)
            routed = chip_smoke.verify_bounds(32768, 0, sf, *kind, sm, clock)
            assert routed["bound_ms"] == half < routed["radix11_bound_ms"] / 2
            assert routed["u32_bound_ms"] == routed["formulation_bound_ms"] == own
            assert by == "operations"
            yard = chip_smoke.verify_bounds(32768, 0, sf, *kind, sm, clock, "shift_add",
                                            chip_smoke.YARDSTICKS[kind])
            assert yard["bound_ms"] == half and yard["formulation_bound_ms"] > half
    assert chip_smoke.u32_select_bytes(1, (4, "affine", "eager", "tree", "half")) == {
        "local": 2 * 33 * 64, "shared": 2 * 33 * 64}
    w5 = chip_smoke.verify_bounds(32768, 0, False, 5, "affine", "eager", "tree", "half", sm, clock)
    assert "u32_bound_ms" not in w5 and w5["bound_ms"] == w5["radix11_bound_ms"]


def test_ptxas_entries_key_the_tree_kernels_and_read_older_names_as_onehot():
    """The kernel's select argument names the tree instantiations
    (u32_modes_tree/<sqr>); a name with it false, or without it (a tree
    before the tree select), is the one-hot one."""
    def entry(args, regs):
        name = f"_ZN3tpn3u325modes23verify_u32_modes_kernelI{args}EEvNS1_10VerifyArgsEPKi"
        return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {name}\n"
                f"    2560 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
                f"ptxas info    : Used {regs} registers, used 1 barriers, 2176 bytes smem\n")

    log = "".join(entry(f"Li4ELb{sf}ELb{sq}ELb{tree}E", 200 + 10 * tree + 2 * sf + sq)
                  for sf in (0, 1) for sq in (0, 1) for tree in (0, 1))
    got = chip_smoke.ptxas_entries(log)
    assert set(got) == {f"{v}/u32_modes{t}/{s}" for v in ("full", "schnorr_free")
                        for s in ("half", "mul") for t in ("", "_tree")}
    assert got["schnorr_free/u32_modes_tree/mul"]["registers"] == 213
    assert got["full/u32_modes/half"]["registers"] == 200
    older = chip_smoke.ptxas_entries(entry("Li4ELb0ELb1E", 229))
    assert older == {"full/u32_modes/mul": {"registers": 229, "smem": 2176, "stack_frame": 2560,
                                            "spill_stores": 0, "spill_loads": 0}}
    assert [chip_smoke.u32_ptxas_key(kind, "full") for kind in chip_smoke.U32_MODES_KINDS
            if kind[3] == "tree"] == ["full/u32_modes_tree/half", "full/u32_modes_tree/mul"]


def test_memory_opcodes_keep_the_load_widths_apart():
    ops = Counter({"LDL.128": 8, "LDL": 3, "LDS": 32, "LDS.64": 2, "STL.128": 4, "LDG.E": 5,
                   "IMAD.WIDE.U32": 100, "LDSM.16": 1})
    assert chip_smoke.memory_opcodes(ops) == {"LDL": 3, "LDL.128": 8, "LDS": 32, "LDS.64": 2,
                                              "STL.128": 4}
    assert chip_smoke.sass_classes(ops)["LDL"] == 11


def test_kernel_vs_plain_launches_the_tree_yardsticks_and_lane_counts():
    """Phase 3 at 4 bits: each tree tuple launches shift-add by name in its
    radix-11 library beside its routed launch, as its one-hot twin does,
    against the shared output, and its routed kernel once more on each
    extra lane count (rows labelled u32_modes_tree/<sqr>); a wrong lane
    there raises."""
    kinds = chip_smoke.instantiations((4,), ("projective", "affine"))
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
    assert [x[1:] for x in launched if x[5] is not None] == [
        ("lazy", "tree", "half", "shift_add", "verify_half"),  # the default tuple's
        ("eager", "tree", "half", "shift_add", "verify_half"),
        ("eager", "tree", "mul", "shift_add", "verify_mul"),
        ("eager", "onehot", "half", "shift_add", "verify_half"),
        ("eager", "onehot", "mul", "shift_add", "verify_mul")]
    tree_rows = [(r["kernel"], r["lanes"]) for r in rows
                 if r["phase"] == "u32_lanes" and r["point_form"] == "affine"
                 and r["select"] == "tree"]
    assert tree_rows == [("u32_modes_tree/half", 1), ("u32_modes_tree/half", 31),
                         ("u32_modes_tree/mul", 1), ("u32_modes_tree/mul", 31)]
    for sqr in ("half", "mul"):
        kind = (4, "affine", "eager", "tree", sqr)
        assert (*kind, "full", "shift_add", f"verify_{sqr}") in max_err

    def wrong(args, sf, form, reduce, select, ladder, sqr, mul, library):
        out = verdicts(args)
        if (len(args) == 31 and (select, reduce, sqr) == ("tree", "eager", "half")
                and library is None):
            out[-1] = ~out[-1]
        return out

    with pytest.raises(RuntimeError, match="u32_modes_tree/half at 31 lanes"):
        chip_smoke.kernel_vs_plain([("full", items, oracle)], kinds, make_args, wrong, plain,
                                   timer, rows.append, yardstick=chip_smoke.YARDSTICKS,
                                   u32_lanes=(31,))


def test_tree_over_onehot_pairs_each_tree_row_with_its_twin():
    """Phase 6's tree_over_onehot lines: one a (square, variant, lanes), the
    routed shift-add tree row over its routed one-hot twin's, from the same
    turns; the yardstick and dot_general rows are not paired."""
    rows = {}
    for select, base in (("tree", 3.0), ("onehot", 4.0)):
        for sqr in ("half", "mul"):
            for variant in ("full", "schnorr_free"):
                for lanes in (32768, 4096):
                    for mul, library, scale in (("shift_add", None, 1.0),
                                                ("shift_add", f"verify_{sqr}", 7.0),
                                                ("dot_general", None, 30.0)):
                        ms = base * scale * (lanes / 32768)
                        rows[(4, "affine", "eager", select, sqr, mul, library, variant,
                              lanes)] = {"ms": ms, "ms_runs": [ms, ms], "bound_ms": 1.3,
                                         "u32_bound_ms": 1.3 if select == "tree" else 1.34,
                                         "library": library or f"lib_{select}_{sqr}"}
    lines = chip_smoke.tree_over_onehot(rows)
    assert len(lines) == 8
    assert {(ln["kind"][4], ln["variant"], ln["lanes"]) for ln in lines} == {
        (s, v, n) for s in ("half", "mul") for v in ("full", "schnorr_free")
        for n in (32768, 4096)}
    for ln in lines:
        assert ln["kind"][3] == "tree" and ln["ratio"] == pytest.approx(0.75)
        assert (ln["library"], ln["onehot_library"]) == (f"lib_tree_{ln['kind'][4]}",
                                                         f"lib_onehot_{ln['kind'][4]}")
        assert ln["u32_bound_ms"] < ln["onehot_u32_bound_ms"]


# ---------- on a card ------------------------------------------------------------


@pytest.fixture(scope="module")
def card_items():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return chip_smoke.corrupt_every(
        chip_smoke.adversarial_items(O, random.Random(0x7EEF), lanes=512), 8)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 31, 33, 4097])
@pytest.mark.parametrize("variant", ["full", "schnorr_free"])
@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_u32_modes_tree_kernel_on_card_matches_plain_and_radix11(card_items, sqr, variant,
                                                                 lanes):
    """The routed tree tuple launches its library alone; its verdicts equal
    the plain version's, the oracle's and the radix-11 entry's by name (the
    512 items wrapped around to the lane count)."""
    pool = card_items if variant == "full" else [it for it in card_items if len(it) == 4]
    batch = chip_smoke.tile(pool, lanes)
    prep = K.prepare_batch_raw(pack_items(batch), pad_to=lanes, window_bits=4)
    args = K.from_reference(prep.device_args, "cuda")
    _, form, reduce, select, _, mul = MODES[sqr]
    modes = dict(schnorr_free=variant == "schnorr_free", point_form=form, reduce=reduce,
                 select=select, ladder="scan", sqr=sqr, mul=mul)
    counts = dict(cuda_kernel.LIBRARY_LAUNCHES)
    got = cuda_kernel.verify_blocked(*args, **modes)
    counts[(LIBRARY[sqr], variant)] += 1
    assert cuda_kernel.LIBRARY_LAUNCHES == counts
    radix11 = cuda_kernel.verify_with(cuda_kernel.VERIFY_LIBRARIES[(mul, sqr)], *args, **modes)
    with torch.inference_mode():
        plain = K.verify_core(*args, **modes)
    assert got.tolist() == radix11.tolist() == plain.tolist() == O.verify_batch_cpu(batch)


@pytest.mark.gpu
@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_engine_on_card_at_the_tree_tuple_runs_on_verify_u32_modes_tree(card_items, sqr):
    """An engine built under TPUNODE_SELECT16=tree at (4, affine, eager)
    launches only the tree library of its square: none in verify_half /
    verify_mul or the one-hot twin."""
    with chip_smoke.select_knob("tree"), chip_smoke.sqr_knob(sqr):
        engine = VerifyEngine(VerifyConfig(batch_size=64, device_batch=128, point_form="affine",
                                           field_reduce="eager"))
    assert engine.wait_warmup(600) == "ready"  # its launches are not the test's
    items = card_items[:200]
    counts = dict(cuda_kernel.LIBRARY_LAUNCHES)
    assert engine.verify_sync(items) == O.verify_batch_cpu(items)
    counts[(LIBRARY[sqr], "full")] += 2  # 128 + a 72-item tail padded to 128
    assert cuda_kernel.LIBRARY_LAUNCHES == counts
