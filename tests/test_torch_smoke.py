"""``chip_smoke.py``'s own logic on the CPU: its traffic, its count-based
bound, its trace reading, and its refusal to run without a card.

The card's numbers come only from a run on the card; these tests pin what
the script computes around them.  Counts are integers: tolerance zero.
"""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from tpunode_torch import cuda_diag
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def test_btc_traffic_is_one_chain_and_corrupts_exactly_its_share():
    items = chip_smoke.btc_pool(O, random.Random(0xB7C), 2, bip340=True)
    assert len(items) == 8
    assert sorted({it[4] if len(it) == 5 else "ecdsa" for it in items}) == ["bip340", "ecdsa"]
    assert O.verify_batch_cpu(items) == [True] * 8
    ecdsa = chip_smoke.btc_pool(O, random.Random(0xB7C), 2, bip340=False)
    assert len(ecdsa) == 6 and all(len(it) == 4 for it in ecdsa)
    bad = chip_smoke.corrupt_every(items, 4)
    assert O.verify_batch_cpu(bad) == [True, True, True, False] * 2


def test_op_count_follows_the_kernel_structure():
    ops = chip_smoke.kernel_ops_per_lane()
    conv, sqr_conv = 24 * 24, 24 * 25 // 2
    assert ops["mul"]["mul"] == conv and ops["sqr"]["mul"] == sqr_conv
    assert ops["pt_add"]["mul"] == 12 * conv  # RCB Alg. 7: 12 products
    assert ops["pt_double"]["mul"] == 6 * conv + 2 * sqr_conv  # Alg. 9: 6M + 2S
    tables = 14 * ops["pt_add"]["mul"] + 16 * conv
    windows = 33 * 4 * (ops["pt_add"]["mul"] + ops["pt_double"]["mul"])
    tail = 3 * conv + 2 * sqr_conv
    assert ops["schnorr_free"]["mul"] == tables + windows + tail
    pows = 2 * (14 * conv + 64 * (4 * sqr_conv + conv))
    assert ops["full"]["mul"] - ops["schnorr_free"]["mul"] == 2 * conv + pows
    assert all(n > 0 for v in ops.values() for n in v.values())


def test_op_count_at_5_bit_follows_the_kernel_structure():
    """30 table adds, 32 λ multiplies and 27 rounds of 5 doublings and 4
    adds; the pow ladders are 4-bit at both widths, and the 4-bit count
    does not move."""
    w4, w5 = chip_smoke.kernel_ops_per_lane(4), chip_smoke.kernel_ops_per_lane(5)
    assert w4 == chip_smoke.kernel_ops_per_lane()
    assert (w4["schnorr_free"]["mul"], w4["full"]["mul"]) == (1_556_088, 1_800_696)
    conv, sqr_conv = 24 * 24, 24 * 25 // 2
    add, dbl = w5["pt_add"]["mul"], w5["pt_double"]["mul"]
    assert (add, dbl) == (w4["pt_add"]["mul"], w4["pt_double"]["mul"])
    tables = 30 * add + 32 * conv
    windows = 27 * (5 * dbl + 4 * add)
    tail = 3 * conv + 2 * sqr_conv
    assert w5["schnorr_free"]["mul"] == tables + windows + tail
    for kind in ("mul", "alu", "flex"):
        assert (w5["full"][kind] - w5["schnorr_free"][kind]
                == w4["full"][kind] - w4["schnorr_free"][kind])
        masks = 4 if kind == "alu" else 0  # one digit mask a table a window
        assert w5["schnorr_free"][kind] - w4["schnorr_free"][kind] == (
            (30 - 14) * w4["pt_add"][kind] + (32 - 16) * w4["mul"][kind]
            + (27 * 5 - 33 * 4) * w4["pt_double"][kind]
            + (27 - 33) * (4 * w4["pt_add"][kind] + masks))


def test_bound_at_5_bit_reads_its_digit_rows_and_tables():
    sm, clock = 132, 1980.0
    base = chip_smoke.kernel_ops(8, 0, schnorr_free=False, window_bits=5)
    assert chip_smoke.kernel_ops(8, 3, False, 5) - base == {"flex": 3 * 27 * 24}
    in4 = 10**6 * (4 * 33 * 4 + 4 * 24 * 4 + 8) + 2 * 16 * 3 * 24 * 4
    in5 = 10**6 * (4 * 27 * 4 + 4 * 24 * 4 + 8) + 2 * 32 * 3 * 24 * 4
    empty = chip_smoke.Counter()
    for wb, in_bytes in ((4, in4), (5, in5)):
        ms, by = chip_smoke.bound_ms(empty, 10**6, sm, clock, wb)
        assert by == "bytes"
        assert ms == pytest.approx((in_bytes + 10**6) / chip_smoke.HBM_BYTES_PER_S * 1e3)
    ms4 = chip_smoke.bound_ms(chip_smoke.kernel_ops(32768, 0, True, 4), 32768, sm, clock, 4)[0]
    ms5 = chip_smoke.bound_ms(chip_smoke.kernel_ops(32768, 0, True, 5), 32768, sm, clock, 5)[0]
    assert ms5 < ms4  # 2% fewer limb products a lane


def test_ptxas_entries_reads_each_instantiation():
    def entry(name, regs, stack, smem):
        return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {name}\n"
                f"    {stack} bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
                f"ptxas info    : Used {regs} registers, used 1 barriers, {stack} bytes "
                f"cumulative stack size, {smem} bytes smem\n"
                f"ptxas info    : Compile time = 727.609 ms\n"
                "ptxas info    : Function properties for _ZN3tpn6pt_addEPNS_2PtEPKS0_S3_\n"
                "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n")

    def verify(sf, wb, af, eager, onehot, sq, regs, stack, smem):
        name = (f"_ZN3tpn13verify_kernelILb{sf}ELi{wb}ELb{af}ELb{eager}ELb{onehot}ELb{sq}"
                f"EEEvNS_10VerifyArgsEPKi")
        return entry(name, regs, stack, smem)

    log = "".join(verify(sf, wb, af, eager, oh, sq,
                         200 + 10 * sf + wb + af + 2 * eager + 20 * oh + 4 * sq,
                         10000 + 1000 * wb + 100 * af + 10 * eager + sf + 300 * oh + 5000 * sq,
                         (1 << wb) * (3 - af) * 192)
                  for wb in (5, 4) for af in (0, 1) for eager in (0, 1) for sf in (0, 1)
                  for oh in (0, 1) for sq in (0, 1))
    log += (entry("_ZN3tpn14trivial_kernelEPKiPii", 8, 0, 0)
            + entry("_ZN3tpn16field_mul_kernelEPKiS1_Pii", 96, 1200, 0)
            + entry("_ZN3tpn18lazy_reduce_kernelEPKiS1_S1_S1_Pii", 112, 1400, 0)
            + entry("_ZN3tpn16mixed_add_kernelEPKiS1_S1_S1_Pii", 168, 2208, 0)
            + entry("_ZN3tpn16batch_inv_kernelEPKiPii", 64, 5184, 0)
            + entry("_ZN3tpn18table_build_kernelEPKiPii", 60, 1632, 0)
            + entry("_ZN3tpn17pow_descan_kernelEPKiPii", 40, 96, 0)
            + entry("_ZN3tpn18select_tree_kernelEPKiS1_Pii", 72, 3072, 0)
            + entry("_ZN3tpn17pow_window_kernelEPKiS1_Pii", 80, 1728, 0)
            + entry("_ZN3tpn22pow_window_smem_kernelEPKiS1_Pii", 81, 1728, 512)
            + entry("_ZN3tpn14window5_kernelEPKiS1_S1_Pii", 90, 4800, 3072))
    got = chip_smoke.ptxas_entries(log)
    assert sorted(got) == sorted(
        [f"{v}/w{wb}/{form}/{reduce}/{select}/{sqr}" for v in ("full", "schnorr_free")
         for wb in (4, 5) for form in ("projective", "affine") for reduce in ("lazy", "eager")
         for select in ("tree", "onehot") for sqr in ("half", "mul")]
        + ["batch_inv", "field_mul", "lazy_reduce", "mixed_add", "pow_descan", "pow_window",
           "pow_window_smem", "select_tree", "table_build", "trivial", "window5"])
    assert got["full/w5/projective/lazy/tree/half"] == {"registers": 205, "smem": 18432,
                                                        "stack_frame": 15000,
                                                        "spill_stores": 0, "spill_loads": 0}
    assert got["full/w5/projective/lazy/tree/mul"] == {"registers": 209, "smem": 18432,
                                                       "stack_frame": 20000, "spill_stores": 0,
                                                       "spill_loads": 0}
    assert got["full/w5/projective/lazy/onehot/half"]["stack_frame"] == 15300
    assert got["schnorr_free/w4/projective/eager/tree/half"]["stack_frame"] == 14011
    assert got["full/w4/affine/eager/onehot/half"] == {"registers": 227, "smem": 6144,
                                                       "stack_frame": 14410, "spill_stores": 0,
                                                       "spill_loads": 0}
    assert got["batch_inv"]["registers"] == 64 and got["mixed_add"]["stack_frame"] == 2208
    assert got["trivial"]["registers"] == 8 and got["lazy_reduce"]["stack_frame"] == 1400
    assert got["pow_window"]["registers"] == 80 and got["pow_window_smem"]["smem"] == 512
    assert got["select_tree"]["stack_frame"] == 3072 and got["window5"]["smem"] == 3072
    assert got["table_build"]["stack_frame"] == 1632 and got["pow_descan"]["registers"] == 40
    assert chip_smoke.ptxas_entries(verify(1, 4, 1, 1, 1, 1, 253, 12096, 6144)).keys() == {
        "schnorr_free/w4/affine/eager/onehot/mul"}


@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
def test_op_count_of_the_affine_form_follows_the_kernel_structure(window_bits):
    """The affine program by hand: the projective Q chain, the batch
    inversion (prefix products, a Fermat ladder, three multiplies a suffix
    entry and a step of the running inverse for all but entry 2), λ
    multiplies of every entry, and each window's doublings, four mixed adds
    and four digit masks and digit-0 compares; the tail is the projective
    program's."""
    aff = chip_smoke.kernel_ops_per_lane(window_bits, "affine")
    proj = chip_smoke.kernel_ops_per_lane(window_bits, "projective")
    nwin, entries = {4: 33, 5: 27}[window_bits], 1 << window_bits
    conv = 24 * 24
    assert aff["pt_add_mixed"]["mul"] == 11 * conv  # RCB Alg. 8: 11 products
    for kind in ("mul", "alu", "flex"):
        inversion = ((entries - 3) * aff["mul"][kind] + aff["pow_const"][kind]
                     + (4 * (entries - 2) - 1) * aff["mul"][kind])
        windows = nwin * (4 * (aff["pt_add_mixed"][kind] - proj["pt_add"][kind])
                          + (4 if kind == "alu" else 0))
        assert aff["schnorr_free"][kind] - proj["schnorr_free"][kind] == inversion + windows
        assert aff["full"][kind] - aff["schnorr_free"][kind] == (
            proj["full"][kind] - proj["schnorr_free"][kind])
    pows = 14 * conv + 64 * (4 * (24 * 25 // 2) + conv)
    assert aff["pow_const"]["mul"] == pows
    products = {4: (1_640_952, 1_885_560), 5: (1_666_944, 1_911_552)}[window_bits]
    assert (aff["schnorr_free"]["mul"], aff["full"]["mul"]) == products


def test_noinline_call_count_follows_the_kernel_structure():
    """Calls a lane: the projective 4-bit program by hand (14 table adds,
    16 λ muls, 33 rounds of 4 doublings and 4 adds, the tail), and what
    the affine form adds and saves."""
    proj = chip_smoke.noinline_calls_per_lane(4)
    assert proj["schnorr_free"] == 14 * 22 + 16 * 3 + 33 * (4 * 16 + 4 * 22) + 19 == 5391
    pow_const = 1 + 14 * 3 + 64 * 15
    assert proj["full"] - proj["schnorr_free"] == 2 * (3 + pow_const) + 2
    for wb, nwin in ((4, 33), (5, 27)):
        aff = chip_smoke.noinline_calls_per_lane(wb, "affine")
        base = chip_smoke.noinline_calls_per_lane(wb)
        inversion = ((1 << wb) - 3) * 3 + pow_const + (4 * ((1 << wb) - 2) - 1) * 3
        assert aff["schnorr_free"] - base["schnorr_free"] == inversion - nwin * 4 * 2
        assert aff["full"] - aff["schnorr_free"] == base["full"] - base["schnorr_free"]


@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
def test_op_count_of_the_eager_bodies_follows_the_kernel_structure(window_bits, point_form):
    """The eager bodies by hand: every product a mul, mul_t or sqr_t of its
    own (12, 11 and 8 of them), the sums between them; the rest of the
    program (tables' λ and inversion multiplies, the tail, the pows) is
    the lazy program's, so the two differ only by the formulas they run."""
    eager = chip_smoke.kernel_ops_per_lane(window_bits, point_form, "eager")
    lazy = chip_smoke.kernel_ops_per_lane(window_bits, point_form, "lazy")
    assert lazy == chip_smoke.kernel_ops_per_lane(window_bits, point_form)
    conv, sqr_conv, nl = 24 * 24, 24 * 25 // 2, 24
    mul, mul_t, sqr_t = eager["mul"], eager["mul_t"], eager["sqr_t"]
    assert (mul_t["mul"], sqr_t["mul"]) == (conv, sqr_conv)
    assert mul - mul_t == chip_smoke._ops(alu=2 * 2 * 23)  # mul's two input carry rounds
    assert eager["pt_add"]["mul"] == 12 * conv and eager["pt_add_mixed"]["mul"] == 11 * conv
    assert eager["pt_double"]["mul"] == 6 * conv + 2 * sqr_conv
    msr = chip_smoke._ops(flex=nl) + chip_smoke._ops(alu=2 * 24, flex=3)  # scale, fold_top
    tail = chip_smoke._rep(2, msr) + chip_smoke._rep(6, mul) + chip_smoke._ops(flex=6 * nl)
    assert eager["pt_add"] == (chip_smoke._rep(3, mul_t) + chip_smoke._rep(3, mul)
                               + chip_smoke._ops(flex=9 * nl) + tail)
    assert eager["pt_add_mixed"] == (chip_smoke._rep(4, mul_t) + mul
                                     + chip_smoke._ops(flex=5 * nl) + tail)
    assert eager["pt_double"] == (chip_smoke._rep(2, sqr_t) + chip_smoke._rep(2, mul_t)
                                  + chip_smoke._rep(4, mul) + msr + chip_smoke._ops(flex=6 * nl))
    nwin, entries = {4: 33, 5: 27}[window_bits], 1 << window_bits
    add = "pt_add_mixed" if point_form == "affine" else "pt_add"
    for kind in ("mul", "alu", "flex"):
        formulas = ((entries - 2) * (eager["pt_add"][kind] - lazy["pt_add"][kind])
                    + nwin * (window_bits * (eager["pt_double"][kind] - lazy["pt_double"][kind])
                              + 4 * (eager[add][kind] - lazy[add][kind])))
        for variant in ("schnorr_free", "full"):
            assert eager[variant][kind] - lazy[variant][kind] == formulas
    assert eager["schnorr_free"]["mul"] == lazy["schnorr_free"]["mul"]  # the same products
    assert all(eager[v]["alu"] > lazy[v]["alu"] for v in ("schnorr_free", "full"))


def test_noinline_call_count_of_the_eager_bodies():
    """Three calls a product (the mul, mul_t or sqr_t, its convolution and
    its reduction) and one for the body itself: 37, 34 and 25 a formula."""
    for wb, nwin in ((4, 33), (5, 27)):
        for form, add_calls in (("projective", (37, 22)), ("affine", (34, 20))):
            eager = chip_smoke.noinline_calls_per_lane(wb, form, "eager")
            lazy = chip_smoke.noinline_calls_per_lane(wb, form, "lazy")
            assert lazy == chip_smoke.noinline_calls_per_lane(wb, form)
            per_round = wb * (25 - 16) + 4 * (add_calls[0] - add_calls[1])
            table = ((1 << wb) - 2) * (37 - 22)
            for variant in ("schnorr_free", "full"):
                assert eager[variant] - lazy[variant] == table + nwin * per_round
    assert chip_smoke.noinline_calls_per_lane(4, "projective", "eager")["schnorr_free"] == (
        14 * 37 + 16 * 3 + 33 * (4 * 25 + 4 * 37) + 19)


def test_bound_of_the_eager_form_reads_the_eager_count():
    sm, clock = 132, 1980.0
    lazy = chip_smoke.kernel_ops(32768, 100, True, 4, "projective", "lazy")
    eager = chip_smoke.kernel_ops(32768, 100, True, 4, "projective", "eager")
    assert eager - chip_smoke.kernel_ops(32768, 0, True, 4, "projective", "eager") == {
        "flex": 100 * 33 * 24}
    assert eager["mul"] == lazy["mul"] and eager["alu"] > lazy["alu"]
    ms_lazy, by = chip_smoke.bound_ms(lazy, 32768, sm, clock)
    ms_eager, by_eager = chip_smoke.bound_ms(eager, 32768, sm, clock)
    assert by == by_eager == "operations" and ms_eager >= ms_lazy


def test_instantiations_put_each_eager_kind_beside_its_lazy_one():
    """The eager group right after the lazy group of its width and form,
    the one-hot pair right after its tree pair, each full-product
    instantiation right after its half-product twin: 32 (width, form,
    reduction, select, square) kinds."""
    kinds = chip_smoke.instantiations((4, 5), ("projective", "affine"))
    assert len(kinds) == len(set(kinds)) == 32
    assert kinds[:4] == [(4, "projective", "lazy", "tree", "half"),
                         (4, "projective", "lazy", "tree", "mul"),
                         (4, "projective", "lazy", "onehot", "half"),
                         (4, "projective", "lazy", "onehot", "mul")]
    assert all(kinds[i][:2] == kinds[i + 4][:2] and kinds[i][2] == "lazy"
               and kinds[i + 4][2] == "eager" for i in range(0, 32, 8))
    assert all(kinds[i][:3] == kinds[i + 2][:3] and kinds[i][3] == "tree"
               and kinds[i + 2][3] == "onehot" for i in range(0, 32, 4))
    assert all(kinds[i][:4] == kinds[i + 1][:4] and kinds[i][4] == "half"
               and kinds[i + 1][4] == "mul" for i in range(0, 32, 2))


def test_kernel_timing_compares_every_instantiation_at_both_lane_counts(monkeypatch):
    """Phase 6 against a stub kernel: every (variant, lanes, width, form,
    reduce, select, square) key of the shift-add multiply — 64
    instantiations at two lane counts — is timed in turns and compared,
    through one plain call per (variant, width, form, reduce) at the larger
    lane count, in the tree select and the half product, whose first lanes
    stand for the smaller count; a launch that disagrees with its share of
    that output fails the phase, at either select, either square and either
    lane count."""
    kinds = [(*kind, "shift_add", None)
             for kind in chip_smoke.instantiations((4, 5), ("projective", "affine"))]
    lane_counts = (64, 8)
    made, launched, planned, timed = [], [], [], []

    def make_args(items, lanes, wb, variant):
        made.append((variant, lanes, wb))
        return (lanes, wb), variant == "schnorr_free"

    def verdicts(args):  # lane i's verdict depends on lane i alone
        return torch.arange(args[0]) % 3 == 0

    def launch(args, sf, form, reduce, select, sqr, mul, library):
        launched.append((args, sf, form, reduce, select, sqr, mul))
        return verdicts(args)

    def plain(args, sf, form, reduce, select, sqr):
        planned.append((args[1], form, reduce, select, sqr, sf, args[0]))
        return verdicts(args)

    def timer(fn, repeats):
        timed.append(repeats)
        fn()
        return 1.0

    extra = []
    cases = [("full", list(range(64))), ("schnorr_free", list(range(64)))]
    rows = chip_smoke.kernel_timing(cases, kinds, make_args, launch, plain, timer,
                                    on_row=lambda row, args, sf: extra.append(row),
                                    lane_counts=lane_counts)
    keys = {(*kind, v, lanes) for kind in kinds for v in ("full", "schnorr_free")
            for lanes in lane_counts}
    assert set(rows) == keys and len(keys) == 128 and len(extra) == 128
    assert len(planned) == len(set(planned)) == 16  # one a (variant, width, form, reduce)
    assert {(wb, form, reduce, select, sqr, lanes)
            for wb, form, reduce, select, sqr, _, lanes in planned
            } == {(*kind[:3], "tree", "half", 64) for kind in kinds}
    assert all(row["max_abs_err"] == 0 and row["plain_ms"] == 1.0 for row in rows.values())
    assert all(len(row["ms_runs"]) == 2 and "twin_ms" not in row for row in rows.values())
    assert timed.count(1) == 16 and timed.count(chip_smoke.TIMED_LAUNCHES) == 256
    assert len(made) == 8
    shared = {key for key, row in rows.items() if row["plain_shared"]}
    assert shared == {key for key in keys
                      if key[3] == "onehot" or key[4] == "mul" or key[8] == 8}
    assert rows[(5, "affine", "eager", "onehot", "mul", "shift_add", None, "full", 8)][
        "plain_of"] == (
        "full/w5/affine/eager/tree/half at 64 lanes")

    def wrong_launch(key):
        def launch_wrong(args, sf, form, reduce, select, sqr, mul, library):
            out = verdicts(args)
            if (args[1], form, reduce, select, sqr, sf, args[0]) == key:
                out[-1] = ~out[-1]
            return out
        return launch_wrong

    for key, name in (((5, "affine", "eager", "onehot", "mul", True, 8),
                       "schnorr_free/w5/affine/eager/onehot/mul.*8 lanes"),
                      ((4, "projective", "lazy", "tree", "mul", False, 64),
                       "full/w4/projective/lazy/tree/mul.*64 lanes"),
                      ((4, "projective", "lazy", "tree", "half", False, 64),
                       "full/w4/projective/lazy/tree/half.*64 lanes")):
        with pytest.raises(RuntimeError, match=name):
            chip_smoke.kernel_timing(cases, kinds, make_args, wrong_launch(key), plain, timer,
                                     lane_counts=lane_counts)
    with pytest.raises(ValueError, match="largest"):
        chip_smoke.kernel_timing(cases, kinds, make_args, launch, plain, timer,
                                 lane_counts=(8, 64))


@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
def test_op_count_of_the_onehot_select_follows_the_kernel_structure(window_bits, point_form):
    """The one-hot select adds, to each of the four selects a window, a
    mask compare an entry and a LOP3 a word of every entry, on the ALU
    pipe; nothing else moves, and it reads every entry where the tree form
    reads one."""
    for reduce in ("lazy", "eager"):
        tree = chip_smoke.kernel_ops_per_lane(window_bits, point_form, reduce, "tree")
        onehot = chip_smoke.kernel_ops_per_lane(window_bits, point_form, reduce, "onehot")
        assert tree == chip_smoke.kernel_ops_per_lane(window_bits, point_form, reduce)
        nwin, entries = {4: 33, 5: 27}[window_bits], 1 << window_bits
        coords = 2 if point_form == "affine" else 3
        for variant in ("schnorr_free", "full"):
            assert onehot[variant] - tree[variant] == {
                "alu": nwin * 4 * entries * (1 + coords * 24)}
        ops_tree = chip_smoke.kernel_ops(32768, 100, False, window_bits, point_form, reduce)
        ops_onehot = chip_smoke.kernel_ops(32768, 100, False, window_bits, point_form, reduce,
                                           "onehot")
        assert ops_onehot["alu"] > ops_tree["alu"] and ops_onehot["mul"] == ops_tree["mul"]
        assert (chip_smoke.bound_ms(ops_onehot, 32768, 132, 1980.0, window_bits, point_form)[0]
                >= chip_smoke.bound_ms(ops_tree, 32768, 132, 1980.0, window_bits,
                                       point_form)[0])
    read = chip_smoke.select_bytes(10, window_bits, point_form, "onehot")
    assert read == {"local": 2 * 10 * nwin * entries * coords * 96,
                    "shared": 2 * 10 * nwin * entries * coords * 96}
    assert chip_smoke.select_bytes(10, window_bits, point_form) == {
        k: v // entries for k, v in read.items()}


def test_select_knob_context_restores_the_environment(monkeypatch):
    monkeypatch.delenv("TPUNODE_SELECT16", raising=False)
    with chip_smoke.select_knob("onehot"):
        assert os.environ["TPUNODE_SELECT16"] == "onehot" and K.select_mode() == "onehot"
    assert "TPUNODE_SELECT16" not in os.environ and K.select_mode() == "tree"
    monkeypatch.setenv("TPUNODE_SELECT16", "tree")
    with pytest.raises(RuntimeError):
        with chip_smoke.select_knob("onehot"):
            raise RuntimeError("a phase failed")
    assert os.environ["TPUNODE_SELECT16"] == "tree"


def test_unroll_keys_engines_and_campaigns():
    """Phase 3's 8 plain calls under the unrolled ladders, one for each
    (width, form, reduction), at the tree select and the half product;
    phase 5's 65 engines, the unroll engine at the default modes right
    after its scan twin, each full-product engine right after its
    half-product twin and the 32 dot_general ones last; phase 7's 65
    campaigns, the unroll one after the shift-add ones, then the
    dot_general ones; their keys in the order of cuda_kernel.LAUNCHES's."""
    from tpunode_torch.verify import cuda_kernel

    kinds = chip_smoke.instantiations((4, 5), ("projective", "affine"))
    keys = chip_smoke.unroll_plain_keys(kinds)
    assert keys == [(wb, form, reduce) for form in ("projective", "affine") for wb in (4, 5)
                    for reduce in ("lazy", "eager")]
    assert chip_smoke.UNROLL_KIND == (4, "projective", "lazy", "tree", "unroll", "half",
                                      "shift_add")
    engines = chip_smoke.engine_kinds(kinds)
    assert len(engines) == len(set(engines)) == 65
    assert engines[:3] == [(4, "projective", "lazy", "tree", "scan", "half", "shift_add"),
                           chip_smoke.UNROLL_KIND,
                           (4, "projective", "lazy", "tree", "scan", "mul", "shift_add")]
    for mul in ("shift_add", "dot_general"):
        assert [(*e[:4], e[5]) for e in engines if e[4] == "scan" and e[6] == mul] == kinds
    assert [e[6] for e in engines] == ["shift_add"] * 33 + ["dot_general"] * 32
    assert sum(e[5] == "mul" for e in engines) == 32
    campaigns = chip_smoke.campaign_kinds(kinds)
    assert campaigns == [chip_smoke.with_ladder(kind, "scan") for kind in kinds] + [
        chip_smoke.UNROLL_KIND] + [chip_smoke.with_ladder(kind, "scan", "dot_general")
                                   for kind in kinds]
    assert {(*key, "full") for key in engines} <= set(cuda_kernel.LAUNCHES)


def test_ladder_knob_context_restores_the_environment(monkeypatch):
    monkeypatch.delenv("TPUNODE_POW_LADDER", raising=False)
    with chip_smoke.ladder_knob("unroll"), chip_smoke.select_knob("onehot"):
        assert (K.pow_ladder_mode(), K.select_mode()) == ("unroll", "onehot")
    assert "TPUNODE_POW_LADDER" not in os.environ and K.pow_ladder_mode() == "scan"
    monkeypatch.setenv("TPUNODE_POW_LADDER", "scan")
    with pytest.raises(RuntimeError):
        with chip_smoke.ladder_knob("unroll"):
            raise RuntimeError("a phase failed")
    assert os.environ["TPUNODE_POW_LADDER"] == "scan"


def test_op_count_of_the_ladder_probes():
    """table_build: 14 multiplies and the canonical form; pow_descan: the
    static ladder's 259 squarings and 70 multiplies (no digit of (p-1)/2 is
    0, so every window after the first multiplies) and the canonical form,
    with no select; both move two limb rows a lane."""
    ops = chip_smoke.kernel_ops_per_lane()
    assert chip_smoke.probe_ops_per_lane("table_build") == (
        chip_smoke._rep(14, ops["mul"]) + ops["canonical"])
    assert chip_smoke.probe_ops_per_lane("pow_descan") == (
        chip_smoke._rep(259, ops["sqr"]) + chip_smoke._rep(70, ops["mul"]) + ops["canonical"])
    window = chip_smoke.probe_ops_per_lane("pow_window")
    descan = chip_smoke.probe_ops_per_lane("pow_descan")
    # the one-hot pow: 14 table multiplies, 64 windows of 4 squarings, a select
    # and a multiply; the static one: 7 and 7, then 63 windows without a select
    assert window + chip_smoke._rep(3, ops["sqr"]) == (
        descan + chip_smoke._rep(8, ops["mul"]) + chip_smoke._ops(alu=64 * 16 * 25))
    for probe in ("table_build", "pow_descan"):
        assert chip_smoke.probe_bytes(probe, 256) == 256 * 2 * 96
        assert chip_smoke.PROBE_PALLAS_LINES[probe] in (175, 440)
    ms, by = chip_smoke.least_ms(chip_smoke._rep(256, descan), 256 * 2 * 96, 132, 1980.0)
    assert by == "operations" and ms < chip_smoke.least_ms(
        chip_smoke._rep(256, window), 256 * 2 * 96, 132, 1980.0)[0]


def _prep_args(items, lanes, wb=4):
    """Phase 6's ``make_args`` on the CPU: the first ``lanes`` items padded
    to ``lanes``."""
    prep = K.prepare_batch_raw(pack_items(items[:lanes]), pad_to=lanes, window_bits=wb)
    return K.from_reference(prep.device_args, "cpu"), prep.schnorr_free


def test_plain_slice_stands_for_the_plain_version_at_fewer_lanes():
    """Phase 6's sharing: the first 8 lanes of the plain output over 16
    lanes (chip_smoke.plain_lanes, at a small stand-in for 32,768 and
    4,096) equal the plain version run over those 8 lanes alone, and a
    one-hot launch is held against the tree's output."""
    adv = chip_smoke.adversarial_items(O, random.Random(0x5A1), lanes=16)
    items = adv[8:] + adv[:8]  # Schnorr and BIP340 lanes among the first 8: the full variant
    big, sf = _prep_args(items, 16)
    small, sf_small = _prep_args(items, 8)
    assert sf == sf_small is False
    out16 = K.verify_core(*big, schnorr_free=sf, select="tree", ladder="scan", sqr="half",
                          mul="shift_add")
    out8 = K.verify_core(*small, schnorr_free=sf, select="onehot", ladder="scan", sqr="half",
                         mul="shift_add")
    assert torch.equal(chip_smoke.plain_lanes(out16, 8), out8)
    assert out16.tolist() == O.verify_batch_cpu(items) and any(out8) and not all(out8)


@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("reduce", ["lazy", "eager"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
@pytest.mark.parametrize("ecdsa_only", [False, True], ids=["full", "schnorr_free"])
def test_onehot_plain_program_equals_the_tree_one(monkeypatch, ecdsa_only, window_bits, reduce,
                                                  point_form):
    """verify_core(select="onehot", ladder="scan", sqr="half") bit for bit the tree's program: every
    entry the one-hot select returns, in every window of every table, is
    held limb for limb against select_tree16 on the same entries and
    digits, so every later value, and the verdicts, are the tree program's;
    the verdicts equal the oracle's."""
    selects = []
    onehot = K._SELECTS["onehot"]

    def checked(entries, digits):
        got = onehot(entries, digits)
        assert torch.equal(got, K.select_tree16(entries, digits))
        selects.append(len(entries))
        return got

    monkeypatch.setitem(K._SELECTS, "onehot", checked)
    items = chip_smoke.adversarial_items(O, random.Random(0x5A2), lanes=16)
    if ecdsa_only:
        items = [it for it in items if len(it) == 4]
    args, sf = _prep_args(items, len(items), window_bits)
    assert sf == ecdsa_only
    got = K.verify_core(*args, schnorr_free=sf, point_form=point_form, reduce=reduce,
                        select="onehot", ladder="scan", sqr="half", mul="shift_add")
    assert got.tolist() == O.verify_batch_cpu(items)
    assert selects == [1 << window_bits] * 4 * {4: 33, 5: 27}[window_bits]


def test_bound_of_the_affine_form_and_of_the_probes():
    sm, clock = 132, 1980.0
    base = chip_smoke.kernel_ops(8, 0, False, 4, "affine")
    assert chip_smoke.kernel_ops(8, 3, False, 4, "affine") - base == {"flex": 3 * 33 * 24}
    assert chip_smoke.verify_bytes(10, 5, "affine") == (
        10 * (4 * 27 * 4 + 4 * 24 * 4 + 8) + 2 * 32 * 2 * 24 * 4 + 10)
    ms, by = chip_smoke.bound_ms(chip_smoke.Counter(), 10**6, sm, clock, 4, "affine")
    assert by == "bytes" and ms == pytest.approx(
        chip_smoke.verify_bytes(10**6, 4, "affine") / chip_smoke.HBM_BYTES_PER_S * 1e3)
    ops = chip_smoke.kernel_ops_per_lane()
    assert chip_smoke.probe_ops_per_lane("mixed_add") == ops["pt_add_mixed"]
    assert chip_smoke.probe_ops_per_lane("batch_inv")["mul"] == (
        28 * ops["mul"]["mul"] + ops["pow_const"]["mul"])
    assert chip_smoke.probe_bytes("mixed_add", 256) == 256 * 7 * 96
    assert chip_smoke.probe_bytes("batch_inv", 256) == 256 * 2 * 96
    assert chip_smoke.probe_ops_per_lane("trivial") == chip_smoke._ops(flex=1)
    assert chip_smoke.probe_ops_per_lane("field_mul") == ops["mul"] + ops["canonical"]
    assert chip_smoke.probe_ops_per_lane("lazy_reduce") == (
        chip_smoke._ops(mul=2 * 576, flex=47) + ops["reduce_wide_loose"] + ops["canonical"])
    assert ops["mul"] == chip_smoke._rep(2, chip_smoke._ops(alu=46)) + chip_smoke._ops(
        mul=576) + ops["reduce_wide_loose"] + chip_smoke._ops(alu=46)
    assert chip_smoke.probe_bytes("trivial", 1024) == 1024 * 8
    assert chip_smoke.probe_bytes("field_mul", 768) == 768 * 3 * 96
    assert chip_smoke.probe_bytes("lazy_reduce", 512) == 512 * 5 * 96
    assert set(chip_smoke.PROBE_PALLAS_LINES) == set(cuda_diag.PROBES)
    assert chip_smoke.probe_bytes("select_tree", 256) == 256 * (2 * 96 + 4)
    assert chip_smoke.probe_bytes("pow_window_smem", 256) == 256 * 2 * 96 + 2 * 64 * 4
    assert chip_smoke.probe_bytes("window5", 256) == 256 * (2 * 96 + 4) + 32 * 96
    ms, by = chip_smoke.least_ms(chip_smoke.Counter(mul=64 * 132 * 1980), 0, sm, clock)
    assert (by, ms) == ("operations", pytest.approx(1e-3))


def test_bound_takes_the_busiest_pipe_and_counts_negations():
    sm, clock = 132, 1980.0
    cycle_ms = 1e3 / (sm * clock * 1e6)
    mul_bound = chip_smoke.Counter(mul=64 * 10**6, alu=0, flex=0)
    assert chip_smoke.bound_ms(mul_bound, 1, sm, clock)[0] == pytest.approx(10**6 * cycle_ms)
    issue_bound = chip_smoke.Counter(mul=64 * 10**6, alu=64 * 10**6, flex=128 * 10**6)
    ms, by = chip_smoke.bound_ms(issue_bound, 1, sm, clock)
    assert ms == pytest.approx(2 * 10**6 * cycle_ms) and by == "operations"
    assert chip_smoke.bound_ms(chip_smoke.Counter(), 10**6, sm, clock)[1] == "bytes"
    base = chip_smoke.kernel_ops(8, 0, schnorr_free=True)
    assert chip_smoke.kernel_ops(8, 3, schnorr_free=True) - base == {"flex": 3 * 33 * 24}


def test_trace_breakdown_unions_device_intervals_inside_the_window(tmp_path):
    def ev(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [
        ev("main_path", "user_annotation", 100.0, 1000.0),
        ev("verify.prepare", "user_annotation", 110.0, 50.0),
        ev("verify.prepare", "user_annotation", 500.0, 30.0),
        ev("verify.kernel", "user_annotation", 170.0, 5.0),
        ev("tpn::verify_kernel<false>", "kernel", 200.0, 300.0),
        ev("Memcpy HtoD", "gpu_memcpy", 150.0, 100.0),  # overlaps the kernel
        ev("tpn::verify_kernel<true>", "kernel", 1050.0, 200.0),  # ends after the window
        ev("Memset", "gpu_memset", 10.0, 20.0),  # before the window
        {"ph": "i", "name": "marker", "ts": 0.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = chip_smoke.trace_breakdown(str(path))
    assert got["window_ms"] == 1.0
    assert got["device_events"] == 4
    assert got["device_busy_ms"] == pytest.approx(0.4)  # 150-500 and 1050-1100
    assert got["device_idle_share"] == pytest.approx(0.6)
    assert got["verify_kernel_launches"] == 2
    assert got["verify_kernel_ms"] == pytest.approx(0.5)
    assert got["span_ms"] == pytest.approx({"verify.prepare": 0.08, "verify.kernel": 0.005})


def test_trace_without_device_events_reads_no_idle_share(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "name": "main_path", "cat": "user_annotation", "ts": 0.0, "dur": 10.0}]}))
    got = chip_smoke.trace_breakdown(str(path))
    assert got["device_idle_share"] is None and got["device_events"] == 0


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("reduce", ["lazy", "eager"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
def test_op_count_of_the_full_product_square_follows_the_kernel_structure(window_bits, reduce,
                                                                         point_form):
    """Under sqr="mul" each square is conv(a, a): 576 products where the
    half product has 300, and none of its 24 adds of d = a + a.  A lane
    squares twice a doubling (wb a window), twice in the on-curve check,
    256 times in a Fermat or Euler ladder (the affine table's, and the two
    acceptance pows of the full variant); nothing else moves, and the
    __noinline__ calls are the same."""
    nwin = {4: 33, 5: 27}[window_bits]
    for select in ("tree", "onehot"):
        half = chip_smoke.kernel_ops_per_lane(window_bits, point_form, reduce, select)
        full = chip_smoke.kernel_ops_per_lane(window_bits, point_form, reduce, select, "mul")
        assert half == chip_smoke.kernel_ops_per_lane(window_bits, point_form, reduce, select,
                                                      "half")
        squares = nwin * window_bits * 2 + 2 + (256 if point_form == "affine" else 0)
        for variant, n in (("schnorr_free", squares), ("full", squares + 2 * 256)):
            assert full[variant] - half[variant] == {"mul": n * (576 - 300)}
            assert half[variant] - full[variant] == {"flex": n * 24}
        assert full["sqr"]["mul"] == full["sqr_t"]["mul"] == full["mul_t"]["mul"] == 576
    for variant in ("schnorr_free", "full"):
        assert (chip_smoke.noinline_calls_per_lane(window_bits, point_form, reduce, "mul")[variant]
                == chip_smoke.noinline_calls_per_lane(window_bits, point_form, reduce)[variant])
    with pytest.raises(ValueError, match="sqr mode"):
        chip_smoke.kernel_ops_per_lane(window_bits, point_form, reduce, "tree", "full")


def test_bound_of_the_full_product_square_reads_its_count():
    """The limb products a lane at 4-bit under the full-product square:
    projective full 2,015,424 and schnorr_free 1,629,504, affine full
    2,170,944; the FMA-pipe bound at 32,768 lanes rises with them."""
    proj = chip_smoke.kernel_ops_per_lane(4, "projective", "lazy", "tree", "mul")
    aff = chip_smoke.kernel_ops_per_lane(4, "affine", "lazy", "tree", "mul")
    assert (proj["full"]["mul"], proj["schnorr_free"]["mul"], aff["full"]["mul"]) == (
        2_015_424, 1_629_504, 2_170_944)
    sm, clock = 132, 1980.0
    half = chip_smoke.kernel_ops(32768, 100, False, 4, "projective", "lazy", "tree")
    full = chip_smoke.kernel_ops(32768, 100, False, 4, "projective", "lazy", "tree", "mul")
    ms_half, by_half = chip_smoke.bound_ms(half, 32768, sm, clock)
    ms_full, by_full = chip_smoke.bound_ms(full, 32768, sm, clock)
    assert by_half == by_full == "operations"
    assert ms_full / ms_half == pytest.approx(2_015_424 / 1_800_696)


def test_kernel_vs_plain_shares_the_half_twin_plain_output():
    """Phase 3 against a stub kernel: 128 instantiations launched (64
    shift-add, 64 dot_general), 28 plain calls: 16 shared ones, one a
    (width, variant, form, reduction) at the tree select, the half product
    and shift-add; at the default key in the full variant one own call
    under the one-hot select, one under sqr="mul" and one under dot_general
    for each square; 8 under the unrolled ladders.  Every launch is held
    against the shared output of its key, so a wrong one fails; an own
    plain output that differs from the shared one fails; the dot_general
    kernel launches once more on a ragged 33 lanes."""
    kinds = chip_smoke.instantiations((4, 5), ("projective", "affine"))
    oracle = [i % 3 == 0 for i in range(40)]
    cases = [("full", list(range(40)), oracle), ("schnorr_free", list(range(40)), oracle)]
    plained, launched, rows, made = [], [], [], []

    def verdicts(args):
        return torch.tensor(oracle[:args[1]])

    def make_args(items, wb, variant):
        made.append(len(items))
        return (wb, len(items)), variant == "schnorr_free"

    def launch(args, sf, form, reduce, select, ladder, sqr, mul, library):
        launched.append((args, sf, form, reduce, select, ladder, sqr, mul))
        return verdicts(args)

    def plain(args, sf, form, reduce, select, ladder, sqr, mul):
        plained.append((args[0], sf, form, reduce, select, ladder, sqr, mul))
        return verdicts(args)

    def timer(fn, repeats):
        fn()
        return 1.0

    max_err, calls = chip_smoke.kernel_vs_plain(cases, kinds, make_args, launch, plain, timer,
                                                rows.append)
    assert calls == len(plained) == 28 and len(max_err) == 128
    shared = [p for p in plained if p[4:] == ("tree", "scan", "half", "shift_add")]
    assert len(shared) == len(set(shared)) == 16
    assert [p for p in plained if p[4:] != ("tree", "scan", "half", "shift_add")
            and p[5] == "scan"] == [
        (4, False, "projective", "lazy", "onehot", "scan", "half", "shift_add"),
        (4, False, "projective", "lazy", "tree", "scan", "mul", "shift_add"),
        (4, False, "projective", "lazy", "tree", "scan", "half", "dot_general"),
        (4, False, "projective", "lazy", "tree", "scan", "mul", "dot_general")]
    assert sum(p[5] == "unroll" for p in plained) == 8
    scan = [x for x in launched if x[5] == "scan"]
    assert len(scan) == 129 and sum(x[7] == "dot_general" for x in scan) == 65
    assert made.count(chip_smoke.DOT_RAGGED_LANES) == 1
    assert [x for x in scan if x[0][1] == chip_smoke.DOT_RAGGED_LANES] == [
        ((4, 33), False, "projective", "lazy", "tree", "scan", "half", "dot_general")]
    assert {r["plain_of"].rsplit("/", 2)[1:] == ["half", "shift_add"] for r in rows
            if r["phase"] == "kernel_vs_plain"} == {True}
    assert {r["phase"] for r in rows} >= {"plain_onehot_vs_kernel", "plain_sqr_mul_vs_kernel",
                                           "plain_dot_vs_kernel", "dot_ragged_warp"}

    def wrong_launch(args, sf, form, reduce, select, ladder, sqr, mul, library):
        out = verdicts(args)
        if (args[0], sf, form, reduce, select, sqr, mul) == (5, True, "affine", "eager", "onehot",
                                                             "mul", "dot_general"):
            out[0] = ~out[0]
        return out

    with pytest.raises(RuntimeError, match="schnorr_free/w5/affine/eager/onehot/mul/dot_general"):
        chip_smoke.kernel_vs_plain(cases, kinds, make_args, wrong_launch, plain, timer,
                                   rows.append)

    for bad in (("tree", "mul", "shift_add"), ("onehot", "half", "shift_add"),
                ("tree", "half", "dot_general")):
        def wrong_plain(args, sf, form, reduce, select, ladder, sqr, mul, bad=bad):
            out = verdicts(args)
            if (select, sqr, mul) == bad:
                out[0] = ~out[0]
            return out

        with pytest.raises(RuntimeError, match="shared plain output"):
            chip_smoke.kernel_vs_plain(cases, kinds, make_args, launch, wrong_plain, timer,
                                       rows.append)

    def ragged_wrong(args, sf, form, reduce, select, ladder, sqr, mul, library):
        out = verdicts(args)
        if args[1] == chip_smoke.DOT_RAGGED_LANES:
            out[-1] = ~out[-1]
        return out

    with pytest.raises(RuntimeError, match="33 lanes"):
        chip_smoke.kernel_vs_plain(cases, kinds, make_args, ragged_wrong, plain, timer,
                                   rows.append)


def test_kernel_vs_plain_reads_the_plain_calls_run_ahead():
    """plain_ahead makes exactly kernel_vs_plain's 28 plain calls, in its
    order and on the same items; kernel_vs_plain given their outputs makes
    no plain call of its own, reports their ms and holds every launch
    against them, so a wrong output made ahead still fails."""
    kinds = chip_smoke.instantiations((4, 5), ("projective", "affine"))
    oracle = [i % 3 == 0 for i in range(40)]
    cases = [("full", list(range(40)), oracle), ("schnorr_free", list(range(40)), oracle)]
    plained, rows = [], []

    def verdicts(args):
        return torch.tensor(oracle[:args[1]])

    def make_args(items, wb, variant):
        return (wb, len(items)), variant == "schnorr_free"

    def launch(args, sf, form, reduce, select, ladder, sqr, mul, library):
        return verdicts(args)

    def plain(args, sf, form, reduce, select, ladder, sqr, mul):
        plained.append((args, sf, form, reduce, select, ladder, sqr, mul))
        return verdicts(args)

    def timer(fn, repeats):
        fn()
        return 2.0

    ahead = chip_smoke.plain_ahead(cases, kinds, make_args, plain, timer)
    assert len(ahead) == len(plained) == 28
    made_ahead = list(plained)
    plained.clear()
    chip_smoke.kernel_vs_plain(cases, kinds, make_args, launch, plain, timer, rows.append)
    assert plained == made_ahead
    plained.clear()
    rows.clear()
    max_err, calls = chip_smoke.kernel_vs_plain(cases, kinds, make_args, launch, plain,
                                                lambda fn, repeats: 1.0, rows.append,
                                                ahead=ahead)
    assert calls == 28 and plained == [] and len(max_err) == 128
    assert {r["plain_ms"] for r in rows if r.get("plain_ms") is not None} == {2.0}
    key = (5, "schnorr_free", "affine", "eager", "tree", "scan", "half", "shift_add")
    out, ms = ahead[key]
    wrong = out.clone()
    wrong[0] = ~wrong[0]
    with pytest.raises(RuntimeError, match="schnorr_free/w5/affine/eager/.* lanes off"):
        chip_smoke.kernel_vs_plain(cases, kinds, make_args, launch, plain, timer, rows.append,
                                   ahead={**ahead, key: (wrong, ms)})


def test_run_campaigns_builds_one_pool_for_33_campaigns(monkeypatch):
    """Phase 7 against a stub campaign: the pool is made once and every one
    of the 65 campaigns (33 shift-add, 32 dot_general) gets that object;
    each runs its select and ladder through the knobs and its square and
    multiply through the config; a mismatch fails, and so does a campaign
    that ran another multiply."""
    monkeypatch.delenv("TPUNODE_SELECT16", raising=False)
    kinds = chip_smoke.instantiations((4, 5), ("projective", "affine"))
    pools, seen, results = [], [], []

    def make_pool():
        pools.append(object())
        return pools[-1]

    def run(n_base, batch, window_bits, point_form, field_reduce, field_sqr, pool, field_mul,
            mismatches=0, ran_mul=None):
        seen.append((pool, n_base, batch))
        return {"window_bits": window_bits, "point_form": point_form,
                "field_reduce": field_reduce, "select": K.select_mode(),
                "ladder": K.pow_ladder_mode(), "field_sqr": field_sqr,
                "field_mul": ran_mul or field_mul,
                "mismatches": mismatches, "launches": 1, "mismatch_detail": []}

    assert chip_smoke.run_campaigns(kinds, make_pool, run, results.append) == 65
    assert len(pools) == 1 and all(p is pools[0] for p, _, _ in seen) and len(seen) == 65
    assert {(n, b) for _, n, b in seen} == {(chip_smoke.CAMPAIGN_BASE, chip_smoke.CAMPAIGN_BATCH)}
    assert sum(r["field_sqr"] == "mul" for r in results) == 32
    assert [r["field_mul"] for r in results] == ["shift_add"] * 33 + ["dot_general"] * 32
    assert results[32]["ladder"] == "unroll" and "TPUNODE_SELECT16" not in os.environ
    with pytest.raises(RuntimeError, match="1 mismatches"):
        chip_smoke.run_campaigns(kinds, make_pool,
                                 lambda *a, **kw: run(*a, **kw, mismatches=1), results.append)
    with pytest.raises(RuntimeError, match="ran"):
        chip_smoke.run_campaigns(kinds, make_pool,
                                 lambda *a, **kw: run(*a, **kw, ran_mul="shift_add"),
                                 results.append)


def test_sqr_knob_context_restores_the_environment(monkeypatch):
    from tpunode_torch.verify import field as F

    monkeypatch.delenv("TPUNODE_FIELD_SQR", raising=False)
    with chip_smoke.sqr_knob("mul"):
        assert F.sqr_mode() == "mul" and K.kernel_modes()[1] == "mul"
    assert "TPUNODE_FIELD_SQR" not in os.environ and F.sqr_mode() == "half"


@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("schnorr_free", [False, True], ids=["full", "schnorr_free"])
def test_full_product_row_shares_its_half_twin_bound(schnorr_free, point_form):
    """Both squares compute one function, so a full-product row's bound is
    its half twin's: the least of the half product's radix-11 work and, at
    4-bit projective (the 8-word kernel's inputs), the 8-word count, which
    is also the half row's own formulation there (the default tuple runs the
    8-word kernel); the full product's own count stands beside it as the
    formulation's bound, and is larger."""
    args = (32768, 100, schnorr_free, 4, point_form, "lazy", "tree")
    sm, clock = 132, 1980.0
    half = chip_smoke.verify_bounds(*args, "half", sm, clock)
    full = chip_smoke.verify_bounds(*args, "mul", sm, clock)
    least = chip_smoke.bound_ms(chip_smoke.kernel_ops(*args, "half"), 32768, sm, clock, 4,
                                point_form)
    own = chip_smoke.bound_ms(chip_smoke.kernel_ops(*args, "mul"), 32768, sm, clock, 4,
                              point_form)[0]
    function = least
    if point_form == "projective":
        u32 = chip_smoke.u32_bound_ms(32768, schnorr_free, sm, clock)
        function = min(least, u32)
        assert half["u32_bound_ms"] == full["u32_bound_ms"] == u32[0] < least[0]
    assert (half["bound_ms"], half["bound_by"]) == (full["bound_ms"], full["bound_by"]) == function
    assert half["radix11_bound_ms"] == full["radix11_bound_ms"] == least[0]
    assert half["formulation_bound_ms"] == half["bound_ms"]
    assert full["formulation_bound_ms"] == own > full["bound_ms"]


def test_ptxas_entries_reads_the_tensor_core_probe_apart_from_field_mul():
    def entry(name, regs, stack, smem):
        return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {name}\n"
                f"    {stack} bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
                f"ptxas info    : Used {regs} registers, used 0 barriers, {smem} bytes smem\n")

    got = chip_smoke.ptxas_entries(entry("_ZN3tpn20field_mul_dot_kernelEPKiS1_Pii", 168, 400,
                                         25344)
                                   + entry("_ZN3tpn16field_mul_kernelEPKiS1_Pii", 96, 1200, 0))
    assert got == {"field_mul_dot": {"registers": 168, "smem": 25344, "stack_frame": 400,
                                     "spill_stores": 0, "spill_loads": 0},
                   "field_mul": {"registers": 96, "smem": 0, "stack_frame": 1200,
                                 "spill_stores": 0, "spill_loads": 0}}


def test_bounds_of_the_tensor_core_probe():
    """The function's bound is the shift-add probe's; the dot formulation's
    adds the byte permutes and the recombination on the int32 pipes, and
    the tensor cores' int8 multiply-adds at the data sheet's rate."""
    sm, clock = 132, 1980.0
    assert chip_smoke.probe_ops_per_lane("field_mul_dot") == chip_smoke.probe_ops_per_lane(
        "field_mul")
    assert chip_smoke.probe_bytes("field_mul_dot", 768) == chip_smoke.probe_bytes("field_mul", 768)
    assert chip_smoke.PROBE_PALLAS_LINES["field_mul_dot"] == 123
    assert chip_smoke.DOT_MACS_PER_LANE == 110_592
    # the data sheet's 1,979 TOPS at 132 SMs and 1,830 MHz
    assert 2 * chip_smoke.TENSOR_INT8_MACS_PER_CLK_PER_SM * 132 * 1830e6 == pytest.approx(
        1979e12, rel=1e-3)
    lanes = 32768
    ops = chip_smoke._rep(lanes, chip_smoke.probe_ops_per_lane("field_mul")
                          + chip_smoke._ops(alu=2 * 576, flex=3 * 47))
    ms, by = chip_smoke.dot_formulation_bound_ms(lanes, sm, clock)
    assert (ms, by) == chip_smoke.least_ms(ops, chip_smoke.probe_bytes("field_mul_dot", lanes),
                                           sm, clock)
    assert ms > chip_smoke.least_ms(
        chip_smoke._rep(lanes, chip_smoke.probe_ops_per_lane("field_mul")),
        chip_smoke.probe_bytes("field_mul", lanes), sm, clock)[0]
    tensor_ms = 1e3 * lanes * 110_592 / (4096 * sm * clock * 1e6)
    assert tensor_ms < ms
    # with a hundredth of the tensor rate the tensor cores bound it
    assert chip_smoke.dot_formulation_bound_ms(lanes, sm, clock / 100) == (
        pytest.approx(100 * ms), "operations")
    rate = chip_smoke.TENSOR_INT8_MACS_PER_CLK_PER_SM
    try:
        chip_smoke.TENSOR_INT8_MACS_PER_CLK_PER_SM = rate // 64
        assert chip_smoke.dot_formulation_bound_ms(lanes, sm, clock) == (
            pytest.approx(64 * tensor_ms), "tensor")
    finally:
        chip_smoke.TENSOR_INT8_MACS_PER_CLK_PER_SM = rate


def test_dot_over_shift_add_times_in_turns_after_a_warm_launch():
    """The tensor-core, the shift-add and the 8-word multiply probes, each
    warmed once, then timed in turns there and back."""
    calls = []

    def timed(fn, repeats):
        assert repeats == chip_smoke.TIMED_LAUNCHES
        fn()
        return {"dot": 4.0, "shift": 2.0, "u32": 1.0}[calls[-1]] + len(calls) / 100

    got = chip_smoke.dot_over_shift_add(lambda: calls.append("dot"),
                                        lambda: calls.append("shift"),
                                        lambda: calls.append("u32"), timed)
    assert calls == ["dot", "shift", "u32", "dot", "shift", "u32", "u32", "shift", "dot"]
    assert got["ms_runs"] == {"field_mul_dot": [4.04, 4.09], "field_mul": [2.05, 2.08],
                              "field_mul_u32": [1.06, 1.07]}
    assert got["ms"] == {"field_mul_dot": pytest.approx(4.065), "field_mul": pytest.approx(2.065),
                         "field_mul_u32": pytest.approx(1.065)}
    assert got["ratio"] == pytest.approx(4.065 / 2.065)
    assert got["u32_ratio"] == pytest.approx(1.065 / 2.065)


def test_dot_timing_times_each_dot_instantiation_in_turns_with_its_twin():
    """Phase 6's dot_general rows against a stub kernel: kernel_timing with
    both multiplies, each dot_general kind right after its shift-add twin,
    times every dot key in one burst right after its twin's first burst (a
    warm launch of every kind before, at each lane count), the shift-add
    ones in two, and holds the dot launch against the shared shift-add
    plain output of its (variant, width, form, reduce); a dot launch that
    disagrees at either lane count fails the phase, and a dot kind that
    does not follow its twin is refused."""
    kinds = [(*kind, mul, None)
             for kind in chip_smoke.instantiations((4, 5), ("projective", "affine"))
             for mul in ("shift_add", "dot_general")]
    lane_counts = (64, 8)

    def make_args(items, lanes, wb, variant):
        return (lanes, wb), variant == "schnorr_free"

    def verdicts(args):
        return torch.arange(args[0]) % 3 == 0

    launched, bursts, planned = [], [], []

    def launch(args, sf, form, reduce, select, sqr, mul, library):
        launched.append((args[1], form, reduce, select, sqr, mul, sf, args[0]))
        return verdicts(args)

    def plain(args, sf, form, reduce, select, sqr):
        planned.append((args[1], form, reduce, select, sqr))
        return verdicts(args)

    def timer(fn, repeats):
        fn()
        if repeats == 1:  # the plain call
            return 1.0
        bursts.append(launched[-1])
        return {"shift_add": 2.0, "dot_general": 20.0}[launched[-1][5]]

    cases = [("full", list(range(64))), ("schnorr_free", list(range(64)))]
    extra = []
    rows = chip_smoke.kernel_timing(cases, kinds, make_args, launch, plain, timer,
                                    on_row=lambda row, args, sf: extra.append(row),
                                    lane_counts=lane_counts)
    dot = {key: row for key, row in rows.items() if key[5] == "dot_general"}
    assert len(rows) == 256 and len(dot) == 128 and len(extra) == 256
    assert len(planned) == 16 and {p[3:] for p in planned} == {("tree", "half")}
    assert all(row["mul"] == "dot_general" and row["mul_dot_over_shift_add"] == 10.0
               and row["twin_ms"] == 2.0 and row["ms_runs"] == [20.0]
               and row["plain_shared"] and row["max_abs_err"] == 0 for row in dot.values())
    assert all(len(row["ms_runs"]) == 2 for key, row in rows.items() if key[5] == "shift_add")
    # each lane count: 64 warm launches, the first pass (each dot burst right
    # after its twin's), then the shift-add kinds back in reverse order
    first = bursts[:64]
    assert [b[5] for b in first] == ["shift_add", "dot_general"] * 32
    assert all(first[i][:5] == first[i + 1][:5] for i in range(0, 64, 2))
    assert [b[:5] for b in bursts[64:96]] == [k[:5] for k in kinds[::-1] if k[5] == "shift_add"]
    assert [x[5] for x in launched[:64]] == [k[5] for k in kinds]  # warm
    assert len(bursts) == 4 * 96
    assert rows[(5, "affine", "eager", "onehot", "mul", "dot_general", None, "full", 8)][
        "plain_of"] == "full/w5/affine/eager/tree/half at 64 lanes"

    def wrong(key):
        def launch_wrong(args, sf, form, reduce, select, sqr, mul, library):
            out = verdicts(args)
            if mul == "dot_general" and (args[1], form, reduce, select, sqr, sf, args[0]) == key:
                out[-1] = ~out[-1]
            return out
        return launch_wrong

    for key in ((5, "affine", "eager", "onehot", "mul", True, 8),
                (4, "projective", "lazy", "tree", "half", False, 64)):
        with pytest.raises(RuntimeError, match="dot_general: kernel and plain"):
            chip_smoke.kernel_timing(cases, kinds, make_args, wrong(key), plain, timer,
                                     lane_counts=lane_counts)
    with pytest.raises(ValueError, match="right after its shift-add twin"):
        chip_smoke.kernel_timing(cases, kinds[1:], make_args, launch, plain, timer,
                                 lane_counts=lane_counts)


def test_ptxas_vs_snapshot_holds_each_shift_add_entry_field_for_field():
    """Phase 2's snapshot comparison: the shift-add entries alone (the
    dot_general and probe entries are not the snapshot's), equal when every
    field is; a differing field names its entry; a snapshot of another nvcc
    release or other flags is not comparable; a snapshot that names other
    entries raises."""
    line = {"registers": 168, "smem": 12288, "stack_frame": 21312, "spill_stores": 0,
            "spill_loads": 0}
    ptxas = {"full/w4/projective/lazy/tree/half": dict(line),
             "full/w4/projective/lazy/tree/mul": dict(line),
             "full/w4/projective/lazy/tree/half/dot_general": {**line, "registers": 255},
             "field_mul": {**line, "registers": 40}}
    snap = {"source": "commit abc", "nvcc": "Build cuda_12", "nvcc_flags": ["-O3"],
            "entries": {"full/w4/projective/lazy/tree/half": dict(line),
                        "full/w4/projective/lazy/tree/mul": dict(line)}}
    held = chip_smoke.ptxas_vs_snapshot(ptxas, snap, "Build cuda_12", ("-O3",))
    assert held == {"snapshot_of": "commit abc", "nvcc": "Build cuda_12",
                    "snapshot_nvcc": "Build cuda_12", "comparable": True, "entries": 2,
                    "equal": 2, "differ": {}}
    ptxas["full/w4/projective/lazy/tree/mul"]["spill_loads"] = 8
    held = chip_smoke.ptxas_vs_snapshot(ptxas, snap, "Build cuda_12", ("-O3",))
    assert held["equal"] == 1 and list(held["differ"]) == ["full/w4/projective/lazy/tree/mul"]
    assert held["differ"]["full/w4/projective/lazy/tree/mul"]["now"]["spill_loads"] == 8
    assert not chip_smoke.ptxas_vs_snapshot(ptxas, snap, "Build cuda_13", ("-O3",))["comparable"]
    assert not chip_smoke.ptxas_vs_snapshot(ptxas, snap, "Build cuda_12", ("-O2",))["comparable"]
    del snap["entries"]["full/w4/projective/lazy/tree/half"]
    with pytest.raises(RuntimeError, match="snapshot names"):
        chip_smoke.ptxas_vs_snapshot(ptxas, snap, "Build cuda_12", ("-O3",))


def test_bounds_of_the_dot_general_kernel():
    """A dot_general row's bound is its shift-add twin's (the half
    product's work); its own formulation's bound adds two byte permutes a
    limb product and three shift-adds a contraction's output limb to the
    int32 work of its square, beside the tensor cores' 110,592 int8
    multiply-adds a contraction, one contraction a convolution; a lane
    makes 3,499 of them in the full 4-bit projective lazy program."""
    sm, clock = 132, 1980.0
    assert chip_smoke.convolutions_per_lane() == {"schnorr_free": 2829, "full": 3499}
    for wb in (4, 5):
        for form in ("projective", "affine"):
            for reduce in ("lazy", "eager"):
                convs = chip_smoke.convolutions_per_lane(wb, form, reduce)
                for variant, n in convs.items():
                    half = chip_smoke.kernel_ops_per_lane(wb, form, reduce)[variant]["mul"]
                    squares = (chip_smoke.kernel_ops_per_lane(wb, form, reduce, "tree", "mul")
                               [variant]["mul"] - half) // (576 - 300)
                    assert 576 * (n - squares) + 300 * squares == half
    args = (32768, 100, False, 4, "projective", "lazy", "tree")
    for sqr in ("half", "mul"):
        dot = chip_smoke.verify_bounds(*args, sqr, sm, clock, "dot_general")
        twin = chip_smoke.verify_bounds(*args, sqr, sm, clock)
        assert (dot["bound_ms"], dot["bound_by"]) == (twin["bound_ms"], twin["bound_by"])
        own, by = chip_smoke.dot_kernel_bound_ms(*args, sqr, sm, clock)
        assert dot["formulation_bound_ms"] == own > twin["formulation_bound_ms"]
        assert by == "tensor" and own == pytest.approx(
            1e3 * 32768 * 3499 * 110_592 / (4096 * sm * clock * 1e6))
    ops = chip_smoke.kernel_ops(*args, "half")
    ops += chip_smoke._ops(alu=2 * ops["mul"], flex=3 * 47 * 3499 * 32768)
    int32_ms = chip_smoke.bound_ms(ops, 32768, sm, clock)[0]
    rate = chip_smoke.TENSOR_INT8_MACS_PER_CLK_PER_SM
    try:  # with 16 times the tensor rate the int32 pipes bound it
        chip_smoke.TENSOR_INT8_MACS_PER_CLK_PER_SM = 16 * rate
        assert chip_smoke.dot_kernel_bound_ms(*args, "half", sm, clock) == (
            pytest.approx(int32_ms), "operations")
    finally:
        chip_smoke.TENSOR_INT8_MACS_PER_CLK_PER_SM = rate


def test_ptxas_entries_keys_the_dot_general_libraries_apart():
    """The dot_general libraries' kernels carry the shift-add ones' names:
    their ptxas lines are read from their own logs and keyed with
    "/dot_general" after the instantiation."""
    def entry(name, regs, smem):
        return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {name}\n"
                f"    12000 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
                f"ptxas info    : Used {regs} registers, used 1 barriers, {smem} bytes smem\n")

    name = "_ZN3tpn13verify_kernelILb0ELi4ELb0ELb0ELb0ELb0EEEvNS_10VerifyArgsEPKi"
    shift = chip_smoke.ptxas_entries(entry(name, 249, 9216))
    dot = chip_smoke.ptxas_entries(entry(name, 255, 34560), "dot_general")
    assert shift == {"full/w4/projective/lazy/tree/half": {
        "registers": 249, "smem": 9216, "stack_frame": 12000, "spill_stores": 8,
        "spill_loads": 8}}
    assert dot == {"full/w4/projective/lazy/tree/half/dot_general": {
        "registers": 255, "smem": 34560, "stack_frame": 12000, "spill_stores": 8,
        "spill_loads": 8}}


def test_mul_knob_context_restores_the_environment(monkeypatch):
    from tpunode_torch.verify import field as F

    monkeypatch.delenv("TPUNODE_FIELD_MUL", raising=False)
    with chip_smoke.mul_knob("dot_general"):
        assert F.mul_mode() == "dot_general" and K.kernel_modes()[0] == "dot_general"
    assert "TPUNODE_FIELD_MUL" not in os.environ and F.mul_mode() == "shift_add"


def test_ptxas_snapshot_reads_the_shift_add_libraries_of_the_tree(tmp_path, monkeypatch):
    """ptxas_snapshot.py builds the tree in a child process there and keeps
    the verify entries of its verify_half and verify_mul logs, keyed as
    phase 2 keys them, beside the nvcc release and the tree's flags; its
    JSON is what ptxas_vs_snapshot reads."""
    import ptxas_snapshot
    from tpunode_torch.verify import cuda_kernel

    def entry(half: int, sq: int) -> str:
        name = f"_ZN3tpn13verify_kernelILb0ELi4ELb0ELb0ELb0ELb{sq}EEEvNS_10VerifyArgsEPKi"
        return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {name}\n"
                f"    {100 + sq} bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
                f"ptxas info    : Used {half} registers, used 1 barriers, 9216 bytes smem\n")

    logs = []
    for lib, sq in (("verify_half", 0), ("verify_mul", 1)):
        logs.append(str(tmp_path / f"lib{lib}.so.log"))
        with open(logs[-1], "w") as f:
            f.write(entry(168 + sq, sq))
    seen = []

    def child(cmd, cwd, check, stdout, text):
        seen.append((cmd[1:], cwd))
        out = json.dumps({"logs": logs, "flags": ["-O3", "-Xptxas", "-v"]})
        return subprocess.CompletedProcess(cmd, 0, stdout=f"building\n{out}\n")

    monkeypatch.setattr(ptxas_snapshot.subprocess, "run", child)
    monkeypatch.setattr(cuda_kernel, "nvcc_version", lambda: "Build cuda_12.test")
    out = tmp_path / "snap.json"
    assert ptxas_snapshot.main([str(tmp_path), str(out), "--source", "commit abc"]) == 0
    snap = json.loads(out.read_text())
    assert seen[0][1] == str(tmp_path) and "C.build()" in seen[0][0][1]
    assert snap == {"source": "commit abc", "nvcc": "Build cuda_12.test",
                    "nvcc_flags": ["-O3", "-Xptxas", "-v"], "entries": {
                        "full/w4/projective/lazy/tree/half": {
                            "stack_frame": 100, "spill_stores": 0, "spill_loads": 0,
                            "registers": 168, "smem": 9216},
                        "full/w4/projective/lazy/tree/mul": {
                            "stack_frame": 101, "spill_stores": 0, "spill_loads": 0,
                            "registers": 169, "smem": 9216}}}
    ptxas = {**snap["entries"], "full/w4/projective/lazy/tree/half/dot_general": {}}
    held = chip_smoke.ptxas_vs_snapshot(ptxas, snap, "Build cuda_12.test",
                                        ("-O3", "-Xptxas", "-v"))
    assert (held["comparable"], held["equal"], held["differ"]) == (True, 2, {})


def test_committed_ptxas_snapshot_names_every_shift_add_instantiation():
    """tpunode_torch/csrc/ptxas_shift_add.json, which phase 2 reads: the
    64 shift-add instantiations under the keys ptxas_entries gives them,
    each with the five fields it reads, built with the flags the build
    uses now (a change of flags needs a new snapshot)."""
    from tpunode_torch.verify import cuda_kernel

    with open(chip_smoke.PTXAS_SNAPSHOT) as f:
        snap = json.load(f)
    kinds = chip_smoke.instantiations((4, 5), ("projective", "affine"))
    assert set(snap["entries"]) == {f"{v}/w{wb}/{form}/{reduce}/{select}/{sqr}"
                                    for v in ("full", "schnorr_free")
                                    for wb, form, reduce, select, sqr in kinds}
    assert all(set(info) == {"registers", "smem", "stack_frame", "spill_stores", "spill_loads"}
               and all(isinstance(n, int) for n in info.values())
               for info in snap["entries"].values())
    assert snap["nvcc_flags"] == list(cuda_kernel.NVCC_FLAGS)
    assert snap["nvcc"] and snap["source"]


def test_trace_breakdown_reads_the_window_it_is_given(tmp_path):
    events = [{"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
              for name, cat, ts, dur in (("main_path", "user_annotation", 0.0, 100.0),
                                         ("block_ingest", "user_annotation", 200.0, 400.0),
                                         ("verify_u32_kernel", "kernel", 300.0, 100.0),
                                         ("verify.pack", "user_annotation", 210.0, 20.0))]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = chip_smoke.trace_breakdown(str(path), "block_ingest")
    assert got["window_ms"] == 0.4 and got["device_busy_ms"] == pytest.approx(0.1)
    assert got["device_idle_share"] == pytest.approx(0.75) and got["verify_kernel_launches"] == 1
    assert chip_smoke.trace_breakdown(str(path))["window_ms"] == 0.1


@pytest.mark.parametrize("chain", ["btc", "bch"])
def test_block_ingest_phase_on_the_cpu_engine(chain):
    """The block_ingest phase's helpers at a small size, on the plain
    program: every comparison reads 0, the BTC block's corrupted
    transactions read invalid, and a changed verdict or a wrong expected
    set shows as a mismatch."""
    from tpunode_torch.verify.cpu_native import load_native_verifier
    from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine
    from tpunode_torch.verify.raw import as_raw_batch

    if chain == "btc":
        txs, bch, expect = chip_smoke.btc_block_txs(40), False, chip_smoke.corrupted_btc_txs
    else:
        txs, bch, expect = chip_smoke.bch_block_txs(16), True, lambda txs, items: []
    data = b"".join(tx.serialize() for tx in txs)
    engine = VerifyEngine(VerifyConfig(device="cpu", batch_size=256, device_batch=256))
    ingest = chip_smoke.ingest_block(engine, data, len(txs), bch)
    assert engine.last_rung == "tpu" and set(ingest["ms"]) == {"parse", "prevout_oracle",
                                                               "extract"}
    items = ingest["items"]
    cpu = load_native_verifier().verify_raw(as_raw_batch(items))
    row = chip_smoke.block_checks(ingest, data, len(txs), bch, cpu, expect)
    assert {k: v for k, v in row.items() if k.endswith("mismatches")} == dict.fromkeys(
        ("native_vs_plain_mismatches", "card_vs_cpu_mismatches", "per_tx_mismatches",
         "invalid_vs_corrupted_mismatches"), 0)
    assert row["txs"] == len(txs) and row["candidate_items"] == items.count > row["txs"]
    assert row["invalid_txs"] == len(expect(txs, items)) == (0 if bch else 4)
    if bch:
        assert 2 in items.present  # BCH Schnorr rows
    flipped = dict(ingest, verdicts=[not v for v in ingest["verdicts"][:1]] + ingest["verdicts"][1:])
    assert chip_smoke.block_checks(flipped, data, len(txs), bch, cpu, expect)[
        "card_vs_cpu_mismatches"] == 1
    # the coinbase is never invalid
    wrong = chip_smoke.block_checks(ingest, data, len(txs), bch, cpu,
                                    lambda txs, items: expect(txs, items) + [0])
    assert wrong["invalid_vs_corrupted_mismatches"] == 1


def _counted_cpu_engine(monkeypatch, kind: tuple):
    """A warmed plain-program engine whose device rung counts a launch per
    dispatched chunk under ``kind`` in ``verify_u32``, as the card's would."""
    from tpunode_torch.verify import cuda_kernel
    from tpunode_torch.verify import engine as E

    run_tpu = E.VerifyEngine._run_tpu

    def counted(self, payloads):
        cuda_kernel.LAUNCHES[(*kind, "full")] += 1
        cuda_kernel.LIBRARY_LAUNCHES[(cuda_kernel.U32_LIBRARY, "full")] += 1
        return run_tpu(self, payloads)

    monkeypatch.setattr(E.VerifyEngine, "_run_tpu", counted)
    engine = E.VerifyEngine(E.VerifyConfig(device="cpu", batch_size=128, device_batch=128))
    assert engine.wait_warmup(120) == "ready"
    return engine


def _phase_counts():
    from tpunode_torch.metrics import metrics
    from tpunode_torch.verify import cuda_kernel

    def reset_launches():
        for counts in (cuda_kernel.LAUNCHES, cuda_kernel.LIBRARY_LAUNCHES):
            for key in counts:
                counts[key] = 0

    def engine_metrics():
        return {name: metrics.get(name) for name in (
            "verify.tpu_items", "verify.cpu_items", "verify.failovers", "verify.dispatch_errors")}

    return reset_launches, engine_metrics


def test_block_ingest_phase_reads_every_check(monkeypatch):
    """The whole block_ingest phase at a small size on the plain program,
    its device rung counting launches as the card's does: both blocks pass,
    the BTC one is traced, and the launches by variant are returned; an
    engine whose rung launches nothing fails the phase."""
    from tpunode_torch.verify import cuda_kernel

    kind = (4, "projective", "lazy", "tree", "scan", "half", "shift_add")
    saved = dict(cuda_kernel.LAUNCHES), dict(cuda_kernel.LIBRARY_LAUNCHES)
    try:
        engine = _counted_cpu_engine(monkeypatch, kind)
        row, launches = chip_smoke.block_ingest_phase(engine, kind, *_phase_counts(),
                                                      btc_txs=20, bch_txs=8)
        assert set(row["blocks"]) == {"btc", "bch"} and launches["full"] >= 2
        for block in row["blocks"].values():
            assert block["rung"] == "tpu" and block["grew"]["verify.tpu_items"] == block[
                "candidate_items"]
            assert block["launches_by_library"] == {"verify_u32/full": 1}
        assert row["traced_btc"]["window_ms"] > 0 and "verify.prepare" in row["traced_btc"][
            "span_ms"]
        monkeypatch.undo()
        from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine

        silent = VerifyEngine(VerifyConfig(device="cpu", batch_size=128, device_batch=128))
        with pytest.raises(RuntimeError, match="block_ingest btc: launched"):
            chip_smoke.block_ingest_phase(silent, kind, *_phase_counts(), btc_txs=20, bch_txs=8)
    finally:
        cuda_kernel.LAUNCHES.update(saved[0])
        cuda_kernel.LIBRARY_LAUNCHES.update(saved[1])


def test_block_ingest_phase_raises_without_the_native_extractor(monkeypatch):
    from tpunode_torch import txextract

    monkeypatch.setattr(txextract, "have_native_extract", lambda: False)
    with pytest.raises(RuntimeError, match="libtxextract.so does not build or load"):
        chip_smoke.block_ingest_phase(None, (), lambda: None, lambda: {})


def test_node_sync_phase_reads_every_check(monkeypatch):
    """The node_sync phase at a small size on the plain program, the node's
    device rung counting launches as the card's does: the chain syncs, every
    verdict is checked and the launches by variant come back; a node whose
    engine launches nothing fails the phase."""
    from tpunode_torch.verify import cuda_kernel
    from tpunode_torch.verify import engine as E

    kind = (4, "projective", "lazy", "tree", "scan", "half", "shift_add")
    saved = dict(cuda_kernel.LAUNCHES), dict(cuda_kernel.LIBRARY_LAUNCHES)
    run_tpu = E.VerifyEngine._run_tpu
    cfg = E.VerifyConfig(device="cpu", batch_size=128, device_batch=128)
    small = dict(n_blocks=3, txs_per_block=8, loose=10)
    try:
        def counted(self, payloads):
            cuda_kernel.LAUNCHES[(*kind, "full")] += 1
            cuda_kernel.LIBRARY_LAUNCHES[(cuda_kernel.U32_LIBRARY, "full")] += 1
            return run_tpu(self, payloads)

        monkeypatch.setattr(E.VerifyEngine, "_run_tpu", counted)
        row, launches = chip_smoke.node_sync_phase(kind, *_phase_counts(), verify=cfg, **small)
        assert row["chain_synced"] == [3] and row["watermark"] == 3
        assert row["verdicts"] == row["chain_txs"] + row["loose_txs"] == 3 * 9 + 10
        assert row["grew"]["verify.tpu_items"] == row["candidates"] > row["verdicts"]
        assert 0 < row["invalid_loose"] <= row["corrupted_loose"] == 2
        assert launches["full"] >= 1 and row["rung"] == "tpu"
        assert {"node.extract", "node.commit", "verify.prepare"} <= set(row["span_ms"])
        assert row["remote_served"]["block"] == 3 and row["remote_served"]["tx"] == 10
        monkeypatch.setattr(E.VerifyEngine, "_run_tpu", run_tpu)
        with pytest.raises(RuntimeError, match="node_sync: .*launched"):
            chip_smoke.node_sync_phase(kind, *_phase_counts(), verify=cfg, **small)
    finally:
        cuda_kernel.LAUNCHES.update(saved[0])
        cuda_kernel.LIBRARY_LAUNCHES.update(saved[1])


def test_node_sync_phase_raises_without_the_native_extractor(monkeypatch):
    from tpunode_torch import txextract

    monkeypatch.setattr(txextract, "have_native_extract", lambda: False)
    with pytest.raises(RuntimeError, match="node_sync: .*libtxextract.so"):
        chip_smoke.node_sync_phase((), lambda: None, lambda: {})
