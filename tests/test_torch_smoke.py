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

    def verify(sf, wb, af, eager, onehot, regs, stack, smem):
        name = (f"_ZN3tpn13verify_kernelILb{sf}ELi{wb}ELb{af}ELb{eager}ELb{onehot}"
                f"EEEvNS_10VerifyArgsEPKi")
        return entry(name, regs, stack, smem)

    log = "".join(verify(sf, wb, af, eager, oh, 200 + 10 * sf + wb + af + 2 * eager + 20 * oh,
                         10000 + 1000 * wb + 100 * af + 10 * eager + sf + 300 * oh,
                         (1 << wb) * (3 - af) * 192)
                  for wb in (5, 4) for af in (0, 1) for eager in (0, 1) for sf in (0, 1)
                  for oh in (0, 1))
    log += (entry("_ZN3tpn14trivial_kernelEPKiPii", 8, 0, 0)
            + entry("_ZN3tpn16field_mul_kernelEPKiS1_Pii", 96, 1200, 0)
            + entry("_ZN3tpn18lazy_reduce_kernelEPKiS1_S1_S1_Pii", 112, 1400, 0)
            + entry("_ZN3tpn16mixed_add_kernelEPKiS1_S1_S1_Pii", 168, 2208, 0)
            + entry("_ZN3tpn16batch_inv_kernelEPKiPii", 64, 5184, 0)
            + entry("_ZN3tpn18select_tree_kernelEPKiS1_Pii", 72, 3072, 0)
            + entry("_ZN3tpn17pow_window_kernelEPKiS1_Pii", 80, 1728, 0)
            + entry("_ZN3tpn22pow_window_smem_kernelEPKiS1_Pii", 81, 1728, 512)
            + entry("_ZN3tpn14window5_kernelEPKiS1_S1_Pii", 90, 4800, 3072))
    got = chip_smoke.ptxas_entries(log)
    assert sorted(got) == sorted(
        [f"{v}/w{wb}/{form}/{reduce}/{select}" for v in ("full", "schnorr_free")
         for wb in (4, 5) for form in ("projective", "affine") for reduce in ("lazy", "eager")
         for select in ("tree", "onehot")]
        + ["batch_inv", "field_mul", "lazy_reduce", "mixed_add", "pow_window",
           "pow_window_smem", "select_tree", "trivial", "window5"])
    assert got["full/w5/projective/lazy/tree"] == {"registers": 205, "smem": 18432,
                                                   "stack_frame": 15000, "spill_stores": 0,
                                                   "spill_loads": 0}
    assert got["full/w5/projective/lazy/onehot"]["stack_frame"] == 15300
    assert got["schnorr_free/w4/projective/eager/tree"]["stack_frame"] == 14011
    assert got["full/w4/affine/eager/onehot"] == {"registers": 227, "smem": 6144,
                                                  "stack_frame": 14410, "spill_stores": 0,
                                                  "spill_loads": 0}
    assert got["batch_inv"]["registers"] == 64 and got["mixed_add"]["stack_frame"] == 2208
    assert got["trivial"]["registers"] == 8 and got["lazy_reduce"]["stack_frame"] == 1400
    assert got["pow_window"]["registers"] == 80 and got["pow_window_smem"]["smem"] == 512
    assert got["select_tree"]["stack_frame"] == 3072 and got["window5"]["smem"] == 3072
    assert chip_smoke.ptxas_entries(verify(1, 4, 1, 1, 1, 253, 12096, 6144)).keys() == {
        "schnorr_free/w4/affine/eager/onehot"}


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
    """The eager pair right after the lazy pair of its width and form, each
    one-hot instantiation right after its tree twin."""
    kinds = chip_smoke.instantiations((4, 5), ("projective", "affine"))
    assert len(kinds) == len(set(kinds)) == 16
    assert kinds[:4] == [(4, "projective", "lazy", "tree"), (4, "projective", "lazy", "onehot"),
                         (4, "projective", "eager", "tree"),
                         (4, "projective", "eager", "onehot")]
    assert all(kinds[i][:2] == kinds[i + 2][:2] and kinds[i][2] == "lazy"
               and kinds[i + 2][2] == "eager" for i in range(0, 16, 4))
    assert all(kinds[i][:3] == kinds[i + 1][:3] and kinds[i][3] == "tree"
               and kinds[i + 1][3] == "onehot" for i in range(0, 16, 2))


def test_kernel_timing_compares_every_instantiation_at_both_lane_counts(monkeypatch):
    """Phase 6 against a stub kernel: every (variant, lanes, width, form,
    reduce, select) key — 32 instantiations at two lane counts — is timed
    in turns and compared, through one plain call per (variant, width,
    form, reduce) at the larger lane count, in the tree select, whose first
    lanes stand for the smaller count; a launch that disagrees with its
    share of that output fails the phase, at either select and lane count."""
    kinds = chip_smoke.instantiations((4, 5), ("projective", "affine"))
    lane_counts = (64, 8)
    made, launched, planned, timed = [], [], [], []

    def make_args(items, lanes, wb, variant):
        made.append((variant, lanes, wb))
        return (lanes, wb), variant == "schnorr_free"

    def verdicts(args):  # lane i's verdict depends on lane i alone
        return torch.arange(args[0]) % 3 == 0

    def launch(args, sf, form, reduce, select):
        launched.append((args, sf, form, reduce, select))
        return verdicts(args)

    def plain(args, sf, form, reduce, select):
        planned.append((args[1], form, reduce, select, sf, args[0]))
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
    assert set(rows) == keys and len(keys) == 64 and len(extra) == 64
    assert len(planned) == len(set(planned)) == 16  # one a (variant, width, form, reduce)
    assert {(wb, form, reduce, select, lanes) for wb, form, reduce, select, _, lanes in planned
            } == {(*kind[:3], "tree", 64) for kind in kinds}
    assert all(row["max_abs_err"] == 0 and row["plain_ms"] == 1.0 for row in rows.values())
    assert all(len(row["ms_runs"]) == 2 for row in rows.values())
    assert timed.count(1) == 16 and timed.count(chip_smoke.TIMED_LAUNCHES) == 128
    assert len(made) == 8
    shared = {key for key, row in rows.items() if row["plain_shared"]}
    assert shared == {key for key in keys if key[3] == "onehot" or key[5] == 8}
    assert rows[(5, "affine", "eager", "onehot", "full", 8)]["plain_of"] == (
        "full/w5/affine/eager/tree at 64 lanes")

    def wrong_launch(key):
        def launch_wrong(args, sf, form, reduce, select):
            out = verdicts(args)
            if (args[1], form, reduce, select, sf, args[0]) == key:
                out[-1] = ~out[-1]
            return out
        return launch_wrong

    for key, name in (((5, "affine", "eager", "onehot", True, 8),
                       "schnorr_free/w5/affine/eager/onehot.*8 lanes"),
                      ((4, "projective", "lazy", "tree", False, 64),
                       "full/w4/projective/lazy/tree.*64 lanes")):
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
    out16 = K.verify_core(*big, schnorr_free=sf, select="tree")
    out8 = K.verify_core(*small, schnorr_free=sf, select="onehot")
    assert torch.equal(chip_smoke.plain_lanes(out16, 8), out8)
    assert out16.tolist() == O.verify_batch_cpu(items) and any(out8) and not all(out8)


@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("reduce", ["lazy", "eager"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
@pytest.mark.parametrize("ecdsa_only", [False, True], ids=["full", "schnorr_free"])
def test_onehot_plain_program_equals_the_tree_one(monkeypatch, ecdsa_only, window_bits, reduce,
                                                  point_form):
    """verify_core(select="onehot") bit for bit the tree's program: every
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
                        select="onehot")
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
