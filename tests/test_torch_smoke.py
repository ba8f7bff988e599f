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

import chip_smoke
from tpunode_torch.verify import ecdsa_cpu as O

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

    def verify(sf, wb, af, regs, stack, smem):
        return entry(f"_ZN3tpn13verify_kernelILb{sf}ELi{wb}ELb{af}EEEvNS_10VerifyArgsEPKi",
                     regs, stack, smem)

    log = (verify(0, 5, 0, 243, 21600, 18432) + verify(1, 5, 0, 255, 21120, 18432)
           + verify(0, 4, 0, 243, 12384, 9216) + verify(1, 4, 0, 255, 11904, 9216)
           + verify(0, 5, 1, 249, 21312, 12288) + verify(1, 5, 1, 253, 21312, 12288)
           + verify(0, 4, 1, 249, 12096, 6144) + verify(1, 4, 1, 253, 12096, 6144)
           + entry("_ZN3tpn16mixed_add_kernelEPKiS1_S1_S1_Pii", 168, 2208, 0)
           + entry("_ZN3tpn16batch_inv_kernelEPKiPii", 64, 5184, 0))
    got = chip_smoke.ptxas_entries(log)
    assert sorted(got) == sorted(
        [f"{v}/w{wb}/{form}" for v in ("full", "schnorr_free") for wb in (4, 5)
         for form in ("projective", "affine")] + ["batch_inv", "mixed_add"])
    assert got["full/w5/projective"] == {"registers": 243, "smem": 18432, "stack_frame": 21600,
                                         "spill_stores": 0, "spill_loads": 0}
    assert got["schnorr_free/w4/projective"]["stack_frame"] == 11904
    assert got["full/w4/affine"] == {"registers": 249, "smem": 6144, "stack_frame": 12096,
                                     "spill_stores": 0, "spill_loads": 0}
    assert got["batch_inv"]["registers"] == 64 and got["mixed_add"]["stack_frame"] == 2208
    assert chip_smoke.ptxas_entries(verify(1, 4, 1, 253, 12096, 6144)).keys() == {
        "schnorr_free/w4/affine"}


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
