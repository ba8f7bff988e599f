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
    def entry(sf, wb, regs, stack, smem):
        name = f"_ZN3tpn13verify_kernelILb{sf}ELi{wb}EEEvNS_10VerifyArgsEPKi"
        return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {name}\n"
                f"    {stack} bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
                f"ptxas info    : Used {regs} registers, used 1 barriers, {stack} bytes "
                f"cumulative stack size, {smem} bytes smem\n"
                f"ptxas info    : Compile time = 727.609 ms\n"
                "ptxas info    : Function properties for _ZN3tpn6pt_addEPNS_2PtEPKS0_S3_\n"
                "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n")

    log = (entry(0, 5, 243, 21600, 18432) + entry(1, 5, 255, 21120, 18432)
           + entry(0, 4, 243, 12384, 9216) + entry(1, 4, 255, 11904, 9216))
    got = chip_smoke.ptxas_entries(log)
    assert sorted(got) == ["full/w4", "full/w5", "schnorr_free/w4", "schnorr_free/w5"]
    assert got["full/w5"] == {"registers": 243, "smem": 18432, "stack_frame": 21600,
                              "spill_stores": 0, "spill_loads": 0}
    assert got["schnorr_free/w4"]["stack_frame"] == 11904
    assert chip_smoke.ptxas_entries(entry(1, 4, 255, 11904, 9216)).keys() == {"schnorr_free/w4"}


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
