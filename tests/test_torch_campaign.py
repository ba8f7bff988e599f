"""The port's campaign entry point (``tpunode_torch.campaign``) on the CPU.

Its pool must be the reference's (``benchmarks/campaign.py``) item for item
from the same seed, and the plain version must pass it with zero
mismatches at both window widths.  Verdicts are booleans: tolerance zero.
"""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmarks.campaign import build_pool as ref_build_pool
from tpunode_torch import campaign as C
from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.engine import VerifyEngine

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _plain(item) -> tuple:
    """An item with its pubkey as (x, y), so the two packages' points compare."""
    q = item[0]
    return (None if q is None else (q.x, q.y),) + tuple(item[1:])


def test_pool_equals_the_reference_pool():
    ref_rng, rng = random.Random(C.SEED), random.Random(C.SEED)
    ref_items, ref_shapes, ref_expects = ref_build_pool(3, ref_rng)
    items, shapes, expects = C.build_pool(3, rng)
    assert [_plain(it) for it in items] == [_plain(it) for it in ref_items]
    assert shapes == ref_shapes and expects == ref_expects
    assert rng.getstate() == ref_rng.getstate()  # the same draws, in the same order
    assert len(set(shapes)) == 21 and any(expects) and not all(expects)


@pytest.mark.parametrize("window_bits", [4, 5])
def test_pool_passes_the_plain_version_at_each_width(window_bits):
    res = C.run_campaign(3, 32, window_bits=window_bits, device="cpu")
    assert res["mismatches"] == 0 and res["mismatch_detail"] == []
    assert res["items"] == sum(v["total"] for v in res["tally"].values()) == 21
    assert (res["kernel"], res["device"], res["window_bits"], res["launches"]) == (
        "plain", "cpu", window_bits, 0)
    assert res["tally"]["ecdsa-valid"] == {"accepted": 1, "total": 1}
    assert res["tally"]["bip340-parity-twin"] == {"accepted": 0, "total": 1}


def test_a_wrong_verdict_is_a_mismatch(monkeypatch):
    real = VerifyEngine.verify_sync

    def flip_first(self, items):
        got = real(self, items)
        return [not got[0]] + got[1:]

    monkeypatch.setattr(VerifyEngine, "verify_sync", flip_first)
    res = C.run_campaign(3, 32, window_bits=4, device="cpu")
    assert res["mismatches"] == 1
    assert res["mismatch_detail"] == [{"index": 0, "shape": "ecdsa-valid", "device": False,
                                       "oracle": True, "required": True}]


def test_cli_prints_one_json_line_and_exits_0():
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "tpunode_torch.campaign", "3", "32", "--window-bits", "5",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert (res["mismatches"], res["items"], res["window_bits"]) == (0, 21, 5)


def test_cli_exits_1_on_a_mismatch(monkeypatch, capsys):
    monkeypatch.setattr(C, "run_campaign", lambda *a, **kw: {"mismatches": 1})
    assert C.main(["3", "32", "--device", "cpu"]) == 1
    assert json.loads(capsys.readouterr().out) == {"mismatches": 1}
    with pytest.raises(SystemExit):
        C.main(["3", "32", "--window-bits", "6"])


def test_campaign_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def plain_must_not_run(*a, **kw):
        raise AssertionError("the plain version ran for a device that was not the CPU")

    monkeypatch.setattr(K, "verify_core", plain_must_not_run)
    launches = dict(cuda_kernel.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA"):
        C.run_campaign(3, 32)
    assert cuda_kernel.LAUNCHES == launches
