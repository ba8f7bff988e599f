"""``u32_modes_ab.py``, the in-turns timing of two trees' one-hot eager
affine 8-word kernels: what it builds from which tree, and that it refuses
to run without a card.  The timing itself needs the card and nvcc."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import u32_modes_ab  # noqa: E402

from tpunode_torch.verify import cuda_kernel  # noqa: E402

FAKE_NVCC = '''#!{python}
"""A stand-in for nvcc: writes its arguments as JSON to the -o file and the
ptxas lines nvcc -Xptxas -v prints; fails for a source under FAIL_UNDER."""
import json, os, sys
args = sys.argv[1:]
fail = os.environ.get("FAIL_UNDER")
if fail and args[-1].startswith(fail):
    print("error: a fault in " + args[-1])
    sys.exit(2)
with open(args[args.index("-o") + 1], "w") as f:
    json.dump(args, f)
print("ptxas info    : Compiling entry function "
      "'_ZN3tpn3u325modes23verify_u32_modes_kernelILi4ELb0ELb0EEEvNS1_10VerifyArgsEPKi' "
      "for 'sm_90a'")
print("ptxas info    : Function properties for "
      "_ZN3tpn3u325modes23verify_u32_modes_kernelILi4ELb0ELb0EEEvNS1_10VerifyArgsEPKi")
print("    2560 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
print("ptxas info    : Used 233 registers, used 1 barriers, 2176 bytes smem")
'''


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    tool = tmp_path / "nvcc"
    tool.write_text(FAKE_NVCC.replace("{python}", sys.executable))
    tool.chmod(0o755)
    monkeypatch.setattr(cuda_kernel, "_nvcc", lambda: str(tool))
    other = tmp_path / "other"
    shutil.copytree(ROOT / "tpunode_torch" / "csrc", other / "tpunode_torch" / "csrc",
                    ignore=shutil.ignore_patterns("build"))
    out = tmp_path / "out"
    out.mkdir()
    return {"this": str(ROOT), "other": str(other)}, str(out)


def test_each_tree_builds_every_modes_library_from_its_own_source(fake_nvcc):
    """One nvcc process a (tree, library) for each one-hot modes library
    (the four a tree before the tree select builds too; the tree ones are
    not A/B'd): the tree's own verify_u32_modes.cu, the library's -D
    definitions and the port's nvcc flags, its ptxas log kept beside the
    library's path."""
    trees, out = fake_nvcc
    built = u32_modes_ab.build(trees, out)
    onehot = {lib for (_, select, _), lib in cuda_kernel.U32_MODES_LIBRARIES.items()
              if select == "onehot"}
    assert len(onehot) == 4 and set(u32_modes_ab.onehot_libraries().values()) == onehot
    assert set(built) == {(tree, lib) for tree in trees for lib in onehot}
    for (tree, lib), (path, log) in built.items():
        args = json.loads(Path(path).read_text())
        _, defines = cuda_kernel._LIBRARIES[lib]
        assert args[-1] == os.path.join(trees[tree], "tpunode_torch", "csrc",
                                        "verify_u32_modes.cu")
        assert args[:len(defines)] == [f"-D{d}" for d in defines]
        assert tuple(args[len(defines):len(defines) + len(cuda_kernel.NVCC_FLAGS)]) == (
            cuda_kernel.NVCC_FLAGS)
        assert os.path.dirname(path) == out and Path(path).name.startswith(f"{tree}_{lib}")
        import chip_smoke

        assert chip_smoke.ptxas_entries(log)["full/u32_modes/half"]["registers"] == 233


def test_a_failed_build_raises_with_nvcc_output(fake_nvcc, monkeypatch):
    trees, out = fake_nvcc
    monkeypatch.setenv("FAIL_UNDER", trees["other"])
    with pytest.raises(RuntimeError, match="a fault in") as err:
        u32_modes_ab.build(trees, out)
    assert "('this'," not in str(err.value) and str(err.value).count("nvcc failed (2)") == 4


def test_exits_1_without_a_card(tmp_path):
    """No CUDA device: exit 1 and print no timing line and no ok line."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(ROOT / "u32_modes_ab.py"), str(tmp_path)],
                          capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 1
    assert "no CUDA device" in proc.stderr and '"ok"' not in proc.stdout
