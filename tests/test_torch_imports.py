"""Import hygiene of the port: tpunode_torch and chip_smoke.py import neither
jax nor anything of the reference package ``tpunode`` or of its
``benchmarks``."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((REPO / "tpunode_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "tpunode", "benchmarks")


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_and_no_reference_package(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_the_walk_sees_the_whole_package():
    names = {p.name for p in SOURCES}
    assert {"engine.py", "kernel.py", "cuda_kernel.py", "field.py", "curve.py",
            "bounds.py", "cpu_native.py", "raw.py", "ecdsa_cpu.py", "trace.py",
            "native.py", "width.py", "campaign.py", "cuda_diag.py", "chip_smoke.py",
            "compat.py", "threadsan.py", "metrics.py", "events.py", "tracectx.py",
            "chaos.py", "actors.py", "sched.py", "util.py", "params.py", "wire.py",
            "sighash.py", "seenlru.py", "txverify.py", "txextract.py", "headers.py",
            "txgen.py", "store.py", "utxo.py", "peer.py", "chain.py", "peermgr.py", "ibd.py",
            "mempool.py", "watchdog.py", "asyncsan.py", "timeseries.py", "slo.py",
            "blackbox.py", "node.py"} <= names


def test_port_imports_with_jax_and_tpunode_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'tpunode', 'benchmarks'):\n"
        "    sys.modules[name] = None\n"
        "import tpunode_torch.verify.engine, tpunode_torch.verify.cuda_kernel\n"
        "import tpunode_torch.verify.sched, tpunode_torch.actors, tpunode_torch.compat\n"
        "import tpunode_torch.campaign, tpunode_torch.cuda_diag\n"
        "import tpunode_torch.txextract, tpunode_torch.txgen, tpunode_torch.seenlru\n"
        "import tpunode_torch.node, tpunode_torch.store, tpunode_torch.native\n"
        "from tpunode_torch import Node, NodeConfig, UtxoStore, open_store\n"
        "from tpunode_torch.native import NativeKV\n"
        "from tpunode_torch.verify.sched import affinity_key\n"
        "import chip_smoke\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'tpunode.', 'benchmarks.'))\n"
        "               for m, mod in sys.modules.items() if mod is not None)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
