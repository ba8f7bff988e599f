#!/usr/bin/env python3
"""Write the ptxas lines of a source tree's 64 shift-add verify kernel
instantiations as JSON: the snapshot that ``chip_smoke.py``'s phase 2 holds
this tree's build against, field for field.

    python3 ptxas_snapshot.py TREE OUT --source TEXT

``TREE`` is the root of a checkout of this repository, this one or another
commit unpacked with ``git archive``.  Its own
``tpunode_torch.verify.cuda_kernel.build()`` runs in a child process there,
on a machine with nvcc; the entries are read from the ptxas logs of its
``verify_half`` and ``verify_mul`` libraries (the shift-add ones) by
``chip_smoke.ptxas_entries``.  Beside them go ``TEXT`` (which tree it was),
the nvcc release and the tree's nvcc flags: phase 2 compares only a
snapshot of the same release and flags.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402

SHIFT_ADD_LIBRARIES = ("verify_half", "verify_mul")
_CHILD = ("import json\n"
          "from tpunode_torch.verify import cuda_kernel as C\n"
          "paths = C.build()\n"
          f"print(json.dumps({{'logs': [paths[n] + '.log' for n in {SHIFT_ADD_LIBRARIES!r}], "
          "'flags': list(C.NVCC_FLAGS)}))\n")


def snapshot(tree: str, source: str) -> dict:
    """Build ``tree``'s libraries in a child process there and return the
    snapshot: ``source``, ``nvcc``, ``nvcc_flags`` and the ``entries``
    keyed as :func:`chip_smoke.ptxas_entries` keys them."""
    from tpunode_torch.verify import cuda_kernel

    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=tree, check=True,
                          stdout=subprocess.PIPE, text=True)
    built = json.loads(proc.stdout.strip().splitlines()[-1])
    entries = {}
    for log in built["logs"]:
        with open(os.path.join(tree, log)) as f:
            entries.update(chip_smoke.ptxas_entries(f.read()))
    return {"source": source, "nvcc": cuda_kernel.nvcc_version(), "nvcc_flags": built["flags"],
            "entries": dict(sorted(entries.items()))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree")
    ap.add_argument("out")
    ap.add_argument("--source", required=True, help="which tree this is, e.g. its commit")
    args = ap.parse_args(argv)
    snap = snapshot(args.tree, args.source)
    with open(args.out, "w") as f:
        json.dump(snap, f, indent=1)
        f.write("\n")
    print(json.dumps({"entries": len(snap["entries"]), "nvcc": snap["nvcc"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
