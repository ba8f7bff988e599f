#!/usr/bin/env python3
"""Time the 8-word verify kernels of the mode tuples
(``tpunode_torch/csrc/verify_u32_modes.cu``) of this tree and of another in
turns on one card, on the same arguments.

    python3 u32_modes_ab.py OTHER_TREE [--lanes 32768 4096] [--turns 4]
                            [--library NAME ...] [--out FILE]

``OTHER_TREE`` is the root of another checkout of this repository, such as
a commit unpacked with ``git archive``; only its ``tpunode_torch/csrc`` is
read.  Each tree's ``verify_u32_modes.cu`` is compiled into each library
of ``cuda_kernel.U32_MODES_LIBRARIES`` that both trees can build
(:func:`shared_libraries`; ``--library`` keeps the named ones alone) with
this tree's nvcc flags and that library's ``-D`` definitions, one nvcc
process a (tree, library), all
started together, into a temporary directory, and ``verify_u32`` beside
them from each tree's ``verify_u32.cu``; their ptxas lines are read by
``chip_smoke.ptxas_entries``, and each library's ptxas lines and static
SASS (``cuobjdump -sass``, where the toolkit has it) are held against the
other tree's.  Then, for each library but ``verify_u32``, variant and lane
count, both trees' ``tpn_verify_u32_modes`` run on the same prepared batch
(``full``: ``chip_smoke.py``'s block pool, BIP340 lanes included;
``schnorr_free``: its mempool pool; every ninth item corrupted), timed in
``--turns`` turns each, alternating which tree goes first, each turn
``chip_smoke.TIMED_LAUNCHES`` launches between two CUDA events.  Both
trees' verdicts must equal the native CPU verifier's.

Prints the card's name and power limit, one JSON line a tree's ptxas lines,
one a library with ``ptxas_equal`` and ``sass_equal`` (None without
cuobjdump), one a (library, variant, lanes) with both trees' mean ms, their runs and
``this / other``, and last ``{"ok": true}``; with ``--out`` the same lines
go to that file as well.  Needs one card and nvcc; exits 1 when a build or
a verdict fails.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import re
import sys
import tempfile
import threading

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CORRUPT_EVERY = 9


def _source(root: str, library: str = "verify_u32_modes_half") -> str:
    """The source of ``library`` in the tree at ``root``."""
    from tpunode_torch.verify import cuda_kernel as C

    return os.path.join(root, "tpunode_torch", "csrc", C._LIBRARIES[library][0])


def shared_libraries(other: str = HERE) -> dict:
    """{mode tuple: library} of ``U32_MODES_LIBRARIES`` that the tree at
    ``other`` builds too: each
    whose ``-D`` macros its ``verify_u32_modes.cu`` names (a tree before the
    tree select or the projective form ignores ``TPN_SELECT_TREE`` or
    ``TPN_POINT_PROJECTIVE`` and would build another kernel, and one
    before the lazy dot_general tuple ``TPN_U32_DOT``)."""
    from tpunode_torch.verify import cuda_kernel as C

    with open(_source(other)) as f:
        text = f.read()
    return {key: library for key, library in C.U32_MODES_LIBRARIES.items()
            if all(d.split("=")[0] in text for d in C._LIBRARIES[library][1])}


def build(trees: dict, out_dir: str, libraries) -> dict:
    """{(tree, library): (path, ptxas log)} for each tree of ``trees``
    ({name: root}) and each of ``libraries``; raises with nvcc's output when
    a build fails."""
    from tpunode_torch.verify import cuda_kernel as C

    jobs = {}
    for tree, root in trees.items():
        for library in libraries:
            src = _source(root, library)
            _, defines = C._LIBRARIES[library]
            path = os.path.join(out_dir, f"{tree}_{library}.so")
            jobs[(tree, library)] = path, [C._nvcc(), *(f"-D{d}" for d in defines),
                                           *C.NVCC_FLAGS, "-o", path, src]
    results: dict = {}
    threads = [threading.Thread(target=C._run_nvcc, args=(cmd, results, key))
               for key, (_, cmd) in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [f"{key}: nvcc failed ({results[key][0]})\n{results[key][1]}"
              for key in jobs if results[key][0] != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return {key: (path, results[key][1]) for key, (path, _) in jobs.items()}


def entry(path: str):
    """The ``tpn_verify_u32_modes`` of the library at ``path``."""
    fn = ctypes.CDLL(path).tpn_verify_u32_modes
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_SASS_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)")


def sass_bodies(text: str) -> dict:
    """Each function's instructions in ``cuobjdump -sass`` output, {mangled
    name: [instruction text]}: what two builds must share for their code
    to be the same (the headers name each build's own file)."""
    heads = list(chip_smoke._SASS_FUNCTION.finditer(text))
    return {head.group(1): _SASS_INSTRUCTION.findall(
        text[head.end():nxt.start() if nxt else len(text)])
        for head, nxt in zip(heads, heads[1:] + [None])}


def same_code(built: dict, library: str) -> dict:
    """Whether both trees' builds of ``library`` (:func:`build`'s) give the
    same ptxas lines and the same static SASS, instruction for instruction
    in each function (None where the toolkit has no cuobjdump), and the
    instructions of this tree's."""
    ptxas = [chip_smoke.ptxas_entries(built[(tree, library)][1]) for tree in ("this", "other")]
    sass = [chip_smoke.cuobjdump_sass(built[(tree, library)][0]) for tree in ("this", "other")]
    if None in sass:
        return {"library": library, "ptxas_equal": ptxas[0] == ptxas[1], "sass_equal": None}
    bodies = [sass_bodies(text) for text in sass]
    return {"library": library, "ptxas_equal": ptxas[0] == ptxas[1],
            "sass_equal": bodies[0] == bodies[1], "sass_functions": len(bodies[0]),
            "instructions": sum(map(len, bodies[0].values()))}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", help="the root of the other tree")
    parser.add_argument("--lanes", type=int, nargs="+", default=[32768, 4096])
    parser.add_argument("--turns", type=int, default=4)
    parser.add_argument("--library", nargs="+", help="time these libraries alone")
    parser.add_argument("--out", help="also write the lines to this file")
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("u32_modes_ab: no CUDA device is available", file=sys.stderr)
        return 1
    from tpunode_torch.verify import cuda_kernel as C
    from tpunode_torch.verify import ecdsa_cpu as O
    from tpunode_torch.verify import kernel as K
    from tpunode_torch.verify.cpu_native import load_native_verifier
    from tpunode_torch.verify.raw import pack_items

    trees = {"this": HERE, "other": os.path.abspath(opts.other)}
    libraries = {key: library for key, library in shared_libraries(trees["other"]).items()
                 if not opts.library or library in opts.library}
    if opts.library and set(opts.library) != set(libraries.values()):
        print(f"u32_modes_ab: both trees build {sorted(libraries.values())} of "
              f"{opts.library}", file=sys.stderr)
        return 1
    out_file = open(opts.out, "w") if opts.out else None

    def emit(line) -> None:
        text = line if isinstance(line, str) else json.dumps(line)
        print(text, flush=True)
        if out_file:
            out_file.write(text + "\n")
            out_file.flush()

    card = chip_smoke.nvidia_smi("name,power.limit")
    emit(card)
    with tempfile.TemporaryDirectory() as tmp:
        built = build(trees, tmp, [C.U32_LIBRARY, *libraries.values()])
        for tree in trees:
            ptxas = {}
            for library in (C.U32_LIBRARY, *libraries.values()):
                ptxas.update(chip_smoke.ptxas_entries(built[(tree, library)][1]))
            emit({"tree": tree, "root": trees[tree], "ptxas": ptxas})
        for library in (C.U32_LIBRARY, *libraries.values()):
            emit(same_code(built, library))
        dev = torch.device("cuda")
        rng = random.Random(chip_smoke.SEED)
        most = max(opts.lanes)
        pools = {"full": chip_smoke.btc_pool(O, rng, 96, bip340=True),
                 "schnorr_free": chip_smoke.btc_pool(O, rng, 64, bip340=False)}
        items = {v: chip_smoke.corrupt_every(chip_smoke.tile(pool, most), CORRUPT_EVERY)
                 for v, pool in pools.items()}
        native = load_native_verifier()
        expect = {v: native.verify_raw(pack_items(its)) for v, its in items.items()}
        for (wb, form, reduce, select, sqr, mul), library in libraries.items():
            fns = {tree: entry(built[(tree, library)][0]) for tree in trees}
            tables = C._g_tables(dev, wb, form)
            for variant, its in items.items():
                for lanes in opts.lanes:
                    prep = K.prepare_batch_raw(pack_items(its[:lanes]), pad_to=lanes,
                                               window_bits=wb)
                    sf = prep.schnorr_free
                    if sf != (variant == "schnorr_free"):
                        raise RuntimeError(f"{variant}: the batch selects the other variant")
                    args = K.from_reference(prep.device_args, dev)
                    outs = {tree: torch.empty(lanes, dtype=torch.bool, device=dev)
                            for tree in trees}
                    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

                    def launch(tree: str) -> None:
                        ptrs = [ctypes.c_void_p(t.data_ptr())
                                for t in (tables, *args, outs[tree])]
                        err = fns[tree](*ptrs, lanes, int(sf), int(sqr == "mul"), stream)
                        if err:
                            raise RuntimeError(f"{tree} {library}: launch failed ({err})")

                    for tree in trees:
                        launch(tree)
                    torch.cuda.synchronize()
                    for tree in trees:
                        if outs[tree].tolist() != list(expect[variant][:lanes]):
                            raise RuntimeError(f"{tree} {library} {variant} at {lanes} lanes: "
                                               f"verdicts differ from the native verifier's")
                    runs = {tree: [] for tree in trees}
                    for turn in range(opts.turns):
                        for tree in (("this", "other") if turn % 2 == 0 else ("other", "this")):
                            runs[tree].append(chip_smoke.timed_ms(
                                torch, lambda: launch(tree), chip_smoke.TIMED_LAUNCHES))
                    ms = {tree: sum(r) / len(r) for tree, r in runs.items()}
                    emit({"card": card, "library": library, "window_bits": wb,
                          "point_form": form, "reduce": reduce, "select": select,
                          "sqr": sqr, "mul": mul,
                          "variant": variant, "lanes": lanes, "ms": ms, "ms_runs": runs,
                          "this_over_other": ms["this"] / ms["other"],
                          "valid": sum(expect[variant][:lanes])})
    emit({"ok": True})
    if out_file:
        out_file.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
