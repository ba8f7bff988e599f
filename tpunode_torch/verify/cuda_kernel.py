"""The hand-written CUDA verify kernels: build, binding, routing, launcher.

Replace ``pallas_kernel.verify_blocked`` / ``_kernel``
(``tpunode/verify/pallas_kernel.py``) on an H100.  Three kernel sources:

* ``tpunode_torch/csrc/verify_u32.cu`` (with ``field_u32.cuh`` and
  ``curve_u32.cuh``), the kernel redesigned for the card: 8-word field
  elements on the widening multiply, everything inlined.  It runs the
  default mode tuple, :data:`U32_MODES` (4-bit windows, projective, lazy,
  tree select, half-product square, shift-add), under either pow ladder:
  the main path's kernel.
* ``tpunode_torch/csrc/verify_u32_modes.cu``, the same arithmetic at the
  mode tuples of :data:`U32_MODES_LIBRARIES` (:data:`U32_MODES_TUPLES`),
  each square its own library.  The eager shift-add ones: affine with
  4-bit or 5-bit windows and the one-hot select, or 4-bit windows and the
  tree select; projective with 5-bit windows and the one-hot select: the
  affine Q table by one batch inversion and mixed adds, or the projective
  one by complete adds alone and complete adds, in the eager bodies'
  order, every entry read by the one-hot select (in 16-byte loads, eight
  entries in flight, λQ's select right after Q's, or projective in the
  same walk), or the one entry of the digit by the tree select, right
  before its add.  And the lazy ``dot_general`` one, affine, 5-bit,
  one-hot: the same program in the lazy bodies' order, every product's
  anti-diagonal sums contracted by its warp on the integer tensor cores
  (``csrc/field_u32_dot.cuh``), every warp converged to its end.
* ``tpunode_torch/csrc/verify_kernel.cu`` (with ``field.cuh``,
  ``field_dot.cuh`` and ``curve.cuh``), the radix-11 template that computes
  the reference's own formulation, for every other mode tuple.

Each note says what bounds its kernel and how it is laid out.  The same
build compiles ``csrc/diag.cu``, the probes of :mod:`tpunode_torch.cuda_diag`.

* **Build**: at first use, ``nvcc`` compiles each library for ``sm_90a``
  from its one source into a shared library with a plain C entry point, in
  ``tpunode_torch/csrc/build/``, named by a hash of the source, the headers,
  the flags and the ``-D`` definitions so an edit rebuilds.  ``verify_u32``
  is one library (``tpn_verify_u32``); ``verify_u32_modes.cu`` builds ten
  times, one library a mode tuple:
  ``verify_u32_modes_half`` and ``verify_u32_modes_mul`` under
  ``-DTPN_SQR_MUL=0`` and ``=1`` (4-bit, affine, one-hot),
  ``verify_u32_modes5_half`` and ``verify_u32_modes5_mul`` the same under
  ``-DTPN_WB=5``, ``verify_u32_modes_tree_half`` and
  ``verify_u32_modes_tree_mul`` the same under ``-DTPN_SELECT_TREE=1``
  (4-bit, tree), ``verify_u32_modes5_proj_half`` and
  ``verify_u32_modes5_proj_mul`` under ``-DTPN_WB=5
  -DTPN_POINT_PROJECTIVE=1`` (5-bit, projective, one-hot), all eager and
  shift-add, and ``verify_u32_dot5_half`` and ``verify_u32_dot5_mul`` under
  ``-DTPN_WB=5 -DTPN_U32_DOT=1`` (5-bit, affine, lazy, one-hot,
  ``dot_general``) (``tpn_verify_u32_modes``, each its tuple's two variants:
  one process of four instantiations took 127-132 s, the build's
  longest).  The radix-11 source builds four times, once for each
  (multiply, square): ``verify_half`` and
  ``verify_mul`` under ``-DTPN_MUL_DOT=0`` (shift-add) with
  ``-DTPN_SQR_MUL=0`` (the 32 half-product instantiations) and ``=1`` (the
  32 full-product ones), ``verify_dot_half`` and ``verify_dot_mul`` the
  same under ``-DTPN_MUL_DOT=1`` (every convolution on the tensor cores,
  ``csrc/field_dot.cuh``), each exporting ``tpn_verify_blocked``; the
  probes' library is ``diag``.  The nvcc processes start together; a
  library whose PTX the caller asks for keeps it from its own process
  (``chip_smoke.py`` reads the probes' PTX for digit loads, ``verify_mul``'s
  for the half-product square and each radix-11 library's for ``mma``).  A
  failed build raises with nvcc's output.
* **Binding**: ctypes; pointers from ``data_ptr()``, the stream from
  ``torch.cuda.current_stream(dev).cuda_stream``.  The launch runs with the
  tensors' card made current (``torch.cuda.device(dev)``), asynchronously
  on that card's current stream; the C function returns
  ``cudaGetLastError()`` and a nonzero code raises.
* **Routing**: :func:`kernel_library` names the library of a mode tuple:
  ``verify_u32`` for :data:`U32_MODES`, its library in
  :data:`U32_MODES_LIBRARIES` for each of :data:`U32_MODES_TUPLES`, else
  the radix-11 library of its (multiply, square).  There is no fallback:
  if that library fails to build or to launch, the call raises; a tuple
  routed to an 8-word library never runs
  its radix-11 entry through :func:`verify_blocked`.  Those entries stay in
  ``verify_half`` and ``verify_mul`` (``verify_dot_half`` and
  ``verify_dot_mul`` for the ``dot_general`` tuple) as the 8-word kernels'
  yardsticks, launched only by name through :func:`verify_with`.
* **Dispatch**: :func:`verify_blocked` launches the routed kernel for CUDA
  tensors at the window width of the digit rows (33 rows: 4-bit, 27:
  5-bit), in the point form, with the reduction, the table select, the
  square and the multiply it is given, and counts the launch in
  :data:`LAUNCHES` under that width, form, reduction, select, pow ladder,
  square, multiply and variant, and in :data:`LIBRARY_LAUNCHES` under the
  library and the variant; CPU tensors go to the plain version,
  :func:`kernel.verify_core`.  There is no fallback from one to the
  other.  The kernels have one ladder form, as the Pallas kernel has
  (pallas_kernel.py:182-270: its pow table, pow windows and Q table chain
  are ``fori_loop`` ladders under either value of ``TPUNODE_POW_LADDER``):
  both ladders launch the same kernel, and the count keyed on the ladder
  shows which caller reached it.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

from .. import threadsan
from . import bounds as _bounds
from . import kernel as _kernel
from .curve import POINT_FORMS
from .field import MUL_MODES, REDUCE_MODES, SQR_MODES
from .width import WINDOWS_BY_BITS

__all__ = ["LAUNCHES", "LIBRARY_LAUNCHES", "STREAM_LAUNCHES", "VARIANTS", "VERIFY_LIBRARIES",
           "U32_LIBRARY", "U32_MODES", "U32_MODES_LIBRARIES", "U32_MODES_TUPLES", "BUILD_LOGS",
           "BUILD_SECONDS", "NVCC_FLAGS", "PTX_FLAGS", "build",
           "nvcc_version", "sqr_ptx", "load_library", "launch_count", "count_launch",
           "kernel_library", "verify_with", "verify_blocked"]

VARIANTS = ("full", "schnorr_free")
#: Kernel launches made by :func:`verify_with` (so by :func:`verify_blocked`)
#: in this process, one count for each mode tuple of the 128 radix-11
#: instantiations (the default one's launches run ``verify_u32``; see
#: :data:`LIBRARY_LAUNCHES`) and each pow ladder its caller runs:
#: keyed (window bits, point form, reduce mode, select, ladder, square,
#: multiply, variant).
LAUNCHES = {(wb, form, reduce, select, ladder, sqr, mul, v): 0 for wb in WINDOWS_BY_BITS
            for form in POINT_FORMS for reduce in REDUCE_MODES for select in ("tree", "onehot")
            for ladder in ("scan", "unroll") for sqr in SQR_MODES for mul in MUL_MODES
            for v in VARIANTS}
#: nvcc's output of the builds this process loaded (ptxas registers/spills),
#: each library's by name (the verify libraries share their kernels' names).
BUILD_LOGS: dict = {}
#: Wall seconds of each nvcc process the last :func:`build` started, by
#: library name, and by ``"<name>.ptx"`` for a PTX it emitted.
BUILD_SECONDS: dict = {}

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD_DIR = os.path.join(_CSRC, "build")
_HEADERS = ("field.cuh", "field_dot.cuh", "curve.cuh", "field_u32.cuh", "field_u32_dot.cuh",
            "curve_u32.cuh")
#: (multiply, square) -> the radix-11 verify library of its 32 instantiations.
VERIFY_LIBRARIES = {("shift_add", "half"): "verify_half", ("shift_add", "mul"): "verify_mul",
                    ("dot_general", "half"): "verify_dot_half",
                    ("dot_general", "mul"): "verify_dot_mul"}
#: The library of the kernel redesigned for the card (``csrc/verify_u32.cu``).
U32_LIBRARY = "verify_u32"
#: The mode tuple that :data:`U32_LIBRARY` runs, under either ladder:
#: (window bits, point form, reduce, select, sqr, mul), the default one.
U32_MODES = (4, "projective", "lazy", "tree", "half", "shift_add")
#: A mode tuple (window bits, point form, reduce, select, sqr, mul; the
#: fields of :data:`U32_MODES`) -> the library that runs it on the same
#: 8-word arithmetic (``csrc/verify_u32_modes.cu`` under ``-DTPN_SQR_MUL=0``
#: / ``1``, with ``-DTPN_WB=5`` at 5 bits, ``-DTPN_SELECT_TREE=1`` for the
#: tree select, ``-DTPN_POINT_PROJECTIVE=1`` for projective points and
#: ``-DTPN_U32_DOT=1`` for the lazy ``dot_general`` tuple).  The eager
#: shift-add tuples: affine 4-bit or 5-bit one-hot and 4-bit tree,
#: projective 5-bit one-hot; and the lazy affine 5-bit one-hot
#: ``dot_general`` one, whose products are contracted on the tensor cores
#: (``csrc/field_u32_dot.cuh``).  Each square has its own library, and a
#: library is built only where a tuple routes to it.
U32_MODES_LIBRARIES = {
    (4, "affine", "eager", "onehot", "half", "shift_add"): "verify_u32_modes_half",
    (4, "affine", "eager", "onehot", "mul", "shift_add"): "verify_u32_modes_mul",
    (5, "affine", "eager", "onehot", "half", "shift_add"): "verify_u32_modes5_half",
    (5, "affine", "eager", "onehot", "mul", "shift_add"): "verify_u32_modes5_mul",
    (4, "affine", "eager", "tree", "half", "shift_add"): "verify_u32_modes_tree_half",
    (4, "affine", "eager", "tree", "mul", "shift_add"): "verify_u32_modes_tree_mul",
    (5, "projective", "eager", "onehot", "half", "shift_add"): "verify_u32_modes5_proj_half",
    (5, "projective", "eager", "onehot", "mul", "shift_add"): "verify_u32_modes5_proj_mul",
    (5, "affine", "lazy", "onehot", "half", "dot_general"): "verify_u32_dot5_half",
    (5, "affine", "lazy", "onehot", "mul", "dot_general"): "verify_u32_dot5_mul"}
#: The mode tuples that :data:`U32_MODES_LIBRARIES` run, one a library, under
#: either ladder.
U32_MODES_TUPLES = tuple(U32_MODES_LIBRARIES)
#: library name -> (its one source file, which includes some of
#: :data:`_HEADERS`, and its -D definitions).  One radix-11 library a
#: (multiply, square): the four compile side by side with the others, each
#: in a quarter of the time of one library of all 128 instantiations.
_LIBRARIES = {
    **{name: ("verify_kernel.cu", (f"TPN_MUL_DOT={int(mul == 'dot_general')}",
                                   f"TPN_SQR_MUL={int(sqr == 'mul')}"))
       for (mul, sqr), name in VERIFY_LIBRARIES.items()},
    U32_LIBRARY: ("verify_u32.cu", ()),
    **{name: ("verify_u32_modes.cu", (*(("TPN_WB=5",) if wb == 5 else ()),
                                      *(("TPN_SELECT_TREE=1",) if select == "tree" else ()),
                                      *(("TPN_POINT_PROJECTIVE=1",) if form == "projective"
                                        else ()),
                                      *(("TPN_U32_DOT=1",) if mul == "dot_general" else ()),
                                      f"TPN_SQR_MUL={int(sqr == 'mul')}"))
       for (wb, form, _, select, sqr, mul), name in U32_MODES_LIBRARIES.items()},
    "diag": ("diag.cu", ()),
}
#: Kernel launches made by :func:`verify_with` (so by
#: :func:`verify_blocked`) in this process, keyed (library, variant): which
#: code a run went through.
LIBRARY_LAUNCHES = {(name, v): 0 for name in (*VERIFY_LIBRARIES.values(), U32_LIBRARY,
                                               *U32_MODES_LIBRARIES.values())
                    for v in VARIANTS}
#: The same launches keyed (card, stream handle): which card and which of
#: its streams each ran on (a sharded launch gives every shard a stream of
#: its own).  Keys appear as launches do; clear it to start a count.
STREAM_LAUNCHES: collections.Counter = collections.Counter()
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
#: The flags of a library's PTX (the source as nvcc hands it to ptxas).
PTX_FLAGS = ("-O3", "-std=c++17", "-arch=compute_90a", "-ptx")
_FORM_CODES = {form: i for i, form in enumerate(POINT_FORMS)}  # the launcher's point_form
_REDUCE_CODES = {"lazy": 0, "eager": 1}  # the launcher's reduce
_SELECT_CODES = {"tree": 0, "onehot": 1}  # the launcher's select
_SQR_CODES = {"half": 0, "mul": 1}  # the launcher's sqr
_MUL_CODES = {"shift_add": 0, "dot_general": 1}  # the launcher's mul

_lock = threadsan.lock("verify.cuda_libs")
_libs: dict = {}
# LAUNCHES, LIBRARY_LAUNCHES and STREAM_LAUNCHES
_count_lock = threadsan.lock("verify.launch_counts")


def launch_count(window_bits: int, point_form: str, reduce: str, select: str,
                 ladder: str, sqr: str, mul: str) -> int:
    """Launches at ``window_bits`` in ``point_form`` with ``reduce``,
    ``select``, ``ladder``, ``sqr`` and ``mul``, both variants."""
    return sum(LAUNCHES[(window_bits, point_form, reduce, select, ladder, sqr, mul, v)]
               for v in VARIANTS)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def nvcc_version() -> str:
    """The last line of ``nvcc --version``: the compiler's release and build."""
    proc = subprocess.run([_nvcc(), "--version"], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, check=True)
    return proc.stdout.strip().splitlines()[-1]


def _lib_path(name: str) -> str:
    src, defines = _LIBRARIES[name]
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for f_name in (src, *_HEADERS):
        with open(os.path.join(_CSRC, f_name), "rb") as f:
            h.update(f_name.encode() + f.read())
    return os.path.join(_BUILD_DIR, f"libtpn_{name}_{h.hexdigest()[:16]}.so")


def _run_nvcc(cmd: list, results: dict, key: str) -> None:
    """Run one nvcc command to its end; record (returncode, output,
    seconds) under ``key``."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    results[key] = proc.returncode, proc.stdout, time.perf_counter() - t0


def build(ptx: tuple = ()) -> dict:
    """Compile every library whose source/flag hash has none yet, one nvcc
    process for each, all started together; returns {name: path}.  The
    libraries named in ``ptx`` also get their PTX, ``<path>.ptx``: the one
    their own nvcc process hands to ptxas, kept (``-keep``) so that no
    second process repeats the front end (on the card's 8-core host the
    build ran 13 processes, 5 of them PTX only), or, for a library built
    already, from one more process, started with the others.  Raises
    RuntimeError with nvcc's output on a failure."""
    paths = {name: _lib_path(name) for name in _LIBRARIES}
    jobs, keep_dirs = {}, {}
    os.makedirs(_BUILD_DIR, exist_ok=True)
    for name, path in paths.items():
        src, defines = _LIBRARIES[name]
        head = [_nvcc(), *(f"-D{d}" for d in defines)]
        src = os.path.join(_CSRC, src)
        wants_ptx = name in ptx and not os.path.exists(path + ".ptx")
        if not os.path.exists(path):
            keep = []
            if wants_ptx:
                keep_dirs[name] = f"{path}.{os.getpid()}.keep"
                os.makedirs(keep_dirs[name], exist_ok=True)
                keep = ["-keep", "-keep-dir", keep_dirs[name]]
            jobs[name] = [*head, *NVCC_FLAGS, *keep, "-o", f"{path}.{os.getpid()}.tmp", src]
        elif wants_ptx:
            jobs[f"{name}.ptx"] = [*head, *PTX_FLAGS, "-o", f"{path}.ptx.{os.getpid()}.tmp", src]
    results: dict = {}
    threads = [threading.Thread(target=_run_nvcc, args=(cmd, results, key))
               for key, cmd in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    BUILD_SECONDS.clear()
    failed = []
    try:
        for key, cmd in jobs.items():
            code, log, seconds = results[key]
            BUILD_SECONDS[key] = seconds
            if code != 0:
                failed.append(f"nvcc failed ({code}): {' '.join(cmd)}\n{log}")
                continue
            name, dot, _ = key.partition(".")
            final = paths[name] + (".ptx" if dot else "")
            if not dot:
                if name in keep_dirs:
                    kept = [f for f in os.listdir(keep_dirs[name]) if f.endswith(".ptx")]
                    if len(kept) != 1:
                        failed.append(f"nvcc kept {kept} in {keep_dirs[name]}, expected one PTX "
                                      f"file: {' '.join(cmd)}")
                        continue
                    os.replace(os.path.join(keep_dirs[name], kept[0]), final + ".ptx")
                with open(final + ".log", "w") as f:
                    f.write(log)
            os.replace(f"{final}.{os.getpid()}.tmp", final)
    finally:
        for keep in keep_dirs.values():
            shutil.rmtree(keep, ignore_errors=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    BUILD_LOGS.clear()
    for name, path in paths.items():
        if os.path.exists(path + ".log"):
            with open(path + ".log") as f:
                BUILD_LOGS[name] = f.read()
    return paths


_PTX_CALL = re.compile(r"\bcall(?:\.uni)?\s+(?:\([^)]*\)\s*,\s*)?(\w+)")


def sqr_ptx(ptx: str) -> dict:
    """What a library's PTX shows of its squares: the lines that name the
    half-product ``tpn::sqr_conv`` (its definition, its declaration or a
    call), and the calls of ``tpn::sqr_conv`` and of the general
    convolution ``tpn::conv`` (mangled ``_ZN3tpn8sqr_conv..``,
    ``_ZN3tpn4conv..``).  The full-product library names no ``sqr_conv``:
    every square there calls ``conv``."""
    calls = _PTX_CALL.findall(ptx)
    return {"sqr_conv_lines": sum("sqr_conv" in line for line in ptx.splitlines()),
            "sqr_conv_calls": sum("sqr_conv" in callee for callee in calls),
            "conv_calls": sum(callee.startswith("_ZN3tpn4conv") for callee in calls)}


def load_library(name: str) -> ctypes.CDLL:
    """The library ``name`` (one of :data:`VERIFY_LIBRARIES`',
    :data:`U32_LIBRARY`, :data:`U32_MODES_LIBRARIES`' or "diag"),
    built if need be and loaded once."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build()[name])
        return _libs[name]


def _load(mul: str, sqr: str) -> ctypes.CDLL:
    """The radix-11 verify library of multiply ``mul`` ("shift_add" or
    "dot_general") and square ``sqr`` ("half" or "mul")."""
    lib = load_library(VERIFY_LIBRARIES[(mul, sqr)])
    if lib.tpn_verify_blocked.argtypes is None:
        vp = ctypes.c_void_p
        lib.tpn_verify_blocked.argtypes = [vp] * 18 + [ctypes.c_int] * 8 + [vp]
        lib.tpn_verify_blocked.restype = ctypes.c_int
        lib.tpn_error_string.restype = ctypes.c_char_p
        lib.tpn_error_string.argtypes = [ctypes.c_int]
    return lib


def _load_u32() -> ctypes.CDLL:
    """The library of the kernel redesigned for the card, :data:`U32_LIBRARY`."""
    lib = load_library(U32_LIBRARY)
    if lib.tpn_verify_u32.argtypes is None:
        vp = ctypes.c_void_p
        lib.tpn_verify_u32.argtypes = [vp] * 18 + [ctypes.c_int] * 2 + [vp]
        lib.tpn_verify_u32.restype = ctypes.c_int
        lib.tpn_u32_error_string.restype = ctypes.c_char_p
        lib.tpn_u32_error_string.argtypes = [ctypes.c_int]
    return lib


def _load_u32_modes(name: str) -> ctypes.CDLL:
    """A library of :data:`U32_MODES_LIBRARIES`, the one mode tuple's."""
    lib = load_library(name)
    if lib.tpn_verify_u32_modes.argtypes is None:
        vp = ctypes.c_void_p
        lib.tpn_verify_u32_modes.argtypes = [vp] * 18 + [ctypes.c_int] * 3 + [vp]
        lib.tpn_verify_u32_modes.restype = ctypes.c_int
        lib.tpn_u32_modes_error_string.restype = ctypes.c_char_p
        lib.tpn_u32_modes_error_string.argtypes = [ctypes.c_int]
    return lib


def kernel_library(window_bits: int, point_form: str, reduce: str, select: str, sqr: str,
                   mul: str) -> str:
    """The library whose kernel :func:`verify_blocked` launches for a mode
    tuple: :data:`U32_LIBRARY` for :data:`U32_MODES`, the tuple's library
    in :data:`U32_MODES_LIBRARIES` for :data:`U32_MODES_TUPLES`, else the
    radix-11 library of (``mul``, ``sqr``)."""
    modes = (window_bits, point_form, reduce, select, sqr, mul)
    if modes == U32_MODES:
        return U32_LIBRARY
    if modes in U32_MODES_LIBRARIES:
        return U32_MODES_LIBRARIES[modes]
    return VERIFY_LIBRARIES[(mul, sqr)]


@functools.lru_cache(maxsize=None)
def _g_tables(device: torch.device, wb: int, form: str = "projective") -> torch.Tensor:
    """G's and λG's window tables on ``device``: (2, 2^wb, 3, 24) int32, or
    (2, 2^wb, 2, 24) in the affine form."""
    tabs = torch.stack([torch.from_numpy(t) for t in _kernel.window_tables(wb, form)])
    return tabs.to(device).contiguous()


def _check(args: tuple) -> tuple:
    """Validate device, dtype, shape and contiguity; returns the batch B
    and the window width of the digit rows."""
    if len(args) != 16:
        raise ValueError(f"verify_blocked takes 16 device arrays, got {len(args)}")
    b = args[8].shape[-1]
    dev = args[8].device
    wb = _kernel.digit_rows_width(*args[:4])
    for i, t in enumerate(args):
        nd = 2 if i < 4 or 8 <= i < 12 else 1
        rows = _kernel.windows(wb) if i < 4 else 24
        want = (rows, b) if nd == 2 else (b,)
        dtype = torch.int32 if nd == 2 else torch.bool
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != want:
            raise ValueError(
                f"argument {i}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                f"expected {dtype} {want} on {dev}"
            )
        if not t.is_contiguous():
            raise ValueError(f"argument {i} is not contiguous")
    return b, wb


def _entry(library: str, modes: tuple) -> tuple:
    """How to launch ``library``'s kernel at ``modes`` (:data:`U32_MODES`'
    fields): ``(load, codes)``, where ``load()`` loads the library (built
    at first use: a failed build raises) and gives its entry point and its
    error-string function, and ``codes`` are the mode codes that entry
    takes after the variant.  Raises unless the library holds an
    instantiation of ``modes``: :data:`U32_LIBRARY` only :data:`U32_MODES`,
    one of :data:`U32_MODES_LIBRARIES` only its own tuple (its code: the
    square's), a radix-11 one its own (multiply, square).  The radix-11 launch audits its
    formulas' int32 headroom (``bounds.assert_formulas_safe``); that replay
    proves the radix-11 template only, and the 8-word kernels' arithmetic
    has no signed value to overflow: ``tests/test_torch_u32.py``,
    ``tests/test_torch_u32_modes.py``, ``tests/test_torch_u32_modes5.py``,
    ``tests/test_torch_u32_modes_tree.py``,
    ``tests/test_torch_u32_modes5_proj.py`` and
    ``tests/test_torch_u32_dot5.py`` stand in for it (the field layer and
    the tensor-core contraction against Python integers at the carries'
    edges, the point formulas and the per-lane program against the plain
    version)."""
    wb, point_form, reduce, select, sqr, mul = modes
    if library == U32_LIBRARY:
        if modes != U32_MODES:
            raise ValueError(f"{U32_LIBRARY} runs the modes {U32_MODES} only, not {modes}")

        def load_u32() -> tuple:
            lib = _load_u32()
            return lib.tpn_verify_u32, lib.tpn_u32_error_string
        return load_u32, ()
    if library in U32_MODES_LIBRARIES.values():
        runs = next(t for t, name in U32_MODES_LIBRARIES.items() if name == library)
        if modes != runs:
            raise ValueError(f"{library} runs the modes {runs} only, not {modes}")

        def load_u32_modes() -> tuple:
            lib = _load_u32_modes(library)
            return lib.tpn_verify_u32_modes, lib.tpn_u32_modes_error_string
        return load_u32_modes, (_SQR_CODES[sqr],)
    if library != VERIFY_LIBRARIES[(mul, sqr)]:
        raise ValueError(f"{library} holds no instantiation of the modes {modes}")
    _bounds.assert_formulas_safe(reduce, window_bits=wb, point_form=point_form, ladder="scan")

    def load_radix11() -> tuple:
        lib = _load(mul, sqr)
        return lib.tpn_verify_blocked, lib.tpn_error_string
    return load_radix11, (wb, _FORM_CODES[point_form], _REDUCE_CODES[reduce],
                          _SELECT_CODES[select], _SQR_CODES[sqr], _MUL_CODES[mul])


def _launch(library: str, load, ptrs: list, b: int, schnorr_free: bool, codes: tuple,
            stream) -> None:
    """Launch ``library``'s kernel, as :func:`_entry` gives it (``load``
    and ``codes``), over ``b`` lanes on ``stream`` with the pointers
    ``ptrs`` (the G tables, the 16 arguments, the verdicts); a launch the
    card refuses raises with the library's message.  Nothing else is
    tried."""
    entry, message = load()
    err = entry(*ptrs, b, int(schnorr_free), *codes, stream)
    if err != 0:
        raise RuntimeError(
            f"verify kernel launch failed ({library}): {message(err).decode()} ({err})"
        )


def verify_blocked(*args: torch.Tensor, schnorr_free: bool,
                   point_form: str = "projective", reduce: str = "lazy",
                   select: str, ladder: str, sqr: str, mul: str) -> torch.Tensor:
    """Verdicts (B,) bool for ``PreparedBatch.device_args`` as tensors.

    CUDA tensors launch the kernel of :func:`kernel_library` (asynchronously,
    on their card's current stream, with that card made current) at the
    digit rows' window width, in ``point_form`` ("projective" or "affine")
    with ``reduce`` ("lazy" or "eager") and ``select`` ("tree" or "onehot",
    required); CPU tensors run the plain version.  ``schnorr_free`` selects
    the variant without the acceptance pows; set it only when no lane is a
    Schnorr or BIP340 lane (``PreparedBatch.schnorr_free``).  ``ladder``
    ("scan" or "unroll", required) is the caller's pow ladder: the plain
    version runs it; the kernels run their one ladder form under both values
    (the Q table chain and the pows with digits in ``__constant__`` memory),
    as the Pallas kernel does (pallas_kernel.py:182-270), and the launch is
    counted under ``ladder``.  ``sqr`` ("half" or "mul", required) is the
    square: the half product or the full product ``conv(a, a)``; ``mul``
    ("shift_add" or "dot_general", required) the multiply: every
    convolution summed on the int32 pipes or contracted on the tensor cores.
    The default tuple (:data:`U32_MODES`) runs the 8-word kernel
    (``verify_u32``), each tuple of :data:`U32_MODES_TUPLES` its library in
    :data:`U32_MODES_LIBRARIES`; each other (multiply,
    square) is its own radix-11 library of 32 instantiations.  Every verdict
    is the same."""
    _, wb = _check(args)
    if args[8].device.type == "cpu":
        return _kernel.verify_core(*args, schnorr_free=schnorr_free, point_form=point_form,
                                   reduce=reduce, select=select, ladder=ladder, sqr=sqr,
                                   mul=mul)
    _kernel.kernel_modes(wb, point_form, reduce, select, ladder, sqr, mul)
    return _verify_on_card(kernel_library(wb, point_form, reduce, select, sqr, mul), args,
                           schnorr_free, (wb, point_form, reduce, select, sqr, mul), ladder)


def verify_with(library: str, *args: torch.Tensor, schnorr_free: bool,
                point_form: str = "projective", reduce: str = "lazy", select: str,
                ladder: str, sqr: str, mul: str) -> torch.Tensor:
    """:func:`verify_blocked`'s launch through the named ``library`` (CUDA
    tensors only), counted in :data:`LAUNCHES` and :data:`LIBRARY_LAUNCHES`:
    the routed one, or by name the radix-11 entry of a tuple routed to an
    8-word library (``verify_half``'s or ``verify_mul``'s, or
    ``verify_dot_half``'s or ``verify_dot_mul``'s), the yardstick
    that ``chip_smoke.py`` times the 8-word kernel against.  The library
    must hold an instantiation of the modes (:func:`_entry`)."""
    _, wb = _check(args)
    _kernel.kernel_modes(wb, point_form, reduce, select, ladder, sqr, mul)
    return _verify_on_card(library, args, schnorr_free,
                           (wb, point_form, reduce, select, sqr, mul), ladder)


def _verify_on_card(library: str, args: tuple, schnorr_free: bool, modes: tuple,
                    ladder: str) -> torch.Tensor:
    """The launch of :func:`verify_blocked` and :func:`verify_with` on
    checked arguments and modes."""
    dev = args[8].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    load, codes = _entry(library, modes)
    b = args[8].shape[-1]
    out = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return out
    sf = bool(schnorr_free)
    with torch.cuda.device(dev):
        tables = _g_tables(dev, modes[0], modes[1])
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (tables, *args, out)]
        handle = torch.cuda.current_stream(dev).cuda_stream
        _launch(library, load, ptrs, b, sf, codes, ctypes.c_void_p(handle))
    count_launch(library, modes, ladder, sf, stream=(str(dev), handle))
    return out


def count_launch(library: str, modes: tuple, ladder: str, schnorr_free: bool,
                 stream: Optional[tuple] = None) -> None:
    """Add one launch of ``library`` at ``modes`` (:data:`U32_MODES`'
    fields) under ``ladder`` to :data:`LAUNCHES` and
    :data:`LIBRARY_LAUNCHES`, and under ``stream`` (card, stream handle)
    to :data:`STREAM_LAUNCHES`.  Engine lanes launch from several dispatch
    threads at once, so the read-modify-writes run under one lock."""
    wb, point_form, reduce, select, sqr, mul = modes
    variant = VARIANTS[bool(schnorr_free)]
    with _count_lock:
        LAUNCHES[(wb, point_form, reduce, select, ladder, sqr, mul, variant)] += 1
        LIBRARY_LAUNCHES[(library, variant)] += 1
        if stream is not None:
            STREAM_LAUNCHES[stream] += 1
