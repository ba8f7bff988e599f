"""The hand-written CUDA verify kernel: build, binding, launcher.

Replaces ``pallas_kernel.verify_blocked`` / ``_kernel``
(``tpunode/verify/pallas_kernel.py``) on an H100.  The kernel source is
``tpunode_torch/csrc/verify_kernel.cu`` (with ``field.cuh`` and
``curve.cuh``); its note says what bounds it and how it is laid out.  The
same build compiles ``csrc/diag.cu``, the probes of
:mod:`tpunode_torch.cuda_diag`.

* **Build**: at first use, ``nvcc`` compiles each library for ``sm_90a``
  from its one source into a shared library with a plain C entry point, in
  ``tpunode_torch/csrc/build/``, named by a hash of the source, the flags
  and the ``-D`` definitions so an edit rebuilds.  The verify source builds
  four times, once for each (multiply, square): ``verify_half`` and
  ``verify_mul`` under ``-DTPN_MUL_DOT=0`` (shift-add) with
  ``-DTPN_SQR_MUL=0`` (the 32 half-product instantiations) and ``=1`` (the
  32 full-product ones), ``verify_dot_half`` and ``verify_dot_mul`` the
  same under ``-DTPN_MUL_DOT=1`` (every convolution on the tensor cores,
  ``csrc/field_dot.cuh``), each exporting ``tpn_verify_blocked``; the
  probes' library is ``diag``.  The nvcc processes start together, with one
  more for each library whose PTX the caller asks for (``chip_smoke.py``
  reads the probes' PTX for digit loads, ``verify_mul``'s for the
  half-product square and each verify library's for ``mma``).  A failed
  build raises with nvcc's output.
* **Binding**: ctypes; pointers from ``data_ptr()``, the stream from
  ``torch.cuda.current_stream(dev).cuda_stream``.  The launch runs with the
  tensors' card made current (``torch.cuda.device(dev)``), asynchronously
  on that card's current stream; the C function returns
  ``cudaGetLastError()`` and a nonzero code raises.
* **Dispatch**: :func:`verify_blocked` launches the kernel for CUDA tensors
  at the window width of the digit rows (33 rows: 4-bit, 27: 5-bit), in the
  point form, with the reduction, the table select and the square it is
  given, from the library of that multiply and square, and counts the
  launch in :data:`LAUNCHES` under that width, form, reduction, select,
  pow ladder, square, multiply and variant; CPU tensors go to the plain version,
  :func:`kernel.verify_core`.  There is no fallback from one to the other.  The kernel has one ladder form, as the
  Pallas kernel has (pallas_kernel.py:182-270: its pow table, pow windows
  and Q table chain are ``fori_loop`` ladders under either value of
  ``TPUNODE_POW_LADDER``): both ladders launch the same instantiation, and
  the count keyed on the ladder shows which caller reached it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

from . import bounds as _bounds
from . import kernel as _kernel
from .curve import POINT_FORMS
from .field import MUL_MODES, REDUCE_MODES, SQR_MODES
from .width import WINDOWS_BY_BITS

__all__ = ["LAUNCHES", "VARIANTS", "VERIFY_LIBRARIES", "BUILD_LOGS", "BUILD_SECONDS",
           "NVCC_FLAGS", "PTX_FLAGS", "build", "nvcc_version", "sqr_ptx", "load_library",
           "launch_count", "verify_blocked"]

VARIANTS = ("full", "schnorr_free")
#: Kernel launches made by :func:`verify_blocked` in this process, one count
#: for each of the 128 instantiations and each pow ladder its caller runs:
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
_HEADERS = ("field.cuh", "field_dot.cuh", "curve.cuh")
#: (multiply, square) -> the verify library of its 32 instantiations.
VERIFY_LIBRARIES = {("shift_add", "half"): "verify_half", ("shift_add", "mul"): "verify_mul",
                    ("dot_general", "half"): "verify_dot_half",
                    ("dot_general", "mul"): "verify_dot_mul"}
#: library name -> (its one source file, which includes :data:`_HEADERS`,
#: and its -D definitions).  One library a (multiply, square): the four
#: compile side by side, each in a quarter of the time of one library of
#: all 128 instantiations.
_LIBRARIES = {
    **{name: ("verify_kernel.cu", (f"TPN_MUL_DOT={int(mul == 'dot_general')}",
                                   f"TPN_SQR_MUL={int(sqr == 'mul')}"))
       for (mul, sqr), name in VERIFY_LIBRARIES.items()},
    "diag": ("diag.cu", ()),
}
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

_lock = threading.Lock()
_libs: dict = {}


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
    libraries named in ``ptx`` also get their PTX, ``<path>.ptx``, from one
    more nvcc process each, started with the others.  Raises RuntimeError
    with nvcc's output on a failure."""
    paths = {name: _lib_path(name) for name in _LIBRARIES}
    jobs = {}
    os.makedirs(_BUILD_DIR, exist_ok=True)
    for name, path in paths.items():
        src, defines = _LIBRARIES[name]
        head = [_nvcc(), *(f"-D{d}" for d in defines)]
        src = os.path.join(_CSRC, src)
        if not os.path.exists(path):
            jobs[name] = [*head, *NVCC_FLAGS, "-o", f"{path}.{os.getpid()}.tmp", src]
        if name in ptx and not os.path.exists(path + ".ptx"):
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
    for key, cmd in jobs.items():
        code, log, seconds = results[key]
        BUILD_SECONDS[key] = seconds
        if code != 0:
            failed.append(f"nvcc failed ({code}): {' '.join(cmd)}\n{log}")
            continue
        name, dot, _ = key.partition(".")
        final = paths[name] + (".ptx" if dot else "")
        if not dot:
            with open(final + ".log", "w") as f:
                f.write(log)
        os.replace(f"{final}.{os.getpid()}.tmp", final)
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
    """The library ``name`` (one of :data:`VERIFY_LIBRARIES`' or "diag"),
    built if need be and loaded once."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build()[name])
        return _libs[name]


def _load(mul: str, sqr: str) -> ctypes.CDLL:
    """The verify library of multiply ``mul`` ("shift_add" or
    "dot_general") and square ``sqr`` ("half" or "mul")."""
    lib = load_library(VERIFY_LIBRARIES[(mul, sqr)])
    if lib.tpn_verify_blocked.argtypes is None:
        vp = ctypes.c_void_p
        lib.tpn_verify_blocked.argtypes = [vp] * 18 + [ctypes.c_int] * 8 + [vp]
        lib.tpn_verify_blocked.restype = ctypes.c_int
        lib.tpn_error_string.restype = ctypes.c_char_p
        lib.tpn_error_string.argtypes = [ctypes.c_int]
    return lib


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


def verify_blocked(*args: torch.Tensor, schnorr_free: bool,
                   point_form: str = "projective", reduce: str = "lazy",
                   select: str, ladder: str, sqr: str, mul: str) -> torch.Tensor:
    """Verdicts (B,) bool for ``PreparedBatch.device_args`` as tensors.

    CUDA tensors launch the kernel (asynchronously, on their card's current
    stream, with that card made current) at the digit rows' window width,
    in ``point_form`` ("projective" or "affine") with ``reduce`` ("lazy"
    or "eager") and ``select`` ("tree" or "onehot", required); CPU tensors
    run the plain version.  ``schnorr_free`` selects the variant without
    the acceptance pows; set it only when no lane is a Schnorr or BIP340
    lane (``PreparedBatch.schnorr_free``).  ``ladder`` ("scan" or
    "unroll", required) is the caller's pow ladder: the plain version runs
    it; the kernel runs its one ladder form under both values (its Q table
    chain and its pows with digits in ``__constant__`` memory), as the
    Pallas kernel does (pallas_kernel.py:182-270), so the bounds audit of a
    launch replays "scan", and the launch is counted under ``ladder``.
    ``sqr`` ("half" or "mul", required) is the square: the half product or
    the full product ``conv(a, a)``; ``mul`` ("shift_add" or "dot_general",
    required) the multiply: every convolution summed on the int32 pipes or
    contracted on the tensor cores.  Each (multiply, square) is its own
    library of 32 instantiations, every verdict the same."""
    b, wb = _check(args)
    dev = args[8].device
    if dev.type == "cpu":
        return _kernel.verify_core(*args, schnorr_free=schnorr_free, point_form=point_form,
                                   reduce=reduce, select=select, ladder=ladder, sqr=sqr,
                                   mul=mul)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _kernel.kernel_modes(wb, point_form, reduce, select, ladder, sqr, mul)
    _bounds.assert_formulas_safe(reduce, window_bits=wb, point_form=point_form, ladder="scan")
    out = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return out
    lib = _load(mul, sqr)
    sf = bool(schnorr_free)
    with torch.cuda.device(dev):
        tables = _g_tables(dev, wb, point_form)
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (tables, *args, out)]
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = lib.tpn_verify_blocked(*ptrs, b, int(sf), wb, _FORM_CODES[point_form],
                                     _REDUCE_CODES[reduce], _SELECT_CODES[select],
                                     _SQR_CODES[sqr], _MUL_CODES[mul], stream)
    if err != 0:
        raise RuntimeError(
            f"verify kernel launch failed: {lib.tpn_error_string(err).decode()} ({err})"
        )
    LAUNCHES[(wb, point_form, reduce, select, ladder, sqr, mul, VARIANTS[sf])] += 1
    return out
