"""The hand-written CUDA verify kernel: build, binding, launcher.

Replaces ``pallas_kernel.verify_blocked`` / ``_kernel``
(``tpunode/verify/pallas_kernel.py``) on an H100.  The kernel source is
``tpunode_torch/csrc/verify_kernel.cu`` (with ``field.cuh`` and
``curve.cuh``); its note says what bounds it and how it is laid out.  The
same build compiles ``csrc/diag.cu``, the probes of
:mod:`tpunode_torch.cuda_diag`.

* **Build**: at first use, ``nvcc`` compiles each source for ``sm_90a``
  into a shared library with a plain C entry point, in
  ``tpunode_torch/csrc/build/``, named by a hash of the sources and flags so
  an edit rebuilds.  The nvcc processes start together.  A failed build
  raises with nvcc's output.
* **Binding**: ctypes; pointers from ``data_ptr()``, the stream from
  ``torch.cuda.current_stream(dev).cuda_stream``.  The launch runs with the
  tensors' card made current (``torch.cuda.device(dev)``), asynchronously
  on that card's current stream; the C function returns
  ``cudaGetLastError()`` and a nonzero code raises.
* **Dispatch**: :func:`verify_blocked` launches the kernel for CUDA tensors
  at the window width of the digit rows (33 rows: 4-bit, 27: 5-bit), in the
  point form, with the reduction and the table select it is given, and
  counts the launch in :data:`LAUNCHES` under that width, form, reduction,
  select and variant; CPU tensors go to the plain version,
  :func:`kernel.verify_core`.  There is no
  fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from . import bounds as _bounds
from . import kernel as _kernel
from .curve import POINT_FORMS
from .field import REDUCE_MODES
from .width import WINDOWS_BY_BITS

__all__ = ["LAUNCHES", "VARIANTS", "BUILD_LOG", "NVCC_FLAGS", "build", "load_library",
           "launch_count", "verify_blocked"]

VARIANTS = ("full", "schnorr_free")
#: Kernel launches made by :func:`verify_blocked` in this process, one count
#: for each of the 32 instantiations: keyed (window bits, point form,
#: reduce mode, select, variant).
LAUNCHES = {(wb, form, reduce, select, v): 0 for wb in WINDOWS_BY_BITS for form in POINT_FORMS
            for reduce in REDUCE_MODES for select in ("tree", "onehot") for v in VARIANTS}
#: nvcc's output of the builds this process loaded (ptxas registers/spills).
BUILD_LOG = ""

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD_DIR = os.path.join(_CSRC, "build")
_HEADERS = ("field.cuh", "curve.cuh")
#: library name -> its one source file, which includes :data:`_HEADERS`.
_LIBRARIES = {"verify": "verify_kernel.cu", "diag": "diag.cu"}
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
_FORM_CODES = {form: i for i, form in enumerate(POINT_FORMS)}  # the launcher's point_form
_REDUCE_CODES = {"lazy": 0, "eager": 1}  # the launcher's reduce
_SELECT_CODES = {"tree": 0, "onehot": 1}  # the launcher's select

_lock = threading.Lock()
_libs: dict = {}


def launch_count(window_bits: int, point_form: str, reduce: str, select: str) -> int:
    """Launches at ``window_bits`` in ``point_form`` with ``reduce`` and
    ``select``, both variants."""
    return sum(LAUNCHES[(window_bits, point_form, reduce, select, v)] for v in VARIANTS)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (_LIBRARIES[name], *_HEADERS):
        with open(os.path.join(_CSRC, src), "rb") as f:
            h.update(src.encode() + f.read())
    return os.path.join(_BUILD_DIR, f"libtpn_{name}_{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile every library whose source/flag hash has none yet, one nvcc
    process for each, all started together; returns {name: path}.  Raises
    RuntimeError with nvcc's output on a failure."""
    global BUILD_LOG
    paths = {name: _lib_path(name) for name in _LIBRARIES}
    procs = {}
    os.makedirs(_BUILD_DIR, exist_ok=True)
    for name, path in paths.items():
        if not os.path.exists(path):
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", f"{path}.{os.getpid()}.tmp",
                   os.path.join(_CSRC, _LIBRARIES[name])]
            procs[name] = cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)
    failed = []
    for name, (cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
            continue
        with open(paths[name] + ".log", "w") as f:
            f.write(log)
        os.replace(f"{paths[name]}.{os.getpid()}.tmp", paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    logs = []
    for path in paths.values():
        if os.path.exists(path + ".log"):
            with open(path + ".log") as f:
                logs.append(f.read())
    BUILD_LOG = "".join(logs)
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The library ``name`` ("verify" or "diag"), built if need be and
    loaded once."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build()[name])
        return _libs[name]


def _load():
    lib = load_library("verify")
    if lib.tpn_verify_blocked.argtypes is None:
        vp = ctypes.c_void_p
        lib.tpn_verify_blocked.argtypes = [vp] * 18 + [ctypes.c_int] * 6 + [vp]
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
                   select: str) -> torch.Tensor:
    """Verdicts (B,) bool for ``PreparedBatch.device_args`` as tensors.

    CUDA tensors launch the kernel (asynchronously, on their card's current
    stream, with that card made current) at the digit rows' window width,
    in ``point_form`` ("projective" or "affine") with ``reduce`` ("lazy"
    or "eager") and ``select`` ("tree" or "onehot", required); CPU tensors
    run the plain version.  ``schnorr_free`` selects the variant without
    the acceptance pows; set it only when no lane is a Schnorr or BIP340
    lane (``PreparedBatch.schnorr_free``)."""
    b, wb = _check(args)
    dev = args[8].device
    if dev.type == "cpu":
        return _kernel.verify_core(*args, schnorr_free=schnorr_free, point_form=point_form,
                                   reduce=reduce, select=select)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _kernel.kernel_modes(wb, point_form, reduce, select)
    _bounds.assert_formulas_safe(reduce, window_bits=wb, point_form=point_form)
    out = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return out
    lib = _load()
    sf = bool(schnorr_free)
    with torch.cuda.device(dev):
        tables = _g_tables(dev, wb, point_form)
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (tables, *args, out)]
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = lib.tpn_verify_blocked(*ptrs, b, int(sf), wb, _FORM_CODES[point_form],
                                     _REDUCE_CODES[reduce], _SELECT_CODES[select], stream)
    if err != 0:
        raise RuntimeError(
            f"verify kernel launch failed: {lib.tpn_error_string(err).decode()} ({err})"
        )
    LAUNCHES[(wb, point_form, reduce, select, VARIANTS[sf])] += 1
    return out
