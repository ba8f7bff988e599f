"""The hand-written CUDA verify kernel: build, binding, launcher.

Replaces ``pallas_kernel.verify_blocked`` / ``_kernel``
(``tpunode/verify/pallas_kernel.py``) on an H100.  The kernel source is
``tpunode_torch/csrc/verify_kernel.cu`` (with ``field.cuh`` and
``curve.cuh``); its note says what bounds it and how it is laid out.

* **Build**: at first use, ``nvcc`` compiles the sources for ``sm_90a``
  into a shared library with a plain C entry point, in
  ``tpunode_torch/csrc/build/``, named by a hash of the sources and flags so
  an edit rebuilds.  A failed build raises with nvcc's output.
* **Binding**: ctypes; pointers from ``data_ptr()``, the stream from
  ``torch.cuda.current_stream().cuda_stream``.  The launch is asynchronous
  on the current stream; the C function returns ``cudaGetLastError()`` and
  a nonzero code raises.
* **Dispatch**: :func:`verify_blocked` launches the kernel for CUDA tensors
  at the window width of the digit rows (33 rows: 4-bit, 27: 5-bit) and
  counts the launch in :data:`LAUNCHES` under that width; CPU tensors go
  to the plain version, :func:`kernel.verify_core`.  There is no fallback
  from one to the other.
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

__all__ = ["LAUNCHES", "BUILD_LOG", "NVCC_FLAGS", "build", "verify_blocked"]

#: Kernel launches made by :func:`verify_blocked` in this process, by
#: window width.
LAUNCHES = {4: 0, 5: 0}
#: nvcc's output of the build this process loaded (ptxas registers/spills).
BUILD_LOG = ""

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD_DIR = os.path.join(_CSRC, "build")
_SOURCES = ("verify_kernel.cu", "field.cuh", "curve.cuh")
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def build() -> str:
    """Compile the kernel library if this source/flag hash has none yet;
    returns its path.  Raises RuntimeError with nvcc's output on failure."""
    global BUILD_LOG
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    lib_path = os.path.join(_BUILD_DIR, f"libtpn_verify_{h.hexdigest()[:16]}.so")
    log_path = lib_path + ".log"
    if os.path.exists(lib_path):
        if os.path.exists(log_path):
            with open(log_path) as f:
                BUILD_LOG = f.read()
        return lib_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, "verify_kernel.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    BUILD_LOG = proc.stdout + proc.stderr
    with open(log_path, "w") as f:
        f.write(BUILD_LOG)
    os.replace(tmp, lib_path)
    return lib_path


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp = ctypes.c_void_p
            lib.tpn_verify_blocked.restype = ctypes.c_int
            lib.tpn_verify_blocked.argtypes = [vp] * 18 + [ctypes.c_int] * 3 + [vp]
            lib.tpn_error_string.restype = ctypes.c_char_p
            lib.tpn_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=None)
def _g_tables(device: torch.device, wb: int) -> torch.Tensor:
    """G's and λG's window tables on ``device``: (2, 2^wb, 3, 24) int32."""
    tabs = torch.stack([torch.from_numpy(t) for t in _kernel.window_tables(wb)])
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


def verify_blocked(*args: torch.Tensor, schnorr_free: bool) -> torch.Tensor:
    """Verdicts (B,) bool for ``PreparedBatch.device_args`` as tensors.

    CUDA tensors launch the kernel (asynchronously, on the current stream)
    at the digit rows' window width; CPU tensors run the plain version.
    ``schnorr_free`` selects the variant without the acceptance pows; set
    it only when no lane is a Schnorr or BIP340 lane
    (``PreparedBatch.schnorr_free``)."""
    b, wb = _check(args)
    dev = args[8].device
    if dev.type == "cpu":
        return _kernel.verify_core(*args, schnorr_free=schnorr_free)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _kernel.kernel_modes(wb)
    _bounds.assert_formulas_safe(window_bits=wb)
    out = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return out
    lib = _load()
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (_g_tables(dev, wb), *args, out)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    err = lib.tpn_verify_blocked(*ptrs, b, int(bool(schnorr_free)), wb, stream)
    if err != 0:
        raise RuntimeError(
            f"verify kernel launch failed: {lib.tpn_error_string(err).decode()} ({err})"
        )
    LAUNCHES[wb] += 1
    return out
