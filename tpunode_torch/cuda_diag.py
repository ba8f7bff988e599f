"""Probes of the verify kernel's affine-form constructs, one CUDA kernel each.

The port's counterparts of two of ``benchmarks/mosaic_diag.py``'s Mosaic
probes: a build-and-run check of one construct at a time, so that a fault of
the toolchain or of the code is pinned to that construct and not only seen
in the whole verify kernel.

* ``mixed_add``: one complete mixed addition (``curve.pt_add_mixed``, the
  affine form's window add) of 7G and 11G over 256 lanes; X - x_e·Z and
  Y - y_e·Z must be ≡ 0 (mod p) against host affine addition.
* ``batch_inv``: the affine Q table's batch inversion over 16 entries —
  the column z^1 .. z^14 of one random z a lane (``default_rng(17)``),
  prefix products, one Fermat ladder, the suffix step of entry 15 — and
  z_15 · z_15^-1 must canonicalise to 1 in every lane.

The kernels are ``csrc/diag.cu``, built with the verify kernel
(:func:`tpunode_torch.verify.cuda_kernel.build`); :func:`mixed_add_plain`
and :func:`batch_inv_plain` are their plain PyTorch versions.  On a CUDA
tensor a wrapper launches its kernel and counts it in :data:`LAUNCHES`; on a
CPU tensor it runs the plain version.  Run::

    python -m tpunode_torch.cuda_diag [--device cpu]

It runs on the card unless the CPU is asked for, prints one JSON line and
exits 1 if a probe fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch

from .verify import cuda_kernel
from .verify import field as F
from .verify.curve import make_point, pt_add_mixed
from .verify.ecdsa_cpu import GENERATOR, point_add, point_mul
from .verify.kernel import _PM2_DIGITS, _pow_const, resolve_device

__all__ = ["LAUNCHES", "LANES", "PROBES", "mixed_add", "mixed_add_plain", "batch_inv",
           "batch_inv_plain", "probe_inputs", "run_probe", "run", "main"]

#: Probe kernel launches made in this process, by probe.
LAUNCHES = {"mixed_add": 0, "batch_inv": 0}
LANES = 256  # the Mosaic probes' block width
PROBES = tuple(LAUNCHES)
_ENTRIES = 16  # the batch inversion's table, as at 4-bit windows


def _check(name: str, *rows: torch.Tensor) -> torch.device:
    """Every argument an int32 (24, B) contiguous limb-row tensor on one device."""
    dev, b = rows[0].device, rows[0].shape[-1]
    for i, t in enumerate(rows):
        if (t.dtype != torch.int32 or tuple(t.shape) != (F.NLIMBS, b) or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name} argument {i}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected contiguous int32 ({F.NLIMBS}, {b}) on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _lib() -> ctypes.CDLL:
    """The probes' library (built with the verify kernel), bound once."""
    lib = cuda_kernel.load_library("diag")
    if lib.tpn_diag_batch_inv.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tpn_diag_mixed_add.argtypes = [vp] * 5 + [ci, vp]
        lib.tpn_diag_mixed_add.restype = ci
        lib.tpn_diag_batch_inv.argtypes = [vp] * 2 + [ci, vp]
        lib.tpn_diag_batch_inv.restype = ci
        lib.tpn_diag_error_string.argtypes = [ci]
        lib.tpn_diag_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, fn: str, *tensors: torch.Tensor, b: int) -> None:
    """Launch ``fn`` on the current stream over ``b`` lanes; raise if the
    launch fails, else count it."""
    lib = _lib()
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in tensors]
    stream = ctypes.c_void_p(torch.cuda.current_stream(tensors[0].device).cuda_stream)
    err = getattr(lib, fn)(*ptrs, b, stream)
    if err != 0:
        msg = lib.tpn_diag_error_string(err).decode()
        raise RuntimeError(f"{name} probe launch failed: {msg} ({err})")
    LAUNCHES[name] += 1


def mixed_add_plain(px, py, qx, qy) -> torch.Tensor:
    """(px, py, 1) + (qx, qy) by the plain mixed add: (3, 24, B)."""
    one = F.ONE.to(px.device).expand_as(px)
    return pt_add_mixed(make_point(px, py, one), torch.stack([qx, qy]))


def mixed_add(px, py, qx, qy) -> torch.Tensor:
    """:func:`mixed_add_plain` for CPU tensors; the probe kernel for CUDA
    tensors (asynchronous, on the current stream)."""
    if _check("mixed_add", px, py, qx, qy).type == "cpu":
        return mixed_add_plain(px, py, qx, qy)
    out = torch.empty((3,) + tuple(px.shape), dtype=torch.int32, device=px.device)
    _launch("mixed_add", "tpn_diag_mixed_add", px, py, qx, qy, out, b=px.shape[-1])
    return out


def batch_inv_plain(z) -> torch.Tensor:
    """canonical(z_15 · z_15^-1) over the column z_k = z^(k-1), by prefix
    products, one Fermat ladder and the suffix step of entry 15: (24, B)."""
    col = [None, None, z]
    for _ in range(3, _ENTRIES):
        col.append(F.mul(col[-1], z))
    prefix = [None, None, z]
    for k in range(3, _ENTRIES):
        prefix.append(F.mul(prefix[-1], col[k]))
    inv = F.mul(_pow_const(prefix[-1], _PM2_DIGITS), prefix[-2])
    return F.canonical(F.mul(col[-1], inv))


def batch_inv(z) -> torch.Tensor:
    """:func:`batch_inv_plain` for CPU tensors; the probe kernel for CUDA
    tensors (asynchronous, on the current stream)."""
    if _check("batch_inv", z).type == "cpu":
        return batch_inv_plain(z)
    out = torch.empty_like(z)
    _launch("batch_inv", "tpn_diag_batch_inv", z, out, b=z.shape[-1])
    return out


def probe_inputs(name: str, device, lanes: int = LANES) -> tuple:
    """The Mosaic probe's inputs on ``device``: 7G and 11G broadcast to
    ``lanes`` (mixed_add), or one z in [2, 2^61) a lane from
    ``default_rng(17)`` (batch_inv)."""
    def cols(vals) -> torch.Tensor:
        limbs = np.stack([F.to_limbs(v) for v in vals], axis=1)
        return torch.from_numpy(np.ascontiguousarray(limbs)).to(device)

    if name == "mixed_add":
        p1, p2 = point_mul(7, GENERATOR), point_mul(11, GENERATOR)
        return tuple(cols([v] * lanes) for v in (p1.x, p1.y, p2.x, p2.y))
    if name == "batch_inv":
        rng = np.random.default_rng(17)
        return (cols([int(rng.integers(2, 2**61)) for _ in range(lanes)]),)
    raise ValueError(f"no probe {name!r}: {PROBES}")


def _host_check(name: str, out: torch.Tensor) -> int:
    """Lanes whose result is wrong, checked with Python integers."""
    out = out.cpu().numpy()
    if name == "mixed_add":
        e = point_add(point_mul(7, GENERATOR), point_mul(11, GENERATOR))
        return sum(
            (F.from_limbs(out[0, :, i]) - e.x * F.from_limbs(out[2, :, i])) % F.P != 0
            or (F.from_limbs(out[1, :, i]) - e.y * F.from_limbs(out[2, :, i])) % F.P != 0
            for i in range(out.shape[-1]))
    one = F.to_limbs(1)
    return int((out != one[:, None]).any(axis=0).sum())


def run_probe(name: str, device) -> dict:
    """One probe on ``device``: its wrapper on the probe's inputs, checked
    on the host.  A failure is reported in the result, not raised."""
    t0 = time.perf_counter()
    try:
        fn = {"mixed_add": mixed_add, "batch_inv": batch_inv}[name]
        out = fn(*probe_inputs(name, device))
        bad = _host_check(name, out)
        res = {"case": name, "ok": bad == 0, "lanes": out.shape[-1], "bad_lanes": bad}
    except Exception as e:  # noqa: BLE001 — a probe reports its fault and the next one runs
        res = {"case": name, "ok": False,
               "error": f"{type(e).__name__}: {e}"[:600],
               "traceback": traceback.format_exc()[-2000:]}
    res["s"] = time.perf_counter() - t0
    return res


def run(device: Optional[str] = None) -> dict:
    """Every probe on ``device`` (None: the card; a missing card raises)."""
    dev = resolve_device(device)
    return {"diag": "cuda" if dev.type == "cuda" else "plain",
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "cases": [run_probe(name, dev) for name in PROBES]}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpunode_torch.cuda_diag",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card; cpu runs the plain versions")
    res = run(ap.parse_args(argv).device)
    print(json.dumps(res), flush=True)
    return 0 if all(c["ok"] for c in res["cases"]) else 1


if __name__ == "__main__":
    sys.exit(main())
