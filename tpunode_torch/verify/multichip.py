"""Multi-card batch verification: the batch split over a mesh of cards.

The BCH 32 MB-block stress config (~150k signatures in one block) wants
more than one card.  Signature verification has no cross-item
dependencies, so the multi-card design is pure data parallelism:

* a 1-D :class:`Mesh` over the visible cards, axis ``"batch"``;
* every input array split along its batch dimension — the minor-most axis
  of the limb-major arrays (see field.py), the only axis of the masks — so
  the host-to-card transfer is split per card;
* each shard runs the same single-card program (the mode tuple's kernel,
  or the plain program) on its own card, inside ``torch.cuda.device(dev)``
  and on a stream of its own — no traffic between cards in the hot loop;
* the host sums the shards' valid counts (:meth:`ShardedVerdicts.total`),
  the counterpart of the reference's one ``psum``; there is no collective.

Fleet topology: :func:`make_hybrid_mesh` generalizes the 1-D mesh to a
``(host, chip)`` grid — data-parallel lane sharding across hosts with the
per-host axis kept local.  :func:`sharded_verify_fn` /
:func:`dispatch_raw_sharded` take either mesh shape (the batch axis
shards over ALL mesh axes jointly); :func:`host_submesh` slices one
host's device row back out as a 1-D mesh — the fleet dispatcher's
per-host device rung (engine ``mesh_hosts``).

:class:`Mesh` takes the place of ``jax.sharding.Mesh``: a numpy object
array of ``torch.device`` (1-D, or 2-D for :data:`HYBRID_AXES`) and its
axis names.  An explicit device list may repeat a device (two shards on
one card, each on its own stream): torch has one CPU device, so a CPU
mesh of several entries is that device repeated, as the reference's
tests use 8 virtual CPU devices; the engine never builds such a mesh,
since :func:`visible_devices` lists each card once.

The reference's Mosaic fallback (``with_mosaic_fallback``,
``pallas_broken``) has no counterpart: the port has one kernel a mode
tuple and a failed launch raises.  Its multi-process pod branch of
:func:`make_hybrid_mesh` has none yet either: every mesh here is one
process's cards.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..trace import span
from . import cuda_kernel
from .ecdsa_cpu import Point
from .kernel import (
    collect_verdicts,
    from_reference,
    prepare_batch,
    prepare_batch_raw,
    verify_core,
)
# Canonical fleet host names: owned by sched.py (next to the AffinityMap
# that seeds rendezvous scores from them), re-exported here so topology
# callers keep one import site.
from .sched import host_names
from .width import WINDOW_BITS

__all__ = [
    "HYBRID_AXES",
    "Mesh",
    "ShardedVerdicts",
    "visible_devices",
    "make_mesh",
    "make_hybrid_mesh",
    "host_names",
    "host_submesh",
    "sharded_verify_fn",
    "verify_batch_sharded",
    "dispatch_raw_sharded",
]

#: Axis names of a hybrid (multi-host) mesh: ``host`` is the slow
#: (cross-host) axis, ``chip`` the fast per-host (local) axis.
HYBRID_AXES = ("host", "chip")


class Mesh:
    """A grid of ``torch.device`` entries with one name per axis.

    ``devices`` is a device list (1-D) or a nested list / numpy array
    whose rank is ``len(axis_names)``; each entry is a ``torch.device`` or
    its string.  ``mesh.devices`` is a numpy object array of
    ``torch.device`` (read ``.shape``, ``.size``, ``.ndim``, ``.flat``).
    A device may repeat; an empty grid raises ValueError."""

    __slots__ = ("devices", "axis_names")

    def __init__(self, devices, axis_names: Sequence[str] = ("batch",)):
        names = tuple(axis_names)
        src = devices if isinstance(devices, np.ndarray) else np.array(devices, dtype=object)
        if src.ndim != len(names):
            raise ValueError(f"a {src.ndim}-D device grid needs {src.ndim} axis names, "
                             f"got {names}")
        if src.size == 0:
            raise ValueError("a mesh needs at least one device")
        grid = np.empty(src.shape, dtype=object)
        for i, d in enumerate(src.flat):
            dev = torch.device(d)
            if dev.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported mesh device {dev}")
            grid.flat[i] = dev
        self.devices = grid
        self.axis_names = names

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def _key(self) -> tuple:
        return (tuple(str(d) for d in self.devices.flat), self.devices.shape, self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices.flat]}, shape={self.shape})"


def visible_devices(device=None) -> list:
    """The devices a mesh over ``device``'s kind may hold: each visible
    card once (``torch.cuda.device_count()``; none without CUDA), or the
    one CPU device when ``device`` names the CPU.  None means the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` visible devices (all, if
    None) of ``device``'s kind (:func:`visible_devices`)."""
    devs = visible_devices(device)
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, ("batch",))


def make_hybrid_mesh(
    hosts: Optional[int] = None, chips_per_host: Optional[int] = None, device=None
) -> Mesh:
    """A ``(hosts, chips_per_host)`` mesh with the per-host axis kept
    local: the visible devices of ``device``'s kind, reshaped row by row
    into the requested grid (one process; tests pin the 2x4 grid over 8
    CPU entries).

    Defaults: one host per device, ``chips_per_host`` = the per-host
    device count.  Raises ValueError when the requested grid needs more
    devices than are visible — a topology that silently shrank must not
    masquerade as the requested one (the engine's fleet layer handles
    shrinking explicitly)."""
    devs = visible_devices(device)
    n = len(devs)
    if hosts is None and chips_per_host is None:
        hosts, chips_per_host = n, 1
    elif hosts is None:
        hosts = max(1, n // chips_per_host)
    elif chips_per_host is None:
        chips_per_host = max(1, n // hosts)
    need = hosts * chips_per_host
    if need > n:
        raise ValueError(
            f"hybrid mesh {hosts}x{chips_per_host} needs {need} devices, "
            f"only {n} visible"
        )
    grid = np.empty((hosts, chips_per_host), dtype=object)
    for i, d in enumerate(devs[:need]):
        grid.flat[i] = d
    return Mesh(grid, HYBRID_AXES)


def host_submesh(
    mesh: Mesh, host_index: int, chips: Optional[int] = None
) -> Mesh:
    """One host's device row of a hybrid mesh as a 1-D local mesh — the
    fleet dispatcher's per-host device rung dispatches whole lanes over
    this (zero cross-host traffic per lane).  ``chips`` keeps only the
    leading that-many devices of the row (the engine's chip-by-chip
    degradation rebuilds here at the largest still-healthy width).  A
    1-D mesh is its own (only) full-width row."""
    if mesh.devices.ndim == 1 and chips is None:
        return mesh
    row = mesh.devices if mesh.devices.ndim == 1 else mesh.devices[host_index]
    devs = list(row.flat)
    if chips is not None:
        devs = devs[:chips]
    return Mesh(devs, ("batch",))


def _batch_axes(mesh: Mesh):
    """The axis names the batch dimension is split over: the single name
    on a 1-D mesh, the name tuple on a hybrid mesh (the batch axis shards
    over host AND chip jointly — pure data parallelism, row-major over
    ``mesh.devices.flat``)."""
    names = tuple(mesh.axis_names)
    return names if len(names) > 1 else names[0]


def _mesh_is_cuda(mesh: Mesh) -> bool:
    return all(d.type == "cuda" for d in mesh.devices.flat)


class _Shard:
    """One shard's launch: its verdict tensor, the stream it runs on (None
    on the CPU) and the buffers that stream reads, held until read."""

    __slots__ = ("device", "out", "stream", "buffers", "verdicts")

    def __init__(self, device, out, stream, buffers):
        self.device = device
        self.out = out
        self.stream = stream
        self.buffers = buffers
        self.verdicts: Optional[list] = None


class ShardedVerdicts:
    """The handle of a sharded launch, for :func:`kernel.collect_verdicts`:
    the shards in batch order, each read after a wait on its own stream
    (not on the card as a whole).  Each shard's device inputs and pinned
    host buffers stay alive until it is read."""

    __slots__ = ("shards", "axes")

    def __init__(self, shards: list, axes):
        self.shards = shards
        self.axes = axes

    def __len__(self) -> int:
        return sum(int(sh.out.shape[0]) for sh in self.shards)

    def read(self) -> list[bool]:
        """Every lane's verdict, shard by shard, in order."""
        out: list[bool] = []
        for sh in self.shards:
            if sh.verdicts is None:
                if sh.stream is None:
                    sh.verdicts = sh.out.cpu().tolist()
                else:
                    sh.stream.synchronize()
                    with torch.cuda.device(sh.device), torch.cuda.stream(sh.stream):
                        sh.verdicts = sh.out.cpu().tolist()
                sh.buffers = None
            out.extend(sh.verdicts)
        return out

    def counts(self) -> list[int]:
        """Each shard's valid count."""
        self.read()
        return [sum(sh.verdicts) for sh in self.shards]

    def total(self) -> int:
        """The batch's valid count: the host's sum of the shards' counts
        (padding lanes are invalid, so they add nothing)."""
        return sum(self.counts())


def _launch_shard(dev: torch.device, cols: list, core, kw: dict) -> _Shard:
    """Upload one shard's columns to ``dev`` and launch ``core`` there,
    without waiting: on a card inside ``torch.cuda.device(dev)``, on a
    stream of its own, from pinned buffers."""
    if dev.type != "cuda":
        with span("verify.transfer"):
            args = from_reference(cols, dev)
        # no autograd bookkeeping: the host-bound plain program runs faster;
        # the one CPU device runs one shard at a time (shards of concurrent
        # lanes in several threads would only contend for the interpreter)
        with span("verify.kernel"), _CPU_LOCK, torch.inference_mode():
            out = core(*args, **kw)
        return _Shard(dev, out, None, args)
    stream = torch.cuda.Stream(device=dev)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        with span("verify.transfer"):
            pinned = tuple(t.pin_memory() for t in from_reference(cols, "cpu"))
            args = tuple(t.to(dev, non_blocking=True) for t in pinned)
        with span("verify.kernel"), torch.inference_mode():
            out = core(*args, **kw)
    return _Shard(dev, out, stream, (pinned, args))


_FN_CACHE: dict = {}
_CPU_LOCK = threading.Lock()


def sharded_verify_fn(
    mesh: Mesh,
    kernel: str = "auto",
    *,
    interpret: Optional[bool] = None,
    block: Optional[int] = None,
    schnorr_free: bool = False,
    point_form: str = "projective",
    reduce: str = "lazy",
    select: str,
    ladder: str,
    sqr: str,
    mul: str,
):
    """The verify step sharded over ``mesh``: called with the 16
    ``PreparedBatch.device_args`` as host arrays (batch a multiple of the
    mesh size; callers pad), it splits each along its batch axis, uploads
    and launches every shard on its device without waiting, and returns
    the :class:`ShardedVerdicts` handle.

    ``kernel``: "auto" launches the mode tuple's hand-written kernel
    (``cuda_kernel.verify_blocked``) on an all-CUDA mesh and the plain
    program elsewhere; "xla" forces the plain program (``verify_core``,
    on whatever device a shard is); "pallas" forces the hand kernel and
    raises ValueError on a mesh with a CPU entry.  ``interpret`` and
    ``block`` (the reference's Pallas interpret mode and block size) have
    no counterpart and raise ValueError.

    ``schnorr_free``: an ECDSA-only batch may launch the variant without
    the acceptance pows, exactly like the single-card dispatch — callers
    must derive it from ``PreparedBatch.schnorr_free`` (a wrong True would
    accept jacobi/parity forgeries).  The plain program runs the full
    checks, so it ignores the flag.  The modes (``point_form``,
    ``reduce``, ``select``, ``ladder``, ``sqr``, ``mul``) are passed to
    every shard's launch; the window width comes from the digit rows.
    Cached per mesh, program, variant and modes."""
    if kernel not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown kernel {kernel!r}: auto|pallas|xla")
    if interpret is not None or block is not None:
        raise ValueError("interpret= and block= are the reference's Pallas options: "
                         "the port has no counterpart")
    on_cards = _mesh_is_cuda(mesh)
    if kernel == "pallas" and not on_cards:
        raise ValueError(f"the hand-written kernel runs on cards only, not on {mesh}")
    use_kernel = kernel == "pallas" or (kernel == "auto" and on_cards)
    schnorr_free = bool(schnorr_free) and use_kernel
    modes = (point_form, reduce, select, ladder, sqr, mul)
    key = (mesh, use_kernel, schnorr_free, modes)
    cached = _FN_CACHE.get(key)
    if cached is not None:
        return cached
    kw = dict(schnorr_free=schnorr_free, point_form=point_form, reduce=reduce,
              select=select, ladder=ladder, sqr=sqr, mul=mul)
    core = cuda_kernel.verify_blocked if use_kernel else verify_core
    n = mesh.size
    axes = _batch_axes(mesh)

    def step(*args) -> ShardedVerdicts:
        arrays = [np.asarray(a) for a in args]
        b = arrays[8].shape[-1]
        if b % n:
            raise ValueError(f"batch {b} is not a multiple of the mesh's {n} devices")
        per = b // n
        shards = [
            _launch_shard(dev, [a[..., i * per:(i + 1) * per] for a in arrays], core, kw)
            for i, dev in enumerate(mesh.devices.flat)
        ]
        return ShardedVerdicts(shards, axes)

    _FN_CACHE[key] = step
    return step


def _mesh_quantum(mesh: Mesh) -> int:
    """Per-batch size quantum: a multiple of the mesh size (the kernel
    takes any lane count a shard)."""
    return mesh.size


def dispatch_raw_sharded(
    raw, mesh: Mesh, pad_to: Optional[int] = None, kernel: str = "auto", *,
    window_bits: int = WINDOW_BITS, point_form: str = "projective", reduce: str = "lazy",
    select: str, ladder: str, sqr: str, mul: str,
) -> tuple:
    """ASYNC sharded dispatch of a packed RawBatch: host prep once at a
    mesh-aligned shape (the native ``secp_prepare_batch``), the rows split
    per shard, each shard uploaded and launched on its device and stream.
    Returns the ``(ShardedVerdicts, count)`` handle — collect with
    :func:`kernel.collect_verdicts`; the caller can prep the next lane
    while this one computes, exactly like the single-card
    :func:`kernel.dispatch_batch_gpu_raw`.

    This is the engine's mesh rung (``VerifyConfig.mesh_devices``) and a
    fleet host's rung over its row: a packed full lane shards across
    cards with zero inter-card traffic in the hot loop.  A shard whose
    launch fails raises."""
    from .raw import as_raw_batch

    raw = as_raw_batch(raw)
    quantum = _mesh_quantum(mesh)
    size = max(pad_to or 0, len(raw), 1)
    size = (size + quantum - 1) // quantum * quantum
    with span("verify.prepare"):
        prep = prepare_batch_raw(raw, pad_to=size, window_bits=window_bits)
    fn = sharded_verify_fn(mesh, kernel, schnorr_free=prep.schnorr_free,
                           point_form=point_form, reduce=reduce, select=select,
                           ladder=ladder, sqr=sqr, mul=mul)
    return fn(*prep.device_args), prep.count


def verify_batch_sharded(
    items: Sequence[tuple[Optional[Point], int, int, int]],
    mesh: Optional[Mesh] = None,
    pad_to: Optional[int] = None, *,
    window_bits: int = WINDOW_BITS, point_form: str = "projective", reduce: str = "lazy",
    select: str, ladder: str, sqr: str, mul: str,
) -> list[bool]:
    """End-to-end multi-card verify: host prep in Python, shard over the
    mesh (all visible cards if None), run, read back.

    Pads the batch to a multiple of the mesh size (lanes padded with
    ``host_valid=False`` are rejected for free)."""
    if not items:
        return []
    mesh = mesh or make_mesh()
    quantum = _mesh_quantum(mesh)
    size = pad_to or len(items)
    size = max(size, len(items))
    size = (size + quantum - 1) // quantum * quantum
    prep = prepare_batch(items, pad_to=size, window_bits=window_bits)
    # schnorr_free from the host prep flags (the one safe derivation —
    # kernel.PreparedBatch): an ECDSA-only sharded batch sheds the
    # acceptance pows exactly like the single-card dispatch
    fn = sharded_verify_fn(mesh, schnorr_free=prep.schnorr_free, point_form=point_form,
                           reduce=reduce, select=select, ladder=ladder, sqr=sqr, mul=mul)
    return collect_verdicts(fn(*prep.device_args), prep.count)
