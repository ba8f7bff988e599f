"""Batch verification engine: the queue between ingest and the card.

Ingest submits verify items — ``(pubkey, z, r, s)`` ECDSA tuples or
5-tuples tagged ``"schnorr"`` / ``"bip340"`` — or packed
:class:`~tpunode_torch.verify.raw.RawBatch` rows.  The engine verifies them
on one device in fixed-shape chunks:

* work is cut into chunks of ``device_batch`` lanes; a chunk no longer than
  ``batch_size`` is padded to ``batch_size`` instead of a mostly empty
  ``device_batch``;
* each chunk is host-prepped, uploaded and launched without waiting (the
  launch is asynchronous on the current stream), so chunk N+1's host prep
  runs while chunk N computes; the verdicts are read back at the end;
* async submissions coalesce: a runner task lingers up to ``max_wait`` for
  a fuller lane, then verifies everything queued in a worker thread.

The device is the card unless the config names the CPU (``device="cpu"``,
which runs the kernel's plain version); with no card the engine raises.
The window width (``window_bits``, 4 or 5) is the engine's own: it preps
every chunk at it, and the digit rows carry it to the kernel.  So are the
point form (``point_form``, "projective" or "affine"), the reduction of
the point formulas (``field_reduce``, "lazy" or "eager"), the square
(``field_sqr``, "half" or the full-product "mul") and the multiply
(``field_mul``, "shift_add" or "dot_general": every convolution contracted
on the tensor cores), which every dispatch passes to the kernel.  The
table select ("tree" or "onehot") and the pow ladders' form ("scan" or
"unroll") have no config field, as in the reference: the engine reads the ``TPUNODE_SELECT16`` and
``TPUNODE_POW_LADDER`` knobs once, at construction, keeps them as
:attr:`VerifyEngine.select` and :attr:`VerifyEngine.ladder` and passes them
to every dispatch; a later change of the environment does not reach a
built engine.  On the CPU the ladder is the plain program's; the CUDA
kernel runs its one ladder form under both, as the reference's Pallas
kernel does.  Warmup builds the
kernel, runs both shapes in the engine's modes and holds 8
mixed-algorithm verdicts against the oracle, raising on any mismatch.  A
failure anywhere on the path raises to the caller; there is no CPU
fallback.
"""

from __future__ import annotations

import asyncio
import contextlib
import time
from dataclasses import dataclass
from typing import Optional, Sequence

from .ecdsa_cpu import (
    CURVE_N,
    GENERATOR,
    bip340_challenge,
    lift_x,
    point_mul,
    schnorr_challenge,
    sign,
    sign_bip340,
    sign_schnorr,
    verify_batch_cpu,
)
from .curve import check_point_form, point_form
from .field import check_mul, check_reduce, check_sqr, mul_mode, reduce_mode, sqr_mode
from .kernel import (
    collect_verdicts,
    dispatch_batch_gpu_raw,
    kernel_modes,
    pow_ladder_mode,
    resolve_device,
    select_mode,
)
from .raw import RawBatch, as_raw_batch, concat_raw, pack_items
from .width import window_bits, windows
from ..trace import span

__all__ = ["VerifyConfig", "VerifyEngine", "warmup_items"]


@dataclass
class VerifyConfig:
    """Engine knobs; the defaults are the reference engine's."""

    batch_size: int = 4096  # small device shape: tails pad to it
    device_batch: int = 32768  # steady-state device shape: work is chunked at it
    max_wait: float = 0.025  # seconds an async submission lingers for a fuller lane
    warmup: bool = True  # build the kernel and cross-check at construction
    device: Optional[str] = None  # None = the card; "cpu" = the plain version
    window_bits: Optional[int] = None  # 4 or 5; None = TPUNODE_WINDOW_BITS, else 4
    # "projective" or "affine"; None = TPUNODE_POINT_FORM, else "projective"
    point_form: Optional[str] = None
    # "lazy" or "eager"; None = TPUNODE_FIELD_REDUCE, else "lazy"
    field_reduce: Optional[str] = None
    # "half" or "mul"; None = TPUNODE_FIELD_SQR, else "half"
    field_sqr: Optional[str] = None
    # "shift_add" or "dot_general"; None = TPUNODE_FIELD_MUL, else "shift_add"
    field_mul: Optional[str] = None

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.window_bits is None:
            self.window_bits = window_bits()
        windows(self.window_bits)  # raises ValueError unless 4 or 5
        if self.point_form is None:
            self.point_form = point_form()
        check_point_form(self.point_form)
        if self.field_reduce is None:
            self.field_reduce = reduce_mode()
        check_reduce(self.field_reduce)
        if self.field_sqr is None:
            self.field_sqr = sqr_mode()
        check_sqr(self.field_sqr)
        if self.field_mul is None:
            self.field_mul = mul_mode()
        check_mul(self.field_mul)
        if self.device_batch < self.batch_size:
            self.device_batch = self.batch_size


def warmup_items() -> tuple[list[tuple], list[bool]]:
    """8 items over all three algorithms, every third one corrupted, with
    the verdicts the oracle gives them."""
    items = []
    for i in range(8):
        priv = (0xA11CE + i) % CURVE_N
        pub = point_mul(priv, GENERATOR)
        z = (0xD00D << i) % CURVE_N
        if i % 4 == 1:
            r, s = sign_schnorr(priv, z, 0xC0FFEE + i)
            z ^= 1 if i % 3 == 2 else 0
            items.append((pub, schnorr_challenge(r, pub, z), r, s, "schnorr"))
        elif i % 4 == 3:
            r, s = sign_bip340(priv, z, 0xC0FFEE + i)
            z ^= 1 if i % 3 == 2 else 0
            items.append((lift_x(pub.x), bip340_challenge(r, pub.x, z), r, s, "bip340"))
        else:
            r, s = sign(priv, z, 0xC0FFEE + i)
            z ^= 1 if i % 3 == 2 else 0
            items.append((pub, z, r, s))
    return items, verify_batch_cpu(items)


class VerifyEngine:
    """Submit items, get verdicts.

    Usage::

        engine = VerifyEngine(VerifyConfig())
        ok = engine.verify_sync(items)        # list[bool]
        async with engine:
            ok = await engine.verify(items)
    """

    def __init__(self, cfg: Optional[VerifyConfig] = None):
        self.cfg = cfg or VerifyConfig()
        self.select = select_mode()  # the knobs', read once
        self.ladder = pow_ladder_mode()
        self.modes()  # a knob value that names no mode raises here
        self.device = resolve_device(self.cfg.device)
        self._pending: list = []  # (RawBatch, future, enqueue time), oldest first
        self._kick: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        if self.cfg.warmup:
            self.warmup()

    def modes(self) -> tuple:
        """The engine's mode tuple (``kernel.kernel_modes``): its width,
        point form, reduction, select, ladder, square and multiply."""
        return kernel_modes(self.cfg.window_bits, self.cfg.point_form, self.cfg.field_reduce,
                            self.select, self.ladder, self.cfg.field_sqr, self.cfg.field_mul)

    def _dispatch(self, raw: RawBatch, pad: int) -> tuple:
        return dispatch_batch_gpu_raw(raw, pad_to=pad, device=self.device,
                                      window_bits=self.cfg.window_bits,
                                      point_form=self.cfg.point_form,
                                      reduce=self.cfg.field_reduce, select=self.select,
                                      ladder=self.ladder, sqr=self.cfg.field_sqr,
                                      mul=self.cfg.field_mul)

    def warmup(self) -> None:
        """Build the kernel, run both device shapes in the engine's modes,
        and hold the 8 warmup verdicts against the oracle; raises
        RuntimeError on a mismatch."""
        items, expect = warmup_items()
        raw = pack_items(items)
        for shape in dict.fromkeys((self.cfg.batch_size, self.cfg.device_batch)):
            got = collect_verdicts(*self._dispatch(raw, shape))
            if got != expect:
                raise RuntimeError(
                    f"warmup verdicts at batch {shape} disagree with the oracle: "
                    f"{got} != {expect}"
                )

    # -- synchronous API ------------------------------------------------------

    def verify_sync(self, items: Sequence[tuple]) -> list[bool]:
        """Blocking verification of verify item tuples."""
        return self._run_gpu(self._pack(items))

    def verify_raw_sync(self, raw) -> list[bool]:
        """Blocking verification of a packed batch."""
        return self._run_gpu(as_raw_batch(raw))

    @staticmethod
    def _pack(items: Sequence[tuple]) -> RawBatch:
        with span("verify.pack"):
            return pack_items(items)

    def _run_gpu(self, raw: RawBatch) -> list[bool]:
        """Chunk at ``device_batch``, pad short chunks to ``batch_size``,
        launch every chunk before reading any verdict back."""
        big, small = self.cfg.device_batch, self.cfg.batch_size
        pending = []
        for lo in range(0, len(raw), big):
            chunk = raw.slice(lo, lo + big)
            pad = big if len(chunk) > small else small
            pending.append(self._dispatch(chunk, pad))
        out: list[bool] = []
        for handle in pending:
            out.extend(collect_verdicts(*handle))
        return out

    # -- async coalescing queue -----------------------------------------------

    async def __aenter__(self) -> "VerifyEngine":
        self._kick = asyncio.Event()
        self._task = asyncio.create_task(self._run(), name="verify-engine")
        return self

    async def __aexit__(self, *exc) -> None:
        self._kick = None
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
            self._task = None
        for _, fut, _ in self._pending:
            fut.cancel()
        self._pending.clear()

    async def verify(self, items: Sequence[tuple]) -> list[bool]:
        """Queue verify item tuples; resolves with their verdicts."""
        return await self._enqueue(self._pack(items))

    async def verify_raw(self, raw) -> list[bool]:
        """Queue a packed batch; resolves with its verdicts."""
        return await self._enqueue(as_raw_batch(raw))

    async def _enqueue(self, raw: RawBatch) -> list[bool]:
        if not len(raw):
            return []
        if self._kick is None:
            raise RuntimeError("engine not started: use `async with engine`")
        fut = asyncio.get_running_loop().create_future()
        self._pending.append((raw, fut, time.monotonic()))
        self._kick.set()
        return await fut

    async def _run(self) -> None:
        """Linger until a full lane is queued or the oldest submission has
        waited ``max_wait``, then verify everything queued in a worker
        thread and resolve each submission with its own slice."""
        while True:
            while not self._pending:
                self._kick.clear()
                await self._kick.wait()
            while sum(len(r) for r, _, _ in self._pending) < self.cfg.device_batch:
                remain = self._pending[0][2] + self.cfg.max_wait - time.monotonic()
                if remain <= 0:
                    break
                self._kick.clear()
                with contextlib.suppress(asyncio.TimeoutError):
                    await asyncio.wait_for(self._kick.wait(), timeout=remain)
            batch, self._pending = self._pending, []
            try:
                verdicts = await asyncio.to_thread(
                    self._run_gpu, concat_raw([r for r, _, _ in batch])
                )
            except asyncio.CancelledError:
                for _, fut, _ in batch:
                    fut.cancel()
                raise
            except Exception as e:  # noqa: BLE001 — delivered to every waiter
                for _, fut, _ in batch:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            lo = 0
            for raw, fut, _ in batch:
                if not fut.done():
                    fut.set_result(verdicts[lo : lo + len(raw)])
                lo += len(raw)
