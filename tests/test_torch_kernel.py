"""The port's verify program against the reference's Pallas kernel.

One mixed batch — ECDSA (valid, z = 0, bad s, R at infinity, the r+n
path), BCH Schnorr and BIP340 with their jacobi/parity twins, pubkeys off
the curve or missing, out-of-range scalars — goes through the reference's
``pallas_kernel.verify_blocked`` in interpret mode once, then through the
port's plain ``verify_blocked`` and through the whole engine slice on the
CPU.  The verdicts must be identical (booleans: tolerance zero).  The CUDA
kernel itself is held against the plain version in test_torch_cuda.py.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from benchmarks.campaign import build_pool
from tpunode.verify import ecdsa_cpu as RO
from tpunode.verify import kernel as RK
from tpunode.verify.pallas_kernel import verify_blocked as ref_verify_blocked
from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

LANES = 16


@pytest.fixture(scope="module")
def batch():
    """(items, prepared batch, the reference kernel's verdicts): the
    reference runs once, in interpret mode (about a minute on a CPU)."""
    items = chip_smoke.adversarial_items(O, random.Random(0xBA7C), lanes=LANES)
    prep = K.prepare_batch_raw(pack_items(items), pad_to=LANES)
    ref_prep = RK.prepare_batch(items, pad_to=LANES, native=False)
    out = ref_verify_blocked(*(jnp.asarray(a) for a in ref_prep.device_args),
                             interpret=True, block=8)
    return items, prep, [bool(v) for v in np.asarray(out)]


def test_batch_covers_every_lane_kind(batch):
    items, prep, ref = batch
    expect = O.verify_batch_cpu(items)
    assert ref == expect
    assert {it[4] for it in items if len(it) == 5} == {"schnorr", "bip340"}
    assert prep.r2_valid.any() and not prep.host_valid.all()
    assert any(expect) and not all(expect)


def test_plain_verify_blocked_matches_reference_kernel(batch):
    _, prep, ref = batch
    launches = dict(cuda_kernel.LAUNCHES)
    args = K.from_reference(prep.device_args, "cpu")
    got = cuda_kernel.verify_blocked(*args, schnorr_free=prep.schnorr_free, select="tree",
                                     ladder="scan", sqr="half", mul="shift_add")
    assert got.dtype == torch.bool and got.tolist() == ref
    assert cuda_kernel.LAUNCHES == launches  # a CPU tensor never reaches the kernel


def test_engine_slice_matches_reference_kernel(batch):
    items, _, ref = batch
    engine = VerifyEngine(VerifyConfig(device="cpu", warmup=False,
                                       batch_size=LANES, device_batch=LANES))
    assert engine.verify_sync(items) == ref
    assert engine.verify_raw_sync(pack_items(items)) == ref


def test_schnorr_free_variant_matches_full_on_ecdsa_lanes(batch):
    items, _, _ = batch
    ecdsa = [it for it in items if len(it) == 4][:8]
    prep = K.prepare_batch(ecdsa)
    assert prep.schnorr_free
    args = K.from_reference(prep.device_args, "cpu")
    pruned = cuda_kernel.verify_blocked(*args, schnorr_free=True, select="tree", ladder="scan", sqr="half",
                                        mul="shift_add")
    full = cuda_kernel.verify_blocked(*args, schnorr_free=False, select="tree", ladder="scan", sqr="half",
                                      mul="shift_add")
    assert pruned.tolist() == full.tolist() == O.verify_batch_cpu(ecdsa)


def test_wrapper_rejects_malformed_arguments(batch):
    _, prep, _ = batch
    args = list(K.from_reference(prep.device_args, "cpu"))
    with pytest.raises(ValueError):
        cuda_kernel.verify_blocked(*args[:-1], schnorr_free=False, select="tree", ladder="scan", sqr="half",
                                   mul="shift_add")
    bad = list(args)
    bad[8] = bad[8].to(torch.int64)
    with pytest.raises(ValueError):
        cuda_kernel.verify_blocked(*bad, schnorr_free=False, select="tree", ladder="scan", sqr="half",
                                   mul="shift_add")
    bad = list(args)
    bad[0] = bad[0][:-1]
    with pytest.raises(ValueError):
        cuda_kernel.verify_blocked(*bad, schnorr_free=False, select="tree", ladder="scan", sqr="half",
                                   mul="shift_add")


def _campaign(n_base: int, batch_size: int) -> None:
    items, shapes, expects = build_pool(n_base, random.Random(0xCA4))
    engine = VerifyEngine(VerifyConfig(device="cpu", warmup=False,
                                       batch_size=batch_size, device_batch=batch_size))
    got = engine.verify_sync(items)
    want = RO.verify_batch_cpu(items)
    bad = [(s, g, w) for s, g, w in zip(shapes, got, want) if g != w]
    assert not bad, bad[:5]
    assert got == expects


def test_campaign_slice_matches_reference_oracle():
    _campaign(3, 32)


@pytest.mark.slow  # the full adversarial pool through the plain program (minutes)
def test_campaign_full_pool_matches_reference_oracle():
    _campaign(256, 512)
