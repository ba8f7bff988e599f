"""The hand-written CUDA kernels on a card (marker ``gpu``): the verify
kernel in both point forms and the two probes of ``tpunode_torch.cuda_diag``.

The kernels have no CPU mode, so these tests skip without a card; on a card
run ``python -m pytest -m gpu tests/test_torch_cuda.py``.  They import
neither jax nor the reference package, so they run where only the port's
dependencies are installed.  Verdicts are booleans and limbs integers:
tolerance zero.
"""

import random

import pytest
import torch

import chip_smoke
from tpunode_torch import cuda_diag
from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine
from tpunode_torch.verify.raw import pack_items

pytestmark = pytest.mark.gpu

LANES = 200  # not a multiple of the 128-thread block: the ragged edge is masked


@pytest.fixture(scope="module")
def items():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return chip_smoke.adversarial_items(O, random.Random(0xCDA), lanes=LANES)


@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
@pytest.mark.parametrize("ecdsa_only", [False, True], ids=["full", "schnorr_free"])
def test_kernel_matches_plain_version_and_oracle(items, ecdsa_only, window_bits):
    if ecdsa_only:
        items = [it for it in items if len(it) == 4]
    prep = K.prepare_batch_raw(pack_items(items), pad_to=len(items), window_bits=window_bits)
    assert prep.schnorr_free == ecdsa_only and prep.window_bits == window_bits
    args = K.from_reference(prep.device_args, "cuda")
    launches = dict(cuda_kernel.LAUNCHES)
    got = cuda_kernel.verify_blocked(*args, schnorr_free=prep.schnorr_free)
    launches[(window_bits, "projective", "schnorr_free" if ecdsa_only else "full")] += 1
    assert cuda_kernel.LAUNCHES == launches
    plain = K.verify_core(*args, schnorr_free=prep.schnorr_free)
    assert got.device.type == "cuda" and got.dtype == torch.bool
    assert got.tolist() == plain.tolist() == O.verify_batch_cpu(items)


@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
@pytest.mark.parametrize("ecdsa_only", [False, True], ids=["full", "schnorr_free"])
def test_affine_kernel_matches_plain_version_and_oracle(items, ecdsa_only, window_bits):
    if ecdsa_only:
        items = [it for it in items if len(it) == 4]
    prep = K.prepare_batch_raw(pack_items(items), pad_to=len(items), window_bits=window_bits)
    assert prep.schnorr_free == ecdsa_only
    args = K.from_reference(prep.device_args, "cuda")
    launches = dict(cuda_kernel.LAUNCHES)
    got = cuda_kernel.verify_blocked(*args, schnorr_free=ecdsa_only, point_form="affine")
    launches[(window_bits, "affine", "schnorr_free" if ecdsa_only else "full")] += 1
    assert cuda_kernel.LAUNCHES == launches
    plain = K.verify_core(*args, schnorr_free=ecdsa_only, point_form="affine")
    projective = cuda_kernel.verify_blocked(*args, schnorr_free=ecdsa_only)
    assert got.device.type == "cuda" and got.dtype == torch.bool
    assert got.tolist() == plain.tolist() == projective.tolist() == O.verify_batch_cpu(items)


@pytest.mark.parametrize("probe", cuda_diag.PROBES)
def test_probe_kernel_matches_plain_version_and_host_check(items, probe):
    inputs = cuda_diag.probe_inputs(probe, "cuda")
    launches = dict(cuda_diag.LAUNCHES)
    got = getattr(cuda_diag, probe)(*inputs)
    launches[probe] += 1
    assert cuda_diag.LAUNCHES == launches
    plain = getattr(cuda_diag, f"{probe}_plain")(*inputs)
    assert got.device.type == "cuda" and torch.equal(got, plain)
    assert cuda_diag.run_probe(probe, "cuda")["bad_lanes"] == 0


def test_kernel_rejects_malformed_arguments_on_card(items):
    prep = K.prepare_batch_raw(pack_items(items[:8]))
    args = list(K.from_reference(prep.device_args, "cuda"))
    args[9] = args[9].cpu()
    with pytest.raises(ValueError):
        cuda_kernel.verify_blocked(*args, schnorr_free=False)


def test_launcher_refuses_a_width_it_lacks(items):
    import ctypes

    prep = K.prepare_batch_raw(pack_items(items[:8]))
    args = K.from_reference(prep.device_args, "cuda")
    out = torch.empty(8, dtype=torch.bool, device="cuda")
    ptrs = [ctypes.c_void_p(t.data_ptr())
            for t in (cuda_kernel._g_tables(out.device, 4), *args, out)]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    lib = cuda_kernel._load()
    for window_bits, point_form in ((6, 0), (4, 2)):  # no such width; no such form
        err = lib.tpn_verify_blocked(*ptrs, 8, 0, window_bits, point_form, stream)
        assert err != 0 and b"invalid" in lib.tpn_error_string(err)


@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
def test_engine_on_card_matches_oracle(items, window_bits, point_form):
    engine = VerifyEngine(VerifyConfig(batch_size=64, device_batch=128, window_bits=window_bits,
                                       point_form=point_form))
    launches = dict(cuda_kernel.LAUNCHES)
    assert engine.verify_sync(items) == O.verify_batch_cpu(items)
    launches[(window_bits, point_form, "full")] += 2  # 128 + a 72-item tail padded to 128
    assert cuda_kernel.LAUNCHES == launches
