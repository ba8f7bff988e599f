"""The hand-written CUDA verify kernel on a card (marker ``gpu``).

The kernel has no CPU mode, so these tests skip without a card; on a card
run ``python -m pytest -m gpu tests/test_torch_cuda.py``.  They import
neither jax nor the reference package, so they run where only the port's
dependencies are installed.  Verdicts are booleans: tolerance zero.
"""

import random

import pytest
import torch

import chip_smoke
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


@pytest.mark.parametrize("ecdsa_only", [False, True], ids=["full", "schnorr_free"])
def test_kernel_matches_plain_version_and_oracle(items, ecdsa_only):
    if ecdsa_only:
        items = [it for it in items if len(it) == 4]
    prep = K.prepare_batch_raw(pack_items(items), pad_to=len(items))
    assert prep.schnorr_free == ecdsa_only
    args = K.from_reference(prep.device_args, "cuda")
    launches = cuda_kernel.LAUNCHES
    got = cuda_kernel.verify_blocked(*args, schnorr_free=prep.schnorr_free)
    assert cuda_kernel.LAUNCHES == launches + 1
    plain = K.verify_core(*args, schnorr_free=prep.schnorr_free)
    assert got.device.type == "cuda" and got.dtype == torch.bool
    assert got.tolist() == plain.tolist() == O.verify_batch_cpu(items)


def test_kernel_rejects_malformed_arguments_on_card(items):
    prep = K.prepare_batch_raw(pack_items(items[:8]))
    args = list(K.from_reference(prep.device_args, "cuda"))
    args[9] = args[9].cpu()
    with pytest.raises(ValueError):
        cuda_kernel.verify_blocked(*args, schnorr_free=False)


def test_engine_on_card_matches_oracle(items):
    engine = VerifyEngine(VerifyConfig(batch_size=64, device_batch=128))
    launches = cuda_kernel.LAUNCHES
    assert engine.verify_sync(items) == O.verify_batch_cpu(items)
    assert cuda_kernel.LAUNCHES == launches + 2  # 128 + a 72-item tail padded to 128
