"""The hand-written CUDA kernels on a card (marker ``gpu``): the verify
kernel in both point forms, both reductions and both table selects, and the
nine probe cases of ``tpunode_torch.cuda_diag``.

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
    got = cuda_kernel.verify_blocked(*args, schnorr_free=prep.schnorr_free, select="tree")
    launches[(window_bits, "projective", "lazy", "tree",
              "schnorr_free" if ecdsa_only else "full")] += 1
    assert cuda_kernel.LAUNCHES == launches
    plain = K.verify_core(*args, schnorr_free=prep.schnorr_free, select="tree")
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
    got = cuda_kernel.verify_blocked(*args, schnorr_free=ecdsa_only, point_form="affine",
                                     select="tree")
    launches[(window_bits, "affine", "lazy", "tree", "schnorr_free" if ecdsa_only else "full")] += 1
    assert cuda_kernel.LAUNCHES == launches
    plain = K.verify_core(*args, schnorr_free=ecdsa_only, point_form="affine", select="tree")
    projective = cuda_kernel.verify_blocked(*args, schnorr_free=ecdsa_only, select="tree")
    assert got.device.type == "cuda" and got.dtype == torch.bool
    assert got.tolist() == plain.tolist() == projective.tolist() == O.verify_batch_cpu(items)


@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
@pytest.mark.parametrize("ecdsa_only", [False, True], ids=["full", "schnorr_free"])
def test_eager_kernel_matches_plain_version_and_oracle(items, ecdsa_only, window_bits,
                                                       point_form):
    if ecdsa_only:
        items = [it for it in items if len(it) == 4]
    prep = K.prepare_batch_raw(pack_items(items), pad_to=len(items), window_bits=window_bits)
    assert prep.schnorr_free == ecdsa_only
    args = K.from_reference(prep.device_args, "cuda")
    launches = dict(cuda_kernel.LAUNCHES)
    got = cuda_kernel.verify_blocked(*args, schnorr_free=ecdsa_only, point_form=point_form,
                                     reduce="eager", select="tree")
    launches[(window_bits, point_form, "eager", "tree",
              "schnorr_free" if ecdsa_only else "full")] += 1
    assert cuda_kernel.LAUNCHES == launches
    plain = K.verify_core(*args, schnorr_free=ecdsa_only, point_form=point_form, reduce="eager",
                          select="tree")
    lazy = cuda_kernel.verify_blocked(*args, schnorr_free=ecdsa_only, point_form=point_form,
                                      select="tree")
    assert got.device.type == "cuda" and got.dtype == torch.bool
    assert got.tolist() == plain.tolist() == lazy.tolist() == O.verify_batch_cpu(items)


@pytest.fixture(scope="module")
def items512(items):
    return chip_smoke.adversarial_items(O, random.Random(0x0E512), lanes=512)


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
@pytest.mark.parametrize("ecdsa_only", [False, True], ids=["full", "schnorr_free"])
def test_onehot_kernel_matches_plain_version_and_oracle(items512, ecdsa_only, window_bits,
                                                        point_form, reduce):
    """Each one-hot instantiation on 512 adversarial lanes against its own
    plain version (the one-hot select), its tree twin and the oracle."""
    items = items512
    if ecdsa_only:
        items = chip_smoke.tile([it for it in items if len(it) == 4], 512)
    prep = K.prepare_batch_raw(pack_items(items), pad_to=len(items), window_bits=window_bits)
    assert prep.schnorr_free == ecdsa_only
    args = K.from_reference(prep.device_args, "cuda")
    launches = dict(cuda_kernel.LAUNCHES)
    got = cuda_kernel.verify_blocked(*args, schnorr_free=ecdsa_only, point_form=point_form,
                                     reduce=reduce, select="onehot")
    launches[(window_bits, point_form, reduce, "onehot",
              "schnorr_free" if ecdsa_only else "full")] += 1
    assert cuda_kernel.LAUNCHES == launches
    plain = K.verify_core(*args, schnorr_free=ecdsa_only, point_form=point_form, reduce=reduce,
                          select="onehot")
    tree = cuda_kernel.verify_blocked(*args, schnorr_free=ecdsa_only, point_form=point_form,
                                      reduce=reduce, select="tree")
    assert got.device.type == "cuda" and got.dtype == torch.bool
    assert got.tolist() == plain.tolist() == tree.tolist() == O.verify_batch_cpu(items)


@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
def test_onehot_engine_on_card_matches_oracle(items, monkeypatch, window_bits):
    """An engine built under TPUNODE_SELECT16=onehot launches the one-hot
    instantiation."""
    monkeypatch.setenv("TPUNODE_SELECT16", "onehot")
    engine = VerifyEngine(VerifyConfig(batch_size=64, device_batch=128, window_bits=window_bits))
    monkeypatch.delenv("TPUNODE_SELECT16")
    launches = dict(cuda_kernel.LAUNCHES)
    assert engine.verify_sync(items) == O.verify_batch_cpu(items)
    launches[(window_bits, "projective", "lazy", "onehot", "full")] += 2
    assert cuda_kernel.LAUNCHES == launches


@pytest.mark.parametrize("probe", cuda_diag.PROBES)
def test_probe_kernel_matches_plain_version_and_host_check(items, probe):
    inputs = cuda_diag.probe_inputs(probe, "cuda")
    launches = dict(cuda_diag.LAUNCHES)
    got = getattr(cuda_diag, probe)(*inputs)
    launches[probe] += 1
    assert cuda_diag.LAUNCHES == launches
    plain = cuda_diag.FUNCTIONS[probe][1](*inputs)
    assert got.device.type == "cuda" and torch.equal(got, plain)
    assert cuda_diag.run_probe(probe, "cuda")["bad_lanes"] == 0


def test_kernel_rejects_malformed_arguments_on_card(items):
    prep = K.prepare_batch_raw(pack_items(items[:8]))
    args = list(K.from_reference(prep.device_args, "cuda"))
    args[9] = args[9].cpu()
    with pytest.raises(ValueError):
        cuda_kernel.verify_blocked(*args, schnorr_free=False, select="tree")


def test_launcher_refuses_a_width_it_lacks(items):
    import ctypes

    prep = K.prepare_batch_raw(pack_items(items[:8]))
    args = K.from_reference(prep.device_args, "cuda")
    out = torch.empty(8, dtype=torch.bool, device="cuda")
    ptrs = [ctypes.c_void_p(t.data_ptr())
            for t in (cuda_kernel._g_tables(out.device, 4), *args, out)]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    lib = cuda_kernel._load()
    # no such width; no such form; no such reduce; no such select
    for window_bits, point_form, reduce, select in ((6, 0, 0, 0), (4, 2, 0, 0), (4, 0, 2, 0),
                                                    (4, 0, 0, 2)):
        err = lib.tpn_verify_blocked(*ptrs, 8, 0, window_bits, point_form, reduce, select,
                                     stream)
        assert err != 0 and b"invalid" in lib.tpn_error_string(err)


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
def test_engine_on_card_matches_oracle(items, window_bits, point_form, reduce):
    engine = VerifyEngine(VerifyConfig(batch_size=64, device_batch=128, window_bits=window_bits,
                                       point_form=point_form, field_reduce=reduce))
    launches = dict(cuda_kernel.LAUNCHES)
    assert engine.verify_sync(items) == O.verify_batch_cpu(items)
    # 128 + a 72-item tail padded to 128
    launches[(window_bits, point_form, reduce, engine.select, "full")] += 2
    assert cuda_kernel.LAUNCHES == launches


def test_launch_on_a_card_that_is_not_the_current_one(items):
    """The wrappers make the tensors' card current around the launch: with
    card 0 current, a batch on card 1 runs on card 1 and card 0 stays
    current.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the batch must lie on one that is not current")
    prep = K.prepare_batch_raw(pack_items(items), pad_to=len(items))
    args = K.from_reference(prep.device_args, "cuda:1")
    torch.cuda.set_device(0)
    got = cuda_kernel.verify_blocked(*args, schnorr_free=prep.schnorr_free, reduce="eager",
                                     select="tree")
    assert got.device == torch.device("cuda:1") and torch.cuda.current_device() == 0
    assert got.tolist() == O.verify_batch_cpu(items)
    inputs = cuda_diag.probe_inputs("field_mul", "cuda:1")
    out = cuda_diag.field_mul(*inputs)
    assert torch.cuda.current_device() == 0
    assert torch.equal(out.cpu(), cuda_diag.field_mul_plain(*(t.cpu() for t in inputs)))
