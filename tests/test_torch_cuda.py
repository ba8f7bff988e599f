"""The hand-written CUDA kernels on a card (marker ``gpu``): the verify
kernel in both point forms, both reductions, both table selects, both
squares and both multiplies (the dot_general instantiations at ragged lane
counts), the launch key of the unrolled ladders, and the thirteen probe cases
of ``tpunode_torch.cuda_diag``, the tensor-core contraction of
``field_mul_dot`` at ragged lane counts among them.

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


def _ready(**cfg) -> VerifyEngine:
    """An engine whose warmup has ended, so that its launches are not
    counted as the test's."""
    engine = VerifyEngine(VerifyConfig(**cfg))
    assert engine.wait_warmup(600) == "ready", engine.stats()["device_error"]
    return engine


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
    got = cuda_kernel.verify_blocked(*args, schnorr_free=prep.schnorr_free, select="tree",
                                     ladder="scan", sqr="half", mul="shift_add")
    launches[(window_bits, "projective", "lazy", "tree", "scan", "half", "shift_add",
              "schnorr_free" if ecdsa_only else "full")] += 1
    assert cuda_kernel.LAUNCHES == launches
    plain = K.verify_core(*args, schnorr_free=prep.schnorr_free, select="tree", ladder="scan", sqr="half",
                          mul="shift_add")
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
                                     select="tree", ladder="scan", sqr="half", mul="shift_add")
    launches[(window_bits, "affine", "lazy", "tree", "scan", "half", "shift_add",
              "schnorr_free" if ecdsa_only else "full")] += 1
    assert cuda_kernel.LAUNCHES == launches
    plain = K.verify_core(*args, schnorr_free=ecdsa_only, point_form="affine", select="tree",
                          ladder="scan", sqr="half", mul="shift_add")
    projective = cuda_kernel.verify_blocked(*args, schnorr_free=ecdsa_only, select="tree",
                                            ladder="scan", sqr="half", mul="shift_add")
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
                                     reduce="eager", select="tree", ladder="scan", sqr="half",
                                     mul="shift_add")
    launches[(window_bits, point_form, "eager", "tree", "scan", "half", "shift_add",
              "schnorr_free" if ecdsa_only else "full")] += 1
    assert cuda_kernel.LAUNCHES == launches
    plain = K.verify_core(*args, schnorr_free=ecdsa_only, point_form=point_form, reduce="eager",
                          select="tree", ladder="scan", sqr="half", mul="shift_add")
    lazy = cuda_kernel.verify_blocked(*args, schnorr_free=ecdsa_only, point_form=point_form,
                                      select="tree", ladder="scan", sqr="half", mul="shift_add")
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
                                     reduce=reduce, select="onehot", ladder="scan", sqr="half",
                                     mul="shift_add")
    launches[(window_bits, point_form, reduce, "onehot", "scan", "half", "shift_add",
              "schnorr_free" if ecdsa_only else "full")] += 1
    assert cuda_kernel.LAUNCHES == launches
    plain = K.verify_core(*args, schnorr_free=ecdsa_only, point_form=point_form, reduce=reduce,
                          select="onehot", ladder="scan", sqr="half", mul="shift_add")
    tree = cuda_kernel.verify_blocked(*args, schnorr_free=ecdsa_only, point_form=point_form,
                                      reduce=reduce, select="tree", ladder="scan", sqr="half",
                                      mul="shift_add")
    assert got.device.type == "cuda" and got.dtype == torch.bool
    assert got.tolist() == plain.tolist() == tree.tolist() == O.verify_batch_cpu(items)


@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
def test_onehot_engine_on_card_matches_oracle(items, monkeypatch, window_bits):
    """An engine built under TPUNODE_SELECT16=onehot launches the one-hot
    instantiation."""
    monkeypatch.setenv("TPUNODE_SELECT16", "onehot")
    engine = _ready(batch_size=64, device_batch=128, window_bits=window_bits)
    monkeypatch.delenv("TPUNODE_SELECT16")
    launches = dict(cuda_kernel.LAUNCHES)
    assert engine.verify_sync(items) == O.verify_batch_cpu(items)
    launches[(window_bits, "projective", "lazy", "onehot", "scan", "half", "shift_add",
              "full")] += 2
    assert cuda_kernel.LAUNCHES == launches


@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
def test_unroll_engine_on_card_counts_under_its_key(items, monkeypatch, window_bits):
    """An engine built under TPUNODE_POW_LADDER=unroll launches the one
    kernel of its modes, counted under the unroll key, and its verdicts are
    the oracle's.  At 4-bit that is the default tuple's 8-word kernel
    (verify_u32), whose arithmetic the int32 replay does not cover, so no
    bound is audited; at 5-bit the radix-11 launch audits the bounds of the
    scan ladder, which is what that kernel runs."""
    from tpunode_torch.verify import bounds as B

    monkeypatch.setenv("TPUNODE_POW_LADDER", "unroll")
    engine = _ready(batch_size=64, device_batch=128, window_bits=window_bits)
    monkeypatch.delenv("TPUNODE_POW_LADDER")
    assert engine.ladder == "unroll"
    monkeypatch.setattr(B, "_AUDITED", {})
    launches = dict(cuda_kernel.LAUNCHES)
    libraries = dict(cuda_kernel.LIBRARY_LAUNCHES)
    assert engine.verify_sync(items) == O.verify_batch_cpu(items)
    launches[(window_bits, "projective", "lazy", "tree", "unroll", "half", "shift_add",
              "full")] += 2
    assert cuda_kernel.LAUNCHES == launches
    library = "verify_u32" if window_bits == 4 else "verify_half"
    libraries[(library, "full")] += 2
    assert cuda_kernel.LIBRARY_LAUNCHES == libraries
    audited = set() if window_bits == 4 else {("lazy", window_bits, "projective", "scan")}
    assert set(B._AUDITED) == audited


def test_ladder_probes_on_card_agree(items):
    """The static-digit pow, and the two one-hot pows on its inputs, give 1
    in every lane, bit for bit; the table built by dynamic index is a^15."""
    (t,) = cuda_diag.probe_inputs("pow_descan", "cuda")
    digits = cuda_diag.probe_inputs("pow_window", "cuda")[1]
    launches = dict(cuda_diag.LAUNCHES)
    descan = cuda_diag.pow_descan(t)
    assert torch.equal(descan, cuda_diag.pow_window(t, digits))
    assert torch.equal(descan, cuda_diag.pow_window_smem(t, digits))
    assert torch.equal(descan.cpu(), cuda_diag.pow_descan_plain(t.cpu()))
    (a,) = cuda_diag.probe_inputs("table_build", "cuda")
    built = cuda_diag.table_build(a)
    assert cuda_diag._host_check("table_build", built, (a,)) == 0
    for probe in ("pow_descan", "pow_window", "pow_window_smem", "table_build"):
        launches[probe] += 1
    assert cuda_diag.LAUNCHES == launches


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


@pytest.mark.parametrize("lanes", [1, 31, 33, 768, 4097])
def test_field_mul_dot_matches_plain_version_and_shift_add_probe(items, lanes):
    """The warp-collective kernel at a ragged last warp: the probe's 768
    lanes tiled from its loose ones (the ±2^19 / ±2^15 corners first), one
    launch a call, limb for limb its plain version's and the shift-add
    probe's output."""
    a, b = cuda_diag.probe_inputs("field_mul_dot", "cuda")
    idx = (torch.arange(lanes, device=a.device) + 512) % a.shape[-1]
    a, b = a[:, idx].contiguous(), b[:, idx].contiguous()
    launches = dict(cuda_diag.LAUNCHES)
    got = cuda_diag.field_mul_dot(a, b)
    launches["field_mul_dot"] += 1
    assert cuda_diag.LAUNCHES == launches
    assert got.device.type == "cuda" and torch.equal(got, cuda_diag.field_mul_dot_plain(a, b))
    assert torch.equal(got, cuda_diag.field_mul(a, b))
    assert cuda_diag._host_check("field_mul_dot", got, (a, b)) == 0


def test_field_mul_dot_refuses_malformed_arguments_on_card(items):
    a, b = cuda_diag.probe_inputs("field_mul_dot", "cuda")
    launches = dict(cuda_diag.LAUNCHES)
    with pytest.raises(ValueError):
        cuda_diag.field_mul_dot(a.t().contiguous().t(), b)
    with pytest.raises(ValueError):
        cuda_diag.field_mul_dot(a, b.to(torch.int64))
    assert cuda_diag.LAUNCHES == launches


def test_kernel_rejects_malformed_arguments_on_card(items):
    prep = K.prepare_batch_raw(pack_items(items[:8]))
    args = list(K.from_reference(prep.device_args, "cuda"))
    args[9] = args[9].cpu()
    with pytest.raises(ValueError):
        cuda_kernel.verify_blocked(*args, schnorr_free=False, select="tree", ladder="scan", sqr="half",
                                   mul="shift_add")


def test_launcher_refuses_a_width_it_lacks(items):
    import ctypes

    prep = K.prepare_batch_raw(pack_items(items[:8]))
    args = K.from_reference(prep.device_args, "cuda")
    out = torch.empty(8, dtype=torch.bool, device="cuda")
    ptrs = [ctypes.c_void_p(t.data_ptr())
            for t in (cuda_kernel._g_tables(out.device, 4), *args, out)]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    # no such width; no such form; no such reduce; no such select; no such
    # square; the other library's square; no such multiply; the other
    # library's multiply: each of the four libraries refuses them
    for (lib_mul, lib_sqr), name in cuda_kernel.VERIFY_LIBRARIES.items():
        lib = cuda_kernel._load(lib_mul, lib_sqr)
        code, mul = cuda_kernel._SQR_CODES[lib_sqr], cuda_kernel._MUL_CODES[lib_mul]
        for window_bits, point_form, reduce, select, sqr, mul_code in (
                (6, 0, 0, 0, code, mul), (4, 2, 0, 0, code, mul), (4, 0, 2, 0, code, mul),
                (4, 0, 0, 2, code, mul), (4, 0, 0, 0, 2, mul), (4, 0, 0, 0, -1, mul),
                (4, 0, 0, 0, 1 - code, mul), (4, 0, 0, 0, code, 2),
                (4, 0, 0, 0, code, 1 - mul)):
            err = lib.tpn_verify_blocked(*ptrs, 8, 0, window_bits, point_form, reduce, select,
                                         sqr, mul_code, stream)
            assert err != 0 and b"invalid" in lib.tpn_error_string(err), name
    launches = dict(cuda_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="sqr mode"):
        cuda_kernel.verify_blocked(*args, schnorr_free=False, select="tree", ladder="scan",
                                   sqr="full", mul="shift_add")
    with pytest.raises(ValueError, match="mul mode"):
        cuda_kernel.verify_blocked(*args, schnorr_free=False, select="tree", ladder="scan",
                                   sqr="half", mul="dot")
    assert cuda_kernel.LAUNCHES == launches


@pytest.mark.parametrize("reduce", ["lazy", "eager"])
@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
def test_engine_on_card_matches_oracle(items, window_bits, point_form, reduce):
    engine = _ready(batch_size=64, device_batch=128, window_bits=window_bits,
                    point_form=point_form, field_reduce=reduce)
    launches = dict(cuda_kernel.LAUNCHES)
    assert engine.verify_sync(items) == O.verify_batch_cpu(items)
    # 128 + a 72-item tail padded to 128
    launches[(window_bits, point_form, reduce, engine.select, engine.ladder, engine.cfg.field_sqr,
              engine.cfg.field_mul, "full")] += 2
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
                                     select="tree", ladder="scan", sqr="half", mul="shift_add")
    assert got.device == torch.device("cuda:1") and torch.cuda.current_device() == 0
    assert got.tolist() == O.verify_batch_cpu(items)
    inputs = cuda_diag.probe_inputs("field_mul", "cuda:1")
    out = cuda_diag.field_mul(*inputs)
    assert torch.cuda.current_device() == 0
    assert torch.equal(out.cpu(), cuda_diag.field_mul_plain(*(t.cpu() for t in inputs)))


@pytest.mark.parametrize("select", ["tree", "onehot"])
@pytest.mark.parametrize("reduce", ["lazy", "eager"])
@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
@pytest.mark.parametrize("ecdsa_only", [False, True], ids=["full", "schnorr_free"])
def test_full_product_kernel_matches_its_half_twin_and_oracle(items512, ecdsa_only, window_bits,
                                                              point_form, reduce, select):
    """Each of the 32 full-product instantiations on 512 adversarial lanes,
    counted under its own key, against its half-product twin (held against
    the plain version above; the two squares give the same limbs) and the
    oracle."""
    items = items512
    if ecdsa_only:
        items = chip_smoke.tile([it for it in items if len(it) == 4], 512)
    prep = K.prepare_batch_raw(pack_items(items), pad_to=len(items), window_bits=window_bits)
    assert prep.schnorr_free == ecdsa_only
    args = K.from_reference(prep.device_args, "cuda")
    variant = "schnorr_free" if ecdsa_only else "full"
    launches = dict(cuda_kernel.LAUNCHES)
    got = cuda_kernel.verify_blocked(*args, schnorr_free=ecdsa_only, point_form=point_form,
                                     reduce=reduce, select=select, ladder="scan", sqr="mul",
                                     mul="shift_add")
    launches[(window_bits, point_form, reduce, select, "scan", "mul", "shift_add", variant)] += 1
    assert cuda_kernel.LAUNCHES == launches
    half = cuda_kernel.verify_blocked(*args, schnorr_free=ecdsa_only, point_form=point_form,
                                      reduce=reduce, select=select, ladder="scan", sqr="half",
                                      mul="shift_add")
    assert got.device.type == "cuda" and got.dtype == torch.bool
    assert got.tolist() == half.tolist() == O.verify_batch_cpu(items)


@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
def test_full_product_engine_on_card_matches_plain_version_and_oracle(items, monkeypatch,
                                                                      window_bits):
    """An engine built under TPUNODE_FIELD_SQR=mul launches the
    full-product instantiation, counted under its key; its verdicts are the
    plain version's under sqr="mul" and the oracle's."""
    monkeypatch.setenv("TPUNODE_FIELD_SQR", "mul")
    engine = _ready(batch_size=64, device_batch=128, window_bits=window_bits)
    monkeypatch.delenv("TPUNODE_FIELD_SQR")
    assert engine.cfg.field_sqr == "mul"
    launches = dict(cuda_kernel.LAUNCHES)
    assert engine.verify_sync(items) == O.verify_batch_cpu(items)
    launches[(window_bits, "projective", "lazy", "tree", "scan", "mul", "shift_add",
              "full")] += 2
    assert cuda_kernel.LAUNCHES == launches
    prep = K.prepare_batch_raw(pack_items(items), pad_to=len(items), window_bits=window_bits)
    args = K.from_reference(prep.device_args, "cuda")
    plain = K.verify_core(*args, schnorr_free=False, select="tree", ladder="scan", sqr="mul",
                          mul="shift_add")
    assert plain.tolist() == O.verify_batch_cpu(items)


DOT_LANES = (1, 31, 33, 4097)  # one lane, a short warp, a ragged second warp, a ragged block


@pytest.fixture(scope="module")
def ragged(items512):
    """(items, oracle verdicts) at each ragged lane count of the dot_general
    tests, in both variants: the 512 adversarial items, from the first
    BCH Schnorr one on (so that one lane is the full variant), or their
    ECDSA ones, tiled, the oracle's verdicts tiled with them."""
    out = {}
    first = next(k for k, it in enumerate(items512) if len(it) == 5)
    for variant in ("full", "schnorr_free"):
        base = items512[first:] + items512[:first] if variant == "full" else chip_smoke.tile(
            [it for it in items512 if len(it) == 4], 512)
        oracle = O.verify_batch_cpu(base)
        for lanes in DOT_LANES:
            out[(variant, lanes)] = chip_smoke.tile(base, lanes), chip_smoke.tile(oracle, lanes)
    return out



@pytest.mark.parametrize("sqr", ["half", "mul"])
@pytest.mark.parametrize("select", ["tree", "onehot"])
@pytest.mark.parametrize("reduce", ["lazy", "eager"])
@pytest.mark.parametrize("point_form", ["projective", "affine"])
@pytest.mark.parametrize("window_bits", [4, 5], ids=["w4", "w5"])
@pytest.mark.parametrize("ecdsa_only", [False, True], ids=["full", "schnorr_free"])
def test_dot_general_kernel_matches_its_shift_add_twin(ragged, ecdsa_only, window_bits,
                                                       point_form, reduce, select, sqr):
    """Each of the 64 dot_general instantiations at B = 1, 31, 33 and 4,097
    (ragged warps, whose lanes past B run clamped to the end; in the affine
    form lanes whose digit is 0 beside lanes that add), one launch counted
    under its own key each, against its shift-add twin (held against the
    plain version above) and the oracle."""
    variant = "schnorr_free" if ecdsa_only else "full"
    for lanes in DOT_LANES:
        items, oracle = ragged[(variant, lanes)]
        prep = K.prepare_batch_raw(pack_items(items), pad_to=lanes, window_bits=window_bits)
        assert prep.schnorr_free == ecdsa_only
        args = K.from_reference(prep.device_args, "cuda")
        modes = dict(schnorr_free=ecdsa_only, point_form=point_form, reduce=reduce,
                     select=select, ladder="scan", sqr=sqr)
        launches = dict(cuda_kernel.LAUNCHES)
        got = cuda_kernel.verify_blocked(*args, **modes, mul="dot_general")
        launches[(window_bits, point_form, reduce, select, "scan", sqr, "dot_general",
                  variant)] += 1
        assert cuda_kernel.LAUNCHES == launches
        twin = cuda_kernel.verify_blocked(*args, **modes, mul="shift_add")
        assert got.device.type == "cuda" and got.dtype == torch.bool
        assert got.tolist() == twin.tolist() == oracle, lanes


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_dot_general_engine_on_card_matches_plain_version_and_oracle(items, monkeypatch, sqr):
    """An engine built under TPUNODE_FIELD_MUL=dot_general launches the
    dot_general instantiation, counted under its key; its verdicts are the
    plain version's under mul="dot_general" on the card and the oracle's."""
    monkeypatch.setenv("TPUNODE_FIELD_MUL", "dot_general")
    engine = _ready(batch_size=64, device_batch=128, field_sqr=sqr)
    monkeypatch.delenv("TPUNODE_FIELD_MUL")
    assert engine.cfg.field_mul == "dot_general" and engine.modes()[0] == "dot_general"
    launches = dict(cuda_kernel.LAUNCHES)
    assert engine.verify_sync(items) == O.verify_batch_cpu(items)
    launches[(4, "projective", "lazy", "tree", "scan", sqr, "dot_general", "full")] += 2
    assert cuda_kernel.LAUNCHES == launches
    prep = K.prepare_batch_raw(pack_items(items), pad_to=len(items))
    args = K.from_reference(prep.device_args, "cuda")
    plain = K.verify_core(*args, schnorr_free=False, select="tree", ladder="scan", sqr=sqr,
                          mul="dot_general")
    assert plain.tolist() == O.verify_batch_cpu(items)


@pytest.mark.parametrize("chain", ["btc", "bch"])
def test_block_ingest_on_card_runs_verify_u32_alone(chain):
    """A block's wire bytes (a coinbase and 60 transactions of the mix;
    BCH with its Schnorr rows) through the native extraction, the
    default-tuple engine on the card and ``combine``: served by the card,
    launched in ``verify_u32`` alone, every verdict the native CPU
    verifier's and every comparison of the chip_smoke phase at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from tpunode_torch.verify.cpu_native import load_native_verifier
    from tpunode_torch.verify.raw import as_raw_batch

    if chain == "btc":
        txs, bch, expect = chip_smoke.btc_block_txs(60), False, chip_smoke.corrupted_btc_txs
    else:
        txs, bch, expect = chip_smoke.bch_block_txs(60), True, lambda txs, items: []
    data = b"".join(tx.serialize() for tx in txs)
    engine = _ready(batch_size=256, device_batch=1024)
    launches, libraries = dict(cuda_kernel.LAUNCHES), dict(cuda_kernel.LIBRARY_LAUNCHES)
    ingest = chip_smoke.ingest_block(engine, data, len(txs), bch)
    assert engine.last_rung == "tpu"
    grew = {key: n - libraries.get(key, 0) for key, n in cuda_kernel.LIBRARY_LAUNCHES.items()
            if n != libraries.get(key, 0)}
    assert grew and {lib for lib, _ in grew} == {cuda_kernel.U32_LIBRARY}
    assert {key[:7] for key, n in cuda_kernel.LAUNCHES.items() if n != launches.get(key, 0)} == {
        (4, "projective", "lazy", "tree", "scan", "half", "shift_add")}
    items = ingest["items"]
    cpu = load_native_verifier().verify_raw(as_raw_batch(items))
    assert ingest["verdicts"] == cpu
    row = chip_smoke.block_checks(ingest, data, len(txs), bch, cpu, expect)
    assert all(row[key] == 0 for key in row if key.endswith("mismatches")), row
    assert row["invalid_txs"] == len(expect(txs, items))
    assert bch or row["invalid_txs"]


def test_node_syncs_a_chain_on_the_card_through_verify_u32_alone():
    """A port ``Node`` with the default ``VerifyConfig`` (the card) syncs a
    short ``gen_chain`` (4 blocks of 16 transactions of the BCH mix) from an
    in-memory wire-speaking remote through its IBD planner, then verifies
    12 relayed loose transactions: every verdict the native CPU verifier's,
    every chain transaction valid, the corrupted loose ones invalid, and
    every launch at the default tuple in ``verify_u32``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from tpunode_torch.metrics import metrics

    kind = (4, "projective", "lazy", "tree", "scan", "half", "shift_add")

    def reset_launches():
        for counts in (cuda_kernel.LAUNCHES, cuda_kernel.LIBRARY_LAUNCHES):
            for key in counts:
                counts[key] = 0

    def engine_metrics():
        return {name: metrics.get(name) for name in (
            "verify.tpu_items", "verify.cpu_items", "verify.failovers", "verify.dispatch_errors")}

    row, launches = chip_smoke.node_sync_phase(kind, reset_launches, engine_metrics,
                                               n_blocks=4, txs_per_block=16, loose=12)
    assert row["chain_synced"] == [4] and row["watermark"] == 4 and row["rung"] == "tpu"
    assert row["verdicts"] == 4 * 17 + 12 and row["invalid_loose"] > 0
    assert set(row["launches_by_library"]) <= {f"{cuda_kernel.U32_LIBRARY}/full",
                                               f"{cuda_kernel.U32_LIBRARY}/schnorr_free"}
    assert sum(launches.values()) >= 1
