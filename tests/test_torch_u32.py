"""The main path's verify kernel redesigned for the card: 8-word field
elements on the widening multiply (``csrc/field_u32.cuh``,
``csrc/curve_u32.cuh``, ``csrc/verify_u32.cu``).

``tpunode_torch/csrc/host_u32.cpp`` wraps the field layer, the point
formulas, the per-lane program and the ``field_mul_u32`` probe lane in a
plain C interface; the module fixture builds it once with ``g++ -O1
-fsanitize=undefined -fno-sanitize-recover=all`` into a temporary
directory.  Unsigned arithmetic cannot overflow, so a dropped carry shows
only as a wrong value: the field layer is held against Python integers at
the carries' edges (0, 1, p - 1, p, p + 1, 2^256 - 1, all-ones words, a
single 1 in each word, the fold's double carry) and on numpy-seeded
values, and must stay below 2^256; the point formulas against the plain
``tpunode_torch.verify.curve`` values mod p; the per-lane program against
the plain version's verdicts (``kernel.verify_core``) and the oracle.  The
routing is checked by a spy on the library loader.  The ``gpu``-marked
cases run the kernel and the probe on a card.  Limbs, words and verdicts
are integers: every comparison is exact.
"""

import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tpunode_torch import cuda_diag
from tpunode_torch.verify import cuda_kernel
from tpunode_torch.verify import curve as C
from tpunode_torch.verify import ecdsa_cpu as O
from tpunode_torch.verify import field as F
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "tpunode_torch" / "csrc"
GXX_FLAGS = ("-std=c++17", "-O1", "-Wall", "-Wno-unknown-pragmas", "-fsanitize=undefined",
             "-fno-sanitize-recover=all", "-shared", "-fPIC")
P = F.P
TOP = 1 << 256
FOLD = (1 << 32) + 977  # 2^256 mod p
# the field layer's edges: zero and one, p and its neighbours, the top of
# the word range, the fold constant's neighbours, all-ones words, a single 1
# in each word, each word's top bit
EDGES = sorted({0, 1, 2, P - 2, P - 1, P, P + 1, TOP - 1, TOP - 2, FOLD - 1, FOLD, FOLD + 1,
                1 << 255, (1 << 255) - 1, TOP - FOLD - 1}
               | {1 << (32 * i) for i in range(8)} | {0xFFFFFFFF << (32 * i) for i in range(8)}
               | {TOP - (1 << (32 * i)) for i in range(8)} | {1 << (32 * i + 31) for i in range(8)})
OPS = {"mul": 0, "sqr": 1, "add": 2, "sub": 3, "neg": 4, "canonical": 5, "mul_small": 6,
       "pow_euler": 7, "pow_pm2": 8}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """host_u32.cpp built once under UBSan."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    out = tmp_path_factory.mktemp("hostu32") / "libtpn_host_u32.so"
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(out), str(CSRC / "host_u32.cpp")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "warning" not in proc.stderr, proc.stderr
    return ctypes.CDLL(str(out))


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _words(vals) -> np.ndarray:
    """Values below 2^256 as (n, 8) little-endian uint32 words."""
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for v in vals],
                    dtype=np.uint32)


def _ints(words: np.ndarray) -> list:
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]


def _random(rng: np.random.Generator, n: int) -> list:
    """``n`` values in [0, 2^256): weakly reduced elements, p and above too."""
    return [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]


def _pairs(seed: int) -> tuple:
    """Every pair of :data:`EDGES`, then 256 numpy-seeded pairs."""
    rng = np.random.default_rng(seed)
    a = [x for x in EDGES for _ in EDGES] + _random(rng, 256)
    b = [y for _ in EDGES for y in EDGES] + _random(rng, 256)
    return a, b


def _field(lib, op: str, a: list, b: list, k: int = 0) -> list:
    x, y = _words(a), _words(b)
    out = np.zeros_like(x)
    assert lib.tpn_u32_field(_ptr(x), _ptr(y), _ptr(out), len(a), OPS[op],
                             ctypes.c_uint32(k)) == 0
    return _ints(out)


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "neg", "canonical"])
def test_field_op_matches_python_integers(lib, op):
    """Every result is congruent to the integer one mod p (canonical: equal
    to it) for every pair of edges and 256 seeded pairs; the double carry of
    the fold is among them ((2^256 - 1)^2, (2^256 - 1) + (2^256 - 1))."""
    a, b = _pairs(0xF32 + OPS[op])
    got = _field(lib, op, a, b)
    want = {"mul": [x * y for x, y in zip(a, b)], "sqr": [x * x for x in a],
            "add": [x + y for x, y in zip(a, b)], "sub": [x - y for x, y in zip(a, b)],
            "neg": [-x for x in a], "canonical": a}[op]
    if op == "canonical":
        assert got == [w % P for w in want]
    else:
        assert [(g - w) % P for g, w in zip(got, want)] == [0] * len(a)


@pytest.mark.parametrize("k", [3, 8, 21, 0xFFFFFFFF])
def test_mul_small_matches_python_integers(lib, k):
    a, _ = _pairs(0x5A11 + k % 97)
    got = _field(lib, "mul_small", a, a, k)
    assert [(g - x * k) % P for g, x in zip(got, a)] == [0] * len(a)


@pytest.mark.parametrize("euler", [True, False], ids=["euler", "p_minus_2"])
def test_pow_const_matches_python_integers(lib, euler):
    """t^((p-1)/2) and t^(p-2), the exponents' digits read from their
    __constant__ words."""
    vals = EDGES + _random(np.random.default_rng(0x90E), 16)
    got = _field(lib, "pow_euler" if euler else "pow_pm2", vals, vals)
    e = (P - 1) // 2 if euler else P - 2
    assert [g % P for g in got] == [pow(v, e, P) for v in vals]


def test_is_zero_and_eq_match_python_integers(lib):
    """Over the edge pairs, seeded pairs and each value beside its
    representative plus p (where that is below 2^256)."""
    a, b = _pairs(0xE9)
    small = [v for v in EDGES if v + P < TOP]
    a, b = a + small, b + [v + P for v in small]
    x, y = _words(a), _words(b)
    zero, eq = np.zeros(len(a), np.uint8), np.zeros(len(a), np.uint8)
    lib.tpn_u32_tests(_ptr(x), _ptr(y), _ptr(zero), _ptr(eq), len(a))
    assert zero.tolist() == [int(v % P == 0) for v in a]
    assert eq.tolist() == [int(v % P == w % P) for v, w in zip(a, b)]


def test_unknown_field_op_is_refused(lib):
    x = _words([1])
    assert lib.tpn_u32_field(_ptr(x), _ptr(x), _ptr(x), 1, 9, ctypes.c_uint32(0)) == 1


def _limb_rows(rng: np.random.Generator) -> np.ndarray:
    """(24, n) int32 limb columns: zero, every limb at 2^11 - 1 (2^264 - 1),
    each limb alone at its top, p's and 2^256's limbs, seeded canonical
    limbs, mul's loose contract (cuda_diag's, ±2^19 and the top ±2^15) and
    limbs at the ends of int32."""
    cols = [np.zeros(24, np.int64), np.full(24, 2047, np.int64)]
    for i in range(24):
        col = np.zeros(24, np.int64)
        col[i] = 2047
        cols.append(col)
    cols += [F.to_limbs(P).astype(np.int64), F.to_limbs(P - 1).astype(np.int64),
             F.to_limbs(TOP - 1).astype(np.int64)]
    cols += list(rng.integers(0, 2048, size=(64, 24)))
    cols += list(cuda_diag._loose(rng, 32).T.astype(np.int64))
    cols += [np.full(24, 2**31 - 1, np.int64), np.full(24, -2**31, np.int64),
             rng.integers(-2**31, 2**31, size=24)]
    return np.ascontiguousarray(np.stack(cols, axis=1), dtype=np.int32)


def test_from_radix11_matches_python_integers(lib):
    """Every value below 2^264 (and any int32 limbs) maps to 8 words below
    2^256 congruent to it mod p; canonical words map back to their limbs."""
    rows = _limb_rows(np.random.default_rng(0x11))
    n = rows.shape[1]
    out = np.zeros((n, 8), np.uint32)
    lib.tpn_u32_from_radix11(_ptr(rows), _ptr(out), n)
    want = [F.from_limbs(rows[:, i]) for i in range(n)]
    assert [(g - w) % P for g, w in zip(_ints(out), want)] == [0] * n
    canon = _words([w % P for w in want])
    back = np.zeros((24, n), np.int32)
    lib.tpn_u32_to_radix11(_ptr(canon), _ptr(back), n)
    assert np.array_equal(back, np.stack([F.to_limbs(w % P) for w in want], axis=1))


def _points(rng: np.random.Generator) -> tuple:
    """Pairs of projective points (as ints) for the formulas: random
    coordinates below 2^256 (p and above among them), real points with Z
    scaled, each with itself, its negative and infinity, and coordinates
    written as their representative plus p."""
    def scaled(pt, z):
        return (pt.x * z % P, pt.y * z % P, z)

    reals = [O.point_mul(int(k), O.GENERATOR) for k in rng.integers(1, 2**62, size=8)]
    zs = [int(z) % P or 1 for z in _random(rng, 8)]
    inf = (0, 1, 0)
    ps, qs = [], []
    for pt, z in zip(reals, zs):
        a = scaled(pt, z)
        for q in (scaled(pt, 3), (pt.x, P - pt.y, 1), inf, scaled(reals[0], 5)):
            ps.append(a)
            qs.append(q)
        ps.append(inf)
        qs.append(a)
    for _ in range(16):
        ps.append(tuple(_random(rng, 3)))
        qs.append(tuple(_random(rng, 3)))
    # representatives at and above p
    ps.append(tuple(v + P if v + P < TOP else v for v in (1, 2, 0)))
    qs.append((P, P + 1, P + 2))
    return ps, qs


def _pt_words(pts) -> np.ndarray:
    return np.ascontiguousarray(np.stack([_words(pt) for pt in pts]))


def _pt_limbs(pts) -> torch.Tensor:
    """Points as the plain version's (3, 24, n) canonical limbs."""
    return torch.from_numpy(np.stack([np.stack([F.to_limbs(c % P) for c in pt], axis=1)
                                      for pt in zip(*pts)]).astype(np.int32))


def _pt_ints(t: torch.Tensor) -> list:
    """The plain version's (3, 24, n) limbs as points of ints mod p."""
    a = t.numpy()
    return [tuple(F.from_limbs(a[c, :, i]) % P for c in range(3)) for i in range(a.shape[-1])]


@pytest.mark.parametrize("formula", ["pt_add", "pt_double"])
def test_point_formula_matches_the_plain_version(lib, formula):
    """pt_add (RCB'16 Algorithm 7) and pt_double (Algorithm 9) coordinate
    for coordinate, mod p, against the plain lazy formulas on the same
    values: the subtractions t3 - (t0 + t1), t1 - b3·t2, the X3 difference
    and t0 - 3·t2 are negative for many of these lanes."""
    ps, qs = _points(np.random.default_rng(0xC0 + (formula == "pt_double")))
    p, q = _pt_words(ps), _pt_words(qs)
    out = np.zeros_like(p)
    lib.tpn_u32_point(_ptr(p), _ptr(q), _ptr(out), len(ps), int(formula == "pt_double"))
    got = [tuple(v % P for v in _ints(pt)) for pt in out]
    assert all(v < TOP for pt in out for v in _ints(pt))
    if formula == "pt_add":
        plain = C.pt_add(_pt_limbs(ps), _pt_limbs(qs), reduce="lazy")
    else:
        plain = C.pt_double(_pt_limbs(ps), reduce="lazy")
    assert got == _pt_ints(plain)


def test_field_mul_u32_probe_lane_matches_the_plain_version_and_host_check(lib):
    """The probe's lane on its own inputs (the reference probe's columns,
    full-width values below p, mul's loose limbs): canonical limbs equal to
    field.mul followed by canonical, and to the host check's integers."""
    a, b = cuda_diag.probe_inputs("field_mul_u32", "cpu", lanes=32)
    out = torch.zeros_like(a)
    lib.tpn_host_field_mul_u32(*(ctypes.c_void_p(t.data_ptr()) for t in (a, b, out)),
                               a.shape[-1])
    assert cuda_diag.FUNCTIONS["field_mul_u32"][1] is cuda_diag.field_mul_plain
    assert torch.equal(out, cuda_diag.field_mul_plain(a, b))
    assert cuda_diag._host_check("field_mul_u32", out, (a, b)) == 0


@pytest.fixture(scope="module")
def items():
    """33 adversarial items (every shape of chip_smoke.adversarial_items),
    every eighth one corrupted."""
    adv = chip_smoke.adversarial_items(O, random.Random(0x32A), lanes=33)
    return chip_smoke.corrupt_every(adv, 8)


def _host_verify(lib, args, schnorr_free: bool) -> list:
    tables = cuda_kernel._g_tables(torch.device("cpu"), 4, "projective")
    out = torch.zeros(args[8].shape[-1], dtype=torch.bool)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (tables, *args, out)]
    assert lib.tpn_u32_verify(*ptrs, out.shape[0], int(schnorr_free)) == 0
    return out.tolist()


@pytest.mark.parametrize("variant", ["full", "schnorr_free"])
def test_verify_lane_matches_the_plain_version(lib, items, variant):
    """verify_lane at B = 1, 31 and 33, each lane's verdict the plain
    version's on the 33-lane batch (a lane's verdict depends on its item
    alone) and the oracle's: every algorithm and adversarial shape in the
    full variant, the ECDSA ones in schnorr_free."""
    batch = items if variant == "full" else chip_smoke.tile(
        [it for it in items if len(it) == 4], 33)
    prep = K.prepare_batch_raw(pack_items(batch), pad_to=33, window_bits=4)
    assert prep.schnorr_free == (variant == "schnorr_free")
    with torch.inference_mode():
        plain = K.verify_core(*K.from_reference(prep.device_args, "cpu"),
                              schnorr_free=prep.schnorr_free, point_form="projective",
                              reduce="lazy", select="tree", ladder="scan", sqr="half",
                              mul="shift_add").tolist()
    oracle = O.verify_batch_cpu(batch)
    assert plain == oracle and 0 < sum(oracle) < len(oracle)
    for b in (1, 31, 33):
        prep = K.prepare_batch_raw(pack_items(batch[:b]), pad_to=b, window_bits=4)
        got = _host_verify(lib, K.from_reference(prep.device_args, "cpu"),
                           variant == "schnorr_free")
        assert got == plain[:b], b


# ---------- routing, by a spy on the library loader ---------------------------


class _Entry:
    """A fake C entry point: records its calls, returns ``ret``."""
    argtypes = None
    restype = None

    def __init__(self, ret=0):
        self.ret, self.calls = ret, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.ret


class _Lib:
    def __init__(self, ret=0):
        self.tpn_verify_u32, self.tpn_verify_blocked = _Entry(ret), _Entry(ret)
        self.tpn_u32_error_string = self.tpn_error_string = lambda err: b"invalid argument"


def _spy_loader(monkeypatch, ret=0, fail=()) -> tuple:
    """load_library replaced: records each name, raises (a failed build)
    for the names in ``fail``, else returns a fake library.  Returns the
    names loaded and the fake libraries by name."""
    loaded, libs = [], {}

    def load(name):
        loaded.append(name)
        if name in fail:
            raise RuntimeError(f"nvcc failed (1): {name}")
        return libs.setdefault(name, _Lib(ret))

    monkeypatch.setattr(cuda_kernel, "load_library", load)
    return loaded, libs


def test_default_tuple_routes_to_verify_u32_and_others_to_radix11():
    assert cuda_kernel.kernel_library(*cuda_kernel.U32_MODES) == "verify_u32"
    assert cuda_kernel.U32_MODES == (4, "projective", "lazy", "tree", "half", "shift_add")
    for modes, name in (((5, "projective", "lazy", "tree", "half", "shift_add"), "verify_half"),
                        ((4, "affine", "lazy", "tree", "half", "shift_add"), "verify_half"),
                        ((4, "projective", "eager", "tree", "half", "shift_add"), "verify_half"),
                        ((4, "projective", "lazy", "onehot", "half", "shift_add"), "verify_half"),
                        ((4, "projective", "lazy", "tree", "mul", "shift_add"), "verify_mul"),
                        ((4, "projective", "lazy", "tree", "half", "dot_general"),
                         "verify_dot_half")):
        assert cuda_kernel.kernel_library(*modes) == name, modes


@pytest.mark.parametrize("modes", [cuda_kernel.U32_MODES,
                                   (5, "projective", "lazy", "tree", "half", "shift_add"),
                                   (4, "projective", "lazy", "tree", "mul", "shift_add")],
                         ids=["default", "w5", "sqr_mul"])
def test_launch_loads_the_routed_library_alone(monkeypatch, modes):
    """The launch of a routed tuple loads that library and calls its entry
    point: tpn_verify_u32 without mode codes, tpn_verify_blocked with them."""
    loaded, libs = _spy_loader(monkeypatch)
    name = cuda_kernel.kernel_library(*modes)
    load, codes = cuda_kernel._entry(name, modes)
    assert loaded == []  # loaded at the launch, not before
    cuda_kernel._launch(name, load, [None] * 18, 7, True, codes, None)
    assert loaded == [name]
    lib = libs[name]
    if name == "verify_u32":
        assert lib.tpn_verify_u32.calls == [(*[None] * 18, 7, 1, None)]
        assert not lib.tpn_verify_blocked.calls
    else:
        assert len(lib.tpn_verify_blocked.calls) == 1 and not lib.tpn_verify_u32.calls
        assert lib.tpn_verify_blocked.calls[0][18:21] == (7, 1, modes[0])


def test_failed_build_or_launch_raises_without_fallback(monkeypatch):
    load, codes = cuda_kernel._entry("verify_u32", cuda_kernel.U32_MODES)
    loaded, _ = _spy_loader(monkeypatch, fail=("verify_u32",))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_kernel._launch("verify_u32", load, [None] * 18, 7, False, codes, None)
    assert loaded == ["verify_u32"]  # never verify_half
    loaded, _ = _spy_loader(monkeypatch, ret=1)
    with pytest.raises(RuntimeError, match="launch failed \\(verify_u32\\): invalid"):
        cuda_kernel._launch("verify_u32", load, [None] * 18, 7, False, codes, None)
    assert loaded == ["verify_u32"]


def test_entry_refuses_a_library_without_the_modes_and_audits_radix11(monkeypatch):
    """_entry checks the library against the modes before anything loads:
    verify_u32 runs U32_MODES alone, a radix-11 library its own (multiply,
    square); only the radix-11 launch replays the int32 headroom audit."""
    loaded, _ = _spy_loader(monkeypatch)
    audited = []
    monkeypatch.setattr(cuda_kernel._bounds, "assert_formulas_safe",
                        lambda *a, **k: audited.append((a, k)))
    w5 = (5, "projective", "lazy", "tree", "half", "shift_add")
    with pytest.raises(ValueError, match="runs the modes"):
        cuda_kernel._entry("verify_u32", w5)
    with pytest.raises(ValueError, match="holds no instantiation"):
        cuda_kernel._entry("verify_mul", cuda_kernel.U32_MODES)
    assert cuda_kernel._entry("verify_u32", cuda_kernel.U32_MODES)[1] == () and not audited
    assert cuda_kernel._entry("verify_half", cuda_kernel.U32_MODES)[1][0] == 4
    assert len(audited) == 1 and loaded == []


def test_library_launch_counts_name_every_library():
    assert set(cuda_kernel.LIBRARY_LAUNCHES) == {
        (name, v) for name in ("verify_half", "verify_mul", "verify_dot_half", "verify_dot_mul",
                               "verify_u32", "verify_u32_modes_half", "verify_u32_modes_mul",
                               "verify_u32_modes5_half", "verify_u32_modes5_mul",
                               "verify_u32_modes_tree_half", "verify_u32_modes_tree_mul")
        for v in cuda_kernel.VARIANTS}


def test_u32_library_builds_beside_the_others_and_hashes_its_headers():
    """verify_u32 is a library of its own source, and an edit of its headers
    renames every library (the hash reads them)."""
    src, defines = cuda_kernel._LIBRARIES["verify_u32"]
    assert (src, defines) == ("verify_u32.cu", ())
    assert {"field_u32.cuh", "curve_u32.cuh"} <= set(cuda_kernel._HEADERS)
    for name in ("verify_u32", "diag"):
        text = (CSRC / cuda_kernel._LIBRARIES[name][0]).read_text()
        assert '#include "field_u32.cuh"' in text or '#include "curve_u32.cuh"' in text


# ---------- on a card ------------------------------------------------------------


@pytest.fixture(scope="module")
def card_items():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return chip_smoke.corrupt_every(
        chip_smoke.adversarial_items(O, random.Random(0x32C), lanes=200), 8)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 31, 33, 200])
@pytest.mark.parametrize("variant", ["full", "schnorr_free"])
def test_u32_kernel_on_card_matches_plain_and_radix11(card_items, variant, lanes):
    """The routed default tuple launches verify_u32; its verdicts equal the
    plain version's, the oracle's and verify_half's radix-11 entry's."""
    batch = card_items if variant == "full" else chip_smoke.tile(
        [it for it in card_items if len(it) == 4], 200)
    batch = batch[:lanes]
    prep = K.prepare_batch_raw(pack_items(batch), pad_to=lanes, window_bits=4)
    sf = variant == "schnorr_free"
    args = K.from_reference(prep.device_args, "cuda")
    modes = dict(schnorr_free=sf, select="tree", ladder="scan", sqr="half", mul="shift_add")
    counts = dict(cuda_kernel.LIBRARY_LAUNCHES)
    got = cuda_kernel.verify_blocked(*args, **modes)
    counts[("verify_u32", variant)] += 1
    assert cuda_kernel.LIBRARY_LAUNCHES == counts
    radix11 = cuda_kernel.verify_with("verify_half", *args, **modes)
    plain = K.verify_core(*args, **modes)
    assert got.tolist() == radix11.tolist() == plain.tolist() == O.verify_batch_cpu(batch)


@pytest.mark.gpu
def test_u32_library_refuses_other_modes_on_card(card_items):
    prep = K.prepare_batch_raw(pack_items(card_items[:8]), window_bits=5)
    args = K.from_reference(prep.device_args, "cuda")
    with pytest.raises(ValueError, match="runs the modes"):
        cuda_kernel.verify_with("verify_u32", *args, schnorr_free=False, select="tree",
                                ladder="scan", sqr="half", mul="shift_add")


@pytest.mark.gpu
def test_engine_on_card_runs_the_default_tuple_on_verify_u32(card_items):
    engine = VerifyEngine(VerifyConfig(batch_size=64, device_batch=128))
    assert engine.wait_warmup(600) == "ready"  # its launches are not the test's
    counts = dict(cuda_kernel.LIBRARY_LAUNCHES)
    assert engine.verify_sync(card_items) == O.verify_batch_cpu(card_items)
    counts[("verify_u32", "full")] += 2  # 128 + a 72-item tail padded to 128
    assert cuda_kernel.LIBRARY_LAUNCHES == counts


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [768, 32768])
def test_field_mul_u32_probe_on_card(card_items, lanes):
    """The probe's 768 lanes, and its lanes tiled to 32,768: the host check
    and the shift-add probe's output."""
    a, b = cuda_diag.probe_inputs("field_mul_u32", "cuda")
    tiled = torch.arange(lanes, device=a.device) % a.shape[-1]
    a, b = a[:, tiled].contiguous(), b[:, tiled].contiguous()
    launches = cuda_diag.LAUNCHES["field_mul_u32"]
    out = cuda_diag.field_mul_u32(a, b)
    assert cuda_diag.LAUNCHES["field_mul_u32"] == launches + 1
    assert cuda_diag._host_check("field_mul_u32", out, (a, b)) == 0
    assert torch.equal(out, cuda_diag.field_mul(a, b))


# ---------- chip_smoke.py's phases for the 8-word kernel, against stubs -------------


def test_ptxas_entries_key_the_u32_kernel_and_probe_and_the_snapshot_skips_them():
    def entry(name, regs, stack, smem):
        return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {name}\n"
                f"    {stack} bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
                f"ptxas info    : Used {regs} registers, used 1 barriers, {smem} bytes smem\n")

    log = (entry("_ZN3tpn3u3217verify_u32_kernelILb0EEEvNS0_10VerifyArgsEPKi", 200, 2048, 3200)
           + entry("_ZN3tpn3u3217verify_u32_kernelILb1EEEvNS0_10VerifyArgsEPKi", 200, 1536, 3200)
           + entry("_ZN3tpn20field_mul_u32_kernelEPKiS1_Pii", 40, 0, 0)
           + entry("_ZN3tpn16field_mul_kernelEPKiS1_Pii", 96, 1200, 0))
    got = chip_smoke.ptxas_entries(log)
    assert set(got) == {"full/u32", "schnorr_free/u32", "field_mul_u32", "field_mul"}
    assert got["full/u32"] == {"registers": 200, "smem": 3200, "stack_frame": 2048,
                               "spill_stores": 0, "spill_loads": 0}
    line = {"registers": 1, "smem": 0, "stack_frame": 0, "spill_stores": 0, "spill_loads": 0}
    snap = {"source": "s", "nvcc": "n", "nvcc_flags": [], "entries": {"full/w4/a": line}}
    held = chip_smoke.ptxas_vs_snapshot({"full/w4/a": line, **got}, snap, "n", ())
    assert (held["entries"], held["equal"], held["differ"]) == (1, 1, {})


def test_sass_classes_sum_opcodes_by_class():
    text = ("\tcode for sm_90a\n\t\tFunction : _ZN3tpn3u3217verify_u32_kernelILb0EE\n"
            "        /*0000*/                   IMAD.WIDE.U32 R2, R3, R4, R6 ;\n"
            "        /*0010*/              @!P0 IADD3.X R2, R3, R4, RZ, P0, !PT ;\n"
            "        /*0020*/                   IADD3 R2, P0, R3, R4, RZ ;\n"
            "        /*0030*/                   IMAD.X R2, RZ, RZ, R4, P0 ;\n"
            "        /*0040*/                   IMAD.MOV.U32 R2, RZ, RZ, R4 ;\n"
            "        /*0050*/                   EXIT ;\n"
            "\t\tFunction : other\n        /*0000*/                   LDL R1, [R1] ;\n")
    fns = chip_smoke.sass_functions(text)
    assert set(fns) == {"_ZN3tpn3u3217verify_u32_kernelILb0EE", "other"}
    got = chip_smoke.sass_classes(fns["_ZN3tpn3u3217verify_u32_kernelILb0EE"])
    assert {k: n for k, n in got.items() if n} == {"IMAD.WIDE": 1, "IADD3.X": 1, "IADD3": 1,
                                                    "IMAD.X": 1, "IMAD": 1, "other": 1}
    assert chip_smoke.sass_classes(fns["other"])["LDL"] == 1


def test_u32_op_count_follows_the_kernel_structure():
    """u32_ops_per_lane: a product is 64 widening multiplies, 8 of the fold
    and one a fold step (two FMA issues each), a square 36 + 8 + 2; the
    window loop 33 rounds of 4 doublings and 4 adds with β·X; the full
    variant adds the two pow ladders of 14 table products and 64 windows."""
    ops = chip_smoke.u32_ops_per_lane()
    assert ops["mul"]["mul"] == 2 * (64 + 8 + 2) and ops["sqr"]["mul"] == 2 * (36 + 8 + 2)
    assert ops["pow_const"] == chip_smoke._rep(14, ops["mul"]) + chip_smoke._rep(
        64, chip_smoke._rep(4, ops["sqr"]) + ops["mul"] + chip_smoke._ops(alu=3))
    extra = ops["full"].copy()
    extra.subtract(ops["schnorr_free"])
    want = (chip_smoke._rep(2, ops["mul"]) + chip_smoke._rep(2, ops["pow_const"])
            + ops["sub"] + ops["canonical"] + chip_smoke._ops(alu=8 + 1) + ops["canonical"])
    assert +extra == want
    products = ops["schnorr_free"]["mul"] // 2
    # 14 table adds and 33 windows of 4 adds (12 products, 3 small), 4
    # doublings (8 products, 3 small) and β·X; the tail's 5; the conversions'
    # and the folds' products
    assert products > 74 * ((14 + 132) * 12 + 132 * 6 + 33 + 5) + 46 * 132 * 2


def test_u32_bound_sits_below_the_radix11_one():
    sm, clock = 132, 1980.0
    for sf in (False, True):
        u32, by = chip_smoke.u32_bound_ms(32768, sf, sm, clock)
        radix = chip_smoke.verify_bounds(32768, 0, sf, 4, "projective", "lazy", "tree", "half",
                                         sm, clock)
        assert by == "operations" and u32 < radix["radix11_bound_ms"] / 2
        assert radix["bound_ms"] == radix["u32_bound_ms"] == radix["formulation_bound_ms"] == u32
        yard = chip_smoke.verify_bounds(32768, 0, sf, 4, "projective", "lazy", "tree", "half",
                                        sm, clock, "shift_add", chip_smoke.YARDSTICK_LIBRARY)
        assert yard["formulation_bound_ms"] == yard["radix11_bound_ms"] > yard["bound_ms"]
    five = chip_smoke.verify_bounds(32768, 0, False, 5, "projective", "lazy", "tree", "half",
                                    sm, clock)
    assert "u32_bound_ms" not in five and five["bound_ms"] == five["radix11_bound_ms"]


def test_kernel_vs_plain_runs_the_yardstick_and_the_u32_lane_counts():
    """Phase 3 with the default tuple's yardstick: that kind launches under
    shift-add by name in the yardstick's library too, against the shared
    output, and the 8-word kernel on each
    extra lane count, its batch from the first non-ECDSA item in the full
    variant (wrapping around), held against those lanes of the shared
    output; a wrong lane fails the phase."""
    kinds = chip_smoke.instantiations((4,), ("projective",))
    # item i: (tag, i, r, s), lane 9 a Schnorr one
    items = [("e", i, 1, 1) if i != 9 else ("e", i, 1, 1, "schnorr") for i in range(40)]
    oracle = [i % 3 == 0 for i in range(40)]
    launched, rows = [], []
    yard = {chip_smoke.U32_KIND: chip_smoke.YARDSTICK_LIBRARY}

    def make_args(batch, wb, variant):
        return list(batch), variant == "schnorr_free"

    def verdicts(args):
        return torch.tensor([oracle[it[1]] for it in args])

    def launch(args, sf, form, reduce, select, ladder, sqr, mul, library):
        launched.append(([it[1] for it in args], sf, select, ladder, sqr, mul, library))
        return verdicts(args)

    def plain(args, sf, form, reduce, select, ladder, sqr, mul):
        return verdicts(args)

    def timer(fn, repeats):
        fn()
        return 1.0

    max_err, _ = chip_smoke.kernel_vs_plain([("full", items, oracle)], kinds, make_args, launch,
                                            plain, timer, rows.append,
                                            yardstick=yard, u32_lanes=(1, 31, 33, 4097))
    assert [x[1:] for x in launched if x[6] is not None] == [
        (False, "tree", "scan", "half", "shift_add", "verify_half")]
    extra = [x[0] for x in launched if len(x[0]) != 40 and x[5] == "shift_add"]
    assert [len(lanes) for lanes in extra] == [1, 31, 33, 4097]
    assert all(lanes[i] == (9 + i) % 40 for lanes in extra for i in range(len(lanes)))
    assert [r["lanes"] for r in rows if r["phase"] == "u32_lanes"] == [1, 31, 33, 4097]
    assert (*chip_smoke.U32_KIND, "full", "shift_add", "verify_half") in max_err
    assert (4, "projective", "lazy", "onehot", "half", "full", "shift_add",
            "verify_half") not in max_err

    def wrong(args, sf, form, reduce, select, ladder, sqr, mul, library):
        out = verdicts(args)
        if len(args) == 31:
            out[-1] = ~out[-1]
        return out

    with pytest.raises(RuntimeError, match="u32 at 31 lanes"):
        chip_smoke.kernel_vs_plain([("full", items, oracle)], kinds, make_args, wrong, plain,
                                   timer, rows.append, yardstick=yard,
                                   u32_lanes=(31,))
    launched.clear()
    ecdsa = [it for it in items if len(it) == 4]
    chip_smoke.kernel_vs_plain([("schnorr_free", ecdsa, [oracle[it[1]] for it in ecdsa])],
                               kinds, make_args, launch, plain, timer, rows.append,
                               yardstick=yard, u32_lanes=(1, 33))
    assert [(x[0][0], len(x[0]), x[1]) for x in launched
            if len(x[0]) != 39 and x[5] == "shift_add"] == [(0, 1, True), (0, 33, True)]


def test_kernel_timing_times_the_yardstick_in_turns_with_the_u32_kernel():
    """Phase 6 with the yardstick right after the default tuple's shift-add
    kind (the 8-word kernel): both bursts there and back, each compared with
    the shared plain output, u32_over_radix11 their means' ratio, and the
    dot_general row's twin the yardstick."""
    u32 = chip_smoke.U32_KIND
    kinds = [(*u32, "shift_add", None), (*u32, "shift_add", "verify_half"),
             (*u32, "dot_general", None)]
    bursts = []

    def make_args(items, lanes, wb, variant):
        return (lanes, wb), variant == "schnorr_free"

    def verdicts(args):
        return torch.arange(args[0]) % 3 == 0

    def launch(args, sf, form, reduce, select, sqr, mul, library):
        bursts.append((mul, library))
        return verdicts(args)

    def timer(fn, repeats):
        fn()
        return {("shift_add", None): 2.0, ("shift_add", "verify_half"): 10.0,
                ("dot_general", None): 40.0}[bursts[-1]] if repeats > 1 else 1.0

    rows = chip_smoke.kernel_timing([("full", list(range(64)))], kinds, make_args, launch,
                                    lambda *a: verdicts(a[0]), timer, lane_counts=(64, 8))
    yard = rows[(*u32, "shift_add", "verify_half", "full", 64)]
    assert yard["u32_over_radix11"] == 0.2 and len(yard["ms_runs"]) == 2
    assert yard["library"] == "verify_half" and yard["plain_shared"] is True
    assert rows[(*u32, "dot_general", None, "full", 64)]["mul_dot_over_shift_add"] == 4.0
    with pytest.raises(ValueError, match="right after its shift-add twin"):
        chip_smoke.kernel_timing([("full", list(range(64)))], kinds[1:], make_args, launch,
                                 lambda *a: verdicts(a[0]), timer, lane_counts=(64, 8))


def test_trace_breakdown_counts_the_u32_kernel(tmp_path):
    """The traced main path's verify kernel is the 8-word one since the
    default tuple runs it: its launches and device time are counted."""
    import json

    def ev(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [ev("main_path", "user_annotation", 0.0, 1000.0),
              ev("void tpn::u32::verify_u32_kernel<false>(tpn::u32::VerifyArgs, int const*)",
                 "kernel", 100.0, 300.0),
              ev("void tpn::u32::verify_u32_kernel<true>(tpn::u32::VerifyArgs, int const*)",
                 "kernel", 500.0, 100.0),
              ev("void tpn::field_mul_u32_kernel(int const*, int const*, int*, int)", "kernel",
                 700.0, 10.0)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = chip_smoke.trace_breakdown(str(path))
    assert got["verify_kernel_launches"] == 2
    assert got["verify_kernel_ms"] == pytest.approx(0.4)
    assert got["device_busy_ms"] == pytest.approx(0.41)
