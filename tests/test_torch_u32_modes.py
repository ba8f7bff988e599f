"""The one-hot eager affine tuples on the 8-word arithmetic: 4-bit windows,
affine, eager, one-hot select, shift-add, with the half-product or the
full-product square (``csrc/verify_u32_modes.cu`` over ``field_u32.cuh`` and
``curve_u32.cuh``'s eager bodies; libraries ``verify_u32_modes_half`` and
``verify_u32_modes_mul``, one a square).

``tpunode_torch/csrc/host_u32_modes.cpp`` wraps the eager point formulas,
the square and the pows under either square, the affine Q table, the one-hot
select and the per-lane program in a plain C interface; the module fixture
builds it once with ``g++ -O1 -fsanitize=undefined -fno-sanitize-recover=all``
into a temporary directory.  The formulas are held against Python integers
(the group law of ``ecdsa_cpu``) and against the plain
``tpunode_torch.verify.curve`` eager formulas mod p; the affine table against
Python modular inverses of the plain projective chain and against k·Q; the
one-hot select against the tree select; the per-lane program against the
port's plain ``verify_core`` at these modes, the reference's
``tpunode.verify.kernel.verify_core`` run on the CPU at these modes and the
oracle.  Routing is checked by a spy on the library loader.  The
``gpu``-marked cases run the kernel on a card.  Words, limbs and verdicts are
integers: every comparison is exact.
"""

import contextlib
import ctypes
import random
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from tpunode.verify import curve as RC
from tpunode.verify import field as RF
from tpunode.verify import kernel as RK
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
MODES = {sqr: (4, "affine", "eager", "onehot", sqr, "shift_add") for sqr in ("half", "mul")}
SQR_CODE = {"half": 0, "mul": 1}
LIBRARY = {"half": "verify_u32_modes_half", "mul": "verify_u32_modes_mul"}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """host_u32_modes.cpp built once under UBSan."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    out = tmp_path_factory.mktemp("hostu32m") / "libtpn_host_u32_modes.so"
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(out), str(CSRC / "host_u32_modes.cpp")],
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


def _int(row) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(row))


def _random(rng: np.random.Generator, n: int) -> list:
    """``n`` values in [0, 2^256): weakly reduced elements, p and above too."""
    return [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]


def _pts(pts, coords: int = 3) -> np.ndarray:
    """Points of ints as (n, coords, 8) words."""
    return np.ascontiguousarray(np.stack([_words(pt[:coords]) for pt in pts]))


def _limbs(pts, coords: int = 3) -> torch.Tensor:
    """Points of ints as the plain version's (coords, 24, n) canonical limbs."""
    return torch.from_numpy(np.stack([np.stack([F.to_limbs(v % P) for v in coord], axis=1)
                                      for coord in list(zip(*pts))[:coords]]).astype(np.int32))


def _plain_ints(t: torch.Tensor) -> list:
    a = t.numpy()
    return [tuple(F.from_limbs(a[c, :, i]) % P for c in range(a.shape[0]))
            for i in range(a.shape[-1])]


def _affine(pt) -> tuple:
    """A projective point of ints as affine (x, y) mod p, or None at infinity."""
    x, y, z = (v % P for v in pt)
    if z == 0:
        return None
    zi = pow(z, -1, P)
    return x * zi % P, y * zi % P


def _o(pt) -> tuple:
    return None if pt.x is None else (pt.x, pt.y)


def _scaled(pt, z) -> tuple:
    return (pt.x * z % P, pt.y * z % P, z)


def _real_points(rng: np.random.Generator, n: int) -> list:
    return [O.point_mul(int(k), O.GENERATOR) for k in rng.integers(1, 2**62, size=n)]


# ---------- the eager formulas --------------------------------------------------


def _point_op(lib, op: int, ps, qs, q_coords: int = 3) -> list:
    p, q = _pts(ps), _pts(qs, q_coords)
    out = np.zeros_like(p)
    assert lib.tpn_u32m_point(_ptr(p), _ptr(q), _ptr(out), len(ps), op) == 0
    assert all(_int(c) < TOP for pt in out for c in pt)
    return [tuple(_int(c) % P for c in pt) for pt in out]


@pytest.mark.parametrize("formula", ["pt_add_eager", "pt_double_eager_half",
                                     "pt_double_eager_mul", "pt_add_mixed_eager"])
def test_eager_formula_matches_python_integers_and_the_plain_version(lib, formula):
    """Each eager body on real points (Z scaled; with themselves, their
    negatives, infinity and another point) against the group law in Python
    integers, and on those and random coordinates below 2^256 (p and above
    among them) against the plain eager formula, coordinate for coordinate
    mod p: its subtractions are negative for many of these lanes."""
    rng = np.random.default_rng(0xE4 + len(formula))
    reals = _real_points(rng, 8)
    zs = [v % P or 1 for v in _random(rng, 8)]
    ps, qs = [], []
    if formula == "pt_add_mixed_eager":
        for pt, z in zip(reals, zs):
            for q in (pt, O.Point(pt.x, P - pt.y), reals[0], reals[3]):
                ps.append(_scaled(pt, z))
                qs.append((q.x, q.y, 1))
            ps.append((0, 1, 0))
            qs.append((pt.x, pt.y, 1))
    else:
        for pt, z in zip(reals, zs):
            for q in (_scaled(pt, 3), (pt.x, P - pt.y, 1), (0, 1, 0), _scaled(reals[0], 5)):
                ps.append(_scaled(pt, z))
                qs.append(q)
    n_real = len(ps)
    for _ in range(16):
        ps.append(tuple(_random(rng, 3)))
        qs.append(tuple(_random(rng, 3)))
    op = {"pt_add_eager": 0, "pt_double_eager_half": 1, "pt_double_eager_mul": 2,
          "pt_add_mixed_eager": 3}[formula]
    mixed = formula == "pt_add_mixed_eager"
    got = _point_op(lib, op, ps, qs, 2 if mixed else 3)

    def from_pt(pt):
        aff = _affine(pt)
        return O.INFINITY if aff is None else O.Point(*aff)

    for g, p, q in zip(got[:n_real], ps, qs):
        if formula.startswith("pt_double"):
            want = O.point_double(from_pt(p))
        else:
            want = O.point_add(from_pt(p), from_pt(q))
        assert _affine(g) == _o(want)
    if formula == "pt_add_eager":
        plain = C.pt_add(_limbs(ps), _limbs(qs), reduce="eager")
    elif mixed:
        plain = C.pt_add_mixed(_limbs(ps), _limbs(qs, 2), reduce="eager")
    else:
        fns = F.field_ns("shift_add", "mul" if formula.endswith("mul") else "half")
        plain = C.pt_double(_limbs(ps), F=fns, reduce="eager")
    assert got == _plain_ints(plain)


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_square_and_pows_under_either_square_match_python_integers(lib, sqr):
    """square<SQR_MUL>, and pow_const<SQR_MUL>'s p-2 and Euler exponents."""
    vals = [0, 1, P - 1, P, P + 1, TOP - 1, 1 << 255] + _random(np.random.default_rng(0x5A), 8)
    out = np.zeros((len(vals), 3, 8), np.uint32)
    lib.tpn_u32m_square(_ptr(_words(vals)), _ptr(out), len(vals), SQR_CODE[sqr])
    got = [tuple(_int(c) % P for c in row) for row in out]
    assert got == [(v * v % P, pow(v, P - 2, P), pow(v, (P - 1) // 2, P)) for v in vals]


# ---------- the affine table and the one-hot select -------------------------------


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_affine_table_matches_python_inverses_and_k_q(lib, sqr):
    """Entry k of the affine table is the plain projective chain's entry k
    (eager bodies) times Python's modular inverse of its Z, and k·Q; entry 0
    is the (0, 1) placeholder.  Q at full-width coordinates, and one Q given
    by its representatives plus p."""
    rng = np.random.default_rng(0xAF)
    qs = [(pt.x, pt.y) for pt in _real_points(rng, 5)]
    qs.append(tuple(v + P if v + P < TOP else v for v in qs[0]))
    q = np.ascontiguousarray(np.stack([_words(pt) for pt in qs]))
    out = np.zeros((len(qs), 16, 2, 8), np.uint32)
    lib.tpn_u32m_affine_table(_ptr(q), _ptr(out), len(qs), SQR_CODE[sqr])
    qx = torch.from_numpy(np.stack([F.to_limbs(x % P) for x, _ in qs], axis=1).astype(np.int32))
    qy = torch.from_numpy(np.stack([F.to_limbs(y % P) for _, y in qs], axis=1).astype(np.int32))
    proj = K._build_q_table(qx, qy, 4, "eager", ladder="scan", sqr=sqr, mul="shift_add").numpy()
    for i, (x, y) in enumerate(qs):
        got = [tuple(_int(c) % P for c in out[i, k]) for k in range(16)]
        assert got[0] == (0, 1)
        for k in range(1, 16):
            X, Y, Z = (F.from_limbs(proj[k, c, :, i]) % P for c in range(3))
            zi = pow(Z, -1, P)
            assert got[k] == (X * zi % P, Y * zi % P), (i, k)
            assert got[k] == _o(O.point_mul(k, O.Point(x % P, y % P))), (i, k)


@pytest.mark.parametrize("source", ["local", "shared"])
def test_onehot_select_matches_the_tree_select(lib, source):
    """The one-hot select of every digit, and digits with bits above the
    fourth (masked as the kernel masks them), over random tables: the words
    of the entry the plain tree select picks."""
    rng = np.random.default_rng(0x5E1 + (source == "shared"))
    digits = np.array(list(range(16)) + [16 + 3, 0x7FFFFFF5, -1], dtype=np.int32)
    n = len(digits)
    tables = rng.integers(0, 2**32, size=(n, 16, 2, 8), dtype=np.uint32)
    out = np.zeros((n, 2, 8), np.uint32)
    lib.tpn_u32m_select(_ptr(tables), _ptr(digits), _ptr(out), n, int(source == "shared"))
    entries = [torch.from_numpy(tables[:, k].astype(np.int64)).permute(1, 2, 0)
               for k in range(16)]
    tree = K.select_tree16(entries, torch.from_numpy(digits.astype(np.int64) & 15))
    assert np.array_equal(out, tree.permute(2, 0, 1).numpy().astype(np.uint32))


def test_g_tables_convert_to_the_affine_window_tables(lib):
    """G's and λG's affine rows as a block converts them: each entry's
    words equal to the prep's limbs mod p."""
    rows = cuda_kernel._g_tables(torch.device("cpu"), 4, "affine")
    out = np.zeros((2, 16, 2, 8), np.uint32)
    lib.tpn_u32m_g_tables(ctypes.c_void_p(rows.data_ptr()), _ptr(out))
    limbs = rows.numpy()
    for t in range(2):
        for k in range(16):
            for c in range(2):
                assert _int(out[t, k, c]) % P == F.from_limbs(limbs[t, k, c]) % P


# ---------- the per-lane program ---------------------------------------------------


@pytest.fixture(scope="module")
def items():
    """33 adversarial items (every shape of chip_smoke.adversarial_items),
    every eighth one corrupted."""
    adv = chip_smoke.adversarial_items(O, random.Random(0x32A), lanes=33)
    return chip_smoke.corrupt_every(adv, 8)


def _scan(f, init, xs, length=None):
    """lax.scan as a Python loop over concrete values."""
    n = length if xs is None else jax.tree_util.tree_leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, None if xs is None else jax.tree_util.tree_map(lambda a: a[i], xs))
        ys.append(y)
    if ys[0] is None:
        return carry, None
    return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)


class _JitField:
    """The reference field module with its products jitted one call at a
    time (traced under the active field modes); every other name is the
    module's."""

    def __init__(self):
        for name in ("mul", "sqr", "mul_t", "sqr_t"):
            setattr(self, name, jax.jit(getattr(RF, name)))
        self.mul_small_red = jax.jit(RF.mul_small_red, static_argnums=(1,))

    def __getattr__(self, name):
        return getattr(RF, name)


@contextlib.contextmanager
def reference_modes(sqr: str):
    """The reference's ``verify_core`` at (4, affine, eager, onehot, ``sqr``,
    shift_add), run op by op on the CPU: its modes set, its scans and
    conds as Python loops and branches over concrete values, and its field
    products jitted one at a time (a jit of the whole program compiles for
    ~100 s a mode on the CPU).  Every mode and every swapped name is
    restored in ``finally``."""
    prev_kernel = RK.set_kernel_modes(select="onehot", window_bits=4)
    prev_field = RF.set_field_modes(mul="shift_add", sqr=sqr, reduce="eager")
    prev_form = RC.set_point_form("affine")
    saved = RK.lax, RK.F, RK.pt_add, RK.pt_double, RK.pt_add_mixed
    try:
        jf = _JitField()
        RK.lax = types.SimpleNamespace(scan=_scan, cond=lambda p, t, f: t() if bool(p) else f())
        RK.F = jf
        RK.pt_add = lambda p, q: RC.pt_add(p, q, F=jf)
        RK.pt_double = lambda p: RC.pt_double(p, F=jf)
        RK.pt_add_mixed = lambda p, q: RC.pt_add_mixed(p, q, F=jf)
        assert RK.kernel_modes() == ("shift_add", sqr, "eager", "affine", "onehot", "scan", 4)
        yield
    finally:
        RK.lax, RK.F, RK.pt_add, RK.pt_double, RK.pt_add_mixed = saved
        RC.set_point_form(prev_form)
        RF.set_field_modes(mul=prev_field[0], sqr=prev_field[1], reduce=prev_field[2])
        RK.set_kernel_modes(select=prev_kernel[0], window_bits=prev_kernel[2])


@pytest.fixture(scope="module", params=["half", "mul"])
def reference(request, items):
    """The reference's verify_core on the CPU at the tuple of the square
    ``sqr`` over the 33 items: (sqr, its verdicts)."""
    sqr = request.param
    with reference_modes(sqr):
        prep = RK.prepare_batch(items, pad_to=len(items), native=False)
        out = RK.verify_core(*(jnp.asarray(a) for a in prep.device_args))
        verdicts = [bool(v) for v in np.asarray(out)]
    assert RK.kernel_modes() == ("shift_add", "half", "lazy", "projective", "tree", "scan", 4)
    return sqr, verdicts


def _host_verify(lib, args, schnorr_free: bool, sqr: str) -> list:
    tables = cuda_kernel._g_tables(torch.device("cpu"), 4, "affine")
    out = torch.zeros(args[8].shape[-1], dtype=torch.bool)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (tables, *args, out)]
    assert lib.tpn_u32m_verify(*ptrs, out.shape[0], int(schnorr_free), SQR_CODE[sqr]) == 0
    return out.tolist()


@pytest.mark.parametrize("variant", ["full", "schnorr_free"])
def test_verify_lane_matches_plain_reference_and_oracle(lib, items, reference, variant):
    """verify_lane at B = 1, 31 and 33 at the tuple of each square: each
    lane's verdict the port's plain verify_core's at those modes on the
    33-lane batch (a lane's verdict depends on its item alone), the
    reference's verify_core's there (its one program is the full variant's;
    the schnorr_free batch's items are the full batch's ECDSA ones) and the
    oracle's."""
    sqr, ref = reference
    ref_by_item = dict(zip(map(id, items), ref))
    batch = items if variant == "full" else chip_smoke.tile(
        [it for it in items if len(it) == 4], 33)
    prep = K.prepare_batch_raw(pack_items(batch), pad_to=33, window_bits=4)
    assert prep.schnorr_free == (variant == "schnorr_free")
    _, form, reduce, select, _, mul = MODES[sqr]
    with torch.inference_mode():
        plain = K.verify_core(*K.from_reference(prep.device_args, "cpu"),
                              schnorr_free=prep.schnorr_free, point_form=form, reduce=reduce,
                              select=select, ladder="scan", sqr=sqr, mul=mul).tolist()
    oracle = O.verify_batch_cpu(batch)
    assert plain == [ref_by_item[id(it)] for it in batch] == oracle
    assert 0 < sum(oracle) < len(oracle)
    for b in (1, 31, 33):
        prep = K.prepare_batch_raw(pack_items(batch[:b]), pad_to=b, window_bits=4)
        got = _host_verify(lib, K.from_reference(prep.device_args, "cpu"),
                           variant == "schnorr_free", sqr)
        assert got == plain[:b], b


def test_verify_refuses_another_square_code(lib, items):
    prep = K.prepare_batch_raw(pack_items(items[:1]), pad_to=1, window_bits=4)
    args = K.from_reference(prep.device_args, "cpu")
    tables = cuda_kernel._g_tables(torch.device("cpu"), 4, "affine")
    out = torch.zeros(1, dtype=torch.bool)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (tables, *args, out)]
    assert lib.tpn_u32m_verify(*ptrs, 1, 0, 2) == 1


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
        self.tpn_verify_u32_modes, self.tpn_verify_blocked = _Entry(ret), _Entry(ret)
        self.tpn_verify_u32 = _Entry(ret)
        self.tpn_u32_modes_error_string = self.tpn_error_string = (
            lambda err: b"invalid argument")


def _spy_loader(monkeypatch, ret=0, fail=()) -> tuple:
    loaded, libs = [], {}

    def load(name):
        loaded.append(name)
        if name in fail:
            raise RuntimeError(f"nvcc failed (1): {name}")
        return libs.setdefault(name, _Lib(ret))

    monkeypatch.setattr(cuda_kernel, "load_library", load)
    return loaded, libs


def test_exactly_the_two_tuples_route_to_the_new_library():
    """Every mode tuple: the two one-hot eager affine 4-bit shift-add ones go
    to the new library of their square, the default to verify_u32, every
    other to the radix-11 library of its (multiply, square)."""
    assert cuda_kernel.U32_MODES_LIBRARIES == LIBRARY
    assert cuda_kernel.U32_MODES_TUPLES == tuple(MODES.values())
    seen = 0
    for wb in (4, 5):
        for form in ("projective", "affine"):
            for reduce in ("lazy", "eager"):
                for select in ("tree", "onehot"):
                    for sqr in ("half", "mul"):
                        for mul in ("shift_add", "dot_general"):
                            modes = (wb, form, reduce, select, sqr, mul)
                            if modes == cuda_kernel.U32_MODES:
                                want = "verify_u32"
                            elif modes in MODES.values():
                                want = LIBRARY[sqr]
                                seen += 1
                            else:
                                want = cuda_kernel.VERIFY_LIBRARIES[(mul, sqr)]
                            assert cuda_kernel.kernel_library(*modes) == want, modes
    assert seen == 2


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_launch_loads_the_new_library_alone_with_the_square_code(monkeypatch, sqr):
    loaded, libs = _spy_loader(monkeypatch)
    modes, name = MODES[sqr], LIBRARY[sqr]
    load, codes = cuda_kernel._entry(name, modes)
    assert loaded == [] and codes == (SQR_CODE[sqr],)
    cuda_kernel._launch(name, load, [None] * 18, 7, True, codes, None)
    assert loaded == [name]
    lib = libs[name]
    assert lib.tpn_verify_u32_modes.calls == [(*[None] * 18, 7, 1, SQR_CODE[sqr], None)]
    assert not lib.tpn_verify_blocked.calls and not lib.tpn_verify_u32.calls


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_failed_build_or_launch_of_the_new_library_raises_without_fallback(monkeypatch, sqr):
    name = LIBRARY[sqr]
    load, codes = cuda_kernel._entry(name, MODES[sqr])
    loaded, _ = _spy_loader(monkeypatch, fail=(name,))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_kernel._launch(name, load, [None] * 18, 7, False, codes, None)
    assert loaded == [name]  # never the radix-11 library
    loaded, _ = _spy_loader(monkeypatch, ret=1)
    with pytest.raises(RuntimeError, match=f"launch failed \\({name}\\): invalid"):
        cuda_kernel._launch(name, load, [None] * 18, 7, False, codes, None)
    assert loaded == [name]


def test_entry_refuses_the_new_library_at_other_modes(monkeypatch):
    """Before anything loads; the radix-11 entries of the two tuples stay in
    verify_half and verify_mul (the yardsticks), audited as radix-11."""
    loaded, _ = _spy_loader(monkeypatch)
    audited = []
    monkeypatch.setattr(cuda_kernel._bounds, "assert_formulas_safe",
                        lambda *a, **k: audited.append((a, k)))
    for modes in (cuda_kernel.U32_MODES, (4, "affine", "eager", "tree", "half", "shift_add"),
                  (5, "affine", "eager", "onehot", "half", "shift_add"),
                  (4, "affine", "eager", "onehot", "half", "dot_general"), MODES["mul"]):
        with pytest.raises(ValueError, match="runs the modes"):
            cuda_kernel._entry(LIBRARY["half"], modes)
    with pytest.raises(ValueError, match="runs the modes"):
        cuda_kernel._entry(LIBRARY["mul"], MODES["half"])
    with pytest.raises(ValueError, match="runs the modes"):
        cuda_kernel._entry("verify_u32", MODES["half"])
    assert cuda_kernel._entry("verify_half", MODES["half"])[1][:4] == (4, 1, 1, 1)
    assert cuda_kernel._entry("verify_mul", MODES["mul"])[1][4] == 1
    assert len(audited) == 2 and loaded == []


def test_new_library_builds_from_its_own_source_and_is_counted():
    """One source, one library a square under -DTPN_SQR_MUL, as verify_half
    and verify_mul are; both counted by library."""
    for sqr, name in LIBRARY.items():
        assert cuda_kernel._LIBRARIES[name] == ("verify_u32_modes.cu",
                                                (f"TPN_SQR_MUL={SQR_CODE[sqr]}",))
        assert {(name, v) for v in cuda_kernel.VARIANTS} <= set(cuda_kernel.LIBRARY_LAUNCHES)
    text = (CSRC / "verify_u32_modes.cu").read_text()
    assert '#include "curve_u32.cuh"' in text and "__launch_bounds__(128, 2)" in text
    assert "if (sqr != TPN_SQR_MUL) return" in text


# ---------- on a card ------------------------------------------------------------


@pytest.fixture(scope="module")
def card_items():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return chip_smoke.corrupt_every(
        chip_smoke.adversarial_items(O, random.Random(0x32D), lanes=200), 8)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 31, 33, 200])
@pytest.mark.parametrize("variant", ["full", "schnorr_free"])
@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_u32_modes_kernel_on_card_matches_plain_and_radix11(card_items, sqr, variant, lanes):
    """The routed tuple launches its new library; its verdicts equal the
    plain version's, the oracle's and the radix-11 entry's by name."""
    batch = card_items if variant == "full" else chip_smoke.tile(
        [it for it in card_items if len(it) == 4], 200)
    batch = batch[:lanes]
    prep = K.prepare_batch_raw(pack_items(batch), pad_to=lanes, window_bits=4)
    args = K.from_reference(prep.device_args, "cuda")
    _, form, reduce, select, _, mul = MODES[sqr]
    modes = dict(schnorr_free=variant == "schnorr_free", point_form=form, reduce=reduce,
                 select=select, ladder="scan", sqr=sqr, mul=mul)
    counts = dict(cuda_kernel.LIBRARY_LAUNCHES)
    got = cuda_kernel.verify_blocked(*args, **modes)
    counts[(LIBRARY[sqr], variant)] += 1
    assert cuda_kernel.LIBRARY_LAUNCHES == counts
    radix11 = cuda_kernel.verify_with(cuda_kernel.VERIFY_LIBRARIES[(mul, sqr)], *args, **modes)
    plain = K.verify_core(*args, **modes)
    assert got.tolist() == radix11.tolist() == plain.tolist() == O.verify_batch_cpu(batch)


@pytest.mark.gpu
@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_engine_on_card_at_the_tuple_runs_on_verify_u32_modes(card_items, sqr):
    with chip_smoke.select_knob("onehot"), chip_smoke.sqr_knob(sqr):
        engine = VerifyEngine(VerifyConfig(batch_size=64, device_batch=128, point_form="affine",
                                           field_reduce="eager"))
    assert engine.wait_warmup(600) == "ready"  # its launches are not the test's
    counts = dict(cuda_kernel.LIBRARY_LAUNCHES)
    assert engine.verify_sync(card_items) == O.verify_batch_cpu(card_items)
    counts[(LIBRARY[sqr], "full")] += 2  # 128 + a 72-item tail padded to 128
    assert cuda_kernel.LIBRARY_LAUNCHES == counts


# ---------- chip_smoke.py's phases for the new kernel, against stubs ---------------


@pytest.mark.parametrize("sqr", ["half", "mul"])
def test_u32_modes_op_count_follows_the_kernel_structure(sqr):
    """u32_ops_per_lane at the tuple: the mixed add 11 products and 2
    scalings, the doubling's squares in the tuple's square, the affine table
    14 adds, 13 prefix and 55 suffix products and a Fermat ladder; a window
    4 doublings and 4 mixed adds each with a one-hot select over 16 entries
    of 16 words; the full variant adds the two pow ladders."""
    kind = chip_smoke.U32_MODES_KINDS[sqr == "mul"]
    assert kind == (4, "affine", "eager", "onehot", sqr)
    ops, rep = chip_smoke.u32_ops_per_lane(kind), chip_smoke._rep
    square = ops["mul"] if sqr == "mul" else ops["sqr"]
    assert ops["square"] == square
    assert ops["pt_add_mixed"] == (rep(11, ops["mul"]) + rep(2, ops["mul_small"])
                                   + rep(10, ops["add"]) + rep(3, ops["sub"]))
    assert ops["pt_double"] == (rep(6, ops["mul"]) + rep(2, square) + rep(2, ops["mul_small"])
                                + rep(5, ops["add"]) + ops["sub"])
    assert ops["select"] == chip_smoke._ops(alu=16 * (2 + 16))
    assert ops["pow_const"] == rep(14, ops["mul"]) + rep(
        64, rep(4, square) + ops["mul"] + chip_smoke._ops(alu=3))
    extra = ops["full"].copy()
    extra.subtract(ops["schnorr_free"])
    want = (rep(2, ops["mul"]) + rep(2, ops["pow_const"]) + ops["sub"] + ops["canonical"]
            + chip_smoke._ops(alu=8 + 1) + ops["canonical"])
    assert +extra == want
    default = chip_smoke.u32_ops_per_lane()
    assert default["mul"] == ops["mul"] and "pt_add_mixed" not in default
    with pytest.raises(ValueError, match="no 8-word kernel"):
        chip_smoke.u32_ops_per_lane((4, "affine", "eager", "tree", "half"))


def test_u32_modes_bound_is_its_own_count_and_the_functions_least():
    """verify_bounds at the tuple: u32_bound_ms in the row's own square, the
    function's bound the half square's 8-word count (below the radix-11
    one), the routed launch's formulation its own count and the yardstick's
    the radix-11 count in its square."""
    sm, clock = 132, 1980.0
    half_kind, mul_kind = chip_smoke.U32_MODES_KINDS
    for sf in (False, True):
        half, _ = chip_smoke.u32_bound_ms(32768, sf, sm, clock, half_kind)
        full_product, _ = chip_smoke.u32_bound_ms(32768, sf, sm, clock, mul_kind)
        assert half < full_product
        for kind in (half_kind, mul_kind):
            routed = chip_smoke.verify_bounds(32768, 0, sf, *kind, sm, clock)
            assert routed["bound_ms"] == half < routed["radix11_bound_ms"] / 2
            assert routed["u32_bound_ms"] == routed["formulation_bound_ms"] == (
                half if kind == half_kind else full_product)
            yard = chip_smoke.verify_bounds(32768, 0, sf, *kind, sm, clock, "shift_add",
                                            chip_smoke.YARDSTICKS[kind])
            assert yard["bound_ms"] == half and yard["formulation_bound_ms"] > half
    tree = chip_smoke.verify_bounds(32768, 0, False, 4, "affine", "eager", "tree", "half", sm,
                                    clock)
    assert "u32_bound_ms" not in tree and tree["bound_ms"] == tree["radix11_bound_ms"]
    assert chip_smoke.u32_select_bytes(1, half_kind) == {"local": 2 * 33 * 16 * 64,
                                                         "shared": 2 * 33 * 16 * 64}
    assert chip_smoke.u32_select_bytes(1) == {"local": 2 * 33 * 96, "shared": 2 * 33 * 96}


def test_ptxas_entries_key_the_u32_modes_kernel_and_the_snapshot_skips_them():
    def entry(name, regs):
        return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {name}\n"
                f"    2500 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
                f"ptxas info    : Used {regs} registers, used 1 barriers, 2176 bytes smem\n")

    log = "".join(entry(f"_ZN3tpn3u325modes23verify_u32_modes_kernelILb{sf}ELb{sq}EEEvNS1_10"
                        f"VerifyArgsEPKi", 200 + 2 * sf + sq) for sf in (0, 1) for sq in (0, 1))
    got = chip_smoke.ptxas_entries(log)
    assert set(got) == {f"{v}/u32_modes/{s}" for v in ("full", "schnorr_free")
                        for s in ("half", "mul")}
    assert got["schnorr_free/u32_modes/mul"]["registers"] == 203
    assert [chip_smoke.u32_ptxas_key(kind, "full") for kind in chip_smoke.YARDSTICKS] == [
        "full/u32", "full/u32_modes/half", "full/u32_modes/mul"]
    line = {"registers": 1, "smem": 0, "stack_frame": 0, "spill_stores": 0, "spill_loads": 0}
    snap = {"source": "s", "nvcc": "n", "nvcc_flags": [], "entries": {"full/w4/a": line}}
    held = chip_smoke.ptxas_vs_snapshot({"full/w4/a": line, **got}, snap, "n", ())
    assert (held["entries"], held["equal"], held["differ"]) == (1, 1, {})


def test_kernel_vs_plain_launches_each_yardstick_and_the_new_kernels_lane_counts():
    """Phase 3 with the yardsticks dict at 4-bit: each of the two tuples
    launches shift-add by name in its radix-11 library beside its routed
    launch, against the shared output, and its routed kernel once more on
    each extra lane count, after the default tuple's."""
    kinds = chip_smoke.instantiations((4,), ("projective", "affine"))
    items = [("e", i, 1, 1) if i != 5 else ("e", i, 1, 1, "bip340") for i in range(40)]
    oracle = [i % 4 == 1 for i in range(40)]
    launched, rows = [], []

    def make_args(batch, wb, variant):
        return list(batch), variant == "schnorr_free"

    def verdicts(args):
        return torch.tensor([oracle[it[1]] for it in args])

    def launch(args, sf, form, reduce, select, ladder, sqr, mul, library):
        launched.append((len(args), reduce, select, sqr, mul, library))
        return verdicts(args)

    def plain(args, sf, form, reduce, select, ladder, sqr, mul):
        return verdicts(args)

    def timer(fn, repeats):
        fn()
        return 1.0

    max_err, _ = chip_smoke.kernel_vs_plain([("full", items, oracle)], kinds, make_args, launch,
                                            plain, timer, rows.append,
                                            yardstick=chip_smoke.YARDSTICKS,
                                            u32_lanes=(1, 31))
    assert [x[1:] for x in launched if x[5] is not None] == [
        ("lazy", "tree", "half", "shift_add", "verify_half"),
        ("eager", "onehot", "half", "shift_add", "verify_half"),
        ("eager", "onehot", "mul", "shift_add", "verify_mul")]
    assert [(r["kernel"], r["lanes"]) for r in rows if r["phase"] == "u32_lanes"] == [
        ("u32", 1), ("u32", 31), ("u32_modes/half", 1), ("u32_modes/half", 31),
        ("u32_modes/mul", 1), ("u32_modes/mul", 31)]
    for kind in chip_smoke.U32_MODES_KINDS:
        assert (*kind, "full", "shift_add", chip_smoke.YARDSTICKS[kind]) in max_err

    def wrong(args, sf, form, reduce, select, ladder, sqr, mul, library):
        out = verdicts(args)
        if len(args) == 31 and sqr == "mul":
            out[-1] = ~out[-1]
        return out

    with pytest.raises(RuntimeError, match="u32_modes/mul at 31 lanes"):
        chip_smoke.kernel_vs_plain([("full", items, oracle)], kinds, make_args, wrong, plain,
                                   timer, rows.append, yardstick=chip_smoke.YARDSTICKS,
                                   u32_lanes=(31,))


def test_trace_breakdown_counts_the_u32_modes_kernel_and_device_kernels_reads_each(tmp_path):
    import json

    def ev(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [ev("main_path", "user_annotation", 0.0, 1000.0),
              ev("void tpn::u32::modes::verify_u32_modes_kernel<false, true>("
                 "tpn::u32::modes::VerifyArgs, int const*)", "kernel", 100.0, 300.0),
              ev("void tpn::trivial_kernel(int const*, int*, int)", "kernel", 500.0, 2.0),
              ev("void tpn::trivial_kernel(int const*, int*, int)", "kernel", 600.0, 4.0)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = chip_smoke.trace_breakdown(str(path))
    assert got["verify_kernel_launches"] == 1 and got["verify_kernel_ms"] == pytest.approx(0.3)
    kernels = chip_smoke.device_kernels(str(path))
    assert kernels["void tpn::trivial_kernel(int const*, int*, int)"] == [0.002, 0.004]
    assert len(kernels) == 2


# ---------- the build: a library's PTX kept from its own nvcc process ----------------


FAKE_NVCC = '''#!{python}
"""A stand-in for nvcc: writes the -o file, a PTX file under -keep-dir
(unless FAKE_NVCC_NO_PTX is set) and the ptxas line nvcc -Xptxas -v prints."""
import os, sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open(out, "w") as f:
    f.write("ptx of " + args[-1] if "-ptx" in args else "library")
if "-keep-dir" in args and not os.environ.get("FAKE_NVCC_NO_PTX"):
    keep = args[args.index("-keep-dir") + 1]
    with open(os.path.join(keep, "src.ptx"), "w") as f:
        f.write("kept ptx of " + args[-1])
    with open(os.path.join(keep, "src.cudafe1.cpp"), "w") as f:
        f.write("an intermediate")
print("ptxas info    : Used 8 registers")
'''


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    import sys

    tool = tmp_path / "nvcc"
    tool.write_text(FAKE_NVCC.replace("{python}", sys.executable))
    tool.chmod(0o755)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(cuda_kernel, "_nvcc", lambda: str(tool))
    monkeypatch.setattr(cuda_kernel, "_BUILD_DIR", str(build_dir))
    monkeypatch.setattr(cuda_kernel, "_lib_path",
                        lambda name: str(build_dir / f"libtpn_{name}.so"))
    monkeypatch.setattr(cuda_kernel, "BUILD_LOGS", {})
    monkeypatch.setattr(cuda_kernel, "BUILD_SECONDS", {})
    return build_dir


def test_build_keeps_each_asked_ptx_from_the_library_process(fake_nvcc, monkeypatch):
    """One nvcc process a library: the libraries asked for PTX keep it from
    their own process (no PTX-only process), the keep directories go; a
    library built already gets its PTX from a PTX-only process; a process
    that keeps no PTX fails the build."""
    paths = cuda_kernel.build(ptx=("diag", "verify_mul"))
    assert set(paths) == set(cuda_kernel._LIBRARIES)
    assert set(cuda_kernel.BUILD_SECONDS) == set(cuda_kernel._LIBRARIES)
    for name in ("diag", "verify_mul"):
        src = cuda_kernel._LIBRARIES[name][0]
        assert Path(paths[name] + ".ptx").read_text().startswith("kept ptx of ")
        assert Path(paths[name] + ".ptx").read_text().endswith(src)
    assert not Path(paths["verify_half"] + ".ptx").exists()
    assert sorted(p.name for p in fake_nvcc.iterdir() if p.suffix not in (".so", ".log",
                                                                          ".ptx")) == []
    assert cuda_kernel.BUILD_LOGS["verify_mul"].startswith("ptxas info")
    Path(paths["verify_mul"] + ".ptx").unlink()
    cuda_kernel.build(ptx=("verify_mul",))
    assert set(cuda_kernel.BUILD_SECONDS) == {"verify_mul.ptx"}
    assert Path(paths["verify_mul"] + ".ptx").read_text().startswith("ptx of ")
    Path(paths["diag"]).unlink()
    Path(paths["diag"] + ".ptx").unlink()
    monkeypatch.setenv("FAKE_NVCC_NO_PTX", "1")
    with pytest.raises(RuntimeError, match="expected one PTX file"):
        cuda_kernel.build(ptx=("diag",))
    assert not Path(paths["diag"]).exists()
    assert not any(p.name.endswith(".keep") for p in fake_nvcc.iterdir())
