"""The port's stores against the reference's: ``MemoryKV``, ``LogKV`` (v1 and
v2 segmented, CRC, salvage), ``Namespaced``, ``NativeKV`` and ``UtxoStore``.

The same operations, from the same seeds, go through both packages, and the
stores they leave are compared byte for byte: contents, and for the durable
engines every file of the store's directory.  A directory that either
package wrote opens in the other and reads the same.  The reference's own
store tests (``tests/test_store.py``, ``tests/test_utxo.py``,
``tests/test_native_v2.py``) also run against the port, rebound by
:func:`port_reference_tests` below, which the other ``test_torch_*`` files of
the node slice share.
"""

# ---------------------------------------------------------------------------
# The reference's own test scenarios, run against the port.
#
# ``port_reference_tests`` takes a reference test module and returns its
# test functions rebound to the port: every global of the module that is a
# reference module or an object of one (``tpunode.*``) is replaced by the
# port's counterpart of the same name, helpers defined in the module are
# rebound the same way, and while a test runs ``sys.modules`` maps every
# ``tpunode.*`` name the port has to the port's module, so imports inside a
# test body reach the port too.  Helpers of ``tests/fakenet.py`` stay the
# reference's: they speak wire bytes, which both packages read alike.

import contextlib
import dataclasses
import functools
import importlib
import inspect
import pkgutil
import sys
import types
from typing import Optional

import tpunode_torch

_REF = "tpunode"
_PORT = "tpunode_torch"


def _port_module_names() -> list:
    names = [_PORT]
    for info in pkgutil.walk_packages(tpunode_torch.__path__, _PORT + "."):
        names.append(info.name)
    return names


_PORT_NAMES = _port_module_names()


def _port_module(ref_name: str):
    """The port's module for a reference module name, or None."""
    name = _PORT + ref_name[len(_REF):]
    if name not in _PORT_NAMES:
        return None
    return importlib.import_module(name)


def _is_ref_module_name(name: str) -> bool:
    return name == _REF or name.startswith(_REF + ".")


@contextlib.contextmanager
def port_imports():
    """Map every ``tpunode.*`` name the port has onto the port's module
    in ``sys.modules`` (imports inside a test body then reach the port);
    restored on exit."""
    saved = {}
    for name in _PORT_NAMES:
        ref_name = _REF + name[len(_PORT):]
        saved[ref_name] = sys.modules.get(ref_name)
        sys.modules[ref_name] = importlib.import_module(name)
    try:
        yield
    finally:
        for ref_name, mod in saved.items():
            if mod is None:
                sys.modules.pop(ref_name, None)
            else:
                sys.modules[ref_name] = mod


def _ref_index() -> dict:
    """id(object) -> (module name, attribute) over the loaded reference
    modules, preferring the module that defines the object."""
    index: dict = {}
    for mname, mod in list(sys.modules.items()):
        if mod is None or not _is_ref_module_name(mname):
            continue
        for attr, value in list(vars(mod).items()):
            if isinstance(value, types.ModuleType):
                continue
            home = getattr(value, "__module__", None)
            if id(value) not in index or home == mname:
                index[id(value)] = (mname, attr)
    return index


class _Rebinder:
    def __init__(self, overrides: Optional[dict] = None):
        self.index = _ref_index()
        self.namespaces: dict = {}
        self.done: dict = {}
        # id(reference object) -> the object a rebound test sees instead
        self.overrides = overrides or {}

    def value(self, v, home_globals):
        if id(v) in self.overrides:
            return self.overrides[id(v)]
        if isinstance(v, types.ModuleType):
            if _is_ref_module_name(v.__name__):
                pm = _port_module(v.__name__)
                return pm if pm is not None else v
            return v
        if isinstance(v, types.FunctionType) and v.__globals__ is home_globals:
            return self.function(v)
        wrapped = getattr(v, "__wrapped__", None)
        if (
            isinstance(v, types.FunctionType)
            and isinstance(wrapped, types.FunctionType)
            and wrapped.__globals__ is home_globals
        ):
            inner = self.function(wrapped)
            if inspect.isasyncgenfunction(wrapped):
                return contextlib.asynccontextmanager(inner)
            if inspect.isgeneratorfunction(wrapped):
                return contextlib.contextmanager(inner)
            return v
        if isinstance(v, type) and v.__module__ == home_globals.get("__name__"):
            return self.cls(v, home_globals)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            # a reference config built at the test module's top level
            # (``IbdConfig(batch_blocks=4)``): the port's, field for field
            cls = self.value(type(v), home_globals)
            if cls is not type(v):
                return cls(**{
                    f.name: self.value(getattr(v, f.name), home_globals)
                    for f in dataclasses.fields(v) if f.init
                })
            return v
        hit = self.index.get(id(v))
        if hit is not None:
            pm = _port_module(hit[0])
            if pm is not None and hasattr(pm, hit[1]):
                return getattr(pm, hit[1])
        return v

    def globals_for(self, g: dict) -> dict:
        new = self.namespaces.get(id(g))
        if new is None:
            new = {}
            self.namespaces[id(g)] = new
            for k, v in list(g.items()):
                new[k] = v
            for k, v in list(g.items()):
                new[k] = self.value(v, g)
        return new

    def function(self, fn):
        if id(fn) in self.done:
            return self.done[id(fn)]
        g = self.globals_for(fn.__globals__)
        defaults = fn.__defaults__
        if defaults is not None:
            defaults = tuple(self.value(d, fn.__globals__) for d in defaults)
        out = types.FunctionType(fn.__code__, g, fn.__name__, defaults, fn.__closure__)
        kwdefaults = fn.__kwdefaults__
        if kwdefaults is not None:
            kwdefaults = {k: self.value(d, fn.__globals__) for k, d in kwdefaults.items()}
        out.__kwdefaults__ = kwdefaults
        out.__qualname__ = fn.__qualname__
        out.__dict__.update(fn.__dict__)
        self.done[id(fn)] = out
        return out

    def cls(self, c, home_globals):
        if id(c) in self.done:
            return self.done[id(c)]
        body = {}
        for k, v in vars(c).items():
            if k in ("__dict__", "__weakref__"):
                continue
            if isinstance(v, types.FunctionType) and v.__globals__ is home_globals:
                v = self.function(v)
            elif isinstance(v, (staticmethod, classmethod)) and isinstance(
                v.__func__, types.FunctionType
            ):
                v = type(v)(self.function(v.__func__))
            body[k] = v
        bases = tuple(self.value(b, home_globals) for b in c.__bases__)
        out = type(c.__name__, bases, body)
        self.done[id(c)] = out
        return out


def _run_on_port(fn, engine_fields: bool = False):
    scope = engine_constants if engine_fields else contextlib.nullcontext
    if inspect.iscoroutinefunction(fn):
        @functools.wraps(fn)
        async def test(*args, **kw):
            with port_imports(), scope():
                return await fn(*args, **kw)
    else:
        @functools.wraps(fn)
        def test(*args, **kw):
            with port_imports(), scope():
                return fn(*args, **kw)
    return test


#: The reference's ``VerifyConfig`` fields that are module constants of the
#: port's engine (``verify/engine.py``), field -> constant.
ENGINE_CONSTANTS = {
    "pipeline_depth": "PIPELINE_DEPTH",
    "breaker_threshold": "BREAKER_THRESHOLD",
    "breaker_window": "BREAKER_WINDOW",
    "breaker_cooldown": "BREAKER_COOLDOWN",
    "warmup_timeout": "WARMUP_TIMEOUT",
    "warmup_retry": "WARMUP_RETRY",
    "fleet_queue": "FLEET_QUEUE",
}


def _engine_module():
    return importlib.import_module(_PORT + ".verify.engine")


def _constants_config():
    """The port's ``VerifyConfig`` taking, besides its own fields, the
    reference's fields of :data:`ENGINE_CONSTANTS`: each sets its module
    constant of the port's engine (which the engine reads when it is built
    and entered), as a port test would by monkeypatching it."""
    E = _engine_module()

    class VerifyConfig(E.VerifyConfig):
        def __init__(self, *args, **kw):
            for field, const in ENGINE_CONSTANTS.items():
                if field in kw:
                    setattr(E, const, kw.pop(field))
            super().__init__(*args, **kw)

    VerifyConfig.__qualname__ = E.VerifyConfig.__qualname__
    VerifyConfig.__module__ = E.VerifyConfig.__module__
    return VerifyConfig


_CONSTANTS_CONFIG = _constants_config()


@contextlib.contextmanager
def engine_constants():
    """While a rebound reference test runs: the port engine module's
    ``VerifyConfig`` is :func:`_constants_config`'s, and every constant of
    :data:`ENGINE_CONSTANTS` is restored on exit."""
    E = _engine_module()
    saved = {name: getattr(E, name) for name in ("VerifyConfig", *ENGINE_CONSTANTS.values())}
    E.VerifyConfig = _CONSTANTS_CONFIG
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(E, name, value)


def port_function(fn):
    """One helper of a reference test module rebound to the port (call it
    inside :func:`port_imports` when its body imports ``tpunode``)."""
    home = getattr(fn, "__wrapped__", fn).__globals__
    return _Rebinder().value(fn, home)


def port_reference_tests(ref_module, exclude=(), engine_fields: bool = False) -> dict:
    """The reference module's ``test_*`` functions rebound to the port, by
    name, less ``exclude`` (each a test the port cannot run as written;
    the caller says why beside the name).  ``engine_fields``: the tests
    build the reference's ``VerifyConfig`` with fields that are module
    constants of the port's engine (``pipeline_depth``, ``breaker_*``,
    ``warmup_*``, ``fleet_queue``); they get the port's config with those fields mapped
    onto the constants, restored after each test (:func:`engine_constants`)."""
    overrides = {}
    if engine_fields:
        ref_engine = importlib.import_module(_REF + ".verify.engine")
        overrides[id(ref_engine.VerifyConfig)] = _CONSTANTS_CONFIG
    rb = _Rebinder(overrides)
    out = {}
    missing = set(exclude) - {n for n in vars(ref_module) if n.startswith("test_")}
    assert not missing, f"excluded tests not in {ref_module.__name__}: {missing}"
    for name, fn in vars(ref_module).items():
        if not name.startswith("test_") or name in exclude:
            continue
        if not isinstance(fn, types.FunctionType):
            continue
        out[name] = _run_on_port(rb.function(fn), engine_fields)
    return out


# ---------------------------------------------------------------------------
# the reference's store tests on the port

import os
import random

import numpy as np
import pytest

import tests.test_native_v2 as ref_native_v2
import tests.test_store as ref_store
import tests.test_utxo as ref_utxo
import tpunode.native as R_native
import tpunode.store as R_store
import tpunode.utxo as R_utxo
import tpunode_torch.native as P_native
import tpunode_torch.store as P_store
import tpunode_torch.utxo as P_utxo
from tests.fixtures import all_blocks
from tpunode_torch.chaos import chaos as _port_chaos

_PORTED = {}
for _mod in (ref_store, ref_utxo, ref_native_v2):
    for _name, _fn in port_reference_tests(_mod).items():
        assert _name not in _PORTED, f"two reference tests named {_name}"
        _PORTED[_name] = _fn
globals().update(_PORTED)


@pytest.fixture(params=["memory", "log", "native"])
def kv(request, tmp_path):
    """The reference's ``kv`` fixture over the port's engines."""
    if request.param == "memory":
        s = P_store.MemoryKV()
    elif request.param == "log":
        s = P_store.LogKV(str(tmp_path / "kv.log"))
    else:
        s = P_native.NativeKV(str(tmp_path / "kv.log"))
    yield s
    s.close()


@pytest.fixture
def chaos_off():
    yield
    _port_chaos.uninstall()


def test_the_reference_store_tests_are_all_ported():
    names = [n for n in vars(ref_store) if n.startswith("test_")]
    names += [n for n in vars(ref_utxo) if n.startswith("test_")]
    names += [n for n in vars(ref_native_v2) if n.startswith("test_")]
    assert sorted(names) == sorted(_PORTED)


# ---------------------------------------------------------------------------
# the same operations through both packages

PKGS = {"ref": (R_store, R_native, R_utxo), "port": (P_store, P_native, P_utxo)}


def _ops(seed: int, n: int = 400, keys: int = 120) -> list:
    """A seeded batch stream of puts and deletes (numpy's generator)."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n // 4):
        batch = []
        for _ in range(int(rng.integers(1, 8))):
            k = b"k%d" % int(rng.integers(keys))
            if rng.random() < 0.25:
                batch.append(("del", k, b""))
            else:
                batch.append(("put", k, rng.bytes(int(rng.integers(0, 70)))))
        batches.append(batch)
    return batches


def _apply(store, batches) -> None:
    for batch in batches:
        store.write_batch(batch)


def _contents(store) -> list:
    return sorted(store.scan_prefix(b""))


def _files(directory) -> dict:
    """Every file under ``directory``, relative path -> bytes."""
    out = {}
    for root, _, names in os.walk(directory):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, directory)] = f.read()
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_memorykv_and_namespaced_hold_the_same_contents(seed):
    out = {}
    for pkg, (S, _, _) in PKGS.items():
        base = S.MemoryKV()
        _apply(base, _ops(seed))
        ns = S.Namespaced(base, b"u/")
        _apply(ns, _ops(seed + 100, n=80))
        out[pkg] = (_contents(base), _contents(ns), ns.get(b"k1"))
    assert out["ref"] == out["port"]
    assert out["ref"][1]  # the namespaced view holds rows


@pytest.mark.parametrize("compact", [False, True], ids=["segments", "compacted"])
def test_logkv_writes_the_same_files(tmp_path, compact):
    out = {}
    for pkg, (S, _, _) in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        s = S.LogKV(str(d / "kv.log"), segment_bytes=1 << 12)
        _apply(s, _ops(7))
        if compact:
            s.compact()
            _apply(s, _ops(8, n=60))
        contents = _contents(s)
        s.close()
        out[pkg] = (contents, _files(d))
    assert out["ref"][0] == out["port"][0]
    assert out["ref"][1] == out["port"][1]
    assert len(out["port"][1]) > 1  # several segments


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("compact", [False, True], ids=["segments", "compacted"])
def test_logkv_directory_opens_in_the_other_package(tmp_path, writer, compact):
    reader = "port" if writer == "ref" else "ref"
    W, Rd = PKGS[writer][0], PKGS[reader][0]
    path = str(tmp_path / "kv.log")
    s = W.LogKV(path, segment_bytes=1 << 12)
    _apply(s, _ops(11))
    if compact:
        s.compact()
    want = _contents(s)
    s.close()
    r = Rd.LogKV(path, segment_bytes=1 << 12)
    assert _contents(r) == want
    # the reader appends, and the writer reads its appends back
    _apply(r, _ops(12, n=40))
    want = _contents(r)
    r.close()
    w = W.LogKV(path, segment_bytes=1 << 12)
    assert _contents(w) == want
    w.close()


def _v1_file(path, batches) -> dict:
    """Handcraft a legacy v1 log (``<BII`` op, key length, value length)."""
    import struct

    rec = struct.Struct("<BII")
    state = {}
    with open(path, "wb") as f:
        for batch in batches:
            for op, k, v in batch:
                if op == "put":
                    f.write(rec.pack(1, len(k), len(v)) + k + v)
                    state[k] = v
                else:
                    f.write(rec.pack(2, len(k), 0) + k)
                    state.pop(k, None)
    return state


@pytest.mark.parametrize("engine", ["log", "native"])
def test_v1_log_reads_alike(tmp_path, engine):
    path = str(tmp_path / "v1.log")
    state = _v1_file(path, _ops(21))
    with open(path, "rb") as f:
        before = f.read()
    seen = []
    for pkg in ("ref", "port"):
        S, N, _ = PKGS[pkg]
        s = S.LogKV(path) if engine == "log" else N.NativeKV(path)
        seen.append(_contents(s))
        s.close()
        with open(path, "rb") as f:
            assert f.read() == before  # replay leaves the v1 file as it was
    assert seen[0] == seen[1] == sorted(state.items())


def test_salvage_of_a_corrupt_segment_is_alike(tmp_path):
    """A CRC failure in a sealed segment: both packages salvage the same
    prefix, quarantine the same bytes and leave the same directory."""
    src = tmp_path / "src"
    src.mkdir()
    s = R_store.LogKV(str(src / "kv.log"), segment_bytes=1 << 11)
    _apply(s, _ops(31))
    s.close()
    segs = sorted(n for n in os.listdir(src) if n.endswith(".seg"))
    assert len(segs) >= 3
    victim = src / segs[1]
    data = bytearray(victim.read_bytes())
    data[len(data) // 2] ^= 0xFF
    victim.write_bytes(bytes(data))
    out = {}
    for pkg in ("ref", "port"):
        d = tmp_path / pkg
        d.mkdir()
        for n, b in _files(src).items():
            (d / n).write_bytes(b)
        st = PKGS[pkg][0].LogKV(str(d / "kv.log"), segment_bytes=1 << 11)
        contents = _contents(st)
        st.close()
        out[pkg] = (contents, _files(d))
    assert out["ref"] == out["port"]
    assert any(n.endswith(".quarantine") for n in out["port"][1])


@pytest.mark.parametrize("fresh", ["v1", "v2"])
def test_nativekv_writes_the_same_files(tmp_path, fresh):
    out = {}
    for pkg, (S, N, _) in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        path = str(d / "kv.log")
        if fresh == "v2":
            s = S.LogKV(path, segment_bytes=1 << 12)
            _apply(s, _ops(41, n=100))
            s.close()
        n = N.NativeKV(path)
        _apply(n, _ops(42))
        if fresh == "v1":
            n.compact()
        contents = _contents(n)
        n.close()
        out[pkg] = (contents, _files(d))
    assert out["ref"] == out["port"]
    # and the port's native directory replays under the reference's LogKV
    r = R_store.LogKV(str(tmp_path / "port" / "kv.log"))
    assert _contents(r) == out["port"][0]
    r.close()


@pytest.mark.parametrize("case", ["fresh", "v1", "v2"])
def test_open_store_picks_the_same_engine(tmp_path, case):
    kinds = []
    for pkg, (S, _, _) in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        path = str(d / "kv.log")
        if case == "v1":
            _v1_file(path, _ops(51))
        elif case == "v2":
            s = S.LogKV(path)
            _apply(s, _ops(51))
            s.close()
        s = S.open_store(path)
        kinds.append((type(s).__name__, _contents(s)))
        s.close()
    assert kinds[0] == kinds[1]


def _generated_chain():
    """A generated BCH regtest chain with the script mix, as wire blocks
    of the reference's codec."""
    from benchmarks.txgen import gen_chain
    from tpunode.params import BCH_REGTEST

    return gen_chain(BCH_REGTEST, 3, 24, mix=True)


@pytest.mark.parametrize("path", ["apply_block", "apply_ops_blob"])
def test_utxo_store_connects_and_disconnects_alike(path):
    canned = all_blocks()
    out = {}
    for pkg in ("ref", "port"):
        S, _, U = PKGS[pkg]
        tx = __import__(
            ("tpunode" if pkg == "ref" else "tpunode_torch") + ".txextract",
            fromlist=["ParsedTxRegion"],
        )
        kv = S.MemoryKV()
        u = U.UtxoStore(kv, undo_depth=4)
        for height, b in enumerate(canned, start=1):
            if path == "apply_block":
                assert u.apply_block(height, b.header.hash, list(b.txs))
            else:
                raw = b.serialize()[80:]
                with tx.ParsedTxRegion(raw[1:], len(b.txs)) as region:
                    blob, created, spent = region.utxo_ops()
                assert u.apply_ops_blob(height, b.header.hash, blob, created, spent)
        snap = u.snapshot()
        rows = _contents(kv)
        assert u.disconnect() and u.disconnect()
        out[pkg] = (snap, rows, u.snapshot(), _contents(kv), u.height, u.block_hash)
    assert out["ref"] == out["port"]


def test_utxo_store_over_a_generated_chain_and_logkv_reopens_across(tmp_path):
    """A generated BCH chain (txgen's script mix) connected natively into a
    LogKV by the port: the reference reopens it with the same watermark,
    lookups and rows as its own connect of the same chain."""
    chain = _generated_chain()
    import tpunode.txextract as R_tx
    import tpunode_torch.txextract as P_tx

    stores = {}
    for pkg, tx in (("ref", R_tx), ("port", P_tx)):
        S, _, U = PKGS[pkg]
        path = str(tmp_path / f"{pkg}.log")
        kv = S.LogKV(path)
        u = U.UtxoStore(S.Namespaced(kv, U.UTXO_NAMESPACE))
        for height, b in enumerate(chain, start=1):
            raw = b.serialize()[80:]
            n = len(b.txs)
            skip = 1 if n < 0xFD else 3
            with tx.ParsedTxRegion(raw[skip:], n) as region:
                blob, created, spent = region.utxo_ops()
            assert u.apply_ops_blob(height, b.header.hash, blob, created, spent)
        kv.close()
        stores[pkg] = path
    got = {}
    for pkg, path in stores.items():
        kv = R_store.LogKV(path)
        u = R_utxo.UtxoStore(R_store.Namespaced(kv, R_utxo.UTXO_NAMESPACE))
        got[pkg] = (u.height, u.block_hash, u.snapshot(), _contents(kv))
        kv.close()
    assert got["ref"] == got["port"]
    assert got["port"][0] == len(chain)
