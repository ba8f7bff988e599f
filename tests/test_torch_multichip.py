"""The port's multi-card verification (``tpunode_torch/verify/multichip.py``)
against the reference's ``tpunode/verify/multichip.py``.

The reference's tests (``tests/test_multichip.py``) run on the 8 virtual CPU
devices the conftest gives JAX.  Torch has one CPU device, so their port
versions run on a mesh of 8 CPU entries (``visible_devices`` monkeypatched;
a mesh may repeat a device), each shard on the plain program.  Topology
tests, which launch nothing, use 8 ``cuda:i`` entries instead, so that a
row's devices can be told apart.  Mesh shapes, the ``ValueError``s, the
column split of each shard, padding, hybrid rows, ``host_submesh``, mixed
algorithms and the ``schnorr_free`` flag are held against the reference on
the same seeded items; verdicts against both packages' oracles.

Three reference tests have no port version, being the JAX program's alone:
``test_pallas_kernel_inside_shard_map_interpret`` (Pallas in interpret mode
inside ``shard_map``: the port's hand kernel runs on a card only, so its
mesh launch is a ``gpu`` test in ``tests/test_torch_cuda.py``; here, the
options that name it on a CPU mesh raise), ``test_sharded_falls_back_to_
xla_on_mosaic_error`` (the port has no fallback: a failed shard raises,
below) and the jit cache key of ``test_sharded_schnorr_free_verdict_parity``
(the port caches the step per mesh, program, variant and modes, below).
"""

import asyncio
import random

import numpy as np
import pytest
import torch

import tpunode.verify.ecdsa_cpu as RO
import tpunode.verify.kernel as RK
import tpunode.verify.multichip as RM
from tpunode_torch.verify import engine as E
from tpunode_torch.verify import kernel as K
from tpunode_torch.verify import multichip as MC
from tpunode_torch.verify.ecdsa_cpu import (
    CURVE_N,
    GENERATOR,
    bip340_challenge,
    lift_x,
    point_mul,
    schnorr_challenge,
    sign,
    sign_bip340,
    sign_schnorr,
    verify,
    verify_batch_cpu,
)
from tpunode_torch.verify.raw import pack_items

torch.set_num_threads(1)

MODES = dict(select="tree", ladder="scan", sqr="half", mul="shift_add")


def make_items(n, tamper_every=5, seed=20260729):
    """The reference test's items, from its seed, every ``tamper_every``-th
    message corrupted; the verdicts are the port's oracle's, equal to the
    reference's."""
    rng = random.Random(seed)
    items, expect = [], []
    for i in range(n):
        priv = rng.getrandbits(256) % CURVE_N or 1
        pub = point_mul(priv, GENERATOR)
        z = rng.getrandbits(256)
        r, s = sign(priv, z, rng.getrandbits(256) % CURVE_N or 1)
        if i % tamper_every == 1:
            z ^= 1
        items.append((pub, z, r, s))
        expect.append(verify(pub, z, r, s))
    ref = [RO.verify(RO.Point(p.x, p.y), z, r, s) for p, z, r, s in items]
    assert ref == expect
    return items, expect


@pytest.fixture
def cpu8(monkeypatch):
    """8 CPU entries stand for the conftest's 8 virtual devices."""
    devs = [torch.device("cpu")] * 8
    monkeypatch.setattr(MC, "visible_devices", lambda device=None: list(devs))
    monkeypatch.setattr(E, "visible_devices", lambda device=None: list(devs))
    return devs


@pytest.fixture
def ids8(monkeypatch):
    """8 distinct card entries, for the topology tests that launch nothing."""
    devs = [torch.device("cuda", i) for i in range(8)]
    monkeypatch.setattr(MC, "visible_devices", lambda device=None: list(devs))
    return devs


def _index(mesh) -> list:
    return [d.index for d in mesh.devices.flat]


# -- the reference's tests, ported -------------------------------------------------


def test_mesh_uses_all_devices(cpu8):
    mesh = MC.make_mesh()
    assert mesh.devices.size == len(MC.visible_devices()) == 8
    assert mesh.devices.shape == RM.make_mesh().devices.shape == (8,)
    assert tuple(mesh.axis_names) == tuple(RM.make_mesh().axis_names) == ("batch",)


def test_hybrid_mesh_topology(ids8):
    mesh = MC.make_hybrid_mesh(2, 4)
    assert mesh.devices.shape == (2, 4)
    assert tuple(mesh.axis_names) == MC.HYBRID_AXES == RM.HYBRID_AXES == ("host", "chip")
    row1 = MC.host_submesh(mesh, 1)
    assert row1.devices.shape == (4,) and tuple(row1.axis_names) == ("batch",)
    assert _index(row1) == [d.index for d in mesh.devices[1]]
    # the same grids, rows and sub-meshes as the reference's
    for args, kw in (((2, 4), {}), ((), {}), ((), {"hosts": 4}), ((), {"chips_per_host": 2}),
                     ((8, 1), {}), ((1, 8), {})):
        ours, ref = MC.make_hybrid_mesh(*args, **kw), RM.make_hybrid_mesh(*args, **kw)
        assert ours.devices.shape == ref.devices.shape, (args, kw)
        assert _index(ours) == [d.id for d in ref.devices.flat]
        for h in range(ours.devices.shape[0]):
            for chips in (None, 1, 2):
                a, b = MC.host_submesh(ours, h, chips), RM.host_submesh(ref, h, chips)
                assert _index(a) == [d.id for d in b.devices.flat]
    assert MC.make_hybrid_mesh().devices.shape == (8, 1)
    assert MC.make_hybrid_mesh(hosts=4).devices.shape == (4, 2)
    assert MC.make_hybrid_mesh(chips_per_host=2).devices.shape == (4, 2)
    lm = MC.make_mesh(4)
    assert MC.host_submesh(lm, 0) is lm
    with pytest.raises(ValueError, match="needs 16 devices") as ours:
        MC.make_hybrid_mesh(4, 4)
    with pytest.raises(ValueError) as ref:
        RM.make_hybrid_mesh(4, 4)
    assert str(ours.value) == str(ref.value)


def test_hybrid_sharded_matches_oracle(cpu8):
    mesh = MC.make_hybrid_mesh(2, 4)
    items, expect = make_items(24)
    got = MC.verify_batch_sharded(items, mesh=mesh, **MODES)
    assert got == expect
    assert any(got) and not all(got)
    items2, expect2 = make_items(11, seed=11)
    assert MC.verify_batch_sharded(items2, mesh=mesh, **MODES) == expect2


def test_hybrid_fn_cache_keys_on_mesh_topology(ids8):
    h24 = MC.make_hybrid_mesh(2, 4)
    h81 = MC.make_hybrid_mesh(8, 1)
    local = MC.make_mesh()
    f1 = MC.sharded_verify_fn(h24, kernel="xla", **MODES)
    f2 = MC.sharded_verify_fn(h81, kernel="xla", **MODES)
    f3 = MC.sharded_verify_fn(local, kernel="xla", **MODES)
    assert len({id(f1), id(f2), id(f3)}) == 3
    assert MC.sharded_verify_fn(MC.make_hybrid_mesh(2, 4), kernel="xla", **MODES) is f1
    # the modes are part of the key: another select is another step
    assert MC.sharded_verify_fn(h24, kernel="xla", **{**MODES, "select": "onehot"}) is not f1


def test_sharded_matches_oracle(cpu8):
    items, expect = make_items(24)
    got = MC.verify_batch_sharded(items, **MODES)
    assert got == expect
    assert any(got) and not all(got)


def test_sharded_pads_to_mesh_multiple(cpu8):
    items, expect = make_items(10)
    assert MC.verify_batch_sharded(items, **MODES) == expect


def test_sharded_submesh(cpu8):
    mesh = MC.make_mesh(4)
    assert mesh.devices.size == 4
    items, expect = make_items(8)
    assert MC.verify_batch_sharded(items, mesh=mesh, **MODES) == expect


def test_dispatch_raw_sharded_matches_oracle(cpu8):
    items, expect = make_items(22)  # not a multiple of the 8-wide mesh
    raw = pack_items(items)
    mesh = MC.make_mesh()
    handle, count = MC.dispatch_raw_sharded(raw, mesh, **MODES)
    assert (len(handle), count) == (24, 22)
    assert K.collect_verdicts(handle, count) == expect
    # pad_to below the batch is ignored; above it aligns up
    handle, count = MC.dispatch_raw_sharded(raw, mesh, pad_to=64, **MODES)
    assert len(handle) == 64 and [len(sh.out) for sh in handle.shards] == [8] * 8
    assert K.collect_verdicts(handle, count) == expect


def test_dispatch_raw_sharded_hybrid_mesh(cpu8):
    items, expect = make_items(21)  # not a multiple of the 8-device grid
    mesh = MC.make_hybrid_mesh(2, 4)
    handle, count = MC.dispatch_raw_sharded(pack_items(items), mesh, **MODES)
    assert handle.axes == ("host", "chip")
    assert K.collect_verdicts(handle, count) == expect


def test_engine_fleet_serves_lanes_over_host_submeshes(cpu8):
    """With mesh_hosts=2 the device rung carves the 2x4 rows and each host
    worker dispatches its lanes over its own 4-entry sub-mesh (the device
    rung is the plain program; its state is forced ready, as the
    reference's test does)."""
    items, expect = make_items(20)

    async def run() -> list:
        cfg = E.VerifyConfig(device="cpu", batch_size=8, device_batch=8, max_wait=0.02,
                             warmup=False, mesh_hosts=2)
        eng = E.VerifyEngine(cfg)
        eng._device_state = "ready"
        async with eng:
            g1, g2 = await asyncio.gather(eng.verify(items[:11]), eng.verify(items[11:]))
        assert eng._fleet_hybrid_state == "ready"
        assert {hs.mesh_state for hs in eng._hosts.values()} <= {"ready", "cold"}
        assert {hs.chips for hs in eng._hosts.values() if hs.mesh_state == "ready"} == {4}
        assert eng.stats()["fleet"]["hybrid_state"] == "ready"
        return g1 + g2

    assert asyncio.run(run()) == expect


def test_engine_mesh_rung_serves_packed_lanes(cpu8):
    items, expect = make_items(20)

    async def run() -> list:
        cfg = E.VerifyConfig(device="cpu", batch_size=8, device_batch=8, max_wait=0.02,
                             warmup=False, mesh_devices=4)
        eng = E.VerifyEngine(cfg)
        eng._device_state = "ready"
        async with eng:
            g1, g2 = await asyncio.gather(eng.verify(items[:11]), eng.verify(items[11:]))
        assert eng._mesh_state == "ready"
        assert eng.stats()["mesh"] == {"devices": 4, "state": "ready", "shape": [4]}
        return g1 + g2

    assert asyncio.run(run()) == expect


def test_sharded_mixed_algorithms(cpu8):
    rng = random.Random(20260729)
    items = []
    for i in range(16):
        priv = rng.getrandbits(256) % CURVE_N or 1
        pub = point_mul(priv, GENERATOR)
        m = rng.getrandbits(256)
        if i % 3 == 0:
            r, s = sign(priv, m, rng.getrandbits(256) % CURVE_N or 1)
            if i % 6 == 3:
                s = (s + 1) % CURVE_N or 1
            items.append((pub, m, r, s))
        elif i % 3 == 1:
            r, s = sign_schnorr(priv, m, rng.getrandbits(256))
            e = schnorr_challenge(r, pub, m)
            if i % 6 == 4:
                e = (e + 1) % CURVE_N
            items.append((pub, e, r, s, "schnorr"))
        else:
            r, s = sign_bip340(priv, m, rng.getrandbits(256))
            e = bip340_challenge(r, pub.x, m)
            if i % 6 == 5:
                e = (e + 1) % CURVE_N
            items.append((lift_x(pub.x), e, r, s, "bip340"))
    expect = verify_batch_cpu(items)
    ref_items = [(RO.Point(it[0].x, it[0].y), *it[1:]) for it in items]
    assert RO.verify_batch_cpu(ref_items) == expect
    got = MC.verify_batch_sharded(items, mesh=MC.make_mesh(4), **MODES)
    assert got == expect
    assert True in expect and False in expect


# -- port versions of the JAX-only tests ------------------------------------------


def test_the_reference_pallas_options_raise_on_the_port(ids8, cpu8):
    """``interpret=`` and ``block=`` have no counterpart; the hand kernel
    (``kernel="pallas"``) runs on cards only, so a CPU mesh refuses it."""
    mesh = MC.make_mesh(2)
    with pytest.raises(ValueError, match="no counterpart"):
        MC.sharded_verify_fn(mesh, kernel="pallas", interpret=True, block=8, **MODES)
    with pytest.raises(ValueError, match="no counterpart"):
        MC.sharded_verify_fn(mesh, block=8, **MODES)
    with pytest.raises(ValueError, match="cards only"):
        MC.sharded_verify_fn(mesh, kernel="pallas", **MODES)
    with pytest.raises(ValueError, match="auto|pallas|xla"):
        MC.sharded_verify_fn(mesh, kernel="mosaic", **MODES)
    mixed = MC.Mesh([torch.device("cuda", 0), torch.device("cpu")])
    with pytest.raises(ValueError, match="cards only"):
        MC.sharded_verify_fn(mixed, kernel="pallas", **MODES)


def test_a_failed_shard_launch_raises(cpu8, monkeypatch):
    """The reference re-runs a Mosaic failure inside ``shard_map`` on its
    XLA program; the port has one kernel a mode tuple and no fallback: a
    shard whose launch fails raises to the caller."""
    def boom(*args, **kw):
        raise RuntimeError("verify kernel launch failed (verify_u32): out of resources")

    monkeypatch.setattr(MC, "verify_core", boom)
    monkeypatch.setattr(MC, "_FN_CACHE", {})
    items, _ = make_items(4)
    with pytest.raises(RuntimeError, match="launch failed"):
        MC.verify_batch_sharded(items, mesh=MC.make_mesh(2), **MODES)


def test_sharded_schnorr_free_verdict_parity(cpu8, monkeypatch):
    """``schnorr_free`` comes from the host prep flags alone, as in the
    reference; on a CPU mesh the plain program runs the full checks, so the
    flag is dropped (one cached step either way) and the verdicts stand;
    on a card mesh the two variants are distinct steps (their launches on
    the card: ``tests/test_torch_cuda.py``)."""
    items, expect = make_items(16)
    prep = K.prepare_batch(items, pad_to=16)
    ref_prep = RK.prepare_batch([(RO.Point(p.x, p.y), z, r, s) for p, z, r, s in items],
                                pad_to=16)
    assert prep.schnorr_free and ref_prep.schnorr_free
    mesh = MC.make_mesh(2)
    fx1 = MC.sharded_verify_fn(mesh, kernel="xla", **MODES)
    fx2 = MC.sharded_verify_fn(mesh, kernel="xla", schnorr_free=True, **MODES)
    assert fx1 is fx2
    assert MC.sharded_verify_fn(mesh, schnorr_free=True, **MODES) is fx1  # auto: plain here
    handle = fx1(*prep.device_args)
    assert K.collect_verdicts(handle, 16) == expect
    assert handle.total() == sum(expect) and sum(handle.counts()) == sum(expect)
    cards = MC.Mesh([torch.device("cuda", 0), torch.device("cuda", 1)])
    full = MC.sharded_verify_fn(cards, kernel="pallas", **MODES)
    free = MC.sharded_verify_fn(cards, kernel="pallas", schnorr_free=True, **MODES)
    assert full is not free


# -- the split, the handle and the mesh type -----------------------------------------


@pytest.mark.parametrize("shape", [(8,), (2, 4)])
def test_each_shard_gets_the_reference_shards_columns(cpu8, monkeypatch, shape):
    """The port splits every array along its batch axis as the reference's
    ``NamedSharding(mesh, P(None, axes))`` does: shard k of
    ``mesh.devices.flat`` holds the k-th run of columns, on the 1-D mesh
    and over host and chip jointly on the hybrid one; the prep arrays are
    the reference's bit for bit."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    seen = []

    def record(*args, **kw):
        seen.append([a.numpy().copy() for a in args])
        return torch.zeros(args[8].shape[-1], dtype=torch.bool)

    monkeypatch.setattr(MC, "verify_core", record)
    monkeypatch.setattr(MC, "_FN_CACHE", {})
    items, _ = make_items(16)
    prep = K.prepare_batch(items, pad_to=16)
    ref_prep = RK.prepare_batch([(RO.Point(p.x, p.y), z, r, s) for p, z, r, s in items],
                                pad_to=16)
    ours = MC.make_mesh() if shape == (8,) else MC.make_hybrid_mesh(*shape)
    ref = RM.make_mesh() if shape == (8,) else RM.make_hybrid_mesh(*shape)
    MC.sharded_verify_fn(ours, **MODES)(*prep.device_args)
    axes = RM._batch_axes(ref)
    assert MC._batch_axes(ours) == axes
    flat = [d.id for d in ref.devices.flat]
    for i, (a, b) in enumerate(zip(prep.device_args, ref_prep.device_args)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
        spec = P(None, axes) if np.asarray(b).ndim == 2 else P(axes)
        shards = jax.device_put(np.asarray(b), NamedSharding(ref, spec)).addressable_shards
        shards = sorted(shards, key=lambda s: flat.index(s.device.id))
        assert len(seen) == len(shards) == 8
        for got, want in zip(seen, shards):
            assert np.array_equal(got[i], np.asarray(want.data))


def test_the_handle_reads_shard_by_shard_and_sums_on_the_host(cpu8):
    items, expect = make_items(12, tamper_every=3)
    handle, count = MC.dispatch_raw_sharded(pack_items(items), MC.make_mesh(4), **MODES)
    assert [sh.verdicts for sh in handle.shards] == [None] * 4  # nothing read yet
    assert handle.read() == expect
    assert handle.counts() == [sum(expect[i:i + 3]) for i in range(0, 12, 3)]
    assert handle.total() == sum(expect)
    assert all(sh.buffers is None for sh in handle.shards)  # released once read
    assert K.collect_verdicts(handle, 5) == expect[:5]


def test_mesh_type_checks_and_equality():
    with pytest.raises(ValueError, match="at least one device"):
        MC.Mesh([])
    with pytest.raises(ValueError, match="axis names"):
        MC.Mesh(["cpu", "cpu"], ("host", "chip"))
    with pytest.raises(ValueError, match="unsupported mesh device"):
        MC.Mesh(["meta"])
    a = MC.Mesh(["cuda:0", "cuda:1"])
    assert a == MC.Mesh([torch.device("cuda", 0), torch.device("cuda", 1)])
    assert hash(a) == hash(MC.Mesh(["cuda:0", "cuda:1"]))
    assert a != MC.Mesh(["cuda:1", "cuda:0"]) and a.size == 2 and a.shape == {"batch": 2}
    grid = MC.Mesh(np.array([["cpu", "cpu"], ["cpu", "cpu"]], dtype=object), MC.HYBRID_AXES)
    assert grid.devices.ndim == 2 and grid.shape == {"host": 2, "chip": 2}
    assert MC.host_names(3) == ["h0", "h1", "h2"]


def test_visible_devices_lists_each_card_once():
    assert MC.visible_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        assert MC.visible_devices() == []
        with pytest.raises(ValueError, match="at least one device"):
            MC.make_mesh()
    else:
        assert MC.visible_devices() == [torch.device("cuda", i)
                                        for i in range(torch.cuda.device_count())]
    with pytest.raises(ValueError, match="unsupported device"):
        MC.visible_devices("meta")
