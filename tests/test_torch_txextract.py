"""The port's native extraction binding (``txextract``) against the
reference's and against the port's Python path, and the slice as a whole.

Every array of ``RawSigItems`` is held against the reference binding's for
``extract_raw``, ``ParsedTxRegion.extract``, sharded ``extract_range``
(merged, against serial), ``scan_prevouts``, ``utxo_ops`` and ``txids``; the
rows against the port's ``wire`` + ``txverify`` extraction (every template
and malformed shape of ``test_torch_txverify``); malformed regions raise in
both.  Last, a seeded block's wire bytes go through the port's extraction,
``VerifyEngine(VerifyConfig(device="cpu"))``'s ``verify_raw`` at block
priority (the plain program) and ``combine``: its per-transaction verdicts
equal the reference's (its extraction, its oracle, its ``combine``) and the
generator's corruption.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest

import chip_smoke
from benchmarks import txgen as RG
from tests.test_torch_txverify import CASES
from tpunode import params as RP
from tpunode import txextract as RX
from tpunode.verify import ecdsa_cpu as RO
from tpunode_torch import native as N
from tpunode_torch import txextract as X
from tpunode_torch import txgen as G
from tpunode_torch import txverify as T
from tpunode_torch.verify.cpu_native import load_native_verifier
from tpunode_torch.verify.engine import VerifyConfig, VerifyEngine
from tpunode_torch.verify.raw import as_raw_batch

if not (X.have_native_extract() and RX.have_native_extract()):  # pragma: no cover
    pytest.skip("native txextract unavailable", allow_module_level=True)

ITEM_ARRAYS = ("z", "px", "py", "r", "s", "present", "item_tx", "item_input", "item_sig",
               "item_key", "item_nsigs", "item_nkeys")
TX_ARRAYS = ("txids", "tx_n_inputs", "tx_extracted", "tx_items", "tx_sigs", "tx_coinbase",
             "tx_unsupported")


def assert_same_items(ours, ref):
    assert type(ours).__module__ == "tpunode_torch.txextract"
    assert ours.count == ref.count and ours.n_txs == ref.n_txs
    for name in ITEM_ARRAYS + TX_ARRAYS:
        got, want = getattr(ours, name), getattr(ref, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name


def _region(txs) -> bytes:
    return b"".join(tx.serialize() for tx in txs)


def _oracle_rows(region, bch: bool) -> tuple:
    """The prevout oracle's rows for a parsed region, as the node resolves
    them: ``synth_prevout`` where the region wants a row."""
    pv_txids, pv_vouts, pv_wants = region.scan_prevouts(bch)
    ext, scripts = [-1] * len(pv_wants), [None] * len(pv_wants)
    for i in pv_wants.nonzero()[0]:
        ext[i], scripts[i] = G.synth_prevout(pv_txids[i].tobytes(), int(pv_vouts[i]))
    return ext, scripts


def _workloads() -> dict:
    """name -> (reference txs, bch): small blocks of each generator."""
    chain = RG.gen_chain(RP.BCH_REGTEST, 1, 24, mix=True)
    return {
        "signed-segwit": ([RG._coinbase(3)] + RG.gen_signed_txs(
            20, inputs_per_tx=2, seed=21, invalid_every=5, segwit_every=3), False),
        "mixed": ([RG._coinbase(4)] + RG.gen_mixed_txs(40, seed=0x5A5A, invalid_every=9), False),
        "taproot-heavy": (RG.gen_mixed_txs(20, seed=0x7A7, mix=RG._MIX_TAPROOT_HEAVY), False),
        "bch-chain": (list(chain[0].txs), True),
    }


WORKLOADS = _workloads()


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_scan_prevouts_and_txids_equal_the_reference(name):
    txs, bch = WORKLOADS[name]
    data = _region(txs)
    got = X.scan_prevouts(data, len(txs), bch)
    want = RX.scan_prevouts(data, len(txs), bch)
    with X.ParsedTxRegion(data, len(txs)) as region, RX.ParsedTxRegion(data, len(txs)) as ref:
        assert (region.n_txs, region.n_inputs, region.capacity) == (
            ref.n_txs, ref.n_inputs, ref.capacity)
        for ours in (got, region.scan_prevouts(bch)):
            for a, b in zip(ours, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(region.txids(), ref.txids())
        assert [bytes(t) for t in region.txids()] == [tx.txid for tx in txs]
        for a, b in zip(region.tx_layout(), ref.tx_layout()):
            assert np.array_equal(a, b)
        assert np.array_equal(region.input_offsets(), ref.input_offsets())


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_extract_raw_and_region_extract_equal_the_reference(name):
    txs, bch = WORKLOADS[name]
    data = _region(txs)
    with X.ParsedTxRegion(data, len(txs)) as region:
        ext, scripts = _oracle_rows(region, bch)
        ours = region.extract(bch=bch, intra_amounts=True, ext_amounts=ext, ext_scripts=scripts)
    ref = RX.extract_raw(data, len(txs), bch=bch, intra_amounts=True, ext_amounts=ext,
                         ext_scripts=scripts)
    assert_same_items(ours, ref)
    for kwargs in ({}, {"intra_amounts": False}, {"ext_amounts": ext},
                   {"ext_scripts": scripts}):
        assert_same_items(X.extract_raw(data, len(txs), bch=bch, **kwargs),
                          RX.extract_raw(data, len(txs), bch=bch, **kwargs))

    def rows(items) -> list:
        return [(None if row[0] is None else (row[0].x, row[0].y), *row[1:])
                for row in items.to_verify_items()]

    assert ours.count > 0 and rows(ours) == rows(ref)
    combined = ours.combine([True] * ours.count)
    assert len(combined) == int(ours.tx_sigs.sum()) and all(combined)
    rng = np.random.default_rng(len(name))
    verdicts = rng.random(ours.count) < 0.8
    assert ours.combine(verdicts) == ref.combine(verdicts)
    assert [(s.start, s.stop) for s in ours.tx_slices()] == [
        (s.start, s.stop) for s in ref.tx_slices()]
    assert [(s.start, s.stop) for s in ours.sig_slices()] == [
        (s.start, s.stop) for s in ref.sig_slices()]
    for ti in range(ours.n_txs):
        assert vars(ours.stats(ti)) == vars(ref.stats(ti)) and ours.txid(ti) == txs[ti].txid


@pytest.mark.parametrize("cuts", [(0, 7, 30), (0, 1, 40), (0, 20)])
def test_sharded_extract_range_equals_serial_and_the_reference(cuts):
    txs, bch = WORKLOADS["mixed"]
    data = _region(txs)
    with X.ParsedTxRegion(data, len(txs)) as region, RX.ParsedTxRegion(data, len(txs)) as ref:
        ext, scripts = _oracle_rows(region, bch)
        serial = region.extract(intra_amounts=True, ext_amounts=ext, ext_scripts=scripts)
        assert region.build_intra() == ref.build_intra()
        off = region.input_offsets()
        bounds = list(cuts) + [len(txs)]
        shards = []
        for lo, hi in zip(bounds, bounds[1:]):
            fl, fh = int(off[lo]), int(off[hi])
            kwargs = dict(intra_amounts=True, ext_amounts=ext[fl:fh], ext_scripts=scripts[fl:fh])
            shard = region.extract_range(lo, hi, **kwargs)
            assert_same_items(shard, ref.extract_range(lo, hi, **kwargs))
            shards.append((lo, shard))
        assert sum(s.count for _, s in shards) == serial.count
        for name in ITEM_ARRAYS + TX_ARRAYS:
            merged = np.concatenate([getattr(s, name) + (lo if name == "item_tx" else 0)
                                     for lo, s in shards])
            assert np.array_equal(merged, getattr(serial, name)), name
        with pytest.raises(ValueError):
            region.extract_range(2, len(txs) + 1)
        empty = region.extract_range(1, 1)
        assert empty.count == 0 and empty.n_txs == 0


@pytest.mark.parametrize("prefix", [b"o", b"u"])
def test_utxo_ops_equal_the_reference(prefix):
    for txs, _ in WORKLOADS.values():
        data = _region(txs)
        with X.ParsedTxRegion(data, len(txs)) as region, RX.ParsedTxRegion(data, len(txs)) as ref:
            got = region.utxo_ops(prefix)
            assert got == ref.utxo_ops(prefix)
            assert got[1] == sum(len(t.outputs) for t in txs)
    with X.ParsedTxRegion(data, len(txs)) as region:
        with pytest.raises(ValueError):
            region.utxo_ops(b"ab")


@pytest.mark.parametrize("bch", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_native_rows_equal_the_port_python_path(name, bch):
    """Each template and malformed shape as a one-transaction region: the
    native rows against ``wire.Tx.deserialize`` + ``txverify.extract_sig_items``
    over the same amounts and scripts, and against the reference binding."""
    tx, amounts, scripts = CASES[name]
    data = tx.serialize()
    rows = len(tx.inputs)
    ext = [(amounts or {}).get(i, -1) for i in range(rows)]
    ext_scripts = [(scripts or {}).get(i) for i in range(rows)]
    ours = X.extract_raw(data, 1, bch=bch, intra_amounts=False, ext_amounts=ext,
                         ext_scripts=ext_scripts)
    assert_same_items(ours, RX.extract_raw(data, 1, bch=bch, intra_amounts=False,
                                           ext_amounts=ext, ext_scripts=ext_scripts))
    ptx = chip_smoke.plain_extract(data, 1, bch)[0][0]
    py_amounts = {i: a for i, a in enumerate(ext) if a >= 0}
    py_scripts = {i: s for i, s in enumerate(ext_scripts) if s is not None}
    py_items, st = T.extract_sig_items(ptx, prevout_amounts=py_amounts or None, bch=bch,
                                       prevout_scripts=py_scripts or None)
    assert chip_smoke.extraction_mismatches(ours, py_items, [st]) == 0
    verdicts = load_native_verifier().verify_raw(as_raw_batch(ours))
    assert ours.combine(verdicts) == T.combine_verdicts(py_items, verdicts)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_native_block_equals_the_port_python_path(name):
    txs, bch = WORKLOADS[name]
    data = _region(txs)
    with X.ParsedTxRegion(data, len(txs)) as region:
        ext, scripts = _oracle_rows(region, bch)
        ours = region.extract(bch=bch, intra_amounts=True, ext_amounts=ext, ext_scripts=scripts)
    got_txs, py_items, py_stats = chip_smoke.plain_extract(data, len(txs), bch)
    assert [t.txid for t in got_txs] == [t.txid for t in txs]
    assert chip_smoke.extraction_mismatches(ours, py_items, py_stats) == 0
    # the comparison sees a changed row, a changed stat and a lost row
    ours.s[0, -1] ^= 1
    assert chip_smoke.extraction_mismatches(ours, py_items, py_stats) == 1
    ours.s[0, -1] ^= 1
    py_stats[-1].sigs += 1
    assert chip_smoke.extraction_mismatches(ours, py_items, py_stats) == 1
    py_stats[-1].sigs -= 1
    assert chip_smoke.extraction_mismatches(ours, py_items[:-1], py_stats) == 1


def test_malformed_regions_raise_as_the_reference():
    good = _region(WORKLOADS["mixed"][0][:3])
    bad = [(b"\x01\x02\x03", 1), (good, 5), (good[:-1], 3), (good + b"\x00", 3),
           ((1).to_bytes(4, "little") + b"\xfe\x00\x00\x00\x01" + b"\x00" * 8, 1), (b"", 1)]
    for data, n in bad:
        for mod in (X, RX):
            with pytest.raises(ValueError):
                mod.extract_raw(data, n)
            with pytest.raises(ValueError):
                mod.ParsedTxRegion(data, n)
    assert X.extract_raw(good, 3).n_txs == RX.extract_raw(good, 3).n_txs == 3
    assert X.extract_raw(good).n_txs == 3  # -1: to the end of the buffer


def test_without_the_native_library_the_binding_raises(monkeypatch, tmp_path):
    """No Python stand-in: a library that cannot be built or loaded makes
    the binding raise and ``have_native_extract`` read False."""
    monkeypatch.setattr(X, "_lib", None)
    monkeypatch.setattr(X, "_load_failed", False)
    monkeypatch.setattr(X, "_LIB_PATH", str(tmp_path / "missing" / "libtxextract.so"))
    monkeypatch.setattr(N, "ensure_native_lib", lambda path, src: path)
    with pytest.raises(OSError):
        X.ParsedTxRegion(_region(WORKLOADS["mixed"][0][:2]), 2)
    assert not X.have_native_extract()
    engine = VerifyEngine(VerifyConfig(device="cpu", warmup=False))
    with pytest.raises(OSError):
        chip_smoke.ingest_block(engine, _region(WORKLOADS["mixed"][0][:2]), 2, False)


def test_slice_as_a_whole_block_to_per_transaction_verdicts():
    """A seeded 61-transaction block through the port: native parse, the
    prevout oracle, extraction, the CPU engine's ``verify_raw`` at block
    priority, ``combine``.  Its per-transaction verdicts equal the
    reference's path and read invalid exactly where the generator corrupted
    an extracted input."""
    txs = [G._coinbase(1)] + G.gen_mixed_txs(60, seed=0xB10C, invalid_every=9)
    ref_txs = [RG._coinbase(1)] + RG.gen_mixed_txs(60, seed=0xB10C, invalid_every=9)
    data = _region(txs)
    assert data == _region(ref_txs)
    region = X.ParsedTxRegion(data, len(txs))
    pv_txids, pv_vouts, pv_wants = region.scan_prevouts(False)
    ext, ext_scripts = [-1] * len(pv_wants), [None] * len(pv_wants)
    for i in pv_wants.nonzero()[0]:
        ext[i], ext_scripts[i] = G.synth_prevout(pv_txids[i].tobytes(), int(pv_vouts[i]))
    items = region.extract(bch=False, intra_amounts=True, ext_amounts=ext,
                           ext_scripts=ext_scripts)
    region.close()
    engine = VerifyEngine(VerifyConfig(device="cpu", batch_size=256, device_batch=256))

    async def submit():
        async with engine:
            return await engine.verify_raw(items, priority="block")

    verdicts = asyncio.run(submit())
    assert engine.last_rung == "tpu"  # the device rung, here the plain program
    per_sig = items.combine(verdicts)
    ours = [(items.txid(ti), all(per_sig[sl]), tuple(per_sig[sl]))
            for ti, sl in enumerate(items.sig_slices())]

    ref_items = RX.extract_raw(data, len(txs), intra_amounts=True, ext_amounts=ext,
                               ext_scripts=ext_scripts)
    ref_verdicts = RO.verify_batch_cpu(ref_items.to_verify_items())
    assert list(verdicts) == ref_verdicts
    ref_sig = ref_items.combine(ref_verdicts)
    ref = [(ref_items.txid(ti), all(ref_sig[sl]), tuple(ref_sig[sl]))
           for ti, sl in enumerate(ref_items.sig_slices())]
    assert ours == ref
    assert [txid for txid, _, _ in ours] == [tx.txid for tx in ref_txs]
    corrupted = chip_smoke.corrupted_btc_txs(txs, items)
    assert corrupted and [ti for ti, (_, ok, _) in enumerate(ours) if not ok] == corrupted
    # every corrupted transaction whose first input was not extracted is
    # an unsupported (taproot script-path) one
    for ti in range(9, len(txs), 9):
        if ti not in corrupted:
            assert items.stats(ti).unsupported == 2
