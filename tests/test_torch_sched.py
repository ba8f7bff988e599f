"""The lane-packing scheduler in the port against the reference's.

``tpunode_torch.verify.sched`` is the single-host half of
``tpunode.verify.sched``: the packer's lane cuts and priority order must
give the reference's results.  Each scenario runs on both packages,
parametrised over ``tpunode`` and ``tpunode_torch``; a raw payload is each
package's own ``RawBatch``.
"""

import asyncio
import importlib

import numpy as np
import pytest

PACKAGES = ["tpunode", "tpunode_torch"]


def sched(pkg: str):
    return importlib.import_module(f"{pkg}.verify.sched")


def raw_batch(pkg: str, n: int, first: int = 0):
    raw = importlib.import_module(f"{pkg}.verify.raw")
    rows = np.arange(first, first + n, dtype=np.uint8)[:, None].repeat(32, 1)
    return raw.RawBatch(px=rows, py=rows, z=rows, r=rows, s=rows,
                        present=np.ones(n, np.uint8))


def _lane_view(lane) -> list:
    return [(sub.priority, sub.n, lo, hi) for sub, lo, hi in lane.slices]


async def _packer_scenario(pkg: str) -> dict:
    s = sched(pkg)
    loop = asyncio.get_running_loop()
    packer = s.LanePacker()
    subs = []
    for priority, n, t in (("bulk", 5, 0.0), ("mempool", 7, 1.0), ("block", 3, 2.0),
                           ("ibd", 4, 3.0), ("block", 6, 4.0), ("mempool", 2, 5.0)):
        sub = s.Submission(list(range(n)), loop.create_future(), None, priority, enqueued=t)
        packer.push(sub)
        subs.append(sub)
    raw_sub = s.Submission(raw_batch(pkg, 9), loop.create_future(), None, "bulk", enqueued=6.0)
    packer.push(raw_sub)
    depth = (packer.pending(), packer.batches(), packer.depths(), packer.oldest_enqueued(),
             packer.head_class())
    lanes = []
    while True:
        lane = packer.pop_lane(8)
        if lane is None:
            break
        lanes.append(lane)
    views = [_lane_view(lane) for lane in lanes]
    raw_slices = [p.px[:, 0].tolist() for lane in lanes for p in lane.payloads()
                  if not isinstance(p, list)]
    list_slices = [p for lane in lanes for p in lane.payloads() if isinstance(p, list)]
    # deliver every lane's verdicts in reverse lane order: each submission
    # resolves with exactly its own items' verdicts
    for lane in reversed(lanes):
        for sub, lo, hi in lane.slices:
            sub.deliver(lo, [(sub.priority, i) for i in range(lo, hi)])
    results = [sub.fut.result() for sub in (*subs, raw_sub)]
    failed = s.Submission([1, 2, 3], loop.create_future(), None, "bulk")
    packer.push(failed)
    failed.fail(RuntimeError("every rung down"))
    skipped = packer.pop_lane(8)
    with pytest.raises(ValueError, match="unknown priority"):
        s.Submission([1], loop.create_future(), None, "urgent")
    return {
        "depth": depth,
        "lanes": views,
        "occupancy": [lane.occupancy for lane in lanes],
        "class_counts": [lane.class_counts() for lane in lanes],
        "raw_slices": raw_slices,
        "list_slices": list_slices,
        "results": results,
        "after_fail": (skipped, packer.pending(), isinstance(failed.fut.exception(),
                                                            RuntimeError)),
    }


@pytest.mark.parametrize("pkg", PACKAGES)
async def test_packer_lane_cuts_and_priority_order_match_the_reference(pkg):
    got = await _packer_scenario(pkg)
    assert got == await _packer_scenario("tpunode")
    # block first (FIFO within a class), then mempool, ibd, bulk; every
    # lane exactly 8 items but the last
    assert got["lanes"][0] == [("block", 3, 0, 3), ("block", 6, 0, 5)]
    assert got["lanes"][1][0] == ("block", 6, 5, 6)
    assert [sum(hi - lo for *_, lo, hi in lane) for lane in got["lanes"]] == [8, 8, 8, 8, 4]
    assert got["raw_slices"] == [[0, 1, 2, 3, 4], [5, 6, 7, 8]]
    assert got["results"][2] == [("block", i) for i in range(3)]
    assert got["after_fail"] == (None, 0, True)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_slice_payload_matches_the_reference(pkg):
    s = sched(pkg)
    items = list(range(10))
    assert s.slice_payload(items, 0, 10) is items  # a whole payload passes as is
    assert s.slice_payload(items, 2, 5) == [2, 3, 4]
    raw = raw_batch(pkg, 10)
    part = s.slice_payload(raw, 3, 7)
    assert part.px[:, 0].tolist() == [3, 4, 5, 6] and len(part) == 4
    assert np.shares_memory(part.px, raw.px)  # a view, no copy
    assert s.OCCUPANCY_BUCKETS == sched("tpunode").OCCUPANCY_BUCKETS
