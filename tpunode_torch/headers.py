"""Header-chain consensus: validation, difficulty, locators, chain work.

A Haskell node delegates all of this to haskoin-core (``connectBlocks``,
``blockLocator``, ``getAncestor``, ``splitPoint``, ``genesisNode``, driven
from its chain actor's ``importHeaders``).  This module implements the
same consensus surface from scratch:

* proof-of-work check against the compact target,
* expected-bits computation (mainnet 2016-block retarget, testnet3
  min-difficulty blocks, regtest no-retarget, and the Bitcoin Cash EDA /
  cw-144 DAA / aserti3-2d rules),
* median-time-past and future-timestamp sanity,
* cumulative chain-work tracking and best-chain selection,
* block locators, ancestor walks and split points.

Storage is abstracted behind ``HeaderStore`` so the same code runs over the
chain manager's persistent KV store or an in-memory dict in tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Protocol

from .params import Network
from .util import Reader, bits_to_target, hash_to_hex, header_work, target_to_bits
from .wire import BlockHeader

__all__ = [
    "BlockNode",
    "HeaderStore",
    "MemoryHeaderStore",
    "BadHeaders",
    "genesis_node",
    "connect_blocks",
    "next_work_required",
    "median_time_past",
    "get_ancestor",
    "get_parents",
    "block_locator",
    "split_point",
]

# A block is invalid if its timestamp exceeds adjusted time by this much.
MAX_FUTURE_BLOCK_TIME = 2 * 3600


class BadHeaders(Exception):
    """Raised when a header batch fails consensus validation.

    The chain manager maps this to killing the sending peer with
    ``PeerSentBadHeaders`` (reference: Chain.hs:334-338,516).
    """


@dataclass(frozen=True)
class BlockNode:
    """A validated header with its height and cumulative chain work.

    Mirror of haskoin-core's ``BlockNode``.
    """

    header: BlockHeader
    height: int
    work: int  # cumulative chain work up to and including this block

    @property
    def hash(self) -> bytes:
        return self.header.hash

    @property
    def hash_hex(self) -> str:
        return self.header.hash_hex

    def serialize(self) -> bytes:
        return (
            self.header.serialize()
            + self.height.to_bytes(4, "little")
            + self.work.to_bytes(36, "little")
        )

    @classmethod
    def deserialize(cls, data: bytes) -> "BlockNode":
        r = Reader(data)
        header = BlockHeader.deserialize(r)
        height = r.u32()
        work = int.from_bytes(r.read(36), "little")
        return cls(header, height, work)


class HeaderStore(Protocol):
    """Read side of a header store (the ``BlockHeaders`` typeclass analog,
    reference: Chain.hs:233-263)."""

    def get_header(self, block_hash: bytes) -> Optional[BlockNode]: ...

    def get_best(self) -> BlockNode: ...


class MemoryHeaderStore:
    """Dict-backed header store for tests and scratch use."""

    def __init__(self, net: Network):
        g = genesis_node(net)
        self.headers: dict[bytes, BlockNode] = {g.hash: g}
        self.best: BlockNode = g

    def get_header(self, block_hash: bytes) -> Optional[BlockNode]:
        return self.headers.get(block_hash)

    def get_best(self) -> BlockNode:
        return self.best

    def add_headers(self, nodes: Iterable[BlockNode]) -> None:
        for n in nodes:
            self.headers[n.hash] = n

    def set_best(self, node: BlockNode) -> None:
        self.best = node


def genesis_node(net: Network) -> BlockNode:
    """The genesis ``BlockNode`` (reference: haskoin-core ``genesisNode``,
    used at Chain.hs:464-468)."""
    g = net.genesis
    header = BlockHeader(
        version=g.version,
        prev=b"\x00" * 32,
        merkle=g.merkle,
        timestamp=g.timestamp,
        bits=g.bits,
        nonce=g.nonce,
    )
    return BlockNode(header=header, height=0, work=header_work(g.bits))


# --- ancestor / locator / split-point walks --------------------------------


class _Overlay:
    """HeaderStore view extended with not-yet-persisted nodes."""

    def __init__(self, store: HeaderStore, extra: dict[bytes, BlockNode]):
        self._store = store
        self._extra = extra

    def get_header(self, block_hash: bytes) -> Optional[BlockNode]:
        n = self._extra.get(block_hash)
        if n is not None:
            return n
        return self._store.get_header(block_hash)

    def get_best(self) -> BlockNode:
        return self._store.get_best()


def get_ancestor(store: HeaderStore, height: int, node: BlockNode) -> Optional[BlockNode]:
    """Ancestor of ``node`` at ``height`` by walking prev pointers
    (reference: haskoin-core ``getAncestor``, used at Chain.hs:690-697)."""
    if height > node.height or height < 0:
        return None
    cur = node
    while cur.height > height:
        parent = store.get_header(cur.header.prev)
        if parent is None:
            return None
        cur = parent
    return cur


def get_parents(store: HeaderStore, height: int, node: BlockNode) -> list[BlockNode]:
    """Parents of ``node`` from ``height`` up to ``node.height - 1``
    (reference: ``chainGetParents`` Chain.hs:700-715)."""
    acc: list[BlockNode] = []
    cur = node
    while height < cur.height:
        parent = store.get_header(cur.header.prev)
        if parent is None:
            break
        acc.append(parent)
        cur = parent
    acc.reverse()
    return acc


def median_time_past(store: HeaderStore, node: BlockNode, span: int = 11) -> int:
    """Median timestamp of the last ``span`` blocks ending at ``node``."""
    times: list[int] = []
    cur: Optional[BlockNode] = node
    while cur is not None and len(times) < span:
        times.append(cur.header.timestamp)
        if cur.height == 0:
            break
        cur = store.get_header(cur.header.prev)
    times.sort()
    return times[len(times) // 2]


def block_locator(store: HeaderStore, node: BlockNode) -> list[bytes]:
    """Compact O(log n) locator: 10 recent hashes then doubling steps back to
    genesis (reference: haskoin-core ``blockLocator``, used at Chain.hs:582)."""
    hashes: list[bytes] = []
    step = 1
    cur: Optional[BlockNode] = node
    while cur is not None:
        hashes.append(cur.hash)
        if cur.height == 0:
            break
        if len(hashes) >= 10:
            step *= 2
        height = max(0, cur.height - step)
        cur = get_ancestor(store, height, cur)
    return hashes


def split_point(store: HeaderStore, left: BlockNode, right: BlockNode) -> BlockNode:
    """Highest common ancestor of two nodes (reference: haskoin-core
    ``splitPoint``, used at Chain.hs:718-725)."""
    h = min(left.height, right.height)
    l = get_ancestor(store, h, left)
    r = get_ancestor(store, h, right)
    if l is None or r is None:
        raise BadHeaders("split point walk fell off the chain")
    while l.hash != r.hash:
        lp = store.get_header(l.header.prev)
        rp = store.get_header(r.header.prev)
        if lp is None or rp is None:
            raise BadHeaders("split point walk fell off the chain")
        l, r = lp, rp
    return l


# --- difficulty ------------------------------------------------------------


def _clamped_retarget(net: Network, parent: BlockNode, first: BlockNode) -> int:
    """Classic 2016-block retarget with the 4x clamp."""
    timespan = parent.header.timestamp - first.header.timestamp
    lo = net.pow_target_timespan // 4
    hi = net.pow_target_timespan * 4
    timespan = max(lo, min(hi, timespan))
    new_target = bits_to_target(parent.header.bits) * timespan // net.pow_target_timespan
    return target_to_bits(min(new_target, net.pow_limit))


def _last_non_min_difficulty_bits(store: HeaderStore, net: Network, parent: BlockNode) -> int:
    """Walk back over min-difficulty blocks to the last 'real' difficulty
    (the testnet3 rule from Bitcoin Core's GetNextWorkRequired)."""
    limit_bits = net.pow_limit_bits
    cur = parent
    while (
        cur.height % net.retarget_interval != 0
        and cur.header.bits == limit_bits
        and cur.height > 0
    ):
        prev = store.get_header(cur.header.prev)
        if prev is None:
            break
        cur = prev
    return cur.header.bits


def _eda_bits(store: HeaderStore, net: Network, parent: BlockNode) -> int:
    """BCH emergency difficulty adjustment (UAHF, pre-DAA): if the last six
    blocks took more than 12 hours by MTP, ease difficulty by 25%."""
    anc6 = get_ancestor(store, parent.height - 6, parent)
    if anc6 is None:
        return parent.header.bits
    mtp_diff = median_time_past(store, parent) - median_time_past(store, anc6)
    if mtp_diff < 12 * 3600:
        return parent.header.bits
    target = bits_to_target(parent.header.bits)
    target += target >> 2
    return target_to_bits(min(target, net.pow_limit))


def _suitable_block(store: HeaderStore, node: BlockNode) -> BlockNode:
    """Median-by-timestamp of a block and its two parents (BCH DAA)."""
    b2 = node
    b1 = store.get_header(b2.header.prev)
    b0 = b1 and store.get_header(b1.header.prev)
    if b1 is None or b0 is None:
        return node
    blocks = sorted([b0, b1, b2], key=lambda b: (b.header.timestamp, b.height))
    return blocks[1]


def _daa_bits(store: HeaderStore, net: Network, parent: BlockNode) -> int:
    """BCH cw-144 difficulty adjustment (Nov 2017): chain-work over the last
    144 blocks between median-of-three endpoints, scaled to 600s spacing."""
    if parent.height < 147:
        return parent.header.bits
    last = _suitable_block(store, parent)
    first_anchor = get_ancestor(store, parent.height - 144, parent)
    if first_anchor is None:
        return parent.header.bits
    first = _suitable_block(store, first_anchor)
    timespan = last.header.timestamp - first.header.timestamp
    timespan = max(72 * net.pow_target_spacing, min(288 * net.pow_target_spacing, timespan))
    work = (last.work - first.work) * net.pow_target_spacing // timespan
    if work <= 0:
        return net.pow_limit_bits
    next_target = (1 << 256) // work - 1
    return target_to_bits(min(next_target, net.pow_limit))


def _asert_bits(net: Network, parent: BlockNode, header: BlockHeader) -> int:
    """BCH aserti3-2d (Nov 2020): exponential target schedule anchored at the
    activation block, integer fixed-point per the published spec."""
    assert net.asert_anchor is not None
    anchor_height, anchor_bits, anchor_parent_time = net.asert_anchor
    ideal = net.pow_target_spacing
    halflife = 2 * 24 * 3600
    anchor_target = bits_to_target(anchor_bits)
    time_diff = parent.header.timestamp - anchor_parent_time
    height_diff = parent.height - anchor_height + 1
    exponent = ((time_diff - ideal * height_diff) << 16) // halflife
    shifts = exponent >> 16
    frac = exponent & 0xFFFF
    factor = 65536 + (
        (195766423245049 * frac + 971821376 * frac * frac + 5127 * frac * frac * frac + (1 << 47))
        >> 48
    )
    next_target = anchor_target * factor
    if shifts < 0:
        next_target >>= -shifts
    else:
        next_target <<= shifts
    next_target >>= 16
    if next_target == 0:
        return target_to_bits(1)
    return target_to_bits(min(next_target, net.pow_limit))


def next_work_required(
    store: HeaderStore, net: Network, parent: BlockNode, header: BlockHeader
) -> int:
    """Expected compact bits for a block extending ``parent``.

    Dispatches across BTC mainnet/testnet/regtest and the three generations of
    BCH difficulty rules, mirroring the capability haskoin-core provides to the
    reference's ``connectBlocks`` call (Chain.hs:519).
    """
    # Bitcoin Cash mainnet/testnet difficulty epochs (by parent height).
    if net.bch and not net.no_retargeting:
        if net.asert_height is not None and parent.height + 1 > net.asert_height:
            return _asert_bits(net, parent, header)
        if net.daa_height is not None and parent.height >= net.daa_height:
            if net.allow_min_difficulty and header.timestamp > (
                parent.header.timestamp + 2 * net.pow_target_spacing
            ):
                return net.pow_limit_bits
            return _daa_bits(store, net, parent)

    interval = net.retarget_interval
    if (parent.height + 1) % interval != 0:
        # Not a retarget boundary.
        if net.allow_min_difficulty:
            if header.timestamp > parent.header.timestamp + 2 * net.pow_target_spacing:
                return net.pow_limit_bits
            if not net.no_retargeting:
                return _last_non_min_difficulty_bits(store, net, parent)
        if (
            net.bch
            and not net.no_retargeting
            and net.eda_height is not None
            and parent.height >= net.eda_height
        ):
            return _eda_bits(store, net, parent)
        return parent.header.bits
    if net.no_retargeting:
        return parent.header.bits
    first = get_ancestor(store, parent.height + 1 - interval, parent)
    if first is None:
        raise BadHeaders("retarget ancestor missing from store")
    return _clamped_retarget(net, parent, first)


def valid_pow(header: BlockHeader, pow_limit: int) -> bool:
    """Check the header hashes below its own claimed target."""
    target = bits_to_target(header.bits)
    if target <= 0 or target > pow_limit:
        return False
    return int.from_bytes(header.hash, "little") <= target


# --- the main entry point: connect a batch of headers ----------------------


def connect_blocks(
    store: HeaderStore,
    net: Network,
    now: int,
    headers: list[BlockHeader],
) -> tuple[list[BlockNode], BlockNode]:
    """Validate and connect a contiguous batch of headers.

    Returns ``(new_nodes, new_best)``.  ``new_nodes`` must be persisted and, if
    ``new_best`` differs from the stored best, the best pointer updated — the
    chain manager does both in one batch write (the analog of the reference's
    ``connectBlocks`` + ``addBlockHeaders``/``setBestBlockHeader`` write at
    Chain.hs:256-263,519).

    Raises :class:`BadHeaders` when any header fails consensus checks; the
    caller treats the whole batch (and the sending peer) as bad.
    """
    fresh: dict[bytes, BlockNode] = {}
    view = _Overlay(store, fresh)
    nodes: list[BlockNode] = []
    best = store.get_best()

    for header in headers:
        parent = view.get_header(header.prev)
        if parent is None:
            raise BadHeaders(
                f"header {header.hash_hex} does not connect (prev "
                f"{hash_to_hex(header.prev)} unknown)"
            )
        if header.timestamp > now + MAX_FUTURE_BLOCK_TIME:
            raise BadHeaders(f"header {header.hash_hex} timestamp too far in future")
        mtp = median_time_past(view, parent)
        if header.timestamp <= mtp:
            raise BadHeaders(
                f"header {header.hash_hex} timestamp {header.timestamp} <= MTP {mtp}"
            )
        expected_bits = next_work_required(view, net, parent, header)
        if header.bits != expected_bits:
            raise BadHeaders(
                f"header {header.hash_hex} bad bits {header.bits:#x}, "
                f"expected {expected_bits:#x}"
            )
        if not valid_pow(header, net.pow_limit):
            raise BadHeaders(f"header {header.hash_hex} fails proof of work")
        node = BlockNode(
            header=header,
            height=parent.height + 1,
            work=parent.work + header_work(header.bits),
        )
        fresh[node.hash] = node
        nodes.append(node)
        if node.work > best.work:
            best = node

    return nodes, best
