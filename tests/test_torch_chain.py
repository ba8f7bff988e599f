"""The port's peer, chain and peer manager against the reference's, over
``tests/fakenet.py``'s wire transport.

Each comparison drives both packages with the same input — the canned
15-block regtest chain served by the fake remote, the same header batches
handed to the chain actor, the same address strings — and compares what
comes out: the messages each sends as wire bytes, the header store row for
row, the events and the best block.  The reference's own tests of these
modules (``tests/test_peer.py``, ``tests/test_chain_sync.py``,
``tests/test_telemetry.py``) also run against the port.
"""

import asyncio

import pytest

import tests.test_chain_sync as ref_chain_sync
import tests.test_peer as ref_peer
import tests.test_telemetry as ref_telemetry
import tpunode as R
import tpunode.chain as R_chain
import tpunode.peer as R_peer
import tpunode.peermgr as R_peermgr
import tpunode.wire as R_wire
import tpunode_torch as P
import tpunode_torch.chain as P_chain
import tpunode_torch.peer as P_peer
import tpunode_torch.peermgr as P_peermgr
import tpunode_torch.wire as P_wire
from tests.fakenet import dummy_peer_connect
from tests.fixtures import all_blocks
from tests.test_torch_store import port_reference_tests

# ``test_framing_reassembles_one_byte_chunks`` decodes the node's frames
# with the module's codec and hands the messages to fakenet's reactor,
# which matches the reference's message classes: rebound to the port it
# would mix the two codecs.  ``test_chain_reassembles_split_frames`` below
# drives the port's framing through one-byte chunks instead.
_PORTED = {}
for _mod, _skip in (
    (ref_peer, {"test_framing_reassembles_one_byte_chunks"}),
    (ref_chain_sync, set()),
    (ref_telemetry, set()),
):
    for _name, _fn in port_reference_tests(_mod, exclude=_skip).items():
        assert _name not in _PORTED, f"two reference tests named {_name}"
        _PORTED[_name] = _fn
globals().update(_PORTED)

PKGS = {
    "ref": (R, R_chain, R_peer, R_peermgr, R_wire),
    "port": (P, P_chain, P_peer, P_peermgr, P_wire),
}
HEADERS = [b.header for b in all_blocks()]


class FakePeer:
    """The chain actor's view of a peer; keeps what it was sent."""

    def __init__(self, label="fake:0"):
        self.label = label
        self._busy = False
        self.sent = []
        self.killed = None

    def set_busy(self):
        if self._busy:
            return False
        self._busy = True
        return True

    def set_free(self):
        self._busy = False

    def send_message(self, msg):
        self.sent.append(msg)

    def kill(self, e):
        self.killed = e


def _frames(pkg, msgs) -> list:
    W = PKGS[pkg][4]
    net = PKGS[pkg][0].BCH_REGTEST
    return [W.encode_message(net, m) for m in msgs]


async def _drive_chain(pkg, batches, kill=False, **cfg_kw):
    """Hand header batches to a fresh chain actor; return what it sent, its
    store rows, its best block and its events."""
    T, C = PKGS[pkg][0], PKGS[pkg][1]
    store = T.MemoryKV()
    pub = T.Publisher(name="chain-cmp")
    chain = C.Chain(C.ChainConfig(store=T.Namespaced(store, b"c:"),
                                  net=T.BCH_REGTEST, pub=pub, **cfg_kw))
    peers = [FakePeer("fake:%d" % i) for i in range(len(batches))]
    seen = []
    async with pub.subscription() as sub:
        async with chain:
            for p, batch in zip(peers, batches):
                chain.peer_connected(p)
                chain.headers(p, batch)
                await asyncio.sleep(0.05)
            want = sum(len(b) for b in batches) if not kill else 2
            async with asyncio.timeout(5):
                while chain.get_best().height < want or not chain.is_synced():
                    await asyncio.sleep(0.01)
            await asyncio.sleep(0.05)
            seen = [(type(e).__name__, e.node.height, e.node.hash)
                    for e in sub.drain_nowait()]
            best = chain.get_best()
    sent = [_frames(pkg, p.sent) for p in peers]
    killed = [type(p.killed).__name__ if p.killed else None for p in peers]
    return sent, killed, sorted(store.scan_prefix(b"")), (best.height, best.hash), seen


@pytest.mark.parametrize("split", [[15], [3, 12], [5, 5, 5]], ids=["one", "two", "three"])
async def test_chain_sends_and_stores_the_same(split):
    batches, at = [], 0
    for n in split:
        batches.append(HEADERS[at:at + n])
        at += n
    ref = await _drive_chain("ref", batches)
    port = await _drive_chain("port", batches)
    assert ref == port
    assert port[3][0] == 15
    assert port[0][0], "the chain asked its peer for headers"
    assert [e[1] for e in port[4] if e[0] == "ChainSynced"] == [split[0]]


async def test_chain_kills_a_peer_for_bad_headers_alike():
    bad = list(HEADERS[:6])
    bad[3] = HEADERS[9]  # does not connect
    ref = await _drive_chain("ref", [HEADERS[:2], bad], kill=True)
    port = await _drive_chain("port", [HEADERS[:2], bad], kill=True)
    assert ref == port
    assert port[1][1] == "PeerSentBadHeaders"


@pytest.mark.parametrize("s", ["127.0.0.1", "127.0.0.1:8333", "[::1]", "[::1]:18444",
                               "::1", "host.example", "host.example:99", "[fe80::1%eth0]:1",
                               ":", "", "[::1"])
async def test_address_strings_split_and_resolve_alike(s):
    ref = R_peermgr.to_host_service(s)
    port = P_peermgr.to_host_service(s)
    assert ref == port
    if ref[0] is not None and not ref[0][0:1].isalpha():
        assert await R_peermgr.to_sock_addr(R.BCH_REGTEST, s) == \
            await P_peermgr.to_sock_addr(P.BCH_REGTEST, s)


@pytest.mark.parametrize("height", [0, 15, 840_000])
def test_version_message_is_the_same_bytes(height):
    out = []
    for pkg in ("ref", "port"):
        T, _, _, M, W = PKGS[pkg]
        local = W.NetworkAddress.from_host_port("0.0.0.0", 0, services=1)
        remote = W.NetworkAddress.from_host_port("127.0.0.1", 18444, services=1)
        v = M.build_version(T.BCH_REGTEST, 0x1234_5678_9ABC, height, local, remote,
                            timestamp=1_700_000_000)
        out.append(_frames(pkg, [v]))
    assert out[0] == out[1]


async def _session(pkg, chunked: bool):
    """One peer session against the fake remote: the messages the peer
    published, as wire bytes, and the blocks it fetched."""
    T, _, Pe, _, W = PKGS[pkg]
    net = T.BCH_REGTEST
    connect = dummy_peer_connect(R.BCH_REGTEST, all_blocks())
    if chunked:
        inner = connect

        import contextlib

        @contextlib.asynccontextmanager
        async def connect():
            async with inner() as conn:
                class OneByte:
                    def __init__(self):
                        self.buf = b""

                    async def read_chunk(self):
                        if not self.buf:
                            self.buf = await conn.read_chunk()
                        b, self.buf = self.buf[:1], self.buf[1:]
                        return b

                    async def write(self, data):
                        await conn.write(data)

                yield OneByte()
    pub = T.Publisher()
    inbox = T.Mailbox(name="peer")
    cfg = Pe.PeerConfig(pub=pub, net=net, label="fake", connect=connect)
    peer = Pe.Peer(inbox, pub, "fake")
    got = []
    async with pub.subscription() as sub:
        task = asyncio.get_running_loop().create_task(Pe.run_peer(cfg, peer, inbox))
        try:
            async with asyncio.timeout(20):
                version = await sub.receive_match(
                    lambda ev: ev.message if isinstance(ev, Pe.PeerMessage)
                    and isinstance(ev.message, W.MsgVersion) else None)
                got.append(version.version)
                blocks = await Pe.get_blocks(net, 10, peer,
                                             [b.header.hash for b in all_blocks()[3:7]])
                got.extend(W.encode_message(net, W.MsgBlock(b)) for b in blocks)
                got.append(await Pe.ping_peer(5, peer))
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
    return got


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "one_byte_chunks"])
async def test_peer_session_reads_and_fetches_alike(chunked):
    ref = await _session("ref", chunked)
    port = await _session("port", chunked)
    assert ref == port
    assert len(port) == 6 and port[-1] is True


async def test_chain_reassembles_split_frames():
    """The port's peer over one-byte chunks returns what it returns over
    whole frames."""
    assert await _session("port", True) == await _session("port", False)


async def _handshake(pkg):
    """A node without an engine dials the fake remote: what its peer
    manager recorded of the handshake, and what it published."""
    T = PKGS[pkg][0]
    pub = T.Publisher(name=f"{pkg}-handshake", maxsize=None)
    cfg = T.NodeConfig(net=T.BCH_REGTEST, store=T.MemoryKV(), pub=pub, peers=["[::1]:17486"],
                       connect=lambda sa: dummy_peer_connect(R.BCH_REGTEST, all_blocks()),
                       stats_interval=0)
    async with pub.subscription() as events:
        async with T.Node(cfg) as node:
            async with asyncio.timeout(10):
                p = await events.receive_match(
                    lambda ev: ev.peer if isinstance(ev, T.PeerConnected) else None)
                await events.receive_match(
                    lambda ev: ev if isinstance(ev, T.ChainSynced) else None)
            o = node.peer_mgr.get_online_peer(p)
            v = o.version
            return ((v.version, v.services, v.user_agent, v.start_height, v.relay,
                     v.addr_from.serialize() if hasattr(v.addr_from, "serialize") else None),
                    o.online, o.address, [x.address for x in node.peer_mgr.get_peers()],
                    # the lifetime counters read the package's global registry
                    {k: v for k, v in node.peer_mgr.backoff_stats().items()
                     if k in ("addresses", "tracked", "backing_off", "banned")},
                    node.health()["peers_online"])


async def test_peer_manager_handshakes_alike():
    ref = await _handshake("ref")
    port = await _handshake("port")
    assert ref == port
    assert port[1] is True and port[5] == 1
