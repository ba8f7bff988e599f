"""Network parameter tables for Bitcoin and Bitcoin Cash chains.

The reference consumes these as haskoin-core's ``Network`` constants object
(reference: package.yaml:25; used at src/Haskoin/Node/PeerMgr.hs:282,584-585
and src/Haskoin/Node/Chain.hs:330).  Each network bundles the wire magic, DNS
seeds, default port, genesis block header, and the difficulty rules the header
consensus code (headers.py) needs.
"""

from __future__ import annotations

from dataclasses import dataclass

from .util import bits_to_target

__all__ = [
    "Network",
    "BTC",
    "BTC_TEST",
    "BTC_REGTEST",
    "BCH",
    "BCH_TEST",
    "BCH_REGTEST",
    "NETWORKS",
]

# Service bits (protocol: version message `services` field)
NODE_NETWORK = 1 << 0
NODE_WITNESS = 1 << 3

# P2P protocol version we advertise (reference PeerMgr.hs:866-867).
PROTOCOL_VERSION = 70012


@dataclass(frozen=True)
class Genesis:
    version: int
    merkle: bytes  # internal byte order
    timestamp: int
    bits: int
    nonce: int


# Coinbase merkle root shared by every Bitcoin-lineage genesis block
# (display order 4a5e1e4b...; stored internal/little-endian).
_GENESIS_MERKLE = bytes.fromhex(
    "4a5e1e4baab89f3a32518a88c31bc87f618f76673e2cc77ab2127b7afdeda33b"
)[::-1]


@dataclass(frozen=True)
class Network:
    """Static consensus + wire constants for one chain."""

    name: str
    magic: int  # wire magic, serialized big-endian (4 bytes)
    default_port: int
    seeds: tuple[str, ...]
    user_agent: str
    segwit: bool
    genesis: Genesis
    pow_limit: int  # maximum (easiest) target
    pow_target_timespan: int = 14 * 24 * 3600  # two weeks
    pow_target_spacing: int = 600
    # testnet3/regtest: allow min-difficulty blocks after 2*spacing idle
    allow_min_difficulty: bool = False
    # regtest: no retargeting at all
    no_retargeting: bool = False
    # Bitcoin Cash difficulty hard forks (mainnet/testnet heights; None on BTC
    # and on regtest where they never activate via height).
    bch: bool = False
    eda_height: int | None = None  # UAHF emergency difficulty adjustment
    daa_height: int | None = None  # Nov 2017 cw-144 DAA
    asert_height: int | None = None  # Nov 2020 aserti3-2d
    asert_anchor: tuple[int, int, int] | None = None  # (height, bits, prev timestamp)

    @property
    def retarget_interval(self) -> int:
        return self.pow_target_timespan // self.pow_target_spacing  # 2016

    @property
    def pow_limit_bits(self) -> int:
        from .util import target_to_bits

        return target_to_bits(self.pow_limit)


_MAINNET_POW_LIMIT = bits_to_target(0x1D00FFFF)
_REGTEST_POW_LIMIT = bits_to_target(0x207FFFFF)

BTC = Network(
    name="btc",
    magic=0xF9BEB4D9,
    default_port=8333,
    seeds=(
        "seed.bitcoin.sipa.be",
        "dnsseed.bluematt.me",
        "dnsseed.bitcoin.dashjr.org",
        "seed.bitcoinstats.com",
        "seed.bitcoin.jonasschnelli.ch",
        "seed.btc.petertodd.org",
    ),
    user_agent="/tpunode:0.1.0/",
    segwit=True,
    genesis=Genesis(1, _GENESIS_MERKLE, 1231006505, 0x1D00FFFF, 2083236893),
    pow_limit=_MAINNET_POW_LIMIT,
)

BTC_TEST = Network(
    name="btctest",
    magic=0x0B110907,
    default_port=18333,
    seeds=(
        "testnet-seed.bitcoin.jonasschnelli.ch",
        "seed.tbtc.petertodd.org",
        "seed.testnet.bitcoin.sprovoost.nl",
        "testnet-seed.bluematt.me",
    ),
    user_agent="/tpunode:0.1.0/",
    segwit=True,
    genesis=Genesis(1, _GENESIS_MERKLE, 1296688602, 0x1D00FFFF, 414098458),
    pow_limit=_MAINNET_POW_LIMIT,
    allow_min_difficulty=True,
)

BTC_REGTEST = Network(
    name="btcreg",
    magic=0xFABFB5DA,
    default_port=18444,
    seeds=(),
    user_agent="/tpunode:0.1.0/",
    segwit=True,
    genesis=Genesis(1, _GENESIS_MERKLE, 1296688602, 0x207FFFFF, 2),
    pow_limit=_REGTEST_POW_LIMIT,
    allow_min_difficulty=True,
    no_retargeting=True,
)

BCH = Network(
    name="bch",
    magic=0xE3E1F3E8,
    default_port=8333,
    seeds=(
        "seed.bitcoinabc.org",
        "seed.bchd.cash",
        "btccash-seeder.bitcoinunlimited.info",
        "seed.flowee.cash",
    ),
    user_agent="/tpunode:0.1.0/",
    segwit=False,
    genesis=Genesis(1, _GENESIS_MERKLE, 1231006505, 0x1D00FFFF, 2083236893),
    pow_limit=_MAINNET_POW_LIMIT,
    bch=True,
    eda_height=478558,
    daa_height=504031,
    asert_height=661647,
    # ASERT anchor: height, anchor block nBits, parent-of-anchor timestamp
    # (BCH mainnet activation block 661647 per the aserti3-2d spec).
    asert_anchor=(661647, 0x1804DAFE, 1605447844),
)

BCH_TEST = Network(
    name="bchtest",
    magic=0xF4E5F3F4,
    default_port=18333,
    seeds=(
        "testnet-seed.bitcoinabc.org",
        "testnet-seed.bchd.cash",
    ),
    user_agent="/tpunode:0.1.0/",
    segwit=False,
    genesis=Genesis(1, _GENESIS_MERKLE, 1296688602, 0x1D00FFFF, 414098458),
    pow_limit=_MAINNET_POW_LIMIT,
    allow_min_difficulty=True,
    bch=True,
    eda_height=1155875,
    daa_height=1188697,
    asert_height=1421481,
    asert_anchor=(1421481, 0x1D00FFFF, 1605445400),
)

BCH_REGTEST = Network(
    name="bchreg",
    magic=0xDAB5BFFA,
    default_port=18444,
    seeds=(),
    user_agent="/tpunode:0.1.0/",
    segwit=False,
    genesis=Genesis(1, _GENESIS_MERKLE, 1296688602, 0x207FFFFF, 2),
    pow_limit=_REGTEST_POW_LIMIT,
    allow_min_difficulty=True,
    no_retargeting=True,
    bch=True,
)

NETWORKS: dict[str, Network] = {
    n.name: n for n in (BTC, BTC_TEST, BTC_REGTEST, BCH, BCH_TEST, BCH_REGTEST)
}
