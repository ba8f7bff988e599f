"""tpunode_torch: the PyTorch + CUDA port of tpunode.

The JAX package ``tpunode`` is the reference; this package is its port to an
NVIDIA H100, slice by slice.  It imports torch, numpy and the standard
library only — never jax, never tpunode.  See README.md, "The PyTorch/CUDA
port".

The public surface is the reference's, less what the port does not have yet
(the debug HTTP server): the node (``Node``, ``NodeConfig``), its chain and
peer managers, the stores and the transaction layer.
"""

from .actors import LinkedTasks, Mailbox, Publisher, Supervisor
from .events import EventLog, StatsReporter, events
from .metrics import Histogram, Metrics, metrics
from .tracectx import Trace, Tracer, start_trace, tracer
from .watchdog import Watchdog, WatchdogConfig
from .chain import (
    Chain,
    ChainBestBlock,
    ChainConfig,
    ChainEvent,
    ChainSynced,
)
from .headers import (
    BadHeaders,
    BlockNode,
    block_locator,
    connect_blocks,
    genesis_node,
    get_ancestor,
    get_parents,
    median_time_past,
    next_work_required,
    split_point,
)
from .node import (
    IbdConfig,
    Node,
    NodeConfig,
    TxVerdict,
    VerifyShed,
    tcp_connect,
)
from .params import (
    BCH,
    BCH_REGTEST,
    BCH_TEST,
    BTC,
    BTC_REGTEST,
    BTC_TEST,
    NETWORKS,
    Network,
)
from .peer import (
    Peer,
    PeerConfig,
    PeerConnected,
    PeerDisconnected,
    PeerError,
    PeerEvent,
    PeerMessage,
    get_blocks,
    get_data,
    get_txs,
    ping_peer,
)
from .peermgr import (
    OnlinePeer,
    PeerMgr,
    PeerMgrConfig,
    build_version,
    to_host_service,
    to_sock_addr,
)
from .store import (
    LogKV,
    MemoryKV,
    Namespaced,
    StoreVersionError,
    open_store,
)
from .utxo import UtxoStore
from .sighash import bip143_sighash, bip341_sighash, legacy_sighash
from .txverify import (
    ExtractStats,
    SigItem,
    combine_verdicts,
    extract_sig_items,
    intra_block_prevouts,
    is_p2tr,
    msig_match,
    wants_amount,
)
from .wire import (
    Block,
    BlockHeader,
    InvType,
    InvVector,
    LazyBlock,
    LazyTx,
    NetworkAddress,
    Tx,
    build_merkle_root,
)
