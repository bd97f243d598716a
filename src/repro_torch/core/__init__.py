"""RapidStore core: subgraph-centric MVCC dynamic graph storage, with the
view's device materializations as torch tensors on ``store.device``.

Storage lifecycle: commits accumulate as copy-on-write versions in per-
subgraph chains (the hot delta stream, lineage-logged); the
:class:`Compactor` folds versions retired below the oldest reader into a
frozen packed base level and trims the lineage; a checkpoint cycle persists
the base through :mod:`repro_torch.checkpoint.manager` and truncates the
:class:`WriteAheadLog`, which ``RapidStore.recover`` replays after a crash.
A :class:`ShardPlane` lays each view's tiles over shards (several may share
one card) and answers the collective analytics; a :class:`Rebalancer`
migrates subgraphs between shards as WAL-logged placement epochs.
"""

from .clock import ClockStallError, LogicalClock
from .compactor import CompactionReport, Compactor
from .device_cache import DeviceCSRView, DeviceLeafBlockView, DeviceTieredBlocks
from .leaf_pool import LeafPool, SENTINEL
from .reader_tracer import ReaderTracer, FREE_TS
from .reshard import Rebalancer
from .shard_plane import ShardPlane, ShardedViewAssembly
from .snapshot import CompactLeafStream, CSRView, LeafBlockView, SnapshotView
from .store import RapidStore, ReadHandle, StoreStats
from .subgraph import SubgraphSnapshot, build_subgraph
from .version_chain import CommitLineage, VersionChain
from .view_assembler import ViewAssembly
from .wal import WalRecord, WriteAheadLog
from .write_pipeline import WritePipeline, WriteTicket

__all__ = [
    "ClockStallError",
    "CommitLineage",
    "CompactionReport",
    "Compactor",
    "StoreStats",
    "WalRecord",
    "WriteAheadLog",
    "WritePipeline",
    "WriteTicket",
    "ViewAssembly",
    "LogicalClock",
    "LeafPool",
    "SENTINEL",
    "ReaderTracer",
    "Rebalancer",
    "ShardPlane",
    "ShardedViewAssembly",
    "FREE_TS",
    "CompactLeafStream",
    "CSRView",
    "DeviceCSRView",
    "DeviceLeafBlockView",
    "DeviceTieredBlocks",
    "LeafBlockView",
    "SnapshotView",
    "RapidStore",
    "ReadHandle",
    "SubgraphSnapshot",
    "build_subgraph",
    "VersionChain",
]
