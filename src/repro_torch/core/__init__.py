"""RapidStore core: subgraph-centric MVCC dynamic graph storage, with the
view's device materializations as torch tensors on ``store.device``."""

from .clock import ClockStallError, LogicalClock
from .device_cache import DeviceCSRView, DeviceLeafBlockView, DeviceTieredBlocks
from .leaf_pool import LeafPool, SENTINEL
from .reader_tracer import ReaderTracer, FREE_TS
from .snapshot import CompactLeafStream, CSRView, LeafBlockView, SnapshotView
from .store import RapidStore, ReadHandle, StoreStats
from .subgraph import SubgraphSnapshot, build_subgraph
from .version_chain import CommitLineage, VersionChain
from .view_assembler import ViewAssembly

__all__ = [
    "ClockStallError",
    "CommitLineage",
    "StoreStats",
    "ViewAssembly",
    "LogicalClock",
    "LeafPool",
    "SENTINEL",
    "ReaderTracer",
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
