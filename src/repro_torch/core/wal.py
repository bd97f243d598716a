"""Write-ahead log: the durability half of the storage lifecycle.

Storage lifecycle (ROADMAP item 2)::

    hot deltas (version chains + CommitLineage, RAM)
        --[ compactor fold ]-->  frozen packed base level (RAM, repacked)
        --[ checkpoint     ]-->  durable base snapshot (checkpoint/manager)
    every commit             -->  WAL record (this module, fsync'd pre-publish)

The WAL records the *net* effect of every commit — the coalesced
insert/delete edge arrays, vertex-flag changes, and the store's vertex-count
watermark — plus compactor *repack* events (layout changes with no edge-set
effect).  Records are appended and fsync'd BEFORE the commit timestamp is
published: once a reader can observe ``t_r >= ts``, the record for ``ts`` is
durable.  The group-commit pipeline appends a whole drained run and pays ONE
``sync()`` before its single ``publish_range`` — the one-fsync-per-drain
cadence that keeps WAL-on ingest within a small factor of WAL-off.

Recovery contract (:meth:`RapidStore.recover`): replay = newest committed
checkpoint + this log's suffix.  Repack records make replay *layout*-faithful,
not just edge-set-faithful: the clustered-index <-> C-ART layout is
path-dependent (promotion/demotion hysteresis), so replaying the same ops —
including repacks — at the same timestamps reproduces bitwise-identical
``SnapshotView`` materializations.

File format (all little-endian)::

    header:  magic b"RSWL" | u32 version | u64 start_ts         (16 bytes)
    record:  u32 payload_len | u32 crc32(payload) | payload
    payload: u8 kind | u64 ts | u64 n_vertices | kind-specific body
      kind 0 (commit): u32 n_ins | u32 n_dels | u32 n_vset
                       | ins  int64 [n_ins, 2]
                       | dels int64 [n_dels, 2]
                       | vset (int64 vid, u8 flag) * n_vset
      kind 1 (repack): u32 n_sids | sids int64 [n_sids]
      kind 2 (migrate): u32 n_moves | (int64 sid, int64 dst_shard) * n_moves

A torn tail (crash mid-append) is detected by the length/CRC frame and
truncated on reopen; everything before it replays.  ``start_ts`` is the
timestamp the log's history begins AFTER — :meth:`WriteAheadLog.reset`
rewrites the log to a checkpoint's timestamp, keeping any later records,
which is what bounds the replay window.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

_MAGIC = b"RSWL"
_VERSION = 1
_HEADER = struct.Struct("<4sIQ")   # magic, version, start_ts
_FRAME = struct.Struct("<II")      # payload_len, crc32
_COMMIT_HEAD = struct.Struct("<BQQIII")  # kind, ts, n_vertices, n_ins, n_dels, n_vset
_REPACK_HEAD = struct.Struct("<BQQI")    # kind, ts, n_vertices, n_sids
_MIGRATE_HEAD = struct.Struct("<BQQI")   # kind, ts, n_vertices, n_moves
_VSET_ENTRY = struct.Struct("<qB")
_MOVE_ENTRY = struct.Struct("<qq")       # sid, dst shard index

KIND_COMMIT = 0
KIND_REPACK = 1
KIND_MIGRATE = 2


class WalRecord:
    """One decoded log record (see the module docstring for the format)."""

    __slots__ = ("kind", "ts", "n_vertices", "ins", "dels", "vset", "sids",
                 "moves")

    def __init__(self, kind, ts, n_vertices, ins=None, dels=None, vset=None,
                 sids=None, moves=None) -> None:
        self.kind = kind
        self.ts = ts
        self.n_vertices = n_vertices
        self.ins = ins
        self.dels = dels
        self.vset = vset
        self.sids = sids
        self.moves = moves  # KIND_MIGRATE: {sid: dst shard index}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        if self.kind == KIND_REPACK:
            return f"WalRecord(repack, ts={self.ts}, sids={self.sids})"
        if self.kind == KIND_MIGRATE:
            return f"WalRecord(migrate, ts={self.ts}, moves={self.moves})"
        return (
            f"WalRecord(commit, ts={self.ts}, ins={len(self.ins)}, "
            f"dels={len(self.dels)}, vset={len(self.vset or {})})"
        )


def _encode_commit(ts, ins, dels, vset, n_vertices) -> bytes:
    ins = np.ascontiguousarray(np.asarray(ins, np.int64).reshape(-1, 2))
    dels = np.ascontiguousarray(np.asarray(dels, np.int64).reshape(-1, 2))
    vset = vset or {}
    parts = [
        _COMMIT_HEAD.pack(KIND_COMMIT, ts, n_vertices, len(ins), len(dels),
                          len(vset)),
        ins.tobytes(),
        dels.tobytes(),
    ]
    for vid in sorted(vset):
        parts.append(_VSET_ENTRY.pack(int(vid), 1 if vset[vid] else 0))
    return b"".join(parts)


def _encode_repack(ts, sids, n_vertices) -> bytes:
    sids = np.ascontiguousarray(np.asarray(sids, np.int64).reshape(-1))
    return _REPACK_HEAD.pack(KIND_REPACK, ts, n_vertices, len(sids)) + sids.tobytes()


def _encode_migrate(ts, moves, n_vertices) -> bytes:
    parts = [_MIGRATE_HEAD.pack(KIND_MIGRATE, ts, n_vertices, len(moves))]
    for sid in sorted(moves):
        parts.append(_MOVE_ENTRY.pack(int(sid), int(moves[sid])))
    return b"".join(parts)


def _decode(payload: bytes) -> WalRecord:
    kind = payload[0]
    if kind == KIND_COMMIT:
        _, ts, n_vertices, n_ins, n_dels, n_vset = _COMMIT_HEAD.unpack_from(payload)
        off = _COMMIT_HEAD.size
        ins = np.frombuffer(payload, np.int64, n_ins * 2, off).reshape(-1, 2)
        off += n_ins * 16
        dels = np.frombuffer(payload, np.int64, n_dels * 2, off).reshape(-1, 2)
        off += n_dels * 16
        vset: Dict[int, bool] = {}
        for _ in range(n_vset):
            vid, flag = _VSET_ENTRY.unpack_from(payload, off)
            vset[vid] = bool(flag)
            off += _VSET_ENTRY.size
        if off != len(payload):
            raise ValueError("commit record length mismatch")
        return WalRecord(KIND_COMMIT, ts, n_vertices, ins=ins.copy(),
                         dels=dels.copy(), vset=vset or None)
    if kind == KIND_REPACK:
        _, ts, n_vertices, n_sids = _REPACK_HEAD.unpack_from(payload)
        off = _REPACK_HEAD.size
        sids = np.frombuffer(payload, np.int64, n_sids, off)
        if off + n_sids * 8 != len(payload):
            raise ValueError("repack record length mismatch")
        return WalRecord(KIND_REPACK, ts, n_vertices, sids=[int(s) for s in sids])
    if kind == KIND_MIGRATE:
        _, ts, n_vertices, n_moves = _MIGRATE_HEAD.unpack_from(payload)
        off = _MIGRATE_HEAD.size
        moves: Dict[int, int] = {}
        for _ in range(n_moves):
            sid, dst = _MOVE_ENTRY.unpack_from(payload, off)
            moves[int(sid)] = int(dst)
            off += _MOVE_ENTRY.size
        if off != len(payload):
            raise ValueError("migrate record length mismatch")
        return WalRecord(KIND_MIGRATE, ts, n_vertices, moves=moves)
    raise ValueError(f"unknown WAL record kind {kind}")


def _scan(raw: bytes) -> Tuple[int, List[WalRecord], bool]:
    """Walk frames from byte 16; returns (valid_end_offset, records, clean)."""
    records: List[WalRecord] = []
    off = _HEADER.size
    n = len(raw)
    while True:
        if off + _FRAME.size > n:
            return off, records, off == n  # clean only at an exact frame edge
        length, crc = _FRAME.unpack_from(raw, off)
        body_start = off + _FRAME.size
        if body_start + length > n:
            return off, records, False
        payload = raw[body_start : body_start + length]
        if zlib.crc32(payload) != crc:
            return off, records, False
        try:
            records.append(_decode(payload))
        except (ValueError, IndexError, struct.error):
            return off, records, False
        off = body_start + length


class WriteAheadLog:
    """Append-only framed commit log with batched fsync.

    Opening an existing log validates the header, walks the frames, and
    physically truncates any torn tail so later appends never interleave
    with garbage.  ``fsync=False`` downgrades :meth:`sync` to an OS-buffer
    flush — the data still survives a process SIGKILL (the bytes are in the
    kernel), just not a host power loss; benchmarks use it to isolate the
    fsync cost.

    ``hook_before_sync`` / ``hook_after_sync`` are crash-injection points
    for the recovery tests: callables invoked around the durability barrier.
    """

    def __init__(self, path, start_ts: int = 0, fsync: bool = True) -> None:
        self.path = str(path)
        self.fsync_enabled = bool(fsync)
        self.records_appended = 0
        self.syncs = 0
        self.bytes_appended = 0
        self._unsynced_bytes = 0
        self.hook_before_sync = None
        self.hook_after_sync = None
        self._lock = threading.Lock()
        self._dirty = False
        exists = os.path.exists(self.path) and os.path.getsize(self.path) > 0
        if exists:
            with open(self.path, "rb") as f:
                raw = f.read()
            magic, version, file_start = _HEADER.unpack_from(raw)
            if magic != _MAGIC or version != _VERSION:
                raise ValueError(f"{self.path}: not a RapidStore WAL")
            valid_end, _, _ = _scan(raw)
            self.start_ts = int(file_start)
            self._f = open(self.path, "r+b")
            self._f.truncate(valid_end)
            self._f.seek(valid_end)
        else:
            self.start_ts = int(start_ts)
            self._f = open(self.path, "wb")
            self._f.write(_HEADER.pack(_MAGIC, _VERSION, self.start_ts))
            self._f.flush()
            os.fsync(self._f.fileno())

    # -- append side --------------------------------------------------------
    def _append(self, payload: bytes) -> None:
        frame = _FRAME.pack(len(payload), zlib.crc32(payload))
        with self._lock:
            self._f.write(frame)
            self._f.write(payload)
            self._dirty = True
            self.records_appended += 1
            self.bytes_appended += len(frame) + len(payload)
            self._unsynced_bytes += len(frame) + len(payload)

    def append_commit(self, ts: int, ins, dels, vset, n_vertices: int) -> None:
        """Log one commit's net write.  Call BEFORE publishing ``ts``."""
        self._append(_encode_commit(int(ts), ins, dels, vset, int(n_vertices)))

    def append_repack(self, ts: int, sids, n_vertices: int) -> None:
        """Log a compactor repack (layout-only commit) at ``ts``."""
        self._append(_encode_repack(int(ts), sids, int(n_vertices)))

    def append_migrate(self, ts: int, moves, n_vertices: int) -> None:
        """Log a placement-epoch flip (no-write commit) at ``ts``.

        ``moves`` maps subgraph id -> destination shard index.  Like
        repacks, migrations carry no edge-set effect but ARE replayed by
        :meth:`RapidStore.recover` so the restored store's placement
        history matches the crashed store's.
        """
        self._append(_encode_migrate(int(ts), moves, int(n_vertices)))

    def sync(self) -> None:
        """Durability barrier: flush buffered records (+fsync when enabled).

        The group-commit pipeline calls this once per drained run, between
        the batch appends and the single ``publish_range`` — batching the
        fsync exactly like it batches the publish.
        """
        hook = self.hook_before_sync
        if hook is not None:
            hook()
        with self._lock:
            if self._dirty:
                self._f.flush()
                if self.fsync_enabled:
                    os.fsync(self._f.fileno())
                self._dirty = False
                self.syncs += 1
                self._unsynced_bytes = 0
        hook = self.hook_after_sync
        if hook is not None:
            hook()

    # -- maintenance --------------------------------------------------------
    def reset(self, start_ts: int) -> None:
        """Rewrite the log to begin after ``start_ts`` (checkpoint trim).

        Records with ``ts > start_ts`` — commits that raced past the
        checkpoint's snapshot timestamp — are preserved, so reset never
        loses durable history; everything at or below is covered by the
        checkpoint and dropped.  Atomic via tmp-file + rename.
        """
        with self._lock:
            self._f.flush()
            with open(self.path, "rb") as f:
                raw = f.read()
            _, records, _ = _scan(raw)
            keep = [r for r in records if r.ts > start_ts]
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(_HEADER.pack(_MAGIC, _VERSION, int(start_ts)))
                for r in keep:
                    if r.kind == KIND_REPACK:
                        payload = _encode_repack(r.ts, r.sids, r.n_vertices)
                    elif r.kind == KIND_MIGRATE:
                        payload = _encode_migrate(r.ts, r.moves, r.n_vertices)
                    else:
                        payload = _encode_commit(
                            r.ts, r.ins, r.dels, r.vset, r.n_vertices
                        )
                    f.write(_FRAME.pack(len(payload), zlib.crc32(payload)))
                    f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            self.start_ts = int(start_ts)
            self._f = open(self.path, "r+b")
            self._f.seek(0, os.SEEK_END)
            self._dirty = False
            self._unsynced_bytes = 0

    def backlog_bytes(self) -> int:
        """Bytes appended but not yet durability-barriered by :meth:`sync`.

        Exported as the ``wal_backlog_bytes`` gauge on the owning store's
        registry — a growing backlog means commits are outrunning the sync
        cadence (or a committer died between append and sync).  Lock-free
        read of a single int (benign: monotone between syncs).
        """
        return self._unsynced_bytes

    def size_bytes(self) -> int:
        with self._lock:
            self._f.flush()
            return os.path.getsize(self.path)

    def close(self) -> None:
        with self._lock:
            try:
                self._f.flush()
                if self.fsync_enabled:
                    os.fsync(self._f.fileno())
            finally:
                self._f.close()

    # -- replay side --------------------------------------------------------
    @classmethod
    def replay(cls, path) -> Tuple[int, List[WalRecord], bool]:
        """Decode a log: ``(start_ts, records sorted by ts, clean_tail)``.

        ``clean_tail`` is False when a torn frame was found (crash
        mid-append); the preceding records are still valid and returned.
        Records are sorted by commit timestamp — concurrent single-shot
        writers may append out of order, but any ts gap separates commits
        on disjoint subgraphs (overlapping writes serialize on locks or
        shard queues), so in-timestamp-order replay is always consistent.
        """
        with open(path, "rb") as f:
            raw = f.read()
        if len(raw) < _HEADER.size:
            raise ValueError(f"{path}: truncated WAL header")
        magic, version, start_ts = _HEADER.unpack_from(raw)
        if magic != _MAGIC or version != _VERSION:
            raise ValueError(f"{path}: not a RapidStore WAL")
        end, records, clean = _scan(raw)
        records.sort(key=lambda r: r.ts)
        return int(start_ts), records, clean and end == len(raw)


__all__ = ["KIND_COMMIT", "KIND_MIGRATE", "KIND_REPACK", "WalRecord",
           "WriteAheadLog"]
