"""Straggler detection + mitigation harness.

On a synchronous mesh of cards, stragglers show up as step-time skew across
hosts.  The production recipe this module encodes:

1. per-host step timing ring buffer,
2. robust skew detection (median + k*MAD rule — one slow host flags, a
   global slowdown does not),
3. mitigation hooks: re-balance input shards away from the slow host
   (deterministic work partitioning makes this a pure re-indexing), and
   escalate to checkpoint-evict-restart when skew persists.

The detector is pure logic (testable on CPU); the hooks are callbacks the
launcher wires to its scheduler.
"""

from __future__ import annotations

import collections
import statistics
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional


@dataclass
class StragglerConfig:
    window: int = 16  # steps per decision
    mad_k: float = 5.0  # flag hosts slower than median + k*MAD
    min_abs_skew_s: float = 0.05  # ignore sub-50ms skew
    persist_steps: int = 3  # consecutive flags before mitigation


@dataclass
class HostStats:
    times: Deque[float] = field(default_factory=lambda: collections.deque(maxlen=64))
    flags: int = 0


class StragglerDetector:
    def __init__(self, n_hosts: int, cfg: StragglerConfig = StragglerConfig(),
                 on_rebalance: Optional[Callable[[int], None]] = None,
                 on_evict: Optional[Callable[[int], None]] = None):
        self.cfg = cfg
        self.hosts: Dict[int, HostStats] = {h: HostStats() for h in range(n_hosts)}
        self.on_rebalance = on_rebalance
        self.on_evict = on_evict
        self.evicted: List[int] = []

    def record_step(self, host: int, seconds: float) -> None:
        self.hosts[host].times.append(seconds)

    def check(self) -> List[int]:
        """Returns hosts flagged this round; fires mitigation callbacks."""
        med_per_host = {
            h: statistics.median(s.times)
            for h, s in self.hosts.items()
            if len(s.times) >= self.cfg.window and h not in self.evicted
        }
        if len(med_per_host) < 2:
            return []
        meds = list(med_per_host.values())
        global_med = statistics.median(meds)
        mad = statistics.median([abs(m - global_med) for m in meds]) or 1e-9
        flagged = []
        for h, m in med_per_host.items():
            skew = m - global_med
            if skew > max(self.cfg.mad_k * mad, self.cfg.min_abs_skew_s):
                self.hosts[h].flags += 1
                flagged.append(h)
                if self.hosts[h].flags == 1 and self.on_rebalance:
                    self.on_rebalance(h)
                if self.hosts[h].flags >= self.cfg.persist_steps:
                    if self.on_evict and h not in self.evicted:
                        self.on_evict(h)
                        self.evicted.append(h)
            else:
                self.hosts[h].flags = 0
        return flagged
