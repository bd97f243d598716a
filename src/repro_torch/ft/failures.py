"""Failure handling: heartbeat monitor + checkpoint/restart supervisor.

The supervisor loop every production launcher needs:

    while not done:
        try:  run_training(from=latest_checkpoint)
        except WorkerFailure:  shrink/replace mesh, restore, continue

``Supervisor.run`` implements that loop generically over a ``train_fn`` that
periodically calls ``heartbeat()`` and raises on simulated/real failure; the
test suite drives it with injected faults (tests/test_torch_ft.py).  Combined with
checkpoint/elastic.py the restart may land on a *different* device count —
elastic scaling.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class WorkerFailure(RuntimeError):
    def __init__(self, host: int, msg: str = ""):
        super().__init__(f"worker {host} failed {msg}")
        self.host = host


@dataclass
class HeartbeatMonitor:
    timeout_s: float = 30.0
    last_beat: Dict[int, float] = field(default_factory=dict)

    def beat(self, host: int, now: Optional[float] = None) -> None:
        self.last_beat[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self.last_beat.items() if now - t > self.timeout_s]


@dataclass
class Supervisor:
    """Checkpoint/restart driver with bounded retries and elastic shrink."""

    max_restarts: int = 5
    backoff_s: float = 0.0  # real launchers back off; tests use 0
    history: List[str] = field(default_factory=list)

    def run(self, train_fn: Callable[[int], str], total_attempts: Optional[int] = None):
        """``train_fn(attempt) -> "done"`` or raises WorkerFailure."""
        attempts = total_attempts or (self.max_restarts + 1)
        last_exc: Optional[BaseException] = None
        for attempt in range(attempts):
            try:
                result = train_fn(attempt)
                self.history.append(f"attempt {attempt}: {result}")
                return result
            except WorkerFailure as e:
                last_exc = e
                self.history.append(f"attempt {attempt}: {e}")
                if self.backoff_s:
                    time.sleep(self.backoff_s)
        raise RuntimeError(
            f"training failed after {attempts} attempts: {last_exc}"
        ) from last_exc
