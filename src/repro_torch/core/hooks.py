"""Named injection points for the deterministic schedule harness.

Production code calls :meth:`HookPoints.fire` at interesting lifecycle
points (one dict lookup when unarmed — free enough for hot paths); the test
harness (``tests/_torch_schedule.py``) installs callables that park the
calling thread on barriers/events, turning "hope a stress loop hits the race" into
"force the exact interleaving".  The same shape as the WAL's
``hook_before_sync``/``hook_after_sync`` crash points, generalized to a
named registry so a subsystem can expose many points without growing an
attribute per point.

Points currently fired (see :mod:`repro_torch.core.reshard` for the migration
lifecycle they bracket):

- ``hook_before_send`` / ``hook_after_send`` — around one subgraph's tile
  upload (SEND) to its target shard;
- ``hook_after_recv`` — after staged tiles are committed into the
  per-(snapshot, shard) cache;
- ``hook_after_audit`` — after the RUN generation-stamp freshness audit;
- ``hook_before_flip`` / ``hook_after_flip`` — around the placement-epoch
  commit (after the WAL migrate record is durable / after publish);
- ``hook_before_free`` — before source-shard tiles are dropped;
- ``hook_before_assembly`` — in the shard plane, after a view resolved its
  placement epoch but before any tile fetch.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional


class HookPoints:
    """A named set of optional callables, fired as ``fn(**info)``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._fns: Dict[str, Callable] = {}

    def set(self, name: str, fn: Optional[Callable]) -> None:
        """Install (or, with ``fn=None``, remove) the hook for ``name``."""
        with self._lock:
            if fn is None:
                self._fns.pop(name, None)
            else:
                self._fns[name] = fn

    def clear(self, name: Optional[str] = None) -> None:
        """Remove one hook, or every hook when ``name`` is None."""
        with self._lock:
            if name is None:
                self._fns.clear()
            else:
                self._fns.pop(name, None)

    def fire(self, name: str, **info) -> None:
        """Invoke the hook for ``name`` if one is installed.

        Runs on the caller's thread, inside whatever critical section the
        call site sits in — that is the point: a parked hook holds the
        subsystem at exactly that lifecycle stage.  Exceptions propagate to
        the call site (the chaos tests SIGKILL from inside hooks, so they
        never return at all).
        """
        fn = self._fns.get(name)  # dict read: atomic under the GIL
        if fn is not None:
            fn(**info)


# The migration/assembly lifecycle points (reshard.py + shard_plane.py).
RESHARD_HOOKS = HookPoints()


__all__ = ["HookPoints", "RESHARD_HOOKS"]
