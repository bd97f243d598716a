"""The deterministic schedule harness of ``tests/_schedule.py``, bound to
the port's hook points (:data:`repro_torch.core.hooks.RESHARD_HOOKS`).

A test *traps* the hook points it wants to park the runtime at, spawns the
concurrent parties, and scripts the interleaving explicitly:

    with Schedule() as sched:
        sched.trap("hook_before_flip")
        sched.spawn(lambda: rb.execute(plan))
        sched.wait("hook_before_flip")   # migration parked pre-flip
        ...open a reader view here...
        sched.release("hook_before_flip")
        sched.join()

Every blocking primitive carries the schedule's timeout, and any failure
(a spawned thread raising, a timeout) aborts the whole schedule — traps
release and ``join`` re-raises — so a wrong schedule fails the test instead
of deadlocking the suite.  Imports no JAX.
"""

import threading

from repro_torch.core.hooks import RESHARD_HOOKS


class ScheduleTimeout(AssertionError):
    """A schedule primitive timed out — the forced interleaving is wrong."""


class Schedule:
    def __init__(self, timeout: float = 60.0, hooks=RESHARD_HOOKS):
        self.timeout = float(timeout)
        self.hooks = hooks
        self._traps = {}  # name -> (reached Event, release Event)
        self._threads = []
        self._errors = []
        self._lock = threading.Lock()

    def trap(self, name: str) -> None:
        """The next thread firing ``name`` parks until :meth:`release`; the
        trap re-arms on every firing."""
        reached, release = threading.Event(), threading.Event()
        self._traps[name] = (reached, release)

        def _hook(**info):
            reached.set()
            if not release.wait(self.timeout):
                raise ScheduleTimeout(f"trap {name!r} never released")

        self.hooks.set(name, _hook)

    def wait(self, name: str) -> None:
        """Block until a thread is parked at trap ``name``."""
        if not self._traps[name][0].wait(self.timeout):
            self._abort()
            raise ScheduleTimeout(f"trap {name!r} never reached")

    def release(self, name: str) -> None:
        """Unpark the thread at trap ``name`` (and any future arrivals)."""
        self._traps[name][1].set()

    def spawn(self, fn, *args) -> threading.Thread:
        """Run ``fn`` on a tracked thread; its exception aborts the schedule
        and re-raises at :meth:`join`."""

        def _run():
            try:
                fn(*args)
            except BaseException as exc:  # noqa: BLE001 - reported via join
                with self._lock:
                    self._errors.append(exc)
                self._abort()

        t = threading.Thread(target=_run, daemon=True)
        self._threads.append(t)
        t.start()
        return t

    def join(self) -> None:
        """Wait for every spawned thread; re-raise the first failure."""
        for t in self._threads:
            t.join(self.timeout)
            if t.is_alive():
                self._abort()
                raise ScheduleTimeout("spawned thread did not finish")
        if self._errors:
            raise self._errors[0]

    def _abort(self) -> None:
        for _, release in self._traps.values():
            release.set()

    def close(self) -> None:
        """Uninstall every trap hook and release anything still parked."""
        for name in self._traps:
            self.hooks.set(name, None)
        self._abort()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
