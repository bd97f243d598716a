"""What a traced run reads: the device's activity from ``torch.profiler``,
the program's spans and counters, and the breakdown of the window.

The profiler records the card's activity alone (CUDA activity, no host
operators), from the window's start until every query issued in it has
finished, so each kernel launch in the trace belongs to a whole call.
Host times are ``time.perf_counter_ns``; device events are placed on
that clock from the profiler's own start, to within the latency of
starting it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class Trace:
    """One traced window, as the per-layer readers see it."""

    window_s: float
    busy_s: float
    device_events: List[Tuple[str, float, float]]  # (name, start ns, end ns), host clock
    spans: List[Tuple[str, float, dict]]  # the program's spans: (name, seconds, args)
    counters: Dict[str, float]  # growth of each program counter over the window
    tile_groups: List[dict] = field(default_factory=list)  # see yardstick.kernel_bound_s
    d: int = 0  # SpMM's width
    # the least seconds of each launch of a kernel, by kernel name, from the
    # operands the window's queries sent (a query kind file's ``bounds``)
    bounds: Dict[str, List[float]] = field(default_factory=dict)

    def durations(self, match: str) -> List[float]:
        """Seconds of each device event whose name holds ``match``."""
        return [(e - s) / 1e9 for name, s, e in self.device_events if match in name]

    def span_seconds(self, name: str) -> List[float]:
        return [sec for n, sec, _args in self.spans if n == name]


class DeviceProfile:
    """``torch.profiler`` over the card's activity for one window."""

    def __init__(self, device) -> None:
        from torch.profiler import ProfilerActivity

        self.on_card = device.type == "cuda"
        self.activities = [ProfilerActivity.CUDA] if self.on_card else [ProfilerActivity.CPU]
        self.prof = None
        self.t_start_ns = self.t_stop_ns = 0

    def warm(self, fn) -> None:
        """One short session around ``fn()``: the profiler's first use
        (tens of seconds on the card) belongs to set-up."""
        from torch.profiler import profile

        with profile(activities=self.activities):
            fn()

    def start(self) -> None:
        from torch.profiler import profile

        self.prof = profile(activities=self.activities)
        self.prof.start()
        self.t_start_ns = time.perf_counter_ns()

    def stop(self) -> None:
        self.t_stop_ns = time.perf_counter_ns()  # the window, not the flush that follows
        self.prof.stop()

    def events(self) -> List[Tuple[str, float, float]]:
        """The card's events, ``(name, start ns, end ns)`` on the host clock
        (none off the card)."""
        if not self.on_card:
            return []
        from torch.autograd import DeviceType

        res = self.prof.profiler.kineto_results
        t0 = res.trace_start_ns()
        raw = [(e.name(), e.start_ns() - t0, e.end_ns() - t0) for e in res.events()
               if e.device_type() == DeviceType.CUDA]
        base = self.t_start_ns
        return [(name, base + s, base + e) for name, s, e in raw]


def merged(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``intervals`` as sorted, disjoint ones."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_ns(events, lo: float, hi: float) -> float:
    """Nanoseconds of [lo, hi] in which some device event ran."""
    clipped = [(max(s, lo), min(e, hi)) for _n, s, e in events if e > lo and s < hi]
    return sum(e - s for s, e in merged(clipped))


def top_ops(events, k: int = 10) -> List[list]:
    """The ``k`` device operations (by name) that took most time."""
    total: Dict[str, float] = {}
    for name, s, e in events:
        total[name] = total.get(name, 0.0) + (e - s) / 1e9
    return [[n[:200], sec] for n, sec in sorted(total.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(events, lo: float, hi: float, host: Sequence[Tuple[str, float, float]],
              k: int = 10) -> List[list]:
    """The ``k`` longest stretches of [lo, hi] with no device activity,
    each named by what the host was doing at its middle (the harness's
    queries and writes and the program's spans that were open), with its
    seconds."""
    busy = merged([(max(s, lo), min(e, hi)) for _n, s, e in events if e > lo and s < hi])
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
        mid = (s + e) / 2
        doing = sorted({name for name, hs, he in host if hs <= mid <= he})
        where = f" @{(s - lo) / 1e9:.3f}s"
        out.append([("host: " + "+".join(doing) if doing else "host: nothing open")[:180]
                    + where, (e - s) / 1e9])
    return out


def counter_values(registries) -> Dict[str, float]:
    """Every unlabelled counter of the program's registries, by name."""
    from repro_torch.obs.metrics import Counter

    out: Dict[str, float] = {}
    for reg in registries:
        for m in reg.collect():
            if isinstance(m, Counter) and not m.labels:
                out[m.name] = float(m.value)
    return out


def delta(after: Dict[str, float], before: Dict[str, float]) -> Dict[str, float]:
    return {k: v - before.get(k, 0.0) for k, v in after.items()}


def window_spans(lo_ns: float, hi_ns: float) -> List[Tuple[str, float, float, dict]]:
    """The program's spans (``repro_torch.obs.trace``) that started in
    [lo, hi]: (name, start ns, end ns, args)."""
    from repro_torch.obs.trace import TRACER

    return [(sp.name, sp.start_ns, sp.start_ns + sp.dur_ns, sp.args or {})
            for sp in TRACER.spans() if lo_ns <= sp.start_ns <= hi_ns]


def label(name: str, args: Optional[dict]) -> str:
    kind = (args or {}).get("kind")
    return f"{name}:{kind}" if kind else name
