"""Exporters: Prometheus text, Chrome/Perfetto trace JSON, human report.

Three consumers of the same telemetry plane:

- :func:`prometheus_text` renders one or more registries in the
  Prometheus text exposition format (counters get the conventional
  ``_total`` suffix, histograms render cumulative ``le`` buckets +
  ``_sum`` / ``_count``); every name is prefixed ``rapidstore_``.
- :func:`chrome_trace` / :func:`write_chrome_trace` dump the span ring
  as Chrome trace-event JSON (``ph: "X"`` complete events,
  microsecond timestamps) — load the file in Perfetto
  (https://ui.perfetto.dev) or ``chrome://tracing``.  Span ``ts``
  (commit/view timestamp) and args (``id``, ``parent``, ``read``) ride
  along in ``args``.  ``clock="profiler"`` writes them on the clock of
  ``torch.profiler``'s events; ``write_chrome_trace(path, beside=f)``
  writes the spans into a copy of ``prof.export_chrome_trace(f)``'s file,
  so one Perfetto timeline shows a span over the kernels it launched.
- :func:`telemetry_report` is the human-readable store summary behind
  ``RapidStore.telemetry_report()``: counters, evaluated derived
  gauges, histogram p50/p99/max, and span counts.
"""

from __future__ import annotations

import json
import re
from typing import Iterable, List

from .metrics import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from .trace import TRACER, Tracer, clock_anchor

_PREFIX = "rapidstore_"
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _PREFIX + _NAME_RE.sub("_", name)


def _prom_labels(labels, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v) -> str:
    if isinstance(v, float):
        if v != v:  # NaN
            return "NaN"
        return repr(v)
    return str(v)


def prometheus_text(*registries: MetricsRegistry) -> str:
    """Render registries (default: the global one) as Prometheus text."""
    if not registries:
        registries = (REGISTRY,)
    lines: List[str] = []
    typed = set()

    def _type_line(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for reg in registries:
        for m in reg.collect():
            if isinstance(m, Counter):
                name = _prom_name(m.name) + "_total"
                _type_line(name, "counter")
                lines.append(f"{name}{_prom_labels(m.labels)} {m.value}")
            elif isinstance(m, Gauge):
                name = _prom_name(m.name)
                _type_line(name, "gauge")
                lines.append(f"{name}{_prom_labels(m.labels)} {_fmt(m.value)}")
            elif isinstance(m, Histogram):
                name = _prom_name(m.name)
                _type_line(name, "histogram")
                for le, cum in m.buckets():
                    le_label = 'le="%s"' % _fmt(le)
                    lines.append(
                        f"{name}_bucket{_prom_labels(m.labels, le_label)} {cum}"
                    )
                inf_label = 'le="+Inf"'
                lines.append(
                    f"{name}_bucket{_prom_labels(m.labels, inf_label)} {m.count}"
                )
                lines.append(f"{name}_sum{_prom_labels(m.labels)} {_fmt(m.sum)}")
                lines.append(f"{name}_count{_prom_labels(m.labels)} {m.count}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Chrome trace-event JSON (Perfetto-loadable)
# ---------------------------------------------------------------------------
def chrome_trace(tracer: Tracer = TRACER, clock: str = "host", base_ns: int = 0) -> dict:
    """The span ring as a Chrome trace-event dict (``json.dump``-ready).

    ``clock="host"``: timestamps are ``perf_counter`` microseconds.
    ``clock="profiler"``: each span start ``s`` (perf ns) is written as
    ``(s + profiler_ns - perf_ns - base_ns) / 1000`` us, with ``(perf_ns,
    profiler_ns)`` read by :func:`clock_anchor` now and
    ``base_ns`` the ``baseTimeNanoseconds`` that the profiler's own export
    subtracts from its events (written into the dict when not 0)."""
    if clock == "host":
        shift = 0
    elif clock == "profiler":
        perf_ns, prof_ns = clock_anchor()
        shift = prof_ns - perf_ns - int(base_ns)
    else:
        raise ValueError(f"clock must be 'host' or 'profiler', not {clock!r}")
    events = []
    for sp in tracer.spans():
        args = dict(sp.args) if sp.args else {}
        if sp.ts >= 0:
            args["ts"] = sp.ts
        events.append(
            {
                "name": sp.name,
                "cat": sp.cat,
                "ph": "X",
                "ts": (sp.start_ns + shift) / 1e3,  # trace-event timestamps are us
                "dur": sp.dur_ns / 1e3,
                "pid": 1,
                "tid": sp.tid % (1 << 31),  # Perfetto wants an int32
                "args": args,
            }
        )
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if clock == "profiler" and base_ns:
        out["baseTimeNanoseconds"] = int(base_ns)
    return out


def write_chrome_trace(path, tracer: Tracer = TRACER, beside=None) -> str:
    """Dump :func:`chrome_trace` to ``path``; returns the path.

    ``beside`` names a file that ``prof.export_chrome_trace`` wrote: its
    events are copied to ``path`` with the spans added on the profiler's
    clock and its ``baseTimeNanoseconds``."""
    if beside is None:
        out = chrome_trace(tracer)
    else:
        with open(beside) as f:
            out = json.load(f)
        base = int(out.get("baseTimeNanoseconds", 0))
        out["traceEvents"] = list(out.get("traceEvents", [])) + chrome_trace(
            tracer, clock="profiler", base_ns=base)["traceEvents"]
    with open(path, "w") as f:
        json.dump(out, f)
    return str(path)


# ---------------------------------------------------------------------------
# Human-readable report
# ---------------------------------------------------------------------------
def _metric_lines(reg: MetricsRegistry) -> Iterable[str]:
    for m in reg.collect():
        label = f"{m.name}{dict(m.labels) if m.labels else ''}"
        if isinstance(m, Counter):
            yield f"  {label:<44} {m.value}"
        elif isinstance(m, Gauge):
            try:
                v = m.value
            except Exception as exc:  # a callback gauge may outlive its source
                v = f"<error: {exc}>"
            yield f"  {label:<44} {_fmt(v) if not isinstance(v, str) else v}"
        elif isinstance(m, Histogram):
            if m.count:
                yield (
                    f"  {label:<44} n={m.count} p50={m.p50() * 1e3:.3f}ms "
                    f"p99={m.p99() * 1e3:.3f}ms max={m.max * 1e3:.3f}ms"
                )
            else:
                yield f"  {label:<44} n=0"


def telemetry_report(store, tracer: Tracer = TRACER) -> str:
    """Human-readable snapshot of one store's telemetry (+ global plane)."""
    lines = [f"== telemetry: store @ t_r={store.clock.read_timestamp()} =="]
    lines.append("-- store metrics --")
    lines.extend(_metric_lines(store.registry))
    lines.append("-- process metrics --")
    lines.extend(_metric_lines(REGISTRY))
    lines.append("-- spans --")
    if tracer.enabled or tracer.ring.recorded():
        counts = tracer.counts()
        for name in sorted(counts):
            lines.append(f"  {name:<44} {counts[name]}")
        lines.append(
            f"  ring: {len(tracer.spans())} retained / "
            f"{tracer.ring.recorded()} recorded "
            f"({tracer.ring.dropped()} dropped)"
        )
    else:
        lines.append("  (tracing disabled: set REPRO_TELEMETRY=1 or obs.enable())")
    return "\n".join(lines)


__all__ = [
    "chrome_trace",
    "prometheus_text",
    "telemetry_report",
    "write_chrome_trace",
]
