"""Unified telemetry plane: metrics, span tracing, and exporters.

The store's runtime signals — previously scattered over half a dozen
ad-hoc stat dicts (``StoreStats``, ``PipelineStats``, the assembler /
device-cache module counters, WAL and clock integers) — are unified on
three layers:

1. :mod:`repro_torch.obs.metrics` — thread-safe **counters**, **gauges**
   (direct or callback-backed), and **log2-bucketed latency histograms**
   (p50/p99/max) in a :class:`~repro_torch.obs.metrics.MetricsRegistry`.  The
   legacy stat surfaces are kept as backward-compatible *views* over
   registry counters: ``store.stats["commits"]``,
   ``view_assembler.stats.splices``, ``device_cache.stats.uploads`` and
   ``WritePipeline.stats.writes`` all still read exactly as before, but
   every increment now goes through one locked counter — no racy
   read-modify-write remains.
2. :mod:`repro_torch.obs.trace` — a fixed-size, lock-striped **span ring
   buffer**.  Spans cover the commit lifecycle (enqueue → route →
   prepare → wal_sync → link → publish → commit → reclaim), the read
   lifecycle (read → assemble → tier_repad → upload → kernel_dispatch)
   and compactor fold cycles, and carry the commit/view timestamp in
   their args — one write is traceable from submission to the first
   reader view that observes it.
3. :mod:`repro_torch.obs.export` — Prometheus text exposition
   (:func:`~repro_torch.obs.export.prometheus_text`), Chrome trace-event JSON
   loadable in Perfetto (:func:`~repro_torch.obs.export.chrome_trace` /
   ``write_chrome_trace``), and the human-readable
   ``RapidStore.telemetry_report()``.

Metric naming scheme
--------------------
``<subsystem>_<what>[_<unit>]`` with the subsystem one of ``store``,
``pipeline``, ``wal``, ``reader``, ``assembler``, ``device_cache``,
``compactor`` — e.g. ``store_commits``, ``pipeline_queue_depth`` (with a
``shard`` label), ``wal_backlog_bytes``, ``device_cache_hit_ratio``,
``store_memory_bytes`` (with a ``component`` label), and the latency
histograms ``read_latency_seconds`` / ``commit_visibility_seconds`` /
``wal_sync_seconds``.  Exporters prepend the ``rapidstore_`` namespace
(and a ``_total`` suffix for counters) so the exposition follows
Prometheus conventions while in-process names stay short.  Store-scoped
metrics live on the per-store ``store.registry``; process-wide surfaces
(the device cache, the view assembler, reader-slot exhaustion) live on
the module-global :data:`repro_torch.obs.metrics.REGISTRY`.

Overhead contract
-----------------
Counters that back the legacy stat surfaces are **always live** — they
cost what the old locked dicts cost (one uncontended lock per
increment) and tests rely on them unconditionally.  Everything *added*
by this plane — span recording and latency-histogram observation — is
**off by default** and gated behind ``REPRO_TELEMETRY=1`` (or
:func:`repro_torch.obs.trace.enable`); when disabled the hot-path cost is a
single attribute check (``TRACER.enabled``).  When enabled, a span
costs two ``perf_counter_ns`` calls, one tuple build and one striped
ring slot write; the tier-1 bound (asserted by
``benchmarks/bench_concurrent.py``) is reader p99 with telemetry on
≤ 1.1x telemetry off.  The span ring is fixed-size
(``REPRO_TELEMETRY_RING``, default 32768 spans): saturation overwrites
the oldest spans per stripe and never blocks or allocates unboundedly.
"""

from .metrics import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from .trace import TRACER, SpanRing, Tracer, enable, enabled
from .export import chrome_trace, prometheus_text, telemetry_report, write_chrome_trace

__all__ = [
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TRACER",
    "SpanRing",
    "Tracer",
    "enable",
    "enabled",
    "chrome_trace",
    "prometheus_text",
    "telemetry_report",
    "write_chrome_trace",
]
