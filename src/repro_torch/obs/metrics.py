"""Thread-safe metrics: counters, gauges, log2-bucketed histograms.

Design constraints (see the package docstring for the full contract):

- **Counters** are the backing store for every legacy stat surface
  (``StoreStats``, ``PipelineStats``, assembler / device-cache module
  stats), so an increment must be exactly as cheap as the old locked
  dicts: one uncontended ``threading.Lock`` per :meth:`Counter.add`.
  The optional ``mirror`` callback — invoked *under* the counter's lock
  with the new value — is how ``StoreStats`` keeps its plain-dict reads
  exact under concurrent increments.
- **Gauges** are either set directly or callback-backed (``fn=``);
  callback gauges evaluate lazily at read/export time, which is how the
  derived health signals (reader-horizon lag, per-shard queue depth,
  WAL backlog, memory breakdown, cache hit ratio) stay free on the hot
  path.  :meth:`Gauge.set_max` gives the high-watermark semantics the
  pipeline's ``max_batch`` / ``max_publish_run`` need.
- **Histograms** bucket by powers of two of nanoseconds: bucket ``i``
  counts observations in ``(2^(i-1), 2^i]`` ns, so a reported
  percentile ``q`` satisfies ``true_q <= reported <= 2 * true_q``
  (relative error bounded by the bucket base).  ``sum`` and ``max`` are
  tracked exactly.

Registries are cheap objects: each :class:`RapidStore` owns one
(``store.registry``) and the process-wide surfaces share the module
default :data:`REGISTRY`.  Metric identity is ``(name, sorted labels)``;
re-requesting an existing metric returns the same object (lock-free on
the hit path), so module reloads and repeated attach/detach cycles never
double-register.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

_NS_PER_S = 1_000_000_000


class Counter:
    """Monotone locked counter.  ``value`` reads are plain (single int)."""

    __slots__ = ("name", "labels", "_value", "_lock", "mirror")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()) -> None:
        self.name = name
        self.labels = labels
        self._value = 0
        self._lock = threading.Lock()
        # called under the lock with the post-increment value (StoreStats
        # uses this to keep its dict view exact; see module docstring)
        self.mirror: Optional[Callable[[int], None]] = None

    def add(self, delta: int = 1) -> int:
        with self._lock:
            self._value += delta
            v = self._value
            m = self.mirror
            if m is not None:
                m(v)
            return v

    inc = add

    @property
    def value(self) -> int:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0
            m = self.mirror
            if m is not None:
                m(0)


class Gauge:
    """Point-in-time value: set directly, via ``set_max``, or callback-backed."""

    __slots__ = ("name", "labels", "_value", "_fn", "_lock")

    def __init__(
        self,
        name: str,
        labels: Tuple[Tuple[str, str], ...] = (),
        fn: Optional[Callable[[], float]] = None,
    ) -> None:
        self.name = name
        self.labels = labels
        self._value: float = 0
        self._fn = fn
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    def set_max(self, value: float) -> None:
        """High-watermark update (the pipeline's ``max_batch`` semantics)."""
        with self._lock:
            if value > self._value:
                self._value = value

    def set_fn(self, fn: Optional[Callable[[], float]]) -> None:
        self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            return fn()
        return self._value


class Histogram:
    """Log2-bucketed latency histogram (see module docstring for bounds).

    Observations are in **seconds**; bucket ``i`` counts values in
    ``(2^(i-1), 2^i]`` nanoseconds (sub-ns observations land in bucket
    0).  64 buckets cover ~584 years, so no observation overflows.
    """

    N_BUCKETS = 64

    __slots__ = ("name", "labels", "_counts", "_count", "_sum", "_max", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()) -> None:
        self.name = name
        self.labels = labels
        self._counts = [0] * self.N_BUCKETS
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        ns = int(seconds * _NS_PER_S)
        # (2^(i-1), 2^i] bucketing: idx = bit_length(ns - 1), clamped
        idx = (ns - 1).bit_length() if ns > 1 else 0
        if idx >= self.N_BUCKETS:  # pragma: no cover - ~584 years
            idx = self.N_BUCKETS - 1
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += seconds
            if seconds > self._max:
                self._max = seconds

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def max(self) -> float:
        return self._max

    def percentile(self, q: float) -> float:
        """Upper bound (seconds) of the bucket holding the ``q``-th percentile.

        The sample at rank ``ceil(q/100 * count)`` lies in the returned
        bucket, so ``sample <= percentile(q) < 2 * sample``.  0.0 when
        empty.
        """
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            rank = max(1, -(-int(total * q) // 100))  # ceil(q/100 * total)
            acc = 0
            for i, c in enumerate(self._counts):
                acc += c
                if acc >= rank:
                    return float(1 << i) / _NS_PER_S
        return self._max  # pragma: no cover - unreachable

    def p50(self) -> float:
        return self.percentile(50)

    def p99(self) -> float:
        return self.percentile(99)

    def buckets(self) -> List[Tuple[float, int]]:
        """Non-empty ``(upper_bound_seconds, cumulative_count)`` pairs."""
        out: List[Tuple[float, int]] = []
        with self._lock:
            acc = 0
            for i, c in enumerate(self._counts):
                acc += c
                if c:
                    out.append((float(1 << i) / _NS_PER_S, acc))
        return out

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * self.N_BUCKETS
            self._count = 0
            self._sum = 0.0
            self._max = 0.0


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Name+labels -> metric map; creation is locked, lookup is lock-free."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}

    def _get_or_create(self, cls, name: str, labels: Dict[str, str], **kw):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)  # dict read: atomic under the GIL
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, key[1], **kw)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r}{dict(key[1])} is {type(m).__name__}, "
                f"requested {cls.__name__}"
            )
        return m

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(
        self, name: str, fn: Optional[Callable[[], float]] = None, **labels: str
    ) -> Gauge:
        g = self._get_or_create(Gauge, name, labels)
        if fn is not None:
            g.set_fn(fn)
        return g

    def histogram(self, name: str, **labels: str) -> Histogram:
        return self._get_or_create(Histogram, name, labels)

    def unregister(self, name: str, **labels: str) -> None:
        with self._lock:
            self._metrics.pop((name, _label_key(labels)), None)

    def collect(self) -> List[object]:
        """Stable-ordered snapshot of all registered metrics."""
        with self._lock:
            items = list(self._metrics.items())
        return [m for _, m in sorted(items, key=lambda kv: kv[0])]


# Process-wide default registry: the device cache, the view assembler, and
# reader-slot exhaustion live here; per-store metrics live on store.registry.
REGISTRY = MetricsRegistry()


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
]
