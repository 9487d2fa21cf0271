"""Process-local metrics registry: counters, gauges, histograms (port of
repro/obs/metrics.py, the same series and the same ``snapshot()``).

One uniform namespace for every counter the serving stack keeps —
`DistanceCache`, `GraphRegistry`, and `MicroBatchScheduler` all hang
their counters off a `MetricsRegistry` and derive their legacy
``stats()`` dicts from `snapshot()`.

Design constraints:

- **Process-local, not global-only.**  Each component owns (or is
  handed) a registry instance, so two schedulers in one process never
  alias each other's counters.  A module-level `default_registry()`
  exists for process-wide series.
- **Deterministic snapshots.**  `snapshot()` returns a flat
  ``{qualified_name: number}`` dict in sorted-key order containing
  only event counts and set gauges — no wall-clock values — so two
  same-seed replays produce byte-identical snapshots (the chaos
  determinism test relies on this).
- **Cheap increments.**  `Counter.inc` is one int add; the serving hot
  path calls it unconditionally, so it must stay trivial.

Series are keyed on ``(name, sorted(labels))``; the qualified name
renders as ``name{k=v,...}``.

``mark_trace`` / ``count_traces`` / ``trace_count`` keep the JAX package's
retrace-counter API so that ported callers read the same, but nothing in
the port calls them: eager PyTorch traces nothing, so the
``jit.retrace`` series stays empty.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "mark_trace",
    "count_traces",
]


def _qualify(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing event count."""

    __slots__ = ("name", "labels", "_value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._value = 0

    def inc(self, k: int = 1) -> None:
        self._value += k

    @property
    def value(self) -> int:
        return self._value

    def reset(self) -> None:
        self._value = 0


class Gauge:
    """Point-in-time value: either set explicitly or computed at
    snapshot time via a callback (``fn=``)."""

    __slots__ = ("name", "labels", "_value", "_fn")

    def __init__(
        self,
        name: str,
        labels: Tuple[Tuple[str, str], ...] = (),
        fn: Optional[Callable[[], float]] = None,
    ):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        self._value = float(v)

    def add(self, v: float) -> None:
        self._value += float(v)

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        return self._value


class Histogram:
    """Streaming distribution summary.

    Keeps every observation (serving runs are bounded, and the latency
    recorder needs exact p50/p99), exposing count/sum/min/max and
    percentile helpers.  `snapshot()` reports only the count — the
    observed values themselves are typically wall-times and would break
    snapshot determinism.
    """

    __slots__ = ("name", "labels", "_values")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._values: list = []

    def observe(self, v: float) -> None:
        self._values.append(float(v))

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def sum(self) -> float:
        return float(sum(self._values))

    @property
    def min(self) -> float:
        return min(self._values) if self._values else 0.0

    @property
    def max(self) -> float:
        return max(self._values) if self._values else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over everything observed so far."""
        if not self._values:
            return 0.0
        xs = sorted(self._values)
        idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
        return xs[idx]

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50.0),
            "p99": self.percentile(99.0),
        }


class MetricsRegistry:
    """Get-or-create store of named, labeled series."""

    def __init__(self) -> None:
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}

    def _key(self, name: str, labels: Dict[str, str]) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
        return (name, tuple(sorted((str(k), str(v)) for k, v in labels.items())))

    def counter(self, name: str, **labels: str) -> Counter:
        key = self._key(name, labels)
        s = self._series.get(key)
        if s is None:
            s = Counter(name, key[1])
            self._series[key] = s
        elif not isinstance(s, Counter):
            raise TypeError(f"series {name!r} already registered as {type(s).__name__}")
        return s

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None, **labels: str) -> Gauge:
        key = self._key(name, labels)
        s = self._series.get(key)
        if s is None:
            s = Gauge(name, key[1], fn=fn)
            self._series[key] = s
        elif not isinstance(s, Gauge):
            raise TypeError(f"series {name!r} already registered as {type(s).__name__}")
        return s

    def histogram(self, name: str, **labels: str) -> Histogram:
        key = self._key(name, labels)
        s = self._series.get(key)
        if s is None:
            s = Histogram(name, key[1])
            self._series[key] = s
        elif not isinstance(s, Histogram):
            raise TypeError(f"series {name!r} already registered as {type(s).__name__}")
        return s

    def series(self) -> Iterator[object]:
        return iter(self._series.values())

    def find(self, name: str) -> list:
        """Every series registered under ``name`` (any label set)."""
        return [s for (n, _), s in self._series.items() if n == name]

    def snapshot(self) -> Dict[str, float]:
        """Flat, sorted, deterministic view of every series.

        Counters report their count, gauges their current value,
        histograms their observation count (values may be wall-times
        and are deliberately excluded — see class docstring).
        """
        out: Dict[str, float] = {}
        for (name, labels), s in self._series.items():
            q = _qualify(name, labels)
            if isinstance(s, Counter):
                out[q] = s.value
            elif isinstance(s, Gauge):
                out[q] = s.value
            elif isinstance(s, Histogram):
                out[q + ".count"] = s.count
        return dict(sorted(out.items()))

    def reset(self) -> None:
        for s in self._series.values():
            if isinstance(s, Counter):
                s.reset()
            elif isinstance(s, Gauge):
                if s._fn is None:
                    s.set(0.0)
            elif isinstance(s, Histogram):
                s._values.clear()


_DEFAULT: MetricsRegistry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry, for series whose natural scope is the
    process rather than a component instance (``jit.retrace{fn=...}``)."""
    return _DEFAULT


def mark_trace(fn_name: str) -> None:
    """Record one trace of ``fn_name`` in ``jit.retrace{fn=...}``.  In the
    JAX package jitted bodies call it while they are traced; no code of the
    port does, since eager PyTorch has no trace to count."""
    _DEFAULT.counter("jit.retrace", fn=fn_name).inc()


def trace_count(fn_name: str) -> int:
    """How many times ``fn_name`` has been marked so far."""
    return _DEFAULT.counter("jit.retrace", fn=fn_name).value


def count_traces(fn_name: str) -> Callable:
    """Wrap a callable so each call marks one trace of ``fn_name`` (the JAX
    package's decorator for to-be-jitted functions; unused in the port)."""

    def deco(fn: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            mark_trace(fn_name)
            return fn(*args, **kwargs)

        wrapper.__name__ = getattr(fn, "__name__", fn_name)
        wrapper.__qualname__ = wrapper.__name__
        wrapper.__wrapped__ = fn
        return wrapper

    return deco
