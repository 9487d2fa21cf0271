"""Hierarchical solve-level tracing with Chrome-trace export (port of
repro/obs/trace.py, pure Python).

Span taxonomy (parent → child):

    tick ─┬─ mutate        graph mutation applied ahead of solves
          ├─ repair        incremental distance repair after a mutation
          ├─ stage         registry staging of device operands
          ├─ batch_solve   one multisource engine solve (args.qids)
          └─ p2p_solve     one target= early-exit solve (args.qids)

plus instant events ``submit`` (query admitted) and ``answer`` (answer
emitted), so an exact answer's chain submit → tick → solve → answer is
reconstructible from timestamps + qids alone (`obs.validate`).

Two hard requirements drive the shape:

- **Near-zero overhead when disabled.**  The default tracer is a
  module-level no-op singleton; hot-path call sites guard payload
  construction behind ``if tracer.enabled:`` and the no-op ``span()``
  returns one shared reusable context manager — no allocation, no
  clock read.
- **Deterministic under test.**  The clock is injected
  (``Tracer(clock=...)``), fault-plan style, so span ordering and
  durations are exact in tests.

A span opens and closes where its JAX twin does; none waits for the
device.  Spans around the port's entry points (which return numpy, so the
device work has ended) measure the device work; a span around a bare
engine call on CUDA tensors may close before its kernels finish.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "Span",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "get_tracer",
    "set_tracer",
]


class Span:
    """One closed or in-flight duration event."""

    __slots__ = ("name", "t0", "t1", "depth", "args")

    def __init__(self, name: str, t0: float, depth: int):
        self.name = name
        self.t0 = t0
        self.t1: Optional[float] = None
        self.depth = depth
        self.args: Dict[str, Any] = {}

    def set(self, **kwargs: Any) -> "Span":
        """Attach payload fields (engine, sweeps, edges_relaxed, ...)."""
        self.args.update(kwargs)
        return self

    @property
    def duration(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        # closed by the owning Tracer via _SpanCtx; nothing to do here
        return None


class _SpanCtx:
    """Context manager that closes its span on exit."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def set(self, **kwargs: Any) -> "_SpanCtx":
        self.span.set(**kwargs)
        return self

    def __enter__(self) -> "_SpanCtx":
        return self

    def __exit__(self, *exc) -> None:
        self._tracer._close(self.span)


class _NullSpanCtx:
    """Shared, reusable, allocation-free stand-in for a span."""

    __slots__ = ()
    span = None

    def set(self, **kwargs: Any) -> "_NullSpanCtx":
        return self

    def __enter__(self) -> "_NullSpanCtx":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpanCtx()


class Tracer:
    """Collects spans + instant events on an injected monotonic clock."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._stack: List[Span] = []
        self.spans: List[Span] = []
        self.instants: List[Dict[str, Any]] = []

    # -- recording ---------------------------------------------------------
    def span(self, name: str, **args: Any) -> _SpanCtx:
        s = Span(name, self._clock(), depth=len(self._stack))
        if args:
            s.args.update(args)
        self._stack.append(s)
        return _SpanCtx(self, s)

    def _close(self, span: Span) -> None:
        span.t1 = self._clock()
        # tolerate out-of-order exits rather than corrupt the stack
        if self._stack and self._stack[-1] is span:
            self._stack.pop()
        elif span in self._stack:
            self._stack.remove(span)
        self.spans.append(span)

    def instant(self, name: str, **args: Any) -> None:
        self.instants.append({"name": name, "ts": self._clock(), "args": args})

    # -- export ------------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (open in chrome://tracing or Perfetto)."""
        events: List[Dict[str, Any]] = []
        for s in self.spans:
            events.append(
                {
                    "ph": "X",
                    "name": s.name,
                    "ts": s.t0 * 1e6,
                    "dur": s.duration * 1e6,
                    "pid": 1,
                    "tid": 1,
                    "args": s.args,
                }
            )
        for ev in self.instants:
            events.append(
                {
                    "ph": "i",
                    "s": "t",
                    "name": ev["name"],
                    "ts": ev["ts"] * 1e6,
                    "pid": 1,
                    "tid": 1,
                    "args": ev["args"],
                }
            )
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    def write_jsonl(self, path: str) -> None:
        """One span/instant per line, in timestamp order."""
        rows: List[Dict[str, Any]] = []
        for s in self.spans:
            rows.append(
                {
                    "kind": "span",
                    "name": s.name,
                    "t0": s.t0,
                    "t1": s.t1,
                    "depth": s.depth,
                    "args": s.args,
                }
            )
        for ev in self.instants:
            rows.append({"kind": "instant", "name": ev["name"], "t0": ev["ts"], "args": ev["args"]})
        rows.sort(key=lambda r: r["t0"])
        with open(path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


class NullTracer:
    """Disabled tracer: every operation is a shared no-op."""

    enabled = False
    spans: List[Span] = []
    instants: List[Dict[str, Any]] = []

    def span(self, name: str, **args: Any) -> _NullSpanCtx:
        return _NULL_SPAN

    def instant(self, name: str, **args: Any) -> None:
        return None

    def to_chrome(self) -> Dict[str, Any]:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    def write_jsonl(self, path: str) -> None:
        open(path, "w").close()


NULL_TRACER = NullTracer()

_current: object = NULL_TRACER


def get_tracer():
    """The active tracer — NULL_TRACER unless a driver installed one."""
    return _current


def set_tracer(tracer) -> object:
    """Install ``tracer`` process-wide; returns the previous one."""
    global _current
    prev = _current
    _current = tracer if tracer is not None else NULL_TRACER
    return prev
