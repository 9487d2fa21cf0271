"""Observability layer of the port (repro/obs): unified metrics,
solve-level tracing, cost records.

- `repro_torch.obs.metrics` — process-local counter/gauge/histogram
  registry with labeled series and a deterministic `snapshot()`
  contract; the serving components' `stats()` dicts are views over it.
- `repro_torch.obs.trace` — hierarchical spans (tick → batch_solve/
  p2p_solve/repair/stage/mutate) with Chrome-trace + JSONL export, an
  injected clock, and a no-op singleton when disabled.
- `repro_torch.obs.profile` — per-solve cost records
  ``(engine, statics, shape) → wall_ms, sweeps, edges``, each stamped
  with its solve's device, the training data for a measured cost model.
- `repro_torch.obs.validate` — schema + answer-chain validation for the
  exported artifacts (also a CLI).
- `repro_torch.obs.capture` — install/finalize helpers shared by the
  benches' ``--cost-out`` paths and chip_smoke.py.
"""
from .capture import cost_path_for, finalize_capture, install_capture
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    count_traces,
    default_registry,
    mark_trace,
    trace_count,
)
from .profile import (CostLog, CostRecord, NULL_COST_LOG, backend_info,
                      backend_name, get_cost_log, set_cost_log)
from .trace import NULL_TRACER, NullTracer, Span, Tracer, get_tracer, set_tracer

__all__ = [
    "cost_path_for",
    "finalize_capture",
    "install_capture",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "count_traces",
    "default_registry",
    "mark_trace",
    "trace_count",
    "backend_info",
    "backend_name",
    "CostLog",
    "CostRecord",
    "NULL_COST_LOG",
    "get_cost_log",
    "set_cost_log",
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "Tracer",
    "get_tracer",
    "set_tracer",
]
