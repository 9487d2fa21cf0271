"""Self-tuning engine selection of the port (repro/tune): a measured cost
model and replay gating, with the JAX package's exports.

- `repro_torch.tune.calibrate` — sweep the engines the device's dispatch
  can choose (the kernel twins on CUDA, the plain engines on the CPU) over
  a design grid of (corpus, n, m, batch, Δ) through ``api.shortest_paths``
  + ``CostLog``; writes a versioned ``CALIBRATION_torch.json`` stamped
  with the device.
- `repro_torch.tune.model` — the JAX package's deterministic per-(engine,
  nprocs) log-space least-squares cost model, copied (numpy only).
- `repro_torch.tune.select` — ``TunedPolicy``, a drop-in
  ``DispatchPolicy`` for one device that returns the predicted-fastest
  engine *plus its statics* (Δ, bucket cap B), falling back to the
  thresholds outside calibrated support, and refusing a model measured on
  another backend.
- `repro_torch.tune.features` — cheap memoized topology features (degree
  skew, BFS hop eccentricity / frontier width).
- `repro_torch.tune.replay` — trace-replay perf regression gate: a
  recorded cost log re-run against the fitted model.

Selection never changes answers — every candidate engine is bitwise-
equal-to-serial; the model only moves wall time.
``repro_torch.benchmarks.tune_bench`` races the tuned policy against the
thresholds and records ``gate_tune`` in ``BENCH_torch_tune.json``.
"""
from repro_torch.tune.features import graph_features
from repro_torch.tune.model import (CostModel, EngineFit, fit_model,
                                    load_calibration, load_model)
from repro_torch.tune.replay import replay_records
from repro_torch.tune.select import TunedPolicy

__all__ = [
    "CostModel",
    "EngineFit",
    "TunedPolicy",
    "fit_model",
    "graph_features",
    "load_calibration",
    "load_model",
    "replay_records",
]
