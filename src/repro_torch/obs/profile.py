"""Per-solve cost records — the training data for a measured cost model
(port of repro/obs/profile.py: the same fields and schema).

Every engine solve (batched multisource, p2p early-exit, API-level
single source, dynamic repair) can emit one `CostRecord` mapping the
*decision inputs* an engine selector would see —
``(engine, n, m, batch, nprocs, delta)`` — to the *measured outcome*
``(sweeps, edges_relaxed, wall_ms, converged)``.  ROADMAP item 4's
self-tuning dispatch fits its cost model on exactly these rows.

Emission follows the tracer pattern: a module-level no-op `CostLog`
singleton, replaced by the drivers and benches when they capture.
`emit()` on the null log is a constant-time early return, so
instrumented call sites cost nothing in normal runs.

In the port the device is an argument of each solve, not a property of
the process, so every record names the device of its own solve:
``backend_info(device)`` gives ``("gpu", <card name>)`` for a CUDA device
(``"gpu"`` is JAX's backend label for an NVIDIA card) and ``("cpu",
"cpu")`` for the CPU, and every emitter passes both fields.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import Any, Dict, List, Optional

__all__ = [
    "CostRecord",
    "CostLog",
    "NULL_COST_LOG",
    "backend_info",
    "backend_name",
    "get_cost_log",
    "set_cost_log",
]

# schema v1: the decision/outcome fields every record must carry.
COST_RECORD_FIELDS_V1 = (
    "engine",
    "graph",
    "n",
    "m",
    "batch",
    "nprocs",
    "delta",
    "sweeps",
    "edges_relaxed",
    "wall_ms",
    "converged",
)

# schema v2 adds the hardware identity: a cost model fitted on one
# backend is meaningless on another (the paper's MPI/CUDA crossover
# moves with the hardware), so records name where they were measured.
# obs/validate.py accepts both versions; new emitters always write v2.
COST_RECORD_FIELDS_V2_EXTRA = ("backend", "device_kind")
COST_RECORD_FIELDS = COST_RECORD_FIELDS_V1 + COST_RECORD_FIELDS_V2_EXTRA
COST_RECORD_SCHEMA = 2

@functools.lru_cache(maxsize=None)
def _cuda_name(index: int) -> str:
    import torch

    return str(torch.cuda.get_device_name(index))


def backend_name(device) -> str:
    """The backend label of ``device`` (a ``torch.device`` or its name):
    ``"gpu"`` for a CUDA device, ``"cpu"`` for the CPU.  Reads nothing off
    the device."""
    import torch

    kind = torch.device(device).type
    if kind == "cuda":
        return "gpu"
    if kind == "cpu":
        return "cpu"
    raise ValueError(f"unsupported device type {kind!r}")


def backend_info(device) -> tuple:
    """``(backend, device_kind)`` of ``device`` (a ``torch.device`` or its
    name): ``("gpu", "NVIDIA H100 80GB HBM3")`` for a CUDA device, ``("cpu",
    "cpu")`` for the CPU.  The card's name is read once per index."""
    import torch

    backend = backend_name(device)
    dev = torch.device(device)
    if dev.type == "cuda":
        index = (dev.index if dev.index is not None
                 else torch.cuda.current_device())
        return (backend, _cuda_name(index))
    return (backend, "cpu")


@dataclasses.dataclass(frozen=True)
class CostRecord:
    """One solve: decision inputs → measured outcome."""

    engine: str          # which engine ran (bellman_csr, frontier, ...)
    graph: str           # registry graph name, or "" outside serving
    n: int               # vertex count
    m: int               # edge count
    batch: int           # padded multisource bucket size (1 for p2p/single)
    nprocs: int          # mesh size for sharded solves, else 1
    delta: float         # Δ-stepping bucket width, 0.0 when not applicable
    sweeps: int          # relaxation sweeps / bucket phases executed
    edges_relaxed: int   # total edge relaxations performed
    wall_ms: float       # host wall-clock for the solve, ms
    converged: bool      # fixpoint reached within the sweep cap
    backend: str = ""    # "gpu" or "cpu": the solve's device (v2)
    device_kind: str = ""  # the card's name, or "cpu" (v2)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class CostLog:
    """Append-only in-memory cost-record sink with a JSONL exporter."""

    enabled = True

    def __init__(self) -> None:
        self.records: List[CostRecord] = []

    def emit(
        self,
        *,
        engine: str,
        n: int,
        m: int,
        sweeps: int,
        edges_relaxed: int,
        wall_ms: float,
        converged: bool,
        graph: str = "",
        batch: int = 1,
        nprocs: int = 1,
        delta: float = 0.0,
        backend: str = "",
        device_kind: str = "",
    ) -> None:
        if not backend or not device_kind:
            # v2 names the measuring hardware so fitted models can refuse
            # records from another backend; the port has no process-wide
            # backend to fall back on.
            raise ValueError(
                "a cost record names its solve's device: pass backend= and "
                "device_kind= (obs.profile.backend_info(device))")
        self.records.append(
            CostRecord(
                engine=str(engine),
                graph=str(graph),
                n=int(n),
                m=int(m),
                batch=int(batch),
                nprocs=int(nprocs),
                delta=float(delta),
                sweeps=int(sweeps),
                edges_relaxed=int(edges_relaxed),
                wall_ms=float(wall_ms),
                converged=bool(converged),
                backend=str(backend),
                device_kind=str(device_kind),
            )
        )

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r.to_dict()) + "\n")

    def clear(self) -> None:
        self.records.clear()


class _NullCostLog(CostLog):
    """Disabled sink: emit() drops the record before building it."""

    enabled = False

    def __init__(self) -> None:
        self.records = []

    def emit(self, **kwargs: Any) -> None:  # noqa: D102 - no-op
        return None


NULL_COST_LOG = _NullCostLog()

_current: CostLog = NULL_COST_LOG


def get_cost_log() -> CostLog:
    return _current


def set_cost_log(log: Optional[CostLog]) -> CostLog:
    """Install ``log`` process-wide; returns the previous one."""
    global _current
    prev = _current
    _current = log if log is not None else NULL_COST_LOG
    return prev
