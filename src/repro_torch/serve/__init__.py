"""SSSP query-serving subsystem of the port (repro/serve): registry ->
scheduler -> engines -> cache.

``GraphRegistry`` admits named graphs under a byte budget and stages their
operands once on its device; ``MicroBatchScheduler`` coalesces
deduplicated sources into bucket-padded ``multisource_csr`` solves and
point-to-point residues into ``target=`` frontier solves (the
``frontier_relax`` kernel on a CUDA device); ``DistanceCache`` answers hot
sources from solved rows; ``dispatch`` is the engine-selection seam,
which on a CUDA device names each engine's kernel twin; ``landmarks``
precomputes ALT bounds per graph; ``workload`` generates the synthetic
open-loop traces a driver replays; ``errors`` is the typed failure
taxonomy every ``Answer.status`` draws from and ``faults`` the seeded
chaos-injection plans the scheduler probes.
"""
from repro_torch.serve.cache import DistanceCache
from repro_torch.serve.dispatch import (DispatchPolicy, EngineChoice,
                                        default_policy, policy_override,
                                        set_default_policy)
from repro_torch.serve.errors import (STATUS_OK, STATUSES, DeadlineExceeded,
                                      GraphGone, NotConverged, QueryRejected,
                                      SchedulerStalled, ServeError,
                                      SolveFailed)
from repro_torch.serve.faults import (SITES, FaultPlan, FaultRecord,
                                      InjectedFault)
from repro_torch.serve.landmarks import LandmarkSet, build_landmarks
from repro_torch.serve.registry import GraphHandle, GraphRegistry
from repro_torch.serve.scheduler import (Answer, MicroBatchScheduler,
                                         Mutation, Query)
from repro_torch.serve.workload import (SCENARIOS, EdgeChurn,
                                        LatencyRecorder, MutationEvent,
                                        TraceEvent, make_churn_trace,
                                        make_trace)

__all__ = [
    "Answer",
    "DeadlineExceeded",
    "DispatchPolicy",
    "DistanceCache",
    "EdgeChurn",
    "EngineChoice",
    "FaultPlan",
    "FaultRecord",
    "GraphGone",
    "GraphHandle",
    "GraphRegistry",
    "InjectedFault",
    "LandmarkSet",
    "LatencyRecorder",
    "MicroBatchScheduler",
    "Mutation",
    "MutationEvent",
    "NotConverged",
    "Query",
    "QueryRejected",
    "SCENARIOS",
    "SITES",
    "STATUSES",
    "STATUS_OK",
    "SchedulerStalled",
    "ServeError",
    "SolveFailed",
    "TraceEvent",
    "build_landmarks",
    "default_policy",
    "policy_override",
    "make_churn_trace",
    "make_trace",
    "set_default_policy",
]
