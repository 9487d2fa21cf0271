"""The serving layer of the port (repro/serve).  Only the churn sampler of
workload.py is here so far; the registry, scheduler, dispatch, landmarks,
cache, errors and faults come with the serving slice."""
from repro_torch.serve.workload import EdgeChurn

__all__ = ["EdgeChurn"]
