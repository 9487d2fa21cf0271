"""Driver-side capture helpers (port of repro/obs/capture.py): install the
process-wide tracer + cost log, and write/validate their outputs at end of
run.

Capturing drivers and benches follow the JAX package's ``--trace-out
PATH`` contract:

- the Chrome trace JSON is written to ``PATH``
  (open in chrome://tracing or Perfetto),
- the per-solve cost records go to ``splitext(PATH)[0] + ".cost.jsonl"``,
- both artifacts are schema-validated in-process (obs/validate) and the
  driver exits nonzero on an invalid capture; ``python -m
  repro_torch.obs.validate TRACE.json COSTS.jsonl`` checks them again.
"""
from __future__ import annotations

import os.path
from typing import Callable, List, Optional, Tuple

from repro_torch.obs.profile import CostLog, set_cost_log
from repro_torch.obs.trace import Tracer, set_tracer

__all__ = ["cost_path_for", "install_capture", "finalize_capture"]


def cost_path_for(trace_path: str) -> str:
    """Cost-record JSONL path derived from the Chrome-trace path."""
    return os.path.splitext(trace_path)[0] + ".cost.jsonl"


def install_capture(
    clock: Optional[Callable[[], float]] = None,
) -> Tuple[Tracer, CostLog]:
    """Create and install a live Tracer + CostLog process-wide."""
    tr = Tracer() if clock is None else Tracer(clock=clock)
    cl = CostLog()
    set_tracer(tr)
    set_cost_log(cl)
    return tr, cl


def finalize_capture(
    tr: Tracer,
    cl: CostLog,
    trace_path: str,
    *,
    validate: bool = True,
    check_chains: bool = True,
) -> List[str]:
    """Write both artifacts; return validation errors (empty = valid).

    ``check_chains=False`` skips the answer-chain reconstruction for
    captures that never ran the serving scheduler (pure benchmark
    solves emit no submit/tick/answer events, which is not an error).
    """
    tr.write_chrome(trace_path)
    cl.write_jsonl(cost_path_for(trace_path))
    if not validate:
        return []
    from repro_torch.obs.validate import (reconstruct_answer_chains,
                                    validate_chrome_trace,
                                    validate_cost_records)

    doc = tr.to_chrome()
    errs = validate_chrome_trace(doc)
    errs += validate_cost_records([r.to_dict() for r in cl.records])
    if check_chains:
        errs += reconstruct_answer_chains(doc)
    return errs
