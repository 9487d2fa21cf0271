"""Dynamic graphs: mutable CSR overlays and incremental SSSP repair (port of
repro/dynamic).

``DynamicGraph`` (overlay.py) is a versioned mutable view over a frozen
``CsrGraph``: an insertion overlay, weight updates, deletion tombstones and
threshold-triggered compaction, staged on the device with fixed shapes
across versions.  repair.py turns an existing fixpoint into the mutated
graph's, bitwise equal to a cold solve, and holds the dynamic sweeps that
run the core engines on the overlay operands.
"""
from repro_torch.dynamic.overlay import DynamicGraph, EdgeDelta, MutationBatch
from repro_torch.dynamic.repair import (RepairStats, dynamic_segment_sweep,
                                        dynamic_segment_sweep_multi,
                                        make_dynamic_flat_sweep_fn,
                                        predecessors_from_dist_dynamic,
                                        repair_sssp, row_affected,
                                        solve_dynamic, sssp_frontier_dynamic,
                                        sssp_repair)

__all__ = [
    "DynamicGraph",
    "EdgeDelta",
    "MutationBatch",
    "RepairStats",
    "dynamic_segment_sweep",
    "dynamic_segment_sweep_multi",
    "make_dynamic_flat_sweep_fn",
    "predecessors_from_dist_dynamic",
    "repair_sssp",
    "row_affected",
    "solve_dynamic",
    "sssp_frontier_dynamic",
    "sssp_repair",
]
