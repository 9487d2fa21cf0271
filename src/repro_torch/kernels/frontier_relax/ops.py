"""Public wrapper of the in-place frontier push kernel.

``make_frontier_sweep_fn`` adapts it to core/frontier.py's sweep contract.
The TPU version walked the compacted frontier in blocks of padded out-ELL
rows and scatter-min'd the kernel's candidates in XLA; here one call covers
the whole compacted frontier and does the scatter-min itself, over the flat
outgoing CSR windows, into ``dist`` in place.  Bitwise equal to the flat
sweep: the same candidate multiset, min taken in any order.

The fallen-label mask is the fixpoint loop's own ``pending`` set, which
``relax_active`` clears of the active rows before the sweep: the kernel
sets the labels that fell, so no second mask is made or merged.
"""
from __future__ import annotations

from repro_torch.kernels.frontier_relax import kernel as K


def make_frontier_sweep_fn():
    """The kernel-backed sweep for core.frontier.sssp_frontier:
    ``sweep(dist, fids, starts, off, E, fcount, ops, fell)``, in place.
    The kernel finds each row's window in ``ops["out_indptr"]`` itself, so
    it reads only ``fids`` of the compaction."""
    def sweep(dist, fids, starts, off, E, fcount, ops, fell):
        K.frontier_relax(dist, fids, ops["out_indptr"], ops["out_dst"],
                         ops["out_w"], fell)
    return sweep
