"""Wrapper of the hand-written CUDA frontier push kernel
(``csrc/frontier_relax.cu``; it replaces the Pallas TPU kernel
``repro/kernels/frontier_relax/kernel.py:frontier_cand`` together with the
scatter-min that followed it, and the source says what bounds it on an H100
and how its design answers that).

``frontier_relax`` launches the kernel on CUDA tensors and runs the plain
version (ref.py) on CPU tensors.  ``frontier_relax.launches`` counts the
kernel's launches.

The kernel works in place: it lowers ``dist`` itself and flags the labels
that fell in a mask the caller owns.  A call on dist's own labels
allocates 12 bytes a frontier row (each row's label, its Jacobi snapshot,
and out-window) and nothing of size n; a call with explicit labels is one
launch and allocates nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.frontier_relax.ref import frontier_relax_ref

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGS = (_P, _P, _P, _P, _I64, _I64, _P, _P, _P, _P, ctypes.c_int, _P)


def frontier_relax(dist: torch.Tensor, fids: torch.Tensor,
                   out_indptr: torch.Tensor, out_dst: torch.Tensor,
                   out_w: torch.Tensor, fell: torch.Tensor, *,
                   flabels: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter-min ``dist[u] + w`` over the out-windows of the frontier
    vertices ``fids`` into ``dist`` in place, reading every source label as
    it was before the call; ids >= n are skipped.  Sets ``fell[v]`` for
    every label that fell (and clears none); returns ``fell``.

    dist f32 (n,); fids int64 (F,); out_indptr int32 (>= n + 1,) over the
    outgoing CSR (out_dst int32 (m,), out_w f32 (m,)); fell bool (n,).
    Weights must be nonnegative: the kernel's atomicMin compares float bit
    patterns as int32, which orders them only from +0 up to +inf.

    With ``flabels`` (f32 (F,)) row f pushes the label ``flabels[f]``
    instead of ``dist[fids[f]]``, the ids are sources of the out-CSR (ids
    outside its R = ``len(out_indptr) - 1`` rows are skipped), and
    ``dist``, ``out_dst`` and ``fell`` are a block of targets: the local
    push of frontier_sharded, whose labels come from the exchange.  On
    CUDA tensors that mode is one launch of its own warp-balanced kernel:
    no scratch, and no lane-group width (the C entry ignores it).
    """
    n = dist.shape[0]
    m = out_dst.shape[0]
    rows = out_indptr.shape[0] - 1
    common.check(dist, "dist", torch.float32, (n,))
    common.check(fids, "fids", torch.int64, (fids.shape[0],))
    common.check(out_indptr, "out_indptr", torch.int32, (rows + 1,))
    if flabels is None and rows < n:
        raise ValueError(f"out_indptr needs at least {n + 1} entries")
    if flabels is not None:
        common.check(flabels, "flabels", torch.float32, (fids.shape[0],))
    common.check(out_dst, "out_dst", torch.int32, (m,))
    common.check(out_w, "out_w", torch.float32, (m,))
    common.check(fell, "fell", torch.bool, (n,))
    given = () if flabels is None else (flabels,)
    if not common.on_cuda(dist, fids, out_indptr, out_dst, out_w, fell,
                          *given):
        return frontier_relax_ref(dist, fids, out_indptr, out_dst, out_w,
                                  fell, flabels=flabels)
    F = fids.shape[0]
    if F == 0 or m == 0:
        return fell
    if flabels is None:
        # the F rows' out-windows and labels, gathered before the push
        scratch = torch.empty(3 * F, dtype=torch.int32, device=dist.device)
        labels, scratch_ptr = None, scratch.data_ptr()
        bound, group = n, common.lane_group(n, m)
    else:
        labels, scratch_ptr, bound, group = flabels.data_ptr(), None, rows, 0
    rc = common.launcher("frontier_relax", _ARGS)(
        dist.data_ptr(), fids.data_ptr(), labels, scratch_ptr, F, bound,
        out_indptr.data_ptr(), out_dst.data_ptr(), out_w.data_ptr(),
        fell.data_ptr(), group, common.stream(dist))
    common.raise_on_error(rc, "frontier_relax")
    frontier_relax.launches += 1
    return fell


frontier_relax.launches = 0
