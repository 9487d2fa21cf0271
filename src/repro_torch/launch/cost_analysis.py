"""Per-device step costs and the H100 roofline (the port's counterpart of
``repro/launch/hlo_analysis.py``'s callers' API).

JAX compiles a step and walks its HLO text, weighting while-loop bodies
by their trip counts.  The port runs eagerly: there is no program to
parse, and every op a step dispatches is one the card would run.  So
:func:`count_step` runs the step once under :class:`StepCounter`, a
``TorchDispatchMode`` that sees each aten op after DTensor has split it
into one rank's local op (the per-device program, as JAX's SPMD-
partitioned HLO is), and counts:

  dot_flops       ``torch.utils.flop_counter.FlopCounterMode``'s count of
                  mm / bmm / addmm / baddbmm (their ``out_dtype``
                  overloads too) and convolutions: 2 · M · N · K, JAX's
                  rule for a ``dot``
  vector_flops    output elements of each pointwise op, input elements of
                  each reduction (softmax and its kin counted as one):
                  JAX's per-op rule for elementwise / reduce ops
  traffic_bytes   the bytes each op reads plus the bytes it writes; a
                  view counts nothing, a gather reads and writes the rows
                  it takes, a scatter the rows it writes, a lookup's
                  backward its rows, index and whole gradient.  This is not
                  JAX's fusion-discounted model: the port fuses nothing,
                  so every op's operands and result cross HBM
  collectives     functional ``_c10d_functional.*`` ops (DTensor's) and
                  direct ``c10d.*`` ops (``core._dist.ShardGroup``'s),
                  filed under JAX's kind names; the payload is the
                  output's bytes, an all-reduce counted twice (a ring's
                  reduce and broadcast halves), as JAX counts it
  memory          peak live bytes a device (every storage alive at once,
                  freed when its last tensor dies), split into JAX's
                  argument / output / temporary keys

A loop whose trip count the host does not know (a fixpoint) is traced one
body; :meth:`StepCounter.weighted` multiplies a body's counts by a known
trip count (Alg. 2's ``n_true`` iterations), as JAX's walk weights a
``fori_loop``.

The roofline's terms are one NVIDIA H100 SXM at 700 W, dense rates from
NVIDIA's H100 data sheet (see the constants).  The tensor-core term reads
``dot_flops``; the H100 has no VPU, so the non-tensor-core term
(``simt_s``) runs on the CUDA cores.
"""
from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# ---------------------------------------------------------------------------
# the card: one NVIDIA H100 SXM5 80GB at 700 W
# ---------------------------------------------------------------------------

#: bf16 dense tensor-core FLOP/s (H100 SXM data sheet: 989 TFLOPS bf16
#: without sparsity)
PEAK_FLOPS = 989e12
#: CUDA-core ops/s: the data sheet's 67 TFLOPS f32 counts an FMA as two
#: operations; one pointwise op (an add, a min) is one instruction
SIMT_OPS = 33.5e12
#: HBM3 bytes/s (data sheet: 3.35 TB/s)
HBM_BW = 3.35e12
#: network bytes/s a GPU: one 400 Gb/s ConnectX-7 port a GPU in a DGX
#: H100.  Every axis of the (16, 16) and (2, 16, 16) meshes spans more
#: than one 8-GPU NVLink node, so every collective crosses that link
NET_BW = 50e9
#: NVLink 4 bytes/s a direction (data sheet: 900 GB/s both ways), the rate
#: a collective inside one 8-GPU node would see; these meshes' collectives
#: do not reach it
NVLINK_BW = 450e9
#: seconds a collective: the median of a one-float all-reduce on a
#: world-1 NCCL group (:func:`measure_collective_latency`), a launch-and-
#: sync floor that crosses no link, measured by chip_smoke.py's dryrun
#: phase on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (torch
#: 2.11.0+cu128; 200 calls, min 30.2 us)
COLL_LATENCY = 4.540649999995594e-05
#: where COLL_LATENCY comes from
COLL_LATENCY_SOURCE = ("median of a one-float all_reduce on a world-1 "
                       "NCCL group, NVIDIA H100 80GB HBM3 at 700.00 W, "
                       "chip_smoke.py dryrun phase")
#: memory of one card, bytes (the memory model's)
CARD_BYTES = 80e9

CONSTANTS = {
    "card": "NVIDIA H100 SXM5 80GB, 700 W",
    "peak_flops": PEAK_FLOPS,
    "simt_ops": SIMT_OPS,
    "hbm_bw": HBM_BW,
    "net_bw": NET_BW,
    "nvlink_bw_not_reached": NVLINK_BW,
    "coll_latency_s": COLL_LATENCY,
    "card_bytes": CARD_BYTES,
    "source": ("NVIDIA H100 Tensor Core GPU data sheet (SXM5, dense): "
               "989 TFLOPS bf16, 67 TFLOPS f32 (33.5e12 single ops/s), "
               "3.35 TB/s HBM3; 400 Gb/s ConnectX-7 a GPU (DGX H100); "
               "collective latency: " + COLL_LATENCY_SOURCE),
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class WeightedStats:
    dot_flops: float = 0.0
    vector_flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    collective_count: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def add(self, other: "WeightedStats", w: float):
        self.dot_flops += w * other.dot_flops
        self.vector_flops += w * other.vector_flops
        self.traffic_bytes += w * other.traffic_bytes
        for k in COLLECTIVES:
            self.collective_bytes[k] += w * other.collective_bytes[k]
            self.collective_count[k] += int(w * other.collective_count[k])

    def to_dict(self):
        return {
            "dot_flops": self.dot_flops,
            "vector_flops": self.vector_flops,
            "traffic_bytes": self.traffic_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_count": dict(self.collective_count),
            "total_collective_bytes": self.total_collective_bytes,
        }


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def _collective_kinds() -> dict:
    """aten overload -> JAX's kind name, for the collectives on the
    port's paths (those this torch has)."""
    out = {}
    table = {
        "all-gather": ("_c10d_functional.all_gather_into_tensor",
                       "_c10d_functional.all_gather_into_tensor_out",
                       "_c10d_functional_autograd.all_gather_into_tensor",
                       "c10d._allgather_base_", "c10d.allgather_"),
        "all-reduce": ("_c10d_functional.all_reduce",
                       "_c10d_functional.all_reduce_",
                       "c10d.allreduce_"),
        "reduce-scatter": ("_c10d_functional.reduce_scatter_tensor",
                           "_c10d_functional_autograd.reduce_scatter_tensor",
                           "c10d._reduce_scatter_base_",
                           "c10d.reduce_scatter_"),
        "all-to-all": ("_c10d_functional.all_to_all_single",
                       "_c10d_functional_autograd.all_to_all_single",
                       "c10d.alltoall_base_", "c10d.alltoall_",
                       "_dtensor.shard_dim_alltoall"),
        # one rank's block copied to others: JAX's point-to-point kind
        "collective-permute": ("_c10d_functional.broadcast",
                               "_c10d_functional.broadcast_",
                               "c10d.broadcast_", "c10d.send",
                               "c10d.recv_"),
    }
    for kind, names in table.items():
        for name in names:
            ns, op = name.split(".")
            packet = getattr(getattr(torch.ops, ns), op, None)
            if packet is not None and hasattr(packet, "default"):
                out[packet.default] = kind
    return out


_aten = torch.ops.aten
#: reductions that carry no ``reduction`` tag: counted as one reduction
#: of their input, as JAX's reduce ops
_REDUCE_LIKE = {getattr(_aten, n).default for n in (
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "cumsum") if hasattr(_aten, n)}
#: ops that read the rows they take (and the index), not their whole source
_GATHERS = {_aten.index_select.default, _aten.gather.default,
            _aten.embedding.default, _aten.index.Tensor}
#: ops that write rows into their first argument in place: they read the
#: update (and the index) and write as many bytes
_SCATTERS = {_aten.index_put_.default, _aten.scatter_.src,
             _aten.scatter_.value, _aten.index_copy_.default,
             _aten.index_add_.default, _aten.scatter_add_.default}
#: a lookup's backward: reads the rows' gradients and the index, writes
#: the whole table's gradient once (its zero fill and the rows summed in)
_ROW_GRADS = {_aten.embedding_dense_backward.default}
#: allocations that write nothing
_ALLOCS = {_aten.empty.memory_format, _aten.empty_strided.default,
           _aten.empty_like.default, _aten.new_empty.default,
           _aten.new_empty_strided.default}
_SCALARS = {_aten.scalar_tensor.default}
_DTYPE_DOTS = (_aten.mm, _aten.bmm)
_SYNC = {getattr(torch.ops._c10d_functional, "wait_tensor").default}


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


class StepCounter(TorchDispatchMode):
    """Counts each local aten op a step dispatches (module doc).  Enter it
    after ``FakeTensorMode`` (when tracing fake tensors), so it sees every
    op first; DTensor ops are let through to DTensor, whose local ops it
    then sees.

    It keeps :attr:`collective_outputs`, kind -> ``"group: (input
    shape) -> (output shape)"`` -> calls (loop weights not applied).
    With ``log``, it also keeps :attr:`ops`, ``"op[input shapes]"`` ->
    [calls, output bytes, dot flops], and :attr:`peak_by_op`, the bytes
    live at the peak by the op that made them (``"argument"`` for the
    step's arguments): what two traces of one step differ by
    (``tools/op_log_diff.py``)."""

    def __init__(self, log: bool = False):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.flop_registry = FlopCounterMode(display=False).flop_registry
        self.stats = WeightedStats()
        self.raw_collective_bytes = {k: 0.0 for k in COLLECTIVES}
        self.weight = 1.0
        self._kinds = _collective_kinds()
        self._live: dict = {}   # id(storage) -> (weakref, bytes, origin)
        self.live_bytes = 0
        self.peak_bytes = 0
        self.ops = {} if log else None
        self.peak_by_op: dict = {}
        self.collective_outputs: dict = {}
        self._depth = self._paused = 0

    # -- loop weights --------------------------------------------------------
    @contextlib.contextmanager
    def weighted(self, w: float):
        """Counts inside the block are multiplied by ``w`` (a loop body
        traced once that the step runs ``w`` times)."""
        prev, self.weight = self.weight, self.weight * w
        try:
            yield
        finally:
            self.weight = prev

    # -- live storages -------------------------------------------------------
    def track(self, tensors, origin: str = "argument") -> int:
        """Register the storages of ``tensors`` (made by ``origin``) as
        live; returns the bytes newly registered (storages seen before
        count nothing)."""
        added = 0
        for t in tensors:
            st = _local(t).untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            nb = st.nbytes()

            def gone(_, key=key, nb=nb):
                if self._live.pop(key, None) is not None:
                    self.live_bytes -= nb
            self._live[key] = (weakref.ref(st, gone), nb, origin)
            self.live_bytes += nb
            added += nb
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            if self.ops is not None:
                self.peak_by_op = {}
                for _, b, o in self._live.values():
                    self.peak_by_op[o] = self.peak_by_op.get(o, 0) + b
        return added

    def storage_bytes(self, tensors) -> int:
        """Bytes of the distinct storages of ``tensors``."""
        seen = {}
        for t in tensors:
            st = _local(t).untyped_storage()
            seen[id(st)] = st.nbytes()
        return sum(seen.values())

    # -- DTensor's shape inference -------------------------------------------
    def __enter__(self):
        if not self._depth:           # re-entered from a decomposition
            self._unpatch = _pause_during_shape_inference(self)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if not self._depth:
                self._unpatch()

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor splits it into local ops
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if (func._overloadpacket not in self.flop_registry
                and func is not torch.ops.prim.device.default):
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        if func in _SCALARS:
            # a Python number made a tensor: a kernel argument on the card
            # (a meta or fake device materialises it, a real one does not)
            return out
        dots = self.stats.dot_flops
        self._count(func, args, kwargs, out)
        outs = _tensors(out)
        if self.ops is not None:
            key = f"{func}{[tuple(t.shape) for t in _tensors((args, kwargs))]}"
            e = self.ops.setdefault(key, [0, 0, 0.0])
            e[0] += 1
            e[1] += sum(_nbytes(t) for t in outs)
            e[2] += self.stats.dot_flops - dots
        kind = self._kinds.get(func)
        if kind is not None and outs:
            # a functional collective's last string argument names its
            # group
            group = next((a for a in reversed(args) if isinstance(a, str)),
                         "")
            ins = _tensors(args)
            k = (f"{group}: {tuple(ins[0].shape) if ins else ()} -> "
                 f"{tuple(outs[0].shape)}")
            calls = self.collective_outputs.setdefault(kind, {})
            calls[k] = calls.get(k, 0) + 1
        if outs:
            self.track(outs, str(func))
        return out

    def _count(self, func, args, kwargs, out):
        w, st = self.weight, self.stats
        packet = func._overloadpacket
        if packet in self.flop_registry:
            fa, fk = args, kwargs
            if packet in _DTYPE_DOTS:
                # the out_dtype overloads: bmm's counter takes a third
                # positional argument for its output shape
                fa, fk = args[:2], {}
            st.dot_flops += w * self.flop_registry[packet](
                *fa, **fk, out_val=out)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        kind = self._kinds.get(func)
        if kind is not None:
            payload = sum(_nbytes(t) for t in outs)
            self.raw_collective_bytes[kind] += w * payload
            st.collective_bytes[kind] += w * payload * (
                2 if kind == "all-reduce" else 1)
            st.collective_count[kind] += int(w)
            st.traffic_bytes += w * payload
            return
        if func in _SYNC or func.is_view or not outs:
            return                      # no data moved (metadata queries)
        tags = func.tags
        if torch.Tag.pointwise in tags and outs:
            st.vector_flops += w * outs[0].numel()
        elif (torch.Tag.reduction in tags or func in _REDUCE_LIKE) and ins:
            st.vector_flops += w * ins[0].numel()
        if func in _ALLOCS:
            return
        if func in _GATHERS:
            moved = 2 * sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in ins[1:])
        elif func in _SCATTERS:
            moved = 2 * sum(_nbytes(t) for t in ins[1:])
        elif func in _ROW_GRADS:
            moved = _nbytes(ins[0]) + _nbytes(ins[1]) + _nbytes(outs[0])
        else:
            moved = (sum(_nbytes(t) for t in ins)
                     + sum(_nbytes(t) for t in outs))
        st.traffic_bytes += w * moved


def _pause_during_shape_inference(counter: StepCounter):
    """Pause ``counter`` while DTensor infers an op's output shape: its
    sharding propagation runs each new (op, layout) once on global-shape
    fake tensors, which is not a device's work.  Returns the undo."""
    try:
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator)
    except ImportError:
        return lambda: None
    name = "_propagate_tensor_meta_non_cached"
    orig = ShardingPropagator.__dict__.get(name)
    if orig is None:
        return lambda: None

    def paused(self, *a, **kw):
        counter._paused += 1
        try:
            return orig(self, *a, **kw)
        finally:
            counter._paused -= 1
    setattr(ShardingPropagator, name, paused)
    return lambda: setattr(ShardingPropagator, name, orig)


def count_step(fn, *args, counter: StepCounter | None = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a :class:`StepCounter` (or
    ``counter``, whose weights a caller may set around loop bodies) and
    return ``(WeightedStats, memory dict, result)``.

    The memory dict has JAX's keys a device: ``argument_size_in_bytes``
    (the distinct storages of the arguments), ``output_size_in_bytes``
    (storages of the result that are not arguments),
    ``temp_size_in_bytes`` (the rest of the peak) and
    ``live_bytes_per_device`` (their sum, the peak), plus ``fits``
    against one card's :data:`CARD_BYTES`."""
    from repro_torch.models.tree import leaves
    c = counter or StepCounter()
    # the models' trees hold dataclasses (TrainState), which torch's
    # pytree takes for leaves
    tensors = lambda tree: [t for t in leaves(tree)
                            if isinstance(t, torch.Tensor)]
    arg_ts = tensors((args, kwargs))
    arg_bytes = c.track(arg_ts)
    with c:
        out = fn(*args, **kwargs)
    arg_ids = {id(_local(a).untyped_storage()) for a in arg_ts}
    out_bytes = c.storage_bytes(
        t for t in tensors(out)
        if id(_local(t).untyped_storage()) not in arg_ids)
    peak = max(c.peak_bytes, arg_bytes + out_bytes)
    mem = {"argument_size_in_bytes": int(arg_bytes),
           "output_size_in_bytes": int(out_bytes),
           "temp_size_in_bytes": int(peak - arg_bytes - out_bytes),
           "alias_size_in_bytes": 0,
           "live_bytes_per_device": int(peak)}
    mem["fits"] = mem["live_bytes_per_device"] <= CARD_BYTES
    return c.stats, mem, out


def collective_stats(fn, *args, **kwargs) -> dict:
    """The collectives of one run of ``fn``, loop bodies as traced and
    every payload counted once (JAX's unweighted legacy scan)."""
    c = StepCounter()
    count_step(fn, *args, counter=c, **kwargs)
    return {"bytes_by_kind": dict(c.raw_collective_bytes),
            "count_by_kind": dict(c.stats.collective_count),
            "total_bytes": sum(c.raw_collective_bytes.values())}


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    compute_s: float
    simt_s: float
    memory_s: float
    collective_s: float
    latency_s: float                # collective count × COLL_LATENCY
    dot_flops: float
    vector_flops: float
    traffic_bytes: float
    collective_bytes: float
    collective_count: int
    model_flops: Optional[float]
    useful_ratio: Optional[float]   # model_flops / (dot_flops × chips)

    def _terms(self) -> dict:
        return {"compute": self.compute_s, "simt": self.simt_s,
                "memory": self.memory_s, "collective": self.collective_s,
                "latency": self.latency_s}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self._terms().values())

    @property
    def roofline_fraction(self) -> Optional[float]:
        """Model FLOPs over the bound time (JAX's MFU-like score)."""
        if not self.model_flops:
            return None
        return self.model_flops / max(self.bound_time_s, 1e-30)

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["bound_time_s"] = self.bound_time_s
        return d


def roofline(ws: WeightedStats, *, chips: int,
             model_flops: Optional[float] = None) -> Roofline:
    """ws: one device's stats.  model_flops: the whole model's analytic
    FLOPs for the step (6·N·D train / 2·N a token forward)."""
    mf_per_chip = (model_flops / chips) if model_flops else None
    n_coll = int(sum(ws.collective_count.values()))
    return Roofline(
        compute_s=ws.dot_flops / PEAK_FLOPS,
        simt_s=ws.vector_flops / SIMT_OPS,
        memory_s=ws.traffic_bytes / HBM_BW,
        collective_s=ws.total_collective_bytes / NET_BW,
        latency_s=n_coll * COLL_LATENCY,
        dot_flops=ws.dot_flops,
        vector_flops=ws.vector_flops,
        traffic_bytes=ws.traffic_bytes,
        collective_bytes=ws.total_collective_bytes,
        collective_count=n_coll,
        model_flops=model_flops,
        useful_ratio=(mf_per_chip / ws.dot_flops
                      if model_flops and ws.dot_flops else None),
    )


def mfu_fraction(r: Roofline, chips: int) -> Optional[float]:
    """model_flops / (chips × peak × bound_time)."""
    if not r.model_flops:
        return None
    t = r.bound_time_s
    if t <= 0:
        return None
    return r.model_flops / (chips * PEAK_FLOPS * t)


def analytic_train_flops(cfg, tokens: int) -> float:
    """6·N_active·D (the MODEL_FLOPS definition)."""
    return 6.0 * cfg.active_param_count() * tokens


def analytic_decode_flops(cfg, tokens: int) -> float:
    """2·N_active per processed token (fwd only: prefill and decode)."""
    return 2.0 * cfg.active_param_count() * tokens


# ---------------------------------------------------------------------------
# the latency constant, measured on the card
# ---------------------------------------------------------------------------

def measure_collective_latency(device="cuda:0", *, store_dir: str,
                               reps: int = 200) -> dict:
    """Median seconds of a one-float ``all_reduce`` on a world-1 NCCL
    group on ``device`` (each call synchronized, after 20 warm-up
    calls): the floor a collective costs before any link.  Opens and
    closes its own group, so the process may hold no other."""
    from repro_torch.core._dist import open_group
    with open_group(0, 1, backend="nccl", device=device,
                    store_dir=store_dir) as g:
        x = torch.ones(1, device=g.device)
        times = []
        for i in range(20 + reps):
            torch.cuda.synchronize(g.device)
            t0 = time.perf_counter()
            g.all_reduce(x, "sum")
            torch.cuda.synchronize(g.device)
            if i >= 20:
                times.append(time.perf_counter() - t0)
    return {"median_s": statistics.median(times), "min_s": min(times),
            "reps": reps}
