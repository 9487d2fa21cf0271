"""Logical-axis -> mesh-axis sharding rules with divisibility fallback
(port of ``repro/sharding/rules.py``).

MaxText-style: every tensor dim carries an ordered preference list of
*logical* axes; a logical axis resolves to one or more mesh axes ("dp" ->
("pod", "data") on the multi-pod mesh); an assignment is taken only if
the dim is divisible by the product of the mesh-axis sizes and no mesh
axis is used twice in one spec.  Anything unassigned is replicated.

Scheme (baseline), as JAX's:
  batch                  -> dp  = ("pod", "data")
  heads/ff/vocab/experts -> tp  = ("model",)
  param non-TP dim       -> fsdp = ("pod", "data")   (ZeRO-3-style)
  decode KV cache        -> batch over dp, kv-heads over tp,
                            sequence over dp when batch=1 (long_500k).

A spec is a :class:`Spec`, one entry a tensor dim: a mesh-axis name, a
tuple of names, or None.  A mesh is either an :class:`AbstractMesh` (axis
names and sizes, no devices: the production meshes, the rules tests) or
a ``torch.distributed.device_mesh.DeviceMesh`` whose dims are named.

JAX's rules branch on rank: ``spec_for_param`` strips the leading rep dim
of a ``segments`` leaf and tells MoE tensors by rank 3, and
``cache_spec`` branches on ``len(shape) >= 4 / >= 5``.  They take JAX's
layout (stacked reps).  The port keeps one dict a layer with no rep dim,
so :func:`port_param_specs` and :func:`port_cache_specs` apply the rules
to the JAX path and stacked shape of each per-layer leaf and drop the rep
entry (always None): a per-layer shape never meets a rank-based branch.

The ambient mesh (:func:`set_mesh` / :func:`get_mesh`) is per process,
the port's counterpart of ``repro/core/_compat.py``'s ``set_mesh`` /
``get_abstract_mesh``.  :func:`constrain` redistributes a DTensor to the
placements its rule gives on an ambient ``DeviceMesh``; with no mesh, an
abstract one, a world of one or a plain tensor it returns its input.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Any, Sequence

import torch

# ---------------------------------------------------------------------------
# specs and meshes
# ---------------------------------------------------------------------------


def _norm_entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


class Spec(tuple):
    """A partition spec: one entry a dim (an axis name, a tuple of names
    or None).  Equality is JAX ``PartitionSpec``'s: entry by entry, a
    one-name tuple equal to the name, trailing Nones significant."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_norm_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices (JAX's ``AbstractMesh``)."""

    axis_shape: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.axis_shape) != len(self.axis_names):
            raise ValueError(f"{self.axis_shape} against {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_shape))

    @property
    def size(self) -> int:
        return math.prod(self.axis_shape)


def axis_names(mesh) -> tuple:
    """The mesh's axis names, for an abstract or a device mesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names or ())


def mesh_shape(mesh) -> dict:
    """{axis name: size} for an abstract or a device mesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def logical_map(mesh) -> dict[str, tuple[str, ...]]:
    names = axis_names(mesh)
    return {
        "dp": tuple(a for a in ("pod", "data") if a in names),
        "data": tuple(a for a in ("data",) if a in names),
        "pod": tuple(a for a in ("pod",) if a in names),
        "tp": tuple(a for a in ("model",) if a in names),
    }


def _axis_size(mesh, axes: tuple[str, ...]) -> int:
    sh = mesh_shape(mesh)
    return math.prod(sh[a] for a in axes)


def assign_spec(shape: Sequence[int], prefs: Sequence[Sequence[str]],
                mesh) -> Spec:
    """prefs[i] = ordered logical-axis candidates for dim i."""
    lm = logical_map(mesh)
    used: set[str] = set()
    out: list[Any] = [None] * len(shape)
    for i, cands in enumerate(prefs):
        for logical in cands:
            axes = lm.get(logical, ())
            if not axes or any(a in used for a in axes):
                continue
            if shape[i] % _axis_size(mesh, axes) != 0:
                continue
            out[i] = axes if len(axes) > 1 else axes[0]
            used.update(axes)
            break
    return Spec(*out)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> tuple:
    """One device's block of a ``shape`` laid out by ``spec`` (the rules
    assign only dims their axes divide)."""
    sh = mesh_shape(mesh)
    out = []
    for i, n in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        out.append(n // math.prod(sh[a] for a in axes))
    return tuple(out)


# ---------------------------------------------------------------------------
# parameter rules (matched on leaf name; see models/* for layouts)
# ---------------------------------------------------------------------------

_PARAM_RULES: dict[str, list[list[str]]] = {
    # name: prefs per dim (excluding any leading scan-rep dim)
    "tok":      [["tp"], ["dp"]],                    # (V, d)
    "lm_head":  [["dp"], ["tp"]],                    # (d, V)
    "wq":       [["dp"], ["tp"], []],                # (d, H, hd)
    "wk":       [["dp"], ["tp"], []],
    "wv":       [["dp"], ["tp"], []],
    "attn_wo":  [["tp"], [], ["dp"]],                # (H, hd, d)
    "bq":       [["tp"], []],
    "bk":       [["tp"], []],
    "bv":       [["tp"], []],
    "wi_gate":  [["dp"], ["tp"]],                    # (d, ff)
    "wi_up":    [["dp"], ["tp"]],
    "mlp_wo":   [["tp"], ["dp"]],                    # (ff, d)
    "router":   [["dp"], []],                        # (d, E)
    "moe_wi":   [["tp"], ["dp"], ["tp"]],            # (E, d, ff) E->tp else ff
    "moe_wo":   [["tp"], ["tp"], ["dp"]],            # (E, ff, d)
    "in_proj":  [["dp"], ["tp"]],                    # (d, 2di+2N+H)
    "out_proj": [["tp"], ["dp"]],                    # (di, d)
    "conv_w":   [[], ["tp"]],                        # (k, conv_dim)
    "conv_b":   [["tp"]],
}


def _key(entry):
    """A path entry's key: a (kind, key) pair of ``models.tree`` or a
    bare key."""
    if isinstance(entry, tuple) and len(entry) == 2 and entry[0] in (
            "key", "idx", "attr"):
        return entry[1]
    return entry


def _leaf_rule(path) -> tuple[str, bool]:
    """(rule key, has_leading_rep_dim) from a JAX-layout tree path.

    MoE expert tensors share leaf names with dense MLPs (wi_gate / wi_up /
    wo); they are told apart by rank in :func:`spec_for_param` (expert
    tensors are 3-D after stripping the scan-rep dim)."""
    keys = [_key(k) for k in path]
    name = keys[-1]
    in_segment = "segments" in keys or "enc_segments" in keys
    parent = keys[-2] if len(keys) >= 2 else None
    if name == "wo":
        name = "attn_wo" if parent in ("attn", "xattn") else "mlp_wo"
    return name, in_segment


def spec_for_param(path, shape, mesh) -> Spec:
    """The spec of a parameter at JAX-layout ``path`` with JAX-layout
    ``shape`` (a ``segments`` leaf carries its leading rep dim)."""
    name, in_segment = _leaf_rule(path)
    dims = list(shape)
    lead = 0
    if in_segment:
        lead = 1
        dims = dims[1:]
    # disambiguate dense-vs-moe expert tensors by rank
    if name in ("wi_gate", "wi_up") and len(dims) == 3:
        name = "moe_wi"
    if name == "mlp_wo" and len(dims) == 3:
        name = "moe_wo"
    prefs = _PARAM_RULES.get(name)
    if prefs is None or len(prefs) != len(dims):
        # norms, scalars, biases, A_log, gates, ... -> replicated
        return Spec(*([None] * (lead + len(dims))))
    spec = assign_spec(dims, prefs, mesh)
    return Spec(*([None] * lead + list(spec)))


def param_shardings(params_shape, mesh):
    """Spec tree for a JAX-layout parameter tree (anything with
    ``.shape`` at the leaves; ``models.convert.to_jax_layout`` gives one
    from the port's)."""
    from repro_torch.models.tree import leaves_with_path, unflatten
    return unflatten(params_shape, [
        spec_for_param(path, leaf.shape, mesh)
        for path, leaf in leaves_with_path(params_shape)])


def _jax_param_path(path, cfg):
    """(JAX-layout path, stacked?) of a port parameter path: a layer
    ``("layers", j, ...)`` is position ``i`` of segment ``si`` in JAX's
    ``("segments", si, i, ...)``, stacked over the segment's reps."""
    keys = [_key(k) for k in path]
    stacks = {"layers": ("segments", cfg.segments),
              "enc_layers": ("enc_segments", cfg.encoder_segments)}
    if keys and keys[0] in stacks:
        jname, segments = stacks[keys[0]]
        j, base = keys[1], 0
        for si, (pat, rep) in enumerate(segments):
            if j < base + rep * len(pat):
                i = (j - base) % len(pat)
                return (jname, si, i, *keys[2:]), rep
            base += rep * len(pat)
        raise ValueError(f"layer {j} is past the config's segments")
    return tuple(keys), 0


def port_param_specs(params, cfg, mesh):
    """Spec tree of the port's parameters (or any tree of their
    structure, the moments too): JAX's spec of each leaf in JAX's layout,
    its rep entry dropped for a per-layer leaf."""
    from repro_torch.models.tree import leaves_with_path, unflatten
    out = []
    for path, leaf in leaves_with_path(params):
        jpath, rep = _jax_param_path(path, cfg)
        if rep:
            out.append(Spec(*spec_for_param(
                jpath, (rep,) + tuple(leaf.shape), mesh)[1:]))
        else:
            out.append(spec_for_param(jpath, tuple(leaf.shape), mesh))
    return unflatten(params, out)


# ---------------------------------------------------------------------------
# activations / batch / cache
# ---------------------------------------------------------------------------

def batch_spec(shape, mesh) -> Spec:
    """Token-like (B, S[, d]) arrays: batch over dp."""
    prefs = [["dp"]] + [[] for _ in shape[1:]]
    return assign_spec(shape, prefs, mesh)


def _tree_specs(tree, fn):
    from repro_torch.models.tree import leaves, unflatten
    return unflatten(tree, [fn(leaf.shape) for leaf in leaves(tree)])


def batch_shardings(batch_shape, mesh):
    return _tree_specs(batch_shape, lambda s: batch_spec(s, mesh))


def cache_spec(shape, mesh) -> Spec:
    """JAX-layout KV cache (rep, B, S, KV, hd) / ssm state (rep, B, H, P,
    N) / conv state (rep, B, k-1, conv).  Batch over dp; if batch is
    unshardable (long_500k B=1) the sequence/state dim takes dp; kv-heads
    take tp.  When the KV-head count is indivisible by the model axis the
    *sequence* dim takes tp instead (split-K cache partitioning), unless
    ``REPRO_NO_CACHE_SEQ_FALLBACK`` is set, as JAX reads it."""
    if len(shape) >= 4:
        prefs = [[], ["dp"], ["dp"], ["tp"], []][: len(shape)]
        while len(prefs) < len(shape):
            prefs.append([])
        if (len(shape) >= 5
                and not os.environ.get("REPRO_NO_CACHE_SEQ_FALLBACK")):
            lm = logical_map(mesh)
            tp = lm.get("tp", ())
            kv_ok = tp and shape[3] % _axis_size(mesh, tp) == 0
            if not kv_ok:
                prefs[2] = ["dp", "tp"]     # sequence takes the model axis
        return assign_spec(shape, prefs, mesh)
    return assign_spec(shape, [[]] + [["dp"]] * (len(shape) - 1), mesh)


def cache_shardings(cache_shape, mesh):
    """Spec tree for a JAX-layout cache tree (stacked reps)."""
    return _tree_specs(cache_shape, lambda s: cache_spec(s, mesh))


def port_cache_specs(caches, mesh):
    """Spec tree of the port's caches (one entry a layer, no rep dim):
    JAX's spec of the stacked shape with the rep entry dropped."""
    return _tree_specs(caches, lambda s: Spec(*cache_spec(
        (1,) + tuple(s), mesh)[1:]))


def replicated(mesh) -> Spec:
    return Spec()


# ---------------------------------------------------------------------------
# in-model activation constraints
# ---------------------------------------------------------------------------

_ACT_RULES: dict[str, list[list[str]]] = {
    # (B, S, d) hidden states: batch over dp
    "hidden": [["dp", "data", "pod"], [], []],
    # (B, S, H, hd) projected heads: batch over dp, heads over tp
    "heads": [["dp", "data", "pod"], [], ["tp"], []],
    # (B, S, ff) FFN intermediate: batch over dp, ff over tp
    "ffh": [["dp", "data", "pod"], [], ["tp"]],
    # (B, c, V) logits: batch over dp, vocab over tp
    "logits": [["dp", "data", "pod"], [], ["tp"]],
    # (E, C, d) / (E, C, ff) MoE expert buffers: experts over tp
    "experts": [["tp"], [], []],
    # (G, E, C, d|ff) grouped MoE dispatch buffers: groups over dp,
    # experts over tp
    "moe_buffer": [["dp", "data", "pod"], ["tp"], [], []],
    # (G, Tg, d) grouped token buffers
    "tokens_grouped": [["dp", "data", "pod"], [], []],
    # (B, KV, G, Sq, Tk) attention scores: kv-heads over tp, else the key
    # axis (context-parallel attention)
    "scores": [["dp", "data", "pod"], ["tp"], [], [], ["tp"]],
    # (B, H, Sq, Tk) merged-head scores (expanded-KV path): heads over tp
    "scores_h": [["dp", "data", "pod"], ["tp"], [], []],
    # (T, d) flat token buffers (MoE dispatch): tokens over dp
    "tokens_flat": [["dp", "data", "pod"], []],
}


# ---------------------------------------------------------------------------
# the ambient mesh
# ---------------------------------------------------------------------------

_MESH_STACK: list = []
_REGISTERED: list = []


def _mm_strategies(ndim: int) -> list:
    """``mm``'s single-axis strategies (``bmm``'s with the batch dim in
    front): (output placements, input placements) pairs."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    b = ndim - 2                  # leading batch dims: 0 for mm, 1 for bmm
    out = [([Replicate()], [Replicate(), Replicate(), None]),
           ([Shard(b)], [Shard(b), Replicate(), None]),
           ([Shard(b + 1)], [Replicate(), Shard(b + 1), None]),
           ([Partial()], [Shard(b + 1), Shard(b), None])]
    if b:
        out.append(([Shard(0)], [Shard(0), Shard(0), None]))
    return out


def register_strategies() -> None:
    """Give DTensor a sharding strategy for the ops on the models' path
    that have none: ``aten.mm.dtype`` / ``aten.bmm.dtype`` (the bf16
    product with an f32 result, ``models.common._Bf16DotF32``), the
    strategies of ``mm`` / ``bmm``.  Once a process."""
    if _REGISTERED:
        return
    import torch
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten
    for op, ndim in ((aten.mm.dtype, 2), (aten.bmm.dtype, 3)):
        register_sharding(op)(
            lambda a, b, out_dtype, _n=ndim: _mm_strategies(_n))
    _REGISTERED.append(True)


@contextlib.contextmanager
def set_mesh(mesh):
    """Install ``mesh`` (abstract or device) as this process's ambient
    mesh for the ``with`` block."""
    _MESH_STACK.append(mesh)
    try:
        if device_mesh() is None:
            yield mesh
        else:
            # plain tensors the models make (positions, masks, constants)
            # meet DTensors as replicated ones, as JAX's unsharded arrays
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            register_strategies()
            with implicit_replication():
                yield mesh
    finally:
        _MESH_STACK.pop()


def get_mesh():
    """The ambient mesh, or None outside any :func:`set_mesh` block."""
    return _MESH_STACK[-1] if _MESH_STACK else None


def dp_size() -> int:
    """Size of the ambient mesh's data-parallel axes (1 off-mesh)."""
    m = get_mesh()
    if m is None or not axis_names(m):
        return 1
    sh = mesh_shape(m)
    return math.prod(sh[a] for a in ("pod", "data") if a in sh)


def tp_size() -> int:
    """Size of the ambient mesh's model axis (1 off-mesh)."""
    m = get_mesh()
    if m is None or "model" not in axis_names(m):
        return 1
    return mesh_shape(m)["model"]


def device_mesh():
    """The ambient ``DeviceMesh`` of more than one device, else None."""
    m = get_mesh()
    if m is None or isinstance(m, AbstractMesh) or m.size() <= 1:
        return None
    return m


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: a tensor dim named by
    mesh axis ``a`` is ``Shard(dim)`` on ``a``'s mesh dim (a dim named by
    ``("pod", "data")`` on both, pod first); every other mesh dim
    ``Replicate()``, and so is an axis of one device (the same layout;
    DTensor's view rules refuse a size-1 dim sharded over a size-1
    axis)."""
    from torch.distributed.tensor import Replicate, Shard
    names, sizes = axis_names(mesh), mesh_shape(mesh)
    out = [Replicate()] * len(names)
    for dim, e in enumerate(spec):
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            if sizes[a] > 1:
                out[names.index(a)] = Shard(dim)
    return tuple(out)


def layout(mesh, *, data, model) -> tuple:
    """Placements over ``mesh``: ``data`` on the dp axes ("pod", "data"),
    ``model`` on "model", ``Replicate()`` on an axis of one device (as in
    :func:`placements`)."""
    from torch.distributed.tensor import Replicate
    sizes = mesh_shape(mesh)
    return tuple(Replicate() if sizes[a] == 1
                 else data if a in ("pod", "data") else model
                 for a in axis_names(mesh))


def local_block(t, mesh, want, grad=None):
    """This rank's block of ``t`` laid out as ``want`` (a plain tensor is
    taken as replicated), its gradient declared ``grad`` (default: the
    layout's): the entry to code that runs on each rank's block, as a
    ``shard_map`` body does."""
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(t.placements) != tuple(want):
        t = redistribute(t, want)
    return t.to_local(grad_placements=grad)


def zeros_on_mesh(shapes, specs, mesh, device):
    """A tree of zero DTensors on ``mesh``, each of a ``shapes`` leaf's
    global shape and dtype laid out by its spec in ``specs``: this rank
    allocates its block alone (JAX's zero caches placed by their
    shardings)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.tree import leaves, unflatten

    def one(t, spec):
        block = torch.zeros(shard_shape(tuple(t.shape), spec, mesh),
                            dtype=t.dtype, device=device)
        return DTensor.from_local(block, mesh, placements(spec, mesh),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return unflatten(shapes, [one(t, s) for t, s in zip(
        leaves(shapes),
        leaves(specs, is_leaf=lambda x: isinstance(x, Spec)))])


def _splittable(t, dim: int, lead: int):
    """``t`` laid out so that splitting dim ``dim`` into ``(lead, rest)``
    keeps its layout legal: a shard of that dim over mesh dims whose
    sizes do not divide ``lead`` (the heads of a flat (H * hd) product on
    a model axis wider than H) is replicated first, as JAX's partitioner
    reshards before such a reshape.  A plain tensor is returned as is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dim %= t.ndim
    want, k = list(t.placements), 1
    for i, p in enumerate(want):
        if isinstance(p, Shard) and p.dim == dim:
            m = t.device_mesh.size(i)
            if type(p) is Shard and lead % (k * m) == 0:
                k *= m
            else:
                want[i] = Replicate()
    return _redistributed(t, want)


def _redistributed(t, want):
    if list(want) == list(t.placements):
        return t
    return redistribute(t, want)


def redistribute(t, want):
    """``t.redistribute(t.device_mesh, want)``; from a partial sum (a
    lookup's masked partial too) through :class:`_Redistribute`, whose
    gradient rule is written out, so every torch version takes it."""
    if not any(p.is_partial() for p in t.placements):
        return t.redistribute(t.device_mesh, tuple(want))
    return _Redistribute.apply(t, tuple(want))


class _Redistribute(torch.autograd.Function):
    """DTensor's redistribution, with torch 2.13's rule for the gradient
    at a partial input written out: a gradient already in that partial
    layout stays so; any other is made replicated on that mesh dim.
    DTensor's own backward refuses to turn a sum-partial gradient into
    the masked partial of a vocab-split lookup
    (``torch.nn.functional.embedding``); the lookup's gradient is the
    replicated one."""

    @staticmethod
    def forward(ctx, t, want):
        ctx.src = tuple(t.placements)
        return t.redistribute(t.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        back = tuple(gp if gp == p else Replicate() if p.is_partial() else p
                     for p, gp in zip(ctx.src, g.placements))
        if back == tuple(g.placements):
            return g, None
        return g.redistribute(g.device_mesh, back), None


def _mesh_ready(t, shape):
    """``t`` laid out so that ``t.reshape(shape)`` is legal on its mesh:
    a dim split in two keeps the shards its leading factor divides
    (:func:`_splittable`); dims merged into one keep the outer dim's
    shards, the inner dims' are replicated."""
    from torch.distributed.tensor import Replicate, Shard
    src, dst = tuple(t.shape), tuple(shape)
    p = 0
    while p < min(len(src), len(dst)) and src[p] == dst[p]:
        p += 1
    q = 0
    while (q < min(len(src), len(dst)) - p
           and src[len(src) - 1 - q] == dst[len(dst) - 1 - q]):
        q += 1
    inner = range(p, len(src) - q)
    if len(inner) == 1 and len(dst) > len(src):
        return _splittable(t, p, dst[p])
    want = [Replicate() if isinstance(pl, Shard) and pl.dim in inner
            and (pl.dim != p or type(pl) is not Shard) else pl
            for pl in t.placements]
    return _redistributed(t, want)


def mesh_reshape(t, shape):
    """``t.reshape(shape)``.  On a device mesh the layout is made one
    that DTensor's view rules take and that leaves no strided shard
    behind (which its product rules refuse) first
    (:func:`_mesh_ready`), in the forward pass and for the gradient
    alike; a plain tensor reshapes as it would."""
    if not is_dtensor(t):
        return t.reshape(shape)
    shape = list(shape)
    if -1 in shape:
        shape[shape.index(-1)] = t.numel() // -math.prod(shape)
    return _MeshReshape.apply(t, tuple(shape))


class _MeshReshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shape):
        ctx.src = tuple(t.shape)
        return _mesh_ready(t, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _mesh_ready(g, ctx.src).reshape(ctx.src), None


def replicate(x):
    """``x`` replicated on the ambient device mesh; the identity with no
    device mesh or on a plain tensor (as :func:`constrain`)."""
    from torch.distributed.tensor import Replicate
    mesh = device_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    want = (Replicate(),) * mesh.ndim
    return x if tuple(x.placements) == want else redistribute(x, want)


def grad_in_layout(t):
    """``t`` for one use whose gradient comes back in ``t``'s own layout.
    A tied table has two uses, the lookup and the unembedding, and each
    sends back a gradient partial over a different axis (model, data);
    adding a partial to a shard needs the shard made partial, which
    torch 2.11 refuses ("redistribute from S(1) to P(sum)").  Laid out
    as the table first, the two add with no redistribution, as JAX's
    gradients come in their parameters' shardings."""
    if not is_dtensor(t):
        return t
    return _GradInLayout.apply(t)


class _GradInLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        ctx.placements = tuple(t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(g.device_mesh, ctx.placements)


def rowwise(fn, x, *weights):
    """``fn(x, *weights)`` for a function of each row of ``x`` alone (its
    last dim read whole: a norm) and of replicated DTensor ``weights``.
    On a device mesh each rank runs ``fn`` on its block of ``x``'s rows,
    forward and backward (a ``shard_map`` body): the gradient keeps a
    partial sum over a mesh dim that replicates ``x`` (the backward of a
    norm is linear in it) and takes ``x``'s shards on the others; a
    weight's gradient is partial over both kinds of dim.  This is the
    route torch 2.13's DTensor takes on its own; 2.11 moves the rows'
    gradient to a split of the last dim (an all-to-all of hidden states)
    to sum a weight's gradient.  With no device mesh, on a plain tensor
    or weight, or where ``x`` is partial or split along its last dim,
    ``fn`` runs on ``x`` as it is."""
    from torch.distributed.tensor import Shard
    if (device_mesh() is None or not is_dtensor(x)
            or not all(is_dtensor(w) for w in weights)
            or any(p.is_partial() or (isinstance(p, Shard)
                                      and p.dim % x.ndim == x.ndim - 1)
                   for p in x.placements)):
        return fn(x, *weights)
    return _Rowwise.apply(fn, x, *weights)


def _whole(w):
    from torch.distributed.tensor import Replicate
    return w.redistribute(w.device_mesh,
                          [Replicate()] * w.device_mesh.ndim).to_local()


class _Rowwise(torch.autograd.Function):
    """:func:`rowwise` on each rank's block; the backward runs ``fn``'s
    again on the block (saving only the inputs, as a remat unit does)."""

    @staticmethod
    def forward(ctx, fn, x, *weights):
        from torch.distributed.tensor import DTensor
        ctx.fn = fn
        ctx.save_for_backward(x, *weights)
        out = fn(x.to_local(), *(_whole(w) for w in weights))
        return DTensor.from_local(out, x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        x, *weights = ctx.saved_tensors
        mesh = x.device_mesh
        want = tuple(gp if p == Replicate() and gp.is_partial() else p
                     for p, gp in zip(x.placements, g.placements))
        if tuple(g.placements) != want:
            g = g.redistribute(mesh, want)
        with torch.enable_grad():
            xl = x.to_local().detach().requires_grad_()
            wl = [_whole(w).detach().requires_grad_() for w in weights]
            grads = torch.autograd.grad(ctx.fn(xl, *wl), [xl, *wl],
                                        g.to_local(), allow_unused=True)
        w_pl = tuple(Replicate() if p == Replicate() else Partial()
                     for p in want)
        # contiguous, as the DTensor made from it says it is
        return (None, DTensor.from_local(
            grads[0].contiguous(), mesh, want, run_check=False, shape=x.shape,
            stride=x.stride()), *(
            None if gw is None else DTensor.from_local(
                gw, mesh, w_pl, run_check=False, shape=w.shape,
                stride=w.stride()) for gw, w in zip(grads[1:], weights)))


def relayout(x, rule: str):
    """``x`` laid out by ``rule`` as :func:`constrain` lays it out, in the
    forward pass only: the gradient passes back in the layout it arrives
    in, as through an op's own redistribution of its inputs in DTensor
    (where :func:`constrain`'s is redistributed to ``x``'s layout, or
    made replicated for a partial ``x``).  Pins routes that DTensor's
    costs choose differently by torch version, each the one 2.13 takes:
    partial sums reduced into the rule's batch split before a nonlinear
    op (gemma2's capped logits, which 2.11 all-reduces whole; a decode
    step's Q, K and gate), and gemma3's one K head made whole before its
    norm, so that K's weight gradient is taken at full width (2.11 keeps
    it split over "model").  The identity where :func:`constrain` is."""
    want = _rule_placements(x, rule)
    if (want is None or tuple(x.placements) == want
            or sum(p.is_partial() for p in x.placements) > 1):
        # partial sums over two mesh dims (the multipod's "pod" and
        # "data"): DTensor's own route reduces the larger dim first and
        # the other on the reduced block, on both torch versions; no one
        # redistribution into the rule's layout takes it
        return x
    return _ForwardLayouts.apply(x, want)


def reduce_partial(x):
    """``x`` with the partial sums of each mesh dim that holds them reduced
    as a reduce-scatter and its all-gather, in the forward pass only (the
    gradient passes back as through :func:`relayout`): the route torch
    2.13's DTensor takes on its own for gemma's scaled lookup, where 2.11
    all-reduces them at the next :func:`constrain`.  The scatter splits
    the first dim that the mesh dim's ranks divide evenly, as DTensor
    does.  The identity with no device mesh, on a plain tensor or on one
    with no partial sums."""
    from torch.distributed.tensor import Replicate, Shard
    if device_mesh() is None or not is_dtensor(x):
        return x
    steps, at = [], list(x.placements)
    local = x.to_local().shape
    for i, p in enumerate(x.placements):
        if not p.is_partial():
            continue
        dim = next((d for d, n in enumerate(local)
                    if n % x.device_mesh.size(i) == 0), None)
        for q in ([] if dim is None else [Shard(dim)]) + [Replicate()]:
            at[i] = q
            steps.append(tuple(at))
    return _ForwardLayouts.apply(x, *steps) if steps else x


class _ForwardLayouts(torch.autograd.Function):
    """``t`` redistributed to each of ``layouts`` in turn, in the forward
    pass only: the gradient passes back as it arrives (:func:`relayout`,
    :func:`reduce_partial`)."""

    @staticmethod
    def forward(ctx, t, *layouts):
        ctx.n = len(layouts)
        for want in layouts:
            t = t.redistribute(t.device_mesh, want)
        return t

    @staticmethod
    def backward(ctx, g):
        return (g,) + (None,) * ctx.n


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, rule: str):
    """JAX's ``with_sharding_constraint`` against the ambient mesh: a
    DTensor is redistributed to the placements of its rule's spec.  The
    identity with no device mesh, on a world of one, or on a plain tensor
    (keeps model code mesh-agnostic: one device runs as it did)."""
    want = _rule_placements(x, rule)
    if want is None or tuple(x.placements) == want:
        return x
    return redistribute(x, want)


def _rule_placements(x, rule: str):
    """The placements ``rule`` gives ``x`` on the ambient device mesh, or
    None where :func:`constrain` is the identity."""
    mesh = device_mesh()
    if mesh is None or not is_dtensor(x):
        return None
    prefs = _ACT_RULES[rule]
    if len(prefs) != x.ndim:
        return None
    return placements(assign_spec(x.shape, prefs, mesh), mesh)
