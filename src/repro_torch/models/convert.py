"""Parameters carried between the JAX package's layout and the port's.

``from_jax_params(tree, cfg, device)`` takes a parameter tree in JAX's
layout (``jax.tree.map(np.asarray, params)``, or tensors, as a
checkpoint restores them) and returns the port's parameters: each
segment's stacked reps unstacked into the port's flat layer order
(:func:`repro_torch.models.transformer.layer_kinds`), for ``segments``
and ``enc_segments`` alike; the top-level leaves (``embed``, the final
norms, ``lm_head``, Zamba2's ``shared`` block) as they are.  A tree whose
leaves or shapes differ from what ``cfg`` gives is refused, leaf by leaf.
Dtypes are kept unless ``dtype`` is given.  This is the only path from
JAX's parameters into the port's models (torch cannot replay JAX's PRNG).

``to_jax_layout(params, cfg)`` is its inverse: the flat layers restacked
into ``segments[si][i]`` trees with a leading ``(n_rep, ...)`` axis.  It
serves any tree of the parameters' structure (the optimizer's moments
too), which is what a checkpoint stores.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.tree import tree_map

#: top-level entries that are the same in both layouts
_TOP = ("embed", "final_ln", "lm_head", "enc_final_ln", "shared")
#: stacked JAX entry -> the port's flat one
_STACKS = (("segments", "layers", "segments"),
           ("enc_segments", "enc_layers", "encoder_segments"))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _unstack(seg_trees, segments, name):
    """Segment trees (one stacked tree a pattern position) -> flat layers."""
    if len(seg_trees) != len(segments):
        raise ValueError(f"{name}: {len(seg_trees)} segments, the config "
                         f"has {len(segments)}")
    layers = []
    for si, (seg, (pat, rep)) in enumerate(zip(seg_trees, segments)):
        if len(seg) != len(pat):
            raise ValueError(f"{name}/{si}: {len(seg)} pattern positions, "
                             f"the config's pattern is {pat!r}")
        for i, stacked in enumerate(seg):
            for path, a in _flatten(stacked, f"{name}/{si}/{i}"):
                if np.ndim(a) == 0 or np.shape(a)[0] != rep:
                    raise ValueError(f"{path}: shape {np.shape(a)} is not "
                                     f"stacked over the segment's {rep} reps")
        for r in range(rep):
            layers += [tree_map(lambda a: a[r], seg[i])
                       for i in range(len(pat))]
    return layers


def _tensor(a, device, dtype):
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.array(a)                               # a writable copy
        if a.dtype.name == "bfloat16":                # ml_dtypes' bfloat16
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def from_jax_params(tree, cfg, device="cuda", dtype=None) -> dict:
    """The port's parameters from a tree in JAX's layout (see the module)."""
    dev = resolve_device(device)
    want = dict(_flatten(T.init_params(cfg, device="meta")))
    port = {k: tree[k] for k in _TOP if k in tree}
    for jax_name, name, attr in _STACKS:
        if getattr(cfg, attr) or jax_name in tree:
            port[name] = _unstack(tree.get(jax_name, ()), getattr(cfg, attr),
                                  jax_name)
    extra = sorted(set(tree) - set(port) - {j for j, _, _ in _STACKS})
    got = dict(_flatten(port))
    missing = sorted(set(want) - set(got))
    extra += sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{cfg.name}: the tree has {len(got)} leaves, the "
                         f"config {len(want)}; missing {missing[:8]}, "
                         f"unexpected {extra[:8]}")
    for path, t in want.items():
        if tuple(np.shape(got[path])) != tuple(t.shape):
            raise ValueError(f"{cfg.name}: {path} has shape "
                             f"{tuple(np.shape(got[path]))}, the config "
                             f"gives {tuple(t.shape)}")
    return tree_map(lambda a: _tensor(a, dev, dtype), port)


def _restack(layers, segments) -> tuple:
    out, base = [], 0
    for pat, rep in segments:
        seg = []
        for i in range(len(pat)):
            reps = [layers[base + r * len(pat) + i] for r in range(rep)]
            seg.append(tree_map(lambda *ts: torch.stack(ts), *reps))
        out.append(tuple(seg))
        base += rep * len(pat)
    if base != len(layers):
        raise ValueError(f"{len(layers)} layers, the segments hold {base}")
    return tuple(out)


def to_jax_layout(params, cfg) -> dict:
    """``params`` (or any tree of their structure) in JAX's stacked
    layout: ``segments[si][i]`` with leading ``(n_rep, ...)``."""
    tree = {k: params[k] for k in _TOP if k in params}
    for jax_name, name, attr in _STACKS:
        if name in params:
            tree[jax_name] = _restack(params[name], getattr(cfg, attr))
    return tree
