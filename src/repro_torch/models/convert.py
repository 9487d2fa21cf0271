"""Parameters carried over from the JAX package.

``from_jax_params(tree, cfg, device)`` takes the JAX package's parameter
pytree as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns
the port's parameters: each segment's stacked reps unstacked into the
port's flat layer order (:func:`repro_torch.models.transformer.layer_kinds`),
for ``segments`` and ``enc_segments`` alike.  A tree whose leaves or
shapes differ from what ``cfg`` gives is refused, leaf by leaf.  Dtypes
are kept unless ``dtype`` is given.  This is the only path from JAX's
parameters into the port's models (torch cannot replay JAX's PRNG).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import resolve_device
from repro_torch.models import transformer as T


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


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
            layers += [_map(lambda a: np.asarray(a[r]), seg[i])
                       for i in range(len(pat))]
    return layers


def _tensor(a, device, dtype):
    a = np.array(a)                                   # a writable copy
    if a.dtype.name == "bfloat16":                    # ml_dtypes' bfloat16
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def from_jax_params(tree, cfg, device="cuda", dtype=None) -> dict:
    """The port's parameters from JAX's numpy pytree (see the module)."""
    dev = resolve_device(device)
    want = dict(_flatten(T.init_params(cfg, device="meta")))
    port = {k: tree[k] for k in ("embed", "final_ln", "lm_head",
                                  "enc_final_ln") if k in tree}
    port["layers"] = _unstack(tree.get("segments", ()), cfg.segments,
                              "segments")
    if cfg.encoder_segments or "enc_segments" in tree:
        port["enc_layers"] = _unstack(tree.get("enc_segments", ()),
                                      cfg.encoder_segments, "enc_segments")
    extra = sorted(set(tree) - set(port) - {"segments", "enc_segments"})
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
    return _map(lambda a: _tensor(a, dev, dtype), port)
