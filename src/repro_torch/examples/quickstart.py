"""Quickstart: the paper's SSSP engines and a tiny LM through the public
API, in seconds — the port of the JAX package's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``serial`` (Alg. 1), ``bellman`` (Alg. 3/4) and ``bellman_kernel`` (the
min-plus matvec kernel on CUDA) on one graph, then ``multisource``; every
distance row is checked bitwise against ``serial``'s.  Then gemma3-1b at
smoke width: one ``train_loss``, a ``prefill`` and 5 greedy
``decode_step``s.  Returns the distances by engine.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> dict:
    import torch

    from repro_torch.configs import get_config, make_smoke
    from repro_torch.core import graph as G
    from repro_torch.core.api import resolve_device, shortest_paths
    from repro_torch.models import transformer as T

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. SSSP: serial (Alg.1), fixpoint (Alg.3/4), CUDA kernel --------
    g = G.random_graph(500, 1500, seed=0)
    print(f"graph: {g.n} vertices, {g.num_edges} edges, on {dev}")

    dists = {}
    for engine in ("serial", "bellman", "bellman_kernel"):
        res = shortest_paths(g, source=0, engine=engine, device=dev)
        reached = int(np.isfinite(res.dist).sum())
        extra = f", {res.sweeps} sweeps" if res.sweeps is not None else ""
        print(f"  {engine:16s}: reached {reached}/{g.n}{extra}; max dist "
              f"{np.nanmax(np.where(np.isfinite(res.dist), res.dist, np.nan)):.2f}")
        dists[engine] = res.dist

    # --- 2. multi-source batching (beyond-paper) --------------------------
    sources = np.array([0, 7, 99])
    res = shortest_paths(g, sources, engine="multisource", device=dev)
    print(f"  multisource     : dist matrix {res.dist.shape}, "
          f"{res.sweeps} sweeps")
    dists["multisource"] = res.dist

    for engine in ("bellman", "bellman_kernel"):
        if dists[engine].tobytes() != dists["serial"].tobytes():
            raise SystemExit(f"quickstart: {engine} differs from serial")
    for i, s in enumerate(sources):
        ref = shortest_paths(g, int(s), engine="serial", device=dev).dist
        if res.dist[i].tobytes() != ref.tobytes():
            raise SystemExit(f"quickstart: multisource row {s} differs "
                             f"from serial")
    print("  every row bitwise equal to serial's")

    # --- 3. a model from the assigned-architecture zoo --------------------
    cfg = make_smoke(get_config("gemma3-1b"))
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32))).to(dev)
    loss, metrics = T.train_loss(params, {"tokens": tokens,
                                          "labels": tokens}, cfg)
    print(f"\n{cfg.name}: one train-loss eval = {float(loss):.3f}")

    logits, caches, pos = T.prefill(params, tokens, cfg, max_len=40)
    tok = torch.argmax(logits, -1)[:, None]
    for _ in range(5):
        logits, caches, pos = T.decode_step(params, tok, pos, caches, cfg)
        tok = torch.argmax(logits, -1)[:, None]
    print(f"decoded 5 tokens, cache pos now {pos.cpu().numpy()}")
    if not (torch.isfinite(loss) and torch.isfinite(logits).all()):
        raise SystemExit("quickstart: the LM gave non-finite values")
    print("\nquickstart OK")
    return dists


if __name__ == "__main__":
    main()
