"""The one general traffic generator: every mix in ``traffic/<mix>.json``
is parameters for it.

``"kind": "solve"`` — a closed loop of single-source solves, one client,
from ``roots`` roots in turn.  The configuration's ``root_draw`` says how
the seed draws them: ``"degree1"`` uniform without replacement among the
vertices of degree >= 1 (Graph500's rule).
"""
from __future__ import annotations

import numpy as np

KINDS = ("solve",)


def _pool(degree: np.ndarray, labels) -> np.ndarray:
    """The vertices of degree >= 1, in the order of the drawn structure
    (``labels``: drawn vertex -> this run's label; None: the identity)."""
    if labels is None:
        return np.flatnonzero(degree > 0)
    return labels[np.flatnonzero(degree[labels] > 0)]


def solve_roots(mix: dict, config: dict, degree: np.ndarray,
                seed: int, labels=None) -> np.ndarray:
    """The roots of a ``solve`` mix, in the order the loop sends them."""
    draw = config.get("root_draw", "degree1")
    if draw != "degree1":
        raise ValueError(f"unknown root draw {draw!r}")
    rng = np.random.default_rng(seed)
    pool = _pool(degree, labels)
    return rng.choice(pool, size=min(int(mix["roots"]), pool.size),
                      replace=False)
