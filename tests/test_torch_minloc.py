"""The port's MINLOC collectives (repro_torch/core/sharded.py), held to the
cases of tests/test_minloc.py: the bit-pattern order the packed variant
relies on, the index packing bounds, the P = 1 roundtrip of extreme values
(against JAX's own three variants too), and the cross-rank tie-breaks at
P = 4 against the plain reference.

Each P runs in ONE spawned gloo group (core/_dist.spawn, file store under
``tmp_path``) that takes every case; the tests read its results.
"""
import numpy as np
import pytest
import torch

from repro_torch.core._dist import spawn
from repro_torch.core.sharded import (INT32_MAX, _MINLOC, _U32_MAX,
                                      minloc_packed)

VARIANTS = tuple(_MINLOC)
F32_MAX = float(np.finfo(np.float32).max)
P1_CASES = [(0.0, 0), (3.5, 7), (1e-38, INT32_MAX), (F32_MAX, INT32_MAX),
            (float("inf"), INT32_MAX)]
# tests/test_minloc.py's cross-device cases
P4_CASES = [
    ([5.0, 5.0, 5.0, 7.0], [9, 3, INT32_MAX, 1]),
    ([5.0, 5.0, 5.0, 5.0], [INT32_MAX, INT32_MAX - 1, 4, 4]),
    ([2.0, 2.0, 3.0, 2.0], [INT32_MAX, INT32_MAX - 7, 2**30, INT32_MAX - 7]),
    ([float("inf"), 8.0, float("inf"), 8.0], [0, INT32_MAX, 1, 5]),
    ([float("inf")] * 4, [INT32_MAX, 7, INT32_MAX, 9]),
    ([0.0, float(np.finfo(np.float32).tiny), 1.0, 0.0], [8, 0, 1, 2]),
]
TIMEOUT = 120


def _minloc_rank(group, cases):
    """Every case through every variant on this rank: case i gives this
    rank the candidate ``(ds[rank], idxs[rank])``."""
    out = {}
    for i, (ds, idxs) in enumerate(cases):
        d = torch.tensor(ds[group.rank], dtype=torch.float32)
        idx = torch.tensor(idxs[group.rank], dtype=torch.int64)
        for name, fn in _MINLOC.items():
            best, bi = fn(d, idx, group)
            out[name, i] = (float(best), int(bi), best.dtype)
    return out


@pytest.fixture(scope="module")
def p1(tmp_path_factory):
    cases = [([d], [i]) for d, i in P1_CASES]
    return spawn(_minloc_rank, 1, backend="gloo", timeout=TIMEOUT,
                 store_dir=tmp_path_factory.mktemp("minloc1"),
                 args=(cases,))[0]


@pytest.fixture(scope="module")
def p4(tmp_path_factory):
    return spawn(_minloc_rank, 4, backend="gloo", timeout=TIMEOUT,
                 store_dir=tmp_path_factory.mktemp("minloc4"),
                 args=(P4_CASES,))


def _reference(ds, idxs):
    ds = np.float32(ds)
    best = ds.min()
    return best, min(i for d, i in zip(ds, idxs) if d == best)


def _same_f32(a, b):
    return np.float32(a).tobytes() == np.float32(b).tobytes()


def test_f32_bit_pattern_order_matches_float_order_in_int64():
    """The packed variant's invariant as the port carries it: u32 bit
    patterns in int64 sort non-negative f32 (INF and the largest finite
    included) as the floats sort."""
    rng = np.random.default_rng(0)
    d = np.concatenate([
        rng.uniform(0, 1e30, 500).astype(np.float32),
        np.float32([0.0, np.inf, F32_MAX, np.finfo(np.float32).tiny, 1e-38,
                    3.0, 3.0]),
    ])
    t = torch.tensor(d)
    bits = t.view(torch.int32).long() & _U32_MAX
    assert torch.equal(t[torch.argsort(bits, stable=True)],
                       t[torch.argsort(t, stable=True)])


def test_index_packing_bounds_at_large_n():
    """The largest int32 vertex id stays below the 0xFFFFFFFF sentinel in
    the int64 payload, so the sentinel loses to it."""
    idx = torch.tensor(INT32_MAX, dtype=torch.int64)
    assert int(idx) < _U32_MAX
    assert int(torch.where(torch.tensor(False), _U32_MAX, idx)) == INT32_MAX
    assert int(torch.minimum(idx, torch.tensor(_U32_MAX))) == INT32_MAX


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", range(len(P1_CASES)))
def test_minloc_p1_roundtrip_exact(p1, variant, case):
    """The P = 1 collective roundtrip returns the exact distance bits and
    index, +inf and extreme magnitudes included."""
    d, idx = P1_CASES[case]
    best, bi, dtype = p1[variant, case]
    assert dtype == torch.float32
    assert _same_f32(best, d) and bi == idx


@pytest.mark.parametrize("variant", VARIANTS)
def test_minloc_p1_matches_jax(p1, variant):
    """The same P = 1 cases through JAX's own variant (one-device mesh)."""
    import functools

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import sharded as JS
    from repro.core._compat import make_mesh, shard_map

    mesh = make_mesh((1,), ("data",))
    fn = getattr(JS, f"minloc_{variant}")

    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P()),
                       out_specs=(P(), P()), check_vma=False)
    def run(d, i):
        best, bi = fn(d[0], i[0], "data")
        return best[None], bi[None]

    for case, (d, idx) in enumerate(P1_CASES):
        jb, ji = run(jnp.float32([d]), jnp.int32([idx]))
        best, bi, _ = p1[variant, case]
        assert _same_f32(best, np.asarray(jb)[0]) and bi == int(ji[0])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", range(len(P4_CASES)))
def test_minloc_tiebreak_p4_matches_reference(p4, variant, case):
    """Cross-rank ties go to the smallest index, INF candidates lose to
    any finite one, and every rank gets the same answer."""
    rb, ri = _reference(*P4_CASES[case])
    got = {r[variant, case][:2] for r in p4}
    assert len(got) == 1
    best, bi = got.pop()
    assert _same_f32(best, rb) and bi == ri


class _Alone:
    """A one-rank stand-in for a ShardGroup: all-gather is the identity."""

    size = 1

    def all_gather(self, t, dim=0):
        return t.clone()


def test_minloc_packed_sentinel_loses_to_int32_max_index():
    """An all-unreachable candidate (INF, INT32_MAX) comes back as is: the
    0xFFFFFFFF sentinel never wins the index min."""
    best, bi = minloc_packed(torch.tensor(float("inf")),
                             torch.tensor(INT32_MAX), _Alone())
    assert torch.isinf(best) and int(bi) == INT32_MAX
