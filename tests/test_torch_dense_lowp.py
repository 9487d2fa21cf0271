"""Port parity for the dense path in 16 bits: the min-plus sweep ops and
the fixpoint engines ``sssp_bellman`` / ``sssp_multisource`` on a
bfloat16 or float16 adjacency matrix — repro_torch (device="cpu", plain
paths) against the JAX package's Pallas kernels in interpret mode, bitwise.

Both packages take the labels' dtype from the matrix, and both round each
sum to 16 bits, so every comparison is of ``uint16`` bit patterns, with
``pred`` and ``sweeps`` equal.  The CUDA kernels instead add and take the
minimum in float32 and round the minimum once; the property test holds
that arithmetic, written out here in numpy, to the plain 16-bit version.
Inputs come from numpy seeds and are rounded to 16 bits by each package's
own conversion (the test checks they agree)."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from repro.core import bellman as JB
from repro.core import graph as JG
from repro.core import multisource as JM
from repro.kernels.sssp_relax import ops as j_ops
from repro_torch.core import bellman as TB
from repro_torch.core import multisource as TM
from repro_torch.kernels.sssp_relax import ops as t_ops
from repro_torch.kernels.sssp_relax import ref as t_ref

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, jnp.float16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # small tensors: intra-op threads only add contention under xdist
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def bits(x) -> np.ndarray:
    """The uint16 bit patterns of a 16-bit JAX array or torch tensor."""
    if isinstance(x, torch.Tensor):
        assert x.dtype in (torch.bfloat16, torch.float16)
        return x.view(torch.int16).numpy().view(np.uint16)
    x = np.asarray(x)
    assert x.dtype.itemsize == 2
    return x.view(np.uint16)


def pair(a: np.ndarray, kind: str):
    """``a`` (float32) in the 16-bit type of ``kind``, as a JAX array and a
    torch tensor with the same bits."""
    tdt, jdt = DTYPES[kind]
    j, t = jnp.asarray(a, jdt), torch.tensor(a).to(tdt)
    assert np.array_equal(bits(j), bits(t))
    return j, t


def mixed_dist(rng, n, hi=50.0, inf_frac=0.3):
    d = rng.uniform(0.0, hi, n).astype(np.float32)
    d[rng.random(n) < inf_frac] = np.inf
    return d


# ---------------------------------------------------------------------------
# the sweep ops against JAX's (Pallas interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", DTYPES)
@pytest.mark.parametrize("n", [64, 100, 257, 300])
def test_relax_sweep_16bit_bitwise_vs_jax(n, kind):
    adj = JG.random_graph(n, 4 * n, seed=n).adj
    rng = np.random.default_rng(n)
    (jd, td), (ja, ta) = pair(mixed_dist(rng, n), kind), pair(adj, kind)
    want = j_ops.relax_sweep(jd, ja, interpret=True)
    got = t_ops.relax_sweep(td, ta)
    assert got.dtype == td.dtype
    assert np.array_equal(bits(got), bits(want))
    f = rng.random(n) < 0.5
    want = j_ops.relax_sweep(jd, ja, jnp.asarray(f), interpret=True,
                             frontier_mode=True)
    got = t_ops.relax_sweep(td, ta, torch.tensor(f), frontier_mode=True)
    assert np.array_equal(bits(got), bits(want))


@pytest.mark.parametrize("kind", DTYPES)
@pytest.mark.parametrize("s", [1, 3, 8, 9])
@pytest.mark.parametrize("n", [64, 100, 257, 300])
def test_relax_sweep_multi_16bit_bitwise_vs_jax(n, s, kind):
    adj = JG.random_graph(n, 5 * n, seed=s * 100 + n).adj
    rng = np.random.default_rng(s)
    D = np.stack([mixed_dist(rng, n) for _ in range(s)])
    (jD, tD), (ja, ta) = pair(D, kind), pair(adj, kind)
    want = j_ops.relax_sweep_multi(jD, ja, interpret=True)
    got = t_ops.relax_sweep_multi(tD, ta)
    assert got.dtype == tD.dtype and got.shape == (s, n)
    assert np.array_equal(bits(got), bits(want))


@pytest.mark.parametrize("n", [257, 300])
def test_f16_sweeps_overflow_to_inf_as_jax(n):
    """float16 labels near 65504 and weights up to 2000: sums from 65520 up
    round to +inf in both packages, so a vertex labelled INF stays INF
    where its float32 minimum was finite."""
    adj = JG.random_graph(n, 4 * n, seed=n).adj * np.float32(20.0)
    rng = np.random.default_rng(n)
    d = np.float32(64000.0) + mixed_dist(rng, n, hi=1500.0)
    (jd, td), (ja, ta) = pair(d, "f16"), pair(adj, "f16")
    want = j_ops.relax_sweep(jd, ja, interpret=True)
    got = t_ops.relax_sweep(td, ta)
    assert np.array_equal(bits(got), bits(want))
    cand = (td.float()[:, None] + ta.float()).amin(dim=0)
    assert (torch.isinf(td) & torch.isinf(got) & torch.isfinite(cand)).any()
    D = np.stack([d, d[::-1], np.roll(d, 7)])
    (jD, tD) = pair(D, "f16")
    assert np.array_equal(bits(t_ops.relax_sweep_multi(tD, ta)),
                          bits(j_ops.relax_sweep_multi(jD, ja,
                                                       interpret=True)))


# ---------------------------------------------------------------------------
# the fixpoint engines against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_frontier", [False, True],
                         ids=["full", "frontier"])
@pytest.mark.parametrize("kind", DTYPES)
@pytest.mark.parametrize("n,m", [(100, 300), (257, 1000)])
def test_sssp_bellman_16bit_matches_jax(n, m, kind, use_frontier):
    ja, ta = pair(JG.random_graph(n, m, seed=n + m).adj, kind)
    jd, jp, js = JB.sssp_bellman(ja, jnp.int32(0),
                                 sweep_fn=j_ops.make_sweep_fn(interpret=True),
                                 use_frontier=use_frontier)
    assert jd.dtype == ja.dtype
    for sweep in (t_ops.make_sweep_fn(), None):
        td, tp, ts = TB.sssp_bellman(ta, 0, sweep_fn=sweep,
                                     use_frontier=use_frontier)
        assert td.dtype == ta.dtype
        assert np.array_equal(bits(td), bits(jd))
        assert np.array_equal(tp.numpy(), np.asarray(jp))
        assert ts == int(js)


@pytest.mark.parametrize("kind", DTYPES)
@pytest.mark.parametrize("n,m", [(100, 300), (257, 1000)])
def test_sssp_multisource_16bit_matches_jax(n, m, kind):
    ja, ta = pair(JG.random_graph(n, m, seed=n + m).adj, kind)
    srcs = np.array([0, 7, n // 2, n - 1], np.int32)
    jD, js = JM.sssp_multisource(ja, jnp.asarray(srcs),
                                 sweep_fn=_j_multi_interpret)
    assert jD.dtype == ja.dtype
    for sweep in (t_ops.relax_sweep_multi, None):
        tD, ts = TM.sssp_multisource(ta, torch.tensor(srcs), sweep_fn=sweep)
        assert tD.dtype == ta.dtype
        assert np.array_equal(bits(tD), bits(jD))
        assert ts == int(js)


def _j_multi_interpret(D, adj):
    return j_ops.relax_sweep_multi(D, adj, interpret=True)


# ---------------------------------------------------------------------------
# the kernels' arithmetic against the plain 16-bit version
# ---------------------------------------------------------------------------

def round_once(x: np.ndarray, kind: str) -> np.ndarray:
    """float32 ``x`` (no NaN) rounded to nearest even in 16 bits: the
    uint16 patterns.  bfloat16 keeps the top 16 bits of float32, rounded
    on the 16 dropped; float16 by numpy's correctly rounded conversion
    (past 65504 it rounds to +inf)."""
    if kind == "f16":
        with np.errstate(over="ignore"):
            return x.astype(np.float16).view(np.uint16)
    b = x.view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def model_sweep(d32: np.ndarray, a32: np.ndarray, kind: str,
                rows: np.ndarray | None = None) -> np.ndarray:
    """The kernels' arithmetic: float32 adds, the float32 minimum with the
    self-distance, one rounding.  d32 (S, n) and a32 (n, n) hold 16-bit
    values widened to float32; ``rows`` (n,) bool, where given, is the
    frontier whose rows relax."""
    src = d32 if rows is None else np.where(rows, d32, np.float32(np.inf))
    cand = np.min(src[:, :, None] + a32[None, :, :], axis=1)
    return round_once(np.minimum(d32, cand), kind)


LABEL = st.one_of(st.just(np.inf), st.floats(0.0, 7.0e4, width=32).map(abs))
WEIGHT = st.one_of(st.just(np.inf), st.floats(0.0, 3.0e3, width=32).map(abs))


@settings(max_examples=60, deadline=None)
@given(kind=st.sampled_from(sorted(DTYPES)), n=st.integers(1, 24),
       s=st.integers(1, 4), data=st.data())
def test_kernel_arithmetic_equals_plain_16bit(kind, n, s, data):
    """Random labels and weights with INF, drawn up to past float16's
    range: the matvec, the frontier-masked matvec and the matmul."""
    D = np.array(data.draw(st.lists(LABEL, min_size=s * n, max_size=s * n)),
                 np.float32).reshape(s, n)
    adj = np.array(data.draw(st.lists(WEIGHT, min_size=n * n,
                                      max_size=n * n)),
                   np.float32).reshape(n, n)
    np.fill_diagonal(adj, 0.0)
    tD, ta = (torch.tensor(x).to(DTYPES[kind][0]) for x in (D, adj))
    d32, a32 = tD.float().numpy(), ta.float().numpy()
    want = model_sweep(d32, a32, kind)
    assert np.array_equal(bits(t_ref.relax_sweep_multi_ref(tD, ta)), want)
    assert np.array_equal(bits(t_ref.relax_sweep_ref(tD[0], ta)), want[0])
    f = np.arange(n) % 2 == 0
    assert np.array_equal(
        bits(t_ref.relax_sweep_frontier_ref(tD[0], torch.tensor(f), ta)),
        model_sweep(d32[:1], a32, kind, f)[0])


@settings(max_examples=60, deadline=None)
@given(kind=st.sampled_from(sorted(DTYPES)), n=st.integers(1, 24),
       data=st.data())
def test_partial_minima_over_row_ranges_equal_plain_16bit(kind, n, data):
    """The matvec kernels' work list: a block folds a contiguous range of
    rows (its items) in float32, rounds the range's minimum once to 16
    bits and lowers ``out`` (a copy of dist) by the min of the bit
    patterns.  Over any cut of the rows into ranges, with all-INF ranges,
    empty frontiers and float16 sums past 65504, that equals the plain
    sweep and the plain frontier sweep."""
    d = np.array(data.draw(st.lists(LABEL, min_size=n, max_size=n)),
                 np.float32)
    adj = np.array(data.draw(st.lists(WEIGHT, min_size=n * n,
                                      max_size=n * n)),
                   np.float32).reshape(n, n)
    np.fill_diagonal(adj, 0.0)
    cuts = data.draw(st.lists(st.integers(1, max(1, n - 1)), max_size=6))
    bounds = [0, *sorted(set(c for c in cuts if c < n)), n]
    ranges = list(zip(bounds[:-1], bounds[1:]))
    lo, hi = ranges[data.draw(st.integers(0, len(ranges) - 1))]
    if data.draw(st.booleans()):
        d[lo:hi] = np.inf                     # a range with no live row
    frontier = np.array(data.draw(st.one_of(
        st.just([False] * n),
        st.lists(st.booleans(), min_size=n, max_size=n))))
    tdt = DTYPES[kind][0]
    td, ta = torch.tensor(d).to(tdt), torch.tensor(adj).to(tdt)
    d32, a32 = td.float().numpy(), ta.float().numpy()

    def by_ranges(rows):
        out = bits(td).copy()
        src = np.where(rows & np.isfinite(d32), d32, np.float32(np.inf))
        for r0, r1 in ranges:
            part = np.min(src[r0:r1, None] + a32[r0:r1], axis=0)
            out = np.minimum(out, round_once(part, kind))
        return out

    assert np.array_equal(bits(t_ref.relax_sweep_ref(td, ta)),
                          by_ranges(np.ones(n, bool)))
    assert np.array_equal(
        bits(t_ref.relax_sweep_frontier_ref(td, torch.tensor(frontier), ta)),
        by_ranges(frontier))
