"""The CUDA kernels on the card: each against its plain PyTorch version,
bitwise, and the kernel engines on the GPU against the CPU path.  The
dense kernels run at n in {1, 37, 255, 4097} and S in {1, 3, 8, 9}, and
relax_matmul also at n = 1025 to 1028 (every residue mod 4) and S in
{1, 7, 8, 9, 17} with all-INF rows and tiles, so ragged tails, u-split
boundaries and ragged source tiles are covered, all of it also in
bfloat16 and float16 (float16 also with sums past its largest finite
value), and the bfloat16 fixpoints through the kernels against the plain
sweeps.  The two matvecs also run in all three dtypes at n = 2048 to
2055 (every residue mod 8 at a column-block boundary), at n = 16392 and
16393 (tall row tiles, ragged edges), on a contiguous adj view
that is not 16-byte aligned, with frontiers of no row, one row, half and
every row, with all-INF labels and at n below one tile.  The CSR pull
kernels and
the frontier push at every lane-group width, on graphs with rows that
their whole-warp path takes.  The LMs' smoke configs on the card against
the CPU, f32 without TF32, within 1e-4: forward, logits, prefill + decode
and (MoE and Mamba2 archs) one ``train_loss`` gradient, each leaf's max
error relative to its largest entry; and training steps on the card
repeat bitwise (the restart replay's premise).

Marked ``cuda``; every test skips without a CUDA GPU.  On a machine with
one:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import csr as TC
from repro_torch.core import frontier as TF
from repro_torch.core import graph as TG
from repro_torch.core.api import shortest_paths
from repro_torch.kernels import common
from repro_torch.kernels.bucket_relax.kernel import bucket_relax
from repro_torch.kernels.bucket_relax.ref import (bucket_relax_csr_ref,
                                                  bucket_relax_ref)
from repro_torch.kernels.csr_relax.kernel import ell_relax
from repro_torch.kernels.csr_relax.ref import (ell_relax_csr_ref,
                                               ell_relax_ref)
from repro_torch.kernels.frontier_relax.kernel import frontier_relax
from repro_torch.kernels.frontier_relax.ref import frontier_relax_ref
from repro_torch.kernels.sssp_relax.kernel import (relax_matmul, relax_matvec,
                                                   relax_matvec_frontier)
from repro_torch.kernels.sssp_relax.ref import (relax_sweep_frontier_ref,
                                                relax_sweep_multi_ref,
                                                relax_sweep_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _bits(a, b):
    view = torch.int32 if a.element_size() == 4 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def _dist(n, seed, device):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 1000, n).astype(np.float32)
    d[rng.random(n) < 0.3] = np.inf
    return torch.tensor(d, device=device)


def _csr(indptr, indices, weights, device):
    return (torch.tensor(np.asarray(indptr, np.int32), device=device),
            torch.tensor(indices, device=device),
            torch.tensor(weights, device=device))


@pytest.mark.parametrize("n", [20, 255, 100_001])
def test_ell_and_bucket_kernels_bitwise_vs_plain(cuda, n):
    """Both CSR pull kernels against their plain CSR versions and the ELL
    plain versions.  Hub graphs: at n = 100_001 the 16 hubs have rows of
    more than 256 in-arcs, which the kernels give to a whole warp."""
    cg = TC.skewed_hub_csr_graph(n, seed=n)
    if n > 100_000:
        assert int(np.diff(cg.indptr).max()) > 256
    csr = _csr(cg.indptr, cg.indices, cg.weights, cuda)
    idx, w = (torch.tensor(a, device=cuda) for a in cg.ell())
    d = _dist(cg.n, n, cuda)
    before = ell_relax.launches
    got = ell_relax(d, *csr)
    assert ell_relax.launches == before + 1
    assert _bits(got, ell_relax_csr_ref(d, *csr))
    assert _bits(got, ell_relax_ref(d, idx, w))
    for hi in (0.0, 500.0, float("inf")):
        h = torch.tensor(hi, device=cuda)
        (a, ga), (b, gb) = bucket_relax(d, *csr, h), bucket_relax_csr_ref(
            d, *csr, h)
        assert _bits(a, b) and bool(ga) == bool(gb)
        c, gc = bucket_relax_ref(d, idx, w, h)
        assert _bits(a, c) and bool(ga) == bool(gc)


def _random_csr(n, mean, seed):
    """A random CSR of n rows whose mean degree is ``mean``, 8 of its rows
    with 300 to 600 arcs (more than the kernels' 32-arc long-row cut)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 2 * mean + 1, n)
    deg[rng.choice(n, 8, replace=False)] = rng.integers(300, 601, 8)
    deg = np.maximum(deg - (deg.sum() - int(mean * n)) // n, 0)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    m = int(indptr[-1])
    return (indptr, rng.integers(0, n, m).astype(np.int32),
            rng.uniform(0.5, 100.0, m).astype(np.float32))


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
def test_csr_pull_kernels_every_lane_group(cuda, group):
    """Every lane-group width the kernels take, each picked by the
    wrappers from a graph whose mean degree selects it; every graph has
    rows longer than 32 arcs, which the kernels give to a whole warp."""
    ip, src, w = _random_csr(20_011, 1.5 * group, seed=group)
    assert common.lane_group(ip.shape[0] - 1, src.shape[0]) == group
    assert int(np.diff(ip).max()) >= 300
    csr = _csr(ip, src, w, cuda)
    d = _dist(ip.shape[0] - 1, group, cuda)
    assert _bits(ell_relax(d, *csr), ell_relax_csr_ref(d, *csr))
    for hi in (0.0, 50.0, float("inf")):
        h = torch.tensor(hi, device=cuda)
        (a, ga), (b, gb) = bucket_relax(d, *csr, h), bucket_relax_csr_ref(
            d, *csr, h)
        assert _bits(a, b) and bool(ga) == bool(gb)


def _push_both(d, fids, ip, dst, w):
    """The in-place push by the kernel and by the plain version, each from
    ``d`` and an empty mask: ((labels, mask), (labels, mask))."""
    out = []
    for fn in (frontier_relax, frontier_relax_ref):
        got = d.clone()
        fell = torch.zeros(d.shape[0], dtype=torch.bool, device=d.device)
        assert fn(got, fids, ip, dst, w, fell) is fell
        out.append((got, fell))
    return out


def test_frontier_kernel_bitwise_vs_plain(cuda):
    cg = TC.skewed_hub_csr_graph(50_000, seed=3)
    ops = TF.frontier_operands(cg, device=cuda)
    d = _dist(cg.n, 3, cuda)
    for frac in (0.0, 0.01, 0.5):
        on = torch.tensor(np.random.default_rng(1).random(cg.n) < frac,
                          device=cuda)
        fids = torch.cat([torch.nonzero(on).flatten(),
                          torch.full((3,), cg.n, device=cuda)])
        before = frontier_relax.launches
        (a, fa), (b, fb) = _push_both(d, fids, ops["out_indptr"],
                                      ops["out_dst"], ops["out_w"])
        assert frontier_relax.launches == before + 1
        assert _bits(a, b) and torch.equal(fa, fb)
        assert torch.equal(fa, a < d)


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
def test_frontier_relax_every_lane_group(cuda, group):
    """The push at every lane-group width, each picked by the wrapper from
    an outgoing CSR whose mean degree selects it, with rows of 300 to 600
    arcs (the whole-warp path), isolated rows, INF frontier labels and
    compaction sentinels."""
    ip, dst, w = _random_csr(20_011, 1.5 * group, seed=group)
    n = ip.shape[0] - 1
    assert common.lane_group(n, dst.shape[0]) == group
    ip = np.concatenate([ip, ip[-1:]])          # the sentinel's empty row
    ip, dst, w = _csr(ip, dst, w, cuda)
    d = _dist(n, group, cuda)
    hubs = torch.nonzero(ip[1:n + 1] - ip[:n] > 32).flatten()
    assert hubs.numel() >= 8
    rng = np.random.default_rng(group)
    on = torch.tensor(rng.random(n) < 0.3, device=cuda)
    on[hubs] = True
    fids = torch.cat([torch.nonzero(on).flatten(),
                      torch.full((5,), n, device=cuda)])
    (a, fa), (b, fb) = _push_both(d, fids, ip, dst, w)
    assert _bits(a, b) and torch.equal(fa, fb)
    assert torch.equal(fa, a < d) and bool(fa.any())


@pytest.mark.parametrize("corpus", ["sparse", "road", "hub"])
def test_kernel_engines_on_gpu_match_cpu(cuda, corpus):
    make = {"sparse": TC.sparse_csr_graph, "road": TC.road_like_csr_graph,
            "hub": TC.skewed_hub_csr_graph}[corpus]
    cg = make(40_000, seed=5)
    for eng in ("bellman_csr_kernel", "frontier_kernel",
                "delta_stepping_kernel"):
        g = shortest_paths(cg, 0, engine=eng, device=cuda)
        c = shortest_paths(cg, 0, engine=eng, device="cpu")
        assert g.dist.tobytes() == c.dist.tobytes()
        assert np.array_equal(g.pred, c.pred)
        assert (g.sweeps, g.edges_relaxed) == (c.sweeps, c.edges_relaxed)


@pytest.mark.parametrize("n", [1, 37, 255, 4097])
def test_dense_kernels_bitwise_vs_plain(cuda, n):
    adj = torch.tensor(TG.random_graph(n, 4 * n, seed=n).adj, device=cuda)
    d = _dist(n, n, cuda)
    before = relax_matvec.launches
    assert _bits(relax_matvec(d, adj), relax_sweep_ref(d, adj))
    assert relax_matvec.launches == before + 1
    on = torch.tensor(np.random.default_rng(n).random(n) < 0.5, device=cuda)
    got = relax_matvec_frontier(d, on, adj)
    assert _bits(got, relax_sweep_frontier_ref(d, on, adj))
    masked = torch.where(on, d, torch.inf)
    assert _bits(got, torch.minimum(d, relax_matvec(masked, adj)))
    for S in (1, 3, 8, 9):
        D = torch.stack([_dist(n, n + s, cuda) for s in range(S)])
        assert _bits(relax_matmul(D, adj), relax_sweep_multi_ref(D, adj))


@pytest.mark.parametrize("n", [1025, 1026, 1027, 1028])
def test_relax_matmul_ragged_columns_sources_and_inf_tiles(cuda, n):
    """relax_matmul at n = 1, 2, 3 and 0 mod 4 (the 16-byte loads need
    n % 4 == 0; other n take the scalar loads), at S = 1, 7, 8, 9 and 17
    (ragged source tiles), with the first 300 rows INF for every source
    (the compaction drops them) and, at S = 17, a whole tile of 8 INF
    sources."""
    adj = torch.tensor(TG.random_graph(n, 6 * n, seed=n).adj, device=cuda)
    for S in (1, 7, 8, 9, 17):
        D = torch.stack([_dist(n, 10 * n + s, cuda) for s in range(S)])
        D[:, :300] = torch.inf
        if S == 17:
            D[8:16] = torch.inf
        assert _bits(relax_matmul(D, adj), relax_sweep_multi_ref(D, adj))
    assert _bits(relax_matmul(torch.full((9, n), torch.inf, device=cuda),
                              adj), torch.full((9, n), torch.inf,
                                               device=cuda))


LOWP = [torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", LOWP, ids=["bf16", "f16"])
@pytest.mark.parametrize("n", [1, 37, 255, 4097, 1025, 1026, 1027, 1028])
def test_dense_kernels_16bit_bitwise_vs_plain(cuda, n, dtype):
    """The 16-bit instantiations of the three kernels against their plain
    versions (each sum rounded to 16 bits): odd n (rows 2-byte aligned),
    every residue of n mod 4 for relax_matmul's 8-byte loads, ragged
    source tiles, INF rows; each call counts one launch."""
    adj = torch.tensor(TG.random_graph(n, 4 * n, seed=n).adj,
                       device=cuda).to(dtype)
    d = _dist(n, n, cuda).to(dtype)
    counts = (relax_matvec.launches, relax_matvec_frontier.launches,
              relax_matmul.launches)
    assert _bits(relax_matvec(d, adj), relax_sweep_ref(d, adj))
    on = torch.tensor(np.random.default_rng(n).random(n) < 0.5, device=cuda)
    got = relax_matvec_frontier(d, on, adj)
    assert _bits(got, relax_sweep_frontier_ref(d, on, adj))
    for S in (1, 3, 8, 9, 17):
        D = torch.stack([_dist(n, n + s, cuda) for s in range(S)]).to(dtype)
        D[:, :n // 4] = torch.inf
        assert _bits(relax_matmul(D, adj), relax_sweep_multi_ref(D, adj))
    assert (relax_matvec.launches, relax_matvec_frontier.launches,
            relax_matmul.launches) == (counts[0] + 1, counts[1] + 1,
                                       counts[2] + 5)


def test_kernel_wrappers_launch_on_bf16_cuda_tensors(cuda):
    """A bfloat16 CUDA tensor launches each dense kernel once: the
    wrappers take 16-bit labels and matrix, and nothing falls back."""
    n = 300
    adj = torch.tensor(TG.random_graph(n, 4 * n, seed=1).adj,
                       device=cuda).to(torch.bfloat16)
    d = _dist(n, 1, cuda).to(torch.bfloat16)
    on = torch.arange(n, device=cuda) % 2 == 0
    for fn, args in ((relax_matvec, (d, adj)),
                     (relax_matvec_frontier, (d, on, adj)),
                     (relax_matmul, (torch.stack([d, d]), adj))):
        before = fn.launches
        assert fn(*args).dtype == torch.bfloat16
        assert fn.launches == before + 1


DENSE = [torch.float32, torch.bfloat16, torch.float16]


def _matvecs_bitwise(d, on, adj):
    """Both matvecs against their plain versions (the frontier one also
    against the masked relax_matvec), one launch a call."""
    counts = relax_matvec.launches, relax_matvec_frontier.launches
    assert _bits(relax_matvec(d, adj), relax_sweep_ref(d, adj))
    got = relax_matvec_frontier(d, on, adj)
    assert _bits(got, relax_sweep_frontier_ref(d, on, adj))
    assert (relax_matvec.launches, relax_matvec_frontier.launches) == (
        counts[0] + 1, counts[1] + 1)
    masked = torch.where(on, d, torch.inf)
    assert _bits(got, torch.minimum(d, relax_matvec(masked, adj)))


@pytest.mark.parametrize("dtype", DENSE, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", range(2048, 2056))
def test_matvecs_every_residue_mod_8_at_a_tile_boundary(cuda, n, dtype):
    """n = 2048 ... 2055: every residue of n mod 8 (the 16-byte loads need
    n % 8 == 0 in 16 bits, n % 4 == 0 in float32; other n take the
    scalar loads) where the columns cross a block of 2048 (16 bits) or
    1024 (float32) and the rows a tile (of 32 to 256 rows: the tiles
    shrink at small n)."""
    adj = torch.tensor(TG.random_graph(n, 4 * n, seed=n).adj,
                       device=cuda).to(dtype)
    d = _dist(n, n, cuda).to(dtype)
    on = torch.tensor(np.random.default_rng(n).random(n) < 0.5, device=cuda)
    _matvecs_bitwise(d, on, adj)


@pytest.mark.parametrize("dtype", DENSE, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [16392, 16393])
def test_matvecs_tall_tiles_ragged_edges(cuda, n, dtype):
    """n large enough for tiles of 128 to 256 rows, with a ragged last
    tile and column block, on the 16-byte loads (16392) and the scalar
    loads (16393): a matrix of half INF weights drawn on the card."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    adj = torch.rand(n, n, generator=gen, device=cuda) * 100.0
    adj[torch.rand(n, n, generator=gen, device=cuda) < 0.5] = torch.inf
    adj = adj.to(dtype)
    d = _dist(n, n, cuda).to(dtype)
    on = torch.tensor(np.random.default_rng(n).random(n) < 0.5, device=cuda)
    _matvecs_bitwise(d, on, adj)


@pytest.mark.parametrize("dtype", DENSE, ids=["f32", "bf16", "f16"])
def test_matvecs_on_a_misaligned_view(cuda, dtype):
    """A contiguous adj view that starts one element into its buffer (not
    16-byte aligned, though n % 8 == 0) takes the scalar loads and stays
    bitwise."""
    n = 2048
    a = torch.tensor(TG.random_graph(n, 4 * n, seed=3).adj,
                     device=cuda).to(dtype)
    buf = torch.empty(n * n + 1, dtype=dtype, device=cuda)
    adj = buf[1:1 + n * n].view(n, n)
    adj.copy_(a)
    assert adj.is_contiguous() and adj.data_ptr() % 16 != 0
    d = _dist(n, 5, cuda).to(dtype)
    on = torch.tensor(np.random.default_rng(5).random(n) < 0.5, device=cuda)
    _matvecs_bitwise(d, on, adj)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_matvecs_refuse_a_16bit_out_off_a_word_boundary(cuda, dtype):
    """A 16-bit column pair is lowered by one CAS on its 32-bit word, so
    the C entry refuses an ``out`` that starts inside a word (the wrapper
    always passes a fresh clone) and leaves it as it was."""
    import ctypes

    from repro_torch.kernels.sssp_relax import kernel as K

    n = 64
    adj = torch.tensor(TG.random_graph(n, 4 * n, seed=7).adj,
                       device=cuda).to(dtype)
    d = _dist(n, 7, cuda).to(dtype)
    buf = torch.empty(n + 1, dtype=dtype, device=cuda)
    out = buf[1:]
    out.copy_(d)
    assert out.data_ptr() % 4 != 0
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    fn = K._entry("relax_matvec", dtype, (P, P, P, I64, P))
    rc = fn(d.data_ptr(), adj.data_ptr(), out.data_ptr(), n,
            common.stream(d))
    torch.cuda.synchronize()
    assert rc == 716                          # cudaErrorMisalignedAddress
    assert _bits(out, d)
    fn = K._entry("relax_matvec_frontier", dtype, (P, P, P, P, I64, P))
    on = torch.ones(n, dtype=torch.bool, device=cuda)
    assert fn(d.data_ptr(), on.data_ptr(), adj.data_ptr(), out.data_ptr(), n,
              common.stream(d)) == 716
    assert _bits(out, d)


@pytest.mark.parametrize("dtype", DENSE, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("n", [1, 7, 100, 4096])
def test_matvecs_frontiers_inf_labels_and_small_n(cuda, n, dtype):
    """Frontiers of no row, one row, half the rows and every row; all-INF
    labels (no live row anywhere); n below one tile of 256 rows."""
    adj = torch.tensor(TG.random_graph(n, 4 * n, seed=n + 1).adj,
                       device=cuda).to(dtype)
    d = _dist(n, n + 1, cuda).to(dtype)
    d[0] = 0.0
    one = torch.zeros(n, dtype=torch.bool, device=cuda)
    one[0] = True
    half = torch.tensor(np.random.default_rng(n).random(n) < 0.5,
                        device=cuda)
    for on in (torch.zeros_like(one), one, half, torch.ones_like(one)):
        _matvecs_bitwise(d, on, adj)
    inf = torch.full((n,), torch.inf, device=cuda).to(dtype)
    _matvecs_bitwise(inf, half, adj)
    assert _bits(relax_matvec(inf, adj), inf)


@pytest.mark.parametrize("scale", [1.0, 20.0])
@pytest.mark.parametrize("n", [255, 4097])
def test_dense_kernels_f16_overflow_to_inf(cuda, n, scale):
    """float16 labels near its largest finite value (65504): sums from
    65520 up round to +inf, in the kernels as in the plain versions.  At
    20x weights every sum past a finite label overflows, so a vertex whose
    label is INF keeps it although its float32 minimum is finite."""
    adj = (torch.tensor(TG.random_graph(n, 4 * n, seed=n).adj, device=cuda)
           * scale).to(torch.float16)
    d = (64000.0 + _dist(n, n, cuda) * 1.5).to(torch.float16)
    ref = relax_sweep_ref(d, adj)
    if scale > 1:
        cand = (d.float()[:, None] + adj.float()).amin(dim=0)
        assert (torch.isinf(d) & torch.isinf(ref) & torch.isfinite(cand)).any()
    assert _bits(relax_matvec(d, adj), ref)
    on = torch.tensor(np.random.default_rng(n).random(n) < 0.5, device=cuda)
    assert _bits(relax_matvec_frontier(d, on, adj),
                 relax_sweep_frontier_ref(d, on, adj))
    D = torch.stack([d, d.flip(0), d.roll(7)])
    assert _bits(relax_matmul(D, adj), relax_sweep_multi_ref(D, adj))


@pytest.mark.parametrize("dtype", LOWP, ids=["bf16", "f16"])
def test_dense_fixpoints_16bit_kernel_sweep_vs_plain(cuda, dtype):
    """sssp_bellman (also with use_frontier) and sssp_multisource on a
    16-bit matrix: the kernel sweeps give the plain sweeps' labels, pred
    and sweeps, on the card and on the CPU."""
    from repro_torch.core.bellman import sssp_bellman
    from repro_torch.core.multisource import sssp_multisource
    from repro_torch.kernels.sssp_relax.ops import (make_sweep_fn,
                                                    relax_sweep_multi)

    a = torch.tensor(TG.sparse_graph(3001, seed=2).adj).to(dtype)
    adj = a.to(cuda)
    for front in (False, True):
        before = relax_matvec.launches
        kd, kp, ks = sssp_bellman(adj, 0, sweep_fn=make_sweep_fn(),
                                  use_frontier=front)
        assert relax_matvec.launches == before + ks
        for dev_adj in (adj, a):
            pd, pp, ps = sssp_bellman(dev_adj, 0, use_frontier=front)
            assert _bits(kd.cpu(), pd.cpu()) and ks == ps
            assert torch.equal(kp.cpu(), pp.cpu())
    srcs = torch.tensor([0, 5, 17, 3000])
    KD, ks = sssp_multisource(adj, srcs.to(cuda), sweep_fn=relax_sweep_multi)
    for dev_adj, dev_srcs in ((adj, srcs.to(cuda)), (a, srcs)):
        PD, ps = sssp_multisource(dev_adj, dev_srcs)
        assert _bits(KD.cpu(), PD.cpu()) and ks == ps


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_dense_engines_on_gpu_match_cpu(cuda, kind):
    g = (TG.sparse_graph(3000, seed=2) if kind == "sparse"
         else TG.dense_graph(500, seed=2))
    for eng in ("bellman_kernel", "bellman"):
        a = shortest_paths(g, 0, engine=eng, device=cuda)
        c = shortest_paths(g, 0, engine=eng, device="cpu")
        assert a.dist.tobytes() == c.dist.tobytes()
        assert np.array_equal(a.pred, c.pred) and a.sweeps == c.sweeps
    srcs = np.array([0, 5, 17])
    a = shortest_paths(g, srcs, engine="multisource", device=cuda)
    c = shortest_paths(g, srcs, engine="multisource", device="cpu")
    assert a.dist.tobytes() == c.dist.tobytes() and a.sweeps == c.sweeps


def test_dynamic_repair_on_gpu_matches_cpu(cuda):
    """The dynamic path (no kernel of its own) on the card against the CPU
    path: chained repairs and full solves over the same seeded churn,
    dist, pred and every counter equal."""
    from repro_torch.dynamic import DynamicGraph, repair_sssp, solve_dynamic
    from repro_torch.serve.workload import EdgeChurn

    cg = TC.sparse_csr_graph(20_000, seed=3)
    dyns = {d: DynamicGraph(cg, overlay_capacity=64) for d in ("cpu", cuda)}
    churn = EdgeChurn(cg, np.random.default_rng(3))
    prev = {d: solve_dynamic(dyn, 0, device=d) for d, dyn in dyns.items()}
    for _ in range(6):
        edits = [churn.sample() for _ in range(4)]
        for d, dyn in dyns.items():
            for op, u, v, w in edits:
                dyn.apply((op, u, v) if w is None else (op, u, v, w))
            batch = dyn.commit()
            prev[d], _ = repair_sssp(dyn, prev[d], batch, device=d)
        a, b = (prev[d] for d in dyns)
        full = solve_dynamic(dyns[cuda], 0, device=cuda)
        for r in (b, full):
            assert a.dist.tobytes() == r.dist.tobytes()
            assert np.array_equal(a.pred, r.pred)
        assert (a.sweeps, a.edges_relaxed) == (b.sweeps, b.edges_relaxed)


def _serve_stack(device, cg, landmarks=0):
    from repro_torch.serve import (DistanceCache, GraphRegistry,
                                   MicroBatchScheduler)

    registry = GraphRegistry(device=device)
    sched = MicroBatchScheduler(registry, DistanceCache(16), max_batch=4)
    registry.register("g", cg, landmarks=landmarks)
    return registry, sched


def test_registry_on_cuda_stages_once_and_serves_p2p_through_the_kernel(
        cuda):
    """A CUDA registry stages each view once on the card (the frontier view
    on the segment-min tensors), counts each tensor once, hands out the
    frontier_relax sweep, and a served p2p answer launches the kernel and
    equals the CPU stack's answer; a batched tick equals it too."""
    from repro_torch.kernels.frontier_relax import ops as frontier_ops

    cg = TC.sparse_csr_graph(3000, seed=1)
    registry, sched = _serve_stack(cuda, cg, landmarks=4)
    _, cpu_sched = _serve_stack("cpu", cg, landmarks=4)
    h = registry.get("g")
    ops = h.frontier_ops()
    assert h.frontier_ops() is ops and h.csr_ops()["src"] is ops["src"]
    assert all(t.is_cuda for t in ops.values())
    # the landmarks staged the segment-min view; each tensor counts once
    assert registry.bytes_in_use == (cg.nbytes + h.landmarks.nbytes
                                     + sum(t.nbytes for t in ops.values()))
    assert h.frontier_sweep_fn().__module__ == frontier_ops.__name__
    ids = set(h.landmarks.ids.tolist())
    s = next(v for v in range(cg.n) if v not in ids)
    t = next(v for v in range(cg.n - 1, 0, -1) if v not in ids and v != s)
    before = frontier_relax.launches
    answers = []
    for sc in (sched, cpu_sched):
        sc.submit("g", s, t)
        answers += sc.drain()
    assert [a.via for a in answers] == ["target", "target"]
    assert frontier_relax.launches > before
    assert np.float32(answers[0].value) == np.float32(answers[1].value)
    for sc in (sched, cpu_sched):
        for src in (s, 5, 9):
            sc.submit("g", src)
    rows = [[a.value.tobytes() for a in sc.drain()]
            for sc in (sched, cpu_sched)]
    assert rows[0] == rows[1]
    assert sched.snapshot() == cpu_sched.snapshot()


def test_cuda_cost_record_names_the_card(cuda):
    from repro_torch.obs import CostLog, set_cost_log

    cl = CostLog()
    prev = set_cost_log(cl)
    try:
        res = shortest_paths(TC.sparse_csr_graph(500), 0, engine="auto",
                             device=cuda)
    finally:
        set_cost_log(prev)
    (r,) = cl.records
    assert res.engine == r.engine == "frontier_kernel"
    assert (r.backend, r.device_kind) == ("gpu",
                                          torch.cuda.get_device_name(0))


def test_cuda_serving_raises_without_a_gpu(monkeypatch):
    """No quiet move to the CPU: a registry, policy or auto solve built for
    "cuda" raises when no GPU is present (runs on any machine)."""
    from repro_torch.serve import DispatchPolicy, GraphRegistry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: GraphRegistry(device="cuda"), GraphRegistry,
                 lambda: DispatchPolicy(device="cuda"), DispatchPolicy):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError, match="CUDA"):
        shortest_paths(TC.sparse_csr_graph(20), 0, engine="auto")


@pytest.mark.parametrize("engine,kernel", [
    ("delta_stepping_kernel", bucket_relax),
    ("bellman_csr_kernel", ell_relax)])
def test_tuned_query_on_the_card_launches_its_kernel_twin(cuda, engine,
                                                          kernel):
    """A card-stamped model in which ``engine`` is cheapest: the tuned
    policy routes ``engine="auto"`` to that twin (with the measured Δ for
    the Δ engine), its kernel launches, and the answer is the CPU serial
    one."""
    from repro_torch.serve.dispatch import policy_override
    from repro_torch.tune import TunedPolicy, fit_model

    cost = {"frontier_kernel": 1.0 / 100, "bellman_csr_kernel": 1.0 / 50,
            "delta_stepping_kernel": 1.0 / 500}
    cost[engine] = 1.0 / 5000
    recs = []
    for n in (256, 512, 1024, 2048):
        for e, c in cost.items():
            recs.append({"engine": e, "graph": "", "n": n, "m": 3 * n,
                         "batch": 1, "nprocs": 1, "sweeps": 3,
                         "delta": 8.0 if "delta" in e else 0.0,
                         "edges_relaxed": 3 * n, "wall_ms": n * c,
                         "converged": True, "hops": 10.0, "skew": 2.0,
                         "backend": "gpu", "device_kind": "card"})
    policy = TunedPolicy(fit_model(recs, meta={"backend": "gpu"}),
                         device=cuda)
    cg = TC.random_csr_graph(1024, 3072, seed=7)
    before = kernel.launches
    with policy_override(policy):
        res = shortest_paths(cg, 0, engine="auto", device=cuda)
    assert res.engine == engine and policy.model_routed == 1
    assert kernel.launches > before
    ref = shortest_paths(cg, 0, engine="serial", device="cpu")
    assert res.dist.tobytes() == ref.dist.tobytes()


@pytest.mark.parametrize("arch", ["gemma2-2b", "llama-3.2-vision-11b",
                                  "seamless-m4t-medium", "qwen2-moe-a2.7b",
                                  "kimi-k2-1t-a32b", "mamba2-130m",
                                  "zamba2-2.7b"])
def test_lm_smoke_on_the_card_matches_the_cpu(cuda, arch):
    """One parameter draw on the CPU, copied to the card; the forward
    pass, its logits and a teacher-forced prefill + decode (f32 cache) on
    both devices within 1e-4, as chip_smoke's LM phase holds them."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.launch.serve import make_extras
    from repro_torch.models import transformer as T

    assert torch.get_float32_matmul_precision() == "highest"
    # no MoE assignment drops, so decode can match the forward pass
    cfg = dataclasses.replace(make_smoke(get_config(arch)),
                              capacity_factor=64.0)
    host = T.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    extras = make_extras(cfg, 2, 16, rng, "cpu")
    out = {}
    for dev in ("cpu", cuda):
        params = host if dev == "cpu" else _tree_to(host, dev)
        ex = {k: v.to(dev) for k, v in extras.items()}
        t = toks.to(dev)
        x, _, _ = T.forward(params, t, cfg, **ex)
        full = T.logits_from_hidden(params, x, cfg)
        logits, caches, pos = T.prefill(params, t[:, :8], cfg, max_len=16,
                                        cache_dtype=torch.float32, **ex)
        steps = [logits]
        dex = ({"image_embeds": ex["image_embeds"]}
               if "image_embeds" in ex else {})
        for i in range(8, 16):
            logits, caches, pos = T.decode_step(params, t[:, i:i + 1], pos,
                                                caches, cfg, **dex)
            steps.append(logits)
        out[str(dev)] = [x, full, torch.stack(steps, 1)]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert float((a - b.cpu()).abs().max()) <= 1e-4
    assert float((out["cpu"][2] - out["cpu"][1][:, 7:]).abs().max()) < 2e-3


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b",
                                  "mamba2-130m", "zamba2-2.7b"])
def test_lm_gradients_on_the_card_match_the_cpu(cuda, arch):
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.models import transformer as T
    from repro_torch.models.tree import leaves
    from repro_torch.train.step import value_and_grad

    cfg = make_smoke(get_config(arch))
    host = T.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
             for k in ("tokens", "labels")}
    out = {}
    for dev in ("cpu", cuda):
        params = host if dev == "cpu" else _tree_to(host, dev)
        out[str(dev)] = value_and_grad(
            params, {k: v.to(dev) for k, v in batch.items()}, cfg)
    a, b = out["cpu"], out[str(cuda)]
    assert abs(float(a[0]) - float(b[0])) <= 1e-4 * abs(float(a[0]))
    for ga, gb in zip(leaves(a[2]), leaves(b[2])):
        scale = float(ga.abs().max()) + 1e-7
        assert float((ga - gb.cpu()).abs().max()) <= 1e-4 * scale


def test_train_steps_on_the_card_repeat_bitwise(cuda):
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.models.tree import leaves
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step

    cfg = make_smoke(get_config("mamba2-130m"))
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32))
                                 ).to(cuda) for k in ("tokens", "labels")}
    runs = []
    for _ in range(2):
        state = init_train_state(cfg, opt,
                                 torch.Generator(cuda).manual_seed(0), cuda)
        step = make_train_step(cfg, opt)
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        runs.append((losses, [t.cpu() for t in leaves(state.params)]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)
