"""The CUDA kernels on the card: each against its plain PyTorch version,
bitwise, and the kernel engines on the GPU against the CPU path.  The
dense kernels run at n in {1, 37, 255, 4097} and S in {1, 3, 8, 9}, and
relax_matmul also at n = 1025 to 1028 (every residue mod 4) and S in
{1, 7, 8, 9, 17} with all-INF rows and tiles, so ragged tails, u-split
boundaries and ragged source tiles are covered; the CSR pull kernels and
the frontier push at every lane-group width, on graphs with rows that
their whole-warp path takes.  The attention-only LMs' smoke configs on the
card against the CPU, f32 without TF32, within 1e-4.

Marked ``cuda``; every test skips without a CUDA GPU.  On a machine with
one:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
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
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


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
                                  "seamless-m4t-medium"])
def test_lm_smoke_on_the_card_matches_the_cpu(cuda, arch):
    """One parameter draw on the CPU, copied to the card; the forward
    pass, its logits and a teacher-forced prefill + decode (f32 cache) on
    both devices within 1e-4, as chip_smoke's LM phase holds them."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.launch.serve import make_extras
    from repro_torch.models import transformer as T

    assert torch.get_float32_matmul_precision() == "highest"
    cfg = make_smoke(get_config(arch))
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


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)
