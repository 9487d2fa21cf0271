"""The port's sharded engines (A.11a) against the JAX package, on the CPU
over gloo.

- ``CsrGraph.partitioned`` byte-identical to JAX's for P in {1, 2, 3, 4, 8},
  n < P and an edgeless graph included; ``partition_operands``' local
  incoming CSR.
- The sharded CSR engines at P in {1, 2, 4} on random, road and hub graphs:
  ``dist`` bitwise and ``pred`` equal to JAX's single-device
  ``bellman_csr`` / ``frontier`` / ``multisource_csr`` and to ``serial``;
  ``sweeps`` and ``edges_relaxed`` equal to JAX ``frontier``'s;
  ``converged`` (and the capped labels) equal under ``max_sweeps``.  The
  JAX sharded CSR engines cannot be the reference: they fail on this
  tree even at P = 1 (ROADMAP queue C).
- ``dijkstra_sharded`` (three MINLOC variants) and the sharded
  ``multisource`` against JAX's own at P = 1 and P = 4 (JAX in one child
  process with four forced host devices, writing an ``.npz``); at P = 2
  against JAX's P = 1 answers.  ``bellman_sharded`` against JAX's at
  P = 1 and JAX ``bellman`` at P = 2 and 4 (JAX's raises at P = 4).
- The row-base ``ell_relax`` and explicit-label ``frontier_relax`` plain
  paths against a direct numpy min.
- ``sssp_run --procs 2`` and ``run_bench --smoke --devices 2`` on the CPU.

Each P runs ONE spawned gloo group (core/_dist.spawn, file store under
``tmp_path``) that takes every case; the tests read its results.  The
``cuda``-marked tests at the end need a GPU and skip here.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import csr as JC
from repro.core import graph as JG
from repro_torch.core import csr as TC
from repro_torch.core import graph as TG
from repro_torch.core._dist import ShardGroup, open_group, spawn
from repro_torch.core.api import shortest_paths
from repro_torch.core.sharded_csr import partition_operands
from repro_torch.kernels.csr_relax.kernel import ell_relax
from repro_torch.kernels.frontier_relax.kernel import frontier_relax

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120
PROCS = (1, 2, 4)
SOURCE = 3
SOURCES = (0, 17, 42, 99)
CAP = 2
CSR_ENGINES = ("bellman_csr_sharded", "frontier_sharded")
VARIANTS = ("allgather", "pmin", "packed")
DENSE_N, DENSE_M, DENSE_SEED = 150, 450, 7     # n_pad = 152 at P = 4


def j_sp(*args, **kw):
    """JAX's facade, imported here: the spawned ranks import this module
    and need none of JAX."""
    from repro.core.api import shortest_paths as jax_shortest_paths

    return jax_shortest_paths(*args, **kw)


def _graphs():
    """The JAX-built test graphs: random, road (15 x 15 grid) and hub."""
    return {"random": JC.random_csr_graph(203, 600, seed=3),
            "road": JC.road_like_csr_graph(225, seed=1),
            "hub": JC.skewed_hub_csr_graph(300, seed=2)}


def carry(cg):
    return TC.from_arrays(cg.indptr, cg.indices, cg.weights, cg.n,
                          cg.directed)


def _dense():
    return JG.random_graph(DENSE_N, DENSE_M, seed=DENSE_SEED)


# ---------------------------------------------------------------------------
# one spawned group a P: every case on every rank
# ---------------------------------------------------------------------------

def _pack(res):
    return (res.dist, res.pred, res.sweeps, res.edges_relaxed, res.converged)


def _cases_rank(group, csr_graphs, adj):
    """Every engine case on this rank, by key."""
    torch.set_num_threads(1)
    out = {}

    def run(key, g, src, engine, **kw):
        out[key] = _pack(shortest_paths(g, src, engine=engine, device="cpu",
                                        group=group, **kw))

    for name, cg in csr_graphs.items():
        for engine in CSR_ENGINES:
            run((name, engine), cg, SOURCE, engine)
        run((name, "target"), cg, SOURCE, "frontier_sharded", target=7)
        run((name, "multisource_csr_sharded"), cg, list(SOURCES),
            "multisource_csr_sharded")
    cg = csr_graphs["random"]
    for engine in CSR_ENGINES + ("multisource_csr_sharded",):
        src = list(SOURCES) if engine.startswith("multi") else SOURCE
        run(("cap", engine), cg, src, engine, max_sweeps=CAP)
    g = TG.from_adjacency(adj)
    for v in VARIANTS:
        run(("dijkstra", v), g, SOURCE, "dijkstra_sharded", minloc=v)
    run(("bellman_sharded",), g, SOURCE, "bellman_sharded")
    run(("multisource",), g, list(SOURCES), "multisource")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_child):
    """P -> the result dict of every rank; the three groups run at once
    (and beside the JAX child)."""
    from concurrent.futures import ThreadPoolExecutor

    graphs = {k: carry(v) for k, v in _graphs().items()}
    adj = _dense().adj
    with ThreadPoolExecutor(len(PROCS)) as pool:
        futures = {P: pool.submit(
            spawn, _cases_rank, P, backend="gloo", timeout=TIMEOUT,
            store_dir=tmp_path_factory.mktemp(f"group{P}"),
            args=(graphs, adj)) for P in PROCS}
        return {P: f.result() for P, f in futures.items()}


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's single-device answers a graph, and serial's distances."""
    out = {}
    for name, cg in _graphs().items():
        out[name] = {
            "bellman_csr": j_sp(cg, SOURCE, engine="bellman_csr"),
            "frontier": j_sp(cg, SOURCE, engine="frontier"),
            "multisource_csr": j_sp(cg, np.int32(SOURCES),
                                    engine="multisource_csr"),
            "serial": j_sp(cg.to_dense(), SOURCE, engine="serial"),
        }
    cg = _graphs()["random"]
    out["cap"] = {
        "bellman_csr_sharded": j_sp(cg, SOURCE, engine="bellman_csr",
                                    max_sweeps=CAP),
        "frontier_sharded": j_sp(cg, SOURCE, engine="frontier",
                                 max_sweeps=CAP),
        "multisource_csr_sharded": j_sp(cg, np.int32(SOURCES),
                                        engine="multisource_csr",
                                        max_sweeps=CAP),
    }
    out["bellman"] = j_sp(_dense(), SOURCE, engine="bellman")
    return out


_JAX_SHARDED = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.core import graph as G
from repro.core._compat import make_mesh
from repro.core.bellman import sssp_bellman_sharded
from repro.core.multisource import sssp_multisource_sharded
from repro.core.sharded import dijkstra_sharded

g = G.random_graph({n}, {m}, seed={seed})
out = {{}}
for P in (1, 4):
    mesh = make_mesh((P,), ("data",), devices=jax.devices()[:P])
    adj = jnp.asarray(g.padded(P).adj)
    for v in ("allgather", "pmin", "packed"):
        d, p = dijkstra_sharded(adj, jnp.int32({src}), mesh, n_true=g.n,
                                minloc=v)
        out[f"dij_{{v}}_{{P}}"] = np.asarray(d)[:g.n]
        out[f"dijp_{{v}}_{{P}}"] = np.asarray(p)[:g.n]
    D, s = sssp_multisource_sharded(adj, jnp.int32({srcs}), mesh)
    out[f"ms_{{P}}"] = np.asarray(D)[:, :g.n]
    out[f"mss_{{P}}"] = np.int64(s)
mesh = make_mesh((1,), ("data",), devices=jax.devices()[:1])
d, p, s = sssp_bellman_sharded(jnp.asarray(g.adj), jnp.int32({src}), mesh)
out["bs_1"], out["bsp_1"], out["bss_1"] = np.asarray(d), np.asarray(p), s
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_child(tmp_path_factory):
    """JAX's dense sharded engines at P = 1 and 4, started in one child
    process with four forced host devices; yields it and its output."""
    path = tmp_path_factory.mktemp("jax") / "sharded.npz"
    code = _JAX_SHARDED.format(n=DENSE_N, m=DENSE_M, seed=DENSE_SEED,
                               src=SOURCE, srcs=list(SOURCES))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", code, str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        yield proc, path
    finally:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_sharded(jax_child):
    proc, path = jax_child
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log.decode()
    return dict(np.load(path))


def _on_every_rank(results, key):
    """The case's result, after checking that every rank returned the
    same one."""
    first = results[0][key]
    for r in results[1:]:
        for a, b in zip(first, r[key]):
            if isinstance(a, np.ndarray):
                assert a.tobytes() == b.tobytes()
            else:
                assert a == b
    return first


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the partition
# ---------------------------------------------------------------------------

_FIELDS = ("in_src", "in_dst_loc", "in_w", "out_indptr", "out_dst_loc",
           "out_w")


@pytest.mark.parametrize("nprocs", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("graph", ["random", "road", "hub", "tiny",
                                   "edgeless"])
def test_partition_byte_identical_to_jax(graph, nprocs):
    jg = {"tiny": JC.random_csr_graph(3, 2, seed=5),    # n < P for P >= 4
          "edgeless": JC.random_csr_graph(6, 0, seed=0, connected=False),
          **_graphs()}[graph]
    want, got = jg.partitioned(nprocs), carry(jg).partitioned(nprocs)
    for f in _FIELDS:
        assert _same_bits(getattr(got, f), getattr(want, f)), f
    assert (got.nprocs, got.n, got.n_pad, got.loc_n, got.nnz_max) == (
        want.nprocs, want.n, want.n_pad, want.loc_n, want.nnz_max)
    assert (got.nbytes, got.per_device_edge_bytes,
            got.per_device_index_bytes) == (
        want.nbytes, want.per_device_edge_bytes, want.per_device_index_bytes)


def test_partition_is_memoized_read_only_and_checks_p():
    cg = carry(_graphs()["random"])
    parts = cg.partitioned(4)
    assert cg.partitioned(4) is parts and cg.partitioned(2) is not parts
    with pytest.raises(ValueError):
        parts.in_src[0, 0] = 1
    with pytest.raises(ValueError):
        cg.partitioned(0)


@pytest.mark.parametrize("nprocs", [1, 3, 4])
def test_partition_operands_stage_one_block_with_its_in_csr(nprocs):
    """A rank stages its own block only; the local incoming CSR offsets
    window exactly the block's segment ids, padding in the last row."""
    parts = carry(_graphs()["hub"]).partitioned(nprocs)
    for rank in range(nprocs):
        ops = partition_operands(parts, rank, device="cpu")
        ip = ops["in_indptr"].numpy()
        assert ip.dtype == np.int32 and ip.shape == (parts.loc_n + 1,)
        assert ip[0] == 0 and ip[-1] == parts.nnz_max
        rows = np.repeat(np.arange(parts.loc_n), np.diff(ip))
        assert np.array_equal(rows, parts.in_dst_loc[rank])
        for key, field in (("in_src", "in_src"), ("in_w", "in_w"),
                           ("out_indptr", "out_indptr"),
                           ("out_dst", "out_dst_loc"), ("out_w", "out_w")):
            assert _same_bits(ops[key].numpy(), getattr(parts, field)[rank])


# ---------------------------------------------------------------------------
# the sharded CSR engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", PROCS)
@pytest.mark.parametrize("graph", ["random", "road", "hub"])
def test_bellman_csr_sharded_bitwise_vs_jax_bellman_csr(runs, jax_refs, P,
                                                        graph):
    d, p, s, e, c = _on_every_rank(runs[P], (graph, "bellman_csr_sharded"))
    ref = jax_refs[graph]["bellman_csr"]
    assert d.tobytes() == np.asarray(ref.dist).tobytes()
    assert d.tobytes() == np.asarray(jax_refs[graph]["serial"].dist).tobytes()
    assert np.array_equal(p, np.asarray(ref.pred))
    assert s == ref.sweeps and c is True
    # every owner sweeps its padded block, as JAX's facade counts it
    parts = _graphs()[graph].partitioned(P)
    assert e == s * P * parts.nnz_max


@pytest.mark.parametrize("P", PROCS)
@pytest.mark.parametrize("graph", ["random", "road", "hub"])
def test_frontier_sharded_bitwise_vs_jax_frontier(runs, jax_refs, P, graph):
    d, p, s, e, c = _on_every_rank(runs[P], (graph, "frontier_sharded"))
    ref = jax_refs[graph]["frontier"]
    assert d.tobytes() == np.asarray(ref.dist).tobytes()
    assert d.tobytes() == np.asarray(jax_refs[graph]["serial"].dist).tobytes()
    assert np.array_equal(p, np.asarray(ref.pred))
    assert (s, e, c) == (ref.sweeps, ref.edges_relaxed, True)


@pytest.mark.parametrize("P", PROCS)
@pytest.mark.parametrize("graph", ["random", "road", "hub"])
def test_frontier_sharded_target_runs_the_full_fixpoint(runs, jax_refs, P,
                                                        graph):
    """``target=`` is accepted and the full row comes back, as JAX's
    facade does for frontier_sharded."""
    d, p, s, e, c = _on_every_rank(runs[P], (graph, "target"))
    full = _on_every_rank(runs[P], (graph, "frontier_sharded"))
    assert d.tobytes() == full[0].tobytes()
    assert np.array_equal(p, full[1]) and (s, e, c) == full[2:]


@pytest.mark.parametrize("P", PROCS)
@pytest.mark.parametrize("graph", ["random", "road", "hub"])
def test_multisource_csr_sharded_rows_vs_jax_and_per_source(runs, jax_refs,
                                                            P, graph):
    D, pred, s, e, c = _on_every_rank(runs[P],
                                      (graph, "multisource_csr_sharded"))
    ref = jax_refs[graph]["multisource_csr"]
    assert pred is None and c is True
    assert D.tobytes() == np.asarray(ref.dist).tobytes()
    assert s == ref.sweeps
    cg = _graphs()[graph]
    for i, src in enumerate(SOURCES):
        one = j_sp(cg, src, engine="frontier")
        assert D[i].tobytes() == np.asarray(one.dist).tobytes()
    # the union counts each windowed arc once a sweep: at most the sum of
    # the per-source counters
    assert 0 < e <= sum(j_sp(cg, src, engine="frontier").edges_relaxed
                        for src in SOURCES)


@pytest.mark.parametrize("P", PROCS)
@pytest.mark.parametrize("engine", CSR_ENGINES + ("multisource_csr_sharded",))
def test_sharded_csr_max_sweeps_cap_matches_single_device(runs, jax_refs, P,
                                                          engine):
    d, _, s, _, c = _on_every_rank(runs[P], ("cap", engine))
    ref = jax_refs["cap"][engine]
    assert (s, c) == (CAP, False) and ref.converged is False
    assert d.tobytes() == np.asarray(ref.dist).tobytes()


def test_sharded_engines_need_a_group_of_the_right_device():
    cg = carry(_graphs()["random"])
    for engine in CSR_ENGINES + ("dijkstra_sharded", "bellman_sharded"):
        with pytest.raises(ValueError, match="needs a group"):
            shortest_paths(cg, 0, engine=engine, device="cpu")
    fake = ShardGroup(rank=0, size=1, device=torch.device("cuda", 0),
                      backend="nccl")
    with pytest.raises(ValueError, match="group"):
        shortest_paths(cg, 0, engine="frontier_sharded", device="cpu",
                       group=fake)
    alone = ShardGroup(rank=0, size=1, device=torch.device("cpu"),
                       backend="gloo")
    with pytest.raises(ValueError, match="ignore group"):
        shortest_paths(cg, 0, engine="frontier", device="cpu", group=alone)


# ---------------------------------------------------------------------------
# the dense sharded engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", PROCS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_dijkstra_sharded_vs_jax_dijkstra_sharded(runs, jax_sharded, P,
                                                  variant):
    d, p, s, e, c = _on_every_rank(runs[P], ("dijkstra", variant))
    jp = P if P in (1, 4) else 1            # the answer does not depend on P
    assert d.tobytes() == jax_sharded[f"dij_{variant}_{jp}"].tobytes()
    assert np.array_equal(p, jax_sharded[f"dijp_{variant}_{jp}"])
    assert (s, e, c) == (None, None, None)


@pytest.mark.parametrize("P", PROCS)
def test_bellman_sharded_vs_jax(runs, jax_sharded, jax_refs, P):
    """Against JAX's bellman_sharded at P = 1 and its single-device
    bellman elsewhere (JAX's raises at P = 4, queue C)."""
    d, p, s, _, _ = _on_every_rank(runs[P], ("bellman_sharded",))
    if P == 1:
        want = (jax_sharded["bs_1"], jax_sharded["bsp_1"],
                int(jax_sharded["bss_1"]))
    else:
        ref = jax_refs["bellman"]
        want = (np.asarray(ref.dist), np.asarray(ref.pred), ref.sweeps)
    assert d.tobytes() == want[0].tobytes()
    assert np.array_equal(p, want[1]) and s == want[2]


@pytest.mark.parametrize("P", PROCS)
def test_multisource_sharded_vs_jax_multisource_sharded(runs, jax_sharded,
                                                        P):
    D, pred, s, _, _ = _on_every_rank(runs[P], ("multisource",))
    jp = P if P in (1, 4) else 1
    assert pred is None
    assert D.tobytes() == jax_sharded[f"ms_{jp}"].tobytes()
    assert s == int(jax_sharded[f"mss_{jp}"])


# ---------------------------------------------------------------------------
# the two kernel modes, plain paths
# ---------------------------------------------------------------------------

def _labels(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 500, n).astype(np.float32)
    d[rng.random(n) < 0.3] = np.inf
    return d


@pytest.mark.parametrize("nprocs", [1, 3, 4])
def test_ell_relax_row_base_plain_vs_numpy(nprocs):
    """Every owner's block pull, padding arcs included, against a direct
    numpy min over the block's arcs."""
    parts = carry(_graphs()["hub"]).partitioned(nprocs)
    assert (~np.isfinite(parts.in_w)).any()        # padding arcs present
    d = _labels(parts.n_pad, nprocs)
    for rank in range(nprocs):
        ops = partition_operands(parts, rank, device="cpu")
        base = rank * parts.loc_n
        got = ell_relax(torch.tensor(d), ops["in_indptr"], ops["in_src"],
                        ops["in_w"], row_base=base).numpy()
        want = d[base:base + parts.loc_n].copy()
        np.minimum.at(want, parts.in_dst_loc[rank],
                      d[parts.in_src[rank]] + parts.in_w[rank])
        assert got.tobytes() == want.tobytes()


def test_ell_relax_row_base_checks_the_block():
    d = torch.zeros(10)
    ip = torch.tensor([0, 1, 1], dtype=torch.int32)
    src, w = torch.tensor([9], dtype=torch.int32), torch.ones(1)
    assert ell_relax(d, ip, src, w, row_base=8).shape == (2,)
    with pytest.raises(ValueError):
        ell_relax(d, ip, src, w, row_base=9)
    with pytest.raises(ValueError):
        ell_relax(d, ip, src, w)               # without a base: n rows


@pytest.mark.parametrize("nprocs", [1, 2, 4])
def test_frontier_relax_explicit_labels_plain_vs_numpy(nprocs):
    """A push of given labels from global ids (some twice, the sentinel
    n_pad and an id past the rows included) into each owner's block,
    against a direct numpy min, fallen-label mask too."""
    parts = carry(_graphs()["random"]).partitioned(nprocs)
    rng = np.random.default_rng(nprocs)
    ids = np.concatenate([rng.choice(parts.n_pad, 40, replace=False),
                          [5, 5, parts.n_pad, parts.n_pad + 7]])
    lab = rng.uniform(0, 300, ids.size).astype(np.float32)
    for rank in range(nprocs):
        ops = partition_operands(parts, rank, device="cpu")
        ip, dst = parts.out_indptr[rank], parts.out_dst_loc[rank]
        w = parts.out_w[rank]
        blk0 = _labels(parts.loc_n, rank)
        want = blk0.copy()
        for u, du in zip(ids, lab):
            if 0 <= u < parts.n_pad + 1:
                for e in range(ip[u], ip[u + 1]):
                    want[dst[e]] = min(want[dst[e]], du + w[e])
        blk = torch.tensor(blk0)
        fell = torch.zeros(parts.loc_n, dtype=torch.bool)
        frontier_relax(blk, torch.tensor(ids), ops["out_indptr"],
                       ops["out_dst"], ops["out_w"], fell,
                       flabels=torch.tensor(lab))
        assert blk.numpy().tobytes() == want.tobytes()
        assert np.array_equal(fell.numpy(), want < blk0)


def test_frontier_relax_explicit_labels_checks_shape():
    parts = carry(_graphs()["random"]).partitioned(2)
    ops = partition_operands(parts, 0, device="cpu")
    blk = torch.zeros(parts.loc_n)
    fell = torch.zeros(parts.loc_n, dtype=torch.bool)
    with pytest.raises(ValueError):
        frontier_relax(blk, torch.tensor([0, 1]), ops["out_indptr"],
                       ops["out_dst"], ops["out_w"], fell,
                       flabels=torch.zeros(3))


# ---------------------------------------------------------------------------
# groups, sssp_run and run_bench
# ---------------------------------------------------------------------------

def _fail_on_rank_one(group):
    if group.rank == 1:
        raise RuntimeError("rank one fails")
    return group.rank


def _collectives_rank(group):
    t = torch.tensor([float(group.rank)])
    gathered = group.all_gather(t.view(1))
    summed = group.all_reduce(t.clone(), "sum")
    src = group.broadcast(torch.tensor([group.rank + 10]), src=1)
    blocks = group.all_gather(torch.full((2, 3), group.rank), dim=1)
    return (gathered.tolist(), float(summed), int(src), blocks.tolist(),
            group.collectives)


def test_spawn_collectives_and_failures(tmp_path):
    out = spawn(_collectives_rank, 2, backend="gloo", store_dir=tmp_path,
                timeout=TIMEOUT)
    for r in out:
        assert r == ([0.0, 1.0], 1.0, 11, [[0, 0, 0, 1, 1, 1]] * 2, 4)
    with pytest.raises(RuntimeError, match="rank one fails"):
        spawn(_fail_on_rank_one, 2, backend="gloo", store_dir=tmp_path,
              timeout=TIMEOUT)


def test_spawn_refuses_other_start_methods(tmp_path):
    # forked gloo ranks run through sssp_run as a program (the paper
    # benches' legs, tests/test_torch_paper_benches.py); never fork here,
    # from a process whose torch thread pools are running
    for backend, method in (("nccl", "fork"), ("gloo", "forkserver")):
        with pytest.raises(ValueError, match="start method"):
            spawn(_collectives_rank, 1, backend=backend, store_dir=tmp_path,
                  start_method=method)


def test_backend_must_carry_the_device(tmp_path):
    with pytest.raises(ValueError, match="gloo"):
        open_group(0, 1, backend="nccl", device="cpu", store_dir=tmp_path)
    with pytest.raises((ValueError, RuntimeError)):
        open_group(0, 1, backend="gloo", device="cuda:0", store_dir=tmp_path)


def test_sssp_run_procs_verifies_on_cpu(capsys):
    from repro_torch.launch import sssp_run

    for engine in ("frontier_sharded", "dijkstra_sharded"):
        sssp_run.main(["--engine", engine, "--procs", "2", "--nodes", "120",
                       "--device", "cpu", "--repeats", "1", "--verify"])
        out = capsys.readouterr().out
        assert "verify: OK" in out and "procs=2" in out
    with pytest.raises(SystemExit):
        sssp_run.main(["--engine", "frontier", "--procs", "2", "--device",
                       "cpu"])


def test_run_bench_smoke_devices_two_gates_sharded(tmp_path):
    from repro_torch.benchmarks import run_bench

    out = tmp_path / "sssp.json"
    cost = tmp_path / "costs.jsonl"
    run_bench.run(smoke=True, repeats=1, out=str(out), device="cpu",
                  devices=2, cost_out=str(cost))
    doc = json.loads(out.read_text())
    gate = doc["gate_sharded"]
    assert gate["pass"] and "P=2" in gate["rule"] and gate["points"]
    recs = [r for r in doc["results"] if r["engine"].endswith("_sharded")]
    assert {r["engine"] for r in recs} == set(run_bench.SHARDED_KERNEL_OF)
    assert all(r["procs"] == 2 and r["agrees_bitwise"]
               and r["kernel_launches"] == 0 for r in recs)
    costs = [json.loads(x) for x in cost.read_text().splitlines()]
    sharded = [c for c in costs if c["engine"] == "frontier_sharded"]
    assert sharded and all(c["nprocs"] == 2 for c in sharded)


# ---------------------------------------------------------------------------
# on the card (skip without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_nccl_p1_engines_match_frontier_kernel(cuda):
    cg = carry(JC.random_csr_graph(3000, 9000, seed=4))
    ref = shortest_paths(cg, SOURCE, engine="frontier_kernel", device=cuda)
    with open_group(0, 1, backend="nccl", device=cuda,
                    store_dir=tempfile.mkdtemp()) as group:
        for engine in CSR_ENGINES:
            r = shortest_paths(cg, SOURCE, engine=engine, device=cuda,
                               group=group)
            assert r.dist.tobytes() == ref.dist.tobytes()
            assert np.array_equal(r.pred, ref.pred)
        r = shortest_paths(cg, SOURCE, engine="frontier_sharded",
                           device=cuda, group=group)
        assert (r.sweeps, r.edges_relaxed) == (ref.sweeps, ref.edges_relaxed)


@pytest.mark.cuda
@pytest.mark.parametrize("nprocs", [1, 4])
def test_kernel_modes_match_plain_on_the_card(cuda, nprocs):
    parts = carry(_graphs()["hub"]).partitioned(nprocs)
    d = torch.tensor(_labels(parts.n_pad, 0), device=cuda)
    ids = torch.arange(0, parts.n_pad + 1, 3, device=cuda)
    lab = torch.tensor(_labels(ids.numel(), 1), device=cuda)
    lab = torch.where(torch.isfinite(lab), lab, 1.0)
    for rank in range(nprocs):
        ops = partition_operands(parts, rank, device=cuda)
        base = rank * parts.loc_n
        args = (ops["in_indptr"], ops["in_src"], ops["in_w"])
        got = ell_relax(d, *args, row_base=base)
        want = ell_relax(d.cpu(), *(a.cpu() for a in args), row_base=base)
        assert got.cpu().numpy().tobytes() == want.numpy().tobytes()
        blk = d[base:base + parts.loc_n].clone()
        ref = blk.cpu()
        fell = torch.zeros(parts.loc_n, dtype=torch.bool, device=cuda)
        ref_fell = fell.cpu()
        out = (ops["out_indptr"], ops["out_dst"], ops["out_w"])
        frontier_relax(blk, ids, *out, fell, flabels=lab)
        frontier_relax(ref, ids.cpu(), *(a.cpu() for a in out), ref_fell,
                       flabels=lab.cpu())
        assert blk.cpu().numpy().tobytes() == ref.numpy().tobytes()
        assert torch.equal(fell.cpu(), ref_fell)
