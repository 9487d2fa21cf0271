"""The CSR operands of the port's two pull kernels (``ell_relax`` and
``bucket_relax``) against the JAX package's padded ELL, on sparse, road and
hub graphs built by the JAX package: the light incoming CSR holds, row by
row and in order, the arcs of the light in-ELL's non-padding slots, and the
kernels' wrappers (their plain CSR versions on the CPU) are bitwise equal
to the JAX kernels run in Pallas interpret mode on the ELL of the same
arcs, flag included."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import csr as JC
from repro.core import delta_stepping as JD
from repro.kernels.bucket_relax import ops as j_bucket
from repro.kernels.csr_relax import ops as j_csr
from repro_torch.core import csr as TC
from repro_torch.core.bellman_csr import csr_operands
from repro_torch.core.delta_stepping import delta_operands
from repro_torch.kernels import common
from repro_torch.kernels.bucket_relax import ops as t_bucket
from repro_torch.kernels.bucket_relax.kernel import bucket_relax
from repro_torch.kernels.bucket_relax.ref import bucket_relax_csr_ref
from repro_torch.kernels.csr_relax import ops as t_csr
from repro_torch.kernels.csr_relax.kernel import ell_relax
from repro_torch.kernels.csr_relax.ref import ell_relax_csr_ref


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # small tensors: intra-op threads only add contention under xdist
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


CORPORA = {
    "sparse": lambda: JC.sparse_csr_graph(257, seed=3),
    "road": lambda: JC.road_like_csr_graph(900, seed=1),
    "hub": lambda: JC.skewed_hub_csr_graph(2000, seed=2),
}


def carry(cg):
    return TC.from_arrays(cg.indptr, cg.indices, cg.weights, cg.n,
                          cg.directed)


def mixed_dist(cg, seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 500.0, cg.n).astype(np.float32)
    d[rng.random(cg.n) < 0.3] = np.inf
    return d


def as_kernel_csr(indptr, indices, weights):
    """The int32 / int32 / float32 tensors the pull kernels take."""
    return (torch.tensor(np.asarray(indptr, np.int32)),
            torch.tensor(indices), torch.tensor(weights))


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_light_in_csr_holds_the_light_ell_slots_in_order(corpus):
    cg = CORPORA[corpus]()
    tg = carry(cg)
    w = np.asarray(cg.weights)
    for delta in (JD.auto_delta(cg), float(np.median(w)), 40.0):
        ip, src, lw = tg.light_in_csr(delta)
        assert (ip.dtype, src.dtype, lw.dtype) == (np.int64, np.int32,
                                                   np.float32)
        assert tg.light_in_csr(delta)[0] is ip                # memoized
        assert not (ip.flags.writeable or src.flags.writeable
                    or lw.flags.writeable)
        assert bool((lw <= np.float32(delta)).all())
        assert ip[-1] == int((w <= np.float32(delta)).sum())
        deg = np.diff(ip)
        for idx, ew in (cg.light_in_ell(delta), tg.light_in_ell(delta)):
            slot = np.arange(idx.shape[1])[None, :] < deg[:, None]
            assert np.array_equal(idx[slot], src)
            assert np.array_equal(ew[slot], lw)
            assert not idx[~slot].any() and np.isinf(ew[~slot]).all()


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_ell_relax_csr_bitwise_vs_jax_on_graph_ell(corpus):
    cg = CORPORA[corpus]()
    d = mixed_dist(cg, 7)
    idx, w = cg.ell()
    want = np.asarray(j_csr.csr_relax_sweep(
        jnp.asarray(d), jnp.asarray(idx), jnp.asarray(w), interpret=True))
    csr = as_kernel_csr(cg.indptr, cg.indices, cg.weights)
    dt = torch.tensor(d)
    for got in (ell_relax_csr_ref(dt, *csr), ell_relax(dt, *csr),
                t_csr.csr_relax_sweep(dt, *csr)):
        assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_bucket_relax_csr_bitwise_vs_jax_on_light_ell(corpus):
    cg = CORPORA[corpus]()
    tg = carry(cg)
    delta = JD.auto_delta(cg)
    d = mixed_dist(cg, 8)
    lidx, lw = cg.light_in_ell(delta)
    csr = as_kernel_csr(*tg.light_in_csr(delta))
    dt = torch.tensor(d)
    mid = float(np.median(d[np.isfinite(d)]))
    for hi in (0.0, mid, float("inf")):
        want, wgo = j_bucket.bucket_relax_block(
            jnp.asarray(d), jnp.asarray(lidx), jnp.asarray(lw),
            jnp.float32(hi), interpret=True)
        h = torch.tensor(hi, dtype=torch.float32)
        for new, go in (bucket_relax_csr_ref(dt, *csr, h),
                        bucket_relax(dt, *csr, h),
                        t_bucket.bucket_relax_block(dt, *csr, h)):
            assert new.numpy().tobytes() == np.asarray(want).tobytes()
            assert go.dtype == torch.bool and bool(go) == bool(wgo)


def test_kernel_operands_stage_the_csr_and_no_ell():
    tg = carry(CORPORA["hub"]())
    plain = csr_operands(tg, device="cpu")
    assert not any(k.startswith("in_") for k in plain)
    ops = csr_operands(tg, device="cpu", with_in_csr=True)
    assert ops["in_indptr"].dtype == ops["in_src"].dtype == torch.int32
    assert np.array_equal(ops["in_indptr"].numpy(), tg.indptr)
    assert np.array_equal(ops["in_src"].numpy(), tg.indices)
    delta = JD.auto_delta(CORPORA["hub"]())
    dops = delta_operands(tg, delta, device="cpu")
    lip, lsrc, lw = tg.light_in_csr(delta)
    assert dops["light_indptr"].dtype == torch.int32
    assert np.array_equal(dops["light_indptr"].numpy(), lip)
    assert np.array_equal(dops["light_src"].numpy(), lsrc)
    assert dops["light_w"].numpy().tobytes() == lw.tobytes()
    assert dops["m_light"] == lsrc.shape[0]
    assert dops["light_dst"].dtype == torch.int64
    assert np.array_equal(dops["light_dst"].numpy(),
                          np.repeat(np.arange(tg.n), np.diff(lip)))
    for o in (ops, dops):
        assert not any("ell" in k for k in o)


@pytest.mark.parametrize("n,m,group", [(4_000_000, 15_992_000, 2),
                                       (4_000_000, 23_999_986, 4),
                                       (1_000_000, 5_414_726, 4),
                                       (10, 80, 4), (10, 81, 8),
                                       (10, 10, 1), (10, 21, 2),
                                       (10, 1000, 32), (0, 0, 1)])
def test_lane_group_is_the_largest_power_of_two_below_the_mean_degree(
        n, m, group):
    assert common.lane_group(n, m) == group
