"""The port's MoE FFN and Mamba2 block (repro_torch.models.moe / .ssm),
gradients of every arch and remat, against the JAX package's, on the CPU.

Inputs are numpy-made; parameters are JAX's (``init_moe`` / ``init_ssm``
/ ``T.init_params`` at ``PRNGKey(0)``) carried over as numpy, their zero-
or one-initialised leaves drawn (``test_torch_lm_models``'s
``carried_params``).  Bounds, fixed before measuring:

- MoE (qwen2-moe and kimi smoke, ``capacity_factor`` default and 64):
  top-k ids, ``keep`` and ``slot`` equal to JAX's exactly (JAX's read off
  its own ``top_k`` / ``argsort`` and the dispatch buffer it builds); the
  output within 1e-4; aux within 1e-5 relative; and the port matches
  ``test_moe.py``'s per-token dense reference with no drops (2e-3, that
  test's bound); JAX's own MoE tests on the port;
- SSM: ``ssd_chunked`` (y, final state), ``ssm_forward`` (out, conv tail,
  state) and ``ssm_decode`` each within 1e-4 of JAX's at JAX's ``(L,
  chunk)`` cases (16,4) (32,8) (24,24) (8,16); chunk-size invariance and
  the rest of JAX's SSM tests on the port;
- gradients: every leaf of ``value_and_grad(train_loss)`` within 1e-4 ·
  max|g_JAX| (+1e-7) of JAX's, all ten archs' smoke configs; remat none /
  dots / full give gradients within 1e-4 of each other (JAX's
  ``test_remat_equivalence`` bound) and the same loss.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
import repro.models.ssm as jssm
import repro_torch.models.moe as pmoe
import repro_torch.models.ssm as pssm
from repro.configs import ARCHS, get_config, make_smoke
from repro.models import transformer as JT
from repro_torch.models.convert import from_jax_params, to_jax_layout
from repro_torch.train.step import value_and_grad
from test_torch_lm_models import (ZERO_INIT, _err, carried_params,
                                  make_batch, to_torch)

TOL = 1e-4
AUX_RTOL = 1e-5
DENSE_TOL = 2e-3
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
REMAT_TOL = 1e-4
KEY = jax.random.PRNGKey(0)
MOE_ARCHS = ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b")
SSM_CASES = [(16, 4), (32, 8), (24, 24), (8, 16)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _drawn(tree, seed=0):
    """A JAX numpy tree with its zero- / one-initialised leaves drawn."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if getattr(path[-1], "key", None) in ZERO_INIT:
            return (rng.standard_normal(a.shape) * 0.3).astype(a.dtype)
        return np.array(a)
    return jax.tree_util.tree_map_with_path(draw, jax.tree.map(np.asarray,
                                                               tree))


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_cfg(arch, capacity=None, **kw):
    cfg = make_smoke(get_config(arch))
    if capacity is not None:
        kw["capacity_factor"] = capacity
    return dataclasses.replace(cfg, **kw)


def _moe_x(cfg, seed=1, S=64):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)


def jax_moe_traced(p, x, cfg, monkeypatch):
    """JAX's ``moe`` run eagerly, its top-k, argsort and dispatch buffer
    recorded."""
    rec = {}
    top_k, argsort = jax.lax.top_k, jnp.argsort

    def rec_top_k(a, k):
        rec["w"], rec["ids"] = out = top_k(a, k)
        return out

    def rec_argsort(a, **kw):
        out = argsort(a, **kw)
        rec.setdefault("order", out)
        return out

    def rec_constrain(a, rule):
        rec.setdefault(rule, a)
        return a
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", rec_top_k)
        m.setattr(jnp, "argsort", rec_argsort)
        m.setattr(jmoe, "constrain", rec_constrain)
        out, aux = jmoe.moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            cfg)
    return np.asarray(out), float(aux), jax.tree.map(np.asarray, rec)


def port_moe_traced(p, x, cfg, monkeypatch):
    rec = {}
    route = pmoe.route

    def rec_route(*a):
        rec.update(route(*a))
        return rec

    def rec_constrain(a, rule):
        rec.setdefault(rule, a)
        return a
    with monkeypatch.context() as m:
        m.setattr(pmoe, "route", rec_route)
        m.setattr(pmoe, "constrain", rec_constrain)
        out, aux = pmoe.moe(_t(p), torch.from_numpy(x), cfg)
    return out, float(aux), rec


def _keep_slot(ids, order, E, C):
    """JAX's keep / slot (moe.py:117-125) from its ids and argsort, numpy."""
    G = ids.shape[0]
    flat = ids.reshape(G, -1)
    sorted_e = np.take_along_axis(flat, order, -1)
    counts = np.stack([np.bincount(f, minlength=E) for f in flat])
    starts = np.cumsum(counts, -1) - counts
    pos = np.arange(flat.shape[1])[None] - np.take_along_axis(starts,
                                                             sorted_e, -1)
    keep = pos < C
    return keep, np.where(keep, sorted_e * C + pos, E * C)


@pytest.mark.parametrize("capacity", [None, 64.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routing_output_and_aux_match_jax(arch, capacity, monkeypatch):
    cfg = _moe_cfg(arch, capacity)
    p = _drawn(jmoe.init_moe(KEY, cfg))
    x = _moe_x(cfg)
    want, want_aux, j = jax_moe_traced(p, x, cfg, monkeypatch)
    got, aux, r = port_moe_traced(p, x, cfg, monkeypatch)
    E = pmoe._padded_experts(cfg)
    T = x.shape[0] * x.shape[1]
    C = pmoe._capacity(T, cfg)
    keep, slot = _keep_slot(j["ids"], j["order"], E, C)
    # JAX's buffer is its tokens at those slots: the derivation is JAX's
    xt = x.reshape(1, T, cfg.d_model)
    buf = np.zeros((1, E * C + 1, cfg.d_model), np.float32)
    token_of = j["order"] // cfg.moe_top_k
    buf[0, slot[0]] = xt[0, token_of[0]]
    assert np.array_equal(buf[:, :E * C].reshape(j["moe_buffer"].shape),
                          j["moe_buffer"])
    assert np.array_equal(r["ids"].numpy(), j["ids"])
    assert np.array_equal(r["order"].numpy(), j["order"])
    assert np.array_equal(r["keep"].numpy(), keep)
    assert np.array_equal(r["slot"].numpy(), slot)
    assert torch.equal(r["moe_buffer"], torch.tensor(j["moe_buffer"]))
    assert (r["ids"] < cfg.num_experts).all()      # no dead expert routed
    assert (int((~r["keep"]).sum()) > 0) == (capacity is None)
    assert _err(want, got) <= TOL
    assert abs(aux - want_aux) <= AUX_RTOL * abs(want_aux)


def _dense_reference(p, x, cfg):
    """``test_moe.py``'s per-token loop: every token through its top-k."""
    B, S, d = x.shape
    xt = x.reshape(-1, d).astype(np.float32)
    logits = xt @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        top = np.argsort(-probs[t])[:cfg.moe_top_k]
        w = probs[t][top] / probs[t][top].sum()
        for e, wt in zip(top, w):
            g = xt[t] @ p["wi_gate"][e]
            u = xt[t] @ p["wi_up"][e]
            out[t] += wt * (((g / (1 + np.exp(-g))) * u) @ p["wo"][e])
    if "shared" in p:
        g = xt @ p["shared"]["wi_gate"]
        u = xt @ p["shared"]["wi_up"]
        out += ((g / (1 + np.exp(-g))) * u) @ p["shared"]["wo"]
    return out.reshape(B, S, d)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_matches_dense_reference_no_drops(arch):
    cfg = _moe_cfg(arch, 64.0, expert_pad_to=0)
    p = jax.tree.map(np.asarray, jmoe.init_moe(KEY, cfg))
    x = _moe_x(cfg, S=8)
    out, _ = pmoe.moe(_t(p), torch.from_numpy(x), cfg)
    assert _err(out, _dense_reference(p, x, cfg)) < DENSE_TOL


def test_capacity_drops_tokens():
    """JAX's test: near-zero capacity drops most assignments."""
    cfg = _moe_cfg("qwen2-moe-a2.7b", 1e-6, num_shared_experts=0)
    p = _t(jax.tree.map(np.asarray, jmoe.init_moe(KEY, cfg)))
    x = torch.from_numpy(_moe_x(cfg))
    out, _ = pmoe.moe(p, x, cfg)
    full, _ = pmoe.moe(p, x, dataclasses.replace(cfg, capacity_factor=64.0))
    assert torch.linalg.norm(out) < 0.8 * torch.linalg.norm(full)


def test_padded_experts_receive_no_tokens():
    """JAX's test: 16 padded experts, 8 real ones, against the unpadded
    config with the same real-expert weights."""
    cfg = _moe_cfg("qwen2-moe-a2.7b", expert_pad_to=16)
    assert pmoe._padded_experts(cfg) == 16
    p = jax.tree.map(np.asarray, jmoe.init_moe(KEY, cfg))
    x = torch.from_numpy(_moe_x(cfg, S=16))
    out_pad, _ = pmoe.moe(_t(p), x, cfg)
    cfg0 = dataclasses.replace(cfg, expert_pad_to=0)
    p0 = {k: (v if k in ("router", "shared") else v[:cfg.num_experts])
          for k, v in p.items()}
    out0, _ = pmoe.moe(_t(p0), x, cfg0)
    assert _err(out_pad, out0) < DENSE_TOL


def test_aux_loss_balanced_vs_skewed():
    cfg = _moe_cfg("qwen2-moe-a2.7b", 4.0, router_aux_weight=1.0)
    p = jax.tree.map(np.asarray, jmoe.init_moe(KEY, cfg))
    x = torch.from_numpy(_moe_x(cfg, S=32))
    _, aux_rand = pmoe.moe(_t(p), x, cfg)
    skew = dict(p, router=p["router"] + np.float32(100.0) * (
        np.arange(cfg.num_experts) == 0))
    _, aux_skew = pmoe.moe(_t(skew), x, cfg)
    assert float(aux_skew) > float(aux_rand)


def test_capacity_rounding_matches_jax():
    for cf in (1e-6, 1.0, 1.25, 64.0):
        cfg = _moe_cfg("qwen2-moe-a2.7b", cf)
        for T in (1, 4, 128, 1024):
            c = pmoe._capacity(T, cfg)
            assert c == jmoe._capacity(T, cfg) and c % 8 == 0 and c >= 8
    assert pmoe._num_groups(128) == jmoe._num_groups(128) == 1


def test_moe_ep_takes_the_grouped_path_off_a_mesh():
    """qwen2-moe's moe_impl is "ep": off a mesh JAX's moe runs moe_gspmd,
    and so does the port's (no refusal)."""
    cfg = _moe_cfg("qwen2-moe-a2.7b")
    assert cfg.moe_impl == "ep"
    p = _t(jax.tree.map(np.asarray, jmoe.init_moe(KEY, cfg)))
    x = torch.from_numpy(_moe_x(cfg, S=8))
    a, _ = pmoe.moe(p, x, cfg)
    b, _ = pmoe.moe_gspmd(p, x, cfg)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------

def _ssd_inputs(L, seed=0, Bsz=2, H=3, P=4, N=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bsz, L, H, P)).astype(np.float32),
            rng.uniform(0.1, 0.9, (Bsz, L, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rng.standard_normal((Bsz, L, N)).astype(np.float32),
            rng.standard_normal((Bsz, L, N)).astype(np.float32))


def _naive_ssd(xh, dt, A, Bm, Cm):
    """JAX's test's recurrence: h_t = exp(dt_t A) h_{t-1} + dt_t B_t ⊗ x_t."""
    Bsz, L, H, P = xh.shape
    h = np.zeros((Bsz, H, P, Bm.shape[-1]), np.float64)
    ys = np.zeros((Bsz, L, H, P), np.float64)
    for t in range(L):
        dA = np.exp(dt[:, t] * A[None, :])
        h = h * dA[:, :, None, None] + np.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], Bm[:, t], xh[:, t])
        ys[:, t] = np.einsum("bn,bhpn->bhp", Cm[:, t], h)
    return ys, h


@pytest.mark.parametrize("L,chunk", SSM_CASES)
def test_ssd_chunked_matches_jax_and_recurrence(L, chunk):
    ins = _ssd_inputs(L)
    want_y, want_h = jssm.ssd_chunked(*map(jnp.asarray, ins), chunk)
    y, h = pssm.ssd_chunked(*map(torch.from_numpy, ins), chunk)
    assert _err(want_y, y) <= TOL and _err(want_h, h) <= TOL
    ref_y, ref_h = _naive_ssd(*ins)
    assert _err(ref_y, y) <= 1e-3 and _err(ref_h, h) <= 1e-3


def _ssm_cfg(chunk):
    return dataclasses.replace(make_smoke(get_config("mamba2-130m")),
                               ssm_chunk=chunk)


@pytest.mark.parametrize("L,chunk", SSM_CASES)
def test_ssm_forward_and_decode_match_jax(L, chunk):
    cfg = _ssm_cfg(chunk)
    p = _drawn(jssm.init_ssm(KEY, cfg))
    rng = np.random.default_rng(L)
    x = (rng.standard_normal((2, L + 1, cfg.d_model)) * 0.5
         ).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    out, (conv, state) = jssm.ssm_forward(jp, jnp.asarray(x[:, :L]), cfg)
    dec, conv2, state2 = jssm.ssm_decode(jp, jnp.asarray(x[:, L:]), cfg,
                                         conv, state)
    tp = _t(p)
    got, (gconv, gstate) = pssm.ssm_forward(tp, torch.from_numpy(x[:, :L]),
                                            cfg)
    assert gstate.dtype == torch.float32
    for a, b in ((out, got), (conv, gconv), (state, gstate)):
        assert b.shape == a.shape and _err(a, b) <= TOL
    gdec, gconv2, gstate2 = pssm.ssm_decode(tp, torch.from_numpy(x[:, L:]),
                                            cfg, gconv, gstate)
    for a, b in ((dec, gdec), (conv2, gconv2), (state2, gstate2)):
        assert b.shape == a.shape and _err(a, b) <= TOL


def test_chunk_size_invariance():
    ins = _ssd_inputs(32, seed=1, Bsz=1, H=2, P=4, N=3)
    y4, h4 = pssm.ssd_chunked(*map(torch.from_numpy, ins), 4)
    y16, h16 = pssm.ssd_chunked(*map(torch.from_numpy, ins), 16)
    assert _err(y4, y16) <= 1e-4 and _err(h4, h16) <= 1e-4


def test_forward_then_decode_continues_state():
    """JAX's test on the port: ssm_forward's final state continues exactly
    into ssm_decode."""
    cfg = make_smoke(get_config("mamba2-130m"))
    p = _t(_drawn(jssm.init_ssm(KEY, cfg)))
    L = 12
    x = torch.from_numpy((np.random.default_rng(1).standard_normal(
        (1, L + 1, cfg.d_model)) * 0.5).astype(np.float32))
    y_full, _ = pssm.ssm_forward(p, x, cfg)
    y_pre, (conv, state) = pssm.ssm_forward(p, x[:, :L], cfg)
    y_dec, _, _ = pssm.ssm_decode(p, x[:, L:], cfg, conv, state)
    assert _err(y_full[:, :L], y_pre) <= 1e-4
    assert _err(y_full[:, L], y_dec[:, 0]) <= 1e-3


def test_ssd_gradient_is_finite():
    """The segsum mask comes before exp: no inf * 0 in the backward pass."""
    xh, dt, A, Bm, Cm = map(torch.from_numpy, _ssd_inputs(16))
    dt.requires_grad_(True)
    Bm.requires_grad_(True)
    y, h = pssm.ssd_chunked(xh, dt, A, Bm, Cm, 4)
    (y.sum() + h.sum()).backward()
    assert torch.isfinite(dt.grad).all() and torch.isfinite(Bm.grad).all()


# ---------------------------------------------------------------------------
# gradients and remat
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_grads(arch):
    cfg = make_smoke(get_config(arch))
    tree = carried_params(cfg)
    batch = make_batch(cfg)
    f = jax.jit(lambda p, b: jax.value_and_grad(
        lambda p: JT.train_loss(p, b, cfg)[0])(p))
    loss, g = f(jax.tree.map(jnp.asarray, tree),
                {k: jnp.asarray(v) for k, v in batch.items()})
    return cfg, tree, batch, float(loss), jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch):
    cfg, tree, batch, want_loss, want = jax_grads(arch)
    params = from_jax_params(tree, cfg, "cpu")
    loss, _, grads = value_and_grad(params, to_torch(batch), cfg)
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    got = to_jax_layout(grads, cfg)
    paths = jax.tree_util.tree_leaves_with_path(want)
    assert len(paths) == len(jax.tree.leaves(got))
    for (path, w), g in zip(paths, jax.tree.leaves(got)):
        assert tuple(g.shape) == w.shape, path
        bound = GRAD_RTOL * np.abs(w).max() + GRAD_ATOL
        assert _err(w, g) <= bound, (jax.tree_util.keystr(path),
                                     _err(w, g), bound)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-moe-a2.7b",
                                  "zamba2-2.7b"])
def test_remat_policies_give_the_same_gradients(arch):
    cfg = make_smoke(get_config(arch))
    params = from_jax_params(carried_params(cfg), cfg, "cpu")
    batch = to_torch(make_batch(cfg))
    out = {}
    for remat in ("none", "dots", "full"):
        out[remat] = value_and_grad(
            params, batch, dataclasses.replace(cfg, remat=remat,
                                               loss_chunk=8))
    for remat in ("dots", "full"):
        assert float(out[remat][0]) == float(out["none"][0])
        diffs = [_err(a, b) for a, b in zip(
            jax.tree.leaves(out[remat][2]), jax.tree.leaves(out["none"][2]))]
        assert max(diffs) < REMAT_TOL, remat
