"""The port's attention-only LMs (repro_torch.models) against the JAX
package's, on the CPU, for the six archs whose layers are all attention
(gemma3-1b, gemma2-2b, qwen1.5-0.5b, phi4-mini, llama-3.2-vision with C
layers over stub image embeds, seamless-m4t with an E encoder and X
decoder layers).

Each arch's smoke config (f32) gets JAX's parameters, ``T.init_params(
PRNGKey(0), cfg)`` as ``tests/test_models.py`` draws them, with the leaves
JAX initialises to zero (norm scales, QKV biases, the tanh gates) set to
small numpy-drawn values so that every one of them acts; the same numpy
tree goes into JAX and, through ``from_jax_params``, into the port.
Tokens and stub embeddings are numpy-made.  JAX's side runs jitted, once
an arch, in a module-scoped fixture.  Bounds, fixed before measuring:

- forward hidden, ``logits_from_hidden``, ``cross_kv``, the encoder:
  max abs err <= 1e-4;
- ``train_loss`` (forward CE, chunked and unchunked, labels partly
  masked): relative <= 1e-5.

JAX's own model tests follow on the port: smoke shapes, the sliding
window, q-chunk exactness (1e-5), chunked CE == unchunked, label masking,
the parameter count (2%); and the four MoE / SSM archs are refused
(``NotImplementedError`` naming A.13b).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
from repro.configs import get_config, make_smoke
from repro.models import transformer as JT
from repro_torch.models import attention as pattn
from repro_torch.models import transformer as PT
from repro_torch.models.convert import from_jax_params

KEY = jax.random.PRNGKey(0)
ATTN_ARCHS = ("gemma3-1b", "gemma2-2b", "qwen1.5-0.5b", "phi4-mini-3.8b",
              "llama-3.2-vision-11b", "seamless-m4t-medium")
REFUSED_ARCHS = ("kimi-k2-1t-a32b", "qwen2-moe-a2.7b", "mamba2-130m",
                 "zamba2-2.7b")
TOL = 1e-4
LOSS_RTOL = 1e-5
B, S, LOSS_CHUNK = 2, 16, 8
ZERO_INIT = ("scale", "bq", "bk", "bv", "q_norm", "k_norm", "gate",
             "gate_ffn")


def _err(a, b):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b.detach() if isinstance(b, torch.Tensor) else b)
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))


def carried_params(cfg, seed=0):
    """JAX's parameters as numpy, the zero-initialised leaves drawn."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JT.init_params(KEY, cfg))

    def draw(path, a):
        name = getattr(path[-1], "key", None)
        if name in ZERO_INIT:
            return (rng.standard_normal(a.shape) * 0.3).astype(a.dtype)
        return np.array(a)
    return jax.tree_util.tree_map_with_path(draw, tree)


def make_batch(cfg, Bsz=B, Sq=S, seed=0):
    """Numpy tokens, labels (every third masked) and stub embeddings."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (Bsz, Sq)).astype(np.int32)
    labels[:, ::3] = -1
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (Bsz, Sq)).astype(np.int32),
             "labels": labels}
    if cfg.num_image_tokens:
        batch["image_embeds"] = (rng.standard_normal(
            (Bsz, cfg.num_image_tokens, cfg.d_model)) * 0.02
        ).astype(np.float32)
    if cfg.encoder_segments:
        batch["encoder_frames"] = (rng.standard_normal(
            (Bsz, Sq // cfg.audio_downsample, cfg.d_model)) * 0.02
        ).astype(np.float32)
    return batch


def extras(batch):
    return {k: batch[k] for k in ("image_embeds", "encoder_frames")
            if k in batch}


def to_torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def jax_reference(cfg, tree, batch):
    """Everything the tests hold the port to, computed once by JAX."""
    params = jax.tree.map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ex = extras(jb)

    @jax.jit
    def run(params, jb):
        ex = extras(jb)
        x, _, _ = JT.forward(params, jb["tokens"], cfg, **ex)
        out = {"hidden": x, "logits": JT.logits_from_hidden(params, x, cfg)}
        unmasked = dict(jb, labels=jnp.maximum(jb["labels"], 0))
        out["loss_unmasked"] = JT.train_loss(params, unmasked, cfg)[0]
        out["loss"] = JT.train_loss(params, jb, cfg)[0]
        out["loss_chunked"] = JT.train_loss(
            params, jb, dataclasses.replace(cfg, loss_chunk=LOSS_CHUNK))[0]
        return out

    ref = jax.tree.map(np.asarray, run(params, jb))
    kinds = PT.layer_kinds(cfg.segments)
    for kind, ctx_key in (("C", "image_embeds"), ("X", "encoder_frames")):
        if kind in kinds:
            seg, (pat, _) = next((i, s) for i, s in enumerate(cfg.segments)
                                 if kind in s[0])
            first = pat.index(kind)
            p = jax.tree.map(lambda a: a[0],
                             params["segments"][seg][first]["xattn"])
            ctx = ex[ctx_key]
            if kind == "X":
                ctx = JT._encode(params, ctx, cfg)
                ref["encoder_out"] = np.asarray(ctx)
            ref["cross_kv"] = tuple(np.asarray(a)
                                    for a in jattn.cross_kv(p, ctx, cfg))
            ref["cross_layer"] = kinds.index(kind)
    return ref


@functools.lru_cache(maxsize=None)
def reference(arch):
    cfg = make_smoke(get_config(arch))
    tree = carried_params(cfg)
    batch = make_batch(cfg)
    return cfg, tree, batch, jax_reference(cfg, tree, batch)


@pytest.fixture(scope="module", params=ATTN_ARCHS)
def case(request):
    return reference(request.param)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# the six archs against JAX
# ---------------------------------------------------------------------------

def test_forward_hidden_and_logits_match_jax(case):
    cfg, tree, batch, ref = case
    params = from_jax_params(tree, cfg, "cpu")
    tb = to_torch(batch)
    x, caches, aux = PT.forward(params, tb["tokens"], cfg, **extras(tb))
    assert caches is None and float(aux) == 0.0
    assert x.shape == (B, S, cfg.d_model)
    assert _err(ref["hidden"], x) <= TOL
    logits = PT.logits_from_hidden(params, x, cfg)
    assert logits.dtype == torch.float32
    assert _err(ref["logits"], logits) <= TOL


def test_train_loss_matches_jax_chunked_and_masked(case):
    """JAX's chunked-CE and label-masking tests, each value held to JAX's."""
    cfg, tree, batch, ref = case
    params = from_jax_params(tree, cfg, "cpu")
    tb = to_torch(batch)
    got = {
        "loss_unmasked": PT.train_loss(
            params, dict(tb, labels=tb["labels"].clamp(min=0)), cfg)[0],
        "loss": PT.train_loss(params, tb, cfg)[0],
        "loss_chunked": PT.train_loss(
            params, tb, dataclasses.replace(cfg, loss_chunk=LOSS_CHUNK))[0],
    }
    for k, v in got.items():
        assert np.isfinite(float(v)) and float(v) > 0, k
        assert abs(float(v) - float(ref[k])) <= LOSS_RTOL * abs(
            float(ref[k])), (k, float(v), float(ref[k]))
    assert np.isclose(float(got["loss"]), float(got["loss_chunked"]),
                      rtol=1e-5)
    assert not np.isclose(float(got["loss"]), float(got["loss_unmasked"]))


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_cross_kv_and_encoder_match_jax(arch):
    cfg, tree, batch, ref = reference(arch)
    params = from_jax_params(tree, cfg, "cpu")
    ctx = to_torch(extras(batch))
    if "encoder_out" in ref:
        enc = PT._encode(params, ctx["encoder_frames"], cfg)
        assert _err(ref["encoder_out"], enc) <= TOL
        ctx = enc
    else:
        ctx = ctx["image_embeds"]
    k, v = pattn.cross_kv(params["layers"][ref["cross_layer"]]["xattn"],
                          ctx, cfg)
    assert _err(ref["cross_kv"][0], k) <= TOL
    assert _err(ref["cross_kv"][1], v) <= TOL


def test_from_jax_params_carries_every_leaf(case):
    """Every leaf of every rep lands at its flat layer, bitwise."""
    cfg, tree, _, _ = case
    params = from_jax_params(tree, cfg, "cpu")
    n_port = len(jax.tree.leaves(params))
    n_jax = sum(np.shape(a)[0] if any(getattr(k, "key", None) in
                                      ("segments", "enc_segments")
                                      for k in path) else 1
                for path, a in jax.tree_util.tree_leaves_with_path(tree))
    assert n_port == n_jax
    kinds = PT.layer_kinds(cfg.segments)
    flat = 0
    for si, (pat, rep) in enumerate(cfg.segments):
        for r in range(rep):
            for i, kind in enumerate(pat):
                assert kinds[flat] == kind
                want = jax.tree.map(lambda a: a[r], tree["segments"][si][i])
                got = params["layers"][flat]
                for (pw, w), (pg, g) in zip(
                        jax.tree_util.tree_leaves_with_path(want),
                        jax.tree_util.tree_leaves_with_path(got)):
                    assert pw == pg
                    assert np.array_equal(w, g.numpy()), (flat, pw)
                flat += 1
    assert np.array_equal(params["embed"]["tok"].numpy(),
                          tree["embed"]["tok"])
    bf16 = from_jax_params(tree, cfg, "cpu", dtype=torch.bfloat16)
    assert {t.dtype for t in jax.tree.leaves(bf16)} == {torch.bfloat16}


def test_init_params_matches_param_count_and_layout(case):
    """JAX's test_param_count_matches_instantiated (2%) on the port's own
    init, whose leaves have the carried tree's paths and shapes and JAX's
    instantiated count.  ``param_count`` counts no X layer
    (``configs/base.py``: kinds GLDE, C, M, S), so for seamless-m4t the
    instantiated count alone is held."""
    cfg, tree, _, _ = case
    own = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    actual = sum(t.numel() for t in jax.tree.leaves(own))
    assert actual == sum(np.size(a) for a in jax.tree.leaves(tree))
    if "X" not in cfg.layer_kinds():
        assert abs(actual - cfg.param_count()) / actual < 0.02
    carried = from_jax_params(tree, cfg, "cpu")
    assert jax.tree.structure(own) == jax.tree.structure(carried)
    assert [t.shape for t in jax.tree.leaves(own)] == \
           [t.shape for t in jax.tree.leaves(carried)]
    assert {t.dtype for t in jax.tree.leaves(own)} == {torch.float32}


def test_smoke_forward_and_train_step(case):
    """JAX's test_arch_smoke_forward_and_train_step on the port's init."""
    cfg, _, batch, _ = case
    params = PT.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    tb = to_torch(batch)
    x, _, _ = PT.forward(params, tb["tokens"], cfg, **extras(tb))
    assert x.shape == (B, S, cfg.d_model) and torch.isfinite(x).all()
    loss, metrics = PT.train_loss(params, tb, cfg)
    assert np.isfinite(float(loss)) and float(loss) > 0
    assert float(metrics["ce"]) == float(loss)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_from_jax_params_refuses_a_mismatched_tree():
    cfg = make_smoke(get_config("gemma2-2b"))
    tree = carried_params(cfg)
    bad = jax.tree.map(lambda a: a, tree)
    del bad["segments"][0][1]["attn"]["wq"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_params(bad, cfg, "cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["embed"]["tok"] = bad["embed"]["tok"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(bad, cfg, "cpu")
    bad = dict(tree, shared={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        from_jax_params(bad, cfg, "cpu")
    bad = dict(tree, segments=(tree["segments"][0],) * 2)
    with pytest.raises(ValueError, match="segments"):
        from_jax_params(bad, cfg, "cpu")
    other = make_smoke(get_config("phi4-mini-3.8b"))
    with pytest.raises(ValueError):
        from_jax_params(tree, other, "cpu")


@pytest.mark.parametrize("arch", REFUSED_ARCHS)
def test_moe_and_ssm_archs_are_refused(arch):
    cfg = make_smoke(get_config(arch))
    for call in (lambda: PT.init_params(cfg, None, "cpu"),
                 lambda: PT.init_params(cfg, None, "meta"),
                 lambda: PT.init_cache(cfg, 1, 8, torch.float32, "cpu"),
                 lambda: from_jax_params({}, cfg, "cpu")):
        with pytest.raises(NotImplementedError, match="A.13b"):
            call()


def test_default_device_is_cuda():
    cfg = make_smoke(get_config("gemma2-2b"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        PT.init_params(cfg)


# ---------------------------------------------------------------------------
# attention (JAX's own tests, then port vs JAX)
# ---------------------------------------------------------------------------

def _qkv(seed, Bsz, Sq, H, hd, KV=None):
    rng = np.random.default_rng(seed)
    KV = KV or H
    return (rng.standard_normal((Bsz, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((Bsz, Sq, KV, hd)).astype(np.float32),
            rng.standard_normal((Bsz, Sq, KV, hd)).astype(np.float32))


def _attend(q, k, v, **kw):
    Bsz, Sq = q.shape[:2]
    pos = torch.arange(Sq).expand(Bsz, Sq)
    return pattn.attend(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), q_pos=pos, k_pos=pos,
                        k_valid=torch.ones(Bsz, Sq, dtype=torch.bool), **kw)


def test_sliding_window_restricts_attention():
    """A local layer with window w must ignore tokens older than w."""
    q, k, v = _qkv(2, 1, 12, 2, 8)
    full = _attend(q, k, v, causal=True, window=0)
    win = _attend(q, k, v, causal=True, window=4)
    assert torch.allclose(full[:, :4], win[:, :4], atol=1e-5)
    assert not torch.allclose(full[:, -1], win[:, -1])
    assert torch.allclose(full, _attend(q, k, v, causal=True, window=12),
                          atol=1e-5)


def test_q_chunking_is_exact():
    q, k, v = _qkv(3, 2, 32, 4, 16)
    a = _attend(q, k, v, causal=True, window=0, q_chunk=0)
    b = _attend(q, k, v, causal=True, window=0, q_chunk=8)
    assert torch.allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("kv,causal,window,cap,chunk", [
    (4, True, 0, 0.0, 0), (2, True, 0, 0.0, 0), (1, True, 5, 0.0, 0),
    (2, True, 6, 50.0, 8), (2, False, 0, 50.0, 0), (4, False, 0, 0.0, 16),
])
def test_attend_matches_jax(kv, causal, window, cap, chunk):
    """Grouped KV heads, causal or not, window, score softcap, q chunks."""
    q, k, v = _qkv(5, 2, 32, 4, 16, kv)
    pos = jnp.broadcast_to(jnp.arange(32)[None], (2, 32))
    want = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_pos=pos, k_pos=pos,
                        k_valid=jnp.ones((2, 32), bool), causal=causal,
                        window=window, attn_softcap=cap, q_chunk=chunk)
    got = _attend(q, k, v, causal=causal, window=window, attn_softcap=cap,
                  q_chunk=chunk)
    assert _err(want, got) <= TOL
