"""LM serving in the port (prefill / decode_step, repro_torch.launch.serve,
repro_torch.examples.serve_batch) against the JAX package's, on the CPU.

All ten archs' smoke configs (f32) get JAX's parameters with their
zero-initialised leaves drawn (``test_torch_lm_models``'s
``carried_params``); a numpy batch is prefilled for its first half and
decoded teacher-forced for the rest, by JAX (jitted, once an arch, in a
module-scoped fixture) and by the port.  Bounds, fixed before measuring:

- the prefill's and every decode step's logits, ``cache_dtype=float32``:
  max abs err <= 1e-4;
- the same with the default bf16 cache: <= 2e-2 (one bf16 ulp at 1.0 is
  7.8e-3, and an f32 difference of 1e-7 flips some cache roundings);
- the port's own prefill + decode against its forward: < 2e-3 (JAX's
  ``test_decode_matches_forward`` bound, with its ``capacity_factor=64``
  so no MoE assignment drops);
- the serve loop against JAX's greedy loop (``repro/launch/serve.py``'s,
  with the JAX driver's parameters and queue), gemma2-2b smoke and
  mamba2-130m smoke (the arch of JAX's own driver test), f32 cache: token
  ids equal and every step's logits <= 1e-4; the same with the default
  bf16 cache on mamba2-130m, whose greedy tokens are JAX's.

The drivers run on the CPU with ``--device cpu``; their default device,
CUDA, raises without a GPU.  The card against the CPU is in
``test_torch_cuda.py`` (no JAX on the card's machine).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_config, make_smoke
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch.examples import serve_batch
from repro_torch.launch import serve as pserve
from repro_torch.models import transformer as PT
from repro_torch.models.convert import from_jax_params
from test_torch_lm_models import (_err, carried_params, extras, make_batch,
                                  to_torch)

TOL = 1e-4
BF16_CACHE_TOL = 2e-2
DECODE_TOL = 2e-3
HALF = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_teacher_forced(cfg, params, batch, cache_dtype):
    """JAX's prefill of the first HALF tokens, then decode steps fed the
    batch's own tokens: the logits of the prefill and of every step."""
    ex = {k: jnp.asarray(v) for k, v in extras(batch).items()}
    dex = ({"image_embeds": ex["image_embeds"]}
           if "image_embeds" in ex else {})
    toks = jnp.asarray(batch["tokens"])
    S = toks.shape[1]
    prefill = jax.jit(lambda p, t, ex: JT.prefill(
        p, t, cfg, max_len=S, cache_dtype=cache_dtype, **ex))
    decode = jax.jit(lambda p, t, pos, c, ex: JT.decode_step(
        p, t, pos, c, cfg, **ex))
    logits, caches, pos = prefill(params, toks[:, :HALF], ex)
    out = [np.asarray(logits)]
    for t in range(HALF, S):
        logits, caches, pos = decode(params, toks[:, t:t + 1], pos, caches,
                                     dex)
        out.append(np.asarray(logits))
    return np.stack(out, 1)


def port_teacher_forced(cfg, params, batch, cache_dtype, device="cpu"):
    tb = {k: v.to(device) for k, v in to_torch(batch).items()}
    ex = extras(tb)
    dex = ({"image_embeds": ex["image_embeds"]}
           if "image_embeds" in ex else {})
    toks = tb["tokens"]
    S = toks.shape[1]
    logits, caches, pos = PT.prefill(params, toks[:, :HALF], cfg,
                                     max_len=S, cache_dtype=cache_dtype,
                                     **ex)
    out = [logits]
    for t in range(HALF, S):
        logits, caches, pos = PT.decode_step(params, toks[:, t:t + 1], pos,
                                             caches, cfg, **dex)
        out.append(logits)
    assert pos.tolist() == [S] * toks.shape[0]
    return torch.stack(out, 1)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    cfg = make_smoke(get_config(request.param))
    tree = carried_params(cfg)
    batch = make_batch(cfg, seed=1)
    jp = jax.tree.map(jnp.asarray, tree)
    ref = {dt: jax_teacher_forced(cfg, jp, batch, getattr(jnp, dt))
           for dt in ("float32", "bfloat16")}
    return cfg, tree, batch, ref


def test_prefill_decode_f32_cache_match_jax(case):
    cfg, tree, batch, ref = case
    params = from_jax_params(tree, cfg, "cpu")
    got = port_teacher_forced(cfg, params, batch, torch.float32)
    assert got.shape == ref["float32"].shape
    assert _err(ref["float32"], got) <= TOL


def test_prefill_decode_bf16_cache_match_jax(case):
    """The default cache: decode attends an f32 query over bf16 K/V and
    rounds its attention output to bf16, as JAX's."""
    cfg, tree, batch, ref = case
    params = from_jax_params(tree, cfg, "cpu")
    got = port_teacher_forced(cfg, params, batch, torch.bfloat16)
    assert _err(ref["bfloat16"], got) <= BF16_CACHE_TOL
    # the bf16 cache is not the f32 one: the casts are there (a Mamba2
    # entry keeps prefill's conv tail in the activations' dtype and its
    # state in f32, so an all-M stack has none)
    if set(cfg.layer_kinds()) != {"M"}:
        assert _err(ref["float32"], got) > 0


def test_decode_matches_forward(case):
    """JAX's test_decode_matches_forward, on the port against itself."""
    cfg, tree, batch, _ = case
    cfg = dataclasses.replace(cfg, capacity_factor=64.0)
    params = from_jax_params(tree, cfg, "cpu")
    tb = to_torch(batch)
    x, _, _ = PT.forward(params, tb["tokens"], cfg, **extras(tb))
    full = PT.logits_from_hidden(params, x, cfg)
    got = port_teacher_forced(cfg, params, batch, torch.float32)
    assert float((got - full[:, HALF - 1:]).abs().max()) < DECODE_TOL


# ---------------------------------------------------------------------------
# the serving loop and the drivers
# ---------------------------------------------------------------------------

def jax_greedy(cfg, params, queue, batch, gen, max_len, cache_dtype):
    """``repro/launch/serve.py``'s loop with given parameters and cache
    dtype: every request's tokens and every step's logits."""
    prefill = jax.jit(lambda p, t: JT.prefill(
        p, t, cfg, max_len=max_len, cache_dtype=cache_dtype))
    decode = jax.jit(lambda p, tok, pos, c: JT.decode_step(
        p, tok, pos, c, cfg))
    logits_by_step, tokens = [], {}
    while queue:
        reqs, queue = queue[:batch], queue[batch:]
        while len(reqs) < batch:
            reqs.append(reqs[0])
        toks = jnp.stack([jnp.asarray(r.prompt) for r in reqs])
        logits, caches, pos = prefill(params, toks)
        logits_by_step.append(np.asarray(logits))
        nxt = jnp.argmax(logits, axis=-1)[:, None]
        for _ in range(gen):
            for i, r in enumerate(reqs):
                r.generated.append(int(nxt[i, 0]))
            logits, caches, pos = decode(params, nxt, pos, caches)
            logits_by_step.append(np.asarray(logits))
            nxt = jnp.argmax(logits, axis=-1)[:, None]
        tokens.update({r.rid: list(r.generated) for r in reqs})
    return tokens, logits_by_step


@pytest.mark.parametrize("arch,cache", [
    ("gemma2-2b", "float32"), ("mamba2-130m", "float32"),
    ("mamba2-130m", "bfloat16")])
def test_serve_loop_matches_jax_greedy(arch, cache):
    """The smoke config at the JAX driver's defaults and seed 0: its
    parameters, its queue (``np.random.default_rng(0)``)."""
    cfg = make_smoke(get_config(arch))
    requests, batch, prompt_len, gen = 8, 4, 32, 16
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    queue = pserve.make_queue(cfg, requests, prompt_len,
                              np.random.default_rng(0))
    rng = np.random.default_rng(0)          # the JAX driver's draws
    jqueue = [jserve.Request(i, rng.integers(0, cfg.vocab_size,
                                             size=prompt_len
                                             ).astype(np.int32), [])
              for i in range(requests)]
    for a, b in zip(queue, jqueue):
        assert np.array_equal(a.prompt, b.prompt)
    want_tokens, want_logits = jax_greedy(
        cfg, jax.tree.map(jnp.asarray, tree), jqueue, batch, gen,
        prompt_len + gen, getattr(jnp, cache))
    got_logits = []
    summary = pserve.serve(
        from_jax_params(tree, cfg, "cpu"), cfg, list(queue), batch=batch,
        gen=gen, max_len=prompt_len + gen, cache_dtype=getattr(torch, cache),
        on_logits=lambda bi, step, lg: got_logits.append(lg.numpy()))
    assert {r.rid: r.generated for r in queue} == want_tokens
    assert len(got_logits) == len(want_logits) == 2 * (gen + 1)
    errs = [_err(w, g) for w, g in zip(want_logits, got_logits)]
    assert max(errs) <= TOL, errs
    assert summary["tokens"] == requests * gen
    assert len(summary["decode_step_s"]) == 2 * gen


def _shape_of(out: str) -> list:
    """Printed lines with their numbers blanked."""
    return [re.sub(r"[0-9.]+", "#", line) for line in out.splitlines()
            if line.startswith("[serve]")]


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m"])
def test_main_prints_what_jax_prints(arch, capsys):
    jserve.main(["--arch", arch, "--smoke", "--requests", "5"])
    want = _shape_of(capsys.readouterr().out)
    s = pserve.main(["--arch", arch, "--smoke", "--requests", "5",
                     "--device", "cpu"])
    assert _shape_of(capsys.readouterr().out) == want
    assert len(want) == 3                  # 2 batches (the last padded) + total
    assert s["tokens"] == 2 * 4 * 16 and s["device"] == "cpu"


def test_make_extras_draws_as_jax_driver():
    """Stub embeds come from the same rng after the queue, at JAX's shapes."""
    for arch in ("llama-3.2-vision-11b", "seamless-m4t-medium"):
        cfg = make_smoke(get_config(arch))
        rng = np.random.default_rng(3)
        pserve.make_queue(cfg, 2, 24, rng)
        got = pserve.make_extras(cfg, 2, 24, rng, "cpu")
        rng = np.random.default_rng(3)
        for _ in range(2):
            rng.integers(0, cfg.vocab_size, size=24)
        if cfg.num_image_tokens:
            want = rng.standard_normal(
                (2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
            assert np.array_equal(got["image_embeds"].numpy(), want * 0.02)
        else:
            want = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
            assert np.array_equal(got["encoder_frames"].numpy(), want * 0.02)


@pytest.mark.parametrize("argv", [
    [], ["--arch", "llama-3.2-vision-11b"],
    ["--arch", "seamless-m4t-medium", "--gen", "4"],
    ["--arch", "zamba2-2.7b", "--gen", "4"],
])
def test_serve_batch_example_runs(argv, capsys):
    s = serve_batch.main(argv + ["--device", "cpu"])
    gen = 4 if "--gen" in argv else 16
    assert s["tokens"] == 8 * gen
    assert "tok/s" in capsys.readouterr().out


def test_drivers_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    for main in (pserve.main, serve_batch.main):
        with pytest.raises(RuntimeError, match="CUDA GPU"):
            main(["--arch", "gemma2-2b", "--smoke"])
