"""Batched LM serving driver: prefill + greedy decode over a request queue
(port of ``repro/launch/serve.py``, with the same flags plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        [--smoke] [--requests 8 --batch 4 --prompt-len 32 --gen 16] \
        [--device cuda|cpu]

Requests arrive with prompts drawn from ``np.random.default_rng(seed)``,
are grouped into fixed-size batches (the last one padded with its first
request), prefilled once (filling KV caches sized to prompt + gen), then
decoded step by step with greedy sampling.  Per-batch latency and
aggregate tokens/s are printed as JAX's driver prints them.  Parameters
are random, drawn on the device from a ``torch.Generator`` seeded with
``--seed``; no weights are loaded.  The loop is :func:`serve`, which
takes given parameters and a cache dtype.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    generated: list


def make_queue(cfg, requests: int, prompt_len: int, rng) -> list:
    return [Request(i, rng.integers(0, cfg.vocab_size,
                                    size=prompt_len).astype(np.int32), [])
            for i in range(requests)]


def make_extras(cfg, batch: int, prompt_len: int, rng, device) -> dict:
    """Stub image embeddings (vlm) and encoder frames (audio), drawn after
    the queue from the same ``rng``, as JAX's driver draws them."""
    extras = {}
    if cfg.num_image_tokens:
        extras["image_embeds"] = rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model)).astype(np.float32) \
            * 0.02
    if cfg.encoder_segments:
        extras["encoder_frames"] = rng.standard_normal(
            (batch, max(prompt_len // cfg.audio_downsample, 1),
             cfg.d_model)).astype(np.float32) * 0.02
    return {k: torch.from_numpy(v).to(device) for k, v in extras.items()}


def serve(params, cfg, queue, *, batch: int, gen: int, max_len: int,
          extras=None, cache_dtype=torch.bfloat16, on_logits=None) -> dict:
    """Serve ``queue`` (a list of :class:`Request`, consumed) in batches of
    ``batch``: prefill, then ``gen`` greedy decode steps, each request's
    tokens appended to its ``generated``.  ``on_logits(batch_index, step,
    logits)`` sees the logits of the prefill (step 0) and of every decode
    step.  Returns the run's summary: tokens, wall and tokens/s, batch
    latencies, prefill and decode-step walls (host clock; each step ends
    in reading its tokens back)."""
    from repro_torch.models import transformer as T

    device = params["embed"]["tok"].device
    extras = extras or {}
    dec_extras = ({"image_embeds": extras["image_embeds"]}
                  if "image_embeds" in extras else {})
    queue = list(queue)
    t_start = time.perf_counter()
    total_tokens, lat, prefill_s, step_s = 0, [], [], []
    bi = 0
    while queue:
        batch_reqs = queue[:batch]
        queue = queue[batch:]
        while len(batch_reqs) < batch:                 # pad the last batch
            batch_reqs.append(batch_reqs[0])
        t0 = time.perf_counter()
        toks = torch.from_numpy(np.stack([r.prompt for r in batch_reqs]))
        logits, caches, pos = T.prefill(params, toks.to(device), cfg,
                                        max_len=max_len,
                                        cache_dtype=cache_dtype, **extras)
        nxt = torch.argmax(logits, dim=-1)[:, None]
        ids = nxt[:, 0].tolist()
        prefill_s.append(time.perf_counter() - t0)
        if on_logits is not None:
            on_logits(bi, 0, logits)
        for step in range(1, gen + 1):
            for i, r in enumerate(batch_reqs):
                r.generated.append(ids[i])
            ts = time.perf_counter()
            logits, caches, pos = T.decode_step(params, nxt, pos, caches,
                                                cfg, **dec_extras)
            nxt = torch.argmax(logits, dim=-1)[:, None]
            ids = nxt[:, 0].tolist()
            step_s.append(time.perf_counter() - ts)
            if on_logits is not None:
                on_logits(bi, step, logits)
        dt = time.perf_counter() - t0
        lat.append(dt)
        total_tokens += gen * len(batch_reqs)
        bi += 1
        print(f"[serve] batch of {len(batch_reqs)}: {dt*1e3:.0f} ms "
              f"({gen} tokens/req)", flush=True)

    wall = time.perf_counter() - t_start
    print(f"[serve] {total_tokens} tokens in {wall:.2f}s = "
          f"{total_tokens/wall:.1f} tok/s; "
          f"p50 batch latency {np.median(lat)*1e3:.0f} ms", flush=True)
    return dict(tokens=total_tokens, wall_s=wall,
                tokens_per_s=total_tokens / wall, batch_latency_s=lat,
                prefill_s=prefill_s, decode_step_s=step_s,
                device=str(device))


def main(argv=None) -> dict:
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.core.api import resolve_device
    from repro_torch.models import transformer as T

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs on the host")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = make_smoke(cfg)

    params = T.init_params(
        cfg, torch.Generator(dev).manual_seed(args.seed), dev)
    max_len = args.prompt_len + args.gen
    rng = np.random.default_rng(args.seed)
    queue = make_queue(cfg, args.requests, args.prompt_len, rng)
    extras = make_extras(cfg, args.batch, args.prompt_len, rng, dev)
    return serve(params, cfg, queue, batch=args.batch, gen=args.gen,
                 max_len=max_len, extras=extras)


if __name__ == "__main__":
    main()
