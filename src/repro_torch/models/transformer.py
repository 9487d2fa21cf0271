"""LM driver: init / forward / loss / prefill / decode (port of
``repro/models/transformer.py`` for the attention-only archs).

The stack is a list of segments (pattern, n_rep).  JAX stacks a segment's
parameters over reps and scans them; eager torch has no program size to
save, so the port unrolls the stack: ``params["layers"]`` holds one dict a
layer, flat layer ``offset(si) + rep * len(pat) + i`` for position ``i``
of rep ``rep`` of segment ``si`` (the order JAX's scan runs them in), and
the encoder's in ``params["enc_layers"]`` likewise.  Caches are one entry
a decoder layer in the same order; prefill fills them and decode writes
them in place.

One driver covers four of the six assigned families:
  dense              decoder-only segments (G/L/D kinds)
  vlm                C kinds cross-attending to stub image embeddings
  audio (enc-dec)    encoder_segments (E) + decoder segments (X)
The MoE, SSM and hybrid archs raise ``NotImplementedError`` (ROADMAP
A.13b), before any parameter is allocated.  ``train_loss`` is forward
only here; gradients and remat come with training (A.13b).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.api import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import common as cm
from repro_torch.sharding.rules import constrain


def layer_kinds(segments) -> list[str]:
    """The flat layer order of ``segments``: rep by rep, the pattern
    inside each rep."""
    return [kind for pat, rep in segments for _ in range(rep) for kind in pat]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg, generator=None, device="cuda") -> dict:
    """Random parameters at ``cfg``'s widths, drawn on ``device`` from
    ``generator`` (a ``torch.Generator`` on that device; None takes
    torch's default).  ``device="meta"`` gives the shapes alone."""
    dev = resolve_device(device)
    dec, enc = layer_kinds(cfg.segments), layer_kinds(cfg.encoder_segments)
    for kind in dec + enc:
        B._refuse(kind, cfg)
    dt = cm.dtype_of(cfg)
    params: dict[str, Any] = {
        "embed": cm.init_embed(cfg, generator, dev),
        "final_ln": cm.init_rmsnorm(cfg.d_model, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = cm.dense_init((cfg.d_model, cfg.vocab_size), dt,
                                          generator, dev)
    params["layers"] = [B.init_layer(kind, cfg, generator, dev)
                        for kind in dec]
    if enc:
        params["enc_layers"] = [B.init_layer(kind, cfg, generator, dev)
                                for kind in enc]
        params["enc_final_ln"] = cm.init_rmsnorm(cfg.d_model, dt, dev)
    return params


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    dev = resolve_device(device)
    return [B.init_cache_entry(kind, cfg, batch, max_len, dtype, dev)
            for kind in layer_kinds(cfg.segments)]


# ---------------------------------------------------------------------------
# stack runners
# ---------------------------------------------------------------------------

def _auto_q_chunk(S: int) -> int:
    if S >= 4_096:
        return 512
    return 0


def _positions(Bsz: int, S: int, device):
    return torch.arange(S, device=device).expand(Bsz, S)


def _run_stack_full(kinds, layers, x, positions, cfg, *, ctx, caches,
                    q_chunk):
    """Train (caches=None) or prefill (caches given) pass over the stack."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, kind in enumerate(kinds):
        x, entry, aux = B.apply_layer_full(
            layers[i], kind, x, positions, cfg, ctx=ctx,
            entry=None if caches is None else caches[i], q_chunk=q_chunk)
        x = constrain(x, "hidden")
        aux_total = aux_total + aux
    return x, caches, aux_total


def _encode(params, frames, cfg):
    """Run the encoder stack on stub frame embeddings (B, T, d)."""
    Bsz, T, _ = frames.shape
    x, _, _ = _run_stack_full(
        layer_kinds(cfg.encoder_segments), params["enc_layers"], frames,
        _positions(Bsz, T, frames.device), cfg, ctx=None, caches=None,
        q_chunk=_auto_q_chunk(T))
    return cm.rmsnorm(x, params["enc_final_ln"], cfg.norm_eps)


def _build_ctx(params, cfg, image_embeds=None, encoder_frames=None):
    ctx = {}
    if image_embeds is not None:
        ctx["image_embeds"] = image_embeds
    if encoder_frames is not None:
        ctx["encoder_out"] = _encode(params, encoder_frames, cfg)
    return ctx or None


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward(params, tokens, cfg, *, image_embeds=None, encoder_frames=None,
            caches=None, q_chunk=None):
    """Full forward.  Returns (hidden (B,S,d), caches, aux); given caches
    are filled in place."""
    Bsz, S = tokens.shape
    positions = _positions(Bsz, S, tokens.device)
    x = cm.embed(tokens, params["embed"], cfg)
    ctx = _build_ctx(params, cfg, image_embeds, encoder_frames)
    qc = _auto_q_chunk(S) if q_chunk is None else q_chunk
    x, caches, aux = _run_stack_full(
        layer_kinds(cfg.segments), params["layers"], x, positions, cfg,
        ctx=ctx, caches=caches, q_chunk=qc)
    x = cm.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return x, caches, aux


def logits_from_hidden(params, x, cfg):
    return cm.unembed(x, params["embed"], cfg, params.get("lm_head"))


def lm_loss(params, x, labels, cfg):
    """Chunked cross-entropy: logits are materialized ``loss_chunk``
    tokens at a time, summed chunk by chunk in JAX's order."""
    Bsz, S, d = x.shape
    chunk = cfg.loss_chunk
    valid = labels >= 0
    safe_labels = labels.clamp(min=0)

    def ce(xc, lc, vc):
        logits = logits_from_hidden(params, xc, cfg)          # (B, c, V) f32
        logits = constrain(logits, "logits")
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        return torch.sum((lse - gold) * vc)

    if chunk and S > chunk and S % chunk == 0:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(0, S, chunk):
            sl = slice(c, c + chunk)
            total = total + ce(x[:, sl], safe_labels[:, sl], valid[:, sl])
    else:
        total = ce(x, safe_labels, valid)
    denom = valid.sum().clamp(min=1)
    return total / denom


def train_loss(params, batch, cfg):
    """batch: dict(tokens, labels[, image_embeds, encoder_frames]).
    Returns (loss, metrics).  Forward only: no gradient is taken."""
    x, _, aux = forward(
        params, batch["tokens"], cfg,
        image_embeds=batch.get("image_embeds"),
        encoder_frames=batch.get("encoder_frames"))
    loss = lm_loss(params, x, batch["labels"], cfg)
    return loss + aux, {"ce": loss, "aux": aux}


def prefill(params, tokens, cfg, *, max_len: int, image_embeds=None,
            encoder_frames=None, cache_dtype=torch.bfloat16):
    """Fill the KV caches for ``tokens`` and return last-token logits.

    Returns (logits (B, vocab), caches, pos (B,))."""
    Bsz, S = tokens.shape
    caches = init_cache(cfg, Bsz, max_len, cache_dtype, tokens.device)
    x, caches, _ = forward(params, tokens, cfg, image_embeds=image_embeds,
                           encoder_frames=encoder_frames, caches=caches)
    logits = logits_from_hidden(params, x[:, -1:], cfg)[:, 0]
    pos = torch.full((Bsz,), S, dtype=torch.long, device=tokens.device)
    return logits, caches, pos


def decode_step(params, token, pos, caches, cfg, *, image_embeds=None):
    """One serving step: token (B, 1) -> logits (B, vocab), the caches
    written in place.

    ``pos`` (B,) is the write index for this token (tokens so far).
    ``image_embeds`` is accepted as JAX's is and not read: C layers take
    their context K/V from the cache prefill filled.
    """
    x = cm.embed(token, params["embed"], cfg)
    for p, kind, entry in zip(params["layers"], layer_kinds(cfg.segments),
                              caches):
        x, _ = B.apply_layer_decode(p, kind, x, pos, entry, cfg)
        x = constrain(x, "hidden")
    x = cm.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = logits_from_hidden(params, x, cfg)[:, 0]
    return logits, caches, pos + 1
