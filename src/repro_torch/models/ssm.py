"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block (port of
``repro/models/ssm.py``).

Training and prefill run the chunked SSD algorithm: the sequence is split
into chunks of ``ssm_chunk``; inside a chunk the quadratic (dual) form
runs as batched products, between chunks a sequential recurrence carries
the (H, P, N) state, a Python loop over the chunks where JAX scans.
Decode is the pure recurrence h = dA·h + dt·B⊗x.

Layout as JAX's: one fused ``in_proj`` giving [z | x | B | C | dt], a
causal depthwise conv over [x|B|C], a gated RMSNorm before ``out_proj``,
one B/C group.  The scan and the state are f32 whatever the parameters'
dtype.  The projections follow JAX's ``bf16_partial_reduce`` switch
(:func:`repro_torch.models.common.matmul_reduce`), except decode's input
projection, which JAX always accumulates in f32.

On a device mesh (a DTensor ``x``) each rank runs the block on its own
batch rows, whole on every model rank (:func:`_ssm_forward_mesh`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.sharding import rules


def init_ssm(cfg, generator, device):
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * N
    dt = cm.dtype_of(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": cm.dense_init((d, 2 * di + 2 * N + H), dt, generator,
                                 device, fan_in=d),
        "conv_w": cm.dense_init((cfg.ssm_conv, conv_dim), dt, generator,
                                device, fan_in=cfg.ssm_conv),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "A_log": torch.zeros((H,), **f32),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": torch.zeros((di,), dtype=dt, device=device),
        "out_proj": cm.dense_init((di, d), dt, generator, device, fan_in=di),
    }


def _split_proj(zxbcdt, cfg):
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * N]
    dt = zxbcdt[..., -H:]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv1d, kernel k: y[t] = sum_j w[j]*x[t-k+1+j]."""
    k, L = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, k - 1, 0))
    y = 0
    for j in range(k):                  # JAX's sum(), term by term
        y = y + pad[:, j:j + L, :] * w[j]
    return F.silu((y + b).float()).to(xBC.dtype)


def _segsum(x):
    """(..., Q) -> (..., Q, Q): S[i, j] = sum_{j < m <= i} x[m], -inf above
    the diagonal.  The mask is applied before any ``exp``, so no
    ``inf * 0`` reaches a gradient."""
    Q = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    i = torch.arange(Q, device=x.device)
    tri = i[:, None] >= i[None, :]
    return torch.where(tri, diff, torch.tensor(float("-inf"),
                                               device=x.device))


def ssd_chunked(xh, dt, A, Bm, Cm, chunk):
    """Chunked SSD scan.

    xh: (B, L, H, P); dt: (B, L, H); A: (H,); Bm, Cm: (B, L, N).
    Returns (y (B, L, H, P), final_state (B, H, P, N)).  JAX's
    three-operand score einsum is C·Bᵀ (B, nc, Q, Q) times the decay
    matrix, so no (.., Q, Q, N) product is ever built.
    """
    Bsz, L, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    assert L % Q == 0, (L, Q)
    nc = L // Q

    dA = dt * A[None, None, :]                                # (B, L, H) <= 0
    r = lambda t: t.reshape(Bsz, nc, Q, *t.shape[2:])
    xh, dt, dA, Bm, Cm = r(xh), r(dt), r(dA), r(Bm), r(Cm)

    dAh = dA.movedim(-1, 2)                                   # (B, nc, H, Q)
    Lmat = torch.exp(_segsum(dAh))                            # (B, nc, H, Q, Q)

    xdt = xh * dt[..., None]                                  # (B, nc, Q, H, P)
    xdt_h = xdt.permute(0, 1, 3, 2, 4)                        # (B, nc, H, Q, P)
    # intra-chunk (dual quadratic) term
    CB = torch.matmul(Cm, Bm.transpose(-1, -2))               # (B, nc, Q, Q)
    scores = CB[:, :, None] * Lmat                            # (B, nc, H, Q, Q)
    Y_diag = torch.matmul(scores, xdt_h)                      # (B, nc, H, Q, P)

    # per-chunk output states
    A_cum = torch.cumsum(dAh, dim=-1)                         # (B, nc, H, Q)
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)         # (B, nc, H, Q)
    states = torch.matmul((xdt_h * decay_states[..., None]).transpose(-1, -2),
                          Bm[:, :, None])                     # (B, nc, H, P, N)

    # inter-chunk recurrence (sequential over the nc chunks)
    chunk_decay = torch.exp(A_cum[..., -1])                   # (B, nc, H)
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(h)                        # the state *before* chunk c
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, 1)                        # (B, nc, H, P, N)

    # inter-chunk contribution
    state_decay = torch.exp(A_cum)                            # (B, nc, H, Q)
    Y_off = torch.matmul(Cm[:, :, None], prev_states.transpose(-1, -2)) \
        * state_decay[..., None]                              # (B, nc, H, Q, P)

    y = (Y_diag + Y_off).permute(0, 1, 3, 2, 4).reshape(Bsz, L, H, P)
    return y, h


def _gated_out(p, y, z, x, cfg):
    """Gated RMSNorm, then ``out_proj``."""
    y = cm.rmsnorm_nobias(y * F.silu(z.float()).to(x.dtype), p["norm"],
                          cfg.norm_eps)
    return cm.matmul_reduce(y, p["out_proj"], cfg)


def ssm_forward(p, x, cfg):
    """Full-sequence Mamba2 forward (train / prefill).

    x: (B, L, d).  Returns (y (B, L, d), (conv_tail, ssm_state)) with the
    states at the sequence's end (for decode to continue from); the conv
    tail is pre-conv, in the activations' dtype, the state f32.
    """
    if rules.is_dtensor(x):
        return _ssm_forward_mesh(p, x, cfg)
    Bsz, L, d = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = cm.matmul_reduce(x, p["in_proj"], cfg)
    z, xBC_pre, dt_raw = _split_proj(zxbcdt, cfg)
    xBC = _causal_conv(xBC_pre, p["conv_w"], p["conv_b"])
    xh = xBC[..., :di].reshape(Bsz, L, H, P)
    Bm = xBC[..., di:di + N]
    Cm = xBC[..., di + N:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    y, final_state = ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(),
                                 cfg.ssm_chunk)
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(Bsz, L, di).to(x.dtype)
    out = _gated_out(p, y, z, x, cfg)
    conv_tail = xBC_pre[:, -(cfg.ssm_conv - 1):]
    return out, (conv_tail, final_state.float())


def _ssm_forward_mesh(p, x, cfg):
    """:func:`ssm_forward` on DTensors: each rank runs its batch rows (the
    dp axes, when they divide the batch) on its own block, every model
    rank the whole block, as a ``shard_map`` body would.  The weights'
    gradients are partial sums over the data shards; every model rank
    holds the same values.  (DTensor's own rules would run the block on
    replicated tensors too, but torch 2.11's view rule refuses the
    head split's reshape on a (1, 2) mesh.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    sharded = x.shape[0] % rules.dp_size() == 0
    rows = Shard(0) if sharded else Replicate()
    x_pl = rules.layout(mesh, data=rows, model=Replicate())
    rep = (Replicate(),) * mesh.ndim
    w_grad = rules.layout(mesh, data=Partial() if sharded else Replicate(),
                          model=Replicate())
    xl = rules.local_block(x, mesh, x_pl, x_pl)
    pl = {k: rules.local_block(v, mesh, rep, w_grad) for k, v in p.items()}
    with rules.set_mesh(None):
        y, (conv_tail, state) = ssm_forward(pl, xl, cfg)
    wrap = lambda t: DTensor.from_local(t, mesh, x_pl, run_check=False)
    return wrap(y), (wrap(conv_tail), wrap(state))


def ssm_decode(p, x, cfg, conv_state, ssm_state):
    """One-token recurrence.  x: (B, 1, d); conv_state: (B, k-1, conv_dim);
    ssm_state: (B, H, P, N).  Returns (y, new_conv_state, new_ssm_state).
    The input projection is f32-accumulated, as JAX's always is."""
    if rules.is_dtensor(x):
        return _ssm_decode_mesh(p, x, cfg, conv_state, ssm_state)
    Bsz, _, d = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = cm.matmul(x, p["in_proj"])
    z, xBC_new, dt_raw = _split_proj(zxbcdt, cfg)
    window = torch.cat([conv_state, xBC_new], dim=1)          # (B, k, conv)
    w, b = p["conv_w"], p["conv_b"]
    wdt = torch.promote_types(window.dtype, w.dtype)
    y_conv = (window.float() * w.float()).sum(1).to(wdt) + b
    xBC = F.silu(y_conv.float()).to(x.dtype)
    xh = xBC[..., :di].reshape(Bsz, H, P)
    Bm = xBC[..., di:di + N]
    Cm = xBC[..., di + N:]
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None, :])                           # (B, H)
    xf = xh.float()
    h = ssm_state * dA[:, :, None, None] + (
        dt[:, :, None, None] * Bm.float()[:, None, None, :] * xf[..., None])
    y = torch.matmul(h, Cm.float()[:, None, :, None])[..., 0]  # (B, H, P)
    y = y + xf * p["D"][None, :, None]
    y = y.reshape(Bsz, 1, di).to(x.dtype)
    return _gated_out(p, y, z, x, cfg), window[:, 1:], h


def _ssm_decode_mesh(p, x, cfg, conv_state, ssm_state):
    """:func:`ssm_decode` on DTensors: each rank steps its batch rows (the
    dp axes, when they divide the batch) on its own block, every model
    rank the whole block, as :func:`_ssm_forward_mesh` runs the full
    sequence.  Returns the output and both states laid out by rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = x.device_mesh
    rows = Shard(0) if x.shape[0] % rules.dp_size() == 0 else Replicate()
    x_pl = rules.layout(mesh, data=rows, model=Replicate())
    rep = (Replicate(),) * mesh.ndim
    xl, cl, sl = (rules.local_block(t, mesh, x_pl)
                  for t in (x, conv_state, ssm_state))
    pl = {k: rules.local_block(v, mesh, rep) for k, v in p.items()}
    with rules.set_mesh(None):
        outs = ssm_decode(pl, xl, cfg, cl, sl)
    return tuple(DTensor.from_local(t, mesh, x_pl, run_check=False)
                 for t in outs)
