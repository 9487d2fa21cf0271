"""Model / run configuration schema.

One frozen dataclass covers every assigned architecture family
(dense | moe | ssm | hybrid | vlm | audio).  The layer stack is described by
``segments``: an ordered list of (pattern, n_rep) pairs, where ``pattern`` is
a string of per-layer kinds repeated ``n_rep`` times.  The JAX package
stacks a segment's parameters over reps and scans them; the port keeps one
parameter set a layer, in the same order (rep by rep, the pattern inside
each rep).  A copy of ``repro/configs/base.py``: the configurations are
the two packages' shared contract.

Layer kinds:
    G  global (full / causal) attention + FFN (dense or MoE per config)
    L  local sliding-window attention + FFN
    C  cross-attention (+ FFN) — VLM image layers, enc-dec decoder layers
    M  Mamba2 (SSD) block
    S  Mamba2 block followed by the *shared* attention block (Zamba2)
    D  attention + dense FFN even when the model is MoE (Kimi's first layer)
    E  encoder self-attention (bidirectional) + FFN  (enc-dec encoder)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

Segments = Tuple[Tuple[str, int], ...]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    segments: Segments               # decoder / main stack
    # ---- attention ----
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0        # 0 = off (gemma2: 50.0)
    logit_softcap: float = 0.0       # 0 = off (gemma2: 30.0)
    rope_theta: float = 10_000.0
    local_rope_theta: Optional[float] = None   # gemma3: local layers use 10k
    sliding_window: int = 0          # window for 'L' layers
    use_post_norms: bool = False     # gemma2/3 sandwich norms
    # ---- MoE ----
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    expert_pad_to: int = 0           # pad expert count for EP divisibility
    moe_impl: str = "gspmd"          # gspmd | ep (shard_map expert-parallel)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # ---- SSM (Mamba2 / SSD) ----
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # ---- VLM ----
    num_image_tokens: int = 0        # vision stub sequence length
    # ---- enc-dec (audio) ----
    encoder_segments: Segments = ()
    audio_downsample: int = 8        # frames = seq_len // downsample
    # ---- numerics / misc ----
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma: scale embeddings by sqrt(d)
    remat: str = "full"              # none | dots | full (block-granularity)
    bf16_partial_reduce: bool = False  # TP partial-sums reduced in bf16
                                       # (halves Megatron-AR bytes; §Perf)
    loss_chunk: int = 512            # CE computed seq-chunked (0 = off)

    # ------------------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return sum(len(p) * r for p, r in self.segments)

    @property
    def d_inner(self) -> int:        # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attn_out_dim(self) -> int:
        return self.num_heads * self.head_dim

    def layer_kinds(self) -> list[str]:
        out = []
        for pat, rep in self.segments:
            out.extend(list(pat) * rep)
        return out

    # ---- analytic parameter / FLOP accounting (roofline §) -------------
    def param_count(self) -> int:
        d, hd = self.d_model, self.head_dim
        n = 0
        n += self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for kind in self.layer_kinds():
            if kind in "GLDE":
                n += d * (self.num_heads + 2 * self.num_kv_heads) * hd
                n += self.num_heads * hd * d
                if kind == "D" or self.num_experts == 0:
                    n += 3 * d * self.d_ff
                else:
                    n += self.num_experts * 3 * d * self.moe_d_ff
                    n += self.num_shared_experts * 3 * d * self.moe_d_ff
                    n += d * self.num_experts      # router
            elif kind == "C":
                n += d * (self.num_heads + 2 * self.num_kv_heads) * hd
                n += self.num_heads * hd * d
                n += 3 * d * self.d_ff
            elif kind in "MS":
                di, ns = self.d_inner, self.ssm_state
                n += d * (2 * di + 2 * ns + self.ssm_heads)  # in_proj
                n += di * d                                   # out_proj
                n += (di + 2 * ns) * self.ssm_conv            # conv
                n += 3 * self.ssm_heads                       # A, D, dt_bias
                if kind == "S":
                    pass  # shared block counted once below
        if any("S" in p for p, _ in self.segments):
            n += d * (self.num_heads + 2 * self.num_kv_heads) * hd
            n += self.num_heads * hd * d + 3 * d * self.d_ff
        for pat, rep in self.encoder_segments:
            for kind in pat * rep:
                n += d * (self.num_heads + 2 * self.num_kv_heads) * hd
                n += self.num_heads * hd * d + 3 * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(
            1 for k in self.layer_kinds() if k in "GL" and self.num_experts
        )
        inactive = (
            moe_layers
            * (self.num_experts - self.moe_top_k)
            * 3 * self.d_model * self.moe_d_ff
        )
        return full - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# reduced shapes for CPU smoke tests
SMOKE_SHAPES = {
    "train": ShapeConfig("smoke_train", "train", 64, 2),
    "prefill": ShapeConfig("smoke_prefill", "prefill", 64, 2),
    "decode": ShapeConfig("smoke_decode", "decode", 64, 2),
}
