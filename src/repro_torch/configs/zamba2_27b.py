"""zamba2-2.7b [hybrid] — arXiv:2411.15242.

54 Mamba2 layers, d_model 2560, ssm_state 64 (d_inner 5120, head_dim 64 →
80 SSM heads), with a single weight-SHARED attention+FFN block (32 heads,
head_dim 80, d_ff 10240) invoked after every 6th Mamba layer — the
(MMMMMS, 9) segment pattern.  vocab 32000.  The released model's
LoRA-per-invocation refinement of the shared block is omitted (DESIGN.md §6).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10_240,
    vocab_size=32_000,
    segments=(("MMMMMS", 9),),
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
