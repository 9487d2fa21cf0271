"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B.

24L, d_model 2048, 16 heads (MHA kv=16), head_dim 128, vocab 151936,
MoE: 60 routed experts / top-4 / expert d_ff 1408 + 4 shared experts
(fused 4×1408 = 5632 shared width), QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=5632,                   # dense fallback width (unused: all-MoE)
    vocab_size=151_936,
    segments=(("G", 24),),
    num_experts=60,
    expert_pad_to=64,        # 4 dead experts -> expert-parallel over 16 chips
    num_shared_experts=4,
    moe_top_k=4,
    moe_d_ff=1408,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    moe_impl="ep",
    bf16_partial_reduce=True,
    tie_embeddings=False,
)
