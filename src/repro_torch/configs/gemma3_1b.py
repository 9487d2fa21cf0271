"""gemma3-1b [dense] — hf:google/gemma-3-1b-pt.

26L, d_model 1152, 4 Q heads / 1 KV head (GQA), head_dim 256, d_ff 6912,
vocab 262144, 5:1 local:global layer pattern (sliding window 512), dual RoPE
theta (10k local / 1M global), QK-norm, sandwich norms, tied embeddings.
26 = 4×(5L+1G) + 2 trailing local layers.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    segments=(("LLLLLG", 4), ("LL", 1)),
    sliding_window=512,
    rope_theta=1_000_000.0,
    local_rope_theta=10_000.0,
    qk_norm=True,
    use_post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
)
