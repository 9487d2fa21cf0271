"""phi4-mini-3.8b [dense] — arXiv:2412.08905.

32L, d_model 3072, 24 Q / 8 KV heads (GQA), head_dim 128, d_ff 8192,
vocab 200064, RoPE + SwiGLU, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200_064,
    segments=(("G", 32),),
    rope_theta=10_000.0,
    tie_embeddings=True,
)
