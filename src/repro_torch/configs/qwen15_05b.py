"""qwen1.5-0.5b [dense] — hf:Qwen/Qwen1.5-0.5B.

24L, d_model 1024, 16 heads (MHA: kv=16), head_dim 64, d_ff 2816,
vocab 151936, QKV bias, RoPE theta 1e6, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151_936,
    segments=(("G", 24),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
