"""llama-3.2-vision-11b [vlm] — hf:meta-llama/Llama-3.2-11B-Vision.

40-layer LM backbone: d_model 4096, 32 Q / 8 KV heads, head_dim 128,
d_ff 14336, vocab 128256; gated cross-attention image layers every 5th
layer (absolute layers 3, 8, ..., 38 — the (GGGCG, 8) pattern).  The vision
tower is a STUB per the assignment: ``input_specs()`` supplies 6400
precomputed patch embeddings at d_model (≈4 tiles × 1601 patches).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=128_256,
    segments=(("GGGCG", 8),),
    num_image_tokens=6400,
    rope_theta=500_000.0,
    bf16_partial_reduce=True,
    tie_embeddings=False,
)
