"""gemma2-2b [dense] — arXiv:2408.00118.

26L, d_model 2304, 8 Q / 4 KV heads, head_dim 256, d_ff 9216, vocab 256000,
alternating local(4096):global layers, attn softcap 50, final logit softcap
30, sandwich norms, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    segments=(("LG", 13),),
    sliding_window=4096,
    rope_theta=10_000.0,
    attn_softcap=50.0,
    logit_softcap=30.0,
    use_post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
)
