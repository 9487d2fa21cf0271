"""mamba2-130m [ssm] — arXiv:2405.21060 (SSD / state-space duality).

24L, d_model 768, attention-free, ssm_state 128, expand 2 (d_inner 1536),
head_dim 64 (24 SSM heads), vocab 50280 padded to 50304 (next multiple of
128, for TP-shardable embeddings — GPT-NeoX tokenizer padding convention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    d_model=768,
    num_heads=1,                 # unused: attention-free
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50_304,           # 50280 padded to 128-multiple
    segments=(("M", 24),),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
)
