"""kimi-k2-1t-a32b [moe] — arXiv:2501.kimi2 (paper-table config).

61L, d_model 7168, 64 Q / 8 KV heads (assignment specifies GQA kv=8; the
released K2 uses MLA — recorded as a deviation in DESIGN.md §6), head_dim
128, vocab 163840, MoE: 384 experts / top-8 / expert d_ff 2048 + 1 shared
expert.  First layer dense (d_ff 18432), remaining 60 MoE — hence the
(D, 1), (G, 60) segment split.  ~1.04T params, ~32B active.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18_432,                 # the single dense layer
    vocab_size=163_840,
    segments=(("D", 1), ("G", 60)),
    num_experts=384,
    num_shared_experts=1,
    moe_top_k=8,
    moe_d_ff=2048,
    rope_theta=50_000.0,
    moe_impl="ep",
    bf16_partial_reduce=True,
    tie_embeddings=False,
)
