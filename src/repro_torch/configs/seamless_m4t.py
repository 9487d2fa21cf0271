"""seamless-m4t-medium [audio] — arXiv:2308.11596.

Encoder-decoder transformer backbone: 12 encoder + 12 decoder layers,
d_model 1024, 16 heads (MHA), head_dim 64, d_ff 4096, vocab 256206 padded
to 256256 (128-multiple for shardable embeddings).  The speech frontend is
a STUB per the assignment: ``input_specs()`` supplies precomputed frame
embeddings of length seq_len // 8 (audio downsampling).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256_256,          # 256206 padded to 128-multiple
    segments=(("X", 12),),
    encoder_segments=(("E", 12),),
    audio_downsample=8,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
