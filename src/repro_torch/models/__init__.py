"""The attention-only language models: common, mlp, attention, blocks,
transformer, and convert (parameters carried over from the JAX package)."""
