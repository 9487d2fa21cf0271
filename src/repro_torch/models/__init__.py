"""The language models: common, mlp, attention, moe, ssm, blocks,
transformer, tree (parameter-tree helpers), and convert (parameters
carried between the JAX package's layout and the port's)."""
