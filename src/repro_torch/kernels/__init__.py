"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
PyTorch versions, one package per kernel: ``kernel.py`` (wrapper and launch
count), ``ops.py`` (padding and engine adapters), ``ref.py`` (plain
version)."""
