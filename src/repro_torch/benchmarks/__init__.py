"""The port's tracked benchmarks, each a module with its own output file
(``BENCH_torch_*.json`` at the repository root; the JAX package's
``BENCH_*.json`` are never written):

    python -m repro_torch.benchmarks.run_bench [--smoke | --full]
    python -m repro_torch.benchmarks.dynamic_bench [--smoke]

Both take ``--device cuda|cpu`` (default cuda, which needs a GPU).
"""
