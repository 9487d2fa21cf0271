"""The benchmark of ``repro_torch``, the PyTorch and CUDA SSSP engine.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 sssp_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name (``loader.py``): the
configuration ``configs/<config>.json``, its graph generator
``graphs/<generator>.py``, the traffic mix ``traffic/<mix>.json`` and each
per-layer metric's reader ``metrics/<metric>.py``.  The yardstick lives here
too: the plain reference (``reference.py``), the traffic generator
(``workload.py``), the table of peaks, the least bytes of a solve and the
relax kernels' names (``roofline.py``) and the reduction of the profiler's trace
(``trace.py``).  Nothing here imports JAX or the JAX package.
"""
