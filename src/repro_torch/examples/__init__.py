"""The SSSP examples of the JAX package's ``examples/``, on PyTorch: each is
a module with a ``main(argv)`` that runs on ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path) and checks its own answers.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.sssp_pipeline
    PYTHONPATH=src python -m repro_torch.examples.sssp_dynamic_demo
    PYTHONPATH=src python -m repro_torch.examples.sssp_serve_demo
"""
