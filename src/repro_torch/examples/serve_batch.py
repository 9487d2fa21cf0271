"""Batched serving example: the LM serving loop over a queue of requests
for an attention-only architecture (smoke scale by default), reporting
latency and throughput (port of ``examples/serve_batch.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_batch   # gemma2-2b
    PYTHONPATH=src python -m repro_torch.examples.serve_batch \
        --arch seamless-m4t-medium --device cpu
"""
from __future__ import annotations

import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--arch" not in argv:
        argv = ["--arch", "gemma2-2b"] + argv
    if "--smoke" not in argv:
        argv.append("--smoke")
    return serve_main(argv)


if __name__ == "__main__":
    main()
