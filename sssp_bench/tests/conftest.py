"""Small cells for the CPU tests: the configuration and mix each cell
names, cut to a size a test run holds."""
import time

import pytest

from sssp_bench import cell, loader

SMALL = {"graph500-s23": {"scale": 9}}


def small_parts(workload: str):
    bench = loader.load_benchmark()
    wl = loader.workload(bench, workload)
    cfg = loader.load_config(wl["config"])
    cfg["params"].update(SMALL[wl["config"]])
    mix = loader.load_mix(wl["traffic"])
    return bench, wl, cfg, mix


@pytest.fixture
def run_small():
    """Runs a cell once on the CPU at a small size; returns its result."""
    def run(workload, *, seed=2**33 + 7, seconds=0.3, trace=False,
            judge="program"):
        bench, wl, cfg, mix = small_parts(workload)
        return cell.run_cell(bench, wl, seed=seed, seconds=seconds,
                             trace=trace, device="cpu",
                             t_process=time.perf_counter(), config=cfg,
                             mix=mix, judge=judge)
    return run
