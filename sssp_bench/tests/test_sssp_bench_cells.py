"""Whole runs of each cell on the CPU at a small size: the program proves
correct, the control and each fault the cells can have do not, and the
result line has its required keys."""
import numpy as np
import pytest

from repro_torch.core import api

CELLS = ("graph500-s23.solve",)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_the_program_proves_correct(run_small, workload, trace):
    res = run_small(workload, trace=trace)
    assert res["correct"], res["checks"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    checked = [c["value"] for k, c in res["checks"].items()
               if k.startswith("checked_")]
    assert checked and min(checked) >= 1
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert res["device"]["window_s"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_in_bfloat16_fails(run_small, workload):
    res = run_small(workload, judge="control")
    assert not res["correct"]
    assert res["checks"]["wrong_distances"]["value"] > 0


def _solve_fault(kind):
    real = api._shortest_paths

    def broken(g, source, **kw):
        res = real(g, source, **kw)
        if kind == "unchanged":
            # the state the loop started from, returned as the answer
            res.dist = np.full_like(res.dist, np.inf)
            res.dist[int(source)] = 0
        else:
            # one answer altered where it is produced
            i = int(np.flatnonzero(np.isfinite(res.dist))[-1])
            res.dist = res.dist.copy()
            res.dist[i] = np.nextafter(res.dist[i], np.float32(np.inf))
        return res
    return broken


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_a_broken_solve_is_caught(run_small, monkeypatch, workload, kind):
    monkeypatch.setattr(api, "_shortest_paths", _solve_fault(kind))
    res = run_small(workload)
    assert not res["correct"]
    assert res["checks"]["wrong_distances"]["value"] > 0
