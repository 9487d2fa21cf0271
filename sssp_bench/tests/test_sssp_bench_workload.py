"""The traffic generator: the roots' determinism from the seed and their
draw among the vertices of degree >= 1 under the run's labels."""
import numpy as np
import pytest

from sssp_bench import loader, workload


def test_solve_roots_are_deterministic():
    deg = np.arange(500) % 4
    mix = loader.load_mix("solve") | {"roots": 40}
    r1 = workload.solve_roots(mix, {"root_draw": "degree1"}, deg, 5)
    r2 = workload.solve_roots(mix, {"root_draw": "degree1"}, deg, 5)
    r3 = workload.solve_roots(mix, {"root_draw": "degree1"}, deg, 2**33 + 5)
    assert np.array_equal(r1, r2) and len(set(r1.tolist())) == 40
    assert not np.array_equal(r1, r3)
    assert (deg[r1] > 0).all()


def test_relabelled_roots_are_drawn_on_the_structure():
    deg = np.arange(600) % 4
    labels = np.random.default_rng(1).permutation(600)
    deg_run = np.empty(600, int)
    deg_run[labels] = deg
    mix = {"roots": 50}
    r = workload.solve_roots(mix, {}, deg_run, 7, labels)
    assert (deg_run[r] > 0).all()
    # the same draw on the structure, under the run's labels
    inv = np.argsort(labels)
    assert np.array_equal(inv[r], workload.solve_roots(mix, {}, deg, 7))


def test_an_unknown_root_draw_is_refused():
    with pytest.raises(ValueError):
        workload.solve_roots({"roots": 4}, {"root_draw": "grid_ring"},
                             np.ones(16), 1)
