"""The least bytes of a solve, counted by hand on a small graph."""
import numpy as np
import torch

from sssp_bench import reference, roofline
from sssp_bench.inputs import EdgeList, incoming_csr


def test_least_bytes_on_a_hand_built_graph():
    # a path 0-1-2 with a duplicate and a self-loop, an edge 3-4, and 5 alone
    edges = EdgeList(6, torch.tensor([0, 1, 1, 2, 3]),
                     torch.tensor([1, 2, 2, 2, 4]),
                     torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0]))
    deg = np.diff(incoming_csr(edges)[0])
    np.testing.assert_array_equal(deg, [1, 2, 1, 1, 1, 0])
    lab = reference.components(edges).numpy()
    comp_v = np.bincount(lab, minlength=6)
    comp_a = np.bincount(lab, weights=deg, minlength=6)
    # root 0 reaches 3 vertices holding 4 arcs: 4 * 8 + 3 * 8 bytes
    assert roofline.least_bytes(comp_v[lab[0]], comp_a[lab[0]]) == 56
    assert roofline.least_bytes(comp_v[lab[4]], comp_a[lab[4]]) == 32
    assert roofline.least_bytes(comp_v[lab[5]], comp_a[lab[5]]) == 8


def test_peak_table_knows_the_h100_sxm_and_nothing_else():
    assert roofline.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.peak_bytes_per_s("cpu") is None


def _ctx(events, solves, reach):
    from sssp_bench.cell import Window
    from sssp_bench.trace import DeviceTrace
    dt = DeviceTrace(torch.device("cpu"))
    dt.events, dt.window_s = events, 1.0
    return Window(kind="solve", setup_s=0.0, solves=solves, trace=dt,
                  reach=reach, peak_bytes_per_s=1e9)


def test_relax_roofline_holds_the_least_bytes_to_the_relax_kernels_time():
    from sssp_bench import loader
    read = loader.load_metric("relax_roofline").read
    events = [("void frontier_push_kernel(float*, long)", 0.0, 0.002),
              ("Memcpy HtoD (Pageable -> Device)", 0.002, 0.5),
              ("frontier_gather_kernel", 0.5, 0.502),
              ("void at::native::vectorized_elementwise_kernel<4>", 0.6, 0.7)]
    solves = [{"root": 0}, {"root": 1}]
    # 2 solves of 1e6 least bytes each at 1e9 B/s: 2 ms against 4 ms
    ctx = _ctx(events, solves, lambda r: (0, 125_000))
    assert abs(read(ctx) - 50.0) < 1e-9
    # no relax kernel in the window: nothing to read, never 0
    assert read(_ctx(events[1:2] + events[3:], solves,
                     lambda r: (0, 125_000))) is None
