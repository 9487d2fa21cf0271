"""relax_roofline: the relax kernels' share of their roofline, in percent:
the least bytes of the window's solves (``roofline.least_bytes`` of what each
root reaches, by the reference's components and the graph's degrees) over
the card's data-sheet bandwidth, as a share of the device time of the
program's relax kernels (``roofline.RELAX_KERNELS``) in the traced window."""
from sssp_bench.roofline import RELAX_KERNELS, least_bytes


def read(ctx):
    if (ctx.kind != "solve" or ctx.reach is None or ctx.trace is None
            or not ctx.solves or ctx.peak_bytes_per_s is None):
        return None
    kernel_s = ctx.trace.seconds_of_kernels(RELAX_KERNELS)
    if kernel_s <= 0:
        return None
    least = sum(least_bytes(*ctx.reach(s["root"])) for s in ctx.solves)
    return 100.0 * least / ctx.peak_bytes_per_s / kernel_s
