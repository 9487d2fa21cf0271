"""relax_launches_per_solve: launches of the three CSR relax kernels
(``frontier_relax``, ``bucket_relax``, ``ell_relax``: the program's
``<kernel>.launches`` counters) in the window, divided by the solves.  Each
launch is one pass of a fixpoint loop, and each pass ends in a read of
its flag by the host."""


def read(ctx):
    if ctx.kind != "solve" or not ctx.launches or not ctx.solves:
        return None
    total = sum(ctx.launches.values())
    if total == 0:
        return None
    return total / len(ctx.solves)
