"""h2d_ms_per_solve: device time of the host-to-device copies in the traced
window, divided by the solves: the facade's staging of the graph."""


def read(ctx):
    if ctx.kind != "solve" or ctx.trace is None or not ctx.trace.events:
        return None
    return ctx.trace.seconds_of("Memcpy HtoD") * 1e3 / len(ctx.solves)
