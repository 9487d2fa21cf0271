"""device_idle.solve: the share of the traced window of a solve cell in which
no kernel and no copy ran on the card, in percent."""


def read(ctx):
    if ctx.kind != "solve" or ctx.trace is None or not ctx.trace.events:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
