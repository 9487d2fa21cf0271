"""solves_per_s.traced: whole single-source solves answered over the whole
traced window (the last solve started before the close finishes inside it).
A per-layer reading: between runs it follows the host's pageable copy rate
too closely to hold an end-to-end bound."""


def read(ctx):
    if ctx.kind != "solve" or not ctx.solves or ctx.trace is None:
        return None
    return len(ctx.solves) / ctx.window_s
