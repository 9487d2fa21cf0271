"""setup_s: seconds from the start of the process to the first timed
request: imports, the graph from the seed, the program's input, its views,
staging and the warm-up (and, in a checkout's first run, the kernels'
build)."""


def read(ctx):
    return ctx.setup_s
