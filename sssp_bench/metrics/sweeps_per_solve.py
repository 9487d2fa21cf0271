"""sweeps_per_solve: the mean of ``sweeps`` over the facade's cost records
of the window's solves (fixpoint sweeps; Δ-stepping counts its phases)."""


def read(ctx):
    recs = [r for r in ctx.cost_records if r.batch == 1]
    if ctx.kind != "solve" or not recs:
        return None
    return sum(r.sweeps for r in recs) / len(recs)
