"""iters_per_request: mean planner iterations of the served requests (from the read-back)."""


def read(ctx):
    return sum(s[4] for s in ctx.served) / len(ctx.served) if ctx.served else None
