"""device_idle_frac: share of the traced slice in which no operation ran on the card
(``torch.profiler``)."""


def read(ctx):
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"]
