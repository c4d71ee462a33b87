"""throughput_rps: requests served in the window over the window's wall seconds."""


def read(ctx):
    return len(ctx.served) / ctx.window_s if ctx.served else None
