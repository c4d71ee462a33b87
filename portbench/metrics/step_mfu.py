"""step_mfu: the whole counted work of the traced slice (forest, prefix tables, row
sampling: ``work.counted_work``), each item at the larger of its byte and operation
terms at the chip's peaks, over the traced slice's length, in percent."""


def read(ctx):
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    items = ctx.work_fns.counted_work(ctx.traced_work, ctx.config).values()
    return 100.0 * sum(ctx.work_fns.bound_s(*w) for w in items) / ctx.trace["window_s"]
