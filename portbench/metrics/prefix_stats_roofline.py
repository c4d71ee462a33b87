"""prefix_stats_roofline: the prefix power-sum tables over the rows of the groups refilled
in the traced slice, at the chip's peaks (``work.prefix_work``), over the device time of
the ``prefix_power_sums`` kernels (``csrc/prefix_stats.cu``: ``chunked_kernel``, and
``rows_kernel`` with its ``float4`` output) in the slice, in percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    t = sum(v for n, v in ctx.trace["kernels"].items()
            if "chunked_kernel" in n or ("rows_kernel" in n and "float4" in n))
    if t <= 0:
        return None
    w = ctx.work_fns.counted_work(ctx.traced_work, ctx.config)["prefix"]
    return 100.0 * ctx.work_fns.bound_s(*w) / t
