"""tree_qmc_roofline: the forest rows the traced slice's requests needed, at the chip's
peaks (``work.tree_work``), over the device time of the ``ensemble_sum`` kernels
(``csrc/tree_qmc.cu``: ``smem_kernel``, ``global_kernel``) in the slice, in percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    t = sum(v for n, v in ctx.trace["kernels"].items()
            if "smem_kernel" in n or "global_kernel" in n)
    if t <= 0:
        return None
    w = ctx.work_fns.counted_work(ctx.traced_work, ctx.config)["tree"]
    return 100.0 * ctx.work_fns.bound_s(*w) / t
