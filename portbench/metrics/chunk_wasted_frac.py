"""chunk_wasted_frac: the runtime's lane-steps spent waiting on a chunk's straggler over
all lane-steps charged (``RuntimeStats.chunk_stats``), over the window's runs."""


def read(ctx):
    wasted = sum(int(st.chunk_stats["wasted_iters"].sum()) for _b, st in ctx.runs
                 if st.chunk_stats)
    useful = sum(int(st.chunk_stats["total_iters"]) for _b, st in ctx.runs if st.chunk_stats)
    return wasted / (wasted + useful) if wasted + useful else None
