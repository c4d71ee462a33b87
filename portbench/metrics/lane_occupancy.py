"""lane_occupancy: the runtime's mean occupied share of the table's lanes over its chunks
(``RuntimeStats.lane_occupancy``), weighted by each run's chunks."""


def read(ctx):
    chunks = sum(st.n_chunks for _b, st in ctx.runs)
    if not chunks:
        return None
    return sum(st.lane_occupancy * st.n_chunks for _b, st in ctx.runs) / chunks
