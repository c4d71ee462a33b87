"""chunk_ms: wall time of the runtime's chunks (a ``run_chunk`` and its read-back) over
the window, a chunk."""


def read(ctx):
    spans = [s for s in ctx.spans if s[0] == "chunk"]
    return sum(s[2] - s[1] for s in spans) * 1e3 / len(spans) if spans else None
