"""refill_ms: wall time of the runtime's admissions (an ``admit`` and the read-back that
waits for it) summed over the window, over the lanes they refilled."""


def read(ctx):
    spans = [s for s in ctx.spans if s[0] == "refill"]
    lanes = sum(s[3] for s in spans)
    return sum(s[2] - s[1] for s in spans) * 1e3 / lanes if lanes else None
