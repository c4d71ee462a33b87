"""sample_frac: rows the served requests' final plans read over their groups' rows,
sum(min(z, n)) / sum(n) (the paper's section-4 sample fraction)."""


def read(ctx):
    used = total = 0
    for g, _y, _p, z, _it in ctx.served:
        n = int(ctx.dep.sizes[g])
        used += sum(min(int(zj), n) for zj in z)
        total += n * len(z)
    return used / total if total else None
