"""Readings for the comparison's limits: sound runs of the port and the bfloat16 control.

    python3 portbench/readings.py --workload <cell> --deployments 0-13 [--seconds 3]

on the card, from the root of a checkout.  For each deployment seed (the
configuration's rows, sample order and forest drawn from it) one process
builds the server, measures a window of the cell's traffic, frees the
program, and holds its answers to the float64 reference (the sound
readings); then the reference in bfloat16, put in the program's place,
answers the same requests and is held to the same numbers (the control's
readings).  ``--seeds`` instead runs the cell's own deployment under
several ``--seed``.  One line a run; the limits in ``limits/<config>.json``
lie between the largest sound reading and the smallest control reading.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _range(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b or a) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--deployments", default=None)
    ap.add_argument("--seeds", default=None)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import bench, judge

    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {bench.card_line()}", flush=True)
    runs = ([(d, d) for d in _range(args.deployments)] if args.deployments
            else [(None, s) for s in _range(args.seeds)])
    for dseed, seed in runs:
        s = bench.Session(args.workload, seed, deployment_seed=dseed)
        ctx = s.window(args.seconds, seed)
        s.close()
        ref = s.reference()
        s.judge(ctx, ref)
        line = dict(deployment=dseed, seed=seed, served=len(ctx.served), failed=ctx.failed,
                    correct=ctx.correct, sound=ctx.values,
                    iters=sum(x[4] for x in ctx.served) / max(len(ctx.served), 1))
        if args.control:
            low = s.reference(torch.bfloat16)
            answers = {g: low.serve(g) for g in sorted({x[0] for x in ctx.served})}
            ctrl = [(g, a.y_hat, a.prob, a.z, a.iters)
                    for g, a in ((x[0], answers[x[0]]) for x in ctx.served)]
            loops = {g: ref.serve(g) for g in answers}
            at_plan = {(g, tuple(a.z)): ref.at_plan(g, a.z) for g, a in answers.items()}
            line["control"] = judge.numbers(s.dep.task, s.delta, ctrl, loops, at_plan)
        print(json.dumps(line), flush=True)
        del s, ctx
    return 0


if __name__ == "__main__":
    sys.exit(main())
