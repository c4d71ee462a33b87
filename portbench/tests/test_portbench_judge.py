"""The comparison that decides ``correct``: sound runs of the port pass it, the bfloat16
control fails it at the cells' own size, and a run with the timed path broken fails it.

The faults are planted in the port under the window (monkeypatch): a chunk whose steps
leave the lanes' state as it was (the run never finishes, and is stopped past its
grace), the model's mean taken over half of each lane's rows, and ŷ altered where the
model produces it.  A one-card cell has no exchange between cards to leave out."""
import json

import pytest
import torch

from portbench import bench, catalog, judge
from portbench.data import make_deployment
from portbench.reference import Reference
from portbench.system import knobs

SMALL = dict(rows_per_group=600, n_serve_groups=6, lanes=4, segment_requests=12)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell):
    # a sound run may take its time on a loaded CPU: only a hung one is stopped
    return bench.run_cell(cell, 11, 1.0, False, device="cpu", sizes=SMALL, grace_s=300.0)


@pytest.mark.parametrize("cell", [w["name"] for w in catalog.benchmark()["workloads"]])
def test_sound_run_is_correct(cell):
    ctx = _run(cell)
    assert ctx.correct, ctx.checks
    assert ctx.attempted > 0 and ctx.failed == 0 and len(ctx.served) == ctx.attempted


def _step_unchanged(monkeypatch):
    from repro_torch.core.executor_fused import ChunkedExecutor
    monkeypatch.setattr(ChunkedExecutor, "chunk", lambda self, t: t)


def _half_the_rows(monkeypatch):
    from repro_torch.core.executor_fused import FusedExecutor
    model = FusedExecutor._model

    def half(self, s, rows):
        r = rows.shape[1]
        y = model(self, s, rows[:, : (r + 1) // 2])
        return torch.cat([y, y], dim=1)[:, :r]
    monkeypatch.setattr(FusedExecutor, "_model", half)


def _answer_altered(monkeypatch):
    from repro_torch.core.executor_fused import FusedExecutor
    model = FusedExecutor._model

    def altered(self, s, rows):
        y = model(self, s, rows).clone()
        if y.shape[1] > self.m:          # the value row's output: ŷ
            y[:, self.m] = 1.0 - y[:, self.m] if self.classify else y[:, self.m] + 1.0
        return y
    monkeypatch.setattr(FusedExecutor, "_model", altered)


@pytest.mark.parametrize("fault", [_step_unchanged, _half_the_rows, _answer_altered])
@pytest.mark.parametrize("cell", ["turbofan.tight.sat", "student_qa.tight.sat"])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    """Set-up as in a run; the fault is planted under the window alone."""
    s = bench.Session(cell, 11, device="cpu", sizes=SMALL)
    fault(monkeypatch)
    ctx = s.window(1.0, 11, grace_s=4.0)
    s.close()
    s.judge(ctx)
    assert not ctx.correct, ctx.checks


@pytest.mark.parametrize("config", ["turbofan", "student_qa"])
def test_bfloat16_control_is_not_correct(config):
    """The reference in bfloat16 put in the program's place, at the cell's own
    deployment and size, over every serving group."""
    cfg = catalog.load("configs", config)
    dep = make_deployment(cfg, cfg["deployment_seed"])
    delta, tau = knobs(dep, catalog.load("traffic", "tight.sat")["setting"])
    ref = Reference(dep, delta=delta, tau=tau)
    low = Reference(dep, delta=delta, tau=tau, dtype=torch.bfloat16)
    groups = range(dep.n_groups)
    loops = {g: ref.serve(g) for g in groups}
    answers = {g: low.serve(g) for g in groups}
    served = [(g, a.y_hat, a.prob, a.z, a.iters) for g, a in answers.items()]
    at_plan = {(g, tuple(a.z)): ref.at_plan(g, a.z) for g, a in answers.items()}
    checks = judge.check(judge.numbers(dep.task, delta, served, loops, at_plan),
                         catalog.load("limits", config))
    assert not all(ok for *_x, ok in checks), json.dumps(checks)
