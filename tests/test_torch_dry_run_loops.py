"""Scans priced once a trip (``models/lm/scan.py``), the port's counterpart
of the reference's ``hlo_cost.while_costs``.

* At reduced size on the 16 × 16 production mesh, with the SSM chunk cut to
  8 (64 positions: the sLSTM's 64 trips, the mLSTM's and the SSD's 8),
  xlstm's and zamba2's prefill and train cells (the train step with remat
  and AdamW) count the same FLOPs, bytes, operators and collectives with
  the loops priced as with every trip dispatched (``cost.count``'s
  ``price_loops=False``);
* each priced loop is recorded with its trips and one trip's cost: the
  sLSTM's forward trip is its recurrence product by hand, 2·B·H·dh·4dh,
  its backward trip twice that (the gradients of h and of ``r``);
* the plain branch, on CPU tensors with or without a pricer, is bitwise
  the inline loop that the three scans ran before, gradients included;
* a priced loop refuses tensors off ``meta``, and a loop of fewer trips than
  the backward's pricing needs is dispatched whole;
* xlstm-1.3b × prefill_32k at full scale, cut at ``cost.TRACE_LIMIT_S``
  before its loops were priced, is ``ok``: its sLSTM record is the
  recurrence product by hand, and its per-device FLOPs are within 1% of a
  count by hand of every product.
"""
import contextlib
import dataclasses
import functools

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import cost, dryrun
from repro_torch.models.lm import scan
from repro_torch.models.lm import ssm as ssm_lib
from torch_pipeline_parity import one_torch_thread  # noqa: F401  (autouse)

CHUNK = 8


def _cell(arch, shape, tmp_path, priced: bool) -> dict:
    over = lambda c: dataclasses.replace(c, ssm=dataclasses.replace(c.ssm, chunk=CHUNK))  # noqa: E731
    real = dryrun.count
    dryrun.count = functools.partial(cost.count, price_loops=priced)
    try:
        return dryrun.run_cell(arch, shape, False, str(tmp_path / str(priced)), reduced=True,
                               cfg_override=over)
    finally:
        dryrun.count = real


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-2.7b"])
def test_priced_loops_count_what_every_trip_dispatches(arch, shape, tmp_path):
    priced = _cell(arch, shape, tmp_path, True)
    whole = _cell(arch, shape, tmp_path, False)
    assert priced["status"] == whole["status"] == "ok"
    for key in ("flops", "bytes", "operators", "collectives"):
        assert priced[key] == whole[key], key
    assert whole["loops"] == []
    loops = {(e["name"], e["pass"]): e for e in priced["loops"]}
    chunked = ["mlstm"] if arch == "xlstm-1.3b" else ["ssd"]
    names = chunked + (["slstm"] if arch == "xlstm-1.3b" else [])
    passes = ["forward", "backward"] if shape == "train_4k" else ["forward"]
    assert set(loops) == {(n, p) for n in names for p in passes}
    cfg = get_config(arch).reduced()
    layers = cfg.n_layers - (cfg.n_layers // cfg.ssm.slstm_every if arch == "xlstm-1.3b" else 0)
    for (name, pass_), e in loops.items():
        assert e["trips"] == (64 if name == "slstm" else 64 // CHUNK)
        assert e["trip_flops"] > 0 and e["trip_bytes"] > 0 and e["trip_ops"] > 0
        if name != "slstm":  # a layer a shard; forward twice under remat
            assert e["calls"] == layers * 16 * (2 if pass_ == "forward" and shape == "train_4k"
                                                else 1)
    if arch == "xlstm-1.3b":
        b, d, h = 2, cfg.d_model, cfg.n_heads
        dh = d // h
        fwd = loops[("slstm", "forward")]
        assert fwd["trip_flops"] == 2 * b * h * dh * 4 * dh
        assert fwd["calls"] == cfg.n_layers // cfg.ssm.slstm_every * 16
        if shape == "train_4k":
            assert loops[("slstm", "backward")]["trip_flops"] == 2 * fwd["trip_flops"]


def _slstm_inline(p, wx, cfg, state):
    """The sLSTM scan as it was written before ``scan.scan``."""
    bsz, length, d = wx.shape[0], wx.shape[1], wx.shape[2] // 4
    hs = cfg.n_heads
    dh = d // hs
    c, n, m, h = state
    r = p["r"]
    outs = []
    for t in range(length):
        rec = torch.bmm(h.reshape(bsz, hs, dh).transpose(0, 1), r).transpose(0, 1)
        za, ia, fa, oa = (wx[:, t] + rec.reshape(bsz, 4 * d)).chunk(4, dim=-1)
        z = torch.tanh(za)
        log_f = F.logsigmoid(fa)
        o = torch.sigmoid(oa)
        m_new = torch.maximum(log_f + m, ia)
        keep, take = torch.exp(log_f + m - m_new), torch.exp(ia - m_new)
        c = keep * c + take * z
        n = keep * n + take
        h = o * c / torch.maximum(n, torch.exp(-m_new))
        m = m_new
        outs.append(h)
    return torch.stack(outs, dim=1), (c, n, m, h)


class _Pricer:
    """A pricer that must not be reached: CPU loops are dispatched whole."""

    def tally(self):
        raise AssertionError("a CPU loop was priced")


@pytest.mark.parametrize("pricing", [False, True])
def test_plain_branch_is_the_inline_loop_bitwise(pricing):
    cfg = get_config("xlstm-1.3b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = ssm_lib.init_slstm(gen, cfg, torch.float32)
    d = cfg.d_model
    wx = torch.randn((2, 40, 4 * d), generator=gen)
    state = tuple(torch.randn((2, d), generator=gen) for _ in range(4))
    leaves = (p["r"], wx)

    def run(fn):
        xs = [t.detach().clone().requires_grad_(True) for t in leaves]
        h, st = fn({**p, "r": xs[0]}, xs[1], cfg, state)
        loss = (h * h).sum() + st[0].sum()
        return (h, *st, *torch.autograd.grad(loss, xs))

    with scan.pricing(_Pricer()) if pricing else contextlib.nullcontext():
        got = run(ssm_lib._slstm_scan)
    want = run(_slstm_inline)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_a_priced_loop_refuses_real_tensors_and_short_loops_run_whole():
    def body(carry, xs, w):
        (h,), (x,) = carry, xs
        h = torch.tanh(h @ w + x)
        return (h,), h

    w = torch.eye(4)
    xs = (torch.randn((6, 4)).unbind(0),)
    calls = []

    class Tally(int):
        def __sub__(self, other):
            return Tally(int(self) - int(other))

        def __mul__(self, n):
            return Tally(int(self) * n)

    class Pricer:
        def tally(self):
            return Tally(0)

        def add(self, t):
            calls.append(("add", t))

        def record(self, *args):
            calls.append(("record", args))

    with scan.pricing(Pricer()):
        with pytest.raises(ValueError, match="meta tensors only"):
            scan._priced("toy", body, (torch.zeros(4),), xs, (w,))
        # on the CPU the loop is the plain one, priced nowhere
        (h,), ys = scan.scan("toy", body, (torch.zeros(4),), xs, (w,))
        assert len(ys) == 6 and torch.equal(h, ys[-1]) and not calls
        # on meta: one trip weighed by six
        meta = lambda t: t.to("meta")  # noqa: E731
        (h,), ys = scan.scan("toy", body, (meta(torch.zeros(4)),),
                             (tuple(meta(x) for x in xs[0]),), (meta(w),))
        assert len(ys) == 6 and all(y.shape == (4,) for y in ys)
        assert [c[0] for c in calls] == ["add", "record"] and calls[1][1][:3] == ("toy", 6, "forward")
        # three trips: fewer than the backward's pricing needs, dispatched whole
        calls.clear()
        (h,), ys = scan.scan("toy", body, (meta(torch.zeros(4)),),
                             (tuple(meta(x) for x in xs[0][:3]),), (meta(w),))
        assert len(ys) == 3 and not calls


def test_full_scale_xlstm_prefill_is_priced_and_matches_a_count_by_hand(tmp_path):
    """One data replica's 16 model shards, B = 32 / 16 = 2 rows of 32768.
    The guard splits ``w_q``, ``w_k``, ``w_v``, ``w_gate`` over columns and
    ``out_proj`` over rows (di = 4096, 256 a shard); each shard runs the one
    mLSTM head (P = 1024) its columns lie in, four shards a head; the
    sLSTM's ``w`` is split over columns, its recurrence runs on every shard
    and its ``up`` / ``down`` (2730 units) are replicated; the logits are
    the last position's."""
    r = dryrun.run_cell("xlstm-1.3b", "prefill_32k", False, str(tmp_path))
    assert r["status"] == "ok" and r["terms"]["dominant"] == "memory_s"
    cfg, shape = get_config("xlstm-1.3b"), SHAPES["prefill_32k"]
    tp, b, s = 16, shape.global_batch // 16, shape.seq_len
    d, h, vocab = cfg.d_model, cfg.n_heads, cfg.vocab
    di, dh, q, up = 2 * d, d // h, cfg.ssm.chunk, 4 * d // 3
    p = di // h
    n_s = cfg.n_layers // cfg.ssm.slstm_every
    n_m = cfg.n_layers - n_s
    rec = 2 * b * h * dh * 4 * dh                  # the sLSTM's product a position
    (e,) = [e for e in r["loops"] if e["name"] == "slstm"]
    assert (e["pass"], e["trips"], e["calls"], e["trip_flops"]) == ("forward", s, n_s * tp, rec)
    chunk = 2 * 2 * b * q * q * p + 2 * 2 * b * q * p * p   # q·k, w·v; q·C, the state's k·v
    mlstm = (4 * 2 * b * s * d * (di // tp) + 2 * 2 * b * s * d * h
             + 2 * b * s * (di // tp) * d + s // q * chunk)
    slstm = 2 * b * s * d * (4 * d // tp) + s * rec + 2 * 2 * b * s * d * up
    by_hand = n_m * mlstm + n_s * slstm + 2 * b * d * -(-vocab // tp)
    assert abs(r["flops"] - by_hand) <= 0.01 * by_hand, (r["flops"], by_hand)
