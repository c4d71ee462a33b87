"""The port's dry run (``repro_torch.launch.dryrun``) and its cost counters.

* the FLOP counter on a loop of 10 ``(64, 64) @ (64, 64)`` products counts
  10 · 2 · 64³ (the counterpart of the reference's
  ``test_hlo_cost_trip_count_accounting``), and the attention kernel's
  operator on ``meta`` counts its live pairs only;
* the collectives' ring weighting over 2, 4 and 16 shards equals the
  reference's ``hlo_stats.CollectiveStats`` on the same bytes;
* every one of the 40 cells gives a record at its config's and shape's
  ``.reduced()`` on the 16 × 16 production mesh: the 8 skips with the
  reference's reason, the train, prefill and decode cells of all ten
  configs traced (32 ``ok``, FLOPs and roofline terms against the H100's
  peaks; decode on its cache placed by ``cache_pspecs``);
* the dense and VLM configs' decode cells against a count by hand from the
  shapes: per-device FLOPs (the local projections, the partial attention
  over S/tp slots, the FFN's slice and the unembedding's rows) within 10%,
  and link bytes equal to the all-reduces that the decode performs;
* a trace that outlasts ``cost.TRACE_LIMIT_S`` stops and is recorded as ``cut``
  with the operators it had counted;
* ``run_cell``'s reference keywords: deepseek-v2-236b's full-scale train
  cell placed with ``fsdp=True`` (the reference's ZeRO-3 note) holds at
  most 16 GB of parameters and Adam moments a device (placement only: its
  trace is stopped at once), and ``tag``, ``cfg_override`` and
  ``model_kwargs`` reach the record;
* one full-scale cell (qwen1.5-0.5b × train_4k × 16 × 16) on the meta
  device, in a fresh interpreter: its per-device parameter bytes equal a
  count by hand from the reference's specs, and the process's peak RSS
  stays under 2 GB.
"""
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import cells as ref_cells
from repro.configs import get_config as ref_get_config
from repro.launch.hlo_stats import CollectiveStats as RefCollectiveStats
from repro.models.lm import LM as RefLM
from repro.models.lm import sharding as ref_sharding
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import cost, dryrun
from repro_torch.launch.mesh import make_lm_mesh, simulated_devices
from repro_torch.models.lm import LM, collectives
from torch_pipeline_parity import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


def test_flop_counter_counts_every_product_of_a_loop():
    a = torch.empty((64, 64), device="meta")
    ws = torch.empty((10, 64, 64), device="meta")

    def g(a, ws):
        for w in ws:
            a = torch.relu(a @ w)
        return a

    _, c = cost.count(g, a, ws)
    assert c.flops == 10 * 2 * 64 ** 3
    # a product reads two 64 x 64 float32 operands and writes one; relu one and one
    assert c.bytes == 10 * (3 + 2) * 64 * 64 * 4


def test_attention_operator_counts_live_pairs():
    q = torch.empty((2, 64, 4, 32), device="meta", requires_grad=True)
    k = torch.empty((2, 64, 2, 32), device="meta", requires_grad=True)

    def fwd_bwd(q, k):
        o = cost.meta_attention(q, k, k, causal=True)
        return torch.autograd.grad(o.sum(), (q, k))

    (dq, dk), c = cost.count(fwd_bwd, q, k)
    assert dq.shape == q.shape and dk.shape == k.shape
    pairs = 64 * 65 // 2
    assert cost.live_pairs(64, 64, True, 0) == pairs
    assert cost.live_pairs(64, 64, False, 0) == 64 * 64
    assert cost.live_pairs(8, 8, True, 3) == 1 + 2 + 6 * 3
    assert c.flops == 2 * 4 * pairs * 2 * (32 + 32) + 2 * 4 * pairs * 2 * (4 * 32 + 3 * 32)


@pytest.mark.parametrize("g", [2, 4, 16])
def test_collective_ring_weights_are_the_references(g):
    mesh = make_lm_mesh((1, g), devices=simulated_devices(g, "cpu"))
    xs = [torch.ones((3, 5)) * i for i in range(g)]
    want = RefCollectiveStats()
    collectives.reset_stats()
    out = collectives.all_reduce_sum(xs, mesh, "model")
    assert torch.equal(out[-1], torch.full((3, 5), float(sum(range(g)))))
    want.add("all-reduce", 60, g)
    collectives.all_reduce_max(xs, mesh, "model")
    want.add("all-reduce", 60, g)
    gathered = collectives.all_gather(xs, mesh, "model", dim=0)
    assert gathered[0].shape == (3 * g, 5)
    want.add("all-gather", 60 * g, g)
    blocks = [torch.ones((4, 16 * g)) for _ in range(g)]
    resplit = collectives.all_to_all(blocks, mesh, "model", split_dim=1, concat_dim=0)
    assert resplit[1].shape == (4 * g, 16)
    want.add("all-to-all", 4 * 16 * g * 4, g)
    got = collectives.STATS
    assert got.link_bytes == pytest.approx(want.link_bytes, rel=1e-12)
    assert got.per_op_bytes == want.per_op_bytes
    assert got.per_op_count == want.per_op_count


def test_every_cell_gives_a_record_at_reduced_size(tmp_path):
    records = dryrun.main(["--all", "--reduced", "--out", str(tmp_path)])
    assert len(records) == 40 and len(list(tmp_path.glob("*.json"))) == 40
    reasons = {(a, s): why for a, s, ok, why in ref_cells() if not ok}
    by_status: dict = {}
    for r in records:
        by_status.setdefault(r["status"], []).append((r["arch"], r["shape"]))
        assert json.loads((tmp_path / f"{r['arch']}__{r['shape']}__16x16.json").read_text()) == \
            json.loads(json.dumps(r))
        if r["status"] == "skipped":
            assert r["reason"] == reasons[(r["arch"], r["shape"])]
            continue
        assert r["n_devices"] == 256 and r["per_device_bytes"]["params"] > 0
        assert r["flops"] > 0 and r["bytes"] > 0
        assert r["terms"]["peaks"] == "NVIDIA H100 SXM 80GB, 700 W"
        assert r["terms"]["dominant"] in ("compute_s", "memory_s", "collective_s")
        if r["kind"] == "train":
            assert r["per_device_bytes"]["opt_state"] > 0
        if r["kind"] == "decode":
            assert r["per_device_bytes"]["cache"] > 0 and r["cache_bytes"] > 0
            assert r["collectives"]["per_op_count"]["all-reduce"] > 0
    assert len(by_status["skipped"]) == 8
    archs = ("qwen3-14b", "qwen1.5-0.5b", "gemma-7b", "qwen3-8b", "internvl2-1b",
             "granite-moe-1b-a400m", "deepseek-v2-236b", "xlstm-1.3b", "zamba2-2.7b",
             "seamless-m4t-large-v2")
    assert sorted(by_status["ok"]) == sorted(
        [(a, s) for a in archs for s in ("train_4k", "prefill_32k", "decode_32k")]
        + [(a, "long_500k") for a in ("xlstm-1.3b", "zamba2-2.7b")])
    assert set(by_status) == {"ok", "skipped"}
    assert cost.HW["peak_flops"] == 989e12 and cost.HW["hbm_bw"] == 3.35e12
    assert cost.HW["link_bw"] == 450e9


def test_a_trace_past_its_time_limit_is_recorded_as_cut(tmp_path, monkeypatch):
    assert cost.TRACE_LIMIT_S == 1200.0
    a = torch.empty((64, 64), device="meta")
    monkeypatch.setattr(cost, "TRACE_LIMIT_S", 0.0)
    with pytest.raises(cost.TraceCut) as cut:
        cost.count(lambda: [a @ a for _ in range(10)])
    assert cut.value.cost.ops == 0
    # xlstm's reduced train step: its scans priced once a trip, its trace
    # still takes ~10 s, far past the limit
    monkeypatch.setattr(cost, "TRACE_LIMIT_S", 0.5)
    r = dryrun.run_cell("xlstm-1.3b", "train_4k", False, str(tmp_path), reduced=True)
    assert r["status"] == "cut" and r["trace_s"] == 0.5 and r["operators"] > 0
    assert "0.5 s" in r["reason"] and r["collectives"]["per_op_count"]
    assert json.loads((tmp_path / "xlstm-1.3b__train_4k__16x16.json").read_text()) == \
        json.loads(json.dumps(r))


@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen1.5-0.5b", "gemma-7b", "qwen3-8b",
                                  "internvl2-1b"])
def test_decode_cell_matches_a_count_by_hand(arch, tmp_path):
    """At reduced size on 16 × 16: B = 2 does not divide the 16 data shards,
    so every shard holds both rows; the 4 query and 2 KV heads do not divide
    the 16 model shards, so the guard replicates them (each shard projects
    every head, and no query gather or ``wo`` all-reduce is needed); the 64
    cached slots split 4 a shard; ``d_ff``, the vocabulary rows of the
    embedding and the rows of the unembedding split 16 ways."""
    r = dryrun.run_cell(arch, "decode_32k", False, str(tmp_path), reduced=True)
    cfg = get_config(arch).reduced()
    shape = SHAPES["decode_32k"].reduced()
    tp, b, s = 16, shape.global_batch, shape.seq_len
    d, f, n_layers = cfg.d_model, cfg.d_ff, cfg.n_layers
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    vp = LM(cfg).vp
    assert b % tp and h % tp and hkv % tp and not (f % tp or d % tp or s % tp)
    assert cfg.dtype == "bfloat16"
    per_layer = (2 * b * d * (h + 2 * hkv) * hd + 2 * b * h * hd * d   # q, k, v and wo
                 + 2 * 2 * b * h * (s // tp) * hd                      # q·k and p·v over S/tp
                 + 3 * 2 * b * d * (f // tp))                          # the FFN's slice
    flops = n_layers * per_layer + 2 * b * (d // tp) * vp             # the unembedding's rows
    assert r["status"] == "ok" and abs(r["flops"] - flops) <= 0.1 * flops, (r["flops"], flops)

    def all_reduce(nbytes):
        return nbytes * 2 * (tp - 1) / tp

    # the embedding's sum; a layer's max, weight totals and weighted outputs
    # (float32) and the FFN's sum (bf16); the logits' sum over the rows
    link = (all_reduce(b * d * 2) + all_reduce(b * vp * 4)
            + n_layers * (2 * all_reduce(b * h * 4) + all_reduce(b * h * hd * 4)
                          + all_reduce(b * d * 2)))
    assert r["collectives"]["per_op_count"] == {"all-reduce": 2 + 4 * n_layers}
    assert r["collectives"]["link_bytes"] == pytest.approx(link, rel=1e-12)
    assert r["per_device_bytes"]["cache"] == 2 * n_layers * b * s * hkv * hd * 2 // tp


# The peak is this process's own high-water mark since exec (VmHWM): Linux's
# ru_maxrss also keeps the peak of the process that forked it, here a test
# worker that may hold gigabytes.
_FULL_CELL = r"""
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.launch import dryrun
r = dryrun.run_cell("qwen1.5-0.5b", "train_4k", False, {out!r})
hwm = [line for line in open("/proc/self/status") if line.startswith("VmHWM:")][0]
r["maxrss_bytes"] = int(hwm.split()[1]) * 1024
print(json.dumps(r))
"""


class _FakeMesh:
    shape = {"data": 16, "model": 16}


def test_full_scale_cell_on_the_meta_device(tmp_path):
    code = _FULL_CELL.format(src=str(ROOT / "src"), out=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["status"] == "ok" and r["n_devices"] == 256
    assert r["maxrss_bytes"] < 2 * 2 ** 30
    # by hand, from the reference's specs: a leaf's elements over its axes' sizes, bf16
    cfg = ref_get_config("qwen1.5-0.5b")
    shapes = RefLM(cfg).init_shapes()
    specs = ref_sharding.param_pspecs(ref_sharding.ShardingRules(_FakeMesh(), cfg), shapes)
    leaves = jax.tree.leaves(shapes)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    by_hand = sum(math.prod(s.shape) // math.prod(16 for a in p if a is not None) * 2
                  for s, p in zip(leaves, spec_leaves))
    assert r["per_device_bytes"]["params"] == by_hand
    assert r["per_device_bytes"]["opt_state"] == 4 * by_hand + 4  # two float32 moments, the step
    assert r["per_device_bytes"]["inputs"] == 256 // 16 * 4097 * 4
    # the train step's FLOPs a device: at least the model's 6·N·tokens over 256 devices
    assert r["flops"] >= 6 * cfg.param_count() * 256 * 4096 / 256 * 0.99
    assert r["collectives"]["link_bytes"] > 0


def test_run_cell_places_deepseek_train_with_fsdp(tmp_path, monkeypatch):
    # placement only: the trace of 60 full-width layers belongs to the full
    # dry run, not to a unit test, so it is stopped at its first operator
    monkeypatch.setattr(cost, "TRACE_LIMIT_S", 0.0)
    r = dryrun.run_cell("deepseek-v2-236b", "train_4k", False, str(tmp_path), fsdp=True,
                        tag="fsdp")
    assert r["status"] == "cut" and r["fsdp"] and r["tag"] == "fsdp"
    assert (tmp_path / "deepseek-v2-236b__train_4k__16x16__fsdp.json").exists()
    dev = r["per_device_bytes"]
    assert dev["params"] + dev["opt_state"] <= 16e9, dev
    plain = dryrun.run_cell("deepseek-v2-236b", "train_4k", False, str(tmp_path))
    # without FSDP the same cell does not fit one card's 80 GB
    assert plain["per_device_bytes"]["params"] + plain["per_device_bytes"]["opt_state"] > 80e9


def test_run_cell_takes_the_reference_variant_keywords(tmp_path):
    import dataclasses

    r = dryrun.run_cell("qwen1.5-0.5b", "prefill_32k", False, str(tmp_path), reduced=True,
                        tag="wide", cfg_override=lambda c: dataclasses.replace(c, d_ff=512),
                        model_kwargs={"attn_block": 32})
    assert r["status"] == "ok" and r["tag"] == "wide"
    base = dryrun.run_cell("qwen1.5-0.5b", "prefill_32k", False, str(tmp_path), reduced=True)
    assert r["flops"] > base["flops"] and r["params"] > base["params"]
    assert (tmp_path / "qwen1.5-0.5b__prefill_32k__16x16__wide.json").exists()
