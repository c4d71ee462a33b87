"""Multi-pod dry run: place and trace every (arch x shape x mesh) cell.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles each
cell with XLA over 512 forced host devices and reads the HLO; the port has
no HLO.  For each cell the dry run:

  1. builds the production mesh (16x16 pod / 2x16x16 multi-pod) of shards
     on the ``meta`` device (``launch/mesh.make_production_mesh``),
  2. builds the full-scale parameters, the AdamW state, the inputs
     (:func:`input_specs`) and, for decode, the cache on ``meta`` (shapes and
     types, nothing allocated),
  3. places them by the specs of ``models/lm/sharding.py`` and records each
     device's bytes of parameters, optimizer state, inputs and cache, for
     every applicable cell and every family,
  4. for every shape of every family, traces the cell's step on meta shards
     (the train step with remat; the prefill's logits; one ``decode_step``
     on a cache ``seq_len`` deep, placed by ``sharding.shard_cache``, its
     attention split over the cached sequence on "model") and counts its
     FLOPs, bytes and collective traffic (``launch/cost.py``).  One
     data-parallel replica (the model axis's 16 shards) is traced, since the
     others repeat it; the data axes' gradient all-reduce is added from the
     specs.  The MoE family is traced with the
     einsum backend, the reference's dry-run baseline (the sorted backend's
     ``bincount`` and ``argsort`` depend on the data, which ``meta`` does not
     have).  The scans (SSD, mLSTM, sLSTM) are priced once a trip
     (``models/lm/scan.py``); each cell's record lists them under ``loops``,
  5. writes ``roofline_terms`` against the H100's published peaks
     (``cost.HW``) to ``<out>/<arch>__<shape>__<mesh>.json``.

:func:`run_cell` takes the
reference's variant keywords: ``tag`` (a separate record), ``cfg_override``,
``fsdp`` (ZeRO-3 weight sharding over the data axes), ``model_kwargs`` and
``train_kwargs``.  A trace that outlasts ``cost.TRACE_LIMIT_S`` is recorded
as ``cut``.  The default output is ``build/dryrun/`` of the checkout (the
reference's ``experiments/dryrun/`` stays its own).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--reduced] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, cell_applicable, get_config
from repro_torch.launch import cost
from repro_torch.launch.cost import HW, TraceCut, count
from repro_torch.launch.mesh import DP_AXES, make_lm_mesh, make_production_mesh, simulated_devices
from repro_torch.models.lm import LM
from repro_torch.models.lm import collectives
from repro_torch.models.lm.sharding import (
    ShardingRules,
    batch_pspec,
    cache_pspecs,
    param_pspecs,
    shard_cache,
    shard_params,
    use_rules,
)
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.step import build_train_step

__all__ = ["OUT_DIR", "input_specs", "main", "roofline_terms", "run_cell"]

OUT_DIR = str(Path(__file__).resolve().parents[3] / "build" / "dryrun")
META = torch.device("meta")


def _shape(shape_name: str, reduced: bool):
    shape = SHAPES[shape_name]
    return shape.reduced() if reduced else shape


def _config(arch: str, reduced: bool):
    cfg = get_config(arch)
    return cfg.reduced() if reduced else cfg


def input_specs(arch: str, shape_name: str, *, reduced: bool = False) -> dict:
    """``meta`` tensors standing for every model input of the cell."""
    return _inputs(_config(arch, reduced), _shape(shape_name, reduced))


def _inputs(cfg, shape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":  # one new token against a seq_len-deep cache
        return {"tokens": torch.empty((b, 1), dtype=torch.int32, device=META)}
    s_text = s - cfg.n_frontend_tokens if cfg.family == "vlm" else s
    extra = 1 if shape.kind == "train" else 0
    out = {"tokens": torch.empty((b, s_text + extra), dtype=torch.int32, device=META)}
    if cfg.frontend:
        out["frontend"] = torch.empty((b, cfg.n_frontend_tokens, cfg.d_model),
                                      dtype=torch.float32, device=META)
    return out


def _local_bytes(mesh, tree, specs) -> int:
    """One device's bytes of ``tree`` placed by ``specs`` (every block of a
    leaf is the same size)."""
    if isinstance(tree, dict):
        return sum(_local_bytes(mesh, tree[k], specs[k]) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(mesh, t, s) for t, s in zip(tree, specs))
    if not isinstance(tree, torch.Tensor):
        return 0
    split = math.prod(mesh.axis_size(a) for a in specs)
    return tree.numel() // split * tree.element_size()


def _trace_mesh(multi_pod: bool, tp: int):
    """One data-parallel replica of the production mesh: its model axis."""
    dims = (1, 1, tp) if multi_pod else (1, tp)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_lm_mesh(dims, axes, devices=simulated_devices(tp, META))


def _merge(a: dict, b: dict) -> dict:
    out = {"per_op_bytes": dict(a["per_op_bytes"]), "per_op_count": dict(a["per_op_count"]),
           "link_bytes": a["link_bytes"] + b["link_bytes"]}
    for key in ("per_op_bytes", "per_op_count"):
        for kind, v in b[key].items():
            out[key][kind] = out[key].get(kind, 0) + v
    return out


def _trace(model, params, shape, rules, multi_pod: bool, placed, train_kwargs=None) -> dict:
    """Trace one data-parallel replica of the cell's step: per-device FLOPs,
    bytes and collectives (:class:`cost.TraceCut` past its time limit)."""
    tp, dp = rules.tp, rules.dp()
    trace_rules = ShardingRules(_trace_mesh(multi_pod, tp), model.cfg, dp_axes=rules.dp_axes)
    rows = shape.global_batch // dp if shape.global_batch % dp == 0 else shape.global_batch
    batch = {k: v[:rows] for k, v in _inputs(model.cfg, shape).items()}
    params = shard_params(trace_rules, params)
    if shape.kind == "decode":  # the last slot of a cache seq_len deep
        cache = shard_cache(trace_rules, model.init_cache(rows, shape.seq_len, META))
        cache["pos"] = shape.seq_len - 1
    t0 = time.time()
    with use_rules(trace_rules):
        if shape.kind == "train":
            step_fn = build_train_step(model, **(train_kwargs or {}))
            _, spent = count(step_fn, params, adamw_init(params), batch, 0)
        elif shape.kind == "decode":
            with torch.no_grad():
                _, spent = count(model.decode_step, params, cache, batch["tokens"])
        else:
            with torch.no_grad():
                _, spent = count(model.prefill_logits, params, batch["tokens"],
                                batch.get("frontend"))
    trace_s = time.time() - t0
    coll = spent.collectives
    note = (f"one data-parallel replica traced ({tp} shards on the model axis) of {dp}; "
            "per-device FLOPs and bytes are its totals over its shards")
    if shape.kind == "train" and dp > 1:
        collectives.reset_stats()
        collectives.count_gradient_sync(rules, placed)
        coll = _merge(coll, collectives.STATS.as_dict())
        note += "; the data axes' gradient all-reduce added from the specs"
    if rules.fsdp and dp > 1:
        note += ("; FSDP's weight all-gathers and reduce-scatters over the data axes are not "
                 "counted (the traced replica has one data shard)")
    return dict(trace_s=trace_s, flops=spent.flops / tp, bytes=spent.bytes / tp,
                operators=spent.ops, collectives=coll, loops=spent.loops, traced=note)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str = OUT_DIR, *,
             reduced: bool = False, tag: str = "", cfg_override=None, fsdp: bool = False,
             model_kwargs: dict | None = None, train_kwargs: dict | None = None):
    """Place (and where the port runs it, trace) one cell.  ``reduced`` takes
    the config's and the shape's ``.reduced()`` on the production mesh.  As
    in the reference, variants pass ``tag`` (a separate record),
    ``cfg_override`` (ModelConfig -> ModelConfig), ``fsdp`` (ZeRO-3 weight
    sharding over the data axes), ``model_kwargs`` (``LM`` constructor knobs)
    and ``train_kwargs`` (``build_train_step``'s).  A trace still running
    after ``cost.TRACE_LIMIT_S`` stops: the record's status is ``cut``,
    with the operators and collectives it had counted."""
    cfg = _config(arch, reduced)
    if cfg_override is not None:
        cfg = cfg_override(cfg)
    shape = _shape(shape_name, reduced)
    ok, why = cell_applicable(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "tag": tag,
        "kind": shape.kind,
        "reduced": reduced,
        "fsdp": fsdp,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if not ok:
        record.update({"status": "skipped", "reason": why})
        _write(record, out_dir)
        print(f"[dryrun] SKIP {arch} x {shape_name} x {mesh_name}: {why}")
        return record

    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = ShardingRules(mesh, cfg, dp_axes=DP_AXES(multi_pod), fsdp=fsdp)
    model = LM(cfg, remat=(shape.kind == "train"), **(model_kwargs or {}))
    t0 = time.time()
    params = model.init_shapes()
    p_specs = param_pspecs(rules, params)
    placed = shard_params(rules, params)
    specs = _inputs(cfg, shape)
    b_spec = batch_pspec(rules, shape.kind, shape.global_batch)
    per_device = {
        "params": _local_bytes(mesh, params, p_specs),
        "inputs": _local_bytes(mesh, specs, b_spec),
    }
    if shape.kind == "train":  # float32 moments sharded like the parameters, and the step
        opt = adamw_init(params)
        per_device["opt_state"] = (_local_bytes(mesh, opt.mu, p_specs)
                                   + _local_bytes(mesh, opt.nu, p_specs)
                                   + opt.step.element_size())
    if shape.kind == "decode":
        cache = model.init_cache(shape.global_batch, shape.seq_len, META)
        record["cache_bytes"] = int(sum(t.numel() * t.element_size()
                                        for t in cache.values() if isinstance(t, torch.Tensor)))
        per_device["cache"] = _local_bytes(mesh, cache,
                                           cache_pspecs(rules, cache, shape.global_batch))
    record.update({
        "n_devices": mesh.size,
        "per_device_bytes": per_device,
        "mem_argument_size_in_bytes": sum(per_device.values()),
        "place_s": round(time.time() - t0, 2),
        "hw": HW,
    })
    try:
        record.update(_trace(model, params, shape, rules, multi_pod, placed, train_kwargs))
    except TraceCut as cut:
        limit = cost.TRACE_LIMIT_S
        record.update({"status": "cut", "trace_s": limit, "operators": cut.cost.ops,
                       "collectives": cut.cost.collectives,
                       "reason": f"the trace was stopped at its limit of {limit} s, after "
                                 f"{cut.cost.ops} operators"})
        _write(record, out_dir)
        print(f"[dryrun] CUT {arch} x {shape_name} x {mesh_name}: {record['reason']}")
        return record
    record["status"] = "ok"
    record["terms"] = roofline_terms(record, cfg, shape)
    _write(record, out_dir)
    print(f"[dryrun] OK {arch} x {shape_name} x {mesh_name}: trace {record['trace_s']:.1f}s "
          f"flops/dev {record['flops']:.3e} link_bytes/dev "
          f"{record['collectives']['link_bytes']:.3e}")
    return record


def roofline_terms(record: dict, cfg, shape) -> dict:
    """compute/memory/collective seconds per device against ``cost.HW``."""
    t_compute = record["flops"] / HW["peak_flops"]
    t_memory = record["bytes"] / HW["hbm_bw"]
    t_coll = record["collectives"].get("link_bytes", 0.0) / HW["link_bw"]
    terms = {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
    }
    dominant = max(terms, key=terms.get)
    terms["dominant"] = dominant
    # model FLOPs: 6 N D tokens (train), 2 N D (inference fwd only)
    n_active = record["active_params"]
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        model_flops = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        model_flops = 2.0 * n_active * tokens
    else:
        model_flops = 2.0 * n_active * shape.global_batch
    terms["model_flops_total"] = model_flops
    n_dev = record.get("n_devices", 1)
    total = record["flops"] * n_dev
    terms["useful_flop_ratio"] = model_flops / total if total else 0.0
    terms["roofline_fraction"] = (
        (model_flops / n_dev / HW["peak_flops"]) / max(max(t_compute, t_memory, t_coll), 1e-30)
    )
    terms["peaks"] = HW["card"]
    return terms


def _write(record: dict, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    tag = f"__{record['tag']}" if record.get("tag") else ""
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}{tag}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the configs' and shapes' .reduced() on the production mesh")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    if args.all:
        failures, records = [], []
        for arch in ARCH_IDS:
            for shape_name in SHAPES:
                try:
                    records.append(run_cell(arch, shape_name, args.multi_pod, args.out,
                                            reduced=args.reduced))
                except Exception as e:  # noqa: BLE001 - record and continue
                    traceback.print_exc()
                    failures.append((arch, shape_name, str(e)[:200]))
        if failures:
            print(f"[dryrun] {len(failures)} FAILURES:")
            for f in failures:
                print("   ", f)
            sys.exit(1)
        by = {}
        for r in records:
            by[r["status"]] = by.get(r["status"], 0) + 1
        print(f"[dryrun] all cells placed: {json.dumps(by)}")
        return records
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    return [run_cell(args.arch, args.shape, args.multi_pod, args.out, reduced=args.reduced)]


if __name__ == "__main__":
    main()
