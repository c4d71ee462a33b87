"""Every configuration, traffic mix, limit and metric of BENCHMARK.json is a file of its
own, parses, and is found by its name; a new workload entry with its files is a new cell."""
import json
import re
import shutil

import pytest

from portbench import catalog, traffic

BENCH = catalog.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
        assert all(NAME.match(n) for n in names), section
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"], e["name"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert all(m["better"] in ("lower", "higher") for m in BENCH["end_to_end"] + BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_are_found_by_name(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    c = catalog.cell(cell)
    cfg = next(x for x in BENCH["configs"] if x["name"] == w["config"])
    assert json.loads((catalog.ROOT / cfg["file"]).read_text()) == c["config_spec"]
    assert c["config_spec"]["name"] == w["config"]
    assert set(c["limits"]) >= {"plan_mismatch", "prob_gap"}
    assert c["traffic_spec"]["arrivals"] in traffic.ARRIVALS
    e2e = catalog.reported(BENCH, "end_to_end", cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert catalog.reported(BENCH, "per_layer", cell)


@pytest.mark.parametrize("path", sorted(
    f"{kind}/{p.name}" for kind in ("configs", "traffic", "limits")
    for p in (catalog.HERE / kind).glob("*.json")))
def test_every_data_file_parses(path):
    """Files no cell uses yet too: each parses and is found by its name."""
    kind, name = path.split("/")
    spec = catalog.load(kind, name[: -len(".json")])
    if kind == "traffic":
        assert spec["arrivals"] in traffic.ARRIVALS
        assert spec["lanes"] >= 1 and spec["chunk_iters"] >= 1 and spec["segment_requests"] >= 1
    elif kind == "configs":
        assert spec["name"] == name[: -len(".json")]
        assert (catalog.HERE / "limits" / name).is_file()


@pytest.mark.parametrize("reader", sorted(p.stem for p in (catalog.HERE / "metrics").glob("*.py")))
def test_every_reader_file_loads(reader):
    assert callable(catalog.metric_reader(reader))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(catalog.metric_reader(metric))
    entry = next(m for m in BENCH["end_to_end"] + BENCH["per_layer"] if m["name"] == metric)
    for cell in entry.get("workloads", []):
        assert cell in {w["name"] for w in BENCH["workloads"]}
    if metric in {m["name"] for m in BENCH["per_layer"]}:
        assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_adding_a_file_adds_a_cell(tmp_path, monkeypatch):
    """A workload entry and the traffic file it names are all a new cell takes."""
    for kind in ("configs", "traffic", "limits"):
        shutil.copytree(catalog.HERE / kind, tmp_path / kind)
    sat = json.loads((catalog.HERE / "traffic" / "tight.sat.json").read_text())
    (tmp_path / "traffic" / "tight.sat8.json").write_text(json.dumps(dict(sat, lanes=8)))
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "turbofan.tight.sat8", "config": "turbofan", "traffic": "tight.sat8",
         "chips": 1, "why": "eight lanes"}])
    monkeypatch.setattr(catalog, "HERE", tmp_path)
    c = catalog.cell("turbofan.tight.sat8", bench)
    assert c["traffic_spec"]["lanes"] == 8 and c["config_spec"]["name"] == "turbofan"
    with pytest.raises(KeyError):
        catalog.cell("turbofan.tight.sat8")
    with pytest.raises(FileNotFoundError):
        catalog.cell("turbofan.tight.sat16", dict(bench, workloads=[
            dict(bench["workloads"][-1], name="turbofan.tight.sat16", traffic="tight.sat16")]))
