"""``python -m repro_torch.launch.serve``, in process, on the CPU at a tiny size.

Every ported mode serves a few ``turbofan`` requests with ``--device cpu``
and prints the paper's §4 table (latency and the guarantee rate; speedup
over exact for the one-request modes; throughput, queue delay and, for the
continuous mode, lane occupancy and recycles); the arrival-driven modes
also with deadlines, the degradation controller, faults (seeds whose first
call fails or whose first chunk poisons a lane) and the feature cache.  The
sharded modes refuse what the mesh cannot serve (``--devices`` on a mode
that has no lanes to shard, a batch that does not split over the shards,
the cache beside a mesh); ``tests/test_torch_sharded_serving.py`` serves
them.  The default device is the card, which raises without one.
"""
import pytest
import torch

from repro_torch.launch.serve import main

TINY = ["--pipeline", "turbofan", "--device", "cpu", "--rows-per-group", "400",
        "--requests", "6", "--m", "64", "--arrival-rate", "200"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode,extra,keys", [
    ("host", [], ["speedup", "guarantee_rate", "mean_sample_frac", "p95_latency_s"]),
    ("fused", ["--cache-size", "8"], ["speedup", "guarantee_rate", "cache_hits"]),
    ("fused-batched", ["--slo-ms", "5000", "--degrade", "--fault-profile", "failures",
                       "--fault-seed", "25"],
     ["throughput_rps", "p99_latency_ms", "mean_queue_delay_ms", "guarantee_rate",
      "n_shed", "deadline_met_rate"]),
    ("fused-continuous", ["--chunk-iters", "2", "--batch-size", "2"],
     ["throughput_rps", "p50_latency_ms", "lane_occupancy", "n_recycles", "n_chunks",
      "chunk_wasted_frac"]),
    ("fused-continuous", ["--cache-size", "8", "--fault-profile", "poison", "--fault-seed", "26",
                          "--degrade", "--slo-ms", "5000"],
     ["n_poisoned", "n_rollbacks", "cache_misses"]),
], ids=["host", "fused-cached", "batched-slo-faults", "continuous", "continuous-cached-faults"])
def test_every_mode_prints_the_section_4_table(mode, extra, keys, capsys):
    summary = main(TINY + ["--mode", mode] + extra)
    out = capsys.readouterr().out
    assert f"mode={mode}" in out and "device=cpu" in out
    for key in keys:
        assert f"  {key} " in out, (key, out)
    assert summary["guarantee_rate"] > 0.0
    if mode != "host":
        assert "slots_built" in out
    if mode.startswith("fused-"):
        assert summary["n"] + summary["n_shed"] + summary["n_failed"] + summary[
            "n_poisoned"] == summary["n_offered"]
    if "failures" in extra:   # seed 25 fails the first call, and the retry serves it
        assert summary["n_retries"] >= 1


@pytest.mark.parametrize("argv,error", [
    (["--mode", "fused-sharded", "--devices", "3"], "divisible"),
    (["--mode", "fused-batched", "--devices", "2"], "--devices shards"),
], ids=["argv0", "argv1"])
def test_sharded_lanes_raise_naming_the_roadmap_item(argv, error, capsys):
    """What the serving mesh refuses: a batch of 8 lanes over 3 shards, and
    ``--devices`` on a mode without a mesh (an argparse error)."""
    with pytest.raises((ValueError, SystemExit)) as e:
        main(TINY + argv)
    assert error in str(e.value) + capsys.readouterr().err


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--pipeline", "turbofan", "--mode", "fused"])
