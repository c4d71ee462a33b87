"""Each cell's run on the card, end to end through ``portbench/run.py`` (a short window)."""
import json
import subprocess
import sys

import pytest

from portbench import catalog


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in catalog.benchmark()["workloads"]])
def test_cell_is_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2147483659",
         "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=catalog.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, out.stderr[-4000:]
    assert list(result)[-1] == "checks"
