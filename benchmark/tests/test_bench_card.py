"""On the card: each cell runs end to end for a short window and comes out
correct (run there with ``python -m pytest benchmark/tests -q -m card``)."""

import json
import subprocess
import sys

import pytest

from benchmark import cells


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in cells.spec()["workloads"]])
def test_cell_runs_correct_on_the_card(card, name):
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        name, "--seed", "3141592653", "--seconds", "2",
                        "--trace", "0"], cwd=cells.ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checked"]
    assert out["device"]["platform"] == "gpu"
