"""On the card: each cell runs through ``pvg_bench.run`` as the benchmark's
command does, prints its result line last and comes out correct; without
a card the command exits with 2 and prints no result."""
import json
import subprocess
import sys

import pytest

from pvg_bench import spec


def _run(workload: str, trace: int):
    return subprocess.run([sys.executable, "-m", "pvg_bench.run", "--workload", workload,
                           "--seed", str(2 ** 31 + 77), "--seconds", "2", "--trace", str(trace)],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=600)


@pytest.mark.chip
@pytest.mark.parametrize("workload", [w["name"] for w in spec.benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(card, workload):
    done = _run(workload, trace=0)
    assert done.returncode == 0, done.stderr[-2000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    done = _run("bair.play", trace=0)
    assert done.returncode == 2
    assert done.stdout == ""
    assert "never falls back to the CPU" in done.stderr
