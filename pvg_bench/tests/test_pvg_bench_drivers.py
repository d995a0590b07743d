"""A kind of request found by name: the built-in drivers, or a file
``drivers/<driver>.py`` whose ``Outcome`` reaches the result's line; and the
end-to-end metrics, each reported in the cells that it lists."""
import copy
import os
import re
import subprocess
import sys

import pytest
import torch

from pvg_bench import drive, run, spec
from pvg_bench.run import forbidden_modules

STUB = '''
from pvg_bench import check
from pvg_bench.drive import Outcome


def run(cell):
    return Outcome(attempted=3, end_to_end={"eval_frames_per_s": 48.0},
                   context=dict(window_start=0.0, window_s=1.0, traced_end=1.0, frames=48),
                   checks=check.judged({"box_gap": 0.05}, cell.limits), memory_peak_bytes=7)
'''
CELLS = ["bair.train", "tennis.train", "bair.play", "bair.rollout"]


@pytest.fixture
def stub_dir(tmp_path, monkeypatch):
    (tmp_path / "stubkind.py").write_text(STUB)
    monkeypatch.setattr(drive, "DRIVER_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("limit, correct", [(0.1, True), (0.01, False)])
def test_driver_file_is_found_by_name(stub_dir, limit, correct):
    bench = copy.deepcopy(spec.benchmark())
    entry = {"name": "stub.eval", "config": "bair", "traffic": "stub", "chips": 1, "why": "-"}
    bench["workloads"].append(entry)
    bench["end_to_end"].insert(0, {"name": "eval_frames_per_s", "unit": "frames/s",
                                   "better": "higher", "bound": 0.05, "source": "host_clock",
                                   "workloads": ["stub.eval"]})
    cell = drive.Cell(workload="stub.eval", config={}, traffic={"driver": "stubkind"},
                      limits={"box_gap": limit}, seed=2 ** 31 + 5, seconds=1.0, trace=False,
                      device=torch.device("cpu"))
    outcome = drive.run(cell)
    line = run.result_line(bench, entry, cell, outcome, 12.5,
                           {"platform": "gpu", "count": 1, "memory_peak_bytes": 7})
    assert line["metrics"] == {"eval_frames_per_s": {"value": 48.0, "unit": "frames/s"},
                               "setup_s": {"value": 12.5, "unit": "s"}}
    assert line["correct"] is correct and line["attempted"] == 3
    assert list(line)[-1] == "checks"
    assert line["checks"] == {"box_gap": {"value": 0.05, "limit": limit}}


def test_unknown_driver_names_the_missing_path(stub_dir):
    path = os.path.join(str(stub_dir), "nosuchkind.py")
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        drive.load_driver("nosuchkind")


@pytest.mark.parametrize("name, function", [("train", "_train"), ("interactive", "_play"),
                                            ("rollout", "_play")])
def test_built_in_drivers(stub_dir, name, function):
    (stub_dir / f"{name}.py").write_text(STUB)
    assert drive.load_driver(name) is getattr(drive, function)


@pytest.mark.parametrize("workload", CELLS)
def test_cells_report_the_metrics_that_list_them(workload):
    bench = spec.benchmark()
    names = [m["name"] for m in spec.metrics_of(bench, "end_to_end", workload)]
    listing = [m["name"] for m in bench["end_to_end"] if workload in m.get("workloads", [])]
    assert sorted(names) == sorted(listing + ["setup_s"]) and listing


def test_end_to_end_metrics_name_their_cells():
    """Every end-to-end metric but ``setup_s`` lists one cell or more, and
    only cells of the benchmark: a metric that no cell reports has no
    place in ``BENCHMARK.json`` until its cell comes."""
    bench = spec.benchmark()
    cells = {entry["name"] for entry in bench["workloads"]}
    for metric in bench["end_to_end"]:
        assert ("workloads" in metric) == (metric["name"] != "setup_s"), metric["name"]
        listed = metric.get("workloads", ["setup_s"])
        assert listed and (metric["name"] == "setup_s" or set(listed) <= cells), metric["name"]


def test_loading_a_driver_file_loads_no_jax(stub_dir):
    code = ("import sys\nfrom pvg_bench import drive\n"
            f"drive.DRIVER_DIR = {str(stub_dir)!r}\ndrive.load_driver('stubkind')\n"
            "print(' '.join(sorted({n.split('.', 1)[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True)
    loaded = set(out.stdout.split())
    assert "torch" in loaded and forbidden_modules(loaded) == []
