"""Runs one cell of the port's benchmark once and prints its result.

    python3 -m pvg_bench.run --workload bair.train --seed 7 --seconds 20 --trace 0

from the root of a checkout, on a machine with the card(s) the cell asks
for.  It builds the cell's program from the seed, warms up, measures for
``--seconds`` and checks the window's outputs against the plain reference.
With ``--trace 0`` the result holds the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a traced stretch after the
window.  The last line of standard output is one JSON object; the numbers
compared, each beside its limit, close standard error and that line.
Without a card it exits with 2 and prints no result; it never falls back to
the CPU.
"""
from __future__ import annotations

import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - started / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


CLOCK_START = time.perf_counter() - _process_age_s()
# Top-level module names that no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "playablevideogeneration_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``sys.modules``, compared whole."""
    names = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


def _arguments(argv):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def result_line(spec: dict, entry: dict, cell, outcome, setup_s: float, device_info: dict
                ) -> dict:
    """The result's keys in the contract's order, the checks last."""
    from pvg_bench import check, readers, spec as specs

    metrics = {}
    if cell.trace:
        reading = readers.Reading(cell, outcome)
        for metric in specs.metrics_of(spec, "per_layer", entry["name"]):
            value = readers.load_reader(metric["name"])(reading)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
        device_info = dict(device_info, busy_s=outcome.trace.busy_s,
                           window_s=outcome.trace.window_s)
    else:
        for metric in specs.metrics_of(spec, "end_to_end", entry["name"]):
            value = setup_s if metric["name"] == "setup_s" else outcome.end_to_end[metric["name"]]
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    # A step or request that fails raises and ends the run: none is counted
    # as failed in a run that prints a result.
    line = {"correct": check.passed(outcome.checks), "attempted": outcome.attempted,
            "failed": 0, "metrics": metrics, "device": device_info}
    if cell.trace:
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = outcome.checks
    return line


def main(argv=None) -> int:
    args = _arguments(argv)
    import json

    import torch

    from pvg_bench import drive, spec as specs

    bench = specs.benchmark()
    entry = specs.workload(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"pvg_bench: {args.workload} needs {entry['chips']} CUDA device(s), found {found}; "
              f"the benchmark measures the card and never falls back to the CPU",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = specs.cell(args.workload, args.seed, args.seconds, bool(args.trace), device, bench)
    outcome = drive.run(cell)
    setup_s = outcome.context["window_start"] - CLOCK_START
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
            "memory_peak_bytes": outcome.memory_peak_bytes}
    line = result_line(bench, entry, cell, outcome, setup_s, info)
    bad = forbidden_modules()
    if bad:
        print(f"pvg_bench: the run loaded {', '.join(bad)}, which no run of the port may",
              file=sys.stderr)
        return 3
    c = outcome.context
    print(f"pvg_bench: set-up {setup_s:.1f} s, window {c['window_s']:.1f} s, traced stretch "
          f"{c['traced_end'] - c['window_start'] - c['window_s']:.1f} s, check and readers "
          f"{time.perf_counter() - c['traced_end']:.1f} s", file=sys.stderr)
    if outcome.trace is not None:
        unit = "step" if "traced_steps" in c else "frame"
        traced, timed = c.get(f"traced_{unit}s"), c.get(f"{unit}s")
        if traced and timed:
            print(f"pvg_bench: device-only trace {1e3 * outcome.trace.window_s / traced:.4f} ms "
                  f"a {unit} against {1e3 * c['window_s'] / timed:.4f} in the window "
                  f"(the profiler's cost on the host)", file=sys.stderr)
    for name, value in outcome.readings.items():
        print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, c in outcome.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
