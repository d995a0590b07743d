"""Capture a device profile of the training step and rank its time sinks.

Counterpart of ``tools/profile_step.py`` of the JAX package.  It runs the
synthetic BAIR-class train step (``training/bench_harness``: the
flagship's widths in bf16, checkpointed, full phase) once outside the
window and ``--steps`` times under ``torch.profiler``, writes the Chrome
trace into ``--trace-dir``, and prints three tables from that trace:

  1. the top-N kernels by device time, with calls per step, group and scope;
  2. device time by kernel group (``KERNEL_GROUPS``: convolution,
     elementwise, layout transpose ...), in place of the HLO category;
  3. device time by model scope (encoder / dynamics / rendering / action
     network / vgg / optimizer), the JAX tool's labels.

The scopes come from ``record_function`` ranges that this tool opens with
forward hooks on the model's representation, dynamics, rendering and
action networks and on the trainer's VGG19, and with step hooks on the
optimizer; nothing in the model or the trainer changes.  A backward kernel
runs on the autograd engine's thread, outside every forward range: it
takes the scope of the forward op that recorded its autograd node, found
through the backward op's ``Sequence number`` and ``Fwd thread id``.  The
checkpointed steps' recomputes call the modules again, so their hooks
scope them.  Device time that no scope claims is reported as
``unattributed`` with its top kernels, never folded into a scope.  On the
CPU (``--device cpu``) the rows are the operators' self time on the host.

The JAX tool's ``--policy`` is dropped: the port has no selective remat
policies, only per-step checkpointing.

Usage:
    python -m playablevideogeneration_tpu_torch.tools.profile_step \\
        [--batch 8] [--steps 3] [--top 25] [--px 256] [--t 12] \\
        [--trace-dir DIR] [--json out.json] [--device cuda]

With ``--trace-dir`` naming a directory that already holds a trace, that
trace is analysed and nothing is captured.  Runs on the GPU by default.
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Tuple

# Kernel-name fragments that sort a profiled step's device time, first
# match wins.
KERNEL_GROUPS = [
    ("port_kernels", ("gates_fwd_kernel", "gates_bwd_kernel",
                      "batch_norm_leaky_relu_kernel")),
    ("layout_transpose", ("nchwToNhwc", "nhwcToNchw", "tensorTransform")),
    ("convolution", ("fprop", "dgrad", "wgrad", "xmma", "winograd", "cutlass", "gemm",
                     "conv")),
    ("upsample", ("upsample",)),
    ("pooling", ("pool",)),
    ("batch_norm", ("batch_norm",)),
    ("reduction", ("reduce",)),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("copy_cast", ("copy",)),
    ("elementwise", ("elementwise",)),
]
# The JAX tool's labels for framework scopes, in its order.
_SCOPE_PATTERNS = [
    ("vgg (perceptual)", re.compile(r"vgg", re.I)),
    ("representation (encoder)", re.compile(r"representation", re.I)),
    ("dynamics (convlstm hourglass)", re.compile(r"dynamics", re.I)),
    ("rendering (decoder)", re.compile(r"rendering", re.I)),
    ("action network", re.compile(r"action", re.I)),
    ("optimizer/adam", re.compile(r"adam|optimizer|opt_state", re.I)),
    ("transpose/copy glue", re.compile(r"transpose|copy", re.I)),
]
UNATTRIBUTED = "unattributed"
# Range names: this tool's scopes carry the prefix; each profiled step is
# one STEP_RANGE.
SCOPE_PREFIX = "scope:"
STEP_RANGE = "profile_step:train_step"
TRACE_NAME = "train_step.pt.trace.json"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# The port's own spans (``utils.tracing.PREFIX``): host ranges recorded as
# operators, which the host tables leave out as they leave out annotations.
PORT_SPAN_PREFIX = "pvg."
FULL_PHASE_STEP = 4  # the step index the JAX tool passes: past pretraining


def kernel_group(name: str) -> str:
    return next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), "other")


def breakdown(kernels, top: int) -> dict:
    """(name, ms, calls) per kernel, sorted by time, as device time by
    kernel group, the ``top`` kernels, and each of the port's kernels on
    its own."""
    groups = {}
    for name, ms, calls in kernels:
        total = groups.setdefault(kernel_group(name), dict(ms=0.0, calls=0.0))
        total["ms"] += ms
        total["calls"] += calls

    def rows(ks):
        return [dict(kernel=k[0][:90], ms=k[1], calls=k[2]) for k in ks]

    return dict(groups=groups, top=rows(kernels[:top]),
                port=rows(k for k in kernels if kernel_group(k[0]) == "port_kernels"))


def classify_scope(tf_op_name: str) -> str:
    for label, pat in _SCOPE_PATTERNS:
        if pat.search(tf_op_name):
            return label
    return "other"


# --------------------------------------------------------------------- #
# Capture                                                               #
# --------------------------------------------------------------------- #


class ScopeRanges:
    """While entered, every call of the trainer's scoped modules runs
    inside a ``record_function`` range named ``scope:<module path>``, and
    every optimizer step inside ``scope:optimizer``."""

    def __init__(self, trainer):
        from torch.autograd.profiler import record_function

        self._record_function = record_function
        model = trainer.model
        self.modules = [(f"model.{name}", getattr(model, name)) for name in (
            "representation_network", "dynamics_network", "rendering_network",
            *(f"action_network_{i}" for i in range(model.ensemble_size)))]
        self.modules.append(("vgg", trainer.vgg))
        self.optimizer = trainer.state.optimizer
        self._handles = []

    def _open(self, name: str, stack: list):
        def enter(*_):
            stack.append(self._record_function(SCOPE_PREFIX + name).__enter__())
        return enter

    @staticmethod
    def _close(stack: list):
        def leave(*_):
            stack.pop().__exit__(None, None, None)
        return leave

    def __enter__(self):
        for name, module in self.modules:
            stack = []
            # always_call: a checkpoint's recompute stops with an exception
            # once it has what the backward needs, and the range must close.
            self._handles += [module.register_forward_pre_hook(self._open(name, stack)),
                              module.register_forward_hook(self._close(stack), always_call=True)]
        stack = []
        self._handles += [self.optimizer.register_step_pre_hook(self._open("optimizer", stack)),
                          self.optimizer.register_step_post_hook(self._close(stack))]
        return self

    def __exit__(self, *exc):
        for handle in self._handles:
            handle.remove()
        self._handles = []


def capture(batch: int, steps: int, height: int, width: int, t: int, trace_dir: str,
            device: str = "cuda"):
    """Profiles ``steps`` full-phase train steps after one warm step and
    writes the Chrome trace to ``trace_dir/TRACE_NAME``; returns the
    profiler (its ``key_averages()`` hold the same events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from playablevideogeneration_tpu_torch.inference import graphs
    from playablevideogeneration_tpu_torch.training.bench_harness import (
        build_synthetic_trainer,
        make_synthetic_batch,
    )

    def note(msg):
        print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)

    device = torch.device(device)
    # Op by op: the scopes are module hooks, which a graph's replay does
    # not fire.
    trainer = build_synthetic_trainer(height=height, width=width, batch_size=batch,
                                      observations_count=t, remat=True, device=device,
                                      backend=graphs.Eager)
    host = make_synthetic_batch(batch_size=batch, observations_count=t, height=height,
                                width=width)
    b = type(host)(*(torch.as_tensor(x, device=device) for x in host))
    # The JAX tool steps at index FULL_PHASE_STEP; the steps after it keep
    # the schedules where they end.
    trainer.global_step = FULL_PHASE_STEP - 1

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    note("trainer built; warming the train step")
    trainer.train_step(b)
    sync()
    note("warm step done; tracing")
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with ScopeRanges(trainer), profile(activities=activities) as prof:
        for _ in range(steps):
            with record_function(STEP_RANGE):
                trainer.train_step(b)
        sync()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_NAME))
    note("trace complete")
    return prof


# --------------------------------------------------------------------- #
# Analysis                                                              #
# --------------------------------------------------------------------- #


def find_trace(trace_dir: str) -> str:
    """The Chrome trace (``*.json`` or ``*.json.gz``) under ``trace_dir``."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
                   + glob.glob(os.path.join(trace_dir, "**", "*.json.gz"), recursive=True))
    if not paths:
        raise SystemExit(f"no Chrome trace (*.json, *.json.gz) under {trace_dir}")
    return paths[0]


def _nesting(host: List[dict]) -> List[int]:
    """For each host event, the index of the innermost host event of its
    thread that encloses it (-1 for none)."""
    order = sorted(range(len(host)), key=lambda i: (
        host[i].get("pid"), host[i].get("tid"), host[i]["ts"], -host[i].get("dur", 0)))
    parent = [-1] * len(host)
    stack: List[int] = []
    thread = None
    for i in order:
        e = host[i]
        if (e.get("pid"), e.get("tid")) != thread:
            thread, stack = (e.get("pid"), e.get("tid")), []
        while stack and host[stack[-1]]["ts"] + host[stack[-1]].get("dur", 0) <= e["ts"]:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    return parent


class _Scopes:
    """Resolves the scope (a ``scope:`` range's module path) of host
    events: the innermost enclosing scope range, or for an op inside a
    backward function, the scope of the forward op that recorded its
    autograd node."""

    def __init__(self, host: List[dict], parent: List[int]):
        self.host, self.parent = host, parent
        forward: Dict[Tuple, int] = {}
        backward = []
        for i, e in enumerate(host):
            args = e.get("args") or {}
            if e.get("cat") != "cpu_op" or "Sequence number" not in args:
                continue
            if args.get("Fwd thread id", 0) == 0:
                key = (e.get("pid"), e.get("tid"), args["Sequence number"])
                # The last op that read a sequence number created its node.
                if key not in forward or host[forward[key]]["ts"] <= e["ts"]:
                    forward[key] = i
            else:
                backward.append(args)
        self.forward = forward
        # The trace names a forward thread by the profiler's thread number,
        # not by its tid: each number is the thread whose forward ops hold
        # most of its backward ops' sequence numbers.
        threads = {(pid, tid) for pid, tid, _ in forward}
        votes = collections.Counter()
        for args in backward:
            for pid, tid in threads:
                if (pid, tid, args["Sequence number"]) in forward:
                    votes[args["Fwd thread id"], pid, tid] += 1
        self.threads: Dict[int, Tuple] = {}
        for (number, pid, tid), count in sorted(votes.items(), key=lambda kv: kv[1]):
            self.threads[number] = (pid, tid)
        self.memo: Dict[int, Optional[str]] = {}

    def _forward_op(self, e: dict) -> Optional[int]:
        args = e.get("args") or {}
        number = args.get("Fwd thread id", 0)
        if e.get("cat") != "cpu_op" or not number or "Sequence number" not in args:
            return None
        thread = self.threads.get(number)
        return None if thread is None else self.forward.get(
            (*thread, args["Sequence number"]))

    def scope(self, i: int) -> Optional[str]:
        path, found = [], None
        while i != -1:
            if i in self.memo:
                found = self.memo[i]
                break
            path.append(i)
            self.memo[i] = None  # guards against a cycle through forward ops
            e = self.host[i]
            if e.get("cat") == "user_annotation" and e["name"].startswith(SCOPE_PREFIX):
                found = e["name"][len(SCOPE_PREFIX):]
                break
            fwd = self._forward_op(e)
            if fwd is not None and (found := self.scope(fwd)) is not None:
                break
            i = self.parent[i]
        for j in path:
            self.memo[j] = found
        return found


def load_trace(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def analyze(trace_path: str) -> dict:
    """The trace's time by (kernel, scope) row, by group and by scope.

    Rows are the device's kernels, copies and memsets (``time_key``
    ``device_us``) or, in a trace without device events, the host
    operators' self time (``cpu_self_us``).  Each row's scope is the JAX
    tool's label of its launching op's scope, or ``unattributed``."""
    start = time.perf_counter()
    events = load_trace(trace_path)
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATEGORIES]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    steps = sum(e["name"] == STEP_RANGE for e in host) or 1
    parent = _nesting(host)
    scopes = _Scopes(host, parent)

    timed: Iterable[Tuple[str, float, int]]  # (name, us, launching host event)
    if device:
        time_key = "device_us"
        by_correlation, by_external = {}, {}
        for i, e in enumerate(host):
            args = e.get("args") or {}
            if e["cat"] in ("cuda_runtime", "cuda_driver") and "correlation" in args:
                by_correlation[args["correlation"]] = i
            elif e["cat"] in ("cpu_op", "user_annotation") and "External id" in args:
                by_external[args["External id"]] = i

        def launcher(e):
            args = e.get("args") or {}
            i = by_correlation.get(args.get("correlation"))
            return by_external.get(args.get("External id"), -1) if i is None else i

        timed = ((e["name"], float(e.get("dur", 0)), launcher(e)) for e in device)
    else:
        time_key = "cpu_self_us"
        self_us = [float(e.get("dur", 0)) for e in host]
        for i, p in enumerate(parent):
            if p != -1:
                self_us[p] -= float(host[i].get("dur", 0))
        timed = ((e["name"], self_us[i], i) for i, e in enumerate(host)
                 if e["cat"] == "cpu_op" and not e["name"].startswith(PORT_SPAN_PREFIX))

    table: Dict[Tuple[str, str], List[float]] = {}
    for name, us, i in timed:
        scope = scopes.scope(i) if i != -1 else None
        row = table.setdefault((name, UNATTRIBUTED if scope is None
                                else classify_scope(scope)), [0.0, 0])
        row[0] += us
        row[1] += 1
    rows = sorted(({"name": name, "scope": scope, "group": kernel_group(name), time_key: us,
                    "calls": calls, "calls_per_step": calls / steps}
                   for (name, scope), (us, calls) in table.items()),
                  key=lambda r: -r[time_key])
    total = sum(r[time_key] for r in rows)
    by_category, by_scope = collections.Counter(), collections.Counter()
    for r in rows:
        by_category[r["group"]] += r[time_key]
        by_scope[r["scope"]] += r[time_key]
    unattributed = [r for r in rows if r["scope"] == UNATTRIBUTED]
    return {"time_key": time_key, "total_us": total, "steps": steps,
            "by_category": dict(by_category.most_common()),
            "by_scope": dict(by_scope.most_common()), "rows": rows,
            "unattributed_share": by_scope[UNATTRIBUTED] / total if total else 0.0,
            "unattributed_top": unattributed[:10],
            "trace": {"path": trace_path, "bytes": os.path.getsize(trace_path),
                      "events": len(events), "parse_s": time.perf_counter() - start}}


def print_tables(result: dict, top: int) -> None:
    key, total, steps = result["time_key"], result["total_us"], result["steps"]
    what = "device time" if key == "device_us" else "host self time"

    def share(us):
        return 100 * us / max(total, 1e-9)

    def line(r):
        return (f"{r[key] / 1e3:9.2f} ms  {share(r[key]):5.1f}%  x{r['calls_per_step']:<8g} "
                f"{r['group']:<16} {r['scope']:<30} {r['name'][:90]}")

    print(f"== top {top} kernels by {what} (total {total / 1e3:.1f} ms over {steps} steps, "
          f"{total / 1e3 / steps:.1f} ms per step; calls per step) ==")
    for r in result["rows"][:top]:
        print(line(r))
    print("\n== by kernel group ==")
    for group, us in result["by_category"].items():
        print(f"{us / 1e3:9.2f} ms  {share(us):5.1f}%  {group}")
    print("\n== by model scope (forward hooks; backward through sequence numbers) ==")
    for scope, us in result["by_scope"].items():
        print(f"{us / 1e3:9.2f} ms  {share(us):5.1f}%  {scope}")
    print(f"\n== unattributed: {100 * result['unattributed_share']:.1f}% of the {what}; "
          "its top kernels ==")
    for r in result["unattributed_top"]:
        print(line(r))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--px", type=int, default=256)
    parser.add_argument("--t", type=int, default=12)
    parser.add_argument("--trace-dir", default=None,
                        help="reuse the trace in this directory if it holds one, else "
                             "capture into it (default: a new temporary directory)")
    parser.add_argument("--json", dest="json_out", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to profile on (default: cuda)")
    args = parser.parse_args(argv)

    trace_dir = args.trace_dir
    if trace_dir is None or not glob.glob(os.path.join(trace_dir, "**", "*.json*"),
                                          recursive=True):
        trace_dir = trace_dir or tempfile.mkdtemp(prefix="pvg_trace_")
        t0 = time.perf_counter()
        capture(args.batch, args.steps, args.px, args.px, args.t, trace_dir, args.device)
        print(f"# captured {args.steps} steps in {time.perf_counter() - t0:.1f}s -> "
              f"{trace_dir}", file=sys.stderr)

    result = analyze(find_trace(trace_dir))
    print_tables(result, args.top)
    trace = result["trace"]
    print(f"# trace {trace['path']}: {trace['bytes']} bytes, {trace['events']} events, "
          f"parsed in {trace['parse_s']:.1f}s", file=sys.stderr)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({**result, "rows": result["rows"][:200]}, f, indent=1)
        print(f"\n# wrote {args.json_out}", file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
