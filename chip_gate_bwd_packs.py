"""Times the ConvLSTM gate backward kernel (K2) in bf16 with each packed
width its source can take, 4 and 8 elements per thread (8- and 16-byte
accesses), at the flagship's training and loop shapes, on channels-last
inputs, on one NVIDIA GPU.

Run from the repository root on a machine with an H100:

    python3 chip_gate_bwd_packs.py

Each width is built from a copy of ``csrc/convlstm_gates.cu`` with
``kBwdPackBf16`` set to it, with the port's nvcc flags, into a temporary
directory, and called through its C entry point as the port's wrapper
calls it.  At each shape, each width's outputs must equal the plain
version's bit for bit; then the widths are timed in turns (4, 8, 8, 4),
warm and cold, as ``chip_smoke.py`` times kernels.  Prints each width's
registers, spills and SASS counts, one JSON line per timing, a summary
line with the medians per width and shape, and the card's nvidia-smi
line.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as smoke
from playablevideogeneration_tpu_torch.ops.cuda import build
from playablevideogeneration_tpu_torch.ops.cuda.convlstm_gates import _argtypes, _gate_math_bwd

WIDTHS = (4, 8)
PACK_CONSTANT = re.compile(r"constexpr int kBwdPackBf16 = \d+;")
SHAPES = smoke.unique(smoke.GATE_TRAIN_SHAPES + smoke.GATE_LOOP_SHAPES)


def build_widths(directory: Path) -> dict:
    """One nvcc per width, started together; emits each width's registers,
    spills and SASS counts of the backward kernel and returns its C entry
    point for bf16."""
    source = (build.CSRC_DIR / "convlstm_gates.cu").read_text()
    jobs = {}
    for width in WIDTHS:
        text, count = PACK_CONSTANT.subn(f"constexpr int kBwdPackBf16 = {width};", source)
        smoke.require(count == 1, "kBwdPackBf16 is not in the source")
        path = directory / f"convlstm_gates_{width}.cu"
        path.write_text(text)
        jobs[width] = (path.with_suffix(".so"), subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o",
             str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for width, (library, proc) in jobs.items():
        log, _ = proc.communicate(timeout=600)
        smoke.require(proc.returncode == 0, f"nvcc failed for width {width}:\n{log}")
        report = smoke.kernel_report({width: log}, [library])
        smoke.emit(phase="pack_build", width=width, kernels={
            label: entry for label, entry in report.items() if "bwd" in label})
        fn = ctypes.CDLL(str(library)).convlstm_gates_bwd_bf16
        fn.argtypes = _argtypes(6)
        fn.restype = ctypes.c_int
        entries[width] = fn
    return entries


def launcher(fn, width: int):
    def run(gates, c, dh, dc):
        dgates, dc_prev = torch.empty_like(gates), torch.empty_like(c)
        status = fn(gates.data_ptr(), c.data_ptr(), dh.data_ptr(), dc.data_ptr(),
                    dgates.data_ptr(), dc_prev.data_ptr(), c.shape[0], math.prod(c.shape[1:]),
                    c.shape[1], width, c.device.index, torch.cuda.current_stream().cuda_stream)
        smoke.require(status == 0, f"width {width}: CUDA error {status}")
        return dgates, dc_prev
    return run


def time_width(run, shape, gen) -> tuple:
    """(warm ms, cold ms) of one launch at ``shape``, as kernel_time."""
    make = lambda: smoke.stored(smoke.gate_backward_inputs(shape, torch.bfloat16, gen))  # noqa: E731
    args = make()
    warm = smoke.device_ms(lambda: run(*args))
    sets = [args] + [make() for _ in range(math.ceil(
        smoke.COLD_BYTES / (math.prod(shape) * 24)))]
    turn = itertools.cycle(sets)
    cold = smoke.device_ms(lambda: run(*next(turn)))
    return warm, cold


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_gate_bwd_packs.py: torch.cuda.is_available() is False; it needs an "
                 "NVIDIA GPU")
    card = smoke.nvidia_smi()
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    with tempfile.TemporaryDirectory() as directory:
        runs = {w: launcher(fn, w) for w, fn in build_widths(Path(directory)).items()}
        times = {}
        for shape in SHAPES:
            args = smoke.stored(smoke.gate_backward_inputs(shape, torch.bfloat16, gen))
            want = _gate_math_bwd(*args)
            for width, run in runs.items():
                smoke.compare(f"K2 width {width}", shape, torch.bfloat16, run(*args), want)
            for width in WIDTHS + WIDTHS[::-1]:
                warm, cold = time_width(runs[width], shape, gen)
                smoke.emit(phase="pack_time", shape=shape, width=width, us=warm * 1e3,
                           cold_us=cold * 1e3)
                entry = times.setdefault(f"{'x'.join(map(str, shape))}/{width}",
                                         dict(us=[], cold_us=[]))
                entry["us"].append(warm * 1e3)
                entry["cold_us"].append(cold * 1e3)
    bound = {f"{'x'.join(map(str, s))}": math.prod(s) * 24 / smoke.HBM_BYTES_PER_S * 1e6
             for s in SHAPES}
    print(json.dumps({"bound_us": bound, "median": {
        key: {k: statistics.median(v) for k, v in entry.items()} for key, entry in times.items()},
        "all": times}))
    print(card)


if __name__ == "__main__":
    main()
