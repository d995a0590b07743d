"""The detector's benchmark cell (``tennis.detect``) on the CPU at a tiny
size: the port's detector spans, the cell's run through
``make_detector`` with its check against the plain reference, the control
and the planted faults (in the reference's place, and in what the window
serves) reading not correct against the cell's limits, the compared
numbers on made-up boxes, and the operation counts at the cell's size.

The tiny cell: sequences of 2 frames of 64 x 96 at a transform of 64/128,
2 checked requests; the configuration's thresholds and counts otherwise.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_parity import single_threaded_torch  # noqa: F401 (an autouse fixture)

from playablevideogeneration_tpu_torch.evaluation.metrics import frcnn
from playablevideogeneration_tpu_torch.evaluation.metrics.detection import (
    TennisPlayerDetector,
)
from playablevideogeneration_tpu_torch.inference import graphs
from playablevideogeneration_tpu_torch.utils import tracing
from pvg_bench import check, detect_cell, detect_counts, drive, run, spec
from pvg_bench.reference import frcnn as ref

WORKLOAD = "tennis.detect"
SEED = 2 ** 31 + 4321  # above 32 signed bits, as the benchmark's seeds may be
DETECT_SPANS = ("detect.call", "detect.readback", "detect.boxes")


def tiny_cell(seed: int = SEED, trace: bool = False) -> drive.Cell:
    config = copy.deepcopy(spec.program_config("tennis_frcnn"))
    config["data"]["target_input_size"] = [96, 64]
    config["detector"].update(min_size=64, max_size=128)
    config["evaluation"]["detector_resize"] = [64, 128]
    config["evaluation"]["batching"]["observations_count"] = 2
    traffic = spec.traffic("detect_eval")
    traffic.update(warmup_requests=1, check_requests=2, check_share=1.0, traced_requests=1)
    return drive.Cell(workload=WORKLOAD, config=config, traffic=traffic,
                      limits=spec.limits(WORKLOAD), seed=seed, seconds=0.2, trace=trace,
                      device=torch.device("cpu"))


@pytest.fixture(scope="module")
def traced_run():
    cell = tiny_cell(trace=True)
    return cell, drive.run(cell)


def _since(before: dict) -> dict:
    return {name: count - before.get(name, (0, 0.0))[0]
            for name, (count, _) in tracing.tallies().items()
            if count != before.get(name, (0, 0.0))[0]}


@pytest.mark.parametrize("backend", [None, graphs.StandIn], ids=["eager", "stand_in"])
def test_detector_spans_and_box_counter_fire_once_a_call(backend):
    variables = frcnn.random_frcnn_variables(5)
    variables["params"]["box_head"]["cls_score"]["bias"][frcnn.PERSON_LABEL] += 8.0
    person_boxes = frcnn.make_person_box_backend(variables, min_size=64, max_size=128,
                                                 device="cpu", backend=backend)
    detector = TennisPlayerDetector(backend=person_boxes)
    frames = np.random.default_rng(6).uniform(0, 1, (1, 2, 64, 96, 3)).astype(np.float32)
    kept = {}

    def recording(sequence):
        kept["boxes"] = person_boxes(sequence)
        return kept["boxes"]
    detector.backend = recording
    for call in range(2):
        before = tracing.tallies()
        detector(frames)
        moved = _since(before)
        want = {name: 1 for name in DETECT_SPANS + ("detect.select",)}
        if backend is not None:
            want.update({"program.replay": 1}, **({"program.capture": 1} if call == 0 else {}))
        assert moved == want
        assert sum(len(frame) for frame in kept["boxes"]) > 0


def test_detector_spans_nest_in_the_call_under_the_profiler():
    variables = frcnn.random_frcnn_variables(5)
    person_boxes = frcnn.make_person_box_backend(variables, min_size=64, max_size=128,
                                                 device="cpu")
    frames = np.random.default_rng(7).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        person_boxes(frames)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(tracing.PREFIX + "detect.")]
    (_, start, end), = [e for e in events if e[0] == "pvg.detect.call"]
    inner = sorted(name for name, s, e in events if name != "pvg.detect.call")
    assert inner == sorted("pvg." + name for name in DETECT_SPANS[1:])
    assert all(start <= s <= e <= end for _, s, e in events)


def test_the_cell_runs_correct_through_make_detector(traced_run):
    cell, outcome = traced_run
    assert check.passed(outcome.checks), outcome.checks
    assert set(outcome.checks) == {"box_gap", "overlap_share", "missed_share", "feature_gap",
                                   "head_gap"}
    assert outcome.checks["missed_share"]["value"] == 0.0
    assert outcome.readings["checked_frames"] == 4
    assert outcome.readings["center_miss"] == 0.0
    assert outcome.readings["boxes_per_frame"] == outcome.readings["program_boxes_per_frame"] > 0
    c = outcome.context
    assert c["frames"] == 2 * c["requests"] == 2 * outcome.attempted
    assert c["detect_host_s"] > 0 and c["traced_calls"] == 1


def test_the_result_line_holds_the_cells_metrics(traced_run):
    cell, outcome = traced_run
    bench = spec.benchmark()
    entry = spec.workload(WORKLOAD, bench)
    line = run.result_line(bench, entry, cell, outcome, 3.0, {"platform": "cpu"})
    assert line["correct"] is True and list(line)[-1] == "checks"
    # no device here: K4's share finds no kernel to read
    assert set(line["metrics"]) == {"detect_mfu", "detect_host_ms", "idle_share.play"}
    line = run.result_line(bench, entry, dataclasses.replace(cell, trace=False),
                           dataclasses.replace(outcome, trace=None), 3.0, {"platform": "cpu"})
    assert set(line["metrics"]) == {"play_fps", "setup_s"}
    assert line["metrics"]["play_fps"]["value"] == outcome.end_to_end["play_fps"]


@pytest.mark.parametrize("what", sorted(ref.VARIANTS))
def test_control_and_faults_are_not_correct(what):
    cell = tiny_cell()
    numbers, _ = detect_cell.variant_numbers(cell.config, cell.traffic, cell.seed, cell.device,
                                             what)
    assert not check.passed(check.judged(numbers, cell.limits)), numbers


@pytest.mark.parametrize("what", sorted(detect_cell.SERVED_FAULTS))
def test_served_faults_are_not_correct(what):
    """Half of each call's frames served no boxes, or each call the boxes
    of the call before it: the window's own output, checked as it is."""
    cell = tiny_cell()
    outcome = drive.load_driver("detect")(cell, fault=detect_cell.SERVED_FAULTS[what])
    assert not check.passed(outcome.checks), outcome.checks


def _detections(boxes, scores):
    return ref.Detections(boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                          scores=np.asarray(scores, np.float32))


def _stages(seed: int = 0, scale: float = 1.0) -> ref.Stages:
    g = torch.Generator().manual_seed(seed)
    return ref.Stages(levels=[torch.randn(4, 6, 6, generator=g, dtype=torch.float64) * scale
                              for _ in range(5)],
                      rois=torch.rand(7, 4, generator=g),
                      logits=torch.randn(7, ref.NUM_CLASSES, generator=g, dtype=torch.float64),
                      deltas=torch.randn(7, 4, generator=g, dtype=torch.float64))


def test_compared_numbers_on_made_up_boxes():
    config = spec.program_config("tennis_frcnn")
    a, b = (70.0, 20.0, 100.0, 90.0), (100.0, 30.0, 130.0, 85.0)
    want = {0: [_detections([a, b], [0.95, 0.9])]}
    settings = ref.Settings.from_config(config)
    stages = _stages()

    def compared(boxes):
        height, width = detect_cell.frame_size(config)
        centres = ref.player_centers([_detections(boxes, [0.95] * len(boxes))], width, height,
                                     settings)
        return detect_cell.compared(config, {0: ([list(boxes)], centres)}, want, stages, stages)

    same, readings = compared([a, b])
    assert same == {"box_gap": 0.0, "overlap_share": 0.0, "missed_share": 0.0,
                    "feature_gap": 0.0, "head_gap": 0.0}
    assert readings["center_miss"] == 0.0
    moved, readings = compared([a, (b[0] + 0.5,) + b[1:]])
    assert moved["box_gap"] == pytest.approx(0.25) and moved["missed_share"] == 0.0
    lost, readings = compared([a])
    assert lost["missed_share"] == pytest.approx(1 / 3) and readings["center_miss"] == 0.0
    tall = (160.0, 10.0, 180.0, 95.0)  # a taller box the reference does not have
    extra, readings = compared([a, b, tall])
    assert extra["missed_share"] == pytest.approx(1 / 5) and readings["center_miss"] == 1.0
    assert extra["overlap_share"] == 0.0
    # a box at IoU 0.6 with the reference's is near it, and not at 0.9
    shifted = (b[0] + 7.5, b[1], b[2] + 7.5, b[3])
    near, readings = compared([a, shifted])
    assert near["missed_share"] == 0.0 and readings["matched_boxes"] == 1
    # a box at IoU 0.6 with b, which an NMS at 0.5 would have dropped
    beside = (b[0] + 7.5, b[1], b[2] + 7.5, b[3])
    assert detect_cell.iou(np.array([b]), np.array([beside]))[0, 0] == pytest.approx(0.6)
    overlapping, _ = compared([a, b, beside])
    assert overlapping["overlap_share"] == 1.0


def test_stage_gaps_are_relative():
    want = _stages(seed=1)
    scaled = ref.Stages(levels=[level * 1.01 for level in want.levels], rois=want.rois,
                        logits=want.logits, deltas=want.deltas)
    gaps = detect_cell.stage_gaps(scaled, want)
    assert gaps["feature_gap"] == pytest.approx(0.01) and gaps["head_gap"] == 0.0
    shifted = ref.Stages(levels=want.levels, rois=want.rois, logits=want.logits + 5.0,
                         deltas=want.deltas)
    # a shift common to every RoI against the logits' spread over the RoIs
    spread = float((want.logits - want.logits.mean(dim=0)).norm())
    assert detect_cell.stage_gaps(shifted, want)["head_gap"] == pytest.approx(
        5.0 * want.logits.numel() ** 0.5 / spread)


def test_nms_sets_and_operations_at_the_cells_size():
    config = spec.program_config("tennis_frcnn")
    assert detect_counts.level_shapes(config) == [(128, 336), (64, 168), (32, 84), (16, 42),
                                                  (8, 21)]
    assert detect_counts.nms_sets(config) == [(16, 1000)] * 4 + [(16, 504), (16, 1000)]
    bound_us = 1e6 * detect_counts.nms_ops(config) / detect_counts.PEAK_F32_FLOPS
    assert bound_us == pytest.approx(8.77, abs=0.01)  # K4's bound a call


def test_call_flops_at_the_cells_size():
    """About 143 GMAC a frame: 16 frames, 4.6 TFLOP a call."""
    flops = detect_counts.call_flops(spec.program_config("tennis_frcnn"))
    assert 4.3e12 < flops < 4.9e12
