"""The detector's kind of request: one client in a closed loop, each request
one ``TennisPlayerDetector.__call__`` on a (1, T, H, W, 3) sequence in
[0, 1] (a new seeded moving-square sequence each request: one call of the
person-box backend on its T frames), as the offline Tennis evaluation's
``DatasetEvaluator.compute_detections`` calls it once per sequence.

The detector is built as the evaluation builds it: the seed's fitted
weights (``detect_cell.seeded_variables``) are written as ``frcnn.npz``
with ``utils.pretrained.save_variables_npz`` into a directory of their
own, which the configuration's ``tpu.pretrained_weights_dir`` names, and
``evaluation.metrics.detection.make_detector(config)`` resolves
``evaluation.detector: frcnn`` through ``frcnn_backend_from_config`` to
``make_person_box_backend``, whose forward replays as a captured graph on
the card.  The detector's ``backend`` attribute is wrapped so that the box
lists of each call can be kept: those and the player centres of
``check_requests`` seeded requests spread over the window, and the
backend's detector module on the first frame of the first of them, are
compared with the plain reference (``reference/frcnn.py``) after the
window (``detect_cell.compared``).  ``fault``, for the limits' readings
alone, wraps the backend in one of ``detect_cell.SERVED_FAULTS``.

``play_fps`` counts the frames whose detections reached the host in the
window.  The context holds what the readers need: the window's calls
(``requests``) and the seconds per call of the port's ``HOST_SPANS``,
where the port has those spans; the traced calls.  The readings hold the
boxes a frame that the backend returned in the window, and the fit's
(``detect_cell.fit_player``).
"""
from __future__ import annotations

import copy
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

from pvg_bench import check, detect_cell, drive, trace as tracing
from pvg_bench.stats import rate


def build_detector(config: dict, variables: dict, device: torch.device):
    """``make_detector`` of the configuration, its ``frcnn.npz`` written
    into a directory that it names and that is gone once the weights are
    read."""
    from playablevideogeneration_tpu_torch.evaluation.metrics.detection import make_detector
    from playablevideogeneration_tpu_torch.utils import pretrained

    with tempfile.TemporaryDirectory() as directory:
        pretrained.save_variables_npz(variables,
                                      os.path.join(directory, pretrained.WEIGHT_FILES["frcnn"]))
        config = copy.deepcopy(config)
        config.setdefault("tpu", {})["pretrained_weights_dir"] = directory
        return make_detector(config, device)


def _port_tracing():
    from playablevideogeneration_tpu_torch.utils import tracing as port

    return port


# The port's spans of host work after a call's device work: the threshold
# and the tuples, the court filter and the tallest box.
HOST_SPANS = ("detect.boxes", "detect.select")


def _host_s(before: dict, after: dict, calls: int):
    """The seconds per call of ``HOST_SPANS`` between two tallies, or None
    where the port has not those spans."""
    if not calls or any(name not in after for name in HOST_SPANS):
        return None
    return sum(after[name][1] - before.get(name, (0, 0.0))[1] for name in HOST_SPANS) / calls


def run(cell: drive.Cell, fault: Optional[Callable] = None) -> drive.Outcome:
    config, traffic, device, seed = cell.config, cell.traffic, cell.device, cell.seed
    variables, fitted = detect_cell.seeded_variables(config, traffic, seed, device)
    drive.release(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)  # the fit's is not the program's
    detector = build_detector(config, variables, device)
    backend, last = detector.backend, {"boxes": None, "count": 0}
    served = backend if fault is None else fault(backend)

    def recording(frames):
        last["boxes"] = served(frames)
        last["count"] += sum(len(boxes) for boxes in last["boxes"])
        return last["boxes"]
    detector.backend = recording

    def serve(index: int):
        return detector(detect_cell.sequence(config, traffic, seed, index))[0]

    for k in range(traffic["warmup_requests"]):
        serve(detect_cell.WARMUP_REQUEST + k)

    frames_a_call = config["evaluation"]["batching"]["observations_count"]
    kept: Dict[int, detect_cell.Served] = {}
    spans, boxes_before = _port_tracing().tallies(), last["count"]
    start = time.perf_counter()
    # The window closes at ``seconds``, once ``check_requests`` requests
    # have been kept for the check.
    requests = 0
    while time.perf_counter() - start < cell.seconds or len(kept) < traffic["check_requests"]:
        keep = drive.kept_for_check(seed, requests, traffic["check_share"])
        centers = serve(requests)
        if keep:
            kept[requests] = (last["boxes"], centers)
        requests += 1
    window_s = time.perf_counter() - start
    frames = requests * frames_a_call
    context = dict(window_start=start, window_s=window_s, frames=frames,
                   requests=requests,
                   detect_host_s=_host_s(spans, _port_tracing().tallies(), requests))
    readings = dict(fitted, boxes_per_frame=(last["count"] - boxes_before) / frames)

    trace = None
    if cell.trace:
        first = detect_cell.WARMUP_REQUEST + traffic["warmup_requests"]

        def stretch(host: bool):
            for k in range(traffic["traced_requests"]):
                with tracing.span("detect", host):
                    serve(first + k)
        trace = drive.traced_twice(stretch)
        context.update(traced_calls=traffic["traced_requests"],
                       traced_frames=traffic["traced_requests"] * frames_a_call)
    context["traced_end"] = time.perf_counter()
    memory = drive.peak_memory(device)
    chosen = drive.checked_requests(seed, sorted(kept), traffic["check_requests"])
    frame = detect_cell.sequence(config, traffic, seed, chosen[0])[0][0]
    got = detect_cell.port_stages(backend.model, frame)
    del detector, backend, served, recording
    drive.release(device)

    reference = detect_cell.detector(config, variables, device)
    want = detect_cell.detections_of(reference, config, traffic, seed, chosen)
    numbers, shown = detect_cell.compared(config, {i: kept[i] for i in chosen}, want, got,
                                          detect_cell.stages_of(reference, frame, got.rois))
    return drive.Outcome(attempted=requests, end_to_end={"play_fps": rate(frames, window_s)},
                         context=context, checks=check.judged(numbers, cell.limits),
                         readings=dict(readings, **shown), memory_peak_bytes=memory,
                         trace=trace)
