"""The detector's cell: its inputs, its weights, the reference's side of
its check and the numbers compared, and the readings that set its limits.

- ``sequence``: request ``index``'s (1, T, H, W, 3) float32 frames in
  [0, 1], a seeded moving-square video (``videos.moving_square``) of the
  configuration's frame size and sequence length.
- ``seeded_variables``: the port's ``frcnn.random_frcnn_variables(seed)``
  (the converted layout) fitted by the plain reference to find the
  square, the synthetic player, on a calibration sequence that no window
  serves (``fit_player``): the RPN's and the person box deltas shrunk, the
  RPN's objectness and the person logit linear discriminants of their
  features on the square against off it, and the person bias set so that
  the median calibration frame holds ``boxes`` boxes above the 0.8 person
  threshold.  Random heads score a plateau of near-equal boxes that
  rounding reorders, so that which boxes pass 0.8 would follow TF32's
  rounding and not the frame; fitted, the boxes above it lie on the
  square and far from the threshold.
- ``compared``: the numbers that decide ``correct``, from what the
  program produced on the checked requests (their box lists, every
  frame) and from its detector module on the first frame of the first of
  them (``port_stages``: the FPN levels, and the box head on its own
  RoIs), against the reference's on the same frames and RoIs:

  - ``box_gap``: over the reference's boxes above the person threshold
    that a program box matches at IoU >= ``MATCH_IOU``, the median of the
    largest coordinate difference in input pixels;
  - ``overlap_share``: the share of frames in which two of the program's
    boxes overlap at an IoU above the box stage's NMS threshold by more
    than ``OVERLAP_MARGIN``, which a greedy NMS never leaves (0 for the
    reference by construction);
  - ``missed_share``: over every checked frame, the reference's boxes
    scoring at least ``SURE`` with no program box at IoU >= ``NEAR_IOU``,
    plus the program's boxes with no reference box scoring at least
    ``UNSURE`` there, over the two counts: a frame served no boxes, or
    another frame's, reads here; the margins around 0.8 keep a box that
    rounding moves across the threshold out;
  - ``feature_gap``: over the levels P2..P6, the largest ||program -
    reference|| / ||reference||;
  - ``head_gap``: for the class logits and for the person box deltas on
    the program's RoIs, ||program - reference|| over the reference's
    spread over the RoIs (||reference - its mean over the RoIs||), the
    larger of the two.

  Beside them, not compared: ``center_miss``, the share of frames whose
  player centre is found on one side alone or lies more than
  ``CENTER_PX`` pixels from the reference's (the tallest of boxes of
  nearly one height can change with rounding).

``python3 -m pvg_bench.detect_cell --what program|control|<fault> --seeds
a,b,c`` prints the compared numbers per seed: ``program`` runs the cell as
the benchmark does (a window of ``--seconds``), and a name of
``SERVED_FAULTS`` runs it with that fault planted in what the window
serves; the others put ``reference.frcnn.VARIANTS[what]`` (the bfloat16
control or a planted fault) in the program's place on the first
``check_requests`` requests.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import copy
import json
import math
import statistics
import sys
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from pvg_bench import videos
from pvg_bench.reference import frcnn as ref

MATCH_IOU = 0.9
NEAR_IOU = 0.5
OVERLAP_MARGIN = 0.01  # the program's NMS compares its IoU in float32
SURE, UNSURE = 0.85, 0.75
CENTER_PX = 1.0
RIDGE = 1e-3
# Request indices of the calibration sequence and of the warm-up's, the
# window's from 0.
CALIBRATION_REQUEST = (1 << 40) - 1
WARMUP_REQUEST = 1 << 40

# What a checked request produced: its box lists per frame and its (T, 2)
# player centres.
Served = Tuple[List[List[tuple]], np.ndarray]


def frame_size(config: dict) -> Tuple[int, int]:
    """(height, width) of the configuration's frames."""
    width, height = config["data"]["target_input_size"]
    return height, width


def sequence(config: dict, traffic: dict, seed: int, index: int) -> np.ndarray:
    """Request ``index``'s (1, T, H, W, 3) frames in [0, 1], float32."""
    height, width = frame_size(config)
    frames = config["evaluation"]["batching"]["observations_count"]
    video, _ = videos.moving_square(seed, index, frames, height, width,
                                    traffic["square_actions"])
    return (video.astype(np.float32) / 255.0)[None]


def square_box(frame: np.ndarray) -> np.ndarray:
    """(x1, y1, x2, y2), float64, of the square's pixels in one (H, W, 3)
    frame in [0, 1]."""
    mask = np.all(np.abs(frame * 255.0 - np.asarray(videos.SQUARE_COLOUR)) < 0.5, axis=-1)
    ys, xs = np.nonzero(mask)
    return np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float64)


class _Means:
    """The feature rows on the square, and running sums of the rows off it
    and of all the rows' outer products."""

    def __init__(self):
        self.on, self.off, self.outer = [], 0.0, 0.0
        self.n_off = 0

    @property
    def n_on(self) -> int:
        return sum(len(rows) for rows in self.on)

    def add(self, features: torch.Tensor, on: torch.Tensor) -> None:
        features = features.double()
        self.on.append(features[on])
        self.off = self.off + features[~on].sum(dim=0)
        self.outer = self.outer + features.T @ features
        self.n_off += int((~on).sum())

    def probe(self, ceiling: float) -> Tuple[np.ndarray, float]:
        """(weights, bias) of the linear discriminant of the rows on the
        square against the others (the covariance of all the rows, with a
        ridge of ``RIDGE`` of its mean variance), scoring the mean row 0
        and the best row on the square ``ceiling``: no score saturates a
        sigmoid or a softmax in float32, where ties would order the boxes
        by their index."""
        on = torch.cat(self.on)
        n = len(on) + self.n_off
        mean = (on.sum(dim=0) + self.off) / n
        covariance = self.outer / n - torch.outer(mean, mean)
        ridge = RIDGE * float(torch.trace(covariance)) / len(mean)
        direction = torch.linalg.solve(
            covariance + ridge * torch.eye(len(mean), dtype=mean.dtype, device=mean.device),
            on.mean(dim=0) - self.off / self.n_off)
        weights = ceiling * direction / float(((on - mean) @ direction).max())
        return weights.cpu().numpy(), -float(weights @ mean)


def _on_square(overlap: torch.Tensor, share: float) -> torch.Tensor:
    """The boxes whose IoU with the square is at least ``share`` of the
    best IoU that any of them reaches."""
    return (overlap > 0) & (overlap >= share * overlap.max())


def fit_player(variables: dict, settings: ref.Settings, frames: np.ndarray, device,
               fit: dict) -> Tuple[dict, Dict[str, float]]:
    """``variables`` made to find the square, the synthetic player, on
    ``frames`` (T, H, W, 3), and readings of the fit.

    - The RPN's box deltas and the box head's person deltas are scaled by
      ``fit["shrink"]``: random ones move a box by more than its size.
    - The RPN's objectness is a linear discriminant (``_Means.probe``) of
      its shared convolution's features at the anchors on the square
      against the others, one per aspect ratio; the box head's person
      logit one of ``fc7`` on the RoIs whose person box is on the square
      against the others (``_on_square`` at ``fit["share"]``), the best on
      the square scoring ``fit["objectness_ceiling"]`` and
      ``fit["person_ceiling"]`` logits above the mean.
    - The person bias puts the settings' person threshold midway between
      the ``fit["boxes"]``-th and the next person margin over the other
      classes' log-sum-exp of the box stage's NMS, in the median frame."""
    variables = copy.deepcopy(variables)
    params = variables["params"]
    shrink, share, rank = fit["shrink"], fit["share"], fit["boxes"]
    for leaf in ("kernel", "bias"):
        params["rpn_head"]["bbox_pred"][leaf] *= shrink
    person = slice(4 * ref.PERSON, 4 * ref.PERSON + 4)
    params["box_head"]["bbox_pred"]["kernel"][:, person] *= shrink
    params["box_head"]["bbox_pred"]["bias"][person] *= shrink
    squares = [square_box(f) for f in frames]

    detector = ref.Detector(variables, device, settings)
    ratios = len(ref.ASPECT_RATIOS)
    anchors_on = [_Means() for _ in range(ratios)]
    with torch.no_grad(), ref.float32_products():
        for frame, square in zip(frames, squares):
            image = torch.as_tensor(frame, device=detector.device)
            scale, _, _ = detector.geometry(frame.shape[0], frame.shape[1])
            levels = detector.features(detector.transform(image))
            target = torch.as_tensor(square * scale, dtype=torch.float32,
                                     device=detector.device)[None]
            anchors = detector.anchors([tuple(level.shape[-2:]) for level in levels])
            overlaps = [ref.box_iou(a, target)[:, 0].reshape(-1, ratios) for a in anchors]
            best = max(float(o.max()) for o in overlaps)
            for level, overlap in zip(levels, overlaps):
                features = detector.rpn_features(level)[0]
                features = features.permute(1, 2, 0).reshape(-1, features.shape[0])
                on = (overlap > 0) & (overlap >= share * best)
                for a in range(ratios):
                    anchors_on[a].add(features, on[:, a])
    objectness = params["rpn_head"]["cls_logits"]
    for a, means in enumerate(anchors_on):
        objectness["kernel"][0, 0, :, a], objectness["bias"][a] = means.probe(
            fit["objectness_ceiling"])

    detector = ref.Detector(variables, device, settings)
    rois_on, found = _Means(), []
    with torch.no_grad(), ref.float32_products():
        for frame, square in zip(frames, squares):
            image = torch.as_tensor(frame, device=detector.device)
            scale, height, width = detector.geometry(frame.shape[0], frame.shape[1])
            levels = detector.features(detector.transform(image))
            rois = detector.proposals(levels, height, width)
            x = detector.box_features(detector.multiscale_roi_align(levels[:4], rois, height,
                                                                     width))
            deltas = detector.dense(x, "box_head/bbox_pred")[:, person]
            boxes = ref.clip(ref.decode(deltas, rois, ref.BOX_WEIGHTS), height, width)
            target = torch.as_tensor(square * scale, dtype=torch.float32, device=x.device)[None]
            on = _on_square(ref.box_iou(boxes, target)[:, 0], share)
            rois_on.add(x, on)
            logits = detector.dense(x, "box_head/cls_score").double()
            others = torch.cat([logits[:, :ref.PERSON], logits[:, ref.PERSON + 1:]], dim=1)
            valid = ref.large_enough(boxes)
            found.append((x[valid].double(), torch.logsumexp(others, dim=1)[valid], boxes[valid]))
        weights, _ = rois_on.probe(fit["person_ceiling"])
        params["box_head"]["cls_score"]["kernel"][:, ref.PERSON] = weights
        probe = torch.as_tensor(weights, dtype=torch.float64, device=detector.device)
        middles = []
        for x, lse, boxes in found:
            margins = x @ probe - lse
            ranked = margins[ref.nms(boxes, margins.float(), settings.box_nms_thresh)]
            middles.append(0.5 * float(ranked[rank - 1] + ranked[rank]))
    threshold = settings.person_threshold
    params["box_head"]["cls_score"]["bias"][ref.PERSON] = (
        math.log(threshold / (1.0 - threshold)) - statistics.median(middles))
    return variables, dict(fit_rois_on_square=rois_on.n_on / len(frames),
                           fit_anchors_on_square=sum(m.n_on for m in anchors_on) / len(frames))


def seeded_variables(config: dict, traffic: dict, seed: int, device
                     ) -> Tuple[dict, Dict[str, float]]:
    """(the seed's variables fitted to find the square, the fit's
    readings)."""
    from playablevideogeneration_tpu_torch.evaluation.metrics.frcnn import (
        random_frcnn_variables,
    )

    frames = sequence(config, traffic, seed, CALIBRATION_REQUEST)[0]
    return fit_player(random_frcnn_variables(seed), ref.Settings.from_config(config), frames,
                      device, traffic["calibration"])


def detector(config: dict, variables: dict, device,
             variant: ref.Variant = ref.REFERENCE) -> ref.Detector:
    return ref.Detector(variables, device, ref.Settings.from_config(config), variant)


def detections_of(detector: ref.Detector, config: dict, traffic: dict, seed: int,
                  requests: Sequence[int]) -> Dict[int, List[ref.Detections]]:
    """The detections of ``detector`` on each of ``requests``' frames."""
    return {i: detector.sequence(sequence(config, traffic, seed, i)[0]) for i in requests}


def stages_of(detector: ref.Detector, frame: np.ndarray, rois=None) -> ref.Stages:
    """``detector.stages`` of one (H, W, 3) frame, on the host, float64."""
    with torch.no_grad(), ref.float32_products():
        found = detector.stages(torch.as_tensor(frame, device=detector.device),
                                None if rois is None else rois.to(detector.device))
    return _on_host(found)


def port_stages(model, frame: np.ndarray) -> ref.Stages:
    """The port's detector module (the person-box backend's ``model``) on one
    (H, W, 3) frame, as the window ran it (TF32 as it stands): its FPN
    levels, its RoIs with a score, and its box head on them."""
    from playablevideogeneration_tpu_torch.evaluation.metrics.frcnn import (
        multiscale_roi_align,
    )

    device = next(model.parameters()).device
    with torch.no_grad():
        levels = model.features(torch.from_numpy(np.ascontiguousarray(frame[None])).to(device))
        _, height, width = model.geometry(frame.shape[0], frame.shape[1])
        rois, scores = model.proposals(levels, height, width)
        rois = rois[0][scores[0] > 0]
        logits, deltas = model.box_head(multiscale_roi_align([level[0] for level in levels[:4]],
                                                             rois))
    return _on_host(ref.Stages(levels=[level[0] for level in levels], rois=rois, logits=logits,
                               deltas=deltas.reshape(len(rois), -1, 4)[:, ref.PERSON]))


def _on_host(stages: ref.Stages) -> ref.Stages:
    return ref.Stages(levels=[level.double().cpu() for level in stages.levels],
                      rois=stages.rois.cpu(), logits=stages.logits.double().cpu(),
                      deltas=stages.deltas.double().cpu())


def served_as_program(config: dict, detections: Dict[int, List[ref.Detections]]
                      ) -> Dict[int, Served]:
    """What the program would have produced had it computed ``detections``:
    the boxes above the person threshold, and the player centres."""
    settings = ref.Settings.from_config(config)
    height, width = frame_size(config)
    return {i: ([d.above(settings.person_threshold) for d in frames],
                ref.player_centers(frames, width, height, settings))
            for i, frames in detections.items()}


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, 4) x (m, 4) boxes -> (n, m) IoU, float64."""
    a, b = np.asarray(a, np.float64).reshape(-1, 4), np.asarray(b, np.float64).reshape(-1, 4)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def _spread_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / (want - want.mean(dim=0)).norm())


def stage_gaps(got: ref.Stages, want: ref.Stages) -> Dict[str, float]:
    """``feature_gap`` and ``head_gap`` of the program's stages against the
    reference's, whose box head ran on the program's RoIs."""
    return dict(feature_gap=max(float((g - w).norm() / w.norm())
                                for g, w in zip(got.levels, want.levels)),
                head_gap=max(_spread_gap(got.logits, want.logits),
                             _spread_gap(got.deltas, want.deltas)))


def compared(config: dict, served: Dict[int, Served],
             detections: Dict[int, List[ref.Detections]], got: ref.Stages, want: ref.Stages
             ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(the compared numbers, readings beside them) of the program's
    ``served`` requests and stages ``got`` against the reference's
    ``detections`` and stages ``want``."""
    settings = ref.Settings.from_config(config)
    height, width = frame_size(config)
    gaps: List[float] = []
    missed = counted = frames = center_misses = overlapping = 0
    program_boxes = reference_boxes = 0
    for i, (boxes, centers) in served.items():
        want_frames = detections[i]
        want_centers = ref.player_centers(want_frames, width, height, settings)
        for found, d, center, want_center in zip(boxes, want_frames, centers, want_centers):
            found = np.asarray(found, np.float64).reshape(-1, 4)
            overlap = iou(d.boxes, found)
            matched = overlap >= MATCH_IOU
            for k in np.flatnonzero(d.scores > settings.person_threshold):
                if matched[k].any():
                    j = int(np.argmax(overlap[k]))
                    gaps.append(float(np.abs(d.boxes[k].astype(np.float64) - found[j]).max()))
            pairs = np.triu(iou(found, found), 1)
            overlapping += int((pairs > settings.box_nms_thresh + OVERLAP_MARGIN).any())
            near = overlap >= NEAR_IOU
            sure = d.scores >= SURE
            missed += int((~near[sure].any(axis=1)).sum())
            missed += int((~near[d.scores >= UNSURE].any(axis=0)).sum())
            counted += int(sure.sum()) + len(found)
            located, want_located = center[0] != -1, want_center[0] != -1
            far = (located and want_located
                   and float(np.hypot(*(center - want_center))) > CENTER_PX)
            center_misses += int(located != want_located or far)
            frames += 1
            program_boxes += len(found)
            reference_boxes += int((d.scores > settings.person_threshold).sum())
    numbers = dict(box_gap=statistics.median(gaps) if gaps else float("inf"),
                   overlap_share=overlapping / frames if frames else float("inf"),
                   missed_share=missed / counted if counted else float("inf"),
                   **stage_gaps(got, want))
    readings = dict(center_miss=center_misses / frames if frames else float("inf"),
                    box_gap_worst=max(gaps) if gaps else float("inf"),
                    matched_boxes=len(gaps), checked_frames=frames,
                    program_boxes_per_frame=program_boxes / frames if frames else 0.0,
                    reference_boxes_per_frame=reference_boxes / frames if frames else 0.0)
    return numbers, readings


def half_frames(backend: Callable) -> Callable:
    """A planted fault: the backend with the second half of each call's
    frames served no boxes."""
    def call(frames):
        boxes = backend(frames)
        return boxes[:len(boxes) // 2] + [[] for _ in boxes[len(boxes) // 2:]]
    return call


def previous_request(backend: Callable) -> Callable:
    """A planted fault: the backend serving each call the boxes of the
    frames of the call before it (a stale input)."""
    before = []

    def call(frames):
        frames = np.array(frames)
        boxes = backend(before[0] if before else frames)
        before[:] = [frames]
        return boxes
    return call


# Faults planted in what the window serves, the check left as it is.
SERVED_FAULTS = {"half_frames": half_frames, "previous_request": previous_request}


def variant_numbers(config: dict, traffic: dict, seed: int, device, what: str
                    ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """The compared numbers of ``VARIANTS[what]`` in the program's place,
    on the first ``check_requests`` requests."""
    variables, _ = seeded_variables(config, traffic, seed, device)
    requests = range(traffic["check_requests"])
    frame = sequence(config, traffic, seed, requests[0])[0][0]
    program = detector(config, variables, device, ref.VARIANTS[what])
    got = detections_of(program, config, traffic, seed, requests)
    got_stages = stages_of(program, frame)
    del program
    reference_ = detector(config, variables, device)
    want = detections_of(reference_, config, traffic, seed, requests)
    return compared(config, served_as_program(config, got), want, got_stages,
                    stages_of(reference_, frame, got_stages.rois))


def main(argv=None) -> int:
    import argparse

    from pvg_bench import drive, spec

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="tennis.detect")
    parser.add_argument("--what", choices=["program", *SERVED_FAULTS, *ref.VARIANTS],
                        required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    collected: Dict[str, list] = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = spec.cell(args.workload, seed, args.seconds, False, device)
        if args.what == "program" or args.what in SERVED_FAULTS:
            outcome = drive.load_driver(cell.traffic["driver"])(
                cell, fault=SERVED_FAULTS.get(args.what))
            numbers = dict({k: c["value"] for k, c in outcome.checks.items()}, **outcome.readings)
        else:
            compared_, readings = variant_numbers(cell.config, cell.traffic, seed, device,
                                                  args.what)
            numbers = dict(compared_, **readings)
        for k, v in numbers.items():
            collected.setdefault(k, []).append(v)
        print(json.dumps(dict(workload=args.workload, what=args.what, seed=seed, **numbers)),
              flush=True)
        drive.release(device)
    print(json.dumps(dict(workload=args.workload, what=args.what, seeds=args.seeds,
                          **{f"{k}_max": float(np.max(v)) for k, v in collected.items()},
                          **{f"{k}_min": float(np.min(v)) for k, v in collected.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
