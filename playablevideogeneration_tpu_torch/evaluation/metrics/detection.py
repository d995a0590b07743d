"""Object detectors and detection metrics for the action-space evaluation.

Counterpart of ``playablevideogeneration_tpu/evaluation/metrics/detection.py``,
host-side numpy and scipy:

- ``breakout_platform_positions``: the Breakout platform's x position by a
  colour-band scan;
- ``TennisPlayerDetector``: box proposals from a pluggable backend, then
  the tennis court filter and the tallest box's centre;
  ``motion_blob_boxes`` is the weight-free backend (foreground blobs
  against the sequence's median background);
- ``detection_metric``: per-position successful and missed detections and
  the average centre distance.

The Faster R-CNN backend (``evaluation.detector: frcnn``) is not ported
yet (ROADMAP.md, Queue 1 item 9): asking for it raises instead of
degrading.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def breakout_platform_positions(observations: np.ndarray) -> np.ndarray:
    """Detects the Breakout platform x-position in each frame.

    The platform lives in a fixed bottom band of the frame and has a
    distinctive red-ish color (reference breakout_platform_position.py:42-110).

    :param observations: (B, T, H, W, C) float images in [0, 1]
    :return: (B, T, 1) x positions in pixels, -1 where not detected
    """
    b, t, h, w, c = observations.shape
    # The platform band: bottom ~8% of the frame, excluding the very border.
    band = observations[:, :, int(h * 0.89): int(h * 0.97)]
    # Red-dominant pixels (platform color in the breakout dataset).
    red = (band[..., 0] > 0.55) & (band[..., 1] < 0.45) & (band[..., 2] < 0.45)
    mask = red.any(axis=2)  # (B, T, W): column contains platform color
    xs = np.arange(w, dtype=np.float64)
    counts = mask.sum(axis=-1)
    sums = (mask * xs).sum(axis=-1)
    positions = np.where(counts > 0, sums / np.maximum(counts, 1), -1.0)
    return positions[..., None]


def detection_metric(reference_detections: np.ndarray,
                     generated_detections: np.ndarray,
                     prefix: str) -> Dict[str, float]:
    """ADD/MDR-style detection statistics.

    Works for 1-D and 2-D detections: counts positions where both
    sequences have successful detections, average center distance among
    them, and missed-detection rates per position and globally
    (reference detection_metric_2d.py:10, detection_metric_1d.py:10).

    :param reference_detections: (N, T, D) with -1 marking failures
    :param generated_detections: (N, T, D)
    """
    ref = np.asarray(reference_detections, np.float64)
    gen = np.asarray(generated_detections, np.float64)
    n, t, d = ref.shape
    ref_ok = (ref[..., 0] != -1)
    gen_ok = (gen[..., 0] != -1)
    both = ref_ok & gen_ok

    distances = np.linalg.norm(ref - gen, axis=-1)  # (N, T)

    results: Dict[str, float] = {}
    positional_add = []
    positional_mdr = []
    for i in range(t):
        ok = both[:, i]
        denom = ref_ok[:, i].sum()
        add = float(distances[ok, i].mean()) if ok.sum() else -1.0
        mdr = float(1.0 - (ok.sum() / denom)) if denom else -1.0
        results[f"{prefix}/add/{i}"] = add
        results[f"{prefix}/mdr/{i}"] = mdr
        if add >= 0:
            positional_add.append(add)
        if mdr >= 0:
            positional_mdr.append(mdr)

    results[f"{prefix}/add/avg"] = (
        float(np.mean(positional_add)) if positional_add else -1.0)
    results[f"{prefix}/mdr/avg"] = (
        float(np.mean(positional_mdr)) if positional_mdr else -1.0)
    results[f"{prefix}/detection_rate/reference"] = float(ref_ok.mean())
    results[f"{prefix}/detection_rate/generated"] = float(gen_ok.mean())
    return results


# Court-region box filters, expressed as fractions of (W, H) so they work
# at any resolution.  Derived from the reference's hard-coded pixel rules
# for its 256x96 tennis frames (tennis_player_detector.py:34-47): exclude
# the upper-left scoreboard (x2 <= 60, y1 <= 26), the upper-right overlay
# (x1 >= 200, y1 <= 26), and spectator heads low in the frame (y1 > 80).
DEFAULT_COURT_FILTER = {
    "upper_left": (60 / 256, 26 / 96),
    "upper_right": (200 / 256, 26 / 96),
    "max_top": 80 / 96,
}


def court_box_filter(box, width: int, height: int,
                     rules: Dict = DEFAULT_COURT_FILTER) -> bool:
    """Reference check_box_boundaries semantics on an (x1, y1, x2, y2) box."""
    x1, y1, x2, _ = box
    ulx, uly = rules["upper_left"]
    if x2 <= ulx * width and y1 <= uly * height:
        return False
    urx, ury = rules["upper_right"]
    if x1 >= urx * width and y1 <= ury * height:
        return False
    if y1 > rules["max_top"] * height:
        return False
    return True


def select_player_center(boxes, width: int, height: int,
                         rules: Dict = DEFAULT_COURT_FILTER):
    """Applies the court filter and returns the center of the TALLEST
    surviving box, or (-1, -1) (reference tennis_player_detector.py:85-107)."""
    matches = [(b[3] - b[1], b) for b in boxes
               if court_box_filter(b, width, height, rules)]
    if not matches:
        return (-1.0, -1.0)
    matches.sort(key=lambda m: m[0])
    box = matches[-1][1]
    return ((box[0] + box[2]) / 2.0, (box[1] + box[3]) / 2.0)


def motion_blob_boxes(frames: np.ndarray, threshold: float = 0.15,
                      min_area: int = 12) -> list:
    """Weight-free person-box proposals from motion saliency.

    Tennis footage has a static camera and a moving player; foreground
    blobs against the per-sequence median background are box proposals.
    This replaces the reference's pretrained Faster R-CNN proposals
    (tennis_player_detector.py:14-16) in environments without downloadable
    weights; a converted detector can be plugged in via `backend` for
    higher fidelity.

    :param frames: (T, H, W, C) in [0, 1]
    :return: list over T of lists of (x1, y1, x2, y2) boxes
    """
    from scipy import ndimage

    background = np.median(frames, axis=0)
    saliency = np.abs(frames - background).sum(axis=-1)  # (T, H, W)
    all_boxes = []
    for t in range(frames.shape[0]):
        mask = saliency[t] > threshold
        labels, count = ndimage.label(mask)
        boxes = []
        for slice_y, slice_x in ndimage.find_objects(labels):
            area = (slice_y.stop - slice_y.start) * (slice_x.stop - slice_x.start)
            if area >= min_area:
                boxes.append((float(slice_x.start), float(slice_y.start),
                              float(slice_x.stop), float(slice_y.stop)))
        all_boxes.append(boxes)
    return all_boxes


class TennisPlayerDetector:
    """Pluggable tennis player detector.

    The reference is a torchvision Faster R-CNN ResNet50-FPN 'person'
    detector whose boxes pass a court-region filter and a tallest-box
    selection (tennis_player_detector.py:14-108).  Here the box-proposal
    stage is pluggable while the filter/selection logic is shared:

    - ``backend='blob'`` (or ``motion_blob_boxes``): weight-free motion
      saliency proposals — works out of the box on static-camera footage;
    - ``backend=<callable>``: any (T, H, W, C) -> [[boxes]] proposer (e.g.
      a converted neural detector);
    - ``backend=None``: detection unavailable; every frame reports (-1, -1)
      and metrics carry a 'detector_unavailable' marker.
    """

    def __init__(self, backend=None, rules: Dict = DEFAULT_COURT_FILTER):
        if backend == "blob":
            backend = motion_blob_boxes
        self.backend = backend
        self.rules = rules

    @property
    def available(self) -> bool:
        return self.backend is not None

    def __call__(self, observations: np.ndarray) -> np.ndarray:
        b, t, h, w = observations.shape[:4]
        if self.backend is None:
            return np.full((b, t, 2), -1.0)
        centers = np.full((b, t, 2), -1.0)
        for seq in range(b):
            proposals = self.backend(observations[seq])
            for obs in range(t):
                centers[seq, obs] = select_player_center(
                    proposals[obs], w, h, self.rules)
        return centers


def make_detector(config) -> TennisPlayerDetector:
    """Config-selectable detector backend.

    ``evaluation.detector: none | blob | <module>:<callable>``; ``frcnn``
    raises NotImplementedError.
    """
    spec = (config.get("evaluation", {}) or {}).get("detector", "none")
    if spec in (None, "none"):
        return TennisPlayerDetector()
    if spec == "blob":
        return TennisPlayerDetector(backend="blob")
    if spec == "frcnn":
        raise NotImplementedError(
            "evaluation.detector 'frcnn' (the Faster R-CNN backend, "
            "evaluation/metrics/frcnn.py) is not ported to PyTorch yet: ROADMAP.md, "
            "Queue 1 item 9; use 'blob' or a '<module>:<callable>' proposer")
    module_name, _, attr = str(spec).partition(":")
    import importlib

    return TennisPlayerDetector(backend=getattr(
        importlib.import_module(module_name), attr))
