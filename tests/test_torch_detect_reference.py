"""The port's Faster R-CNN detector against the benchmark's plain float32
reference (``pvg_bench/reference/frcnn.py``, torchvision's inference in
plain torch) on the CPU: seeded random variables with the person bias
raised, 2 frames of 64 x 96 at a transform of 64/128; one case per
departure of the port from torchvision that the reference follows; the
benchmark's fit of the heads to the moving square reaching its target
through the port.

Tolerances: boxes 1e-2 px and scores 1e-4 (both sides float32; they differ
in the order of their sums, the port's antialiased resize kernel, gathered
RoIAlign and batched box head against the reference's, which reads about
1e-3 px and 3e-5), the player centres 1e-2 px (a box's).  Boxes are
matched by their coordinates, not by rank: rounding can swap two boxes
of equal score.
"""
import numpy as np
import pytest
import torch
from torch_parity import single_threaded_torch  # noqa: F401 (an autouse fixture)

from playablevideogeneration_tpu_torch.evaluation.metrics import frcnn
from playablevideogeneration_tpu_torch.evaluation.metrics.detection import (
    DEFAULT_COURT_FILTER,
    TennisPlayerDetector,
)
from pvg_bench import detect_cell, spec
from pvg_bench.reference import frcnn as ref

HEIGHT, WIDTH, MIN_SIZE, MAX_SIZE = 64, 96, 64, 128
SEED = 3
PERSON_SHIFT = 8.0  # random weights score the person class near 1/91
BOX_ATOL, SCORE_ATOL, CENTER_ATOL = 1e-2, 1e-4, 1e-2
SETTINGS = ref.Settings(min_size=MIN_SIZE, max_size=MAX_SIZE)


def _frames(seed: int, count: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (count, HEIGHT, WIDTH, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def calibrated():
    """(variables with the person bias raised, the shift, the frames)."""
    variables = frcnn.random_frcnn_variables(SEED)
    variables["params"]["box_head"]["cls_score"]["bias"][ref.PERSON] += PERSON_SHIFT
    return variables, PERSON_SHIFT, _frames(SEED)


@pytest.fixture(scope="module")
def both(calibrated):
    """The port's (boxes, scores, labels) and the reference's detections."""
    variables, _, frames = calibrated
    port = frcnn.make_frcnn(variables, MIN_SIZE, MAX_SIZE, device="cpu")
    boxes, scores, labels = (t.numpy() for t in port(torch.from_numpy(frames)))
    return (boxes, scores, labels), ref.Detector(variables, "cpu", SETTINGS).sequence(frames)


def _matched(boxes: np.ndarray, scores: np.ndarray, want: ref.Detections):
    """For each of the reference's detections, the port's detection nearest
    it: (largest coordinate difference, score difference)."""
    gaps = np.abs(want.boxes[:, None, :] - boxes[None, :, :]).max(axis=-1)
    nearest = gaps.argmin(axis=1)
    return gaps[np.arange(len(nearest)), nearest], np.abs(want.scores - scores[nearest])


def test_detections_match_the_reference(both):
    (boxes, scores, labels), want = both
    for t, w in enumerate(want):
        found = scores[t] > 0
        assert found.sum() == len(w.scores) > 0
        assert (labels[t][found] == frcnn.PERSON_LABEL).all()
        assert (labels[t][~found] == -1).all()
        box_gap, score_gap = _matched(boxes[t][found], scores[t][found], w)
        assert box_gap.max() <= BOX_ATOL
        assert score_gap.max() <= SCORE_ATOL
        # the thresholds and the court filter see boxes above 0.8
        assert (w.scores > SETTINGS.person_threshold).sum() >= 4


def test_player_centres_match_the_reference(calibrated, both):
    variables, _, frames = calibrated
    _, want = both
    detector = TennisPlayerDetector(backend=frcnn.make_person_box_backend(
        variables, min_size=MIN_SIZE, max_size=MAX_SIZE, device="cpu"))
    centres = detector(frames[None])[0]
    expected = ref.player_centers(want, WIDTH, HEIGHT, SETTINGS)
    assert (expected[:, 0] != -1).all()
    np.testing.assert_allclose(centres, expected, atol=CENTER_ATOL, rtol=0)


def test_calibration_reaches_its_target_through_the_port():
    """The benchmark's fit (``detect_cell.fit_player``) on 3 moving-square
    frames: through the port, the median frame holds ``boxes`` boxes above
    the person threshold, each on the square."""
    traffic = spec.traffic("detect_eval")
    config = {"evaluation": {"batching": {"observations_count": 3}},
              "data": {"target_input_size": [WIDTH, HEIGHT]}}
    frames = detect_cell.sequence(config, traffic, SEED, 0)[0]
    variables, readings = detect_cell.fit_player(frcnn.random_frcnn_variables(SEED), SETTINGS,
                                                 frames, "cpu", traffic["calibration"])
    assert readings["fit_rois_on_square"] > 0 and readings["fit_anchors_on_square"] > 0
    port = frcnn.make_frcnn(variables, MIN_SIZE, MAX_SIZE, device="cpu")
    boxes, scores, _ = (t.numpy() for t in port(torch.from_numpy(frames)))
    above = scores > SETTINGS.person_threshold
    assert np.median(above.sum(axis=1)) == traffic["calibration"]["boxes"]
    for frame, found, kept in zip(frames, boxes, above):
        square = detect_cell.square_box(frame)
        assert (detect_cell.iou(found[kept], square[None])[:, 0] > 0).all()


def test_the_courts_rules_are_the_ports():
    assert {k: tuple(v) if isinstance(v, list) else v for k, v in ref.COURT_FILTER.items()} == (
        DEFAULT_COURT_FILTER)


def test_variable_shapes_are_the_ports_layout():
    variables = frcnn.random_frcnn_variables(1)
    flat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            walk(f"{prefix}/{k}" if prefix else k, v) if isinstance(v, dict) else (
                flat.__setitem__(f"{prefix}/{k}", v.shape))
    walk("", variables["params"])
    assert flat == ref.variable_shapes()


# --------------------------------------------------------------------------
# One case per departure of the port from torchvision that the reference
# follows (its docstring's list).


def _departure_resized_size_rounds():
    # 96 x 256 at 800/1333: torchvision floors 499.875 to 499.
    scale, height, width = ref.Detector(ref.empty_variables(), "meta").geometry(96, 256)
    assert (scale, height, width) == frcnn.FasterRCNN().geometry(96, 256)
    assert (height, width) == (500, 1333) and int(np.floor(96 * scale)) == 499


def _departure_one_scale_back_to_the_input(calibrated):
    # At 30 x 50 the transform gives 64 x 107: one scale of 64 / 30, where
    # torchvision's ratios are 30 / 64 and 50 / 107.
    variables, _, _ = calibrated
    frames = _frames(SEED + 1, count=1)[:, :30, :50]
    port = frcnn.make_frcnn(variables, MIN_SIZE, MAX_SIZE, device="cpu")
    boxes, scores, _ = (t.numpy() for t in port(torch.from_numpy(np.ascontiguousarray(frames))))
    want = ref.Detector(variables, "cpu", SETTINGS).sequence(frames)[0]
    found = scores[0] > 0
    box_gap, _ = _matched(boxes[0][found], scores[0][found], want)
    assert box_gap.max() <= BOX_ATOL
    scale, height, width = ref.Detector(ref.empty_variables(), "meta", SETTINGS).geometry(30, 50)
    assert (height, width) == (64, 107)
    # torchvision's x coordinates would lie this far from the port's
    assert np.abs(want.boxes[:, 2] * scale * (50 / 107 - 1 / scale)).max() > BOX_ATOL


def _departure_stable_ties():
    scores = torch.tensor([0.5, 0.7, 0.7, 0.1, 0.7])
    _, port = frcnn.top_k(scores, 5)
    assert ref.stable_order(scores).tolist() == port.tolist() == [1, 2, 4, 0, 3]


def _departure_small_boxes():
    # torchvision's RPN keeps a side of at least 1e-3; the port and the
    # reference drop one of 1e-2 or less, in both stages.
    boxes = torch.tensor([[0.0, 0.0, 5e-3, 4.0], [0.0, 0.0, 2e-2, 4.0]])
    assert ref.large_enough(boxes).tolist() == [False, True]
    assert ref.SMALL_BOX == 1e-2


def _departure_person_only(calibrated):
    # Another class scoring as high as the person fills about half of
    # torchvision's 100 detections; the port's and the reference's are
    # the person boxes all the same.
    variables, _, frames = calibrated
    bias = variables["params"]["box_head"]["cls_score"]["bias"]
    saved = bias.copy()
    bias[2] = bias[ref.PERSON]
    try:
        port = frcnn.make_frcnn(variables, MIN_SIZE, MAX_SIZE, device="cpu")
        boxes, scores, _ = (t.numpy() for t in port(torch.from_numpy(frames[:1])))
        want = ref.Detector(variables, "cpu", SETTINGS).sequence(frames[:1])[0]
    finally:
        bias[:] = saved
    found = scores[0] > 0
    assert found.sum() == len(want.scores) > 0
    box_gap, score_gap = _matched(boxes[0][found], scores[0][found], want)
    assert box_gap.max() <= BOX_ATOL and score_gap.max() <= SCORE_ATOL


def _departure_nominal_strides():
    # At 64 x 96, P5 is 2 x 3 and P6 1 x 2: torchvision spaces P6's
    # anchors by 96 // 2 = 48 across, the port by 64.
    shapes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    port = frcnn.make_anchors(shapes, frcnn.STRIDES)
    mine = ref.anchors(shapes)
    for a, b in zip(port, mine):
        np.testing.assert_array_equal(a, b.numpy())
    assert port[-1][3, 0] - port[-1][0, 0] == 64


def _departure_edge_samples():
    # A box at the bottom edge of an unpadded map, under one bin high:
    # torchvision's samples below the map read zero, the port's the edge.
    feature = torch.arange(2 * 4 * 6, dtype=torch.float32).reshape(1, 2, 4, 6) + 1.0
    boxes = torch.tensor([[4.0, 15.9, 20.0, 16.0]])
    mine = ref.roi_align(feature, boxes, 0.25)
    port = frcnn.roi_align(feature[0], boxes, 0.25)
    torch.testing.assert_close(mine, port, atol=1e-5, rtol=1e-6)
    assert (mine[0, :, -1] > 0).all()


DEPARTURES = {"resized_size_rounds": _departure_resized_size_rounds,
              "one_scale_back_to_the_input": _departure_one_scale_back_to_the_input,
              "stable_ties": _departure_stable_ties, "small_boxes": _departure_small_boxes,
              "person_only": _departure_person_only,
              "nominal_strides": _departure_nominal_strides,
              "edge_samples": _departure_edge_samples}


@pytest.mark.parametrize("name", sorted(DEPARTURES))
def test_departure_followed_as_the_port(name, request):
    case = DEPARTURES[name]
    needs = case.__code__.co_varnames[:case.__code__.co_argcount]
    case(*(request.getfixturevalue(fixture) for fixture in needs))
