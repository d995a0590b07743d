"""The port's Faster R-CNN detector against the JAX package's on the CPU:
every block on the same converted weights (the JAX layout, bridged into
the port by ``utils.jax_weights``), the box math, the end-to-end detector
at a reduced transform (64/128) on the JAX package's
``random_frcnn_variables``, its constant-score rig, the converters, and
``make_detector`` resolving ``evaluation.detector: frcnn``.

Tolerances: blocks and features atol 1e-4, rtol 1e-3 (the JAX suite's
against torch clones, ``tests/test_frcnn.py``); box math 1e-5; anchors,
level assignment, NMS keep-masks, the rig's proposals and its exact
variant bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nchw, nhwc, random_variables, single_threaded_torch  # noqa: F401

from playablevideogeneration_tpu.evaluation.metrics import detection as jax_detection
from playablevideogeneration_tpu.evaluation.metrics import frcnn as jax_frcnn
from playablevideogeneration_tpu_torch.evaluation.metrics import detection
from playablevideogeneration_tpu_torch.evaluation.metrics import frcnn
from playablevideogeneration_tpu_torch.utils import pretrained
from playablevideogeneration_tpu_torch.utils.jax_weights import load_jax_variables

ATOL, RTOL = 1e-4, 1e-3
HEIGHT, WIDTH, MIN_SIZE, MAX_SIZE = 64, 96, 64, 128


def _tree(module, *inputs, seed):
    """Seeded random variables (BatchNorm statistics away from (0, 1)) of
    a JAX module, as numpy."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs))
    return {c: random_variables(t, seed) for c, t in shapes.items()}


def _port(module, variables):
    return load_jax_variables(module, variables).eval()


@pytest.fixture(scope="module")
def jax_detector():
    """The JAX detector at 64/128, compiled once: (variables, frames) ->
    ((boxes, scores, labels), intermediates) per frame; and the JAX
    package's random variables at 64x96."""
    init = jax.jit(lambda key: jax_frcnn.random_frcnn_variables(key, HEIGHT, WIDTH,
                                                                MIN_SIZE, MAX_SIZE))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    model = jax_frcnn.FasterRCNN(min_size=MIN_SIZE, max_size=MAX_SIZE)
    detect = jax.jit(jax.vmap(lambda v, img: model.apply(v, img, mutable=["intermediates"]),
                              in_axes=(None, 0)))

    def run(variables, frames):
        (boxes, scores, labels), state = detect(variables, frames)
        taps = {k: np.asarray(v[0]) for k, v in state["intermediates"].items()}
        return tuple(np.asarray(x) for x in (boxes, scores, labels)), taps

    return variables, run


def _port_detector(variables):
    return frcnn.make_frcnn(variables, MIN_SIZE, MAX_SIZE, device="cpu")


def _frames(seed, count=2):
    return np.random.default_rng(seed).uniform(0, 1, (count, HEIGHT, WIDTH, 3)).astype(
        np.float32)


# --------------------------------------------------------------------- #
# Blocks                                                                #
# --------------------------------------------------------------------- #


def test_frozen_bn_matches_jax():
    x = np.random.default_rng(31).normal(size=(2, 5, 5, 6)).astype(np.float32)
    variables = _tree(jax_frcnn.FrozenBN(6), jnp.asarray(x), seed=31)
    want = jax_frcnn.FrozenBN(6).apply(variables, jnp.asarray(x))
    got = _port(frcnn.FrozenBN(6), variables)(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("stride,project", [(1, False), (2, True)])
def test_bottleneck_matches_jax(stride, project):
    """A stride-1 block, and a stride-2 block whose projection changes the
    channels (32 -> 64)."""
    in_ch = 32 if project else 64
    x = (np.random.default_rng(32).normal(size=(1, 11, 10, in_ch)) * 0.5).astype(np.float32)
    module = jax_frcnn.Bottleneck(16, stride=stride, project=project)
    variables = _tree(module, jnp.asarray(x), seed=32)
    with jax.default_matmul_precision("highest"):
        want = module.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = _port(frcnn.Bottleneck(in_ch, 16, stride, project), variables)(nchw(x))
    assert got.shape == (1, 64, *want.shape[1:3])
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("sizes", [[16, 8, 4, 2], [13, 7, 4, 2], [9, 5, 3, 1]])
def test_fpn_matches_jax(sizes):
    """Laterals, the nearest top-down merge (half-pixel centres: exact x2
    and uneven sizes), output convolutions and P6."""
    rng = np.random.default_rng(33)
    chans = [8, 16, 24, 32]
    feats = [rng.normal(size=(1, s, s + 3, c)).astype(np.float32)
             for s, c in zip(sizes, chans)]
    module = jax_frcnn.FPN(channels=16)
    variables = _tree(module, [jnp.asarray(f) for f in feats], seed=33)
    with jax.default_matmul_precision("highest"):
        want = module.apply(variables, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = _port(frcnn.FPN(chans, 16), variables)([nchw(f) for f in feats])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_nearest_resize_matches_jax():
    x = np.random.default_rng(34).normal(size=(1, 5, 7, 2)).astype(np.float32)
    for size in [(10, 14), (9, 13), (7, 11), (3, 4), (5, 7)]:
        want = jax.image.resize(jnp.asarray(x), (1, *size, 2), "nearest")
        got = frcnn.resize_nearest(nchw(x), *size)
        np.testing.assert_array_equal(nhwc(got), np.asarray(want))


def test_rpn_and_box_heads_match_jax():
    rng = np.random.default_rng(35)
    x = rng.normal(size=(1, 8, 9, 16)).astype(np.float32)
    rpn = jax_frcnn.RPNHead()
    variables = _tree(rpn, jnp.asarray(x), seed=35)
    with jax.default_matmul_precision("highest"):
        want = rpn.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = _port(frcnn.RPNHead(16), variables)(nchw(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=ATOL, rtol=RTOL)

    # The RoI features flatten in (h, w, c) order in both: a port that
    # flattened NCHW as (c, h, w) would load fc6 and compute otherwise.
    roi = rng.normal(size=(5, 7, 7, 16)).astype(np.float32)
    head = jax_frcnn.BoxHead(representation_size=32)
    variables = _tree(head, jnp.asarray(roi), seed=36)
    with jax.default_matmul_precision("highest"):
        want = head.apply(variables, jnp.asarray(roi))
    with torch.no_grad():
        got = _port(frcnn.BoxHead(16, 32), variables)(nchw(roi))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


# --------------------------------------------------------------------- #
# Box math                                                              #
# --------------------------------------------------------------------- #


def _boxes(rng, n, low=0.0, high=100.0):
    centers = rng.uniform(low + 10, high - 10, (n, 2))
    sizes = rng.uniform(2, 40, (n, 2))
    return np.concatenate([centers - sizes / 2, centers + sizes / 2], 1).astype(np.float32)


def test_anchors_match_jax():
    shapes, strides = [(3, 5), (2, 3), (1, 2), (1, 1), (1, 1)], list(frcnn.STRIDES)
    for got, want in zip(frcnn.make_anchors(shapes, strides),
                         jax_frcnn.make_anchors(shapes, strides)):
        np.testing.assert_array_equal(got, want)


def test_decode_clip_and_iou_match_jax():
    rng = np.random.default_rng(37)
    anchors = _boxes(rng, 50)
    deltas = rng.normal(0, 1, (50, 4)).astype(np.float32)
    deltas[0, 2:] = 10.0  # past the dw/dh clamp
    for weights in [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)]:
        want = jax_frcnn.clip_boxes(jax_frcnn.decode_boxes(
            jnp.asarray(deltas), jnp.asarray(anchors), weights), 60.0, 70.0)
        got = frcnn.clip_boxes(frcnn.decode_boxes(
            torch.from_numpy(deltas), torch.from_numpy(anchors), weights), 60.0, 70.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    b = _boxes(rng, 30)
    np.testing.assert_allclose(
        frcnn.box_iou(torch.from_numpy(anchors), torch.from_numpy(b)).numpy(),
        np.asarray(jax_frcnn.box_iou(jnp.asarray(anchors), jnp.asarray(b))), atol=1e-6)


@pytest.mark.parametrize("case", ["distinct", "ties_and_zeros", "constant"])
def test_nms_mask_matches_jax(case):
    """Keep-masks bit for bit, equal scores visited lower index first."""
    rng = np.random.default_rng(38)
    n = 300
    boxes = _boxes(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if case == "ties_and_zeros":
        scores = np.round(scores * 4) / 4  # 0, 0.25, ... 1.0: ties everywhere
        boxes[::7] = boxes[1::7][:len(boxes[::7])]  # duplicate boxes
    elif case == "constant":
        scores[:] = 0.5
    for threshold in (0.5, 0.7):
        want = np.asarray(jax_frcnn.nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                             threshold))
        got = frcnn.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), threshold)
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < n


def test_batched_nms_masks_equal_single_sets():
    rng = np.random.default_rng(39)
    boxes = np.stack([_boxes(rng, 64) for _ in range(6)]).reshape(2, 3, 64, 4)
    scores = rng.uniform(0, 1, (2, 3, 64)).astype(np.float32)
    keep, = frcnn.nms_masks([(torch.from_numpy(boxes), torch.from_numpy(scores))], 0.5)
    for i in range(2):
        for j in range(3):
            want = jax_frcnn.nms_mask(jnp.asarray(boxes[i, j]), jnp.asarray(scores[i, j]), 0.5)
            np.testing.assert_array_equal(keep[i, j].numpy(), np.asarray(want))


def test_roi_align_matches_jax():
    rng = np.random.default_rng(40)
    feature = rng.normal(size=(12, 14, 3)).astype(np.float32)
    boxes = np.concatenate([np.asarray([[2.0, 3.0, 11.0, 9.0], [0.0, 0.0, 28.0, 24.0],
                                        [5.0, 5.0, 5.2, 5.1]], np.float32),
                            _boxes(rng, 5, 0.0, 28.0)])
    for scale in (0.5, 0.25):
        want = jax_frcnn.roi_align(jnp.asarray(feature), jnp.asarray(boxes), scale)
        got = frcnn.roi_align(torch.from_numpy(feature.transpose(2, 0, 1).copy()),
                              torch.from_numpy(boxes), scale)
        np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_fpn_level_assignment_and_multiscale_roi_align_match_jax():
    rng = np.random.default_rng(41)
    boxes = np.concatenate([np.asarray([[0, 0, 224, 224], [0, 0, 16, 16],
                                        [0, 0, 1000, 1000], [0, 0, 0, 0], [10, 10, 170, 150]],
                                       np.float32),
                            _boxes(rng, 40, 0.0, 120.0),
                            _boxes(rng, 20, 0.0, 120.0) * 3.0])
    want = np.asarray(jax_frcnn.fpn_level_assignment(jnp.asarray(boxes)))
    got = frcnn.fpn_level_assignment(torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(want.tolist()) == {0, 1, 2, 3}

    # The JAX detector's selection: every level, a one-hot sum.
    levels = [rng.normal(size=(96 // s, 128 // s, 4)).astype(np.float32) for s in (4, 8, 16, 32)]
    pooled = jnp.stack([jax_frcnn.roi_align(jnp.asarray(f), jnp.asarray(boxes), 1.0 / s)
                        for f, s in zip(levels, (4, 8, 16, 32))])
    selected = jnp.einsum("lkhwc,lk->khwc", pooled,
                          jax.nn.one_hot(jnp.asarray(want), 4, axis=0, dtype=pooled.dtype))
    got = frcnn.multiscale_roi_align(
        [torch.from_numpy(f.transpose(2, 0, 1).copy()) for f in levels], torch.from_numpy(boxes))
    np.testing.assert_allclose(nhwc(got), np.asarray(selected), atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------- #
# End to end                                                            #
# --------------------------------------------------------------------- #


def test_random_variables_have_the_converted_layout(jax_detector):
    """The port's seeded tree: the JAX package's paths and shapes, the
    frozen statistics under params, and the port detector loads it."""
    variables, _ = jax_detector
    ours = frcnn.random_frcnn_variables(7)
    shapes = jax.tree_util.tree_map(np.shape, variables)
    assert jax.tree_util.tree_map(np.shape, ours) == shapes
    assert set(ours["params"]["body"]["bn1"]) == {"scale", "bias", "mean", "var"}
    assert _port_detector(ours) is not None


def test_detector_matches_jax_end_to_end(jax_detector):
    """2 frames of 64x96 at 64/128 on the JAX package's random variables:
    FPN features, proposals' validity, the masked person scores and the
    final detections."""
    variables, run = jax_detector
    frames = _frames(42)
    (want_boxes, want_scores, want_labels), want_taps = run(variables, frames)
    model = _port_detector(variables)
    images = torch.from_numpy(frames)
    with torch.no_grad():
        levels = model.features(images)
        body = jax_frcnn.ResNet50()
        feats = body.apply({"params": variables["params"]["body"]},
                           jax.vmap(lambda f: jax.image.resize(
                               (f - jnp.asarray(jax_frcnn.IMAGENET_MEAN))
                               / jnp.asarray(jax_frcnn.IMAGENET_STD), f.shape, "linear"))(
                               jnp.asarray(frames)))
        want_levels = jax_frcnn.FPN().apply({"params": variables["params"]["fpn"]}, feats)
    for got, want in zip(levels, want_levels):
        np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL)

    taps = {}
    boxes, scores, labels = model(images, taps)
    assert boxes.shape == (2, frcnn.DETECTIONS_PER_IMG, 4)
    assert scores.shape == labels.shape == (2, frcnn.DETECTIONS_PER_IMG)
    np.testing.assert_array_equal(taps["roi_valid"].numpy(), want_taps["roi_valid"])
    np.testing.assert_allclose(taps["masked_class_scores"].numpy(),
                               want_taps["masked_class_scores"], atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    np.testing.assert_allclose(scores.numpy(), want_scores, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(boxes.numpy(), want_boxes, atol=1e-3, rtol=1e-4)
    assert (want_scores > 0).any() and (want_scores <= 0).any()
    assert np.all(labels.numpy()[scores.numpy() <= 0] == -1)


def _rigged(variables, exact: bool):
    """The JAX suite's rig (test_invalid_rois_cannot_emit_detections):
    zeroed RPN weights, so the proposals are the anchors at one constant
    score with dense overlaps, and a box head biased to score 'person'
    near 1.  ``exact`` also zeroes the box head's output kernels and sets
    the other classes' biases to -100, so that every valid RoI keeps its
    proposal's box and scores exactly 1 (exp(-100) vanishes beside 1 in
    f32): ties everywhere, and nothing left to the frameworks' different
    exp and softmax roundings."""
    variables = jax.tree.map(np.array, variables)
    p = variables["params"]
    rpn = p["rpn_head"]
    rpn["cls_logits"]["kernel"][:] = 0.0
    rpn["cls_logits"]["bias"][:] = 2.0
    rpn["bbox_pred"]["kernel"][:] = 0.0
    rpn["bbox_pred"]["bias"][:] = 0.0
    bias = p["box_head"]["cls_score"]["bias"]
    bias[:] = -10.0
    bias[jax_frcnn.PERSON_LABEL] = 10.0
    if exact:
        bias[:] = -100.0
        bias[jax_frcnn.PERSON_LABEL] = 0.0
        p["box_head"]["cls_score"]["kernel"][:] = 0.0
        p["box_head"]["bbox_pred"]["kernel"][:] = 0.0
        p["box_head"]["bbox_pred"]["bias"][:] = 0.0
    return variables


@pytest.mark.parametrize("exact", [False, True], ids=["jax_rig", "exact_rig"])
def test_invalid_rois_cannot_emit_detections(jax_detector, exact):
    """Padding RoIs (zero-score proposals after NMS) must not emit
    detections; the proposals, their validity and, with nothing left to
    floating point, the boxes, scores and labels equal the JAX package's
    bit for bit, ties included."""
    variables, run = jax_detector
    variables = _rigged(variables, exact)
    frames = _frames(43)
    (want_boxes, want_scores, want_labels), want_taps = run(variables, frames)
    taps = {}
    boxes, scores, labels = _port_detector(variables)(torch.from_numpy(frames), taps)
    roi_valid = taps["roi_valid"].numpy()
    person = taps["masked_class_scores"].numpy()
    np.testing.assert_array_equal(roi_valid, want_taps["roi_valid"])
    assert (~roi_valid).sum() > 0 and roi_valid.sum() > 0
    assert (person[roi_valid] > 0.9).all()
    assert np.all(person[~roi_valid] == 0.0) and np.all(
        want_taps["masked_class_scores"][~roi_valid] == 0.0)
    if exact:
        np.testing.assert_array_equal(person, want_taps["masked_class_scores"])
        np.testing.assert_array_equal(boxes.numpy(), want_boxes)
        np.testing.assert_array_equal(scores.numpy(), want_scores)
        np.testing.assert_array_equal(labels.numpy(), want_labels)
        assert (want_labels == frcnn.PERSON_LABEL).sum() > 1


# --------------------------------------------------------------------- #
# Converters and wiring                                                 #
# --------------------------------------------------------------------- #


def _torchvision_state_dict(rng):
    """A state_dict with torchvision's fasterrcnn_resnet50_fpn key names
    (both FPN key styles), at small widths."""
    state = {"backbone.body.conv1.weight": rng.normal(size=(8, 3, 7, 7))}
    bn = ("weight", "bias", "running_mean", "running_var")
    for leaf in bn:
        state[f"backbone.body.bn1.{leaf}"] = rng.normal(size=8)
        state[f"backbone.body.layer1.0.downsample.1.{leaf}"] = rng.normal(size=16)
        for i in (1, 2, 3):
            state[f"backbone.body.layer1.0.bn{i}.{leaf}"] = rng.normal(size=4 if i < 3 else 16)
    state["backbone.body.layer1.0.downsample.0.weight"] = rng.normal(size=(16, 8, 1, 1))
    for i, (o, c, k) in enumerate([(4, 8, 1), (4, 4, 3), (16, 4, 1)]):
        state[f"backbone.body.layer1.0.conv{i + 1}.weight"] = rng.normal(size=(o, c, k, k))
    state["backbone.fpn.inner_blocks.0.0.weight"] = rng.normal(size=(6, 16, 1, 1))
    state["backbone.fpn.inner_blocks.0.0.bias"] = rng.normal(size=6)
    state["backbone.fpn.layer_blocks.0.weight"] = rng.normal(size=(6, 6, 3, 3))
    state["backbone.fpn.layer_blocks.0.bias"] = rng.normal(size=6)
    for name, shape in (("conv", (6, 6, 3, 3)), ("cls_logits", (3, 6, 1, 1)),
                        ("bbox_pred", (12, 6, 1, 1))):
        state[f"rpn.head.{name}.weight"] = rng.normal(size=shape)
        state[f"rpn.head.{name}.bias"] = rng.normal(size=shape[0])
    for name, (o, i) in (("box_head.fc6", (5, 6 * 49)), ("box_head.fc7", (5, 5)),
                         ("box_predictor.cls_score", (91, 5)),
                         ("box_predictor.bbox_pred", (364, 5))):
        state[f"roi_heads.{name}.weight"] = rng.normal(size=(o, i))
        state[f"roi_heads.{name}.bias"] = rng.normal(size=o)
    return {k: v.astype(np.float32) for k, v in state.items()}


@pytest.mark.parametrize("full", [False, True])
def test_converters_match_jax(full):
    state = _torchvision_state_dict(np.random.default_rng(44))
    convert = (frcnn.convert_torch_frcnn_full, jax_frcnn.convert_torch_frcnn_full) if full \
        else (frcnn.convert_torch_frcnn, jax_frcnn.convert_torch_frcnn)
    got, want = convert[0](state), convert[1](state)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w)


def test_make_detector_resolves_frcnn(tmp_path, jax_detector, monkeypatch):
    """``evaluation.detector: frcnn`` with ``detector_resize`` from a saved
    frcnn.npz (the exact rig's weights, so that boxes pass 0.8 and the court
    filter selects among them): the player centres equal the JAX
    detector's bit for bit."""
    monkeypatch.delenv("PVG_PRETRAINED_WEIGHTS", raising=False)
    variables = _rigged(jax_detector[0], exact=True)
    pretrained.save_variables_npz(variables, str(tmp_path / pretrained.WEIGHT_FILES["frcnn"]))
    config = {"evaluation": {"detector": "frcnn", "detector_resize": [MIN_SIZE, MAX_SIZE]},
              "tpu": {"pretrained_weights_dir": str(tmp_path)}}
    detector = detection.make_detector(config, device="cpu")
    assert detector.available
    assert detector.backend.model.min_size == MIN_SIZE
    obs = _frames(45)[None]
    centers = detector(obs)
    want = jax_detection.make_detector(config)(obs)
    assert centers.shape == (1, 2, 2) and (centers >= 0).all()
    np.testing.assert_array_equal(centers, want)


def test_make_detector_without_weights_raises_as_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("PVG_PRETRAINED_WEIGHTS", raising=False)
    config = {"evaluation": {"detector": "frcnn"},
              "tpu": {"pretrained_weights_dir": str(tmp_path)}}
    with pytest.raises(FileNotFoundError) as want:
        jax_detection.make_detector(config)
    with pytest.raises(FileNotFoundError) as got:
        detection.make_detector(config, device="cpu")
    assert str(got.value) == str(want.value)
    assert os.listdir(tmp_path) == []
