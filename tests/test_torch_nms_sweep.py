"""The greedy NMS of score-sorted sets (``ops.cuda.nms_sweep.nms_keep``, K4)
against the JAX package's ``nms_mask`` on the CPU.

The plain version takes the boxes in score order (``metrics.frcnn
._score_order``), packs their IoU > threshold rows to bits
(``_packed_rows``) and sweeps them (``_nms_sweep``); its keep mask in score
order must equal the JAX package's mask taken in the same order, bit for
bit (it is boolean): equal scores visited lower index first, as the stable
``jnp.argsort`` orders them, and every IoU compared in f32, so that a pair
whose f32 IoU lands exactly on the f32 threshold is not suppressed.  The
CUDA kernels themselves are held against the plain version on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import single_threaded_torch  # noqa: F401 (an autouse fixture)

from playablevideogeneration_tpu.evaluation.metrics import frcnn as jax_frcnn
from playablevideogeneration_tpu_torch.evaluation.metrics import frcnn
from playablevideogeneration_tpu_torch.ops.cuda import nms_sweep as sweep

_jax_nms = jax.jit(jax.vmap(jax_frcnn.nms_mask, in_axes=(0, 0, None)), static_argnums=2)


def _boxes(rng, n, low=0.0, high=200.0, size=(2.0, 40.0)):
    centers = rng.uniform(low + 10, high - 10, (n, 2))
    sizes = rng.uniform(*size, (n, 2))
    return np.concatenate([centers - sizes / 2, centers + sizes / 2], 1).astype(np.float32)


def _plain_keep(boxes: np.ndarray, scores: np.ndarray, threshold: float):
    """The plain version's (S, n) keep masks in score order, and the score
    order."""
    order, ordered = frcnn._score_order(torch.from_numpy(boxes), torch.from_numpy(scores))
    return sweep._nms_keep(ordered, threshold), order.numpy()


def _assert_matches_jax(boxes: np.ndarray, scores: np.ndarray, threshold: float) -> np.ndarray:
    keep, order = _plain_keep(boxes, scores, threshold)
    want = np.asarray(_jax_nms(jnp.asarray(boxes), jnp.asarray(scores), threshold))
    np.testing.assert_array_equal(keep.numpy(), np.take_along_axis(want, order, -1))
    return want


@pytest.mark.parametrize("n", [1, 7, 31, 32, 33, 504, 999, 1000, 1024])
def test_plain_sweep_matches_jax(n):
    """Seeded boxes and distinct scores, two sets per call, at the sizes
    of the detector's sets (1000 per RPN level and in the box stage, 504 at
    P6), at the most the kernels take, and ragged ones around a word."""
    rng = np.random.default_rng(n)
    boxes = np.stack([_boxes(rng, n, high=40.0 + 5.0 * np.sqrt(n)) for _ in range(2)])
    scores = rng.uniform(0, 1, (2, n)).astype(np.float32)
    for threshold in (0.5, 0.7):
        want = _assert_matches_jax(boxes, scores, threshold)
        assert want.any()
        # Some box is suppressed, except in the sets of 31 and 32 boxes at
        # 0.7, too sparse for a pair to overlap that much.
        if n > 32 or (n > 7 and threshold == 0.5):
            assert not want.all()


def _case(name: str, rng, n: int = 200):
    boxes = _boxes(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if name == "ties":
        scores = np.round(scores * 4) / 4  # 0, 0.25, ... 1: ties everywhere
        boxes[::5] = boxes[1::5][:len(boxes[::5])]  # duplicated boxes
    elif name == "all_zero":
        scores[:] = 0.0
    elif name == "degenerate":
        boxes[::3, 2:] = boxes[::3, :2]  # zero-area boxes: IoU 0 with everything
        boxes[1::3, 2] = boxes[1::3, 0]  # zero width
    elif name == "all_overlap":
        boxes[:] = boxes[0] + rng.uniform(0, 0.5, (n, 4)).astype(np.float32)
    elif name == "identical":
        boxes[:] = boxes[0]
    elif name == "none_overlap":
        x = np.arange(n, dtype=np.float32) * 10.0
        boxes = np.stack([x, x * 0, x + 5.0, x * 0 + 5.0], 1)
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize("threshold", [0.5, 0.7])
@pytest.mark.parametrize("name", ["ties", "all_zero", "degenerate", "all_overlap", "identical",
                                  "none_overlap"])
def test_plain_sweep_matches_jax_in_corner_cases(name, threshold):
    boxes, scores = _case(name, np.random.default_rng(50))
    want = _assert_matches_jax(boxes[None], scores[None], threshold)[0]
    if name in ("all_overlap", "identical"):
        assert want.sum() == 1  # the first in score order alone
    elif name in ("none_overlap", "degenerate"):
        assert want.sum() >= len(want) // 3 and (name == "degenerate" or want.all())


def _f32_iou(a: np.ndarray, b: np.ndarray) -> np.float32:
    """One pair's IoU in numpy f32, in ``box_iou``'s order of operations."""
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    w = max(min(a[2], b[2]) - max(a[0], b[0]), np.float32(0))
    h = max(min(a[3], b[3]) - max(a[1], b[1]), np.float32(0))
    inter = w * h
    return inter / max(area_a + area_b - inter, np.float32(1e-9))


def _threshold_pairs(threshold: float) -> dict:
    """Pairs of boxes, a W x H box and one of width x inside it, whose f32
    IoU lands one ulp below the f32 threshold (-1), exactly on it (0) and
    one ulp above it (1), each found by stepping x an ulp at a time around
    threshold * W: {-1: [(a, b), ...], 0: ..., 1: ...}."""
    t = np.float32(threshold)
    targets = {-1: np.nextafter(t, np.float32(0)), 0: t, 1: np.nextafter(t, np.float32(1))}
    pairs = {side: [] for side in targets}
    for width in (1.0, 10.0, 37.0, 100.0):
        for height in (1.0, 3.0, 7.5):
            a = np.array([0, 0, width, height], np.float32)
            x = np.float32(t * np.float32(width))
            for _ in range(40):
                x = np.nextafter(x, np.float32(0))
            for _ in range(80):
                b = np.array([0, 0, x, height], np.float32)
                iou = _f32_iou(a, b)
                for side, target in targets.items():
                    if iou == target:
                        pairs[side].append((a, b))
                x = np.nextafter(x, np.float32(np.inf))
    return pairs


@pytest.mark.parametrize("threshold", [0.5, 0.7])
def test_plain_sweep_matches_jax_at_the_threshold(threshold):
    """Pairs whose f32 IoU is the f32 threshold, or one ulp either side:
    the second box is suppressed only above it, in the port and in the JAX
    package.  Each pair is a set of two, the larger box first in score
    order."""
    pairs = _threshold_pairs(threshold)
    assert all(len(found) >= 2 for found in pairs.values()), {s: len(p) for s, p in pairs.items()}
    sides = [side for side, found in pairs.items() for _ in found]
    boxes = np.stack([np.stack(pair) for found in pairs.values() for pair in found])
    scores = np.tile(np.array([0.9, 0.8], np.float32), (len(boxes), 1))
    want = _assert_matches_jax(boxes, scores, threshold)
    np.testing.assert_array_equal(want[:, 0], True)
    np.testing.assert_array_equal(want[:, 1], np.array(sides) <= 0)


def test_several_sets_of_different_content_in_one_call():
    """Every corner case and a random set, stacked into one call: each
    set's mask equals its own call's and the JAX package's."""
    rng = np.random.default_rng(51)
    cases = [_case(name, rng) for name in ("ties", "all_zero", "degenerate", "all_overlap",
                                           "identical", "none_overlap", "random")]
    boxes = np.stack([b for b, _ in cases])
    scores = np.stack([s for _, s in cases])
    keep, order = _plain_keep(boxes, scores, 0.6)
    for i, (b, s) in enumerate(cases):
        alone, _ = _plain_keep(b[None], s[None], 0.6)
        np.testing.assert_array_equal(keep[i].numpy(), alone[0].numpy())
    _assert_matches_jax(boxes, scores, 0.6)


def test_packed_rows_are_little_endian_words():
    """Row i's word w holds columns 32w .. 32w + 31, column j in bit j % 32,
    padded with zeros to whole words: the layout the sweep kernel reads."""
    rng = np.random.default_rng(52)
    n = 70
    boxes = _boxes(rng, n, high=60.0)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    _, ordered = frcnn._score_order(torch.from_numpy(boxes), torch.from_numpy(scores))
    packed = sweep._packed_rows(ordered, 0.3)
    assert packed.shape == (n, 12) and packed.dtype == torch.uint8
    words = packed.view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF
    bits = (words[:, :, None] >> np.arange(32)) & 1
    over = (frcnn.box_iou(ordered, ordered) > 0.3).numpy()
    np.testing.assert_array_equal(bits.reshape(n, -1)[:, :n], over)
    assert not bits.reshape(n, -1)[:, n:].any()


def test_sweep_reads_no_bit_at_or_left_of_the_diagonal():
    """Bit j of row i for j <= i never changes the keep mask: the mask
    kernel leaves the words left of each row's diagonal word unwritten and
    the sweep kernel reads only the words from it on."""
    rng = np.random.default_rng(55)
    n = 100
    boxes = np.stack([_boxes(rng, n, high=60.0) for _ in range(3)])
    _, ordered = frcnn._score_order(torch.from_numpy(boxes),
                                    torch.from_numpy(rng.uniform(0, 1, (3, n)).astype(np.float32)))
    packed = sweep._packed_rows(ordered, 0.5)
    bits = np.unpackbits(packed.numpy(), axis=-1, bitorder="little")
    noise = rng.integers(0, 2, bits.shape).astype(np.uint8)
    at_or_left = np.arange(bits.shape[-1])[None, :] <= np.arange(n)[:, None]
    scrambled = np.where(at_or_left, noise, bits)
    assert (scrambled != bits).any()
    rows = torch.from_numpy(np.packbits(scrambled, axis=-1, bitorder="little"))
    want = sweep._nms_sweep(packed)
    assert not want.all()
    np.testing.assert_array_equal(sweep._nms_sweep(rows).numpy(), want.numpy())


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(53)
    boxes = np.stack([_boxes(rng, 40) for _ in range(3)])
    scores = rng.uniform(0, 1, (3, 40)).astype(np.float32)
    _, ordered = frcnn._score_order(torch.from_numpy(boxes), torch.from_numpy(scores))
    before = sweep.nms_keep.launches
    got = sweep.nms_keep(ordered, 0.5)
    assert sweep.nms_keep.launches == before
    assert got.dtype == torch.bool and got.shape == (3, 40)
    np.testing.assert_array_equal(got.numpy(),
                                  sweep._nms_sweep(sweep._packed_rows(ordered, 0.5)).numpy())


@pytest.mark.parametrize("boxes, message", [
    (torch.zeros(2, 1025, 4), "at most 1024"),
    (torch.zeros(2, 40, 5), r"\(S, n, 4\) float32"),
    (torch.zeros(40, 4), r"\(S, n, 4\) float32"),
    (torch.zeros(2, 40, 4, dtype=torch.float64), "float32"),
    (torch.zeros(2, 40, 4, dtype=torch.bfloat16), "float32"),
    (torch.zeros(2, 4, 40).transpose(1, 2), "contiguous"),
    (torch.zeros(2 * 40 * 4 + 1)[1:].view(2, 40, 4), "16-byte"),
], ids=["too_many", "not_boxes", "no_set_axis", "float64", "bfloat16", "strided", "misaligned"])
def test_wrapper_refuses_what_the_kernel_does_not_take(boxes, message):
    with pytest.raises(ValueError, match=message):
        sweep.nms_keep(boxes, 0.5)


def test_detector_nms_sweeps_each_set_size_once(monkeypatch):
    """``nms_masks`` stacks the sets of one shape into one ``nms_keep``
    call, their boxes in score order: the RPN's levels of one size
    together, the others apart, each mask the JAX package's."""
    rng = np.random.default_rng(54)
    shapes = [(2, 60), (2, 60), (2, 60), (2, 25)]
    candidates = [(_boxes(rng, n * b).reshape(b, n, 4),
                   rng.uniform(0, 1, (b, n)).astype(np.float32)) for b, n in shapes]
    calls = []
    plain = sweep._nms_keep

    def recorded(boxes, threshold):
        calls.append((tuple(boxes.shape), threshold))
        return plain(boxes, threshold)

    monkeypatch.setattr(frcnn, "nms_keep", recorded)
    keeps = frcnn.nms_masks([(torch.from_numpy(b), torch.from_numpy(s)) for b, s in candidates],
                            0.5)
    assert calls == [((6, 60, 4), 0.5), ((2, 25, 4), 0.5)]
    for keep, (b, s) in zip(keeps, candidates):
        np.testing.assert_array_equal(keep.numpy(), np.asarray(_jax_nms(jnp.asarray(b),
                                                                        jnp.asarray(s), 0.5)))
