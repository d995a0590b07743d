"""The greedy NMS sweep (``ops.cuda.nms_sweep``, K4) against the JAX
package's ``nms_mask`` scan on the CPU.

The sweep's plain version reads the packed rows that the port's detector
builds (``metrics.frcnn._packed_suppression``); its keep mask in score
order must equal the JAX package's mask taken in the same order, bit for
bit (it is boolean): equal scores visited lower index first, as the stable
``jnp.argsort`` orders them.  The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py``.
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
    """The plain sweep's (S, n) keep masks in score order, and the score
    order."""
    order, packed = frcnn._packed_suppression(torch.from_numpy(boxes), torch.from_numpy(scores),
                                              threshold)
    return sweep._nms_sweep(packed), order.numpy()


def _assert_matches_jax(boxes: np.ndarray, scores: np.ndarray, threshold: float) -> np.ndarray:
    keep, order = _plain_keep(boxes, scores, threshold)
    want = np.asarray(_jax_nms(jnp.asarray(boxes), jnp.asarray(scores), threshold))
    np.testing.assert_array_equal(keep.numpy(), np.take_along_axis(want, order, -1))
    return want


@pytest.mark.parametrize("n", [1, 7, 33, 504, 1000])
def test_plain_sweep_matches_jax(n):
    """Seeded boxes and distinct scores, two sets per call, at the sizes
    of the detector's sets (1000 per RPN level and in the box stage, 504 at
    P6) and ragged ones around a word."""
    rng = np.random.default_rng(n)
    boxes = np.stack([_boxes(rng, n, high=40.0 + 5.0 * np.sqrt(n)) for _ in range(2)])
    scores = rng.uniform(0, 1, (2, n)).astype(np.float32)
    for threshold in (0.5, 0.7):
        want = _assert_matches_jax(boxes, scores, threshold)
        assert want.any()
        if n > 7:
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
    elif name == "none_overlap":
        x = np.arange(n, dtype=np.float32) * 10.0
        boxes = np.stack([x, x * 0, x + 5.0, x * 0 + 5.0], 1)
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize("name", ["ties", "all_zero", "degenerate", "all_overlap",
                                  "none_overlap"])
def test_plain_sweep_matches_jax_in_corner_cases(name):
    boxes, scores = _case(name, np.random.default_rng(50))
    want = _assert_matches_jax(boxes[None], scores[None], 0.5)[0]
    if name == "all_overlap":
        assert want.sum() == 1  # the first in score order alone
    elif name in ("none_overlap", "degenerate"):
        assert want.sum() >= len(want) // 3 and (name == "degenerate" or want.all())


def test_several_sets_of_different_content_in_one_call():
    """Every corner case and a random set, stacked into one sweep: each
    set's mask equals its own sweep's and the JAX package's."""
    rng = np.random.default_rng(51)
    cases = [_case(name, rng) for name in ("ties", "all_zero", "degenerate", "all_overlap",
                                           "none_overlap", "random")]
    boxes = np.stack([b for b, _ in cases])
    scores = np.stack([s for _, s in cases])
    keep, order = _plain_keep(boxes, scores, 0.6)
    for i, (b, s) in enumerate(cases):
        alone, _ = _plain_keep(b[None], s[None], 0.6)
        np.testing.assert_array_equal(keep[i].numpy(), alone[0].numpy())
    _assert_matches_jax(boxes, scores, 0.6)


def test_packed_rows_are_little_endian_words():
    """Row i's word w holds columns 32w .. 32w + 31, column j in bit j % 32,
    padded with zeros to whole words: the layout the kernel reads."""
    rng = np.random.default_rng(52)
    n = 70
    boxes = _boxes(rng, n, high=60.0)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    order, packed = frcnn._packed_suppression(torch.from_numpy(boxes),
                                              torch.from_numpy(scores), 0.3)
    assert packed.shape == (n, 12) and packed.dtype == torch.uint8
    words = packed.view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF
    bits = (words[:, :, None] >> np.arange(32)) & 1
    ordered = torch.from_numpy(boxes)[order]
    over = (frcnn.box_iou(ordered, ordered) > 0.3).numpy()
    np.testing.assert_array_equal(bits.reshape(n, -1)[:, :n], over)
    assert not bits.reshape(n, -1)[:, n:].any()


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(53)
    boxes = np.stack([_boxes(rng, 40) for _ in range(3)])
    scores = rng.uniform(0, 1, (3, 40)).astype(np.float32)
    _, packed = frcnn._packed_suppression(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5)
    before = sweep.nms_sweep.launches
    got = sweep.nms_sweep(packed)
    assert sweep.nms_sweep.launches == before
    assert got.dtype == torch.bool and got.shape == (3, 40)
    np.testing.assert_array_equal(got.numpy(), sweep._nms_sweep(packed).numpy())


@pytest.mark.parametrize("rows, message", [
    (torch.zeros(2, 1025, 132, dtype=torch.uint8), "at most 1024"),
    (torch.zeros(2, 40, 5, dtype=torch.uint8), "32-bit words"),
    (torch.zeros(2, 40, 4, dtype=torch.uint8), "32-bit words"),
    (torch.zeros(2, 40, 8, dtype=torch.int32), "uint8"),
    (torch.zeros(2, 8, 40, dtype=torch.uint8).transpose(1, 2), "contiguous"),
    (torch.zeros(2 * 40 * 8 + 1, dtype=torch.uint8)[1:].view(2, 40, 8), "32-bit word"),
], ids=["too_many", "partial_word", "too_short", "dtype", "strided", "misaligned"])
def test_wrapper_refuses_what_the_kernel_does_not_take(rows, message):
    with pytest.raises(ValueError, match=message):
        sweep.nms_sweep(rows)


def test_detector_nms_sweeps_each_set_size_once(monkeypatch):
    """``nms_masks`` stacks the sets of one shape into one sweep: the RPN's
    levels of one size together, the others apart, each mask the JAX
    package's."""
    rng = np.random.default_rng(54)
    shapes = [(2, 60), (2, 60), (2, 60), (2, 25)]
    candidates = [(_boxes(rng, n * b).reshape(b, n, 4),
                   rng.uniform(0, 1, (b, n)).astype(np.float32)) for b, n in shapes]
    calls = []
    plain = sweep._nms_sweep

    def recorded(rows):
        calls.append(tuple(rows.shape))
        return plain(rows)

    monkeypatch.setattr(frcnn, "nms_sweep", recorded)
    keeps = frcnn.nms_masks([(torch.from_numpy(b), torch.from_numpy(s)) for b, s in candidates],
                            0.5)
    assert calls == [(6, 60, 8), (2, 25, 4)]
    for keep, (b, s) in zip(keeps, candidates):
        np.testing.assert_array_equal(keep.numpy(), np.asarray(_jax_nms(jnp.asarray(b),
                                                                        jnp.asarray(s), 0.5)))
