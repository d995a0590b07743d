"""Operations of the detector's cell, counted from its shapes.

- ``call_flops``: the floating-point operations of the convolutions and
  matrix products of one call of the detector on a sequence of the
  configuration's frames, counted once by
  ``torch.utils.flop_counter.FlopCounterMode`` over the plain reference's
  networks on meta tensors: the ResNet-50-FPN and the RPN head on a frame
  at its padded size, and the box head on ``rpn_post_nms_top_n`` RoIs, the
  count that the program's static shapes always run, times the frames.
- ``nms_sets``: the candidate sets of a call's greedy NMS, (sets, n) by
  size, derived from the image size: the RPN's, per frame one for each
  level P2..P6 of min(``rpn_pre_nms_top_n``, the level's anchors), and the
  box stage's, per frame one of the RoIs.  ``nms_ops``: 14 f32 operations
  per unordered pair of a set (the IoU, 11, and its comparison with the
  threshold, 3), whatever implements the work.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from pvg_bench.reference import frcnn as ref

# Published H100 SXM dense peaks (NVIDIA's data sheet, at 700 W): TF32 on
# the tensor cores, which cuDNN uses for the configuration's float32
# convolutions, and float32 outside them.
PEAK_TF32_FLOPS = 494.7e12
PEAK_F32_FLOPS = 67e12
NMS_OPS_PER_PAIR = 14


def _detector(config: dict, device="meta") -> ref.Detector:
    return ref.Detector(ref.empty_variables(device), device, ref.Settings.from_config(config))


def _frames(config: dict) -> Tuple[int, int, int]:
    """(frames a call, height, width) of the configuration's sequences."""
    width, height = config["data"]["target_input_size"]
    return config["evaluation"]["batching"]["observations_count"], height, width


def level_shapes(config: dict) -> List[Tuple[int, int]]:
    """(H, W) of P2..P6 at the configuration's padded size."""
    _, height, width = _frames(config)
    h, w = _detector(config).padded_size(height, width)
    shapes = [(h // s, w // s) for s in ref.STRIDES[:4]]
    p5 = shapes[-1]
    return shapes + [((p5[0] - 1) // 2 + 1, (p5[1] - 1) // 2 + 1)]  # P6: a 1x1 pool, stride 2


def call_flops(config: dict) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    detector = _detector(config)
    frames, height, width = _frames(config)
    h, w = detector.padded_size(height, width)
    rois = config["detector"]["rpn_post_nms_top_n"]
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        levels = detector.features(torch.empty(1, 3, h, w, device="meta"))
        for level in levels:
            detector.rpn_head(level)
        detector.box_head(torch.empty(rois, ref.FPN_CHANNELS, ref.ROI_SIZE, ref.ROI_SIZE,
                                      device="meta"))
    return frames * counter.get_total_flops()


def nms_sets(config: dict) -> List[Tuple[int, int]]:
    """[(sets, candidates)] of one call's NMS."""
    frames = _frames(config)[0]
    detector = config["detector"]
    anchors = len(ref.ASPECT_RATIOS)
    levels = [min(detector["rpn_pre_nms_top_n"], h * w * anchors)
              for h, w in level_shapes(config)]
    rois = min(detector["rpn_post_nms_top_n"], sum(levels))
    return [(frames, n) for n in levels] + [(frames, rois)]


def nms_ops(config: dict) -> int:
    return NMS_OPS_PER_PAIR * sum(sets * n * (n - 1) // 2 for sets, n in nms_sets(config))
