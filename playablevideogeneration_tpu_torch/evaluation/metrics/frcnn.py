"""Faster R-CNN ResNet50-FPN person detector, NCHW.

Counterpart of ``playablevideogeneration_tpu/evaluation/metrics/frcnn.py``:
torchvision's ``fasterrcnn_resnet50_fpn`` as the reference's tennis
detector uses it (score threshold 0.8 on 'person' boxes), with the JAX
package's static shapes: fixed-size top-k selections, masked greedy NMS,
and outputs padded with -1 rows.  The submodules carry the Flax names
(``body.layer1_0.conv1``, ``fpn.inner_0``, ``rpn_head.cls_logits``,
``box_head.fc6`` ...), so ``utils.jax_weights.load_jax_variables`` loads
the ``frcnn.npz`` that ``tools/convert_weights.py`` writes (the frozen
BatchNorm statistics sit under ``params`` there).

Inference protocol (torchvision's GeneralizedRCNNTransform and RoIHeads
defaults): ImageNet normalisation, a bilinear resize of the shorter side
to 800 with the longer at most 1333 (``jax.image.resize``'s, which
antialiases when it shrinks: ``utils.tensor_ops.resize_bilinear``),
padding to a multiple of 32; per FPN level the 1000 best anchors, NMS at
IoU 0.7, then the 1000 best proposals; RoIAlign at the level each box is
assigned to; 'person' scores above 0.05, class-wise NMS at IoU 0.5, 100
detections.

The ResNet50-FPN, the RPN head and the box head run batched over a
sequence's frames on the device.  Ties in a top-k or in NMS's score order
go to the lower index, as ``jax.lax.top_k`` and the stable ``jnp.argsort``
break them (a stable descending sort).  The greedy NMS runs on the device,
as the JAX package's ``lax.scan`` does: the boxes of every candidate set
in score order go to ``ops.cuda.nms_keep`` (on the card two hand-written
kernels: the IoU > threshold rows packed to bits, then the sweep over
them), one call per set size (``nms_masks``): for the RPN one for the
levels of 1000 candidates of all frames and one for the smaller P6, and
one for the box stage.  Everything runs in f32 without gradients.

Nothing in the forward reads the host: the constants it needs (the
ImageNet mean and standard deviation, the anchors) are made on the device
once per device and level shapes and kept on the module.  So on a CUDA
device ``make_person_box_backend`` replays the whole forward as one
captured CUDA graph per (frames, height, width, TF32 switches)
(``inference.graphs``), the counterpart of the JAX package's ``jax.jit``
of the detector: one copy of the frames in, the boxes, scores and labels
out.  A call of the backend is the span ``detect.call``, and inside it
``detect.readback`` and ``detect.boxes`` (``utils.tracing``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from playablevideogeneration_tpu_torch.inference import graphs
from playablevideogeneration_tpu_torch.ops.cuda.nms_sweep import nms_keep
# The box math's IoU, kept beside the NMS kernels whose plain version uses it.
from playablevideogeneration_tpu_torch.ops.cuda.nms_sweep import box_iou  # noqa: F401
from playablevideogeneration_tpu_torch.utils import tracing
from playablevideogeneration_tpu_torch.utils.device import DeviceLike
from playablevideogeneration_tpu_torch.utils.jax_weights import build_from_jax_variables
from playablevideogeneration_tpu_torch.utils.tensor_ops import resize_bilinear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
MIN_SIZE, MAX_SIZE = 800, 1333
ANCHOR_SIZES = (32, 64, 128, 256, 512)        # one per level P2..P6
ASPECT_RATIOS = (0.5, 1.0, 2.0)
STRIDES = (4, 8, 16, 32, 64)
RPN_PRE_NMS_TOPK = 1000
RPN_POST_NMS_TOPK = 1000
RPN_NMS_THRESH = 0.7
BOX_SCORE_THRESH = 0.05
BOX_NMS_THRESH = 0.5
DETECTIONS_PER_IMG = 100
NUM_CLASSES = 91                               # COCO incl. background
PERSON_LABEL = 1
BBOX_XFORM_CLIP = math.log(1000.0 / 16)
FPN_CHANNELS = 256
ROI_SIZE = 7
_CALL = tracing.span("detect.call")
_READBACK = tracing.span("detect.readback")
_BOXES = tracing.span("detect.boxes")


# --------------------------------------------------------------------- #
# Backbone: ResNet50 with frozen BatchNorm                              #
# --------------------------------------------------------------------- #


class FrozenBN(nn.Module):
    """Inference-only affine BatchNorm (torchvision's FrozenBatchNorm2d,
    eps 1e-5): y = x * inv + (bias - mean * inv), inv = scale / sqrt(var +
    eps)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


class Bottleneck(nn.Module):
    """torchvision's ResNet Bottleneck: 1x1 -> 3x3 (stride) -> 1x1 (x4), with
    a projecting shortcut on a stage's first block."""

    def __init__(self, in_planes: int, width: int, stride: int = 1, project: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, width, 1, bias=False)
        self.bn1 = FrozenBN(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = FrozenBN(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = FrozenBN(width * 4)
        self.project = project
        if project:
            self.downsample_conv = nn.Conv2d(in_planes, width * 4, 1, stride, bias=False)
            self.downsample_bn = FrozenBN(width * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        shortcut = self.downsample_bn(self.downsample_conv(x)) if self.project else x
        return F.relu(out + shortcut)


# (width, blocks, stride) of the four stages.
RESNET50_STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


class ResNet50(nn.Module):
    """The C2..C5 feature maps (strides 4, 8, 16, 32)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBN(64)
        self.stages: List[List[str]] = []
        in_planes = 64
        for stage, (width, blocks, stride) in enumerate(RESNET50_STAGES):
            names = []
            for b in range(blocks):
                name = f"layer{stage + 1}_{b}"
                setattr(self, name, Bottleneck(in_planes, width, stride if b == 0 else 1,
                                               project=b == 0))
                in_planes = width * 4
                names.append(name)
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)  # the padding is -inf
        feats = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats  # [C2, C3, C4, C5]


def nearest_indices(size: int, out: int, device=None) -> torch.Tensor:
    """The source index of each output position of
    ``jax.image.resize(..., "nearest")`` along one axis: floor((i + 0.5) *
    size / out) in f32 (half-pixel centres; ``F.interpolate``'s
    ``nearest-exact`` in exact arithmetic)."""
    offsets = (torch.arange(out, dtype=torch.float32, device=device) + 0.5) * size / out
    return torch.floor(offsets).long()


def resize_nearest(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, height, width), as ``jax.image.resize(...,
    "nearest")`` resizes."""
    rows = nearest_indices(x.shape[-2], height, x.device)
    cols = nearest_indices(x.shape[-1], width, x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


class FPN(nn.Module):
    """1x1 lateral convolutions, a nearest-neighbour top-down merge, 3x3
    output convolutions, and P6 as a stride-2 max pool (window 1) of P5
    (torchvision's LastLevelMaxPool)."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 channels: int = FPN_CHANNELS):
        super().__init__()
        self.levels = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"inner_{i}", nn.Conv2d(c, channels, 1))
            setattr(self, f"layer_{i}", nn.Conv2d(channels, channels, 3, padding=1))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"inner_{i}")(c) for i, c in enumerate(feats)]
        merged = [laterals[-1]]
        for lateral in laterals[-2::-1]:
            up = resize_nearest(merged[0], lateral.shape[-2], lateral.shape[-1])
            merged.insert(0, lateral + up)
        outs = [getattr(self, f"layer_{i}")(m) for i, m in enumerate(merged)]
        return outs + [F.max_pool2d(outs[-1], 1, 2)]  # [P2, P3, P4, P5, P6]


class RPNHead(nn.Module):
    """A shared 3x3 convolution, then objectness and box-delta 1x1 heads
    for A anchors per position."""

    def __init__(self, channels: int = FPN_CHANNELS, anchors: int = len(ASPECT_RATIOS)):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.cls_logits = nn.Conv2d(channels, anchors, 1)
        self.bbox_pred = nn.Conv2d(channels, anchors * 4, 1)

    def forward(self, feature: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        t = F.relu(self.conv(feature))
        return self.cls_logits(t), self.bbox_pred(t)


class BoxHead(nn.Module):
    """TwoMLPHead (1024-1024) and FastRCNNPredictor (class scores and
    per-class box deltas).  The RoI features are flattened in (h, w, c)
    order, as the JAX package's channels-last features are, which is the
    order of ``fc6``'s converted rows."""

    def __init__(self, channels: int = FPN_CHANNELS, representation_size: int = 1024,
                 num_classes: int = NUM_CLASSES, roi_size: int = ROI_SIZE):
        super().__init__()
        self.fc6 = nn.Linear(channels * roi_size * roi_size, representation_size)
        self.fc7 = nn.Linear(representation_size, representation_size)
        self.cls_score = nn.Linear(representation_size, num_classes)
        self.bbox_pred = nn.Linear(representation_size, num_classes * 4)

    def forward(self, roi_features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """:param roi_features: (K, C, 7, 7)"""
        x = roi_features.permute(0, 2, 3, 1).reshape(roi_features.shape[0], -1)
        x = F.relu(self.fc6(x))
        x = F.relu(self.fc7(x))
        return self.cls_score(x), self.bbox_pred(x)


# --------------------------------------------------------------------- #
# Box math (static shapes throughout)                                   #
# --------------------------------------------------------------------- #


def make_anchors(level_shapes: Sequence[Tuple[int, int]],
                 strides: Sequence[int]) -> List[np.ndarray]:
    """Per-level (H*W*A, 4) anchor grids in (x1, y1, x2, y2), as
    torchvision's AnchorGenerator makes them: square-root-ratio base
    anchors whose half extents are rounded, shifted by the stride."""
    all_anchors = []
    for (h, w), stride, size in zip(level_shapes, strides, ANCHOR_SIZES):
        ratios = np.asarray(ASPECT_RATIOS, np.float32)
        h_ratios = np.sqrt(ratios)
        w_ratios = 1.0 / h_ratios
        ws = w_ratios * size
        hs = h_ratios * size
        base = np.stack([-ws / 2, -hs / 2, ws / 2, hs / 2], axis=1).round()
        shifts_x = np.arange(w, dtype=np.float32) * stride
        shifts_y = np.arange(h, dtype=np.float32) * stride
        sx, sy = np.meshgrid(shifts_x, shifts_y)
        shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
        anchors = (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4)
        all_anchors.append(anchors.astype(np.float32))
    return all_anchors


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """(..., 4) (dx, dy, dw, dh) deltas on (..., 4) anchors -> (x1, y1, x2,
    y2) boxes (torchvision's BoxCoder.decode_single, with its dw/dh
    clamp)."""
    wx, wy, ww, wh = weights
    widths = anchors[..., 2] - anchors[..., 0]
    heights = anchors[..., 3] - anchors[..., 1]
    ctr_x = anchors[..., 0] + 0.5 * widths
    ctr_y = anchors[..., 1] + 0.5 * heights
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(deltas[..., 3] / wh, max=BBOX_XFORM_CLIP)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h], dim=-1)


def clip_boxes(boxes: torch.Tensor, height: float, width: float) -> torch.Tensor:
    return torch.stack([boxes[..., 0].clamp(0, width), boxes[..., 1].clamp(0, height),
                        boxes[..., 2].clamp(0, width), boxes[..., 3].clamp(0, height)], dim=-1)


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest scores along the last axis and their indices, ties
    to the lower index, as ``jax.lax.top_k`` returns them."""
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _gather_rows(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """x (..., N, D), indices (..., K) -> (..., K, D)."""
    return torch.gather(x, -2, indices[..., None].expand(*indices.shape, x.shape[-1]))


def _score_order(boxes: torch.Tensor, scores: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The score order (stable, descending) of (..., n) candidates, and
    their boxes (..., n, 4) in that order."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order, _gather_rows(boxes, order)


def nms_masks(candidates: Sequence[Tuple[torch.Tensor, torch.Tensor]], iou_threshold: float
              ) -> List[torch.Tensor]:
    """Greedy NMS keep-masks of several candidate sets, each boxes (...,
    n, 4) and scores (..., n), with static shapes: the keep-masks (...,
    n) over the inputs, semantically ``torchvision.ops.nms`` (the JAX
    package's ``nms_mask``).  The sets of one shape are stacked, sorted
    and given to one ``nms_keep``; nothing goes to the host."""
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for index, (boxes, _) in enumerate(candidates):
        groups.setdefault(tuple(boxes.shape), []).append(index)
    keeps: List[Optional[torch.Tensor]] = [None] * len(candidates)
    for members in groups.values():
        order, ordered = _score_order(torch.stack([candidates[i][0] for i in members]),
                                      torch.stack([candidates[i][1] for i in members]))
        n = order.shape[-1]
        keep_sorted = nms_keep(ordered.reshape(-1, n, 4), iou_threshold).reshape(order.shape)
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        for member, mask in zip(members, keep):
            keeps[member] = mask
    return keeps


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS of one candidate set: boxes (n, 4), scores (n,) -> the
    (n,) keep-mask."""
    return nms_masks([(boxes, scores)], iou_threshold)[0]


# --------------------------------------------------------------------- #
# RoIAlign                                                              #
# --------------------------------------------------------------------- #


def _bilinear_samples(flat: torch.Tensor, base: torch.Tensor, height: torch.Tensor,
                      width: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of per-box maps: flat (C, L) holds each map
    row-major from ``base`` (K,) with (height, width) (K,); ys and xs (K,
    S) are sample coordinates, clamped into the map as torchvision
    clamps them (boxes are clipped to the image).  Returns (C, K, S, S)."""
    ys = torch.minimum(ys.clamp(min=0.0), (height - 1.0)[:, None])
    xs = torch.minimum(xs.clamp(min=0.0), (width - 1.0)[:, None])
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy = (ys - y0)[:, :, None]
    wx = (xs - x0)[:, None, :]
    y0, x0 = y0.long(), x0.long()
    y1 = torch.minimum(y0 + 1, (height - 1)[:, None])
    x1 = torch.minimum(x0 + 1, (width - 1)[:, None])
    row0 = base[:, None] + y0 * width[:, None]
    row1 = base[:, None] + y1 * width[:, None]

    def at(rows, cols):
        return flat[:, rows[:, :, None] + cols[:, None, :]]

    out = at(row0, x0) * (1 - wy) * (1 - wx)
    out = out + at(row0, x1) * (1 - wy) * wx
    out = out + at(row1, x0) * wy * (1 - wx)
    return out + at(row1, x1) * wy * wx


def _roi_align_at(flat: torch.Tensor, base, height, width, boxes: torch.Tensor,
                  spatial_scale: torch.Tensor, output_size: int,
                  sampling_ratio: int) -> torch.Tensor:
    """RoIAlign of boxes (K, 4) in image coordinates on per-box maps of
    ``flat`` (see ``_bilinear_samples``), each at its ``spatial_scale``
    (K,); returns (K, C, output_size, output_size)."""
    boxes = boxes * spatial_scale[:, None]
    x1, y1 = boxes[:, 0], boxes[:, 1]
    roi_w = torch.clamp(boxes[:, 2] - x1, min=1.0)
    roi_h = torch.clamp(boxes[:, 3] - y1, min=1.0)
    bin_w = roi_w / output_size
    bin_h = roi_h / output_size
    s = sampling_ratio
    steps = torch.arange(output_size, dtype=torch.float32, device=boxes.device)
    offsets = (torch.arange(s, dtype=torch.float32, device=boxes.device) + 0.5) / s
    grid = (steps[:, None] + offsets[None, :]).reshape(-1)  # (out*s,)
    ys = y1[:, None] + bin_h[:, None] * grid[None, :]
    xs = x1[:, None] + bin_w[:, None] * grid[None, :]
    samples = _bilinear_samples(flat, base, height, width, ys, xs)
    c, k = samples.shape[:2]
    pooled = samples.reshape(c, k, output_size, s, output_size, s).mean(dim=(3, 5))
    return pooled.permute(1, 0, 2, 3)


def roi_align(feature: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
              output_size: int = ROI_SIZE, sampling_ratio: int = 2) -> torch.Tensor:
    """RoIAlign (aligned=False, torchvision detection's default): for each
    box, output_size^2 bins of sampling_ratio^2 bilinear samples averaged.

    :param feature: (C, H, W)
    :param boxes: (K, 4) in image coordinates
    :return: (K, C, output_size, output_size)
    """
    c, h, w = feature.shape
    k = boxes.shape[0]
    per_box = boxes.new_ones(k)
    zero = torch.zeros(k, dtype=torch.long, device=boxes.device)
    return _roi_align_at(feature.reshape(c, -1), zero, zero + h, zero + w, boxes,
                         per_box * spatial_scale, output_size, sampling_ratio)


def fpn_level_assignment(boxes: torch.Tensor, num_levels: int = 4,
                         canonical_scale: float = 224.0,
                         canonical_level: int = 4) -> torch.Tensor:
    """The FPN paper's eq. 1 as torchvision's MultiScaleRoIAlign uses it:
    level floor(k0 + log2(sqrt(area) / 224)), clamped to [2, 5], as a
    0-based index into [P2..P5]."""
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    k = torch.floor(canonical_level + torch.log2(
        torch.sqrt(torch.clamp(area, min=1e-6)) / canonical_scale + 1e-6))
    return torch.clamp(k, 2, 2 + num_levels - 1).long() - 2


def multiscale_roi_align(levels: Sequence[torch.Tensor], boxes: torch.Tensor,
                         strides: Sequence[int] = STRIDES[:4]) -> torch.Tensor:
    """RoIAlign of each box (K, 4) at the FPN level it is assigned to,
    levels (C, H_l, W_l) of one frame; (K, C, 7, 7).  The JAX package
    computes every level and selects by a one-hot sum, which adds exact
    zeros: the same values."""
    level = fpn_level_assignment(boxes, len(levels))
    heights = [f.shape[-2] for f in levels]
    widths = [f.shape[-1] for f in levels]
    starts = np.cumsum([0] + [h * w for h, w in zip(heights, widths)])[:-1].tolist()
    flat = torch.cat([f.reshape(f.shape[0], -1) for f in levels], dim=1)
    return _roi_align_at(flat, _per_level(level, starts, torch.long),
                         _per_level(level, heights, torch.long),
                         _per_level(level, widths, torch.long), boxes,
                         _per_level(level, [1.0 / s for s in strides], torch.float32),
                         ROI_SIZE, 2)


def _per_level(level: torch.Tensor, values: Sequence, dtype: torch.dtype) -> torch.Tensor:
    """``values[level]``, each value filled in on the device: no tensor is
    made from host data."""
    out = torch.full(level.shape, values[0], dtype=dtype, device=level.device)
    for index, value in enumerate(values[1:], 1):
        out = out.masked_fill(level == index, value)
    return out


# --------------------------------------------------------------------- #
# Full detector                                                         #
# --------------------------------------------------------------------- #


class FasterRCNN(nn.Module):
    """Eval-mode Faster R-CNN: (N, H, W, 3) [0, 1] RGB frames -> per frame
    (boxes (D, 4), scores (D,), labels (D,)), padded with -1 rows.

    ``min_size``/``max_size`` are the transform's resize bounds (800/1333
    for the COCO checkpoint); the weights do not depend on them.
    """

    def __init__(self, min_size: int = MIN_SIZE, max_size: int = MAX_SIZE):
        super().__init__()
        self.min_size, self.max_size = min_size, max_size
        # Constants made on a device once: (name, ..., device) -> tensors.
        self._constants: Dict[tuple, object] = {}
        self.body = ResNet50()
        self.fpn = FPN()
        self.rpn_head = RPNHead()
        self.box_head = BoxHead()

    def geometry(self, height: int, width: int) -> Tuple[float, int, int]:
        """(scale, resized height, resized width) of an input size."""
        scale = min(self.min_size / min(height, width), self.max_size / max(height, width))
        return scale, int(round(height * scale)), int(round(width * scale))

    def _constant(self, key: tuple, make: Callable[[], object]):
        """``make()``'s tensors, made once per ``key`` (which names the
        device): a captured forward must not copy from the host."""
        value = self._constants.get(key)
        if value is None:
            value = self._constants[key] = make()
        return value

    def transform(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) in [0, 1] -> the normalised, resized frames padded
        to a multiple of 32, (N, 3, H', W')."""
        _, new_h, new_w = self.geometry(images.shape[1], images.shape[2])
        mean, std = self._constant(("normalisation", images.device), lambda: (
            torch.tensor(IMAGENET_MEAN, device=images.device),
            torch.tensor(IMAGENET_STD, device=images.device)))
        x = ((images - mean) / std).permute(0, 3, 1, 2)
        x = resize_bilinear(x, new_h, new_w)
        return F.pad(x, (0, -new_w % 32, 0, -new_h % 32))

    @torch.no_grad()
    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """The FPN levels P2..P6 of (N, H, W, 3) frames."""
        return self.fpn(self.body(self.transform(images)))

    def proposals(self, levels: Sequence[torch.Tensor], new_h: int, new_w: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The RPN's (N, K, 4) proposals and (N, K) scores, 0 where none
        survived: per level the best anchors, decoded and clipped, NMS;
        then the best over all levels."""
        n = levels[0].shape[0]
        shapes = tuple(tuple(l.shape[-2:]) for l in levels)
        device = levels[0].device
        anchors = self._constant(("anchors", shapes, device), lambda: [
            torch.from_numpy(a).to(device) for a in make_anchors(shapes, STRIDES)])
        candidates, valid_masks = [], []
        for level, anchor in zip(levels, anchors):
            logits, deltas = self.rpn_head(level)
            scores = torch.sigmoid(logits.permute(0, 2, 3, 1).reshape(n, -1))
            deltas = deltas.permute(0, 2, 3, 1).reshape(n, -1, 4)
            top_scores, top_idx = top_k(scores, min(RPN_PRE_NMS_TOPK, scores.shape[1]))
            boxes = decode_boxes(_gather_rows(deltas, top_idx), anchor[top_idx])
            boxes = clip_boxes(boxes, new_h, new_w)
            # Tiny boxes score 0 instead of being removed: torchvision's
            # remove_small_boxes with static shapes.
            valid = ((boxes[..., 2] - boxes[..., 0] > 1e-2)
                     & (boxes[..., 3] - boxes[..., 1] > 1e-2))
            candidates.append((boxes, torch.where(valid, top_scores, 0.0)))
            valid_masks.append(valid)
        keeps = nms_masks(candidates, RPN_NMS_THRESH)
        all_boxes = torch.cat([boxes for boxes, _ in candidates], dim=1)
        all_scores = torch.cat([torch.where(keep & valid, scores, 0.0) for (_, scores), keep, valid
                                in zip(candidates, keeps, valid_masks)], dim=1)
        top_scores, top_idx = top_k(all_scores, min(RPN_POST_NMS_TOPK, all_scores.shape[1]))
        return _gather_rows(all_boxes, top_idx), top_scores

    @torch.no_grad()
    def forward(self, images: torch.Tensor, taps: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(N, H, W, 3) frames in [0, 1] -> boxes (N, D, 4) in input
        coordinates, scores (N, D), labels (N, D), -1 where empty.
        ``taps``, when given, receives ``roi_valid`` (N, K) and
        ``masked_class_scores`` (N, K), the JAX module's sown
        intermediates, and ``detection_scores`` (N, K), the person scores
        that the final top-k selects from."""
        return self.detect(self.features(images), images.shape[1:3], taps)

    @torch.no_grad()
    def detect(self, levels: Sequence[torch.Tensor], input_size: Tuple[int, int],
               taps: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``forward``'s box stages on the FPN levels of frames of
        ``input_size`` (H, W)."""
        scale, new_h, new_w = self.geometry(*input_size)
        n = levels[0].shape[0]
        rois, roi_scores = self.proposals(levels, new_h, new_w)
        # When fewer than K proposals survive, the tail holds zero-score
        # boxes that torchvision's RoIHeads would never see: they ride
        # through the box head, and the mask silences their scores.
        roi_valid = roi_scores > 0.0
        heads = [self.box_head(multiscale_roi_align([level[i] for level in levels[:4]],
                                                    rois[i]))
                 for i in range(n)]
        class_scores = torch.stack([scores for scores, _ in heads])
        deltas = torch.stack([d for _, d in heads])
        probs = torch.softmax(class_scores, dim=-1)  # (N, K, NUM_CLASSES)
        deltas = deltas.reshape(*deltas.shape[:2], NUM_CLASSES, 4)

        # The person class only: the tennis use case.
        boxes = decode_boxes(deltas[:, :, PERSON_LABEL], rois, weights=(10.0, 10.0, 5.0, 5.0))
        boxes = clip_boxes(boxes, new_h, new_w)
        scores = torch.where(roi_valid, probs[..., PERSON_LABEL], 0.0)
        if taps is not None:
            taps.update(roi_valid=roi_valid, masked_class_scores=scores)
        scores = torch.where(scores > BOX_SCORE_THRESH, scores, 0.0)
        valid = ((boxes[..., 2] - boxes[..., 0] > 1e-2)
                 & (boxes[..., 3] - boxes[..., 1] > 1e-2))
        scores = torch.where(valid, scores, 0.0)
        keep, = nms_masks([(boxes, scores)], BOX_NMS_THRESH)
        scores = torch.where(keep, scores, 0.0)
        if taps is not None:
            taps["detection_scores"] = scores

        final_scores, idx = top_k(scores, min(DETECTIONS_PER_IMG, scores.shape[-1]))
        final_boxes = _gather_rows(boxes, idx) / scale  # back to input coordinates
        empty = final_scores <= 0.0
        final_boxes = torch.where(empty[..., None], -1.0, final_boxes)
        final_labels = torch.full_like(idx, PERSON_LABEL).masked_fill(empty, -1)
        return final_boxes, final_scores, final_labels


# --------------------------------------------------------------------- #
# Weight conversion (torchvision fasterrcnn_resnet50_fpn state_dict)    #
# --------------------------------------------------------------------- #


def convert_torch_frcnn(state_dict) -> dict:
    """torchvision ``fasterrcnn_resnet50_fpn`` state_dict -> the converted
    variables (the JAX package's layout).  Conv kernels OIHW -> HWIO;
    Linear (out, in) -> (in, out); FrozenBatchNorm2d {weight, bias,
    running_mean, running_var} -> FrozenBN {scale, bias, mean, var}."""
    params: dict = {}

    def put(path, leaf):
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(leaf)

    def conv(v):
        return np.transpose(np.asarray(v), (2, 3, 1, 0))

    bn_leaf = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}

    for key, value in state_dict.items():
        parts = key.split(".")
        if parts[0] == "backbone" and parts[1] == "body":
            # backbone.body.conv1.weight, bn1.*, layerX.B.convY.weight,
            # layerX.B.bnY.*, layerX.B.downsample.{0,1}.*
            rest = parts[2:]
            if rest[0] == "conv1":
                put(["body", "conv1", "kernel"], conv(value))
            elif rest[0] == "bn1":
                put(["body", "bn1", bn_leaf[rest[1]]], value)
            else:
                block = f"{rest[0]}_{rest[1]}"
                if rest[2] == "downsample":
                    if rest[3] == "0":
                        put(["body", block, "downsample_conv", "kernel"], conv(value))
                    else:
                        put(["body", block, "downsample_bn", bn_leaf[rest[4]]], value)
                elif rest[2].startswith("conv"):
                    put(["body", block, rest[2], "kernel"], conv(value))
                else:
                    put(["body", block, rest[2], bn_leaf[rest[3]]], value)
        elif parts[0] == "backbone" and parts[1] == "fpn":
            # backbone.fpn.inner_blocks.i.0.{weight,bias} (older: no .0)
            idx = parts[3]
            kind = "inner" if parts[2] == "inner_blocks" else "layer"
            leaf = "kernel" if parts[-1] == "weight" else "bias"
            put(["fpn", f"{kind}_{idx}", leaf], conv(value) if leaf == "kernel" else value)
        elif parts[0] == "rpn":
            # rpn.head.{conv,cls_logits,bbox_pred}.{weight,bias}
            leaf = "kernel" if parts[-1] == "weight" else "bias"
            put(["rpn_head", parts[2], leaf], conv(value) if leaf == "kernel" else value)
        elif parts[0] == "roi_heads":
            # roi_heads.box_head.fc6/fc7.*, roi_heads.box_predictor.*
            leaf = "kernel" if parts[-1] == "weight" else "bias"
            put(["box_head", parts[2], leaf],
                np.asarray(value).T if leaf == "kernel" else value)
    return {"params": params}


def _torch_fc6_kernel_reorder(kernel_chw: np.ndarray) -> np.ndarray:
    """torchvision flattens RoI features as (C, 7, 7), the converted layout
    as (7, 7, C): fc6's input rows, (C*7*7, 1024) in (C, H, W) order, in
    (H, W, C) order."""
    c = kernel_chw.shape[0] // 49
    k = kernel_chw.reshape(c, 7, 7, -1)
    return np.transpose(k, (1, 2, 0, 3)).reshape(c * 49, -1)


def convert_torch_frcnn_full(state_dict) -> dict:
    """``convert_torch_frcnn`` and the fc6 row reorder."""
    variables = convert_torch_frcnn(state_dict)
    fc6 = variables["params"]["box_head"]["fc6"]
    fc6["kernel"] = _torch_fc6_kernel_reorder(fc6["kernel"])
    return variables


def random_frcnn_variables(seed: int) -> dict:
    """Seeded variables in the converted file's layout (flax names, HWIO
    kernels, the frozen statistics under ``params``), numpy: He-normal
    kernels, biases N(0, 0.01^2), FrozenBN statistics near (0, 1) with
    each block's last scale at 0.2, so that the residual stack keeps its
    activations O(1) through 16 blocks."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        model = FasterRCNN()
    params: dict = {}
    leaves = {"running_mean": "mean", "running_var": "var"}
    for key, tensor in list(model.named_parameters()) + list(model.named_buffers()):
        *path, leaf = key.split(".")
        shape = tuple(tensor.shape)
        frozen_bn = isinstance(model.get_submodule(".".join(path)), FrozenBN)
        if leaf == "weight" and not frozen_bn:
            shape = (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 else shape[::-1]
            leaf, value = "kernel", rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        elif leaf == "weight":
            leaf = "scale"
            value = rng.uniform(0.8, 1.2, shape) * (0.2 if path[-1] in ("bn3", "downsample_bn")
                                                     else 1.0)
        elif leaf == "running_var":
            value = rng.uniform(0.8, 1.2, shape)
        else:
            value = rng.normal(0.0, 0.01 if leaf == "bias" else 0.05, shape)
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaves.get(leaf, leaf)] = value.astype(np.float32)
    return {"params": params}


# --------------------------------------------------------------------- #
# Detector backend for TennisPlayerDetector                             #
# --------------------------------------------------------------------- #


def make_frcnn(variables: Dict, min_size: int = MIN_SIZE, max_size: int = MAX_SIZE,
               device: DeviceLike = "cuda") -> FasterRCNN:
    """The detector holding the converted ``variables`` on ``device``, in
    evaluation mode."""
    return build_from_jax_variables(lambda: FasterRCNN(min_size, max_size), variables, device)


def make_person_box_backend(variables: Dict, score_threshold: float = 0.8,
                            min_size: int = MIN_SIZE, max_size: int = MAX_SIZE,
                            device: DeviceLike = "cuda", backend: Optional[type] = None
                            ) -> Callable[[np.ndarray], list]:
    """A (T, H, W, C) [0, 1] -> [[(x1, y1, x2, y2), ...] per frame] box
    proposer for ``TennisPlayerDetector`` (detection.py): the person boxes
    above ``score_threshold`` (0.8, the reference's,
    tennis_player_detector.py:17).  The detector is the returned
    function's ``model``; its ``detect`` gives the (boxes, scores, labels)
    numpy arrays of a call.

    On a CUDA device each call replays the captured forward of its (T, H,
    W, TF32 switches), a ``graphs.ProgramCache`` of them: one copy of the
    frames to the card, one replay, the three outputs read back.  On the
    CPU it runs op by op.  A call is the span ``detect.call``; the readback
    and the boxes' selection are ``detect.readback`` and ``detect.boxes``
    inside it.

    :param backend: for the tests and the chip check only:
        ``graphs.StandIn`` or ``graphs.Eager``; by default the device
        decides (``graphs.resolve_backend``)"""
    model = make_frcnn(variables, min_size, max_size, device)
    forward = graphs.replayed(model, model, next(model.parameters()).device, backend)

    def detect(frames: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        frames = np.ascontiguousarray(np.asarray(frames, np.float32)[..., :3])
        outputs = forward(torch.from_numpy(frames))
        with _READBACK:
            return tuple(graphs.to_numpy(t) for t in outputs)

    def person_boxes(frames: np.ndarray) -> list:
        with _CALL:
            boxes, scores, labels = detect(frames)
            with _BOXES:
                found = [[tuple(float(v) for v in boxes[t, i]) for i in range(boxes.shape[1])
                          if scores[t, i] > score_threshold and labels[t, i] == PERSON_LABEL]
                         for t in range(boxes.shape[0])]
            return found

    person_boxes.model, person_boxes.detect, person_boxes.programs = (
        model, detect, forward.programs)
    return person_boxes


def frcnn_backend_from_config(config, device: DeviceLike = "cuda"):
    """Resolves ``evaluation.detector: frcnn``: the converted torchvision
    weights (``frcnn.npz``) from the pretrained-weights directory, and the
    optional ``evaluation.detector_resize: [min, max]`` in place of the
    800/1333 transform bounds."""
    from playablevideogeneration_tpu_torch.utils import pretrained

    path = pretrained.find_weights(config, "frcnn")
    if path is None:
        raise FileNotFoundError(
            "evaluation.detector: frcnn needs converted detector weights "
            "(tools/convert_weights.py frcnn) in PVG_PRETRAINED_WEIGHTS or "
            "tpu.pretrained_weights_dir")
    variables = pretrained.load_variables_npz(path)
    resize = (config.get("evaluation", {}) or {}).get("detector_resize", (MIN_SIZE, MAX_SIZE))
    return make_person_box_backend(variables, min_size=int(resize[0]), max_size=int(resize[1]),
                                   device=device)
