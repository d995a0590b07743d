"""A plain float32 Faster R-CNN ResNet-50-FPN person detector, the reference
of the detector's cell.

torchvision's ``fasterrcnn_resnet50_fpn`` in inference, written out in
plain ``torch`` (``torchvision/models/detection/``: ``transform.py``'s
normalisation, resize and padding, ``backbone_utils.py`` and ``resnet.py``
with frozen BatchNorm, ``ops/feature_pyramid_network.py``, ``rpn.py``,
``anchor_utils.py``, ``_utils.py``'s box coder, ``poolers.py`` and
``ops/roi_align.py`` with ``aligned=False`` and sampling ratio 2,
``roi_heads.py``'s ``TwoMLPHead``, predictor and ``postprocess_detections``;
``ops/boxes.py``), one frame at a time, in float32 with TF32 off: no
kernel, no captured graph, no static shapes.  Each greedy NMS is a plain
loop over the stably sorted scores.  It takes the converted variables'
layout (flax names, HWIO kernels, dense kernels (in, out), ``fc6``'s rows
in (h, w, c) order, the frozen statistics beside the parameters), the
layout of ``frcnn.npz``.  The court filter and the tallest box of the
Tennis evaluation (``tennis_player_detector.py:34-107`` upstream) are
copied plainly at the end.  Nothing of the port and nothing of JAX is
imported.

Where the measured program departs from torchvision in a way that can
change a result, this reference follows the program, and says so:

1. the resized size is rounded (``int(round(h * scale))``), where
   torchvision's ``recompute_scale_factor`` floors it: 96 x 256 frames at
   800/1333 become 500 x 1333, not 499 x 1333;
2. boxes go back to the input's coordinates divided by that one scale,
   where torchvision divides by the ratio of each axis;
3. every top-k and NMS order is a stable descending sort of the scores,
   ties to the lower index, and the RPN ranks its candidates by
   probability (torchvision's ``topk`` of the logits leaves ties in no
   set order and sees no ties that the sigmoid makes);
4. a box is kept only where its width and height exceed 1e-2, in the RPN
   too (torchvision's RPN keeps those of at least 1e-3, its box stage
   those of at least 1e-2);
5. only the person class is decoded, and the 100 detections are the best
   person boxes (torchvision's are the best over all 90 classes; a
   person box above the 0.8 threshold can be left out there only where a
   hundred boxes score above it);
6. the anchors of level P2..P6 are spaced by its nominal stride, 4 to 64,
   where torchvision's are spaced by the padded image's size over the
   level's (the same unless P5's size is odd; at 512 x 1344 it is even);
7. a RoIAlign sample beyond the feature map reads the map's edge, where
   torchvision's reads zero (a box is clipped to the resized image, so a
   sample lies beyond the map only where the image fills its padding and
   the box is under one bin of its level high or wide at the edge; at
   500 x 1333 padded to 512 x 1344 none does).

The program's fixed-size top-k, whose zero-score tails ride through the
box head with their scores silenced, gives torchvision's results, so the
reference keeps torchvision's variable-length lists.

``Variant`` puts the control and the planted faults in the program's place
to set the cell's limits: every convolution's and product's operands and
result rounded to bfloat16 (the next precision below the configuration's
float32), the box stage's NMS at another IoU, RoIAlign's samples shifted
by part of a bin, P2 without the FPN's top-down addition.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
RESNET50_STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))  # width, blocks, stride
FPN_IN_CHANNELS = (256, 512, 1024, 2048)
FPN_CHANNELS = 256
ANCHOR_SIZES = (32, 64, 128, 256, 512)  # one per level P2..P6
STRIDES = (4, 8, 16, 32, 64)  # departure 6
ASPECT_RATIOS = (0.5, 1.0, 2.0)
REPRESENTATION = 1024
NUM_CLASSES = 91  # COCO with the background
PERSON = 1
ROI_SIZE = 7
SAMPLING_RATIO = 2
RPN_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
BBOX_XFORM_CLIP = math.log(1000.0 / 16)
BN_EPS = 1e-5
SMALL_BOX = 1e-2  # departure 4
CANONICAL_SCALE, CANONICAL_LEVEL, LEVEL_EPS = 224.0, 4, 1e-6
# The reference's rules for 256 x 96 frames as fractions of (W, H)
# (tennis_player_detector.py:34-47): no box ending left of 60 px or
# starting right of 200 px with its top above 26 px, none with its top
# below 80 px.
COURT_FILTER = {"upper_left": [60 / 256, 26 / 96], "upper_right": [200 / 256, 26 / 96],
                "max_top": 80 / 96}


@dataclass
class Settings:
    """The transform's bounds and the detector's thresholds and counts, as
    a configuration's ``detector`` states them (torchvision's defaults)."""

    min_size: int = 800
    max_size: int = 1333
    rpn_pre_nms_top_n: int = 1000
    rpn_post_nms_top_n: int = 1000
    rpn_nms_thresh: float = 0.7
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    box_detections_per_img: int = 100
    person_threshold: float = 0.8
    court_filter: dict = field(default_factory=lambda: dict(COURT_FILTER))

    @classmethod
    def from_config(cls, config: dict) -> "Settings":
        stated = config["detector"]
        return cls(**{f.name: stated[f.name] for f in fields(cls)})


@dataclass(frozen=True)
class Variant:
    """What is put in the program's place to set the limits: the reference
    itself (the default), its bfloat16 control, or a planted fault."""

    bf16: bool = False  # every convolution's and product's operands and result
    box_nms_thresh: Optional[float] = None  # the box stage's NMS IoU, if not the settings'
    roi_shift: float = 0.0  # RoIAlign's samples moved by this share of a bin, down and right
    p2_top_down: bool = True  # False: P2 is its lateral alone


REFERENCE = Variant()
VARIANTS = {"control": Variant(bf16=True), "nms_iou_0.6": Variant(box_nms_thresh=0.6),
            "roi_half_bin": Variant(roi_shift=0.5), "p2_no_top_down": Variant(p2_top_down=False)}


@dataclass
class Stages:
    """One frame's FPN levels P2..P6 (C, H, W), its RoIs (K, 4) in the
    resized image, and the box head's class logits (K, 91) and person box
    deltas (K, 4) on them."""

    levels: List[torch.Tensor]
    rois: torch.Tensor
    logits: torch.Tensor
    deltas: torch.Tensor


@dataclass
class Detections:
    """One frame's person detections in the input's coordinates, best first:
    boxes (D, 4) as (x1, y1, x2, y2) and scores (D,), float32 numpy."""

    boxes: np.ndarray
    scores: np.ndarray

    def above(self, threshold: float) -> List[tuple]:
        """The boxes scoring above ``threshold``, as tuples of floats."""
        return [tuple(float(v) for v in box) for box, s in zip(self.boxes, self.scores)
                if s > threshold]


# --------------------------------------------------------------------------
# The variables' layout.


def variable_shapes() -> Dict[str, tuple]:
    """{'/'-joined path under ``params``: shape} of every converted
    variable."""
    shapes: Dict[str, tuple] = {}

    def conv(path, k, cin, cout, bias=False):
        shapes[f"{path}/kernel"] = (k, k, cin, cout)
        if bias:
            shapes[f"{path}/bias"] = (cout,)

    def bn(path, c):
        for leaf in ("scale", "bias", "mean", "var"):
            shapes[f"{path}/{leaf}"] = (c,)

    def dense(path, cin, cout):
        shapes[f"{path}/kernel"], shapes[f"{path}/bias"] = (cin, cout), (cout,)

    conv("body/conv1", 7, 3, 64)
    bn("body/bn1", 64)
    cin = 64
    for stage, (width, blocks, _) in enumerate(RESNET50_STAGES):
        for b in range(blocks):
            path = f"body/layer{stage + 1}_{b}"
            conv(f"{path}/conv1", 1, cin, width)
            bn(f"{path}/bn1", width)
            conv(f"{path}/conv2", 3, width, width)
            bn(f"{path}/bn2", width)
            conv(f"{path}/conv3", 1, width, 4 * width)
            bn(f"{path}/bn3", 4 * width)
            if b == 0:
                conv(f"{path}/downsample_conv", 1, cin, 4 * width)
                bn(f"{path}/downsample_bn", 4 * width)
            cin = 4 * width
    for i, c in enumerate(FPN_IN_CHANNELS):
        conv(f"fpn/inner_{i}", 1, c, FPN_CHANNELS, bias=True)
        conv(f"fpn/layer_{i}", 3, FPN_CHANNELS, FPN_CHANNELS, bias=True)
    anchors = len(ASPECT_RATIOS)
    conv("rpn_head/conv", 3, FPN_CHANNELS, FPN_CHANNELS, bias=True)
    conv("rpn_head/cls_logits", 1, FPN_CHANNELS, anchors, bias=True)
    conv("rpn_head/bbox_pred", 1, FPN_CHANNELS, 4 * anchors, bias=True)
    dense("box_head/fc6", FPN_CHANNELS * ROI_SIZE * ROI_SIZE, REPRESENTATION)
    dense("box_head/fc7", REPRESENTATION, REPRESENTATION)
    dense("box_head/cls_score", REPRESENTATION, NUM_CLASSES)
    dense("box_head/bbox_pred", REPRESENTATION, 4 * NUM_CLASSES)
    return shapes


def empty_variables(device="meta") -> dict:
    """Variables of the right shapes and no values, for counting."""
    params: dict = {}
    for path, shape in variable_shapes().items():
        *nodes, leaf = path.split("/")
        node = params
        for name in nodes:
            node = node.setdefault(name, {})
        node[leaf] = torch.empty(shape, device=device)
    return {"params": params}


def _flat(tree: dict, prefix: str = "") -> Dict[str, object]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_flat(value, path) if isinstance(value, dict) else {path: value})
    return out


# --------------------------------------------------------------------------
# Box arithmetic (torchvision's ops.boxes and BoxCoder).


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.max(a[:, None, :2], b[None, :, :2])
    rb = torch.min(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def decode(deltas: torch.Tensor, boxes: torch.Tensor, weights) -> torch.Tensor:
    wx, wy, ww, wh = weights
    widths = boxes[:, 2] - boxes[:, 0]
    heights = boxes[:, 3] - boxes[:, 1]
    ctr_x = boxes[:, 0] + 0.5 * widths
    ctr_y = boxes[:, 1] + 0.5 * heights
    dx, dy = deltas[:, 0] / wx, deltas[:, 1] / wy
    dw = torch.clamp(deltas[:, 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(deltas[:, 3] / wh, max=BBOX_XFORM_CLIP)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h], dim=1)


def clip(boxes: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return torch.stack([boxes[:, 0].clamp(0, width), boxes[:, 1].clamp(0, height),
                        boxes[:, 2].clamp(0, width), boxes[:, 3].clamp(0, height)], dim=1)


def large_enough(boxes: torch.Tensor) -> torch.Tensor:
    """Departure 4: both sides above ``SMALL_BOX``."""
    return (boxes[:, 2] - boxes[:, 0] > SMALL_BOX) & (boxes[:, 3] - boxes[:, 1] > SMALL_BOX)


def stable_order(scores: torch.Tensor) -> torch.Tensor:
    """Departure 3: descending, ties to the lower index."""
    return torch.sort(scores, descending=True, stable=True).indices


def nms(boxes: torch.Tensor, scores: torch.Tensor, threshold: float) -> torch.Tensor:
    """Greedy NMS: the indices of the kept boxes, best first.  In score
    order, a box is kept unless a kept box before it overlaps it at an IoU
    above ``threshold``."""
    order = stable_order(scores)
    over = (box_iou(boxes[order], boxes[order]) > threshold).cpu().numpy()
    suppressed = np.zeros(len(order), dtype=bool)
    kept = []
    for i in range(len(order)):
        if suppressed[i]:
            continue
        kept.append(i)
        suppressed |= over[i]
    return order[torch.as_tensor(kept, dtype=torch.long, device=order.device)]


def anchors(shapes: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """torchvision's AnchorGenerator for levels of (H, W) ``shapes``: per
    level (H W A, 4), position-major, at the level's stride (departure
    6)."""
    made = []
    for (h, w), size, stride in zip(shapes, ANCHOR_SIZES, STRIDES):
        ratios = torch.tensor(ASPECT_RATIOS, dtype=torch.float32)
        h_ratios = torch.sqrt(ratios)
        w_ratios = 1 / h_ratios
        ws = (w_ratios[:, None] * torch.tensor([float(size)])[None, :]).view(-1)
        hs = (h_ratios[:, None] * torch.tensor([float(size)])[None, :]).view(-1)
        base = (torch.stack([-ws, -hs, ws, hs], dim=1) / 2).round()
        shifts_x = torch.arange(0, w, dtype=torch.int32) * stride
        shifts_y = torch.arange(0, h, dtype=torch.int32) * stride
        sy, sx = torch.meshgrid(shifts_y, shifts_x, indexing="ij")
        sx, sy = sx.reshape(-1), sy.reshape(-1)
        shifts = torch.stack((sx, sy, sx, sy), dim=1)
        made.append((shifts.view(-1, 1, 4) + base.view(1, -1, 4)).reshape(-1, 4))
    return made


def roi_align(feature: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
              shift: float = 0.0) -> torch.Tensor:
    """torchvision's ``roi_align`` (aligned False, sampling ratio 2) of
    boxes (K, 4) on one level (1, C, H, W): (K, C, 7, 7); ``shift`` moves
    every sample by that share of a bin down and right (a planted fault;
    0 in the reference)."""
    _, c, height, width = feature.shape
    k, grid, out = len(boxes), SAMPLING_RATIO, ROI_SIZE
    start_x, start_y = boxes[:, 0] * spatial_scale, boxes[:, 1] * spatial_scale
    roi_w = (boxes[:, 2] * spatial_scale - start_x).clamp(min=1.0)
    roi_h = (boxes[:, 3] * spatial_scale - start_y).clamp(min=1.0)
    bin_w, bin_h = roi_w / out, roi_h / out
    p = torch.arange(out, dtype=torch.float32, device=boxes.device).repeat_interleave(grid)
    i = torch.arange(grid, dtype=torch.float32, device=boxes.device).repeat(out)
    ys = (start_y[:, None] + p * bin_h[:, None] + (i + 0.5) * bin_h[:, None] / grid
          + shift * bin_h[:, None])  # (K, 14)
    xs = (start_x[:, None] + p * bin_w[:, None] + (i + 0.5) * bin_w[:, None] / grid
          + shift * bin_w[:, None])
    y = ys[:, :, None].expand(k, out * grid, out * grid).clamp(min=0)
    x = xs[:, None, :].expand(k, out * grid, out * grid).clamp(min=0)  # departure 7
    y_low, x_low = y.long(), x.long()
    y_top, x_top = y_low >= height - 1, x_low >= width - 1
    y_low = torch.where(y_top, height - 1, y_low)
    x_low = torch.where(x_top, width - 1, x_low)
    y_high = torch.where(y_top, height - 1, y_low + 1)
    x_high = torch.where(x_top, width - 1, x_low + 1)
    y = torch.where(y_top, y_low.float(), y)
    x = torch.where(x_top, x_low.float(), x)
    ly, lx = y - y_low, x - x_low
    hy, hx = 1.0 - ly, 1.0 - lx
    flat = feature[0].reshape(c, -1)

    def at(rows, cols):
        return flat[:, rows * width + cols]  # (C, K, 14, 14)

    value = (hy * hx * at(y_low, x_low) + hy * lx * at(y_low, x_high)
             + ly * hx * at(y_high, x_low) + ly * lx * at(y_high, x_high))
    pooled = value.reshape(c, k, out, grid, out, grid).sum(dim=(3, 5)) / (grid * grid)
    return pooled.permute(1, 0, 2, 3)


# --------------------------------------------------------------------------
# The detector.


@contextlib.contextmanager
def float32_products():
    """Convolutions and products in float32, TF32 off, as they were after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Detector:
    """The detector holding ``variables`` (the converted layout) on
    ``device``; ``sequence(frames)`` detects in each (H, W, 3) frame in
    [0, 1].  ``variant`` is the reference by default."""

    def __init__(self, variables: dict, device, settings: Optional[Settings] = None,
                 variant: Variant = REFERENCE):
        self.device = torch.device(device)
        self.settings = settings or Settings()
        self.variant = variant
        self.p: Dict[str, torch.Tensor] = {}
        for path, value in _flat(variables["params"]).items():
            tensor = torch.as_tensor(value, dtype=torch.float32, device=self.device)
            if path.endswith("kernel") and tensor.dim() == 4:
                tensor = tensor.permute(3, 2, 0, 1)  # HWIO -> OIHW
            self.p[path] = tensor.contiguous()
        self._anchors: Dict[tuple, List[torch.Tensor]] = {}

    # Operations whose operands and result the control rounds.

    def _round(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return x.to(torch.bfloat16).float() if self.variant.bf16 and x is not None else x

    def conv(self, x: torch.Tensor, path: str, stride: int = 1, padding: int = 0):
        out = F.conv2d(self._round(x), self._round(self.p[f"{path}/kernel"]),
                       self._round(self.p.get(f"{path}/bias")), stride, padding)
        return self._round(out)

    def dense(self, x: torch.Tensor, path: str) -> torch.Tensor:
        out = self._round(x) @ self._round(self.p[f"{path}/kernel"])
        return self._round(self._round(out) + self._round(self.p[f"{path}/bias"]))

    def frozen_bn(self, x: torch.Tensor, path: str) -> torch.Tensor:
        scale = self.p[f"{path}/scale"] * torch.rsqrt(self.p[f"{path}/var"] + BN_EPS)
        shift = self.p[f"{path}/bias"] - self.p[f"{path}/mean"] * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]

    # The transform.

    def geometry(self, height: int, width: int) -> Tuple[float, int, int]:
        """(scale, resized height, resized width); departure 1."""
        s = self.settings
        scale = min(s.min_size / min(height, width), s.max_size / max(height, width))
        return scale, int(round(height * scale)), int(round(width * scale))

    def padded_size(self, height: int, width: int) -> Tuple[int, int]:
        _, h, w = self.geometry(height, width)
        return h + -h % 32, w + -w % 32

    def transform(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) in [0, 1] -> (1, 3, H', W') normalised, resized, padded
        to multiples of 32 with zeros."""
        mean = torch.tensor(IMAGENET_MEAN, device=image.device)
        std = torch.tensor(IMAGENET_STD, device=image.device)
        x = ((image - mean) / std).permute(2, 0, 1)[None]
        _, h, w = self.geometry(image.shape[0], image.shape[1])
        x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
        return F.pad(x, (0, -w % 32, 0, -h % 32))

    # The networks.

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The FPN's P2..P6 of a transformed (1, 3, H', W') image."""
        x = F.relu(self.frozen_bn(self.conv(x, "body/conv1", 2, 3), "body/bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for stage, (_, blocks, stride) in enumerate(RESNET50_STAGES):
            for b in range(blocks):
                path, s = f"body/layer{stage + 1}_{b}", stride if b == 0 else 1
                out = F.relu(self.frozen_bn(self.conv(x, f"{path}/conv1"), f"{path}/bn1"))
                out = F.relu(self.frozen_bn(self.conv(out, f"{path}/conv2", s, 1),
                                            f"{path}/bn2"))
                out = self.frozen_bn(self.conv(out, f"{path}/conv3"), f"{path}/bn3")
                shortcut = (self.frozen_bn(self.conv(x, f"{path}/downsample_conv", s),
                                           f"{path}/downsample_bn") if b == 0 else x)
                x = F.relu(out + shortcut)
            feats.append(x)
        last = self.conv(feats[-1], f"fpn/inner_{len(feats) - 1}")
        levels = [self.conv(last, f"fpn/layer_{len(feats) - 1}", 1, 1)]
        for i in range(len(feats) - 2, -1, -1):
            lateral = self.conv(feats[i], f"fpn/inner_{i}")
            top_down = F.interpolate(last, size=lateral.shape[-2:], mode="nearest")
            last = lateral if i == 0 and not self.variant.p2_top_down else lateral + top_down
            levels.insert(0, self.conv(last, f"fpn/layer_{i}", 1, 1))
        return levels + [F.max_pool2d(levels[-1], 1, 2, 0)]  # LastLevelMaxPool

    def rpn_features(self, level: torch.Tensor) -> torch.Tensor:
        """The RPN head's shared 3x3 convolution and ReLU on one level."""
        return F.relu(self.conv(level, "rpn_head/conv", 1, 1))

    def rpn_head(self, level: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self.rpn_features(level)
        return self.conv(t, "rpn_head/cls_logits"), self.conv(t, "rpn_head/bbox_pred")

    def box_features(self, roi_features: torch.Tensor) -> torch.Tensor:
        """(K, C, 7, 7) -> ``fc7``'s (K, 1024); the features flattened in
        (h, w, c) order, as ``fc6``'s rows are."""
        x = roi_features.permute(0, 2, 3, 1).reshape(roi_features.shape[0], -1)
        return F.relu(self.dense(F.relu(self.dense(x, "box_head/fc6")), "box_head/fc7"))

    def box_head(self, roi_features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(K, C, 7, 7) -> class logits (K, 91), box deltas (K, 364)."""
        x = self.box_features(roi_features)
        return self.dense(x, "box_head/cls_score"), self.dense(x, "box_head/bbox_pred")

    # The region proposals.

    def anchors(self, shapes: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        key = tuple(shapes)
        if key not in self._anchors:
            self._anchors[key] = [a.to(self.device) for a in anchors(shapes)]
        return self._anchors[key]

    def proposals(self, levels: Sequence[torch.Tensor], height: int, width: int
                  ) -> torch.Tensor:
        """The RPN's proposals (K, 4), best first: per level the best
        anchors, decoded, clipped, the small ones dropped, NMS; then the
        best over the levels."""
        s = self.settings
        shapes = [tuple(level.shape[-2:]) for level in levels]
        boxes, scores = [], []
        for level, anchor in zip(levels, self.anchors(shapes)):
            logits, deltas = self.rpn_head(level)
            a, (h, w) = logits.shape[1], logits.shape[-2:]
            probabilities = torch.sigmoid(logits.permute(0, 2, 3, 1).reshape(-1))
            deltas = deltas.view(1, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(-1, 4)
            top = stable_order(probabilities)[:min(s.rpn_pre_nms_top_n, len(probabilities))]
            level_boxes = clip(decode(deltas[top], anchor[top], RPN_WEIGHTS), height, width)
            level_scores = probabilities[top]
            valid = large_enough(level_boxes)
            level_boxes, level_scores = level_boxes[valid], level_scores[valid]
            kept = torch.sort(nms(level_boxes, level_scores, s.rpn_nms_thresh)).values
            boxes.append(level_boxes[kept])
            scores.append(level_scores[kept])
        boxes, scores = torch.cat(boxes), torch.cat(scores)
        return boxes[stable_order(scores)[:s.rpn_post_nms_top_n]]

    def multiscale_roi_align(self, levels: Sequence[torch.Tensor], boxes: torch.Tensor,
                             height: int, width: int) -> torch.Tensor:
        """torchvision's MultiScaleRoIAlign over P2..P5: each box at the
        level of the FPN paper's eq. 1, the levels' scales inferred from
        their sizes against the resized image's."""
        scales = [2.0 ** round(math.log2(level.shape[-2] / height)) for level in levels]
        k_min, k_max = -math.log2(scales[0]), -math.log2(scales[-1])
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        target = torch.floor(CANONICAL_LEVEL + torch.log2(torch.sqrt(area) / CANONICAL_SCALE)
                             + LEVEL_EPS)
        index = (target.clamp(min=k_min, max=k_max) - k_min).long()
        out = torch.zeros(len(boxes), levels[0].shape[1], ROI_SIZE, ROI_SIZE,
                          device=boxes.device)
        for i, (level, scale) in enumerate(zip(levels, scales)):
            chosen = torch.nonzero(index == i).flatten()
            if len(chosen):
                out[chosen] = roi_align(level, boxes[chosen], scale, self.variant.roi_shift)
        return out

    # One frame.

    def stages(self, image: torch.Tensor, rois: Optional[torch.Tensor] = None) -> Stages:
        """One (H, W, 3) frame's FPN levels, and the box head's class
        logits and person box deltas on ``rois`` (the RPN's own where none
        are given)."""
        _, height, width = self.geometry(image.shape[0], image.shape[1])
        levels = self.features(self.transform(image))
        if rois is None:
            rois = self.proposals(levels, height, width)
        logits, deltas = self.box_head(self.multiscale_roi_align(levels[:4], rois, height,
                                                                 width))
        return Stages(levels=[level[0] for level in levels], rois=rois, logits=logits,
                      deltas=deltas.reshape(len(rois), NUM_CLASSES, 4)[:, PERSON])  # dep. 5

    def _box_stage(self, image: torch.Tensor):
        """(the class logits, the person boxes in the resized image) of one
        (H, W, 3) frame, and its scale."""
        scale, height, width = self.geometry(image.shape[0], image.shape[1])
        found = self.stages(image)
        return found.logits, clip(decode(found.deltas, found.rois, BOX_WEIGHTS), height,
                                  width), scale

    def frame(self, image: torch.Tensor) -> Detections:
        s = self.settings
        logits, boxes, scale = self._box_stage(image)
        scores = torch.softmax(logits, dim=-1)[:, PERSON]
        keep = (scores > s.box_score_thresh) & large_enough(boxes)
        boxes, scores = boxes[keep], scores[keep]
        threshold = self.variant.box_nms_thresh or s.box_nms_thresh
        kept = nms(boxes, scores, threshold)[:s.box_detections_per_img]
        return Detections(boxes=(boxes[kept] / scale).cpu().numpy(),  # departure 2
                          scores=scores[kept].cpu().numpy())

    def sequence(self, frames) -> List[Detections]:
        """Detections of each (H, W, 3) frame in [0, 1] of ``frames``, one
        frame at a time."""
        with torch.no_grad(), float32_products():
            return [self.frame(torch.as_tensor(np.asarray(f, np.float32), device=self.device))
                    for f in frames]


# --------------------------------------------------------------------------
# The Tennis evaluation's choice of the player (a plain copy).


def on_court(box, width: int, height: int, rules: dict) -> bool:
    x1, y1, x2, _ = box
    ulx, uly = rules["upper_left"]
    if x2 <= ulx * width and y1 <= uly * height:
        return False
    urx, ury = rules["upper_right"]
    if x1 >= urx * width and y1 <= ury * height:
        return False
    return not y1 > rules["max_top"] * height


def player_center(boxes: Sequence[tuple], width: int, height: int, rules: dict
                  ) -> Tuple[float, float]:
    """The centre of the tallest box on the court, else (-1, -1)."""
    matches = [(b[3] - b[1], b) for b in boxes if on_court(b, width, height, rules)]
    if not matches:
        return (-1.0, -1.0)
    matches.sort(key=lambda m: m[0])
    box = matches[-1][1]
    return ((box[0] + box[2]) / 2.0, (box[1] + box[3]) / 2.0)


def player_centers(detections: Sequence[Detections], width: int, height: int,
                   settings: Settings) -> np.ndarray:
    """(T, 2): each frame's player centre from its boxes above the
    settings' person threshold."""
    return np.array([player_center(d.above(settings.person_threshold), width, height,
                                   settings.court_filter) for d in detections])

