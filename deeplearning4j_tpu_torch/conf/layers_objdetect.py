"""Object detection: the YOLOv2 output layer and the detection utilities.

Reference: ``org.deeplearning4j.nn.conf.layers.objdetect.Yolo2OutputLayer``
(conf) / ``org.deeplearning4j.nn.layers.objdetect.Yolo2OutputLayer`` (loss),
``YoloUtils`` (activation and NMS), ``DetectedObject``; the JAX package's
``conf/layers_objdetect.py`` (fields, ``@type`` tag, loss and utilities).

Layouts:

- the activations INTO the layer: a logical NCHW image ``[b, nBoxes*(5+C),
  H, W]`` in ``channels_last`` memory, the channels packed anchor-major
  (``box * (5 + C) + k``: tx, ty, tw, th, to, then C class logits), the
  JAX package's last axis. The layer works on the NHWC view, which is the
  memory order, so its arithmetic is the JAX package's step for step.
- labels: ``[b, H, W, 4+C]`` as in the JAX package: per grid cell x1, y1,
  x2, y2 of the ground-truth box IN GRID UNITS (cell size 1) for the cell
  holding the box centre, then the one-hot class; all zero for a cell
  without an object.

Loss (reference ``Yolo2OutputLayer#computeBackpropGradientAndScore``):
position (sigmoid centres and square-root sizes, weight ``lambda_coord``),
confidence (the predicted IOU for the responsible anchor as a constant
target, ``lambda_no_obj`` elsewhere), class probabilities (L2 on the
softmax). The responsible anchor of a labelled cell is the prior of best
shape-IOU with the truth box.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf.layers import Layer


@serde.register
@dataclasses.dataclass
class Yolo2OutputLayer(Layer):
    """YOLOv2 loss head. ``boxes``: anchor priors ``((w, h), ...)`` in grid
    units (reference ``boundingBoxePriors``)."""

    boxes: Tuple[Tuple[float, float], ...] = ()
    lambda_coord: float = 5.0
    lambda_no_obj: float = 0.5

    def __post_init__(self):
        if not self.boxes:
            raise ValueError("Yolo2OutputLayer needs anchor box priors")
        self.boxes = tuple(tuple(float(v) for v in b) for b in self.boxes)

    @property
    def n_boxes(self) -> int:
        return len(self.boxes)

    def _classes(self, channels: int) -> int:
        per = channels // self.n_boxes
        c = per - 5
        if per * self.n_boxes != channels or c < 1:
            raise ValueError(
                f"input depth {channels} != nBoxes({self.n_boxes}) * "
                f"(5 + C) for a positive class count C")
        return c

    def output_type(self, input_type):
        return input_type

    def _decode(self, x):
        """``x``: the NHWC view ``[b, h, w, nb*(5+C)]``. Returns (centre xy
        ``[b,h,w,nb,2]`` in absolute grid units, wh ``[b,h,w,nb,2]``,
        confidence ``[b,h,w,nb]``, class probabilities ``[b,h,w,nb,C]``)."""
        b, h, w, ch = x.shape
        c = self._classes(ch)
        x = x.reshape(b, h, w, self.n_boxes, 5 + c)
        cy = torch.arange(h, dtype=x.dtype, device=x.device)[None, :, None,
                                                             None]
        cx = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, :,
                                                             None]
        sig = torch.sigmoid(x[..., 0:2])
        center = torch.stack([sig[..., 0] + cx, sig[..., 1] + cy], dim=-1)
        priors = torch.tensor(self.boxes, dtype=x.dtype, device=x.device)
        wh = priors * torch.exp(x[..., 2:4])
        conf = torch.sigmoid(x[..., 4])
        probs = torch.softmax(x[..., 5:], dim=-1)
        return center, wh, conf, probs

    def forward(self, params, state, x, train=False, gen=None):
        """Inference output (reference ``YoloUtils.activate``): per anchor
        x, y as absolute grid coordinates, w, h in grid units, the sigmoid
        confidence and the softmax classes, packed as the input is."""
        center, wh, conf, probs = self._decode(x.permute(0, 2, 3, 1))
        out = torch.cat([center, wh, conf[..., None], probs], dim=-1)
        b, h, w = out.shape[:3]
        return out.reshape(b, h, w, -1).permute(0, 3, 1, 2), state

    def score(self, params, x, labels, mask=None):
        """The YOLOv2 loss, averaged over the examples (over the mask's
        nonzero examples with a labels mask)."""
        x = x.permute(0, 2, 3, 1)
        bsz = x.shape[0]
        labels = torch.as_tensor(labels, dtype=x.dtype, device=x.device)
        truth_xy1 = labels[..., 0:2]
        truth_xy2 = labels[..., 2:4]
        truth_cls = labels[..., 4:]
        obj = ((labels[..., 0:4] != 0.0).sum(-1) > 0).to(x.dtype)
        truth_wh = truth_xy2 - truth_xy1
        truth_center = 0.5 * (truth_xy1 + truth_xy2)

        # responsible anchor: the prior of best shape-IOU with the truth
        priors = torch.tensor(self.boxes, dtype=x.dtype, device=x.device)
        inter = (torch.minimum(truth_wh[..., None, 0], priors[:, 0])
                 * torch.minimum(truth_wh[..., None, 1], priors[:, 1]))
        union = (truth_wh[..., 0] * truth_wh[..., 1])[..., None] \
            + priors[:, 0] * priors[:, 1] - inter
        shape_iou = inter / torch.clamp(union, min=1e-9)
        resp = torch.nn.functional.one_hot(
            shape_iou.argmax(-1), self.n_boxes).to(x.dtype)
        resp = resp * obj[..., None]

        center, wh, conf, probs = self._decode(x)
        d_center = ((center - truth_center[..., None, :]) ** 2).sum(-1)
        d_size = ((torch.sqrt(torch.clamp(wh, min=1e-9))
                   - torch.sqrt(torch.clamp(truth_wh, min=1e-9))[..., None, :]
                   ) ** 2).sum(-1)
        pos_loss = self.lambda_coord * (resp * (d_center + d_size)).sum(
            (1, 2, 3))

        p_xy1 = center - 0.5 * wh
        p_xy2 = center + 0.5 * wh
        ixy1 = torch.maximum(p_xy1, truth_xy1[..., None, :])
        ixy2 = torch.minimum(p_xy2, truth_xy2[..., None, :])
        iwh = torch.clamp(ixy2 - ixy1, min=0.0)
        inter_a = iwh[..., 0] * iwh[..., 1]
        area_p = torch.clamp(wh[..., 0] * wh[..., 1], min=0.0)
        area_t = (truth_wh[..., 0] * truth_wh[..., 1])[..., None]
        iou_t = inter_a / torch.clamp(area_p + area_t - inter_a, min=1e-9)
        iou_t = iou_t.detach()  # a target, as in the reference
        conf_loss = ((resp * (conf - iou_t) ** 2).sum((1, 2, 3))
                     + self.lambda_no_obj
                     * ((1.0 - resp) * conf ** 2).sum((1, 2, 3)))

        cls_loss = (obj[..., None] * ((probs - truth_cls[..., None, :]) ** 2
                                      ).sum(-1)).sum((1, 2, 3))

        per_example = pos_loss + conf_loss + cls_loss
        if mask is not None:
            m = torch.as_tensor(mask, dtype=x.dtype, device=x.device)
            m = m.reshape(bsz, -1)[:, 0]
            return (per_example * m).sum() / torch.clamp(m.sum(), min=1.0)
        return per_example.mean()


@dataclasses.dataclass
class DetectedObject:
    """Reference ``org.deeplearning4j.nn.layers.objdetect.DetectedObject``.
    Coordinates in GRID units; ``top_left`` / ``bottom_right`` times
    (image size / grid size) give pixels."""

    example: int
    center_x: float
    center_y: float
    width: float
    height: float
    predicted_class: int
    confidence: float
    class_probs: np.ndarray = None

    @property
    def top_left(self):
        return (self.center_x - self.width / 2,
                self.center_y - self.height / 2)

    @property
    def bottom_right(self):
        return (self.center_x + self.width / 2,
                self.center_y + self.height / 2)


def get_predicted_objects(layer: Yolo2OutputLayer, activated,
                          threshold: float = 0.5) -> List[DetectedObject]:
    """Detections from the activated grid of ``layer.forward`` as the
    network returns it (NHWC ``[b, H, W, nb*(5+C)]``, numpy or a tensor;
    reference ``YoloUtils.getPredictedObjects``): the anchors whose
    confidence times largest class probability exceeds ``threshold``."""
    if isinstance(activated, torch.Tensor):
        activated = activated.detach().cpu().numpy()
    a = np.asarray(activated)
    b, h, w, ch = a.shape
    nb = layer.n_boxes
    a = a.reshape(b, h, w, nb, ch // nb)
    centers, whs, confs, probs = (a[..., 0:2], a[..., 2:4], a[..., 4],
                                  a[..., 5:])
    score = confs * probs.max(axis=-1)
    out: List[DetectedObject] = []
    for ex, yy, xx, bb in zip(*np.nonzero(score > threshold)):
        out.append(DetectedObject(
            example=int(ex),
            center_x=float(centers[ex, yy, xx, bb, 0]),
            center_y=float(centers[ex, yy, xx, bb, 1]),
            width=float(whs[ex, yy, xx, bb, 0]),
            height=float(whs[ex, yy, xx, bb, 1]),
            predicted_class=int(probs[ex, yy, xx, bb].argmax()),
            confidence=float(score[ex, yy, xx, bb]),
            class_probs=probs[ex, yy, xx, bb].copy()))
    return out


def iou(a: DetectedObject, b: DetectedObject) -> float:
    """Box IOU (reference ``DetectedObject`` / ``YoloUtils``)."""
    ax1, ay1 = a.top_left
    ax2, ay2 = a.bottom_right
    bx1, by1 = b.top_left
    bx2, by2 = b.bottom_right
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return inter / union if union > 0 else 0.0


def nms(objects: List[DetectedObject], iou_threshold: float = 0.45
        ) -> List[DetectedObject]:
    """Non-max suppression per (example, class) (reference
    ``YoloUtils.nms``), most confident first; the kept boxes sorted by
    example, then falling confidence."""
    keep: List[DetectedObject] = []
    by_class = {}
    for o in objects:
        by_class.setdefault((o.example, o.predicted_class), []).append(o)
    for group in by_class.values():
        group = sorted(group, key=lambda o: -o.confidence)
        while group:
            best = group.pop(0)
            keep.append(best)
            group = [o for o in group if iou(best, o) < iou_threshold]
    return sorted(keep, key=lambda o: (o.example, -o.confidence))
