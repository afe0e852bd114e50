"""YOLOv2-style detection loss on tensors (differentiable, for QAT) and
VOC mAP@0.5 evaluation of detector head outputs (paper Sec. V), on the host
in numpy: box decoding, per-class NMS and 11-point AP."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.data.detection import ANCHORS
from repro_torch.obs import spans


def decode_head(pred: torch.Tensor, n_anchors: int, n_classes: int
                ) -> Dict[str, torch.Tensor]:
    """[B,gh,gw,A*(5+C)] -> dict of txy (sigmoid), twh, obj and cls
    logits."""
    B, gh, gw, _ = pred.shape
    p = pred.reshape(B, gh, gw, n_anchors, 5 + n_classes)
    return {"txy": torch.sigmoid(p[..., 0:2]), "twh": p[..., 2:4],
            "obj": p[..., 4], "cls": p[..., 5:]}


def yolo_loss(pred: torch.Tensor, targets: Dict[str, torch.Tensor],
              n_anchors: int, n_classes: int, lambda_coord: float = 5.0,
              lambda_noobj: float = 0.5
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"coord", "obj", "cls"}) per positive anchor: squared error
    on sigmoid offsets and sqrt sizes, objectness BCE (no-object terms
    weighted by `lambda_noobj`) and class NLL, summed over the batch and
    divided by max(positives, 1).  `targets` are `yolo_targets`' arrays as
    tensors on pred's device."""
    d = decode_head(pred, n_anchors, n_classes)
    obj_t = targets["obj"]                    # [B,gh,gw,A]
    xywh_t = targets["txywh"]                 # [B,gh,gw,A,4]
    cls_t = targets["cls"]                    # [B,gh,gw,A]

    anchors = torch.as_tensor(ANCHORS[:n_anchors], dtype=torch.float32,
                              device=pred.device)
    wh_pred = anchors * torch.exp(torch.clamp(d["twh"], -4.0, 4.0))
    xy_loss = torch.sum(torch.square(d["txy"] - xywh_t[..., 0:2]), -1)
    wh_loss = torch.sum(torch.square(torch.sqrt(wh_pred + 1e-9)
                                     - torch.sqrt(xywh_t[..., 2:4] + 1e-9)),
                        -1)
    coord = lambda_coord * torch.sum(obj_t * (xy_loss + wh_loss))

    logit = d["obj"]
    # at a zero logit (a cell whose pooled activations are all 0) the
    # reference's max(x, 0) splits its gradient and its |x| has slope 1:
    # torch.maximum does the first, the where the second (torch.abs: 0)
    abs_logit = torch.where(logit >= 0, logit, -logit)
    bce = (torch.maximum(logit, torch.zeros_like(logit)) - logit * obj_t
           + torch.log1p(torch.exp(-abs_logit)))
    obj_loss = (torch.sum(obj_t * bce)
                + lambda_noobj * torch.sum((1 - obj_t) * bce))

    logp = torch.log_softmax(d["cls"], dim=-1)
    cls_nll = -torch.gather(logp, -1, cls_t[..., None].long())[..., 0]
    cls_loss = torch.sum(obj_t * cls_nll)

    n_pos = torch.clamp(torch.sum(obj_t), min=1.0)
    total = (coord + obj_loss + cls_loss) / n_pos
    return total, {"coord": coord / n_pos, "obj": obj_loss / n_pos,
                   "cls": cls_loss / n_pos}


# ------------------------------------------------------------------ mAP

def _decode_boxes(pred: np.ndarray, n_anchors: int, n_classes: int,
                  conf_thresh: float = 0.1):
    """One image's head output -> (boxes [n,4] cx cy w h, scores, classes)."""
    gh, gw, _ = pred.shape
    p = pred.reshape(gh, gw, n_anchors, 5 + n_classes)
    txy = 1 / (1 + np.exp(-p[..., 0:2]))
    twh = np.clip(p[..., 2:4], -4, 4)
    wh = ANCHORS[:n_anchors] * np.exp(twh)
    obj = 1 / (1 + np.exp(-p[..., 4]))
    cls_prob = np.exp(p[..., 5:] - p[..., 5:].max(-1, keepdims=True))
    cls_prob /= cls_prob.sum(-1, keepdims=True)
    gy, gx = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    cx = (gx[..., None] + txy[..., 0]) / gw
    cy = (gy[..., None] + txy[..., 1]) / gh
    conf = obj[..., None] * cls_prob
    boxes, scores, classes = [], [], []
    for c in range(n_classes):
        m = conf[..., c] > conf_thresh
        if not m.any():
            continue
        boxes.append(np.stack([cx[m], cy[m], wh[..., 0][m], wh[..., 1][m]], -1))
        scores.append(conf[..., c][m])
        classes.append(np.full(int(m.sum()), c))
    if not boxes:
        return (np.zeros((0, 4), np.float32), np.zeros(0, np.float32),
                np.zeros(0, np.int64))
    return np.concatenate(boxes), np.concatenate(scores), np.concatenate(classes)


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between [n,4] and [m,4] (cx,cy,w,h)."""
    ax0, ay0 = a[:, 0] - a[:, 2] / 2, a[:, 1] - a[:, 3] / 2
    ax1, ay1 = a[:, 0] + a[:, 2] / 2, a[:, 1] + a[:, 3] / 2
    bx0, by0 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
    bx1, by1 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
    ix = np.maximum(0, np.minimum(ax1[:, None], bx1) -
                    np.maximum(ax0[:, None], bx0))
    iy = np.maximum(0, np.minimum(ay1[:, None], by1) -
                    np.maximum(ay0[:, None], by0))
    inter = ix * iy
    area_a = (ax1 - ax0) * (ay1 - ay0)
    area_b = (bx1 - bx0) * (by1 - by0)
    return inter / (area_a[:, None] + area_b - inter + 1e-9)


def _nms(boxes, scores, thresh=0.45):
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        ious = _iou(boxes[i:i + 1], boxes[order[1:]])[0]
        order = order[1:][ious < thresh]
    return np.asarray(keep, np.int64)


def _count_boxes(passed: int, kept: int) -> None:
    """One decoded image's boxes above the confidence threshold and after
    NMS, counted on the enclosing span while a profiler trace runs."""
    if spans.spans_on():
        spans.count("images")
        spans.count("boxes_passed", passed)
        spans.count("boxes_kept", kept)


def decode_detections(pred: np.ndarray, n_anchors: int, n_classes: int,
                      conf_thresh: float = 0.1, nms_thresh: float = 0.45):
    """One image's head output -> per-class-NMS'd detections.

    Returns (boxes [n,4] cx cy w h as image fractions, scores, classes),
    sorted by descending score — the same decode + suppression `evaluate_map`
    applies before AP matching, exposed for callers that want the boxes
    themselves (the serving engine's response payload)."""
    boxes, scores, classes = _decode_boxes(pred, n_anchors, n_classes,
                                           conf_thresh)
    keep_parts = []
    for c in np.unique(classes):
        idx = np.nonzero(classes == c)[0]
        keep_parts.append(idx[_nms(boxes[idx], scores[idx], nms_thresh)])
    if not keep_parts:
        _count_boxes(0, 0)
        return boxes, scores, classes                 # already empty
    keep = np.concatenate(keep_parts)
    _count_boxes(scores.size, keep.size)
    keep = keep[np.argsort(-scores[keep])]
    return boxes[keep], scores[keep], classes[keep]


def evaluate_map(preds: np.ndarray, gt_boxes: List[np.ndarray],
                 gt_classes: List[np.ndarray], n_anchors: int,
                 n_classes: int, iou_thresh: float = 0.5) -> float:
    """VOC-style mAP@0.5 over a batch of head outputs."""
    det = {c: [] for c in range(n_classes)}   # (score, img, box)
    n_gt = {c: 0 for c in range(n_classes)}
    for c_list in gt_classes:
        for c in c_list:
            n_gt[int(c)] += 1
    for i, pred in enumerate(preds):
        boxes, scores, classes = _decode_boxes(pred, n_anchors, n_classes)
        kept = 0
        for c in range(n_classes):
            m = classes == c
            if not m.any():
                continue
            b, s = boxes[m], scores[m]
            keep = _nms(b, s)
            kept += keep.size
            for k in keep:
                det[c].append((float(s[k]), i, b[k]))
        _count_boxes(scores.size, kept)
    aps = []
    for c in range(n_classes):
        if n_gt[c] == 0:
            continue
        entries = sorted(det[c], key=lambda e: -e[0])
        matched = [np.zeros(len(gb), bool) for gb in gt_boxes]
        tp = np.zeros(len(entries))
        fp = np.zeros(len(entries))
        for j, (score, img, box) in enumerate(entries):
            gmask = gt_classes[img] == c
            if not gmask.any():
                fp[j] = 1
                continue
            gb = gt_boxes[img][gmask]
            ious = _iou(box[None], gb)[0]
            best = int(np.argmax(ious))
            gidx = np.where(gmask)[0][best]
            if ious[best] >= iou_thresh and not matched[img][gidx]:
                tp[j] = 1
                matched[img][gidx] = True
            else:
                fp[j] = 1
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / n_gt[c]
        precision = ctp / np.maximum(ctp + cfp, 1e-9)
        ap = 0.0
        for r in np.linspace(0, 1, 11):
            p = precision[recall >= r].max() if (recall >= r).any() else 0.0
            ap += p / 11
        aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0


def evaluate_map_per_chip(preds, gt_boxes: List[np.ndarray],
                          gt_classes: List[np.ndarray], n_anchors: int,
                          n_classes: int, iou_thresh: float = 0.5
                          ) -> np.ndarray:
    """[chips, B, gh, gw, A*(5+C)] head outputs -> [chips] mAP@0.5.

    The host-side metric callback of the chip-ensemble MC engine: NMS and AP
    are not array programs, so each chunk's predictions come back to the host
    and every chip's mAP folds into the streaming Welford/quantile
    accumulators (Table II's actual metric over a chip population).  While
    a profiler trace runs it is a `score_map` span (`chips`) that counts
    the `images` decoded, their `boxes_passed` (above the confidence
    threshold) and `boxes_kept` (after NMS).
    """
    preds = np.asarray(preds)
    with spans.span("score_map", chips=len(preds)):
        return np.array([evaluate_map(p, gt_boxes, gt_classes, n_anchors,
                                      n_classes, iou_thresh) for p in preds],
                        np.float32)
