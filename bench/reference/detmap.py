"""VOC mAP@0.5 of detector head outputs, on the host in NumPy: box
decoding (sigmoid offsets, anchor sizes, objectness times class softmax
above a confidence threshold), per-class NMS at IoU 0.45 and the 11-point
AP, averaged over the classes that have ground truth.  A frozen copy of
the arithmetic the program scores a die with, so that a later change to
the program's scoring is judged against this one."""
from __future__ import annotations

from typing import List

import numpy as np

ANCHORS = np.array([[0.08, 0.12], [0.18, 0.25], [0.35, 0.45],
                    [0.5, 0.3], [0.75, 0.65]], np.float32)  # (w, h)


def decode_boxes(pred: np.ndarray, n_anchors: int, n_classes: int,
                 conf_thresh: float = 0.1):
    """One image's head output [gh, gw, A*(5+C)] -> (boxes [n,4] cx cy w h,
    scores, classes)."""
    gh, gw, _ = pred.shape
    p = pred.reshape(gh, gw, n_anchors, 5 + n_classes)
    txy = 1 / (1 + np.exp(-p[..., 0:2]))
    wh = ANCHORS[:n_anchors] * np.exp(np.clip(p[..., 2:4], -4, 4))
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
        boxes.append(np.stack([cx[m], cy[m], wh[..., 0][m], wh[..., 1][m]],
                              -1))
        scores.append(conf[..., c][m])
        classes.append(np.full(int(m.sum()), c))
    if not boxes:
        return (np.zeros((0, 4), np.float32), np.zeros(0, np.float32),
                np.zeros(0, np.int64))
    return (np.concatenate(boxes), np.concatenate(scores),
            np.concatenate(classes))


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between boxes [n,4] and [m,4] (cx, cy, w, h)."""
    ax0, ay0 = a[:, 0] - a[:, 2] / 2, a[:, 1] - a[:, 3] / 2
    ax1, ay1 = a[:, 0] + a[:, 2] / 2, a[:, 1] + a[:, 3] / 2
    bx0, by0 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
    bx1, by1 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
    ix = np.maximum(0, np.minimum(ax1[:, None], bx1)
                    - np.maximum(ax0[:, None], bx0))
    iy = np.maximum(0, np.minimum(ay1[:, None], by1)
                    - np.maximum(ay0[:, None], by0))
    inter = ix * iy
    area_a = (ax1 - ax0) * (ay1 - ay0)
    area_b = (bx1 - bx0) * (by1 - by0)
    return inter / (area_a[:, None] + area_b - inter + 1e-9)


def nms(boxes: np.ndarray, scores: np.ndarray, thresh: float = 0.45
        ) -> np.ndarray:
    """Indices kept by greedy NMS, highest score first."""
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        ious = iou(boxes[i:i + 1], boxes[order[1:]])[0]
        order = order[1:][ious < thresh]
    return np.asarray(keep, np.int64)


def map50(preds: np.ndarray, gt_boxes: List[np.ndarray],
          gt_classes: List[np.ndarray], n_anchors: int, n_classes: int,
          iou_thresh: float = 0.5) -> float:
    """mAP@0.5 of one die's head outputs [B, gh, gw, A*(5+C)]."""
    det = {c: [] for c in range(n_classes)}
    n_gt = {c: 0 for c in range(n_classes)}
    for c_list in gt_classes:
        for c in c_list:
            n_gt[int(c)] += 1
    for i, pred in enumerate(preds):
        boxes, scores, classes = decode_boxes(pred, n_anchors, n_classes)
        for c in range(n_classes):
            m = classes == c
            if not m.any():
                continue
            b, s = boxes[m], scores[m]
            for k in nms(b, s):
                det[c].append((float(s[k]), i, b[k]))
    aps = []
    for c in range(n_classes):
        if n_gt[c] == 0:
            continue
        entries = sorted(det[c], key=lambda e: -e[0])
        matched = [np.zeros(len(gb), bool) for gb in gt_boxes]
        tp = np.zeros(len(entries))
        fp = np.zeros(len(entries))
        for j, (_, img, box) in enumerate(entries):
            gmask = gt_classes[img] == c
            if not gmask.any():
                fp[j] = 1
                continue
            gb = gt_boxes[img][gmask]
            ious = iou(box[None], gb)[0]
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
            ap += (precision[recall >= r].max() if (recall >= r).any()
                   else 0.0) / 11
        aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0
