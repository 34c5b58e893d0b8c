"""Weighted Box Fusion (host-side, numpy).

Parity target ``pcdet/models/model_utils/
model_nms_utils.py:14-123`` (``compute_WBF``): greedy IoU clustering of
score-sorted boxes, mean box with circular-mean heading per cluster, max
score, and the "retain low" rules that keep mid-IoU boxes at the score
threshold. The reference runs this on CPU numpy too.

The cluster IoU is the numpy one of ``ops/boxes_np.py``.
"""

from __future__ import annotations

import numpy as np

from . import boxes_np


def limit(ang):
    ang = ang % (2 * np.pi)
    ang = np.where(ang > np.pi, ang - 2 * np.pi, ang)
    ang = np.where(ang < -np.pi, ang + 2 * np.pi, ang)
    return ang


def compute_wbf(det_names, det_scores, det_boxes, iou_thresh=0.85,
                iou_thresh2=0.1, fusion='mean', retain_low=False,
                score_thresh=0.4):
    if len(det_names) == 0:
        return det_names, det_scores, det_boxes

    order = det_scores.argsort()[::-1]
    det_scores = det_scores[order]
    det_names = det_names[order]
    det_boxes = det_boxes[order].astype(np.float64)
    det_boxes[:, 6] = limit(det_boxes[:, 6])

    cluster_boxes = []     # list of list of boxes
    cluster_scores = []
    cluster_merged = []    # representative box per cluster
    cluster_names = []
    out_boxes, out_scores, out_names = [], [], []

    for i, box in enumerate(det_boxes):
        score, name = det_scores[i], det_names[i]
        if i == 0:
            cluster_boxes.append([box])
            cluster_scores.append([score])
            cluster_merged.append(box.copy())
            cluster_names.append(name)
            continue
        merged = np.asarray(cluster_merged).reshape(-1, 7)
        ious = boxes_np.boxes_iou_bev(box[None, :7], merged[:, :7])[0]
        argmax = int(np.argmax(ious))
        max_iou = float(np.max(ious))
        if max_iou >= iou_thresh:
            cluster_boxes[argmax].append(box)
            cluster_scores[argmax].append(score)
        elif iou_thresh2 <= max_iou < iou_thresh and score > score_thresh \
                and retain_low:
            if np.max(cluster_scores[argmax]) - score < 0.2:
                out_scores.append(score_thresh)
                out_boxes.append(box)
                out_names.append(name)
        elif 0.03 <= max_iou < iou_thresh2 and retain_low:
            continue
        elif (not retain_low) and 0.03 <= max_iou < iou_thresh:
            continue
        else:
            cluster_boxes.append([box])
            cluster_scores.append([score])
            cluster_merged.append(box.copy())
            cluster_names.append(name)

    for i in range(len(cluster_merged)):
        if fusion == 'mean':
            boxes = np.asarray(cluster_boxes[i])
            merged = cluster_merged[i]
            mean_box = boxes.mean(axis=0)
            merged[:6] = mean_box[:6]
            angles = limit(boxes[:, 6])
            res = limit(angles - merged[6])
            res = res[np.abs(res) < 1.5]
            if len(res):
                merged[6] = merged[6] + res.mean()
            out_scores.append(np.max(cluster_scores[i]))
            out_boxes.append(merged)
            out_names.append(cluster_names[i])
        else:
            out_scores.append(np.max(cluster_scores[i]))
            out_boxes.append(cluster_merged[i])
            out_names.append(cluster_names[i])

    return (np.asarray(out_names), np.asarray(out_scores),
            np.asarray(out_boxes))
