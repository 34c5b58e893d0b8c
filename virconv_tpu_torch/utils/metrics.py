"""Recall records of the eval loop (host numpy). The port's copy of
``compute_recall`` in ``virconv_tpu/utils/metrics.py``."""

from __future__ import annotations

from ..ops import boxes_np


def compute_recall(pred_boxes, gt_boxes, thresh_list=(0.3, 0.5, 0.7)):
    """{'recall_<t>': (gt boxes hit at 3D IoU > t, gt boxes)} of one
    frame."""
    if len(gt_boxes) == 0:
        return {f'recall_{t}': (0, 0) for t in thresh_list}
    if len(pred_boxes) == 0:
        return {f'recall_{t}': (0, len(gt_boxes)) for t in thresh_list}
    best = boxes_np.boxes_iou3d(gt_boxes[:, :7],
                                pred_boxes[:, :7]).max(axis=1)
    return {f'recall_{t}': (int((best > t).sum()), len(gt_boxes))
            for t in thresh_list}
