"""Host-side post-processing of model outputs (a copy of
``virconv_tpu/utils/postprocess.py`` that also takes torch tensors).

Parity target ``pcdet/models/detectors/
detector3d_template.py:230-305``: by default (WBF=True) only a score
threshold is applied in this step and the WBF flags are packed for the
dataset's prediction generator, which clusters on host; the NMS path uses
class-agnostic rotated NMS.
"""

from __future__ import annotations

import numpy as np

from ..ops import boxes_np


def _np(x):
    if x is None or isinstance(x, np.ndarray):
        return x
    return x.detach().cpu().numpy()


def post_process_batch(model_out, post_cfg, num_class):
    """Convert padded device outputs into per-sample prediction dicts."""
    boxes = _np(model_out['batch_box_preds'])              # (B, N, 7)
    cls = _np(model_out['batch_cls_preds'])                # (B, N, C)
    valid = _np(model_out.get('roi_valid'))
    scores = 1.0 / (1.0 + np.exp(-cls))
    use_wbf = post_cfg.get('WBF', True)

    pred_dicts = []
    for b in range(boxes.shape[0]):
        score_b = scores[b].max(-1)
        label_b = scores[b].argmax(-1) + 1
        box_b = boxes[b]
        mask = np.isfinite(score_b)
        if valid is not None:
            mask &= valid[b] if valid.ndim == 2 else valid
        if use_wbf:
            mask &= score_b > post_cfg.SCORE_THRESH
            record = {
                'pred_boxes': box_b[mask],
                'pred_scores': score_b[mask],
                'pred_labels': label_b[mask],
                'WBF': True,
                'IoU': post_cfg.get('IoU', 0.85),
                'RL': post_cfg.get('RL', False),
                'SCORE_THRESH': post_cfg.get('SCORE_THRESH', 0.4),
            }
        else:
            nms_cfg = post_cfg.NMS_CONFIG
            m = score_b > post_cfg.SCORE_THRESH
            idx = np.nonzero(m & mask)[0]
            keep = boxes_np.nms_bev(
                box_b[idx], score_b[idx], nms_cfg.NMS_THRESH,
                pre_max=nms_cfg.NMS_PRE_MAXSIZE,
                post_max=nms_cfg.NMS_POST_MAXSIZE)
            sel = idx[keep]
            record = {'pred_boxes': box_b[sel], 'pred_scores': score_b[sel],
                      'pred_labels': label_b[sel]}
        pred_dicts.append(record)
    return pred_dicts
