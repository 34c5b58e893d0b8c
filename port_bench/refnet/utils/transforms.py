"""Invertible world transforms (the reference "X_TRANS" ensemble).

A copy of ``virconv_tpu/utils/transforms.py`` with torch device
variants. Parity target ``pcdet/datasets/augmentor/X_transform.py``:
each transform replica is parameterized by (rotation, flip-flag, scale) and
applied in config order rotation -> flip(y) -> scale; the inverse applies
1/scale -> flip(y) -> rotation(-r) (reversed queue with backward flags).

Both numpy (host input pipeline) and torch (in-model back-projection for
NRConv, roi re-expression in the cascade head) variants are provided.
Params are float arrays ``[rot, flip, scale]``.
"""

from __future__ import annotations

import numpy as np


def get_transform_params(x_trans_cfg, rot_num):
    """Per-replica params from config (X_transform.py:37-47)."""
    names = [c['NAME'] for c in x_trans_cfg.AUG_CONFIG_LIST]
    params = np.zeros((rot_num, len(names)), dtype=np.float32)
    for s in range(rot_num):
        for i, c in enumerate(x_trans_cfg.AUG_CONFIG_LIST):
            if c['NAME'] == 'world_rotation':
                params[s, i] = c['WORLD_ROT_ANGLE'][s]
            elif c['NAME'] == 'world_flip':
                params[s, i] = c['ALONG_AXIS_LIST'][s]
            elif c['NAME'] == 'world_scaling':
                params[s, i] = c['WORLD_SCALE_RANGE'][s]
    return params


# ---------------------------------------------------------------- numpy ----
def _rot_np(xy, angle):
    cosa, sina = np.cos(angle), np.sin(angle)
    x = xy[:, 0] * cosa - xy[:, 1] * sina
    y = xy[:, 0] * sina + xy[:, 1] * cosa
    return np.stack([x, y], -1)


def transform_points_np(points, param, inverse=False):
    """points (N, 3+C); param [rot, flip, scale]."""
    rot, flip, scale = float(param[0]), float(param[1]), float(param[2])
    points = points.copy()
    if not inverse:
        points[:, 0:2] = _rot_np(points[:, 0:2], rot)
        if flip == 1:
            points[:, 1] = -points[:, 1]
        points[:, 0:3] *= scale
    else:
        points[:, 0:3] /= scale
        if flip == 1:
            points[:, 1] = -points[:, 1]
        points[:, 0:2] = _rot_np(points[:, 0:2], -rot)
    return points


def transform_boxes_np(boxes, param, inverse=False):
    """boxes (N, 7+); param [rot, flip, scale]."""
    rot, flip, scale = float(param[0]), float(param[1]), float(param[2])
    boxes = boxes.copy()
    if not inverse:
        boxes[:, 0:2] = _rot_np(boxes[:, 0:2], rot)
        boxes[:, 6] += rot
        if flip == 1:
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 6] = -boxes[:, 6]
        boxes[:, 0:6] *= scale
    else:
        boxes[:, 0:6] /= scale
        if flip == 1:
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 6] = -boxes[:, 6]
        boxes[:, 0:2] = _rot_np(boxes[:, 0:2], -rot)
        boxes[:, 6] -= rot
    return boxes


# ---------------------------------------------------------------- torch ----
def transform_boxes(boxes, param, inverse=False):
    """boxes (N, 7+) tensor, param (3,) tensor [rot, flip, scale]."""
    import torch
    rot, flip, scale = param[0], param[1], param[2]
    sign = torch.where(flip == 1, -1.0, 1.0).to(boxes.dtype)
    if not inverse:
        cosa, sina = torch.cos(rot), torch.sin(rot)
        x = boxes[:, 0] * cosa - boxes[:, 1] * sina
        y = (boxes[:, 0] * sina + boxes[:, 1] * cosa) * sign
        heading = (boxes[:, 6] + rot) * sign
        return torch.cat([torch.stack([x, y], -1) * scale,
                          boxes[:, 2:6] * scale, heading[:, None],
                          boxes[:, 7:]], -1)
    x = boxes[:, 0] / scale
    y = boxes[:, 1] / scale * sign
    rest = boxes[:, 2:6] / scale
    heading = boxes[:, 6] * sign - rot
    cosa, sina = torch.cos(-rot), torch.sin(-rot)
    xr = x * cosa - y * sina
    yr = x * sina + y * cosa
    return torch.cat([torch.stack([xr, yr], -1), rest, heading[:, None],
                      boxes[:, 7:]], -1)
