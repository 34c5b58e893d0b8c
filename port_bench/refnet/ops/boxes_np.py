"""Host-side numpy twins of the box geometry ops.

Used by the input pipeline (gt-sampling collision tests), WBF clustering and
the KITTI eval metric — all host-side in the reference too. A copy of
``virconv_tpu/ops/boxes_np.py``.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-8


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """points (B, N, 3+C), angle (B,)."""
    cosa, sina = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(angle), np.ones_like(angle)
    rot = np.stack([cosa, sina, zeros,
                    -sina, cosa, zeros,
                    zeros, zeros, ones], axis=1).reshape(-1, 3, 3)
    xyz = np.einsum('bnc,bcd->bnd', points[..., 0:3], rot)
    return np.concatenate([xyz, points[..., 3:]], axis=-1)


def boxes_to_corners_bev(boxes):
    dx, dy = boxes[:, 3], boxes[:, 4]
    template = np.array([[0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5], [0.5, -0.5]])
    corners = template[None] * np.stack([dx, dy], -1)[:, None, :]
    angle = boxes[:, 6]
    cosa, sina = np.cos(angle), np.sin(angle)
    x = corners[..., 0] * cosa[:, None] - corners[..., 1] * sina[:, None]
    y = corners[..., 0] * sina[:, None] + corners[..., 1] * cosa[:, None]
    return np.stack([x, y], -1) + boxes[:, None, 0:2]


def boxes_to_corners_3d(boxes):
    template = np.array([
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
        [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
    ], dtype=np.float64) / 2.0
    corners = boxes[:, None, 3:6] * template[None]
    corners = rotate_points_along_z(corners, boxes[:, 6])
    return corners + boxes[:, None, 0:3]


def _points_in_rects(points, boxes):
    """points (..., 2) vs boxes (M, 7) -> (..., M) bool."""
    d = points[..., None, :] - boxes[:, 0:2]
    cosa, sina = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    lx = d[..., 0] * cosa + d[..., 1] * sina
    ly = -d[..., 0] * sina + d[..., 1] * cosa
    return (np.abs(lx) <= boxes[:, 3] / 2 + EPS) & \
           (np.abs(ly) <= boxes[:, 4] / 2 + EPS)


def boxes_overlap_bev(boxes_a, boxes_b):
    """Pairwise rotated BEV overlap areas (N, M), fully vectorized."""
    n, m = len(boxes_a), len(boxes_b)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    ca = boxes_to_corners_bev(boxes_a)          # (N, 4, 2)
    cb = boxes_to_corners_bev(boxes_b)          # (M, 4, 2)

    # corners of A in B: (N, 4, M) -> (N, M, 4)
    a_in_b = _points_in_rects(ca, boxes_b).transpose(0, 2, 1)
    b_in_a = _points_in_rects(cb, boxes_a).transpose(2, 0, 1)  # (N, M, 4)

    # segment intersections (N, M, 4, 4)
    a0 = ca[:, None, :, None, :]
    a1 = np.roll(ca, -1, axis=1)[:, None, :, None, :]
    b0 = cb[None, :, None, :, :]
    b1 = np.roll(cb, -1, axis=1)[None, :, None, :, :]
    da = a1 - a0
    db = b1 - b0
    d0 = b0 - a0
    denom = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]
    safe = np.where(np.abs(denom) < EPS, 1.0, denom)
    t = (d0[..., 0] * db[..., 1] - d0[..., 1] * db[..., 0]) / safe
    u = (d0[..., 0] * da[..., 1] - d0[..., 1] * da[..., 0]) / safe
    xok = (np.abs(denom) >= EPS) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    xpts = a0 + t[..., None] * da                        # (N, M, 4, 4, 2)

    cand = np.concatenate([
        np.broadcast_to(ca[:, None], (n, m, 4, 2)),
        np.broadcast_to(cb[None], (n, m, 4, 2)),
        xpts.reshape(n, m, 16, 2)], axis=2)              # (N, M, 24, 2)
    valid = np.concatenate([a_in_b, b_in_a, xok.reshape(n, m, 16)], axis=2)

    cnt = valid.sum(-1)                                   # (N, M)
    center = np.where(valid[..., None], cand, 0).sum(2) / \
        np.maximum(cnt, 1)[..., None]
    rel = cand - center[:, :, None, :]
    ang = np.arctan2(rel[..., 1], rel[..., 0])
    ang = np.where(valid, ang, 1e9)
    order = np.argsort(ang, axis=-1)
    v = np.take_along_axis(cand, order[..., None], axis=2)
    idx = np.arange(24)
    nxt = np.where(idx[None, None] + 1 < cnt[..., None], idx + 1, 0)
    vn = np.take_along_axis(v, nxt[..., None], axis=2)
    cross = v[..., 0] * vn[..., 1] - vn[..., 0] * v[..., 1]
    cross = np.where(idx[None, None] < cnt[..., None], cross, 0.0)
    area = 0.5 * np.abs(cross.sum(-1))
    return np.where(cnt >= 3, area, 0.0)


def boxes_iou_bev(boxes_a, boxes_b):
    inter = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return inter / np.clip(area_a + area_b - inter, EPS, None)


def boxes_iou3d(boxes_a, boxes_b):
    inter_bev = boxes_overlap_bev(boxes_a, boxes_b)
    za1 = boxes_a[:, 2] - boxes_a[:, 5] / 2
    za2 = boxes_a[:, 2] + boxes_a[:, 5] / 2
    zb1 = boxes_b[:, 2] - boxes_b[:, 5] / 2
    zb2 = boxes_b[:, 2] + boxes_b[:, 5] / 2
    zi = np.clip(np.minimum(za2[:, None], zb2[None]) -
                 np.maximum(za1[:, None], zb1[None]), 0, None)
    inter = inter_bev * zi
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None]
    return inter / np.clip(vol_a + vol_b - inter, EPS, None)


def nms_bev(boxes, scores, thresh, pre_max=None, post_max=None):
    """Exact greedy rotated NMS (host). Returns kept indices."""
    order = np.argsort(-scores)
    if pre_max is not None:
        order = order[:pre_max]
    boxes_s = boxes[order]
    iou = boxes_iou_bev(boxes_s, boxes_s)
    n = len(order)
    keep = []
    suppressed = np.zeros(n, bool)
    for i in range(n):
        if suppressed[i]:
            continue
        keep.append(order[i])
        suppressed |= iou[i] > thresh
        suppressed[i] = False
        if post_max is not None and len(keep) >= post_max:
            break
    return np.array(keep, dtype=np.int64)


def points_in_boxes(points, boxes):
    """(P,) index of first containing box, -1 if none."""
    if len(boxes) == 0:
        return -np.ones(len(points), np.int32)
    d = points[:, None, 0:3] - boxes[None, :, 0:3]
    cosa = np.cos(boxes[:, 6])[None]
    sina = np.sin(boxes[:, 6])[None]
    lx = d[..., 0] * cosa + d[..., 1] * sina
    ly = -d[..., 0] * sina + d[..., 1] * cosa
    inside = ((np.abs(lx) <= boxes[None, :, 3] / 2)
              & (np.abs(ly) <= boxes[None, :, 4] / 2)
              & (np.abs(d[..., 2]) <= boxes[None, :, 5] / 2))
    idx = np.argmax(inside, axis=1).astype(np.int32)
    return np.where(inside.any(axis=1), idx, -1)


