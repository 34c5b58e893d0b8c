"""Host augmentation primitives of the training loader (numpy).

The port's copy of ``virconv_tpu/datasets/augmentor/augmentor_utils.py``:
world flip, rotation and scaling with their recorded parameters,
per-object noise with a collision test of the candidate transforms (the
rotated BEV overlap of ``ops/native.boxes_overlap_bev``), and the SE-SSD
pyramid augmentations (dropout, sparsify, swap).

Every random number comes from the ``rng`` argument (an
``np.random.RandomState``), drawn in the order in which the JAX functions
draw the same numbers from numpy's global state. Boxes and points are
changed in place where the JAX functions change them in place.
"""

from __future__ import annotations

import numpy as np

from ...ops import boxes_np
from ...ops import native as native_ops


def random_flip_along_x(gt_boxes, points, rng):
    enable = rng.choice([False, True])
    if enable:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
    return gt_boxes, points, enable


def global_rotation(gt_boxes, points, rot_range, rng):
    angle = rng.uniform(rot_range[0], rot_range[1])
    points[:, :] = boxes_np.rotate_points_along_z(
        points[None], np.array([angle]))[0]
    gt_boxes[:, 0:3] = boxes_np.rotate_points_along_z(
        gt_boxes[None, :, 0:3], np.array([angle]))[0]
    gt_boxes[:, 6] += angle
    return gt_boxes, points, angle


def global_scaling(gt_boxes, points, scale_range, rng):
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points, 1.0
    scale = rng.uniform(scale_range[0], scale_range[1])
    points[:, :3] *= scale
    gt_boxes[:, :6] *= scale
    return gt_boxes, points, scale


def enlarge_box3d(boxes3d, extra_width=(0, 0, 0)):
    large = boxes3d.copy()
    large[:, 3:6] += np.asarray(extra_width)[None]
    large[:, 2] += np.asarray(extra_width)[2] / 2
    return large


def remove_points_in_boxes3d(points, boxes3d):
    idx = boxes_np.points_in_boxes(points, boxes3d[:, :7])
    return points[idx < 0]


def points_in_box_with_margin(points, box, margin=0.1):
    d = points[:, 0:3] - box[0:3]
    cosa, sina = np.cos(box[6]), np.sin(box[6])
    lx = d[:, 0] * cosa + d[:, 1] * sina
    ly = -d[:, 0] * sina + d[:, 1] * cosa
    return ((np.abs(lx) <= box[3] / 2 + margin)
            & (np.abs(ly) <= box[4] / 2 + margin)
            & (np.abs(d[:, 2]) <= box[5] / 2))


def noise_per_object(gt_boxes, points, rng, points_pseudo=None,
                     valid_mask=None, rotation_perturb=np.pi / 4,
                     center_noise_std=1.0, global_rot_range=(0.0, 0.0),
                     extra_width=(0, 0, 0), num_try=100):
    """Per-object random rotation and translation with collision rejection.
    Boxes are taken in order; each takes the first of ``num_try`` candidate
    transforms whose box overlaps no other current box (rotated BEV test),
    and the points inside it (enlarged by ``extra_width``) move with it."""
    num_boxes = gt_boxes.shape[0]
    if num_boxes == 0:
        return
    if not isinstance(rotation_perturb, (list, tuple, np.ndarray)):
        rotation_perturb = [-rotation_perturb, rotation_perturb]
    if not isinstance(center_noise_std, (list, tuple, np.ndarray)):
        center_noise_std = [center_noise_std] * 3
    if valid_mask is None:
        valid_mask = np.ones(num_boxes, dtype=bool)

    loc_noises = rng.normal(scale=np.asarray(center_noise_std),
                            size=(num_boxes, num_try, 3))
    rot_noises = rng.uniform(rotation_perturb[0], rotation_perturb[1],
                             size=(num_boxes, num_try))
    grown = enlarge_box3d(gt_boxes[:, :7], extra_width)

    current = gt_boxes[:, :7].copy()
    for i in range(num_boxes):
        if not valid_mask[i]:
            continue
        cand = np.tile(current[i][None], (num_try, 1))
        cand[:, 0:3] += loc_noises[i]
        cand[:, 6] += rot_noises[i]
        others = np.delete(current, i, axis=0)
        if len(others):
            overlap = native_ops.boxes_overlap_bev(cand, others)
            ok = (overlap < 1e-6).all(axis=1)
        else:
            ok = np.ones(num_try, bool)
        hits = np.nonzero(ok)[0]
        if len(hits) == 0:
            continue
        t = hits[0]
        # the in-box points: to the box frame, rotate, translate back
        for pts in (points, points_pseudo):
            if pts is None or len(pts) == 0:
                continue
            mask = points_in_box_with_margin(pts, grown[i])
            local = pts[mask, 0:3] - current[i, 0:3]
            ang = rot_noises[i, t]
            cosa, sina = np.cos(ang), np.sin(ang)
            x = local[:, 0] * cosa - local[:, 1] * sina
            y = local[:, 0] * sina + local[:, 1] * cosa
            moved = np.stack([x, y, local[:, 2]], -1) \
                + current[i, 0:3] + loc_noises[i, t]
            pts[mask, 0:3] = moved
        current[i, 0:3] += loc_noises[i, t]
        current[i, 6] += rot_noises[i, t]
    gt_boxes[:, :7] = current


# ----------------------------------------------------------- pyramid aug ----
_PYRAMID_ORDERS = np.array([
    [0, 1, 5, 4], [4, 5, 6, 7], [7, 6, 2, 3],
    [3, 2, 1, 0], [1, 2, 6, 5], [0, 4, 7, 3]])


def get_pyramids(boxes):
    """(N, 6, 15): the box centre and the 4 corners of each face."""
    corners = boxes_np.boxes_to_corners_3d(boxes).reshape(-1, 24)
    out = []
    for order in _PYRAMID_ORDERS:
        pyramid = np.concatenate(
            [boxes[:, 0:3]] +
            [corners[:, 3 * o: 3 * o + 3] for o in order], axis=1)
        out.append(pyramid[:, None, :])
    return np.concatenate(out, axis=1)


def in_hull(points, hull_points):
    from scipy.spatial import Delaunay
    try:
        hull = Delaunay(hull_points)
    except Exception:
        return np.zeros(len(points), bool)
    return hull.find_simplex(points) >= 0


def points_in_pyramids_mask(points, pyramids):
    pyramids = pyramids.reshape(-1, 5, 3)
    flags = np.zeros((points.shape[0], pyramids.shape[0]), dtype=bool)
    for i, pyr in enumerate(pyramids):
        flags[:, i] = in_hull(points[:, 0:3], pyr)
    return flags


def _one_hot(x, num_class=6):
    oh = np.zeros((len(x), num_class))
    oh[range(len(x)), x] = 1
    return oh


def local_pyramid_dropout(gt_boxes, points, dropout_prob, rng,
                          pyramids=None):
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes).reshape(-1, 6, 5, 3)
    if pyramids.shape[0] == 0:
        return gt_boxes, points, pyramids
    drop_idx = rng.randint(0, 6, pyramids.shape[0])
    drop_oh = _one_hot(drop_idx)
    drop_box = rng.uniform(0, 1, pyramids.shape[0]) <= dropout_prob
    if drop_box.sum():
        drop_mask = (drop_box[:, None] * drop_oh) > 0
        masks = points_in_pyramids_mask(points, pyramids[drop_mask])
        points = points[~masks.any(-1)]
    pyramids = pyramids[~drop_box]
    return gt_boxes, points, pyramids


def local_pyramid_sparsify(gt_boxes, points, prob, max_num_pts, rng,
                           pyramids=None):
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes).reshape(-1, 6, 5, 3)
    if pyramids.shape[0] == 0:
        return gt_boxes, points, pyramids
    sp_idx = rng.randint(0, 6, pyramids.shape[0])
    sp_oh = _one_hot(sp_idx)
    sp_box = rng.uniform(0, 1, pyramids.shape[0]) <= prob
    sp_mask = (sp_box[:, None] * sp_oh) > 0
    sampled = pyramids[sp_mask]
    if sampled.shape[0]:
        masks = points_in_pyramids_mask(points, sampled)
        counts = masks.sum(0)
        dense = counts > max_num_pts
        if dense.any():
            masks = masks[:, dense]
            remain = points[~masks.any(-1)]
            kept = []
            for i in range(masks.shape[1]):
                grp = points[masks[:, i]]
                sel = rng.choice(len(grp), max_num_pts, replace=False)
                kept.append(grp[sel])
            points = np.concatenate([remain] + kept, axis=0)
    pyramids = pyramids[~sp_box]
    return gt_boxes, points, pyramids


def _pyramid_ratios(pts, pyr):
    """Barycentric-like coordinates of ``pts`` in face-pyramid ``pyr``."""
    pyr = pyr.reshape(15)
    sc = (pyr[3:6] + pyr[6:9] + pyr[9:12] + pyr[12:]) / 4.0
    v0, v1 = pyr[6:9] - pyr[3:6], pyr[12:] - pyr[3:6]
    v2 = pyr[0:3] - sc
    a = ((pts[:, 0:3] - pyr[3:6]) * v0).sum(-1) / (v0 ** 2).sum()
    b = ((pts[:, 0:3] - pyr[3:6]) * v1).sum(-1) / (v1 ** 2).sum()
    g = ((pts[:, 0:3] - sc) * v2).sum(-1) / (v2 ** 2).sum()
    return a, b, g


def _pyramid_recover(abg, pyr):
    """Points of ``pyr`` at the coordinates ``abg`` of ``_pyramid_ratios``."""
    a, b, g = abg
    pyr = pyr.reshape(15)
    sc = (pyr[3:6] + pyr[6:9] + pyr[9:12] + pyr[12:]) / 4.0
    v0, v1 = pyr[6:9] - pyr[3:6], pyr[12:] - pyr[3:6]
    v2 = pyr[0:3] - sc
    return a[:, None] * v0 + b[:, None] * v1 + pyr[3:6] + g[:, None] * v2


def _rescale_extra(src, dst):
    """``src``'s feature columns mapped onto the range of ``dst``'s."""
    lo, hi = dst[:, 3:].min(0), dst[:, 3:].max(0)
    slo, shi = src[:, 3:].min(0), src[:, 3:].max(0)
    ratio = (src[:, 3:] - slo) / np.clip(shi - slo, 1e-6, None)
    return ratio * (hi - lo) + lo


def local_pyramid_swap(gt_boxes, points, prob, max_num_pts, rng,
                       pyramids=None):
    """Swap the points of matching face-pyramids between two boxes, each
    re-placed by its coordinates in the pyramid it leaves."""
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes).reshape(-1, 6, 5, 3)
    if pyramids.shape[0] == 0:
        return gt_boxes, points
    swap_box = rng.uniform(0, 1, pyramids.shape[0]) <= prob
    if swap_box.sum() == 0:
        return gt_boxes, points
    masks = points_in_pyramids_mask(points, pyramids)
    nums = masks.sum(0).reshape(pyramids.shape[0], 6)
    eligible = nums > max_num_pts
    selected = eligible * swap_box[:, None]
    if selected.sum() == 0:
        return gt_boxes, points

    bi, fj = np.nonzero(selected)
    chosen = {}                                 # faces of each box
    for b, f in zip(bi, fj):
        chosen.setdefault(b, []).append(f)
    to_swap, partners = [], []
    for b, faces in chosen.items():
        f = rng.choice(faces)
        # partner: another box eligible on the same face
        cands = np.where(eligible[:, f])[0]
        cands = cands[cands != b]
        if len(cands) == 0:
            continue
        p = rng.choice(cands)
        to_swap.append((b, f))
        partners.append((p, f))
    if not to_swap:
        return gt_boxes, points

    pair_masks = np.stack([
        points_in_pyramids_mask(points, pyramids[b, f][None])[:, 0]
        for (b, f) in to_swap + partners], 1)
    remain = points[~pair_masks.any(-1)]
    n = len(to_swap)
    res = []
    for i in range(n):
        b, f = to_swap[i]
        p, pf = partners[i]
        pts_a = points[pair_masks[:, i]]
        pts_b = points[pair_masks[:, i + n]]
        if len(pts_a) == 0 or len(pts_b) == 0:
            res.extend([pts_a, pts_b])
            continue
        new_a = _pyramid_recover(_pyramid_ratios(pts_b, pyramids[p, pf]),
                                 pyramids[b, f])
        new_b = _pyramid_recover(_pyramid_ratios(pts_a, pyramids[b, f]),
                                 pyramids[p, pf])
        res.append(np.concatenate([new_a, _rescale_extra(pts_b, pts_a)], 1))
        res.append(np.concatenate([new_b, _rescale_extra(pts_a, pts_b)], 1))
    points = np.concatenate([remain] + res, axis=0)
    return gt_boxes, points
