"""Differentiable rotated-IoU (ODIoU) RPN loss. Counterpart of
``virconv_tpu/ops/odiou.py``, as plain tensor functions whose gradients
come from autograd (the JAX package's come from autodiff).

Per matched box pair (gt g, prediction q):

    odiou = 1 - IoU3D~ + |c_g - c_q|^2 / (mbr_diag_bev^2 + inter_h^2 + 1e-7)
            + 1.25 * (1 - |cos(r_q - r_g)|)

with the JAX package's two reference quirks: every box enters the BEV
overlap and the minimum-area rectangle with the reflected heading
``pi/2 - ry`` (centers kept), and the 3D diagonal takes the clamped
intersection height. The minimum-area rectangle is found over every
pairwise corner direction (a superset of the hull edges), as the JAX
package does.

Masks mirror the JAX package's, so no NaN reaches a gradient: coincident
corners take the direction ``atan2(0, 1)``, a pair that ``ok`` masks
divides by 1, and ties of a min or max share the gradient as JAX's do
(``amax``/``amin``, ``torch.maximum``/``torch.minimum``, ``boxes.clip``).
``torch.fmod`` has C's sign rule, as ``jnp.fmod``.
"""

from __future__ import annotations

import math

import torch

from .boxes import boxes_overlap_bev_pairs, clip


def _reflect(boxes):
    """Heading ry -> pi/2 - ry."""
    return torch.cat([boxes[..., :6], math.pi / 2 - boxes[..., 6:7]], -1)


def _bev_corners(boxes):
    """(N, 4, 2) BEV corners of standard boxes, in the JAX package's order."""
    c, s = torch.cos(boxes[:, 6]), torch.sin(boxes[:, 6])
    u = torch.stack([c, s], -1) * boxes[:, 3:4] / 2
    v = torch.stack([-s, c], -1) * boxes[:, 4:5] / 2
    ctr = boxes[:, 0:2]
    return torch.stack([ctr + u + v, ctr + u - v, ctr - u + v, ctr - u - v],
                       1)


def _mbr_diag_sq(corners):
    """Squared diagonal of the minimum-area enclosing rectangle of (N, P, 2)
    points, over every pairwise-difference direction folded into
    [0, pi/2)."""
    d = corners[:, :, None, :] - corners[:, None, :, :]     # (N, P, P, 2)
    nz = (d[..., 0].abs() + d[..., 1].abs()) > 1e-9
    ang = torch.atan2(torch.where(nz, d[..., 1], torch.zeros_like(d[..., 1])),
                      torch.where(nz, d[..., 0], torch.ones_like(d[..., 0])))
    ang = torch.fmod(ang, math.pi / 2).abs()
    n, p = corners.shape[0], corners.shape[1]
    ang = ang.reshape(n, p * p)                             # (N, A)
    ca, sa = torch.cos(ang), torch.sin(ang)
    x = ca[:, :, None] * corners[:, None, :, 0] \
        + sa[:, :, None] * corners[:, None, :, 1]           # (N, A, P)
    y = -sa[:, :, None] * corners[:, None, :, 0] \
        + ca[:, :, None] * corners[:, None, :, 1]
    wx = x.amax(2) - x.amin(2)
    wy = y.amax(2) - y.amin(2)
    best = torch.argmin(wx * wy, 1, keepdim=True)
    bw = torch.gather(wx, 1, best)[:, 0]
    bh = torch.gather(wy, 1, best)[:, 0]
    return bw ** 2 + bh ** 2


def odiou_3d(gboxes, qboxes):
    """Per-pair ODIoU of (N, 7) matched pairs; 0 where a box has a
    non-positive size."""
    ok = (gboxes[:, 3:6] > 0).all(-1) & (qboxes[:, 3:6] > 0).all(-1)
    g = clip(gboxes, -200.0, 200.0)
    q = clip(qboxes, -200.0, 200.0)

    angle_factor = 1.25 * (1.0 - torch.cos(q[:, 6] - g[:, 6]).abs())

    gr, qr = _reflect(g), _reflect(q)
    inter_area = boxes_overlap_bev_pairs(gr, qr)
    inter_h = clip(
        torch.minimum(g[:, 2] + 0.5 * g[:, 5], q[:, 2] + 0.5 * q[:, 5])
        - torch.maximum(g[:, 2] - 0.5 * g[:, 5], q[:, 2] - 0.5 * q[:, 5]),
        0.0)
    vol_inc = inter_h * inter_area
    vol_union = (g[:, 3] * g[:, 4] * g[:, 5]
                 + q[:, 3] * q[:, 4] * q[:, 5] - vol_inc)
    iou = vol_inc / torch.where(ok, vol_union, torch.ones_like(vol_union))

    corners = torch.cat([_bev_corners(gr), _bev_corners(qr)], 1)
    mbr_sq = _mbr_diag_sq(corners) + inter_h ** 2 + 1e-7
    center_sq = ((g[:, 0:3] - q[:, 0:3]) ** 2).sum(-1)

    od = 1.0 - iou + center_sq / mbr_sq + angle_factor
    return torch.where(ok, od, torch.zeros_like(od))


def odiou_3d_weighted(gboxes, qboxes, weights, batch_size):
    """2 * sum(od * weights) / batch_size."""
    od = odiou_3d(gboxes, qboxes)
    return 2.0 * (od * weights).sum() / batch_size


