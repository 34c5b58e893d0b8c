"""KITTI camera calibration: parsing + host (numpy) and device (torch) paths.

A copy of ``virconv_tpu/utils/calibration.py`` whose device projection
is torch. Parity target: ``pcdet/utils/calibration_kitti.py`` — robust
file parsing with a default R0 fallback, lidar<->rect<->image transforms.
For the in-model NRConv projection the transforms are expressed as two dense
per-sample matrices so the whole batch projects with two einsums instead of
the reference's per-sample python loop (``spconv_backbone.py:61-79``):

    lidar_to_rect: rect = [x, 1] @ (V2C^T R0^T)    -> ``v2r`` (4, 3)
    rect_to_img:   hom  = [rect, 1] @ P2^T         -> ``p2t`` (4, 3)
"""

from __future__ import annotations

import re

import numpy as np

DEFAULT_R0 = np.array([[0.99992624, 0.00965411, -0.0072371],
                       [-0.00968531, 0.99994343, -0.00433077],
                       [0.00719491, 0.00440054, 0.99996366]], dtype=np.float32)


def get_calib_from_file(filepath):
    """Parse a KITTI calib txt (tolerates odometry-style key names)."""
    data = {'R0': DEFAULT_R0.copy()}

    def last(line, n, shape):
        return np.array(re.split(' ', line.strip())[-n:],
                        np.float32).reshape(shape)

    with open(filepath) as f:
        for line in f.readlines():
            if line[:2] == 'P2':
                data['P2'] = last(line, 12, (3, 4))
            elif line[:2] == 'P3':
                data['P3'] = last(line, 12, (3, 4))
            elif line[:14] == 'Tr_velo_to_cam' or line[:11] == 'Tr_velo_cam':
                data['Tr_velo2cam'] = last(line, 12, (3, 4))
            elif line[:7] == 'R0_rect' or line[:6] == 'R_rect':
                data['R0'] = last(line, 9, (3, 3))
    return data


class Calibration:
    def __init__(self, calib_file):
        calib = calib_file if isinstance(calib_file, dict) \
            else get_calib_from_file(calib_file)
        self.P2 = calib['P2']
        self.R0 = calib['R0']
        self.V2C = calib['Tr_velo2cam']
        self.cu = self.P2[0, 2]
        self.cv = self.P2[1, 2]
        self.fu = self.P2[0, 0]
        self.fv = self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    # ---- host (numpy) path -------------------------------------------------
    def cart_to_hom(self, pts):
        return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=np.float32)))

    def lidar_to_rect(self, pts_lidar):
        pts_hom = self.cart_to_hom(pts_lidar)
        return np.dot(pts_hom, np.dot(self.V2C.T, self.R0.T))

    def rect_to_lidar(self, pts_rect):
        pts_hom = self.cart_to_hom(pts_rect)
        r0_ext = np.eye(4, dtype=np.float32)
        r0_ext[:3, :3] = self.R0
        v2c_ext = np.eye(4, dtype=np.float32)
        v2c_ext[:3, :4] = self.V2C
        return np.dot(pts_hom, np.linalg.inv(np.dot(r0_ext, v2c_ext).T))[:, :3]

    def rect_to_img(self, pts_rect):
        pts_hom = self.cart_to_hom(pts_rect)
        pts_2d = np.dot(pts_hom, self.P2.T)
        pts_img = (pts_2d[:, 0:2].T / pts_hom[:, 2]).T
        depth = pts_2d[:, 2] - self.P2.T[3, 2]
        return pts_img, depth

    def lidar_to_img(self, pts_lidar):
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u, v, depth_rect):
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.concatenate(
            (x.reshape(-1, 1), y.reshape(-1, 1), depth_rect.reshape(-1, 1)),
            axis=1)

    def corners3d_to_img_boxes(self, corners3d):
        n = corners3d.shape[0]
        hom = np.concatenate((corners3d, np.ones((n, 8, 1))), axis=2)
        img_pts = np.matmul(hom, self.P2.T)
        x = img_pts[:, :, 0] / img_pts[:, :, 2]
        y = img_pts[:, :, 1] / img_pts[:, :, 2]
        boxes = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
        boxes_corner = np.concatenate(
            (x.reshape(-1, 8, 1), y.reshape(-1, 8, 1)), axis=2)
        return boxes, boxes_corner

    # ---- device path: dense matrices consumed by the model -----------------
    def device_matrices(self):
        """Return (v2r (4, 3), p2t (4, 3)) float32 for batched projection."""
        v2r = np.dot(self.V2C.T, self.R0.T).astype(np.float32)   # (4, 3)
        p2t = self.P2.T.astype(np.float32)                        # (4, 3)
        return v2r, p2t


def project_lidar_to_img(xyz, v2r, p2t):
    """Batched device projection (torch counterpart of the JAX package's
    ``project_lidar_to_img_jax``). xyz (N, 3), v2r (N, 4, 3) or (4, 3),
    p2t likewise. Returns (uv (N, 2), depth (N,)).

    Elementwise f32 products summed in index order, the same on every
    device: the outputs are floored to pixel-grid coords, so a TF32 or
    reordered matmul would move projections across pixel boundaries."""
    import torch
    v = v2r if v2r.ndim == 3 else v2r[None]
    p = p2t if p2t.ndim == 3 else p2t[None]

    def affine(a, m):              # [a, 1] @ m, accumulated in index order
        out = a[:, 0:1] * m[:, 0]
        for i in range(1, a.shape[1]):
            out = out + a[:, i:i + 1] * m[:, i]
        return out + m[:, a.shape[1]]

    rect = affine(xyz, v)
    img = affine(rect, p)
    z = torch.where(rect[:, 2].abs() < 1e-6,
                    torch.full_like(rect[:, 2], 1e-6), rect[:, 2])
    uv = img[:, 0:2] / z[:, None]
    depth = img[:, 2] - p[:, 3, 2]
    return uv, depth
