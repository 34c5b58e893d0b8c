"""Completed depth -> the fused float16 cloud of one frame, on the host
(numpy): a frozen copy of the measured program's ``depth2points`` (the
reference's ``tools/PENet/dataloaders/my_loader.py`` ``depth2pointsrgbp``
and ``la_sampling2``, ``vis_utils.py`` ``save_depth_as_points``).

Back-project every crop pixel whose depth lies in (0.1, 100) m through the
crop's calibration, attach RGB / 3, keep the points below z = 1 m, thin
them on a spherical grid keeping the nearest point of each bin, and put
them after the LiDAR scan (intensity x 10, indicator 2; virtual points
indicator 1), in float16.
"""

from __future__ import annotations

import numpy as np

from .utils.calibration import Calibration


def la_sampling2(points, vert_res=0.0025, hor_res=0.0015):
    r = np.linalg.norm(points[:, 0:3], axis=-1)
    r = np.clip(r, 1e-6, None)
    theta = np.arccos(np.clip(points[:, 2] / r, -1, 1))
    fan = np.arctan(points[:, 1] / np.clip(points[:, 0], 1e-6, None))
    vert = (theta // vert_res).astype(np.int64)
    hor = (fan // hor_res).astype(np.int64)
    key = vert * 1_000_003 + hor
    order = np.lexsort((r, key))
    key_s = key[order]
    first = np.ones(len(key_s), bool)
    first[1:] = key_s[1:] != key_s[:-1]
    return points[order[first]]


def depth_to_points_rgb(depth, rgb, calib, max_depth=100.0):
    v, u = np.nonzero((depth > 0.1) & (depth < max_depth))
    d = depth[v, u]
    pts_rect = calib.img_to_rect(u.astype(np.float32),
                                 v.astype(np.float32), d)
    out = np.zeros((len(d), 8), np.float32)
    out[:, 0:3] = calib.rect_to_lidar(pts_rect)
    out[:, 4:7] = rgb[v, u].astype(np.float32) / 3.0
    out[:, 7] = 1.0
    return out


def fuse(virtual, lidar, max_z=1.0):
    virtual = la_sampling2(virtual[virtual[:, 2] < max_z])
    lidar8 = np.zeros((len(lidar), 8), np.float32)
    lidar8[:, 0:3] = lidar[:, 0:3]
    lidar8[:, 3] = lidar[:, 3] * 10.0
    lidar8[:, 7] = 2.0
    return np.concatenate([lidar8, virtual], axis=0).astype(np.float16)


def crop_calibration(k_mat, calib):
    """The crop's calibration: its intrinsics with the frame's R0 and
    velodyne-to-camera transform (``calib``: a {'P2', 'R0',
    'Tr_velo2cam'} dict)."""
    return Calibration({
        'P2': np.array([[k_mat[0, 0], 0, k_mat[0, 2], 0],
                        [0, k_mat[1, 1], k_mat[1, 2], 0],
                        [0, 0, 1, 0]], np.float32),
        'R0': calib['R0'], 'Tr_velo2cam': calib['Tr_velo2cam']})


def frame_points(depth, rgb_c, k_mat, calib, lidar):
    """The fused cloud of a frame from its depth (CROP_H, CROP_W)."""
    return fuse(depth_to_points_rgb(depth, rgb_c,
                                    crop_calibration(k_mat, calib)), lidar)
