"""Dense depth -> virtual multimodal points (numpy).

The port's own copy of ``virconv_tpu/models/depth_completion/
depth2points.py`` (the reference's ``tools/PENet/dataloaders/my_loader.py``
``depth2pointsrgbp`` and ``la_sampling2``, ``vis_utils.py``
``save_depth_as_points``): back-project completed depth to the LiDAR
frame, attach RGB/3, keep points below z < 1, thin the virtual set with a
spherical keep-nearest grid, tag indicator 1 (virtual) / 2 (real LiDAR,
intensity x10), float16.

This numpy code is the contract and the CPU path. On a CUDA device
``VirtualPointGenerator`` makes the virtual rows with the kernels of
``ops/depth2points.py`` from the depth already on the card, to the same
bits: the back-projection (numpy's float32 operations one by one, the
4 x 4 product in np.dot's order), the z cut, the bins' float32 floor
division and the keep-nearest. Only la_sampling2's angles stay numpy's
there too (``ops.depth2points.angles``, which ``la_sampling2`` calls
through ``bins``): the bins are float32 floors of ``arccos`` / ``arctan``,
and a device transcendental one ulp off would move points across bins.
"""

from __future__ import annotations

import numpy as np

from ...ops.depth2points import bins


def la_sampling2(points, vert_res=0.0025, hor_res=0.0015):
    """Spherical-grid keep-nearest thinning of dense virtual points."""
    r = np.linalg.norm(points[:, 0:3], axis=-1)
    r = np.clip(r, 1e-6, None)
    vert, hor = bins(np.clip(points[:, 2] / r, -1, 1),
                     points[:, 1] / np.clip(points[:, 0], 1e-6, None),
                     vert_res, hor_res)
    key = vert * 1_000_003 + hor
    order = np.lexsort((r, key))
    key_s = key[order]
    first = np.ones(len(key_s), bool)
    first[1:] = key_s[1:] != key_s[:-1]
    return points[order[first]]


def depth_to_points_rgb(depth, rgb, calib, max_depth=100.0):
    """Dense depth map (H, W) + image (H, W, 3) -> virtual lidar points
    (N, 8): [x, y, z, intensity=0, r/3, g/3, b/3, indicator=1]."""
    h, w = depth.shape
    v, u = np.nonzero((depth > 0.1) & (depth < max_depth))
    d = depth[v, u]
    pts_rect = calib.img_to_rect(u.astype(np.float32),
                                 v.astype(np.float32), d)
    pts_lidar = calib.rect_to_lidar(pts_rect)
    colors = rgb[v, u].astype(np.float32) / 3.0
    out = np.zeros((len(d), 8), np.float32)
    out[:, 0:3] = pts_lidar
    out[:, 4:7] = colors
    out[:, 7] = 1.0
    return out


def lidar_rows(lidar_pts):
    """The scan (N, 4) as fused rows (N, 8) float32: [x, y, z,
    intensity x 10, 0, 0, 0, indicator=2]."""
    lidar8 = np.zeros((len(lidar_pts), 8), np.float32)
    lidar8[:, 0:3] = lidar_pts[:, 0:3]
    lidar8[:, 3] = lidar_pts[:, 3] * 10.0
    lidar8[:, 7] = 2.0
    return lidar8


def fuse_virtual_and_lidar(virtual_pts, lidar_pts, max_z=1.0,
                           vert_res=0.0025, hor_res=0.0015):
    """Combine thinned virtual points with real LiDAR into the 8-dim
    ``velodyne_depth`` format (float16)."""
    virtual_pts = virtual_pts[virtual_pts[:, 2] < max_z]
    virtual_pts = la_sampling2(virtual_pts, vert_res, hor_res)
    fused = np.concatenate([lidar_rows(lidar_pts), virtual_pts], axis=0)
    return fused.astype(np.float16)
