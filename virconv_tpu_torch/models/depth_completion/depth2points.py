"""Dense depth -> virtual multimodal points, on the host (numpy).

The port's own copy of ``virconv_tpu/models/depth_completion/
depth2points.py`` (the reference's ``tools/PENet/dataloaders/my_loader.py``
``depth2pointsrgbp`` and ``la_sampling2``, ``vis_utils.py``
``save_depth_as_points``): back-project completed depth to the LiDAR
frame, attach RGB/3, keep points below z < 1, thin the virtual set with a
spherical keep-nearest grid, tag indicator 1 (virtual) / 2 (real LiDAR,
intensity x10), float16. It stays on the host: ``la_sampling2``'s bins are
float32 floors of ``arccos`` / ``arctan``, and a device transcendental one
ulp off would move points across bins.
"""

from __future__ import annotations

import numpy as np


def la_sampling2(points, vert_res=0.0025, hor_res=0.0015):
    """Spherical-grid keep-nearest thinning of dense virtual points."""
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


def fuse_virtual_and_lidar(virtual_pts, lidar_pts, max_z=1.0,
                           vert_res=0.0025, hor_res=0.0015):
    """Combine thinned virtual points with real LiDAR into the 8-dim
    ``velodyne_depth`` format (float16)."""
    virtual_pts = virtual_pts[virtual_pts[:, 2] < max_z]
    virtual_pts = la_sampling2(virtual_pts, vert_res, hor_res)

    lidar8 = np.zeros((len(lidar_pts), 8), np.float32)
    lidar8[:, 0:3] = lidar_pts[:, 0:3]
    lidar8[:, 3] = lidar_pts[:, 3] * 10.0
    lidar8[:, 7] = 2.0
    fused = np.concatenate([lidar8, virtual_pts], axis=0)
    return fused.astype(np.float16)
