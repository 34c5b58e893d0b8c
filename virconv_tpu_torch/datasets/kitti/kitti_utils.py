"""KITTI label parsing and camera <-> LiDAR box conversions (host numpy).

The port's copy of ``virconv_tpu/datasets/kitti/kitti_utils.py``. KITTI
camera boxes are [x, y, z, l, h, w, ry] with the origin at the box bottom;
LiDAR boxes are [x, y, z, dx(l), dy(w), dz(h), heading], centred.
"""

from __future__ import annotations

import numpy as np


class Object3d:
    """One line of a KITTI ``label_2`` file."""

    def __init__(self, line):
        label = line.strip().split(' ')
        self.cls_type = label[0]
        self.truncation = float(label[1])
        self.occlusion = float(label[2])
        self.alpha = float(label[3])
        self.box2d = np.array([float(v) for v in label[4:8]],
                              dtype=np.float32)
        self.h = float(label[8])
        self.w = float(label[9])
        self.l = float(label[10])
        self.loc = np.array([float(v) for v in label[11:14]],
                            dtype=np.float32)
        self.ry = float(label[14])
        self.score = float(label[15]) if len(label) == 16 else -1.0
        self.level = self.get_kitti_obj_level()

    def get_kitti_obj_level(self):
        """0 easy, 1 moderate, 2 hard, -1 none, by the devkit's rules."""
        height = float(self.box2d[3]) - float(self.box2d[1]) + 1
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            return 0
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            return 1
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            return 2
        return -1


def get_objects_from_label(label_file):
    with open(label_file, 'r') as f:
        lines = f.readlines()
    return [Object3d(line) for line in lines if line.strip()]


def boxes3d_kitti_camera_to_lidar(boxes3d_camera, calib):
    """camera [x, y, z, l, h, w, r] (bottom origin) -> LiDAR
    [x, y, z, l, w, h, heading] (centre origin)."""
    boxes = boxes3d_camera.copy()
    l, h, w = boxes[:, 3:4], boxes[:, 4:5], boxes[:, 5:6]
    r = boxes[:, 6:7]
    xyz_lidar = calib.rect_to_lidar(boxes[:, 0:3])
    xyz_lidar[:, 2] += h[:, 0] / 2
    return np.concatenate([xyz_lidar, l, w, h, -(np.pi / 2 + r)], axis=-1)


def boxes3d_lidar_to_kitti_camera(boxes3d_lidar, calib):
    boxes = boxes3d_lidar.copy()
    xyz_lidar = boxes[:, 0:3].copy()
    l, w, h = boxes[:, 3:4], boxes[:, 4:5], boxes[:, 5:6]
    r = boxes[:, 6:7]
    xyz_lidar[:, 2] -= h[:, 0] / 2
    xyz_cam = calib.lidar_to_rect(xyz_lidar)
    return np.concatenate([xyz_cam, l, h, w, -r - np.pi / 2], axis=-1)


def boxes3d_kitti_camera_to_imageboxes(boxes3d, calib, image_shape=None):
    """camera boxes -> image [x1, y1, x2, y2] of the projected 3D corners,
    clipped to ``image_shape`` (h, w) when given."""
    l, h, w = boxes3d[:, 3:4], boxes3d[:, 4:5], boxes3d[:, 5:6]
    x_c = np.array([1, 1, -1, -1, 1, 1, -1, -1], dtype=np.float32) / 2
    z_c = np.array([1, -1, -1, 1, 1, -1, -1, 1], dtype=np.float32) / 2
    y_c = np.array([0, 0, 0, 0, -1, -1, -1, -1], dtype=np.float32)
    corners = np.stack([l * x_c[None], h * y_c[None], w * z_c[None]],
                       axis=-1)                         # (N, 8, 3)
    ry = boxes3d[:, 6]
    cosa, sina = np.cos(ry), np.sin(ry)
    x = corners[..., 0] * cosa[:, None] + corners[..., 2] * sina[:, None]
    z = -corners[..., 0] * sina[:, None] + corners[..., 2] * cosa[:, None]
    corners = np.stack([x, corners[..., 1], z], axis=-1)
    corners += boxes3d[:, None, 0:3]
    boxes2d, _ = calib.corners3d_to_img_boxes(corners)
    if image_shape is not None:
        boxes2d[:, [0, 2]] = np.clip(boxes2d[:, [0, 2]], 0,
                                     image_shape[1] - 1)
        boxes2d[:, [1, 3]] = np.clip(boxes2d[:, [1, 3]], 0,
                                     image_shape[0] - 1)
    return boxes2d
