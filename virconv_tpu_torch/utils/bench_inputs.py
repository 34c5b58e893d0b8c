"""Inputs of the full-width main paths: synthetic KITTI-scale frames.

FRAMES street scenes from ``synth_scene`` (LiDAR ~17-20k points, fused
real + virtual ~60k), padded to the loader's per-stream point capacities,
with a KITTI-typical calibration -- the inputs ``bench.py`` builds for the
JAX package, made here with numpy from ``seed``. ``train_batch`` is the
training batch of ``tools/bench_train.py``: each frame's ROT_NUM replicas
world-transformed, with their gt boxes.
"""

from __future__ import annotations

import numpy as np

from .calibration import Calibration
from .synth_scene import make_scene
from .transforms import transform_boxes_np, transform_points_np

N_LIDAR_PTS, N_FUSED_PTS = 32768, 65536
N_TRAIN_PTS, N_TRAIN_GT = 65536, 64
# the training replicas' world transforms [rot, flip, scale]
TRAIN_TRANSFORMS = np.array([[0.3, 0.0, 0.98], [0.3, 1.0, 1.02],
                             [0.0, 1.0, 1.0]], np.float32)
FRAMES = 2            # frames per request, bench.py's default


def kitti_calib():
    """(v2r, p2t) of a KITTI-typical camera calibration."""
    p2 = np.array([[721.5, 0., 609.6, 44.9], [0., 721.5, 172.9, 0.2],
                   [0., 0., 1., 0.003]], np.float32)
    v2c = np.array([[7.5e-03, -1.0, -1.8e-04, -4.1e-03],
                    [2.0e-03, 1.9e-04, -1.0, -7.6e-02],
                    [1.0, 7.5e-03, 2.0e-03, -2.7e-01]], np.float32)
    return Calibration({'P2': p2, 'R0': np.eye(3, dtype=np.float32),
                        'Tr_velo2cam': v2c}).device_matrices()


def synth_frames(frames, seed=0):
    """``frames`` street scenes as the Detector's input dict."""
    rng = np.random.default_rng(seed)
    lpts = np.zeros((frames, N_LIDAR_PTS, 8), np.float32)
    lval = np.zeros((frames, N_LIDAR_PTS), bool)
    mpts = np.zeros((frames, N_FUSED_PTS, 8), np.float32)
    mval = np.zeros((frames, N_FUSED_PTS), bool)
    for e in range(frames):
        s = make_scene(seed=e)
        n = len(s['lidar'])
        lidar8 = np.concatenate([s['lidar'][:, :4],
                                 np.zeros((n, 3), np.float32),
                                 np.ones((n, 1), np.float32)], -1)
        if n > N_LIDAR_PTS:
            lidar8 = lidar8[rng.choice(n, N_LIDAR_PTS, replace=False)]
        fused = np.concatenate([lidar8, s['virtual']], 0)
        if len(fused) > N_FUSED_PTS:
            fused = fused[rng.choice(len(fused), N_FUSED_PTS, replace=False)]
        lpts[e, :len(lidar8)] = lidar8
        lval[e, :len(lidar8)] = True
        mpts[e, :len(fused)] = fused
        mval[e, :len(fused)] = True
    v2r, p2t = kitti_calib()
    return {'points': lpts, 'points_valid': lval, 'points_mm': mpts,
            'points_mm_valid': mval, 'v2r': np.tile(v2r, (frames, 1, 1)),
            'p2t': np.tile(p2t, (frames, 1, 1))}


def train_batch(frames=2, seed=0, rot_num=3):
    """A training batch of ``frames`` street scenes x ``rot_num`` replicas
    (entry = frame * rot_num + replica), each replica's points and gt boxes
    world-transformed by ``TRAIN_TRANSFORMS``: ``N_TRAIN_PTS`` points per
    stream per frame, up to ``N_TRAIN_GT`` gt boxes, ``trans_params`` set
    and ``transform_param`` None (every entry is its own sample)."""
    rng = np.random.default_rng(seed)
    n = N_TRAIN_PTS
    lpts = np.zeros((frames, n, 8), np.float32)
    lval = np.zeros((frames, n), bool)
    mpts = np.zeros((frames, n, 8), np.float32)
    mval = np.zeros((frames, n), bool)
    gt = np.zeros((frames, N_TRAIN_GT, 8), np.float32)
    gt_valid = np.zeros((frames, N_TRAIN_GT), bool)
    for e in range(frames):
        s = make_scene(seed=e)
        lidar8 = np.concatenate([s['lidar'][:, :4],
                                 np.zeros((len(s['lidar']), 3), np.float32),
                                 np.ones((len(s['lidar']), 1), np.float32)],
                                -1)[:n]
        fused = np.concatenate([lidar8, s['virtual']], 0)
        if len(fused) > n:
            fused = fused[rng.choice(len(fused), n, replace=False)]
        lpts[e, :len(lidar8)] = lidar8
        lval[e, :len(lidar8)] = True
        mpts[e, :len(fused)] = fused
        mval[e, :len(fused)] = True
        boxes = s['boxes'][:N_TRAIN_GT]
        gt[e, :len(boxes), :7] = boxes[:, :7]
        gt[e, :len(boxes), 7] = 1
        gt_valid[e, :len(boxes)] = True
    params = TRAIN_TRANSFORMS[:rot_num]

    def replicate(arr, fn):
        return np.stack([fn(arr[e], p) for e in range(frames)
                         for p in params])
    v2r, p2t = kitti_calib()
    entries = frames * rot_num
    return {'points': replicate(lpts, transform_points_np),
            'points_valid': np.repeat(lval, rot_num, 0),
            'points_mm': replicate(mpts, transform_points_np),
            'points_mm_valid': np.repeat(mval, rot_num, 0),
            'v2r': np.tile(v2r, (entries, 1, 1)),
            'p2t': np.tile(p2t, (entries, 1, 1)),
            'trans_params': np.tile(params, (frames, 1)),
            'transform_param': None,
            'gt_boxes': replicate(gt, transform_boxes_np),
            'gt_valid': np.repeat(gt_valid, rot_num, 0)}
