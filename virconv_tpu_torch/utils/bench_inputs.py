"""Inputs of the full-width main paths: synthetic KITTI-scale frames.

FRAMES street scenes from ``synth_scene`` (LiDAR ~17-20k points, fused
real + virtual ~60k), padded to the loader's per-stream point capacities,
with a KITTI-typical calibration -- the inputs ``bench.py`` builds for the
JAX package, made here with numpy from ``seed``. ``train_batch`` is the
training batch of ``tools/bench_train.py``: each frame's ROT_NUM replicas
world-transformed, with their gt boxes. ``synth_frames_l`` and
``train_batch_l`` are VirConv-L's: the same streets as one fused stream
per frame, built as the loader builds it with ``LATER_FUSION`` False
(LiDAR first, StVD on the virtual points, intensity / 10), one entry per
frame.
"""

from __future__ import annotations

import numpy as np

from ..datasets.dataset import (LIDAR, VIRTUAL, fuse_streams,
                                input_point_discard)
from .calibration import Calibration, identity_calib
from .synth_scene import fused_cloud, make_scene
from .transforms import transform_boxes_np, transform_points_np

N_LIDAR_PTS, N_FUSED_PTS = 32768, 65536
N_TRAIN_PTS, N_TRAIN_GT = 65536, 64
# the training replicas' world transforms [rot, flip, scale]
TRAIN_TRANSFORMS = np.array([[0.3, 0.0, 0.98], [0.3, 1.0, 1.02],
                             [0.0, 1.0, 1.0]], np.float32)
FRAMES = 2            # frames per request, bench.py's default


# a KITTI-typical camera calibration (P2, R0, Tr_velo_to_cam)
KITTI_CALIB = {
    'P2': np.array([[721.5, 0., 609.6, 44.9], [0., 721.5, 172.9, 0.2],
                    [0., 0., 1., 0.003]], np.float32),
    'R0': np.eye(3, dtype=np.float32),
    'Tr_velo2cam': np.array([[7.5e-03, -1.0, -1.8e-04, -4.1e-03],
                             [2.0e-03, 1.9e-04, -1.0, -7.6e-02],
                             [1.0, 7.5e-03, 2.0e-03, -2.7e-01]], np.float32)}


def kitti_calib():
    """(v2r, p2t) of ``KITTI_CALIB``."""
    return Calibration(KITTI_CALIB).device_matrices()


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


def fused_stream(scene, rng, capacity, training=False):
    """One frame's single stream (VirConv-L) as the loader builds it: the
    LiDAR points, then the virtual points StVD keeps (rate 0.8 over 10
    distance bins at evaluation, 2 in training), intensity / 10, at most
    ``capacity`` points drawn without replacement. Draws from ``rng`` (a
    ``RandomState``)."""
    cloud = fused_cloud(scene)
    kept = input_point_discard(cloud[cloud[:, 7] == VIRTUAL], rng,
                               bin_num=2 if training else 10, rate=0.8)
    fused = fuse_streams(cloud[cloud[:, 7] == LIDAR], kept)
    if len(fused) > capacity:
        fused = fused[rng.choice(len(fused), capacity, replace=False)]
    return fused


def _padded(streams, capacity):
    pts = np.zeros((len(streams), capacity, 8), np.float32)
    valid = np.zeros((len(streams), capacity), bool)
    for e, s in enumerate(streams):
        pts[e, :len(s)] = s
        valid[e, :len(s)] = True
    return pts, valid


def synth_frames_l(frames, seed=0):
    """``frames`` street scenes as VirConv-L's Detector input: each frame's
    one fused stream (``points``, no ``points_mm``) of at most
    ``N_FUSED_PTS`` points."""
    rng = np.random.RandomState(seed)
    pts, valid = _padded([fused_stream(make_scene(seed=e), rng, N_FUSED_PTS)
                          for e in range(frames)], N_FUSED_PTS)
    v2r, p2t = kitti_calib()
    return {'points': pts, 'points_valid': valid,
            'v2r': np.tile(v2r, (frames, 1, 1)),
            'p2t': np.tile(p2t, (frames, 1, 1))}


def train_batch_l(frames=2, seed=0):
    """VirConv-L's training batch: ``frames`` street scenes, one entry
    each (a loader batch's shape), each frame's fused stream of
    ``N_TRAIN_PTS`` points with the training StVD and its gt boxes
    world-transformed by the first of ``TRAIN_TRANSFORMS``, which is the
    entry's ``trans_params``."""
    rng = np.random.RandomState(seed)
    p = TRAIN_TRANSFORMS[0]
    streams, gt = [], np.zeros((frames, N_TRAIN_GT, 8), np.float32)
    gt_valid = np.zeros((frames, N_TRAIN_GT), bool)
    for e in range(frames):
        s = make_scene(seed=e)
        streams.append(transform_points_np(
            fused_stream(s, rng, N_TRAIN_PTS, training=True), p))
        boxes = s['boxes'][:N_TRAIN_GT]
        gt[e, :len(boxes), :7] = transform_boxes_np(boxes[:, :7], p)
        gt[e, :len(boxes), 7] = 1
        gt_valid[e, :len(boxes)] = True
    pts, valid = _padded(streams, N_TRAIN_PTS)
    v2r, p2t = kitti_calib()
    return {'points': pts, 'points_valid': valid,
            'v2r': np.tile(v2r, (frames, 1, 1)),
            'p2t': np.tile(p2t, (frames, 1, 1)),
            'trans_params': np.tile(p[None], (frames, 1)),
            'transform_param': None, 'gt_boxes': gt, 'gt_valid': gt_valid}


def tiny_batch(rng, n_entries=1, n_pts=1500, train=True, n_rep=1):
    """The batch of the JAX package's model tests (``tests/
    test_model_forward.py::make_batch``, whose arrays it gives bit for bit):
    ``n_pts`` uniform points per entry in the tiny range, both streams the
    same, the last 50 invalid, two gt boxes per frame. ``train``:
    ``trans_params`` of one augmentation; else ``n_rep`` test-time replicas
    per frame (``transform_param``). Draws from ``rng``, a numpy
    ``Generator``."""
    pcr = [0, -8, -3, 16, 8, 1]
    v2r, p2t = identity_calib(fu=200.0, fv=200.0, cu=700.0,
                              cv=300.0).device_matrices()
    pts = rng.uniform([pcr[0], pcr[1], pcr[2], 0, 0, 0, 0, 1],
                      [pcr[3], pcr[4], pcr[5], 1, 1, 1, 1, 2.01],
                      (n_entries, n_pts, 8)).astype(np.float32)
    pts[..., 7] = np.round(pts[..., 7])
    valid = np.ones((n_entries, n_pts), bool)
    valid[:, -50:] = False
    frames = n_entries // n_rep
    gt = np.zeros((frames, 6, 8), np.float32)
    gt[:, 0] = [4, 0, -1, 3.9, 1.6, 1.56, 0.3, 1]
    gt[:, 1] = [10, 3, -1, 3.9, 1.6, 1.56, -0.5, 1]
    gt_valid = np.zeros((frames, 6), bool)
    gt_valid[:, :2] = True
    batch = {'points': pts, 'points_valid': valid, 'points_mm': pts.copy(),
             'points_mm_valid': valid.copy(),
             'v2r': np.tile(v2r, (n_entries, 1, 1)),
             'p2t': np.tile(p2t, (n_entries, 1, 1)),
             'gt_boxes': gt, 'gt_valid': gt_valid}
    if train:
        batch['trans_params'] = np.tile(
            np.array([[0.1, 1.0, 1.01]], np.float32), (n_entries, 1))
        batch['transform_param'] = None
    else:
        params = np.array([[0.3, 0.0, 0.98], [0.3, 1.0, 1.02]],
                          np.float32)[:n_rep]
        batch['transform_param'] = np.tile(params[None], (frames, 1, 1))
        batch['trans_params'] = np.tile(params, (frames, 1))
    return batch
