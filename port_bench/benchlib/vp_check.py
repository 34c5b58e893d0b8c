"""The comparison that decides ``correct`` in the virtual-point cell: the
measured side's coarse depth, refined depth and fused cloud of a frame
against ``refnet``'s PENet_C2 in float32 (TF32 off) on the same weights
and inputs, and its ``depth2points``.

- ``coarse_gap``: ENet's fused depth, the largest difference over the
  reference's largest magnitude;
- ``depth_gap``: the refined depth after both CSPN stages, the same;
- ``points_miss``: the reference's ``depth2points`` on the measured side's
  own depth has to give the measured side's cloud exactly: the points
  whose float16 bits differ (a cloud of another length counts as a
  mismatch);
- ``count_gap``: the virtual points kept, the measured side's against the
  reference's own cloud (from its own depth), relative: a depth that moves
  by round-off can flip a pixel across the (0.1, 100) m range, the z = 1 m
  cut or a thinning bin.

Each is the worst over the frames judged.
"""

from __future__ import annotations

import numpy as np
import torch

from .judge import MISMATCH, relgap

NUMBERS = ('coarse_gap', 'depth_gap', 'points_miss', 'count_gap')


@torch.no_grad()
def reference_frame(model, inputs):
    """The reference's (coarse, refined depth) of one frame, on the host."""
    p = model.heads(*inputs)
    depth = model.propagate(p)
    return p['coarse'][0, 0].cpu(), depth[0, 0].cpu()


def points_miss(cloud, redone):
    if cloud.shape != redone.shape:
        return MISMATCH
    differ = (cloud.view(np.uint16) != redone.view(np.uint16)).any(1)
    return float(differ.sum())


def judge_frame(model, inputs, prep, side):
    """The numbers of one frame: ``prep`` the frame's prepared arrays,
    ``side`` the measured side's {'coarse', 'depth', 'cloud'} (host
    arrays or tensors)."""
    from refnet.depth2points import frame_points
    _, rgb_c, _, _, k_mat, calib, lidar, _ = prep
    coarse, depth = reference_frame(model, inputs)
    mine_depth = np.asarray(side['depth'], np.float32)
    ref_cloud = frame_points(depth.numpy(), rgb_c, k_mat, calib, lidar)
    redone = frame_points(mine_depth, rgb_c, k_mat, calib, lidar)
    n_ref = len(ref_cloud) - len(lidar)
    n_mine = len(side['cloud']) - len(lidar)
    return {
        'coarse_gap': relgap(torch.as_tensor(side['coarse']), coarse),
        'depth_gap': relgap(torch.as_tensor(mine_depth), depth),
        'points_miss': points_miss(side['cloud'], redone),
        'count_gap': abs(n_mine - n_ref) / max(n_ref, 1)}


def judge_frames(model, frames, device, picks, sides):
    """Each number's worst over the frames: ``picks`` the pool index of
    each judged frame, ``sides`` its measured side."""
    out = dict.fromkeys(NUMBERS, 0.0)
    for k, side in zip(picks, sides):
        got = judge_frame(model, frames.inputs(k, device), frames.pool[k],
                          side)
        for name, v in got.items():
            out[name] = max(out[name], v)
    return out
