"""Anchor-based RPN head, eval forward with NMS proposals. Counterpart of
``virconv_tpu/models/dense_heads/anchor_head.py`` (AnchorHeadSingle)."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...config import CfgNode
from ...ops import boxes as box_ops


def generate_anchors(point_cloud_range, grid_size, stride, anchor_sizes,
                     anchor_rotations, anchor_bottom_heights,
                     align_center=False):
    """Dense anchor grid, flattened (y, x, size, rot) -> (N, 7) float32."""
    pcr = np.asarray(point_cloud_range, np.float64)
    nx, ny = grid_size[0] // stride, grid_size[1] // stride
    if align_center:
        x_stride = (pcr[3] - pcr[0]) / nx
        y_stride = (pcr[4] - pcr[1]) / ny
        x_off, y_off = x_stride / 2, y_stride / 2
    else:
        x_stride = (pcr[3] - pcr[0]) / (nx - 1)
        y_stride = (pcr[4] - pcr[1]) / (ny - 1)
        x_off = y_off = 0.0
    xs = pcr[0] + x_off + np.arange(nx) * x_stride
    ys = pcr[1] + y_off + np.arange(ny) * y_stride
    sizes = np.asarray(anchor_sizes, np.float64)
    rots = np.asarray(anchor_rotations, np.float64)
    heights = np.asarray(anchor_bottom_heights, np.float64)
    gz, gy, gx = np.meshgrid(heights, ys, xs, indexing='ij')
    base = np.stack([gx, gy, gz], axis=-1)
    a = np.broadcast_to(base[:, :, :, None, None, :],
                        base.shape[:3] + (len(sizes), len(rots), 3))
    s = np.broadcast_to(sizes[None, None, None, :, None, :], a.shape)
    r = np.broadcast_to(rots[None, None, None, None, :, None],
                        a.shape[:5] + (1,))
    anchors = np.concatenate([a, s, r], axis=-1).copy()
    anchors[..., 2] += anchors[..., 5] / 2
    return anchors.reshape(-1, 7).astype(np.float32), (ny, nx)


def compute_anchor_mask(points_xy, points_mask, point_cloud_range,
                        bev_shape):
    """(H, W) anchor occupancy mask shared across the batch: points in a
    x10-coarse grid, OR-dilated one cell forward per axis, upsampled x10;
    the last ``W % 10`` columns (and ``H % 10`` rows) are never set."""
    h, w = bev_shape
    stride = (point_cloud_range[3] - point_cloud_range[0]) / w * 10.0
    ix = ((points_xy[:, 0] - point_cloud_range[0]) / stride).to(torch.int32)
    iy = ((points_xy[:, 1] - point_cloud_range[1]) / stride).to(torch.int32)
    ix = torch.clamp(ix, 0, w // 10 - 1).long()
    iy = torch.clamp(iy, 0, h // 10 - 1).long()
    large = torch.zeros((h // 10, w // 10), dtype=torch.bool,
                        device=points_xy.device)
    large[iy[points_mask], ix[points_mask]] = True
    pad = torch.nn.functional.pad(large, (0, 1, 0, 1))
    dil = pad[:-1, :-1] | pad[1:, :-1] | pad[:-1, 1:] | pad[1:, 1:]
    fine = dil.repeat_interleave(10, 0).repeat_interleave(10, 1)
    return torch.nn.functional.pad(
        fine, (0, w - fine.shape[1], 0, h - fine.shape[0]))


class AnchorHeadSingle(nn.Module):
    """1x1-conv RPN over BEV features with NMS proposals."""

    def __init__(self, model_cfg, in_channels: int, num_class: int,
                 grid_size, point_cloud_range):
        super().__init__()
        mcfg = CfgNode(model_cfg)
        cfg = mcfg.ANCHOR_GENERATOR_CONFIG[0]
        anchors, self.bev_shape = generate_anchors(
            point_cloud_range, grid_size, cfg['feature_map_stride'],
            cfg['anchor_sizes'], cfg['anchor_rotations'],
            cfg['anchor_bottom_heights'], cfg.get('align_center', False))
        self.register_buffer('anchors', torch.from_numpy(anchors),
                             persistent=False)
        self.point_cloud_range = tuple(point_cloud_range)
        self.num_class = num_class
        self.num_anchors_per_loc = (len(cfg['anchor_sizes'])
                                    * len(cfg['anchor_rotations'])
                                    * len(cfg['anchor_bottom_heights']))
        self.coder = box_ops.ResidualCoder()
        self.num_dir_bins = mcfg.get('NUM_DIR_BINS', 2)
        self.dir_offset = mcfg.get('DIR_OFFSET', 0.78539)
        self.dir_limit_offset = mcfg.get('DIR_LIMIT_OFFSET', 0.0)
        na = self.num_anchors_per_loc
        self.conv_cls = nn.Conv2d(in_channels, na * num_class, 1)
        self.conv_box = nn.Conv2d(in_channels, na * self.coder.code_size, 1)
        self.conv_dir = nn.Conv2d(in_channels, na * self.num_dir_bins, 1)

    def forward(self, bev_feats, points_xy, points_mask, nms_cfg):
        """bev_feats (B, H, W, C); points_xy (P, 2) anchor-mask points.
        Returns proposals (rois, roi_scores, roi_labels, roi_valid)."""
        b = bev_feats.shape[0]
        x = bev_feats.permute(0, 3, 1, 2)

        def head(conv, width):
            return conv(x).permute(0, 2, 3, 1).reshape(b, -1, width)
        cls_preds = head(self.conv_cls, self.num_class)
        box_preds = head(self.conv_box, self.coder.code_size)
        dir_preds = head(self.conv_dir, self.num_dir_bins)

        amask = compute_anchor_mask(points_xy, points_mask,
                                    self.point_cloud_range, self.bev_shape)
        amask_flat = amask.reshape(-1).repeat_interleave(
            self.num_anchors_per_loc)

        batch_boxes = self.coder.decode(box_preds, self.anchors[None])
        dir_labels = dir_preds.argmax(-1)
        period = 2 * math.pi / self.num_dir_bins
        dir_rot = box_ops.limit_period(batch_boxes[..., 6] - self.dir_offset,
                                       self.dir_limit_offset, period)
        heading = dir_rot + self.dir_offset + period * dir_labels
        batch_boxes = torch.cat([batch_boxes[..., :6], heading[..., None],
                                 batch_boxes[..., 7:]], -1)

        scores = torch.sigmoid(cls_preds.amax(-1))
        roi_labels = cls_preds.argmax(-1) + 1
        sels, valids = [], []
        for i in range(b):
            sel, valid = box_ops.nms_bev(
                batch_boxes[i], scores[i], nms_cfg['thresh'],
                pre_max=nms_cfg['pre'], post_max=nms_cfg['post'],
                valid=amask_flat)
            sels.append(sel)
            valids.append(valid)
        sel = torch.stack(sels)
        valid = torch.stack(valids)
        brange = torch.arange(b, device=sel.device)[:, None]
        rois = torch.where(valid[..., None], batch_boxes[brange, sel],
                           torch.zeros_like(batch_boxes[brange, sel]))
        return {
            'rois': rois,
            'roi_scores': torch.where(valid, scores[brange, sel],
                                      torch.zeros_like(scores[brange, sel])),
            'roi_labels': torch.where(valid, roi_labels[brange, sel],
                                      torch.ones_like(sel)),
            'roi_valid': valid,
            'keep': sel,
        }
