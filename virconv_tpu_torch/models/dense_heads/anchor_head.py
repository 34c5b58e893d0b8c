"""Anchor-based RPN head with NMS proposals, its target assignment and loss.
Counterpart of ``virconv_tpu/models/dense_heads/anchor_head.py``
(AnchorHeadSingle)."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...config import CfgNode
from ...ops import boxes as box_ops
from ...ops.odiou import odiou_3d_weighted
from ...parallel import data_parallel as dp
from ...utils import trace


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


def nearest_bev_iou(boxes_a, boxes_b):
    """AABB IoU of heading-snapped BEV boxes."""
    def to_aabb(b):
        rot = box_ops.limit_period(b[:, 6], 0.5, math.pi).abs()
        dxdy = torch.where((rot < math.pi / 4)[:, None], b[:, [3, 4]],
                           b[:, [4, 3]])
        return torch.cat([b[:, 0:2] - dxdy / 2, b[:, 0:2] + dxdy / 2], 1)
    a, b = to_aabb(boxes_a), to_aabb(boxes_b)
    lt = torch.maximum(a[:, None, 0:2], b[None, :, 0:2])
    rb = torch.minimum(a[:, None, 2:4], b[None, :, 2:4])
    inter = torch.clamp(rb - lt, min=0.0).prod(-1)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / torch.clamp(area_a[:, None] + area_b[None] - inter,
                               min=1e-6)


def assign_anchor_targets(anchors, gt_boxes, gt_valid, coder,
                          matched_threshold, unmatched_threshold):
    """One sample's axis-aligned target assignment. anchors (N, 7),
    gt_boxes (M, 8) [box7, class], gt_valid (M,). Returns labels (N,) int32
    (-1 ignore, 0 background, class), reg_targets (N, 7), reg_weights (N,)
    and ious (N,)."""
    iou = nearest_bev_iou(anchors, gt_boxes[:, :7])
    iou = torch.where(gt_valid[None, :], iou, torch.full_like(iou, -1.0))
    a2g_max, a2g_arg = iou.max(1)
    g2a_max = iou.amax(0)
    g2a_max = torch.where(g2a_max == 0, torch.full_like(g2a_max, -1.0),
                          g2a_max)
    force = ((iou == g2a_max[None, :]) & gt_valid[None, :]
             & (g2a_max[None, :] > 0)).any(1)
    gt_cls = gt_boxes[:, 7].to(torch.int32)
    labels = torch.full((anchors.shape[0],), -1, dtype=torch.int32,
                        device=anchors.device)
    labels = torch.where(a2g_max < unmatched_threshold,
                         torch.zeros_like(labels), labels)
    labels = torch.where((a2g_max >= matched_threshold) | force,
                         gt_cls[a2g_arg], labels)
    labels = torch.where(gt_valid.any(), labels, torch.zeros_like(labels))
    fg = labels > 0
    tgt = coder.encode(gt_boxes[a2g_arg, :7], anchors)
    return {'labels': labels,
            'reg_targets': torch.where(fg[:, None], tgt,
                                       torch.zeros_like(tgt)),
            'reg_weights': fg.float(),
            'ious': torch.clamp(a2g_max, min=0.0)}


def sigmoid_focal_loss(logits, targets, weights, alpha=0.25, gamma=2.0):
    """Per-element sigmoid focal loss."""
    p = torch.sigmoid(logits)
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1 - p) + (1 - targets) * p
    bce = (torch.clamp(logits, min=0) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    return alpha_w * pt ** gamma * bce * weights[..., None]


def weighted_smooth_l1(preds, targets, weights, beta=1.0 / 9.0,
                       code_weights=None):
    diff = preds - targets
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype,
                                      device=diff.device)
    n = diff.abs()
    loss = torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)
    return loss * weights[..., None]


def compute_anchor_mask(points_xy, points_mask, point_cloud_range,
                        bev_shape):
    """(H, W) anchor occupancy mask shared across the batch: points in a
    x10-coarse grid, OR-dilated one cell forward per axis, upsampled x10;
    the last ``W % 10`` columns (and ``H % 10`` rows) are never set. In a
    data-parallel step the batch is every rank's: the coarse grids are
    OR-ed over the ranks."""
    h, w = bev_shape
    stride = (point_cloud_range[3] - point_cloud_range[0]) / w * 10.0
    ix = ((points_xy[:, 0] - point_cloud_range[0]) / stride).to(torch.int32)
    iy = ((points_xy[:, 1] - point_cloud_range[1]) / stride).to(torch.int32)
    ix = torch.clamp(ix, 0, w // 10 - 1).long()
    iy = torch.clamp(iy, 0, h // 10 - 1).long()
    large = torch.zeros((h // 10, w // 10), dtype=torch.bool,
                        device=points_xy.device)
    large[iy[points_mask], ix[points_mask]] = True
    if dp.active():
        large = dp.global_sum(large.float()) > 0
    pad = torch.nn.functional.pad(large, (0, 1, 0, 1))
    dil = pad[:-1, :-1] | pad[1:, :-1] | pad[:-1, 1:] | pad[1:, 1:]
    fine = dil.repeat_interleave(10, 0).repeat_interleave(10, 1)
    return torch.nn.functional.pad(
        fine, (0, w - fine.shape[1], 0, h - fine.shape[0]))


class AnchorHeadSingle(nn.Module):
    """1x1-conv RPN over BEV features with NMS proposals. A truthy
    ``OD_LOSS`` adds the ODIoU loss term (``ops/odiou.py``) to the RPN
    loss."""

    def __init__(self, model_cfg, in_channels: int, num_class: int,
                 grid_size, point_cloud_range):
        super().__init__()
        mcfg = CfgNode(model_cfg)
        self.od_loss = bool(mcfg.get('OD_LOSS', False))
        cfg = mcfg.ANCHOR_GENERATOR_CONFIG[0]
        anchors, self.bev_shape = generate_anchors(
            point_cloud_range, grid_size, cfg['feature_map_stride'],
            cfg['anchor_sizes'], cfg['anchor_rotations'],
            cfg['anchor_bottom_heights'], cfg.get('align_center', False))
        self.register_buffer('anchors', torch.from_numpy(anchors),
                             persistent=False)
        self.point_cloud_range = tuple(point_cloud_range)
        self.num_class = num_class
        self.matched_threshold = cfg['matched_threshold']
        self.unmatched_threshold = cfg['unmatched_threshold']
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

    def forward(self, bev_feats, points_xy, points_mask, nms_cfg,
                gt_boxes=None, gt_valid=None):
        """bev_feats (B, H, W, C); points_xy (P, 2) anchor-mask points.
        Returns proposals (rois, roi_scores, roi_labels, roi_valid, and the
        NMS keep indices), and in train mode the predictions and the anchor
        targets of gt_boxes (B, M, 8) / gt_valid (B, M) for ``loss``."""
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
        with torch.no_grad(), trace.span('rpn.nms'):   # selection only
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
        out = {
            'rois': rois,
            'roi_scores': torch.where(valid, scores[brange, sel],
                                      torch.zeros_like(scores[brange, sel])),
            'roi_labels': torch.where(valid, roi_labels[brange, sel],
                                      torch.ones_like(sel)),
            'roi_valid': valid,
            'keep': sel,
        }
        if self.training:
            with trace.span('rpn.anchor_targets'):
                tgt = [assign_anchor_targets(
                    self.anchors, gt_boxes[i], gt_valid[i], self.coder,
                    self.matched_threshold, self.unmatched_threshold)
                    for i in range(b)]
            tgt = {k: torch.stack([t[k] for t in tgt]) for k in tgt[0]}
            tgt['labels'] = torch.where(amask_flat[None, :], tgt['labels'],
                                        torch.full_like(tgt['labels'], -1))
            tgt['reg_weights'] = tgt['reg_weights'] * amask_flat[None, :]
            out.update(cls_preds=cls_preds, box_preds=box_preds,
                       dir_preds=dir_preds, targets=tgt)
        return out

    def loss(self, out, loss_weights, code_weights):
        """RPN loss: focal classification, smooth-L1 box regression with a
        sin-difference heading, direction cross-entropy, and with
        ``OD_LOSS`` the ODIoU term. Returns (total, {rpn_loss_cls,
        rpn_loss_loc, rpn_loss_dir[, rpn_loss_od]})."""
        tgt = out['targets']
        labels = tgt['labels']
        # the frame count of the '/ b' terms and the ODIoU's positive count
        # are the global batch's in a data-parallel step; the per-frame
        # pos_norm stays the frame's
        b = dp.global_int(labels.shape[0], labels.device)
        positives = labels > 0
        negatives = labels == 0
        pos_norm = torch.clamp(positives.sum(1, keepdim=True).float(),
                               min=1.0)
        cls_w = (negatives | positives).float() / pos_norm
        reg_w = positives.float() / pos_norm
        if self.num_class == 1:
            cls_t = positives.long()
        else:
            cls_t = (labels * (labels >= 0)).long()
        one_hot = torch.nn.functional.one_hot(
            cls_t, self.num_class + 1)[..., 1:].float()
        cls_loss = sigmoid_focal_loss(out['cls_preds'], one_hot,
                                      cls_w).sum() / b
        cls_loss = cls_loss * loss_weights['cls_weight']

        bp, rt = out['box_preds'], tgt['reg_targets']
        sin_p = torch.sin(bp[..., 6:7]) * torch.cos(rt[..., 6:7])
        sin_t = torch.cos(bp[..., 6:7]) * torch.sin(rt[..., 6:7])
        bp2 = torch.cat([bp[..., :6], sin_p, bp[..., 7:]], -1)
        rt2 = torch.cat([rt[..., :6], sin_t, rt[..., 7:]], -1)
        loc_loss = weighted_smooth_l1(bp2, rt2, reg_w,
                                      code_weights=code_weights).sum() / b
        loc_loss = loc_loss * loss_weights['loc_weight']

        rot_gt = rt[..., 6] + self.anchors[None, :, 6]
        offset_rot = box_ops.limit_period(rot_gt - self.dir_offset, 0,
                                          2 * math.pi)
        dir_t = torch.clamp((offset_rot / (2 * math.pi / self.num_dir_bins))
                            .to(torch.int64), 0, self.num_dir_bins - 1)
        dir_oh = torch.nn.functional.one_hot(dir_t, self.num_dir_bins).float()
        logp = torch.log_softmax(out['dir_preds'], -1)
        dir_w = positives.float()
        dir_w = dir_w / torch.clamp(dir_w.sum(-1, keepdim=True), min=1.0)
        dir_loss = -(dir_oh * logp).sum(-1) * dir_w
        dir_loss = dir_loss.sum() / b * loss_weights['dir_weight']
        total = cls_loss + loc_loss + dir_loss
        tb = {'rpn_loss_cls': cls_loss, 'rpn_loss_loc': loc_loss,
              'rpn_loss_dir': dir_loss}
        if self.od_loss:
            # the reference's normalization (anchor_head_template.py:296-318
            # and odiou_loss.py:904-906, as the JAX package has it):
            # 2 * sum(od over positives) / b, scaled by 2 / (n_pos + 1).
            # Only positive anchors weigh in, so only they are computed.
            anchors = self.anchors[None]
            gt = self.coder.decode(rt, anchors)[positives]
            od = odiou_3d_weighted(gt, self.coder.decode(bp, anchors)
                                   [positives], torch.ones_like(gt[:, 0]), b)
            od = 2.0 * od / (dp.global_sum(positives.sum()) + 1)
            total = total + od
            tb['rpn_loss_od'] = od
        return total, tb
