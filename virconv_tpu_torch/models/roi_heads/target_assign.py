"""ROI proposal target sampling and the canonical-frame gt transform.
Counterpart of ``virconv_tpu/models/roi_heads/target_assign.py``.

Each ROI gets a random key within its category (foreground, hard
background, easy background); a stable argsort groups the categories, and
per-slot gathers compose the fixed-size sample, background with
replacement. The random numbers come in as tensors (``train.draws.Draws``):
per sample three uniforms over the proposals and ``ROI_PER_IMAGE`` integers
in [0, 2**30), and per call the hard-sampling stripe start. Gradients flow
through the sampled rois, their IoUs (the soft class labels) and the
canonical gt, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from ...ops import boxes as box_ops
from ...parallel import data_parallel as dp


def _canonical_gt(rois, gt_of_rois):
    """gt boxes in each roi's canonical frame, heading flipped into
    [-pi/2, pi/2]."""
    roi_ry = rois[..., 6] % (2 * math.pi)
    gt = torch.cat([gt_of_rois[..., 0:3] - rois[..., 0:3],
                    gt_of_rois[..., 3:6],
                    gt_of_rois[..., 6:7] - roi_ry[..., None],
                    gt_of_rois[..., 7:]], -1)
    b, n = gt.shape[0], gt.shape[1]
    gt = box_ops.rotate_points_along_z(gt.reshape(-1, 1, gt.shape[-1]),
                                       -roi_ry.reshape(-1)).reshape(b, n, -1)
    heading = gt[..., 6] % (2 * math.pi)
    opposite = (heading > math.pi * 0.5) & (heading < math.pi * 1.5)
    heading = torch.where(opposite, (heading + math.pi) % (2 * math.pi),
                          heading)
    heading = torch.where(heading > math.pi, heading - 2 * math.pi, heading)
    heading = torch.clamp(heading, -math.pi / 2, math.pi / 2)
    return torch.cat([gt[..., :6], heading[..., None], gt[..., 7:]], -1)


def sample_rois_single(u_fg, u_hard, u_easy, rand_sel, rois, roi_scores,
                       roi_labels, gt_boxes, gt_valid, cfg):
    """One sample's ROI subsampling. rois (R, 7), gt (M, 8); ``u_*`` (R,)
    uniforms and ``rand_sel`` (ROI_PER_IMAGE,) integers. Returns a dict of
    (ROI_PER_IMAGE,) tensors, with the sampled indices under 'sampled'."""
    roi_per_image = int(cfg.ROI_PER_IMAGE)
    fg_quota = int(round(cfg.FG_RATIO * roi_per_image))
    dev = rois.device

    iou = box_ops.boxes_iou3d(rois[:, :7], gt_boxes[:, :7])
    gt_cls = gt_boxes[:, 7].to(torch.int64)
    same_cls = roi_labels[:, None] == gt_cls[None, :]
    iou = torch.where(same_cls & gt_valid[None, :], iou,
                      torch.full_like(iou, -1.0))
    iou_max, gt_assignment = iou.max(1)
    max_overlaps = torch.clamp(iou_max, min=0.0)

    n_cls = len(cfg.CLS_FG_THRESH)
    fg_thresh = torch.tensor([min(cfg.REG_FG_THRESH[i], cfg.CLS_FG_THRESH[i])
                              for i in range(n_cls)], dtype=torch.float32,
                             device=dev)
    cls_idx = torch.clamp(gt_cls[gt_assignment] - 1, 0, n_cls - 1)
    mo = max_overlaps.detach()
    is_fg = mo >= fg_thresh[cls_idx]
    is_easy_bg = mo < cfg.CLS_BG_THRESH_LO
    # everything that is neither foreground nor easy background is hard
    # background (fg_thresh <= reg_fg, so the JAX package's two hard-bg
    # terms together cover exactly that)
    is_hard_bg = ~is_fg & ~is_easy_bg

    n_fg = is_fg.sum()
    n_hard = is_hard_bg.sum()
    n_easy = is_easy_bg.sum()
    inf = torch.full_like(u_fg, float('inf'))
    fg_order = torch.argsort(torch.where(is_fg, u_fg, inf), stable=True)
    hard_order = torch.argsort(torch.where(is_hard_bg, u_hard, inf),
                               stable=True)
    easy_order = torch.argsort(torch.where(is_easy_bg, u_easy, inf),
                               stable=True)

    fg_take = torch.where(n_hard + n_easy == 0,
                          torch.full_like(n_fg, roi_per_image),
                          torch.clamp(n_fg, max=fg_quota))
    bg_needed = roi_per_image - fg_take
    hard_num = torch.where(
        (n_hard > 0) & (n_easy > 0),
        torch.minimum((bg_needed.float() * cfg.HARD_BG_RATIO).to(torch.int64),
                      n_hard),
        torch.where(n_hard > 0, bg_needed, torch.zeros_like(bg_needed)))

    slots = torch.arange(roi_per_image, device=dev)
    fg_pos = torch.where(slots < n_fg, slots,
                         rand_sel % torch.clamp(n_fg, min=1))
    fg_idx = fg_order[fg_pos]
    hard_idx = hard_order[rand_sel % torch.clamp(n_hard, min=1)]
    easy_idx = easy_order[rand_sel % torch.clamp(n_easy, min=1)]
    bg_idx = torch.where(slots - fg_take < hard_num, hard_idx, easy_idx)
    sampled = torch.where(slots < fg_take, fg_idx, bg_idx)

    out_gt = gt_boxes[gt_assignment[sampled]]
    out_gt = torch.where(gt_valid.any(), out_gt, torch.zeros_like(out_gt))
    return {'rois': rois[sampled], 'roi_labels': roi_labels[sampled],
            'roi_ious': max_overlaps[sampled],
            'roi_scores': roi_scores[sampled], 'gt_of_rois': out_gt,
            'sampled': sampled}


def proposal_targets(rng, rois, roi_scores, roi_labels, gt_boxes, gt_valid,
                     cfg):
    """Batched ROI sampling with labels and masks (CLS_SCORE_TYPE
    roi_iou_x). ``rng``: the step's draws (``train.draws.Draws``)."""
    b, r = rois.shape[0], rois.shape[1]
    dev = rois.device
    n_roi = int(cfg.ROI_PER_IMAGE)
    per = []
    for i in range(b):
        u = [rng.uniform((r,), dev, entry=(i, b)) for _ in range(3)]
        rand_sel = rng.randint(2 ** 30, (n_roi,), dev, entry=(i, b))
        per.append(sample_rois_single(*u, rand_sel, rois[i], roi_scores[i],
                                      roi_labels[i], gt_boxes[i],
                                      gt_valid[i], cfg))
    sampled = {k: torch.stack([p[k] for p in per]) for k in per[0]}

    ious = sampled['roi_ious']
    gt_of = sampled['gt_of_rois']
    gt_cls = gt_of[..., -1].to(torch.int64)
    n_cls = len(cfg.CLS_FG_THRESH)
    reg_valid = torch.zeros(ious.shape, dtype=torch.int32, device=dev)
    for ci in range(n_cls):
        cls_mask = gt_cls == ci + 1
        reg_fg = cfg.REG_FG_THRESH[ci]
        reg_valid = reg_valid + ((ious > reg_fg) & cls_mask).to(torch.int32)
        if cfg.get('ENABLE_HARD_SAMPLING', False):
            hard = ((ious < reg_fg) & (ious > cfg.HARD_SAMPLING_THRESH[ci])
                    & cls_mask)
            teval = int(1 / cfg.HARD_SAMPLING_RATIO[ci])
            # one start for the whole batch (rank 0's in a data-parallel
            # step), tested on the global entry index
            start = dp.broadcast(rng.randint(teval, (), dev, shared=True))
            off = dp.entry_offset(b, dev)
            stripe = (torch.arange(off, off + b, device=dev) % teval) == start
            reg_valid = reg_valid + (hard & stripe[:, None]).to(torch.int32)

    cls_labels = torch.zeros_like(ious)
    for ci in range(n_cls):
        cls_mask = gt_cls == ci + 1
        fg_t, bg_t = cfg.CLS_FG_THRESH[ci], cfg.CLS_BG_THRESH[ci]
        lab = (ious > fg_t).float()
        interval = (ious <= fg_t) & (ious >= bg_t)
        lab = torch.where(interval, (ious - bg_t) / (fg_t - bg_t), lab)
        cls_labels = torch.where(cls_mask, lab, cls_labels)

    return {'rois': sampled['rois'], 'roi_labels': sampled['roi_labels'],
            'roi_scores': sampled['roi_scores'], 'gt_iou_of_rois': ious,
            'gt_of_rois': _canonical_gt(sampled['rois'], gt_of),
            'gt_of_rois_src': gt_of, 'reg_valid_mask': reg_valid,
            'rcnn_cls_labels': cls_labels, 'sampled': sampled['sampled']}
