"""TED multimodal cascade ROI head (TEDMHead) and its loss. Counterpart of
``virconv_tpu/models/roi_heads/ted_head.py``.

Per cascade stage i the rois are re-expressed in transform replica i's
frame, grid-pooled from the LiDAR and multimodal streams (replica i is
batch entry b * rot_num + i), passed through shared FCs, cross-attended
against the earlier stages, and classified / regressed by three branches
(fused, multimodal-only, LiDAR-only; eval uses the fused one); a BEV "PART"
confidence sampled at 7x7 in-box points is added to the logits. The final
prediction is the mean over stages. In train mode each stage first samples
its rois against the gt boxes (``target_assign.proposal_targets``) and FC
dropout is on; nothing is detached, so the losses reach the RPN's box
branch through the proposals, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from ...config import CfgNode
from ...ops import boxes as box_ops
from ...parallel import data_parallel as dp
from ...utils import trace
from ...utils import transforms as tr
from ..layers import DenseConvBlock, MaskedBatchNorm
from .target_assign import proposal_targets
from .voxel_pool import NeighborVoxelSAModule, build_pool_tables


def positional_embedding(pos_seq, demb: int = 8):
    inv_freq = 1.0 / (10000 ** (torch.arange(0, demb, 2.0,
                                             device=pos_seq.device) / demb))
    sinusoid = pos_seq[:, None] * inv_freq[None, :]
    return torch.cat([torch.sin(sinusoid), torch.cos(sinusoid)], -1)


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (query scaled by 1/sqrt(d))."""

    def __init__(self, features: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(features, features)
        self.key = nn.Linear(features, features)
        self.value = nn.Linear(features, features)
        self.out = nn.Linear(features, features)

    def forward(self, q, k, v):
        """q (B, Lq, C), k / v (B, Lk, C) -> (B, Lq, C)."""
        b, lq, c = q.shape
        h = self.num_heads
        hd = c // h
        qh = self.query(q).reshape(b, lq, h, hd) / math.sqrt(hd)
        kh = self.key(k).reshape(b, -1, h, hd)
        vh = self.value(v).reshape(b, -1, h, hd)
        logits = torch.einsum('bqhd,bkhd->bhqk', qh, kh)
        attn = torch.softmax(logits, -1)
        o = torch.einsum('bhqk,bkhd->bqhd', attn, vh).reshape(b, lq, c)
        return self.out(o)


class CrossAttention(nn.Module):
    """Current stage feature against the stage history, with positional
    embeddings of the stage index and 4-head attention."""

    def __init__(self, hidden_dim: int, num_heads: int = 4,
                 pos_dim: int = 8):
        super().__init__()
        self.pos_dim = pos_dim
        self.q = nn.Linear(hidden_dim + pos_dim, hidden_dim, bias=False)
        self.k = nn.Linear(hidden_dim + pos_dim, hidden_dim, bias=False)
        self.v = nn.Linear(hidden_dim + pos_dim, hidden_dim, bias=False)
        self.mha = MultiHeadAttention(hidden_dim, num_heads)

    def forward(self, inputs, q_in):
        """inputs (S, B, C) history; q_in (1, B, C). Returns (1, B, C)."""
        s, b, _ = inputs.shape
        dev = inputs.device
        pos_k = positional_embedding(
            torch.arange(1, s + 1, dtype=torch.float32, device=dev),
            self.pos_dim)
        pos_q = positional_embedding(torch.tensor([float(s)], device=dev),
                                     self.pos_dim)
        k_in = torch.cat([inputs, pos_k[:, None].expand(s, b, self.pos_dim)],
                         -1)
        q_full = torch.cat([q_in, pos_q[:, None].expand(1, b, self.pos_dim)],
                           -1)
        q = self.q(q_full).transpose(0, 1)
        k = self.k(k_in).transpose(0, 1)
        v = self.v(k_in).transpose(0, 1)
        return self.mha(q, k, v).transpose(0, 1)


class FCStack(nn.Module):
    """Linear + masked BN + ReLU stack with an optional final projection;
    in train mode dropout after every layer but the last, its keep mask
    drawn from ``rng``."""

    def __init__(self, in_features: int, widths, out_features=None,
                 dp_ratio: float = 0.0):
        super().__init__()
        self.n = len(widths)
        self.dp_ratio = dp_ratio
        c = in_features
        for i, w in enumerate(widths):
            setattr(self, f'fc{i}', nn.Linear(c, w, bias=False))
            setattr(self, f'bn{i}', MaskedBatchNorm(w))
            c = w
        self.out = nn.Linear(c, out_features) if out_features else None

    def forward(self, x, mask, rng=None):
        for i in range(self.n):
            x = getattr(self, f'fc{i}')(x)
            x = torch.relu(getattr(self, f'bn{i}')(x, mask))
            if self.training and self.dp_ratio > 0 and i != self.n - 1:
                keep_p = 1.0 - self.dp_ratio
                keep = rng.uniform(x.shape, x.device) < keep_p
                x = torch.where(keep, x / keep_p, torch.zeros_like(x))
        return self.out(x) if self.out is not None else x


def dense_grid_points(rois, grid_size: int):
    """(N, G^3, 3) grid points of rois (N, 7) in the world frame."""
    g = grid_size
    idx = np.stack(np.meshgrid(np.arange(g), np.arange(g), np.arange(g),
                               indexing='ij'), -1).reshape(-1, 3)
    idx = torch.as_tensor(idx, dtype=torch.float32, device=rois.device)
    local = (idx[None] + 0.5) / g * rois[:, None, 3:6] \
        - rois[:, None, 3:6] / 2
    world = box_ops.rotate_points_along_z(local, rois[:, 6])
    return world + rois[:, None, 0:3]


def bilinear_sample_per_channel(image, xs, ys):
    """image (H, W, C); xs, ys (C, N) pixel coords (align_corners=False);
    channel c sampled at (xs[c], ys[c]); zero padding outside."""
    h, w, c = image.shape
    x = xs - 0.5
    y = ys - 0.5
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    cc = torch.arange(c, device=image.device)[:, None]

    def tap(xi, yi, wgt):
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        val = image[torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1), cc]
        return val * wgt * ok
    wx1 = x - x0
    wy1 = y - y0
    return (tap(x0, y0, (1 - wx1) * (1 - wy1))
            + tap(x0 + 1, y0, wx1 * (1 - wy1))
            + tap(x0, y0 + 1, (1 - wx1) * wy1)
            + tap(x0 + 1, y0 + 1, wx1 * wy1))


def gen_sample_grid(rois, grid_size=7, grid_offsets=(0.0, 40.0),
                    spatial_scale=2.5):
    """BEV sample locations per roi in feature-map pixels: xs, ys
    (grid^2, N)."""
    n = rois.shape[0]
    idx = np.stack(np.meshgrid(np.arange(grid_size), np.arange(grid_size),
                               indexing='ij'), -1).reshape(-1, 2)
    idx = torch.as_tensor(idx, dtype=torch.float32, device=rois.device)
    size = rois[:, 3:5]
    local = idx[None] / (grid_size - 1) * size[:, None] - size[:, None] / 2
    local3 = torch.cat([local, torch.ones((n, grid_size ** 2, 1),
                                          device=rois.device)], -1)
    world = box_ops.rotate_points_along_z(local3, rois[:, 6]) + torch.cat(
        [rois[:, 0:2], torch.zeros((n, 1), device=rois.device)], -1)[:, None]
    x = (world[..., 0] + grid_offsets[0]) * spatial_scale
    y = (world[..., 1] + grid_offsets[1]) * spatial_scale
    return x.T, y.T


class TEDMHead(nn.Module):
    """Cascade / ensemble refinement head."""

    def __init__(self, model_cfg, num_class: int, rot_num: int, voxel_size,
                 point_cloud_range, input_channels: Dict[str, int],
                 bev_channels: int, code_size: int = 7):
        super().__init__()
        cfg = CfgNode(model_cfg)
        self.cfg = cfg
        self.num_class = num_class
        self.rot_num = rot_num
        self.code_size = code_size
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        pooled_c = {}
        for name, pool_cfg in (('pool', cfg.ROI_GRID_POOL),
                               ('pool_mm', cfg.ROI_GRID_POOL_MM)):
            total = 0
            for src in pool_cfg.FEATURES_SOURCE:
                lc = pool_cfg.POOL_LAYERS[src]
                setattr(self, f'{name}_{src}', NeighborVoxelSAModule(
                    input_channels[src], lc.QUERY_RANGES, lc.POOL_RADIUS,
                    lc.NSAMPLE, lc.MLPS, voxel_size, point_cloud_range))
                total += sum(m[1] for m in lc.MLPS)
            pooled_c[name] = total * pool_cfg.GRID_SIZE ** 3
        shared = tuple(cfg.SHARED_FC)
        hid = shared[-1]
        dp = cfg.DP_RATIO
        self.shared_fc = FCStack(pooled_c['pool'], shared, dp_ratio=dp)
        self.shared_fc_mm = FCStack(pooled_c['pool_mm'], shared, dp_ratio=dp)
        self.cross_attn = CrossAttention(hid)
        self.cross_attn_mm = CrossAttention(hid)
        cs = code_size * num_class
        self.cls_head = FCStack(4 * hid, cfg.CLS_FC, num_class, dp)
        self.reg_head = FCStack(4 * hid, cfg.REG_FC, cs, dp)
        self.cls_head_pi = FCStack(2 * hid, cfg.CLS_FC, num_class, dp)
        self.reg_head_pi = FCStack(2 * hid, cfg.REG_FC, cs, dp)
        self.cls_head_p = FCStack(2 * hid, cfg.CLS_FC, num_class, dp)
        self.reg_head_p = FCStack(2 * hid, cfg.REG_FC, cs, dp)
        self.use_part = cfg.get('PART', None) is not None
        if self.use_part:
            self.part_conv1 = DenseConvBlock(bev_channels, cfg.PART.IN_CHANNEL)
            self.part_conv2 = nn.Conv2d(cfg.PART.IN_CHANNEL,
                                        cfg.PART.SIZE ** 2, 1, bias=False)
        self.coder = box_ops.ResidualCoder()

    def _roi_grid_pool(self, name, pool_cfg, feats_3d, strides, rois,
                       roi_valid, entry_idx, tables, bf16):
        with trace.span('roi_head.grid_pool'):
            b, n = rois.shape[0], rois.shape[1]
            g = pool_cfg.GRID_SIZE
            dev = rois.device
            grid_xyz = dense_grid_points(rois.reshape(-1, rois.shape[-1]),
                                         g)
            grid_xyz = grid_xyz.reshape(b, n * g ** 3, 3)
            qmask = roi_valid.reshape(b, n).repeat_interleave(g ** 3, 1)
            pcr = torch.as_tensor(self.point_cloud_range[:3],
                                  dtype=torch.float32, device=dev)
            vs = torch.as_tensor(self.voxel_size, dtype=torch.float32,
                                 device=dev)
            base = torch.floor((grid_xyz - pcr) / vs).to(torch.int32)
            outs = []
            for src in pool_cfg.FEATURES_SOURCE:
                st = feats_3d[src]
                stride = strides[src]
                cz, cy, cx = (torch.div(base[..., i], stride,
                                        rounding_mode='floor')
                              for i in (2, 1, 0))
                be = entry_idx[:, None].expand(b, n * g ** 3).to(torch.int32)
                qc = torch.stack([be, cz, cy, cx], -1).reshape(-1, 4)
                key = (name, src)

                def table_fn(st=st, key=key):
                    if key not in tables:
                        tables[key] = build_pool_tables(st)
                    return tables[key]
                outs.append(getattr(self, f'{name}_{src}')(
                    st, stride, grid_xyz.reshape(-1, 3), qc,
                    qmask.reshape(-1), table_fn=table_fn, q_per_roi=g ** 3,
                    bf16=bf16))
            pooled = torch.cat(outs, -1)
            return (pooled.reshape(b * n, -1),
                    qmask.reshape(b * n, g ** 3)[:, 0])

    def _part_scores(self, parts_feat, rois_score):
        cfg = self.cfg.PART
        scale = 1.0 / cfg.FEATMAP_STRIDE
        out = []
        for img, boxes in zip(parts_feat, rois_score):
            xs, ys = gen_sample_grid(boxes, cfg.SIZE, tuple(cfg.GRID_OFFSETS),
                                     scale)
            out.append(bilinear_sample_per_channel(img, xs, ys).mean(0))
        return torch.stack(out)

    def decode_boxes(self, rois, reg):
        """Decode canonical-frame residuals into world boxes."""
        b, n = rois.shape[0], rois.shape[1]
        local = torch.cat([torch.zeros_like(rois[..., 0:3]), rois[..., 3:]],
                          -1)
        dec = self.coder.decode(reg.reshape(b, n, -1), local)
        flat = dec.reshape(-1, dec.shape[-1])
        flat = box_ops.rotate_points_along_z(flat[:, None, :],
                                             rois[..., 6].reshape(-1))[:, 0]
        flat = torch.cat([flat[:, 0:3] + rois[..., 0:3].reshape(-1, 3),
                          flat[:, 3:]], -1)
        return flat.reshape(b, n, -1)

    def forward(self, feats_lidar, feats_mm, strides, proposals, bev_feats,
                transform_params, bf16: bool = True, gt_boxes=None,
                gt_valid=None, rng=None):
        """feats_lidar / feats_mm: multi-scale SparseTensors (entries
        b * n_replicas + i); proposals from the anchor head; bev_feats
        (B, H, W, C); transform_params (B, n_replicas, 3) or None. Train
        mode: gt_boxes (B, M, 8) / gt_valid (B, M), ``rng`` the step's
        draws; the output adds the per-stage ``stage_targets`` of
        ``loss``."""
        train = self.training
        rois = proposals['rois'][..., :7]
        roi_scores = proposals['roi_scores']
        roi_labels = proposals['roi_labels']
        roi_valid = proposals['roi_valid']
        b = rois.shape[0]
        n_rep = transform_params.shape[1] if transform_params is not None \
            else 1
        entry_base = torch.arange(b, dtype=torch.int32,
                                  device=rois.device) * n_rep
        parts_feat = None
        if self.use_part:
            x = self.part_conv1(bev_feats)
            parts_feat = self.part_conv2(x.permute(0, 3, 1, 2)).permute(
                0, 2, 3, 1)
        tables = {}
        all_preds, all_scores, stage_targets = [], [], []
        hist, hist_mm = [], []

        def per_sample(fn, boxes):
            return torch.stack([fn(boxes[j], transform_params[j])
                                for j in range(b)])

        for i in range(self.rot_num):
            if i >= 1 and transform_params is not None:
                prev, cur = min(i - 1, n_rep - 1), min(i, n_rep - 1)
                rois = per_sample(lambda bx, p: tr.transform_boxes(
                    tr.transform_boxes(bx, p[prev], inverse=True), p[cur]),
                    rois)
            tgt = None
            if train:
                stage_cfg = self.cfg.TARGET_CONFIG.get(
                    f'STAGE{i}', self.cfg.TARGET_CONFIG.STAGE0)
                tgt = proposal_targets(rng, rois, roi_scores, roi_labels,
                                       gt_boxes, gt_valid, stage_cfg)
                rois = tgt['rois'][..., :7]
                roi_labels = tgt['roi_labels']
                roi_valid = torch.ones(rois.shape[:2], dtype=torch.bool,
                                       device=rois.device)
            if i >= 1 and transform_params is not None:
                cur = min(i, n_rep - 1)
                rois_score = per_sample(lambda bx, p: tr.transform_boxes(
                    tr.transform_boxes(bx, p[cur], inverse=True), p[0]),
                    rois)
            else:
                rois_score = rois
            part_scores = None
            if self.use_part:
                part_scores = self._part_scores(parts_feat,
                                                rois_score).reshape(-1, 1)
            entry = entry_base + min(i, n_rep - 1)
            pooled, pmask = self._roi_grid_pool(
                'pool', self.cfg.ROI_GRID_POOL, feats_lidar, strides, rois,
                roi_valid, entry, tables, bf16)
            pooled_mm, _ = self._roi_grid_pool(
                'pool_mm', self.cfg.ROI_GRID_POOL_MM, feats_mm, strides,
                rois, roi_valid, entry, tables, bf16)

            shared = self.shared_fc(pooled, pmask, rng)[None]
            hist.append(shared)
            cur = self.cross_attn(torch.cat(hist, 0), shared)
            cur = torch.cat([cur, shared], -1)[0]
            shared_mm = self.shared_fc_mm(pooled_mm, pmask, rng)[None]
            hist_mm.append(shared_mm)
            cur_mm = self.cross_attn_mm(torch.cat(hist_mm, 0), shared_mm)
            cur_mm = torch.cat([cur_mm, shared_mm], -1)[0]

            final = torch.cat([cur_mm, cur], -1)
            heads = {'': (self.cls_head, self.reg_head, final)}
            if train:
                heads['_pi'] = (self.cls_head_pi, self.reg_head_pi, cur_mm)
                heads['_p'] = (self.cls_head_p, self.reg_head_p, cur)
            preds = {}
            for br, (cls_head, reg_head, feat) in heads.items():
                cls = cls_head(feat, pmask, rng)
                preds[f'rcnn_reg{br}'] = reg_head(feat, pmask, rng)
                if part_scores is not None:
                    cls = cls + part_scores
                preds[f'rcnn_cls{br}'] = cls
            boxes = self.decode_boxes(rois, preds['rcnn_reg'])
            scores = preds['rcnn_cls'].reshape(b, -1, self.num_class)
            outs = boxes
            if transform_params is not None:
                cur_p = min(i, n_rep - 1)
                outs = per_sample(lambda bx, p: tr.transform_boxes(
                    bx, p[cur_p], inverse=True), boxes)
            all_preds.append(outs)
            all_scores.append(scores)
            if train:
                stage_targets.append({'targets': tgt, 'rois': rois, **preds})
            rois = boxes
            roi_scores = scores.squeeze(-1)
        out = {'batch_box_preds': torch.stack(all_preds).mean(0),
               'batch_cls_preds': torch.stack(all_scores).mean(0),
               'roi_valid': roi_valid}
        if train:
            out['stage_targets'] = stage_targets
        return out

    def loss(self, stage_targets, loss_weights, code_weights):
        """Cascade loss over stages and the three branches (fused 1.0,
        multimodal-only and LiDAR-only 0.5 each). Returns (total, tb). In a
        data-parallel step the normalizers (valid and foreground ROI
        counts) are the global batch's, so each rank's total and terms are
        its partials of the global ones (``tb['rcnn_reg_fg_s*']`` its own
        foreground count)."""
        total = 0.0
        tb = {}
        for s, st_t in enumerate(stage_targets):
            tgt = st_t['targets']
            for branch, w in (('', 1.0), ('_pi', 0.5), ('_p', 0.5)):
                c = self._cls_loss(st_t[f'rcnn_cls{branch}'], tgt) \
                    * loss_weights['rcnn_cls_weight']
                r, terms = self._reg_loss(st_t[f'rcnn_reg{branch}'],
                                          st_t['rois'], tgt, loss_weights,
                                          code_weights)
                total = total + w * (c + r)
                if branch == '':
                    for name, val in terms.items():
                        tb[f'rcnn_reg_{name}_s{s}'] = val
            tb[f'rcnn_cls_s{s}'] = self._cls_loss(st_t['rcnn_cls'], tgt)
        tb['rcnn_loss'] = total
        return total, tb

    @staticmethod
    def _cls_loss(rcnn_cls, tgt):
        labels = tgt['rcnn_cls_labels'].reshape(-1)
        logits = rcnn_cls.reshape(-1)
        bce = (torch.clamp(logits, min=0) - logits * labels
               + torch.log1p(torch.exp(-logits.abs())))
        valid = (labels >= 0).float()
        return (bce * valid).sum() / torch.clamp(dp.global_sum(valid.sum()),
                                                 min=1.0)

    def _reg_loss(self, rcnn_reg, rois, tgt, loss_weights, code_weights):
        from ..dense_heads.anchor_head import weighted_smooth_l1
        code = self.code_size
        gt_ct = tgt['gt_of_rois'][..., :code].reshape(-1, code)
        fg = (tgt['reg_valid_mask'].reshape(-1) > 0).float()
        fg_all = dp.global_sum(fg.sum())
        fg_sum = torch.clamp(fg_all, min=1.0)
        flat = rois.reshape(-1, code)
        zero = torch.zeros_like(flat[:, 0:3])
        rois_anchor = torch.cat([zero, flat[:, 3:6], zero[:, :1],
                                 flat[:, 7:]], -1)
        reg_targets = self.coder.encode(gt_ct, rois_anchor)
        l1 = weighted_smooth_l1(rcnn_reg[None], reg_targets[None], fg[None],
                                code_weights=code_weights)
        l1_term = l1.sum() / fg_sum * loss_weights['rcnn_reg_weight']
        # decode every row (static shapes), with the reg of background rows
        # zeroed so a wild exp() there cannot reach the masked sum as NaN
        reg_fg = rcnn_reg.reshape(-1, code) * fg[:, None]
        dec = self.decode_boxes(rois.reshape(1, -1, code),
                                reg_fg.reshape(1, -1, code))[0]
        gt_src = tgt['gt_of_rois_src'][..., :code].reshape(-1, code)
        corner = box_ops.corner_loss(dec, gt_src)
        corner_term = (corner * fg).sum() / fg_sum \
            * loss_weights['rcnn_corner_weight']
        canon = self.coder.decode(reg_fg, rois_anchor)
        bb_term = (box_ops.bb_loss(canon, gt_ct) * fg).sum() / (fg_all
                                                                 + 1.0)
        return l1_term + corner_term + bb_term, {
            'l1': l1_term, 'corner': corner_term, 'bb': bb_term,
            'fg': fg.sum()}
