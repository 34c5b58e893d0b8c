"""VoxelRCNN: voxelize -> VirConv8x (VirConv-T/S) or VirConvL8x
(VirConv-L) -> BEV -> RPN -> TED head, at eval and in train mode
(``.train()``: the loss of one step). Counterpart of
``virconv_tpu/models/detectors/voxel_rcnn.py``.

Batch (tensors on one device):
    points        (B*R, P, 8)  float32   LiDAR stream (T/S) or the fused
                                         real + virtual stream (L)
    points_valid  (B*R, P)     bool
    points_mm / points_mm_valid           fused real + virtual stream (T/S
                                          only)
    v2r, p2t      (B*R, 4, 3)  float32   calibration matrices
    trans_params  (B*R, 3) | None         world transform of each entry
    transform_param (B, R, 3) | None      test-time replica params
    gt_boxes (B*R, M, 8), gt_valid (B*R, M)   train only
Transform replicas ride the batch axis (entry = b * R + i). A training batch
has ``transform_param`` None: each entry is its own sample. With the
single-stream backbone both ROI pool families read the one NRConv stream,
each with its own weights, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ...config import CfgNode
from ...ops import sparse as sp
from ...utils import trace
from ..backbones_2d.bev import BaseBEVBackbone, height_compression
from ..backbones_3d.virconv import VirConv8x, VirConvL8x
from ..dense_heads.anchor_head import AnchorHeadSingle
from ..roi_heads.ted_head import TEDMHead


class VoxelRCNN(nn.Module):
    def __init__(self, model_cfg, dataset_cfg, num_class: int = 1):
        super().__init__()
        mcfg = CfgNode(model_cfg)
        dcfg = CfgNode(dataset_cfg)
        self.pcr = tuple(dcfg.POINT_CLOUD_RANGE)
        proc = [p for p in dcfg.DATA_PROCESSOR
                if p['NAME'] == 'transform_points_to_voxels'][0]
        self.voxel_size = tuple(proc.VOXEL_SIZE)
        self.max_pts_per_voxel = proc.MAX_POINTS_PER_VOXEL
        self.max_voxels = dict(proc.MAX_NUMBER_OF_VOXELS)
        self.grid_size = tuple(
            int(round((self.pcr[i + 3] - self.pcr[i]) / self.voxel_size[i]))
            for i in range(3))
        self.indicator_max = mcfg.VFE.get('MODEL', None) == 'max'
        enc = dcfg.get('POINT_FEATURE_ENCODING', {})
        n_point_features = enc.get('num_features', 8)

        bcfg = mcfg.BACKBONE_3D
        self.is_mm = bcfg.get('MM', False)
        nf = tuple(bcfg.NUM_FILTERS)
        backbones = {'VirConv8x': VirConv8x, 'VirConvL8x': VirConvL8x}
        if bcfg.NAME not in backbones or \
                (bcfg.NAME == 'VirConv8x') != bool(self.is_mm):
            raise NotImplementedError(f'{bcfg.NAME} with MM {self.is_mm}')
        self.backbone = backbones[bcfg.NAME](
            n_point_features, nf, bcfg.OUT_FEATURES, self.voxel_size,
            self.pcr, bcfg.LAYER_DISCARD_RATE)
        b2 = mcfg.BACKBONE_2D
        self.bev_backbone = BaseBEVBackbone(
            mcfg.MAP_TO_BEV.NUM_BEV_FEATURES, b2.LAYER_NUMS,
            b2.LAYER_STRIDES, b2.NUM_FILTERS, b2.UPSAMPLE_STRIDES,
            b2.NUM_UPSAMPLE_FILTERS)
        bev_c = sum(b2.NUM_UPSAMPLE_FILTERS)
        rnms = mcfg.ROI_HEAD.NMS_CONFIG
        self.nms_cfg = {mode: dict(pre=c.NMS_PRE_MAXSIZE,
                                   post=c.NMS_POST_MAXSIZE,
                                   thresh=c.NMS_THRESH)
                        for mode, c in (('train', rnms.TRAIN),
                                        ('test', rnms.TEST))}
        self.loss_weights = (mcfg.DENSE_HEAD.LOSS_CONFIG.LOSS_WEIGHTS,
                             mcfg.ROI_HEAD.LOSS_CONFIG.LOSS_WEIGHTS)
        self.dense_head = AnchorHeadSingle(mcfg.DENSE_HEAD, bev_c, num_class,
                                           self.grid_size[:2], self.pcr)
        rh = mcfg.ROI_HEAD
        self.roi_head = TEDMHead(rh, num_class, rh.ROT_NUM, self.voxel_size,
                                 self.pcr, {'x_conv3': nf[2],
                                            'x_conv4': nf[3]}, bev_c)
        self.eval()

    def voxelize(self, points, valid, n_entries, indicator_max, mode='test'):
        """(E, P, C) padded points -> SparseTensor with the reference's +1
        z padding of the sparse shape; ``mode`` picks the voxel cap."""
        p = points.reshape(-1, points.shape[-1])
        bidx = torch.arange(n_entries, dtype=torch.int32,
                            device=points.device).repeat_interleave(
                                points.shape[1])
        st = sp.voxelize(p, valid.reshape(-1), self.pcr, self.voxel_size,
                         max_voxels=self.max_voxels[mode] * n_entries,
                         max_points_per_voxel=self.max_pts_per_voxel,
                         batch_size=n_entries, batch_idx=bidx,
                         indicator_max=indicator_max)
        d, h, w = st.spatial_shape
        return st.replace(spatial_shape=(d + 1, h, w))

    def forward(self, batch: Dict[str, Any], bf16: bool = True, rng=None):
        """Eval forward (no gradients), or in train mode the loss of one
        step. ``bf16``: bf16 operands in the eval sparse conv and (with
        ``VIRCONV_POOL_BF16``, on by default) ROI pooling kernels, f32
        accumulation, as on the TPU; in train mode bf16 operands in the
        band conv only with ``VIRCONV_BAND_TRAIN_BF16`` (off by default:
        training is f32). ``VIRCONV_BF16_FEATS`` (off) stores the eval
        convs' rows as bf16. The three switches are the JAX package's,
        read as the contexts and pools are built.
        ``rng`` (train mode): the step's random draws (``train.draws``)."""
        if not self.training:
            with torch.no_grad():
                return self._forward(batch, bf16, None)
        return self._forward(batch, bf16, rng)

    def _forward(self, batch, bf16, rng):
        train = self.training
        mode = 'train' if train else 'test'
        points = batch['points']
        n_entries = points.shape[0]
        tp = batch.get('transform_param')
        n_rep = tp.shape[1] if tp is not None else 1
        b = n_entries // n_rep
        with trace.span('voxelize'):
            st = self.voxelize(points, batch['points_valid'], n_entries,
                               self.indicator_max, mode)
            if self.is_mm:
                # the multimodal stream keeps the plain mean (no indicator
                # max)
                st_mm = self.voxelize(batch['points_mm'],
                                      batch['points_mm_valid'], n_entries,
                                      False, mode)
        with trace.span('backbone_3d'):
            streams = (st, st_mm) if self.is_mm else (st,)
            bb = self.backbone(*streams, batch['v2r'], batch['p2t'],
                               batch.get('trans_params'), bf16, rng)
        feats_mm = bb['multi_scale_3d_features_mm'] if self.is_mm \
            else bb['multi_scale_3d_features']

        # BEV path uses replica 0 only
        enc = bb['encoded_spconv_tensor']
        if n_rep > 1:
            keep = enc.mask & (enc.coords[:, 0] % n_rep == 0)
            coords = enc.coords.clone()
            coords[:, 0] = torch.div(coords[:, 0], n_rep,
                                     rounding_mode='floor')
            enc = sp.SparseTensor(
                feats=torch.where(keep[:, None], enc.feats,
                                  torch.zeros_like(enc.feats)),
                coords=torch.where(keep[:, None], coords,
                                   torch.full_like(coords, -1)),
                mask=keep, spatial_shape=enc.spatial_shape, batch_size=b)
        with trace.span('bev'):
            bev_feats = self.bev_backbone(height_compression(enc))

        # anchor mask source: replica-0 points of the whole batch
        pts0 = points.reshape(b, n_rep, *points.shape[1:])[:, 0]
        pv0 = batch['points_valid'].reshape(b, n_rep, -1)[:, 0]
        with trace.span('rpn'):
            rpn = self.dense_head(bev_feats, pts0[..., 0:2].reshape(-1, 2),
                                  pv0.reshape(-1), self.nms_cfg[mode],
                                  batch.get('gt_boxes'),
                                  batch.get('gt_valid'))
        with trace.span('roi_head'):
            roi_out = self.roi_head(
                bb['multi_scale_3d_features'], feats_mm,
                bb['multi_scale_3d_strides'], rpn, bev_feats, tp, bf16,
                batch.get('gt_boxes'), batch.get('gt_valid'), rng)
        out = {'batch_box_preds': roi_out['batch_box_preds'],
               'batch_cls_preds': roi_out['batch_cls_preds'],
               'roi_valid': roi_out['roi_valid'],
               'rois': rpn['rois'], 'roi_scores': rpn['roi_scores'],
               'keep': rpn['keep'], 'keep_valid': rpn['roi_valid'],
               'bev_feats': bev_feats, 'backbone': bb}
        if train:
            rpn_lw, rcnn_lw = self.loss_weights
            with trace.span('loss'):
                rpn_loss, rpn_tb = self.dense_head.loss(
                    rpn, rpn_lw, rpn_lw['code_weights'])
                rcnn_loss, rcnn_tb = self.roi_head.loss(
                    roi_out['stage_targets'], rcnn_lw,
                    rcnn_lw['code_weights'])
            out['loss'] = rpn_loss + rcnn_loss
            out['tb'] = {**rpn_tb, **rcnn_tb}
            out['stage_targets'] = roi_out['stage_targets']
        return out
