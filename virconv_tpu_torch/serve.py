"""Serving entry point: a ``Detector`` (VirConv-T by default, or any
shipped config) that takes a batch of frames and returns per-frame boxes,
scores and labels after WBF.

Each frame is replicated by the test-time world transforms of
``DATA_CONFIG.X_TRANS`` (replica i of frame b is batch entry b * R + i),
run through the model on the device, then score-thresholded and fused by
weighted box fusion on the host. A config without ``X_TRANS`` (VirConv-L)
serves each frame as one entry with no transform (``transform_param`` and
``trans_params`` None), as the JAX loader collates it; its frames carry
one fused point stream and no ``points_mm``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import resolve_device
from .config import CfgNode, virconv_t_config
from .models.detectors.voxel_rcnn import VoxelRCNN
from .ops.wbf import compute_wbf
from .utils import trace
from .utils import transforms as tr
from .utils.jax_weights import load_state_dict_checked, random_init_
from .utils.postprocess import post_process_batch


class Detector:
    """Detector eval on one device (``cfg``: VirConv-T by default).

    ``state_dict``: the port's weights (``utils.jax_weights.
    from_jax_variables`` gives them from a flax checkpoint); without one the
    weights are random from ``seed``. ``device`` defaults to CUDA and raises
    when there is none, unless the caller passes ``device="cpu"``."""

    def __init__(self, cfg: CfgNode | None = None, state_dict=None,
                 device="cuda", seed: int = 0, bf16: bool = True):
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else virconv_t_config()
        self.bf16 = bf16
        model = VoxelRCNN(self.cfg.MODEL, self.cfg.DATA_CONFIG,
                          num_class=len(self.cfg.CLASS_NAMES))
        if state_dict is None:
            random_init_(model, seed)
        else:
            load_state_dict_checked(model, state_dict)
        self.model = model.to(self.device).eval()
        dcfg = self.cfg.DATA_CONFIG
        self.rot_num = self.cfg.MODEL.ROI_HEAD.ROT_NUM
        x_trans = dcfg.get('X_TRANS', None)
        self.params = None if x_trans is None else \
            tr.get_transform_params(x_trans, self.rot_num)
        self.post_cfg = CfgNode(self.cfg.MODEL.POST_PROCESSING)

    def make_batch(self, frames: Dict[str, np.ndarray]):
        """Replicate F frames by the R test-time transforms into device
        tensors. ``frames``: points (F, P, C), points_valid (F, P), v2r
        and p2t (F, 4, 3), and for a two-stream model points_mm (F, Pm, C)
        and points_mm_valid (F, Pm)."""
        n_f = frames['points'].shape[0]
        r = self.rot_num

        def rep(x):               # (F, ...) -> (F*R, ...), frame-major
            return np.repeat(x, r, axis=0)

        def transformed(pts):
            if self.params is None:
                return rep(pts)
            out = np.stack([np.stack([tr.transform_points_np(f, p)
                                      for p in self.params]) for f in pts])
            return out.reshape(n_f * r, *pts.shape[1:])

        dev = self.device
        t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
        batch = {
            'points': t(transformed(frames['points'])),
            'points_valid': t(rep(frames['points_valid'])),
            'v2r': t(rep(frames['v2r']).astype(np.float32)),
            'p2t': t(rep(frames['p2t']).astype(np.float32)),
            'transform_param': None, 'trans_params': None,
        }
        if self.model.is_mm:
            batch['points_mm'] = t(transformed(frames['points_mm']))
            batch['points_mm_valid'] = t(rep(frames['points_mm_valid']))
        if self.params is not None:
            batch['transform_param'] = t(np.tile(self.params[None],
                                                 (n_f, 1, 1)))
            batch['trans_params'] = t(np.tile(self.params, (n_f, 1)))
        return batch

    @torch.no_grad()
    def forward(self, frames: Dict[str, np.ndarray]):
        """Raw model outputs (device tensors) for a batch of frames."""
        with trace.span('make_batch'):
            batch = self.make_batch(frames)
        return self.model(batch, bf16=self.bf16)

    def __call__(self, frames: Dict[str, np.ndarray]) -> List[dict]:
        """Per-frame ``{'boxes' (n, 7), 'scores' (n,), 'labels' (n,)}`` in
        the LiDAR frame after score threshold and WBF."""
        out = self.forward(frames)
        with trace.span('postprocess_wbf'):
            return self._postprocess(out)

    def _postprocess(self, out):
        preds = post_process_batch(out, self.post_cfg,
                                   len(self.cfg.CLASS_NAMES))
        results = []
        for p in preds:
            labels, scores, boxes = compute_wbf(
                p['pred_labels'], p['pred_scores'], p['pred_boxes'],
                iou_thresh=p['IoU'], retain_low=p['RL'],
                score_thresh=p['SCORE_THRESH'])
            results.append({'boxes': np.asarray(boxes, np.float64)
                            .reshape(-1, 7),
                            'scores': np.asarray(scores, np.float64),
                            'labels': np.asarray(labels, np.int64)})
        return results
