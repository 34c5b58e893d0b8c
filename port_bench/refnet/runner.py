"""The reference's entry points: ``RefDetector`` (serving: replicas,
model, score threshold and WBF) and ``RefTrainer`` (one optimizer step),
frozen copies of the measured program's single-process ``Detector`` and
``Trainer`` on this package's model. Both take their weights as a
state_dict; neither makes any.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CfgNode
from .models.detectors.voxel_rcnn import VoxelRCNN
from .ops.wbf import compute_wbf
from .train.draws import Draws
from .train.optim import build_optimizer
from .utils import transforms as tr
from .utils.postprocess import post_process_batch


def build_model(cfg: CfgNode, state_dict, device):
    model = VoxelRCNN(cfg.MODEL, cfg.DATA_CONFIG,
                      num_class=len(cfg.CLASS_NAMES))
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.endswith('num_batches_tracked')]
    if missing or unexpected:
        raise KeyError(f'missing {missing}, unexpected {unexpected}')
    return model.to(device)


def step_seed(seed: int, step: int) -> int:
    """The generator seed of training step ``step`` of a run seeded
    ``seed`` (one process)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class RefDetector:
    def __init__(self, cfg: CfgNode, state_dict, device):
        self.device = torch.device(device)
        self.cfg = cfg
        self.model = build_model(cfg, state_dict, self.device).eval()
        dcfg = cfg.DATA_CONFIG
        self.rot_num = cfg.MODEL.ROI_HEAD.ROT_NUM
        x_trans = dcfg.get('X_TRANS', None)
        self.params = None if x_trans is None else \
            tr.get_transform_params(x_trans, self.rot_num)
        self.post_cfg = CfgNode(cfg.MODEL.POST_PROCESSING)

    def make_batch(self, frames):
        n_f = frames['points'].shape[0]
        r = self.rot_num

        def rep(x):
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
    def forward(self, frames):
        return self.model(self.make_batch(frames))

    def postprocess(self, out):
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

    def __call__(self, frames):
        return self.postprocess(self.forward(frames))


class RefTrainer:
    """One process, one device: ``step(batch)`` as the measured program's
    ``Trainer.step`` (draws from a generator seeded ``step_seed(seed, t)``,
    forward in train mode, backward, the optimizer)."""

    def __init__(self, cfg: CfgNode, state_dict, device, seed: int,
                 total_steps: int):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = build_model(cfg, state_dict, self.device).train()
        self.seed = seed
        self.step_count = 0
        self.generator = torch.Generator(device=self.device)
        self.optimizer = build_optimizer(self.model, cfg.OPTIMIZATION,
                                         total_steps)

    def to_device(self, batch):
        return {k: None if v is None else torch.as_tensor(
            np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v,
            device=self.device) for k, v in batch.items()}

    def step(self, batch):
        batch = self.to_device(batch)
        self.generator.manual_seed(step_seed(self.seed, self.step_count))
        draws = Draws(self.generator)
        self.model.zero_grad(set_to_none=True)
        out = self.model(batch, rng=draws)
        out['loss'].backward()
        loss = out['loss'].detach()
        self.optimizer.step()
        self.step_count += 1
        return loss

    @torch.no_grad()
    def forward(self, batch, step: int):
        """The train-mode forward of step ``step`` (its draws), without
        the backward or the update: what the work counts read."""
        batch = self.to_device(batch)
        self.generator.manual_seed(step_seed(self.seed, step))
        return self.model(batch, rng=Draws(self.generator))
