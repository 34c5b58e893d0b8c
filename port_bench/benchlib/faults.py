"""Faults planted under the timed path, for the tests and the readings
that show the check catches them: the check has to come out not correct
under each.

Serving: ``half_batch`` (the second half of a request's frames served
without their points), ``answer`` (a served box moved 0.1 m where the
detector produces it), ``proposal`` (the RPN's proposals moved 0.1 m in x
where its head produces them), ``late_stage`` (the ROI head's box
residuals zero from its second stage on, a stage that returns nothing;
the first stage's are the head's only stage in a one-stage model),
``query`` (the first ROI grid pool's query points moved 0.1 m in x where
the head builds them). Training: ``unchanged`` (the step returns the
state it got), ``half_batch`` (the step takes the first half of the
batch's entries, its loss the mean over them), ``answer`` (the step's
loss 1 % off where it is produced), ``query`` (as in serving). A fault's
hooks run before any other hook of its module, so a capture sees what
the fault made.
"""

from __future__ import annotations

import numpy as np
import torch


def _moved_proposals(module, inputs, out):
    out = dict(out)
    rois = out['rois'].clone()
    rois[..., 0] += 0.1
    out['rois'] = rois
    return out


class _LateStage:
    """Forward hooks that zero the ROI head's box residuals from the
    second stage on (from the first in a one-stage head)."""

    def __init__(self, roi_head):
        self.calls = 0
        self.first = 1 if roi_head.rot_num > 1 else 0
        roi_head.register_forward_pre_hook(self.reset, prepend=True)
        roi_head.reg_head.register_forward_hook(self.zero, prepend=True)

    def reset(self, module, args):
        self.calls = 0

    def zero(self, module, inputs, out):
        self.calls += 1
        if self.calls > self.first:
            return out * 0
        return out


def _moved_queries(module, args):
    return (args[0], args[1], args[2] + torch.tensor(
        [0.1, 0.0, 0.0], device=args[2].device)) + tuple(args[3:])


def _plant(model, fault):
    """Register the hooks of a fault planted in ``model``, if it has
    any."""
    if fault == 'proposal':
        model.dense_head.register_forward_hook(_moved_proposals,
                                                prepend=True)
    elif fault == 'late_stage':
        _LateStage(model.roi_head)
    elif fault == 'query':
        from .capture import pool_modules
        pool_modules(model)[0][1].register_forward_pre_hook(
            _moved_queries, prepend=True)


class _Detector:
    def __init__(self, det, fault):
        self.det, self.fault, self.model = det, fault, det.model
        _plant(det.model, fault)

    def __call__(self, frames):
        if self.fault == 'half_batch':
            frames = dict(frames)
            half = frames['points'].shape[0] // 2
            for k in ('points_valid', 'points_mm_valid'):
                if k in frames:
                    v = frames[k].copy()
                    v[half:] = False
                    frames[k] = v
            return self.det(frames)
        out = self.det(frames)
        if self.fault == 'answer':
            for r in out:
                if len(r['boxes']):
                    r['boxes'] = r['boxes'].copy()
                    r['boxes'][0, 0] += 0.1
                    break
        return out


def detector(fault):
    return lambda det: _Detector(det, fault)


def step(fault):
    planted = []

    def run(trainer, batch):
        if fault == 'query':
            if not planted:
                _plant(trainer.model, fault)
                planted.append(trainer.model)
            return trainer.step(batch)
        if fault == 'unchanged':
            state = {k: v.detach().clone()
                     for k, v in trainer.model.state_dict().items()}
            out = trainer.step(batch)
            trainer.model.load_state_dict(state)
            return out
        if fault == 'half_batch':
            n = batch['points'].shape[0] // 2
            batch = {k: v if v is None or np.ndim(v) == 0 else v[:n]
                     for k, v in batch.items()}
            return trainer.step(batch)
        loss, tb = trainer.step(batch)
        return loss * 1.01, tb
    return run


def hooks(mode, fault):
    if fault is None:
        return {}
    return {'detector': detector(fault)} if mode == 'infer' \
        else {'step': step(fault)}
