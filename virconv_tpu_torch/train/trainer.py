"""Training entry point: a VirConv-T ``Trainer`` that takes one optimizer
step per batch (forward in train mode, losses, backward, the optimizer of
``OPTIMIZATION.OPTIMIZER``). Counterpart of the train step and training
state of ``virconv_tpu/train/trainer.py``.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from .. import resolve_device
from ..config import CfgNode, virconv_t_config
from ..models.detectors.voxel_rcnn import VoxelRCNN
from ..parallel import data_parallel as dp
from ..utils import trace
from ..utils.jax_weights import load_state_dict_checked, random_init_
from .draws import Draws
from .optim import OPTIMIZERS, build_optimizer


def step_seed(seed: int, step: int, rank: int | None = None) -> int:
    """The generator seed of step ``step``: a function of (seed, step)
    only, as the JAX step folds ``state.step`` into its keys; with
    ``rank``, folded with the rank of a data-parallel group of two or
    more."""
    entropy = [seed, step] if rank is None else [seed, step, rank]
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class Trainer:
    """VirConv-T training on one device, or data parallel over several.

    ``state_dict``: the port's weights (``utils.jax_weights``); without one
    the weights are random from ``seed``. ``device`` defaults to CUDA and
    raises when there is none, unless the caller passes ``device="cpu"``.
    Every random draw of step t (StVD, ROI sampling, dropout) comes from a
    ``torch.Generator`` on the device seeded with ``step_seed(seed, t)``,
    so a resumed run draws what an uninterrupted one draws.
    ``total_steps`` sizes the learning-rate schedules.
    ``OPTIMIZATION.OPTIMIZER`` is ``adam_onecycle``, ``adam`` or ``sgd``:
    any other name raises ``NotImplementedError`` before the model is
    built.

    ``dist``: data parallel over a ``torch.distributed`` group (True: the
    default group), each rank stepping on its frames of the global batch.
    Rank 0's parameters and buffers go to every rank at construction. A
    step runs forward and backward inside ``data_parallel.synced`` (BN
    moments and loss normalizers over the global batch), sums the
    gradients over the ranks (``allreduce_grads``), then clips and updates
    as one process would: every rank ends the step with the same
    parameters. The loss and tb terms it returns are the global ones. In a
    group of two or more, rank r's generator is seeded with
    ``step_seed(seed, t, r)``: StVD, ROI sampling and dropout draw per
    rank; the hard-sampling stripe start is rank 0's."""

    def __init__(self, cfg: CfgNode | None = None, state_dict=None,
                 device="cuda", seed: int = 0, total_steps: int = 1000,
                 dist=None):
        self.cfg = cfg if cfg is not None else virconv_t_config()
        name = self.cfg.OPTIMIZATION.OPTIMIZER
        if name not in OPTIMIZERS:
            raise NotImplementedError(
                f'optimizer {name!r}: the port builds {sorted(OPTIMIZERS)}, '
                'as the JAX package does')
        self.device = resolve_device(device)
        if self.device.type == 'cuda':
            # cuDNN may pick weight-gradient algorithms for the BEV and RPN
            # convs that add with atomics in any order, so two runs of one
            # step gave different gradients (as the pool gathers did,
            # before ops.gather_rows): the deterministic algorithms give the
            # same bits on every run, as the JAX package does. A global
            # switch: it holds for every cuDNN call of the process.
            torch.backends.cudnn.deterministic = True
        model = VoxelRCNN(self.cfg.MODEL, self.cfg.DATA_CONFIG,
                          num_class=len(self.cfg.CLASS_NAMES))
        if state_dict is None:
            random_init_(model, seed)
        else:
            load_state_dict_checked(model, state_dict)
        self.model = model.to(self.device).train()
        self.group, self.rank = None, None
        if dist:
            import torch.distributed as tdist
            self.group = tdist.group.WORLD if dist is True else dist
            if tdist.get_world_size(self.group) > 1:
                self.rank = tdist.get_rank(self.group)
            dp.broadcast_module(self.model, self.group)
        self.seed = seed
        self.step_count = 0
        self.generator = torch.Generator(device=self.device)
        self.optimizer = build_optimizer(self.model, self.cfg.OPTIMIZATION,
                                         total_steps)

    def to_device(self, batch: Dict[str, np.ndarray]):
        return {k: None if v is None else torch.as_tensor(
            np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v,
            device=self.device) for k, v in batch.items()}

    def lr(self) -> float:
        """The learning rate the next step applies: the schedule at the
        number of applied updates (steps less skipped ones)."""
        return float(self.optimizer.lr())

    def step(self, batch, draws: Draws | None = None):
        """One optimizer step on ``batch`` (numpy arrays or tensors: a
        loader batch, or ``utils.bench_inputs.train_batch``). ``draws``
        replaces the step's generator (tests hand in recorded draws).
        Returns (loss, tb): the loss tensor and the per-term dict with
        ``nonfinite_skips``. The step applies the learning rate ``lr()``
        gave before it. The parameters' ``.grad`` keep this step's
        gradients, and the BN running statistics are updated in the
        model. With ``dist``: ``batch`` is this rank's share, the gradients
        are the global loss's and the loss and terms the global ones."""
        batch = self.to_device(batch)
        if draws is None:
            self.generator.manual_seed(step_seed(self.seed, self.step_count,
                                                 self.rank))
            draws = Draws(self.generator)
        self.model.zero_grad(set_to_none=True)
        with (dp.synced(self.group) if self.group is not None
              else contextlib.nullcontext()):
            out = self.model(batch, rng=draws)
            with trace.span('backward'):
                out['loss'].backward()
            with trace.span('allreduce_grads'):
                dp.allreduce_grads(self.model)
            loss, terms = out['loss'].detach(), {
                k: v.detach() for k, v in out['tb'].items()}
            if self.group is not None:
                # the global loss and terms: the sums of the ranks' partials
                names = list(terms)
                flat = dp.global_sum(torch.stack(
                    [loss.float()] + [terms[k].float() for k in names]))
                loss = flat[0]
                terms = dict(zip(names, flat[1:]))
        with trace.span('optimizer'):
            self.optimizer.step()
        self.step_count += 1
        tb = {**terms, 'nonfinite_skips': self.optimizer.total_notfinite}
        return loss, tb

    def state_dict(self):
        """``model_state`` (parameters and BN statistics), the optimizer's
        state and ``step``: everything a resumed run needs."""
        return {'model_state': self.model.state_dict(),
                'optimizer_state': self.optimizer.state_dict(),
                'step': self.step_count}

    def load_state_dict(self, state):
        load_state_dict_checked(self.model, state['model_state'])
        self.optimizer.load_state_dict(state['optimizer_state'])
        self.step_count = int(state['step'])
