"""Training entry point: a VirConv-T ``Trainer`` that takes one optimizer
step per batch (forward in train mode, losses, backward, ``adam_onecycle``).
Counterpart of the train step of ``virconv_tpu/train/trainer.py``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from .. import resolve_device
from ..config import CfgNode, virconv_t_config
from ..models.detectors.voxel_rcnn import VoxelRCNN
from ..utils.jax_weights import load_state_dict_checked, random_init_
from .draws import Draws
from .optim import AdamOneCycle


class Trainer:
    """VirConv-T training on one device.

    ``state_dict``: the port's weights (``utils.jax_weights``); without one
    the weights are random from ``seed``. ``device`` defaults to CUDA and
    raises when there is none, unless the caller passes ``device="cpu"``.
    Every random draw of a step (StVD, ROI sampling, dropout) comes from
    one ``torch.Generator`` on the device, seeded with ``seed``.
    ``total_steps`` sizes the OneCycle schedule. ``OPTIMIZATION.OPTIMIZER``
    must be ``adam_onecycle``: any other name raises
    ``NotImplementedError`` before the model is built."""

    def __init__(self, cfg: CfgNode | None = None, state_dict=None,
                 device="cuda", seed: int = 0, total_steps: int = 1000):
        self.cfg = cfg if cfg is not None else virconv_t_config()
        name = self.cfg.OPTIMIZATION.OPTIMIZER
        if name != 'adam_onecycle':
            raise NotImplementedError(
                f'optimizer {name!r}: only adam_onecycle is ported; adam '
                'and sgd are not yet')
        self.device = resolve_device(device)
        model = VoxelRCNN(self.cfg.MODEL, self.cfg.DATA_CONFIG,
                          num_class=len(self.cfg.CLASS_NAMES))
        if state_dict is None:
            random_init_(model, seed)
        else:
            load_state_dict_checked(model, state_dict)
        self.model = model.to(self.device).train()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.optimizer = AdamOneCycle(self.model, self.cfg.OPTIMIZATION,
                                      total_steps)

    def to_device(self, batch: Dict[str, np.ndarray]):
        return {k: None if v is None else torch.as_tensor(
            np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v,
            device=self.device) for k, v in batch.items()}

    def step(self, batch, draws: Draws | None = None):
        """One optimizer step on ``batch`` (numpy arrays or tensors, as
        ``utils.bench_inputs.train_batch`` builds them). ``draws`` replaces
        the generator's draws (tests hand in recorded ones). Returns (loss,
        tb): the loss tensor and the per-term dict with ``nonfinite_skips``.
        The parameters' ``.grad`` keep this step's gradients, and the BN
        running statistics are updated in the model."""
        batch = self.to_device(batch)
        rng = draws if draws is not None else Draws(self.generator)
        self.model.zero_grad(set_to_none=True)
        out = self.model(batch, rng=rng)
        with record_function('backward'):
            out['loss'].backward()
        with record_function('optimizer'):
            self.optimizer.step()
        tb = {**{k: v.detach() for k, v in out['tb'].items()},
              'nonfinite_skips': self.optimizer.total_notfinite}
        return out['loss'].detach(), tb
