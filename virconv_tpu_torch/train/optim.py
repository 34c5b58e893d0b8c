"""The ``adam_onecycle`` optimizer: fastai-style OneCycle learning-rate and
momentum schedules, global-norm gradient clipping and AdamW with decoupled
weight decay on kernels only, skipping (and counting) any step whose
gradients are not all finite. Counterpart of ``virconv_tpu/train/optim.py``,
whose optax chain is ``apply_if_finite(chain(clip_by_global_norm,
inject_hyperparams(adamw)(lr=schedule, b1=momentum schedule)))``; the
schedules and the update follow optax's arithmetic in float32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# consecutive non-finite steps skipped before one is applied anyway (optax
# apply_if_finite's max_consecutive_errors in the JAX package)
MAX_CONSECUTIVE_ERRORS = 10000


def _cos_anneal(start, end, pct):
    pct = torch.clamp(pct, 0.0, 1.0)
    return end + (start - end) / 2.0 * (torch.cos(math.pi * pct) + 1.0)


def one_cycle_lr(lr_max, total_steps, moms=(0.95, 0.85), div_factor=10.0,
                 pct_start=0.4):
    """(lr_fn, mom_fn) of the step index: the learning rate cosine-anneals
    lr/div -> lr over the first ``pct_start`` of the steps, then
    lr -> lr/(div*1e4); the momentum (Adam's beta1) moves the other way.
    Both return float32 tensors."""
    low_lr = lr_max / div_factor
    final_lr = lr_max / (div_factor * 1e4)
    up = int(total_steps * pct_start)
    down = max(total_steps - up, 1)

    def schedule(step, first, peak, last):
        step = torch.as_tensor(min(int(step), total_steps),
                               dtype=torch.float32)
        phase1 = _cos_anneal(first, peak, step / max(up, 1))
        phase2 = _cos_anneal(peak, last, (step - up) / down)
        return torch.where(step <= up, phase1, phase2)

    return (lambda step: schedule(step, low_lr, lr_max, final_lr),
            lambda step: schedule(step, moms[0], moms[1], moms[0]))


def decayed_parameters(model: nn.Module):
    """Names of the parameters that are flax ``kernel`` leaves (weight decay
    applies to these only): sparse-conv and position kernels, and the
    weights of linear and conv layers; not BN scales, not biases."""
    names = set()
    for mod_name, mod in model.named_modules():
        prefix = f'{mod_name}.' if mod_name else ''
        for leaf, _ in mod.named_parameters(recurse=False):
            if leaf == 'kernel' or (leaf == 'weight' and isinstance(
                    mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d))):
                names.add(prefix + leaf)
    return names


class AdamOneCycle:
    """``adam_onecycle`` over the parameters of ``model``, reading their
    ``.grad``. ``step()`` returns whether the update was applied;
    ``total_notfinite`` counts the skipped steps."""

    def __init__(self, model: nn.Module, opt_cfg, total_steps: int):
        self.params = [(n, p) for n, p in model.named_parameters()
                       if p.requires_grad]
        decay = decayed_parameters(model)
        self.decay = [n in decay for n, _ in self.params]
        self.lr_fn, self.mom_fn = one_cycle_lr(
            opt_cfg.LR, total_steps, tuple(opt_cfg.MOMS), opt_cfg.DIV_FACTOR,
            opt_cfg.PCT_START)
        self.weight_decay = float(opt_cfg.get('WEIGHT_DECAY', 0.0))
        self.max_norm = float(opt_cfg.get('GRAD_NORM_CLIP', 10.0))
        self.b2, self.eps = 0.999, 1e-8
        self.count = 0                 # applied updates
        self.notfinite_count = 0
        self.total_notfinite = 0
        self.mu = [torch.zeros_like(p) for _, p in self.params]
        self.nu = [torch.zeros_like(p) for _, p in self.params]

    @torch.no_grad()
    def step(self) -> bool:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for _, p in self.params]
        finite = bool(torch.stack([torch.isfinite(g).all()
                                   for g in grads]).all())
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        if not finite:
            self.total_notfinite += 1
            if self.notfinite_count <= MAX_CONSECUTIVE_ERRORS:
                return False
        g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if not bool(g_norm < self.max_norm):
            grads = [g / g_norm * self.max_norm for g in grads]
        dev = grads[0].device
        lr = self.lr_fn(self.count).to(dev)
        b1 = self.mom_fn(self.count).to(dev)
        t = self.count + 1
        bc1 = 1 - b1 ** t
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** t
        for (_, p), g, mu, nu, decay in zip(self.params, grads, self.mu,
                                            self.nu, self.decay):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - self.b2) * g * g + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2.to(dev)) + self.eps)
            if decay:
                u = u + self.weight_decay * p
            p.add_(-lr * u)
        self.count += 1
        return True
