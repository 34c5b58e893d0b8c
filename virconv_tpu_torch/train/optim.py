"""The optimizers of ``OPTIMIZATION.OPTIMIZER``, counterparts of
``virconv_tpu/train/optim.py``'s optax chains, following optax's
arithmetic in float32:

* ``adam_onecycle``: fastai-style OneCycle learning-rate and momentum
  schedules, global-norm gradient clipping and AdamW with decoupled weight
  decay on kernels only, skipping (and counting) any step whose gradients
  are not all finite (``apply_if_finite(chain(clip_by_global_norm,
  inject_hyperparams(adamw)(lr=schedule, b1=momentum schedule)))``);
* ``adam``: clipping, then Adam (``chain(clip_by_global_norm,
  adam(piecewise_constant_schedule))``);
* ``sgd``: clipping, then SGD with momentum, not Nesterov.

The last two decay the learning rate by ``LR_DECAY`` at each epoch of
``DECAY_STEP_LIST`` (steps per epoch = total steps // ``NUM_EPOCHS``) and,
as in the JAX package, apply non-finite steps. ``state_dict()`` /
``load_state_dict()`` save and restore each optimizer's moments and
counters, keyed by parameter name.
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


def piecewise_lr(init, boundaries_and_scales):
    """optax's ``piecewise_constant_schedule``: ``init`` times the scale of
    every boundary the step has reached, as a float32 tensor."""
    bounds = sorted(boundaries_and_scales.items())

    def lr_fn(step):
        v = torch.tensor(init, dtype=torch.float32)
        for threshold, scale in bounds:
            ind = torch.tensor(float(int(step) < threshold))
            v = v * ind + (1 - ind) * scale * v
        return v
    return lr_fn


def step_decay_lr(opt_cfg, total_steps):
    """The ``adam`` / ``sgd`` schedule: ``LR`` times ``LR_DECAY`` at each
    epoch of ``DECAY_STEP_LIST``."""
    steps_per_epoch = max(total_steps // max(opt_cfg.NUM_EPOCHS, 1), 1)
    return piecewise_lr(opt_cfg.LR, {int(e) * steps_per_epoch:
                                     opt_cfg.LR_DECAY
                                     for e in opt_cfg.DECAY_STEP_LIST})


class _Optimizer:
    """The parameters of ``model`` that take gradients (read from their
    ``.grad``), global-norm clipping at ``GRAD_NORM_CLIP``, and the state
    of the subclass's ``SLOTS`` (per-parameter tensors) and ``COUNTERS``
    (ints). ``count`` is the number of applied updates, the step index of
    the schedules; ``total_notfinite`` counts skipped steps."""

    SLOTS: tuple = ()
    COUNTERS = ('count', 'total_notfinite')

    def __init__(self, model: nn.Module, opt_cfg):
        self.params = [(n, p) for n, p in model.named_parameters()
                       if p.requires_grad]
        self.max_norm = float(opt_cfg.get('GRAD_NORM_CLIP', 10.0))
        self.count = 0
        self.total_notfinite = 0
        for slot in self.SLOTS:
            setattr(self, slot, [torch.zeros_like(p)
                                 for _, p in self.params])

    def lr(self):
        """The learning rate the next update applies (float32 tensor)."""
        return self.lr_fn(self.count)

    def _grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for _, p in self.params]

    def _clip(self, grads):
        g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if not bool(g_norm < self.max_norm):
            grads = [g / g_norm * self.max_norm for g in grads]
        return grads

    def state_dict(self):
        names = [n for n, _ in self.params]
        state = {k: int(getattr(self, k)) for k in self.COUNTERS}
        for slot in self.SLOTS:
            state[slot] = dict(zip(names, getattr(self, slot)))
        return state

    @torch.no_grad()
    def load_state_dict(self, state):
        names = [n for n, _ in self.params]
        for slot in self.SLOTS:
            saved = state[slot]
            if set(saved) != set(names):
                raise KeyError(f'optimizer state {slot}: parameters differ '
                               f'({sorted(set(saved) ^ set(names))[:4]})')
            for n, t in zip(names, getattr(self, slot)):
                t.copy_(saved[n])
        for k in self.COUNTERS:
            setattr(self, k, int(state[k]))


class Adam(_Optimizer):
    """``adam``: clipping, then Adam (b1 0.9, b2 0.999, eps 1e-8) at the
    step-decay learning rate."""

    SLOTS = ('mu', 'nu')

    def __init__(self, model: nn.Module, opt_cfg, total_steps: int):
        super().__init__(model, opt_cfg)
        self.lr_fn = step_decay_lr(opt_cfg, total_steps)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8

    @torch.no_grad()
    def step(self) -> bool:
        grads = self._clip(self._grads())
        dev = grads[0].device
        lr = self.lr_fn(self.count).to(dev)
        t = self.count + 1
        bc1 = (1 - torch.tensor(self.b1, dtype=torch.float32) ** t).to(dev)
        bc2 = (1 - torch.tensor(self.b2, dtype=torch.float32) ** t).to(dev)
        for (_, p), g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g * g + self.b2 * nu)
            p.add_(-lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)))
        self.count += 1
        return True


class SGD(_Optimizer):
    """``sgd``: clipping, then SGD with momentum ``MOMENTUM`` (the trace
    g + momentum * trace, not Nesterov) at the step-decay learning
    rate."""

    SLOTS = ('trace',)

    def __init__(self, model: nn.Module, opt_cfg, total_steps: int):
        super().__init__(model, opt_cfg)
        self.lr_fn = step_decay_lr(opt_cfg, total_steps)
        self.momentum = float(opt_cfg.MOMENTUM)

    @torch.no_grad()
    def step(self) -> bool:
        grads = self._clip(self._grads())
        lr = self.lr_fn(self.count).to(grads[0].device)
        for (_, p), g, tr in zip(self.params, grads, self.trace):
            tr.copy_(g + self.momentum * tr)
            p.add_(-lr * tr)
        self.count += 1
        return True


class AdamOneCycle(_Optimizer):
    """``adam_onecycle``. ``step()`` returns whether the update was
    applied."""

    SLOTS = ('mu', 'nu')
    COUNTERS = ('count', 'notfinite_count', 'total_notfinite')

    def __init__(self, model: nn.Module, opt_cfg, total_steps: int):
        super().__init__(model, opt_cfg)
        decay = decayed_parameters(model)
        self.decay = [n in decay for n, _ in self.params]
        self.lr_fn, self.mom_fn = one_cycle_lr(
            opt_cfg.LR, total_steps, tuple(opt_cfg.MOMS), opt_cfg.DIV_FACTOR,
            opt_cfg.PCT_START)
        self.weight_decay = float(opt_cfg.get('WEIGHT_DECAY', 0.0))
        self.b2, self.eps = 0.999, 1e-8
        self.notfinite_count = 0

    @torch.no_grad()
    def step(self) -> bool:
        grads = self._grads()
        finite = bool(torch.stack([torch.isfinite(g).all()
                                   for g in grads]).all())
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        if not finite:
            self.total_notfinite += 1
            if self.notfinite_count <= MAX_CONSECUTIVE_ERRORS:
                return False
        grads = self._clip(grads)
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


OPTIMIZERS = {'adam_onecycle': AdamOneCycle, 'adam': Adam, 'sgd': SGD}


def build_optimizer(model: nn.Module, opt_cfg, total_steps: int):
    """The optimizer ``opt_cfg.OPTIMIZER`` names over ``model``'s
    parameters; ``NotImplementedError`` for any other name."""
    name = opt_cfg.OPTIMIZER
    if name not in OPTIMIZERS:
        raise NotImplementedError(
            f'optimizer {name!r}: the JAX package builds '
            f'{sorted(OPTIMIZERS)} only')
    return OPTIMIZERS[name](model, opt_cfg, total_steps)
