"""The port's ``adam_onecycle`` (virconv_tpu_torch/train/optim.py) against the
JAX package's optax chain (virconv_tpu/train/optim.py): the OneCycle
learning-rate and momentum schedules at several steps (rtol 1e-6), then
several optimizer steps on a small parameter tree with the same gradients:
weight decay on kernels only, a step whose gradient norm is clipped, and a
non-finite step that is skipped and counted. Parameters after each step
within atol 1e-7 / rtol 1e-5 (f32 arithmetic in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from virconv_tpu.config import CfgNode as JaxCfg
from virconv_tpu.train.optim import build_optimizer
from virconv_tpu.train.optim import one_cycle_lr as jax_one_cycle_lr
from virconv_tpu_torch.config import virconv_t_config
from virconv_tpu_torch.models.layers import MaskedBatchNorm
from virconv_tpu_torch.train.optim import (AdamOneCycle, decayed_parameters,
                                           one_cycle_lr)


@pytest.mark.parametrize('total', [10, 1000])
def test_one_cycle_schedules_match_jax(total):
    opt = virconv_t_config().OPTIMIZATION
    args = (opt.LR, total, tuple(opt.MOMS), opt.DIV_FACTOR, opt.PCT_START)
    lr, mom = one_cycle_lr(*args)
    jlr, jmom = jax_one_cycle_lr(*args)
    steps = sorted({0, 1, 3, total // 3, int(total * 0.4), total // 2,
                    total - 1, total, total + 5})
    for s in steps:
        np.testing.assert_allclose(float(lr(s)), float(jlr(s)), rtol=1e-6,
                                   err_msg=f'lr at {s}')
        np.testing.assert_allclose(float(mom(s)), float(jmom(s)), rtol=1e-6,
                                   err_msg=f'momentum at {s}')


class Tiny(nn.Module):
    """A sparse-conv kernel, a linear layer and a BN: the three kinds of
    leaf the decay mask tells apart."""

    def __init__(self, rng):
        super().__init__()
        def t(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32))
        self.kernel = nn.Parameter(t(27, 4, 6))
        self.fc = nn.Linear(6, 5)
        with torch.no_grad():
            self.fc.weight.copy_(t(5, 6))
            self.fc.bias.copy_(t(5))
        self.bn = MaskedBatchNorm(5)
        with torch.no_grad():
            self.bn.weight.copy_(t(5))
            self.bn.bias.copy_(t(5))

    def jax_tree(self, grads=False):
        """The same leaves as a flax tree (Linear's weight is the transposed
        flax kernel): the parameters, or with ``grads`` their ``.grad``."""
        def a(p):     # a copy: the port updates its parameters in place
            return jnp.asarray(np.array((p.grad if grads else p).detach()))
        return {'kernel': a(self.kernel),
                'fc': {'kernel': a(self.fc.weight).T, 'bias': a(self.fc.bias)},
                'bn': {'scale': a(self.bn.weight), 'bias': a(self.bn.bias)}}


def _step_grads(rng, model):
    """Gradient sets for 5 steps: small, clipped (norm > 10), non-finite,
    small, clipped."""
    out = []
    for i, scale in enumerate((0.1, 5.0, 0.1, 0.2, 3.0)):
        g = {n: (rng.standard_normal(tuple(p.shape)) * scale).astype(
            np.float32) for n, p in model.named_parameters()}
        if i == 2:
            g['fc.bias'][1] = np.nan
        out.append(g)
    return out


def test_decay_mask_is_kernels_only():
    model = Tiny(np.random.default_rng(0))
    assert decayed_parameters(model) == {'kernel', 'fc.weight'}


def test_adam_onecycle_steps_match_optax():
    rng = np.random.default_rng(0)
    model = Tiny(rng)
    opt_cfg = virconv_t_config().OPTIMIZATION
    opt = AdamOneCycle(model, opt_cfg, total_steps=10)
    params = model.jax_tree()
    tx, _ = build_optimizer(params, JaxCfg(dict(opt_cfg)), total_steps=10)
    state = tx.init(params)
    norms = []
    for i, g in enumerate(_step_grads(rng, model)):
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n])
        grads = model.jax_tree(grads=True)
        norms.append(float(optax.global_norm(grads)))
        applied = opt.step()
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        assert applied == (i != 2)
        got = model.jax_tree()
        for path, want in jax.tree_util.tree_leaves_with_path(params):
            leaf = got
            for k in path:
                leaf = leaf[k.key]
            np.testing.assert_allclose(np.asarray(leaf), np.asarray(want),
                                       atol=1e-7, rtol=1e-5,
                                       err_msg=f'step {i} {path}')
    assert norms[1] > 10 and norms[4] > 10 and norms[0] < 10
    assert not np.isfinite(norms[2])
    assert opt.total_notfinite == int(state.total_notfinite) == 1
    assert opt.count == 4
