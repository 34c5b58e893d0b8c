"""The port's optimizers (virconv_tpu_torch/train/optim.py) against the
JAX package's optax chains (virconv_tpu/train/optim.py). ``adam_onecycle``:
the OneCycle learning-rate and momentum schedules at several steps (rtol
1e-6), then several optimizer steps on a small parameter tree with the
same gradients: weight decay on kernels only, a step whose gradient norm
is clipped, and a non-finite step that is skipped and counted. Parameters
after each step within atol 1e-7 / rtol 1e-5 (f32 arithmetic in another
order). ``adam`` and ``sgd``: the step-decay schedule (rtol 1e-6) and 8
steps across both ``DECAY_STEP_LIST`` boundaries, clipped steps among
them, parameters within rtol 1e-6 (atol 1e-8 for the elements near 0).
Then a state round trip for all three: a step after ``state_dict`` ->
``load_state_dict`` into a fresh optimizer equals the uninterrupted step
bit for bit."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from virconv_tpu.config import CfgNode as JaxCfg
from virconv_tpu.train.optim import build_optimizer as jax_build_optimizer
from virconv_tpu.train.optim import one_cycle_lr as jax_one_cycle_lr
from virconv_tpu_torch.config import virconv_t_config
from virconv_tpu_torch.models.layers import MaskedBatchNorm
from virconv_tpu_torch.train.optim import (AdamOneCycle, build_optimizer,
                                           decayed_parameters, one_cycle_lr)


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
    tx, _ = jax_build_optimizer(params, JaxCfg(dict(opt_cfg)),
                                total_steps=10)
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


# ---------------------------------------------------------- adam and sgd ---
TOTAL = 8              # 4 epochs of 2 steps: the LR decays at steps 2 and 6


def step_decay_cfg(name):
    opt = virconv_t_config().OPTIMIZATION
    opt.OPTIMIZER = name
    opt.NUM_EPOCHS = 4
    opt.DECAY_STEP_LIST = [1, 3]
    return opt


@pytest.mark.parametrize('name', ['adam', 'sgd'])
def test_step_decay_schedule_matches_optax(name):
    opt_cfg = step_decay_cfg(name)
    model = Tiny(np.random.default_rng(0))
    opt = build_optimizer(model, opt_cfg, TOTAL)
    _, jlr = jax_build_optimizer(model.jax_tree(), JaxCfg(dict(opt_cfg)),
                                 TOTAL)
    for s in range(TOTAL + 2):
        np.testing.assert_allclose(float(opt.lr_fn(s)), float(jlr(s)),
                                   rtol=1e-6, err_msg=f'lr at {s}')
    assert float(opt.lr_fn(1)) == pytest.approx(0.01)
    assert float(opt.lr_fn(2)) == pytest.approx(0.001)
    assert float(opt.lr_fn(6)) == pytest.approx(0.0001)


@pytest.mark.parametrize('name', ['adam', 'sgd'])
def test_adam_and_sgd_steps_match_optax(name):
    rng = np.random.default_rng(1)
    model = Tiny(rng)
    opt_cfg = step_decay_cfg(name)
    opt = build_optimizer(model, opt_cfg, TOTAL)
    params = model.jax_tree()
    tx, _ = jax_build_optimizer(params, JaxCfg(dict(opt_cfg)), TOTAL)
    state = tx.init(params)
    norms = []
    for i, scale in enumerate((0.1, 5.0, 0.2, 3.0, 0.1, 0.3, 4.0, 0.05)):
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy((rng.standard_normal(
                tuple(p.shape)) * scale).astype(np.float32))
        grads = model.jax_tree(grads=True)
        norms.append(float(optax.global_norm(grads)))
        assert opt.step()
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        got = model.jax_tree()
        for path, want in jax.tree_util.tree_leaves_with_path(params):
            leaf = got
            for k in path:
                leaf = leaf[k.key]
            np.testing.assert_allclose(np.asarray(leaf), np.asarray(want),
                                       rtol=1e-6, atol=1e-8,
                                       err_msg=f'{name} step {i} {path}')
    assert sum(n > 10 for n in norms) == 3 and norms[0] < 10
    assert opt.count == TOTAL and opt.total_notfinite == 0


@pytest.mark.parametrize('name', ['adam_onecycle', 'adam', 'sgd'])
def test_optimizer_state_round_trip(name):
    """Two steps, the state through ``torch.save`` into a fresh optimizer
    over a copy of the model, a third step on each: the same parameters
    and state, bit for bit (``adam_onecycle`` with a skipped step among the
    first two, so its counters travel too)."""
    import copy
    rng = np.random.default_rng(2)
    model = Tiny(rng)
    opt_cfg = step_decay_cfg(name)
    grads = _step_grads(rng, model)[1:4]     # clipped, non-finite, small
    if name != 'adam_onecycle':
        grads[1]['fc.bias'][1] = 0.5         # adam and sgd apply NaNs
    opt = build_optimizer(model, opt_cfg, TOTAL)

    def step(m, o, g):
        for n, p in m.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        o.step()
    for g in grads[:2]:
        step(model, opt, g)
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    fresh_model = copy.deepcopy(model)
    fresh = build_optimizer(fresh_model, opt_cfg, TOTAL)
    fresh.load_state_dict(torch.load(buf, weights_only=True))
    step(model, opt, grads[2])
    step(fresh_model, fresh, grads[2])
    for (n, a), (_, b) in zip(model.named_parameters(),
                              fresh_model.named_parameters()):
        assert torch.equal(a, b), n
    got, want = fresh.state_dict(), opt.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert all(torch.equal(got[k][n], t) for n, t in v.items()), k
        else:
            assert got[k] == v, k
    assert want['count'] == (2 if name == 'adam_onecycle' else 3)
