"""Three training steps of the port (plain kernel versions on the CPU)
against three steps of the JAX package from the same weights and the same
draws: the tiny VirConv-T preset of tests/test_torch_train_step.py on its
sparse-grid batch, with the RPN's ODIoU term (``OD_LOSS: True``), here;
tests/test_torch_multi_step_l.py runs the same checks on the tiny-L
preset of tests/test_torch_virconv_l_step.py. The JAX step is
``jax.value_and_grad`` of ``model.apply(train=True,
mutable=['batch_stats'])``, then the optimizer of
``virconv_tpu/train/optim.py`` (``adam_onecycle``) and
``optax.apply_updates``, as ``virconv_tpu/train/trainer.py`` composes
them, jitted once and called three times with the carried state. Step
t takes PRNGKey(4 + 3t), (5 + 3t) and (6 + 3t) for the StVD, the ROI
sampling and dropout; each step's StVD uniforms and ROI-sampling draws
are recorded and replayed to ``Trainer.step``.

Each port step starts from the JAX state after the step before (the
parameters, the BN statistics, Adam's moments and count), so the checks
see what a later step adds (the optimizer's state and schedules at step
t, the BN statistics, the ROI targets of moved weights) and not the
parting of two free-running runs: Adam turns a gradient element that is
round-off on both sides into a step of up to the learning rate, of
either sign, and the proposals' NMS and ROI sampling then pick other
sets (the tiny-L loss parted by 24 % at the second step that way).

Four kinds of place where f32 round-off crosses a discontinuity are
taken out of the comparison, each after a check that the two sides
agree: each stage's ROIs enter the port's ROI sampling with JAX's values
and order (within 1e-4; proposals whose scores tie within round-off may
leave NMS in either order); each ROI pool's output enters the head with
JAX's values (within 1e-4 x its scale); so does every BatchNorm's
output, the pre-activation of the ReLU after it (within 1e-3 x its
scale: a train-mode BN divides by the batch's deviation, which magnifies
the pools' 2e-5 relative differences, up to 1.3e-4 seen); and so does
each training pool group's sum of gathered rows and position term, the
input of the ReLU before its max (within 1e-4 x its scale;
``snap_pool_relu``). All are straight through (the port's value plus its
detached difference to JAX's), so every gradient still flows through
the port's own proposals, pools, BNs and backbone, and only the ReLU
masks and the discrete choices are JAX's. Without them a voxel query
lies within the proposals' round-off of its radius (keys 0, 1 and 2,
tiny-L's first step: moving the port's ROIs by 1e-5 m put its gradients
onto JAX's), or a pre-activation lies closer to ReLU's kink than the two
sides' round-off and gradients part. With these keys that happens three
times: tiny-T's third step, ``bev_backbone.block1_conv0.BatchNorm_0``
channel 19 (-7.1e-7 in the port, +4.3e-7 in JAX, of a 7.3 scale);
tiny-L's second, ``roi_head.pool_mm_x_conv4.mlp_out_bn0`` channel 12
(-2.3e-6 against +1.8e-6, of 6.8); and tiny-L's third, two sums in the
pools (+1.07e-5 against -1.22e-5, and -1.0e-6 against +2.4e-6, of
10.4 and 9.3), whose one sample then carries a column's max gradient on
one side only, into the pool's position term, the ROIs, the RPN's box
branch and the backbone. The first two put their BN's bias gradient
2.3x and 2.1x outside the tolerance, and with that one BN's output
snapped every gradient comes within it (worst 4.2e-5 and 1.3e-4 of the
scale); the third put 29 tensors outside it. JAX run eagerly agrees with
JAX under ``jit`` at all three (within 3.3e-6, 1.5e-5 and 3.0e-5), so
the two sides differ by round-off, not by what they compute.

After every step: the loss and every tb term within rtol 1e-4 (atol
1e-6); every gradient within 1e-3 x the max |JAX grad| of its parameter,
floored at 1e-4 x the step's largest (tests/test_torch_train_step.py);
the BN running statistics within 1e-5; every parameter within 1e-3 x its
max |JAX value| plus what that gradient tolerance moves Adam's update:
lr x twice its first-order change through m and v (from JAX's moments
after the step), at most 2 x lr, the most an update can move when the
gradient's sign is round-off (Adam's bias-corrected |m| / sqrt(v) stays
at or under 1 in these steps); Adam's count and skip count exactly, mu
within 1e-3 x its max |JAX mu| and nu within 2e-3 x its max |JAX nu|
(nu holds squared gradients), both scales floored as the gradients'."""
import functools

import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from virconv_tpu.config import CfgNode as JaxCfg
from virconv_tpu.models.detectors.voxel_rcnn import VoxelRCNN as JaxRCNN
from virconv_tpu.models.roi_heads import voxel_pool as jvoxel_pool
from virconv_tpu.train.optim import build_optimizer as jax_build_optimizer
from virconv_tpu_torch.config import CfgNode, virconv_t_config
from virconv_tpu_torch.models.roi_heads import ted_head
from virconv_tpu_torch.models.roi_heads import voxel_pool as tvoxel_pool
from virconv_tpu_torch.models.roi_heads.voxel_pool import NeighborVoxelSAModule
from virconv_tpu_torch.train.draws import Draws
from virconv_tpu_torch.train.trainer import Trainer
from virconv_tpu_torch.utils.jax_weights import (from_jax_variables,
                                                 load_state_dict_checked)

from test_model_forward import shrink_cfg, tiny_cfg
from test_torch_detector import random_variables
from test_torch_train_step import install_recorders, sparse_grid_batch

torch.set_num_threads(1)

N_STEPS = 3
TOTAL_STEPS = 1000
# module types whose outputs enter the port's step with JAX's values
SNAPPED = ('NeighborVoxelSAModule', 'BatchNorm', 'MaskedBatchNorm')


def t_setup(od_loss=False):
    """(port config, JAX model, variables, batch) of the tiny-T step of
    tests/test_torch_train_step.py: dropout off, its NMS sizes and small
    box residuals, so both stages sample foreground; ``od_loss`` sets
    ``DENSE_HEAD.OD_LOSS``."""
    model_cfg, data_cfg = tiny_cfg(mm=True)
    shrink_cfg(model_cfg, data_cfg)
    model_cfg.ROI_HEAD.DP_RATIO = 0.0
    if od_loss:
        model_cfg.DENSE_HEAD.OD_LOSS = True
    nms = model_cfg.ROI_HEAD.NMS_CONFIG.TRAIN
    nms.NMS_PRE_MAXSIZE, nms.NMS_POST_MAXSIZE = 256, 128
    batch = sparse_grid_batch()
    jmodel = JaxRCNN(model_cfg=model_cfg, dataset_cfg=data_cfg)
    variables = random_variables(jmodel, batch)
    for box in (variables['params']['dense_head']['conv_box'],
                variables['params']['roi_head']['reg_head']['out']):
        box['kernel'] = box['kernel'] * np.float32(0.01)
        box['bias'] = box['bias'] * np.float32(0.01)
    cfg = CfgNode({'CLASS_NAMES': ['Car'], 'MODEL': dict(model_cfg),
                   'DATA_CONFIG': dict(data_cfg),
                   'OPTIMIZATION': virconv_t_config().OPTIMIZATION})
    return cfg, jmodel, variables, batch


def adam_moments(opt_state):
    """(mu, nu) of the ``ScaleByAdamState`` inside an optax state."""
    found = []

    def visit(x):
        if isinstance(x, optax.ScaleByAdamState):
            found.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                visit(y)
        elif hasattr(x, '_fields'):
            for f in x._fields:
                visit(getattr(x, f))
    visit(opt_state)
    assert len(found) == 1
    return found[0].mu, found[0].nu


def calls_by_path(tree, prefix=()):
    """{dotted module path: [``__call__`` outputs in call order]} of
    captured flax intermediates (the path is the port's module name; other
    methods' outputs are left out)."""
    out = {}
    for k, v in tree.items():
        if k == '__call__':
            out['.'.join(prefix)] = [np.asarray(x) for x in v]
        elif isinstance(v, dict):
            out.update(calls_by_path(v, prefix + (k,)))
    return out


class _Delegate:
    """Stands in for a module (``flax.linen`` or ``torch``) inside one of
    the two packages' ``voxel_pool``: every name is the module's, but
    ``relu`` of a 3-D input, a training pool group's (rows, samples, mid)
    sum of gathered rows and position term, goes to ``pool_relu``."""

    def __init__(self, module, pool_relu):
        self._module, self._pool_relu = module, pool_relu

    def __getattr__(self, name):
        return getattr(self._module, name)

    def relu(self, x):
        if x.ndim == 3:
            x = self._pool_relu(x)
        return self._module.relu(x)


def record_pool_relu(monkeypatch):
    """Records, through debug callbacks, every pre-ReLU input of the JAX
    training pools' groups (``_group_body``'s tail): under ``nn.remat``
    twice, in the forward and as the backward recomputes it, the two a few
    ulps apart (in the order XLA runs them). Returns the list the records
    go to."""
    seen = []

    def record(x):
        jax.debug.callback(lambda a: seen.append(np.asarray(a)), x)
        return x
    monkeypatch.setattr(jvoxel_pool, 'nn', _Delegate(fnn, record))
    return seen


def jax_steps(model, variables, batch, opt_cfg, monkeypatch):
    """N_STEPS JAX train steps under one ``jit``: per step the loss, tb,
    parameters, BN statistics, Adam moments, skip count, the draws, the
    outputs of every module of a ``SNAPPED`` type and the pools' pre-ReLU
    inputs (``record_pool_relu``)."""
    stvd, stages, _ = install_recorders(monkeypatch)
    pool_x = record_pool_relu(monkeypatch)
    jbatch = {k: None if v is None else jnp.asarray(v)
              for k, v in batch.items()}
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    stats = jax.tree_util.tree_map(jnp.asarray, variables['batch_stats'])
    tx, _ = jax_build_optimizer(params, JaxCfg(dict(opt_cfg)), TOTAL_STEPS)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, stats, opt_state, rngs):
        def loss_fn(p):
            out, mut = model.apply(
                {'params': p, 'batch_stats': stats}, jbatch, train=True,
                rngs=rngs, mutable=['batch_stats', 'intermediates'],
                capture_intermediates=lambda m, _: type(m).__name__ in
                SNAPPED)
            return out['loss'], (out['tb'], mut['batch_stats'],
                                 mut['intermediates'])
        (loss, (tb, new_stats, captured)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (loss, tb, grads, optax.apply_updates(params, updates),
                new_stats, opt_state, captured)

    out = []
    for t in range(N_STEPS):
        n_stvd, n_stages, n_x = len(stvd), len(stages), len(pool_x)
        rngs = {k: jax.random.PRNGKey(4 + 3 * t + i) for i, k in
                enumerate(('stvd', 'sampling', 'dropout'))}
        loss, tb, grads, params, stats, opt_state, captured = step(
            params, stats, opt_state, rngs)
        jax.effects_barrier()
        mu, nu = adam_moments(opt_state)
        xs = pool_x[n_x:]
        assert xs and len(xs) % 2 == 0, len(xs)
        out.append({'loss': float(loss),
                    'tb': {k: float(v) for k, v in tb.items()},
                    'grads': from_jax_variables({'params': grads}),
                    'params': from_jax_variables({'params': params}),
                    'stats': from_jax_variables({'params': {},
                                                 'batch_stats': stats}),
                    'mu': from_jax_variables({'params': mu}),
                    'nu': from_jax_variables({'params': nu}),
                    'skips': int(opt_state.total_notfinite),
                    'stage_rois': [s['rois'] for s in stages[n_stages:]],
                    'captured': calls_by_path(captured),
                    'pool_x': xs,
                    'draws': stvd[n_stvd:] + [
                        d for s in stages[n_stages:] for d in s['draws']]})
    return out


def match_rows(got, want):
    """(R,) indices of ``got``'s rows in ``want``'s order: each row of
    ``want`` takes a distinct row of ``got`` within atol 1e-4 / rtol 1e-4
    (its own position first)."""
    ok = ((got[:, None] - want[None]).abs()
          <= 1e-4 + 1e-4 * want[None].abs()).all(-1)        # (got, want)
    used, order = set(), []
    for j in range(want.shape[0]):
        cand = [j] if bool(ok[j, j]) and j not in used else []
        cand += [k for k in ok[:, j].nonzero()[:, 0].tolist()
                 if k not in used]
        assert cand, f'JAX ROI {j} has no port ROI within 1e-4'
        used.add(cand[0])
        order.append(cand[0])
    return torch.tensor(order)


def snap_rois(monkeypatch, stage_rois):
    """Makes the port's ROI sampling take each stage's ROIs with the values
    and order of ``stage_rois`` (JAX's, popped in stage order), straight
    through: the matched port ROIs (``match_rows``), with their scores and
    labels, plus the detached difference."""
    orig = ted_head.proposal_targets

    def targets(rng, rois, scores, labels, *rest):
        jrois = torch.from_numpy(stage_rois.pop(0)[..., :rois.shape[-1]])
        order = [match_rows(r.detach(), j) for r, j in zip(rois, jrois)]
        rois, scores, labels = (torch.stack([x[i][o] for i, o in
                                             enumerate(order)])
                                for x in (rois, scores, labels))
        return orig(rng, rois + (jrois - rois).detach(), scores, labels,
                    *rest)
    monkeypatch.setattr(ted_head, 'proposal_targets', targets)


def snap_outputs(model, captured):
    """Makes each module of ``model`` named in ``captured`` (JAX's outputs,
    by module path in call order: the ROI pools and every BN) return JAX's
    values, straight through, after checking they agree within 1e-4 (a
    pool) or 1e-3 (a BN) x their scale (a 2D BN's NHWC output taken to
    the port's NCHW). Returns the hook handles."""
    def hook(module, args, out, name, rel):
        want = torch.from_numpy(np.array(captured[name].pop(0)))
        if want.shape != out.shape and want.ndim == 4:
            want = want.permute(0, 3, 1, 2)
        scale = max(1.0, float(want.abs().max()))
        err = float((out.detach() - want).abs().max())
        assert err <= rel * scale, (name, err, scale)
        return out + (want - out).detach()
    handles = []
    for name in captured:
        module = model.get_submodule(name)
        rel = 1e-4 if isinstance(module, NeighborVoxelSAModule) else 1e-3
        handles.append(module.register_forward_hook(
            functools.partial(hook, name=name, rel=rel)))
    return handles


def snap_pool_relu(monkeypatch, pool_x):
    """Makes each training pool group's pre-ReLU input in the port's
    ``voxel_pool`` take the values of the nearest of ``pool_x`` (JAX's),
    straight through, after checking they agree within 1e-4 x their scale.
    The record and its twin (the same sum as JAX's backward recomputed it,
    within 1e-5 x the scale, which leaves every sign as it is in the
    forward's) are used up."""
    def snap(x):
        want = [torch.from_numpy(np.array(a)) for a in pool_x]

        def dist(a, b):
            return (float((a - b).abs().max()) if a.shape == b.shape
                    else float('inf'))
        errs = [dist(x.detach(), w) for w in want]
        i = int(np.argmin(errs))
        w = want[i]
        scale = max(1.0, float(w.abs().max()))
        assert errs[i] <= 1e-4 * scale, ('pool pre-ReLU', errs[i], scale)
        twins = [dist(v, w) if j != i else float('inf')
                 for j, v in enumerate(want)]
        j = int(np.argmin(twins))
        assert twins[j] <= 1e-5 * scale, ('pool pre-ReLU twin', twins[j])
        assert ((want[j] > 0) == (w > 0)).all(), 'twins of one sign pattern'
        for k in sorted((i, j), reverse=True):
            pool_x.pop(k)
        return x + (w - x).detach()
    monkeypatch.setattr(tvoxel_pool, 'torch', _Delegate(torch, snap))


def port_steps(cfg, variables, batch, want):
    """The port's Trainer for N_STEPS steps, each from the JAX state after
    the step before and replaying the JAX step's draws and stage ROIs
    (``snap_rois``); per step the loss, tb, gradients, parameters, buffers
    and optimizer state."""
    trainer = Trainer(CfgNode(cfg), state_dict=from_jax_variables(variables),
                      device='cpu', total_steps=TOTAL_STEPS)
    out = []
    for t, w in enumerate(want):
        if t:
            prev = want[t - 1]
            load_state_dict_checked(trainer.model,
                                    {**prev['params'], **prev['stats']})
            opt = trainer.optimizer.state_dict()
            opt.update(mu=prev['mu'], nu=prev['nu'], count=t)
            trainer.optimizer.load_state_dict(opt)
        draws = Draws(replay=list(w['draws']))
        stage_rois = list(w['stage_rois'])
        captured = {k: list(v) for k, v in w['captured'].items()}
        pool_x = list(w['pool_x'])
        hooks = snap_outputs(trainer.model, captured)
        with pytest.MonkeyPatch.context() as mp:
            snap_rois(mp, stage_rois)
            snap_pool_relu(mp, pool_x)
            loss, tb = trainer.step(batch, draws)
        for h in hooks:
            h.remove()
        assert not draws.replay, 'every JAX draw is used'
        assert not pool_x, 'every pool group ran'
        assert not stage_rois, 'every stage sampled its ROIs'
        assert any(isinstance(trainer.model.get_submodule(k),
                              NeighborVoxelSAModule) for k in captured)
        left = [k for k, v in captured.items() if v]
        assert not left, f'modules JAX ran and the port did not: {left}'
        opt = trainer.optimizer.state_dict()
        out.append({'loss': float(loss),
                    'tb': {k: float(v) for k, v in tb.items()},
                    'grads': {n: p.grad.clone() for n, p in
                              trainer.model.named_parameters()},
                    'params': {n: p.detach().clone() for n, p in
                               trainer.model.named_parameters()},
                    'stats': {n: b.clone() for n, b in
                              trainer.model.named_buffers()},
                    'mu': {n: t.clone() for n, t in opt['mu'].items()},
                    'nu': {n: t.clone() for n, t in opt['nu'].items()},
                    'count': opt['count'],
                    'skips': opt['total_notfinite'],
                    'lr': float(trainer.optimizer.lr_fn(t)),
                    'b1': float(trainer.optimizer.mom_fn(t))})
    return out


def run_both(setup):
    cfg, jmodel, variables, batch = setup()
    with pytest.MonkeyPatch.context() as mp:
        want = jax_steps(jmodel, variables, batch, cfg.OPTIMIZATION, mp)
    return want, port_steps(cfg, variables, batch, want)


@pytest.fixture(scope='module')
def runs():
    return run_both(lambda: t_setup(od_loss=True))


def test_loss_terms_each_step(runs):
    want, got = runs
    for t, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g['loss'], w['loss'], rtol=1e-4,
                                   err_msg=f'step {t}')
        assert set(g['tb']) == set(w['tb']) | {'nonfinite_skips'}
        for k, v in w['tb'].items():
            np.testing.assert_allclose(g['tb'][k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f'step {t} {k}')
    assert any(w['tb'].get('rcnn_reg_fg_s0', 0) > 0 for w in want), \
        'want foreground rois'



def _scales(want, floor):
    """Per tensor, max |want| floored at ``floor`` x the largest of all."""
    top = max(float(w.abs().max()) for w in want.values())
    return {n: max(float(w.abs().max()), floor * top, 1e-30)
            for n, w in want.items()}


def _close(got, want, rel, what, floor=0.0):
    assert set(got) == set(want), what
    for name, scale in _scales(want, floor).items():
        err = float((got[name] - want[name]).abs().max())
        assert err <= rel * scale, (what, name, err, rel * scale)


def test_gradients_each_step(runs):
    want, got = runs
    for t, (w, g) in enumerate(zip(want, got)):
        _close(g['grads'], w['grads'], 1e-3, f'gradients of step {t}',
               floor=1e-4)


def update_slack(lr, b1, count, mu, nu, grad, tol, b2=0.999, eps=1e-8):
    """Per element: how far a gradient error of ``tol`` can move Adam's
    update lr * m_hat / (sqrt(v_hat) + eps) (twice its first-order change
    through m and v at JAX's moments ``mu``, ``nu``), at most 2 lr."""
    bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
    m_hat, s = (mu / bc1).abs(), torch.sqrt(nu / bc2)
    dm = (1 - b1) * tol / bc1
    dv = (1 - b2) * (2 * grad.abs() * tol + tol * tol) / bc2
    du = dm / (s + eps) + m_hat * dv / (2 * torch.clamp(s, min=eps)
                                        * (s + eps) ** 2)
    return torch.clamp(2 * lr * du, max=2 * lr)


def test_parameters_each_step(runs):
    want, got = runs
    for t, (w, g) in enumerate(zip(want, got)):
        gscale = _scales(w['grads'], 1e-4)
        assert set(g['params']) == set(w['params'])
        for name, scale in _scales(w['params'], 0.0).items():
            bound = 1e-3 * scale + update_slack(
                g['lr'], g['b1'], t + 1, w['mu'][name], w['nu'][name],
                w['grads'][name], 1e-3 * gscale[name])
            err = (g['params'][name] - w['params'][name]).abs()
            assert (err <= bound).all(), (
                f'parameters after step {t}', name, float(err.max()))


def test_od_loss_each_step(runs):
    """The T steps run the RPN's ODIoU term (``OD_LOSS``): it is reported
    and positive on both sides at every step (its value against JAX's in
    test_loss_terms_each_step, its gradients in
    test_gradients_each_step)."""
    want, got = runs
    for w, g in zip(want, got):
        assert w['tb']['rpn_loss_od'] > 0 and g['tb']['rpn_loss_od'] > 0


def test_bn_statistics_each_step(runs):
    want, got = runs
    for t, (w, g) in enumerate(zip(want, got)):
        assert w['stats']
        for name, v in w['stats'].items():
            np.testing.assert_allclose(g['stats'][name].numpy(), v.numpy(),
                                       atol=1e-5, rtol=1e-5,
                                       err_msg=f'step {t} {name}')


def test_optimizer_state_each_step(runs):
    want, got = runs
    for t, (w, g) in enumerate(zip(want, got)):
        assert g['count'] == t + 1
        assert g['skips'] == w['skips'] == 0
        _close(g['mu'], w['mu'], 1e-3, f'mu after step {t}', floor=1e-4)
        _close(g['nu'], w['nu'], 2e-3, f'nu after step {t}', floor=1e-8)
