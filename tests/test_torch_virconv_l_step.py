"""One whole tiny-L training step of the port (plain kernel versions on the
CPU) against the JAX package's ``jax.value_and_grad``, as
tests/test_torch_train_step.py runs it for VirConv-T: the tiny-L config
(``configs/tiny.tiny_l_config``, dropout off) on that file's duplicate-free
sparse-grid batch as one fused stream, the same carried weights, the JAX
StVD uniforms (no input draw, then x_conv1..3) and ROI-sampling draws
replayed. In order: the proposals and the sampled ROIs of the one stage
(as sets per entry: proposals whose scores tie within float round-off may
leave NMS in either order), the loss and every tb term within rtol 1e-4,
every gradient within 1e-3 x the max |JAX grad| of its parameter (floored
at 1e-4 x the step's largest gradient)."""
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import numpy as np
import pytest
import torch

from virconv_tpu_torch.config import CfgNode
from virconv_tpu_torch.train.draws import Draws
from virconv_tpu_torch.train.trainer import Trainer
from virconv_tpu_torch.utils.jax_weights import from_jax_variables

from test_torch_train_step import run_jax
from test_torch_virconv_l import train_setup

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def steps():
    cfg, jmodel, variables, batch = train_setup()
    with pytest.MonkeyPatch.context() as mp:
        want = run_jax(jmodel, variables, batch, mp)
    trainer = Trainer(CfgNode(cfg), state_dict=from_jax_variables(variables),
                      device='cpu')
    captured = {}
    forward = trainer.model.forward

    def capture(*a, **k):
        captured.update(forward(*a, **k))
        return captured
    draws = Draws(replay=want['stvd']
                  + [d for s in want['stages'] for d in s['draws']])
    trainer.model.forward = capture
    loss, tb = trainer.step(batch, draws)
    assert not draws.replay, 'every JAX draw is used'
    return want, {'loss': loss, 'tb': tb, 'out': captured,
                  'model': trainer.model}


def by_position(rois):
    """Each entry's rows in (x, y, z) order: proposals whose scores tie
    to within float round-off may leave NMS in either order."""
    rois = np.asarray(rois)
    return np.stack([r[np.lexsort(np.round(r[:, 2::-1].T, 3))]
                     for r in rois])


def test_train_step_rois_match_jax(steps):
    want, got = steps
    out = got['out']
    assert len(want['stvd']) == 3, 'no input draw, then x_conv1..3'
    assert len(want['stages']) == len(out['stage_targets']) == 1
    assert out['keep_valid'].numpy().any()
    jst, tst = want['stages'][0], out['stage_targets'][0]
    np.testing.assert_allclose(by_position(out['rois'].detach().numpy()),
                               by_position(jst['rois']), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(by_position(tst['rois'].detach().numpy()),
                               by_position(jst['out'][..., :7]), atol=1e-4,
                               rtol=1e-4)
    assert float(want['tb']['rcnn_reg_fg_s0']) > 0, 'want foreground rois'


def test_train_step_loss_matches_jax(steps):
    want, got = steps
    np.testing.assert_allclose(float(got['loss']), float(want['loss']),
                               rtol=1e-4)
    assert set(got['tb']) == set(want['tb']) | {'nonfinite_skips'}
    assert got['tb']['nonfinite_skips'] == 0
    for k, v in want['tb'].items():
        np.testing.assert_allclose(float(got['tb'][k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_train_step_gradients_match_jax(steps):
    want, got = steps
    jgrads = from_jax_variables({'params': want['grads']})
    params = dict(got['model'].named_parameters())
    assert set(jgrads) == set(params)
    floor = 1e-4 * max(float(g.abs().max()) for g in jgrads.values())
    for name, g in jgrads.items():
        p = params[name]
        assert p.grad is not None, name
        scale = max(float(g.abs().max()), floor)
        err = float((p.grad - g).abs().max())
        assert err <= 1e-3 * scale, (name, err, scale)
