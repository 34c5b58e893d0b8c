"""One whole training step of the port (plain kernel versions on the CPU)
against the JAX package's ``jax.value_and_grad`` of ``model.apply(train=
True, mutable=['batch_stats'])`` at the width-shrunk tiny preset of
tests/test_model_forward.py (``make_batch(train=True)``, 2 entries) with
the same carried weights and the same random draws: the JAX StVD uniforms
and ROI-sampling keys are captured at run time (wrapping
``layer_voxel_discard`` and ``proposal_targets``) and replayed to the port;
dropout is off (DP_RATIO 0) in this test only.

In order: NMS keep sets and sampled ROIs identical; loss and every tb term
within rtol 1e-4; every parameter's gradient within 1e-3 x the max |JAX
grad| of that parameter (floored at 1e-4 x the step's largest gradient);
the BN running statistics after the step at 1e-5. The JAX step runs the
neighbor-map training convs (``VIRCONV_BAND_TRAIN=0``, its CPU route);
the port's default step runs its band training conv, and
``test_band_train_off_step_matches_jax`` holds its step under
``VIRCONV_BAND_TRAIN=0`` to the same JAX step at the same tolerances.
The points sit on a sparse grid seen through an orthographic camera, so no
two valid rows of any NRConv image-plane tensor share a pixel (asserted):
duplicate pixels resolve differently on the two sides
(tests/test_torch_train_sparse.py)."""
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.models.backbones_3d import virconv as jvirconv
from virconv_tpu.models.detectors.voxel_rcnn import VoxelRCNN as JaxRCNN
from virconv_tpu.models.roi_heads import ted_head as jted
from virconv_tpu.ops import boxes as jbox
from virconv_tpu_torch.config import CfgNode, virconv_t_config
from virconv_tpu_torch.ops import sparse as tsp
from virconv_tpu_torch.train.draws import Draws
from virconv_tpu_torch.train.trainer import Trainer
from virconv_tpu_torch.utils.jax_weights import from_jax_variables

from test_model_forward import make_batch, shrink_cfg, tiny_cfg
from test_torch_detector import random_variables

torch.set_num_threads(1)


def sparse_grid_batch():
    """make_batch(train=True) with 8 valid points per entry on a grid 9 m
    apart in x and 4 m in y, the identity world transform, and an
    orthographic camera u = 10 (x + 4 z) + 200.3, v = 10 y + 300.3: at
    every stride s the 2D pixel // s separates the neighboring sites of one
    point's downsampled cluster (x steps by one cell, z by four), the grid
    keeps the clusters apart, and the 0.3 px offset keeps every projection
    off a pixel boundary (float rounding cannot move a site)."""
    rng = np.random.default_rng(0)
    batch = {k: None if v is None else np.array(v) for k, v in
             make_batch(rng, n_entries=2, n_pts=64, train=True).items()}
    grid = np.array([(x, y, -2.45) for x in (3.05, 12.05)
                     for y in (-6.05, -2.05, 2.05, 6.05)], np.float32)
    for key in ('points', 'points_mm'):
        pts = batch[key]
        for e in range(2):
            pts[e, :8, :3] = grid + np.float32(0.3 * e)
    valid = np.zeros((2, 64), bool)
    valid[:, :8] = True
    batch['points_valid'] = batch['points_mm_valid'] = valid
    v2r = np.array([[1, 0, 0], [0, 1, 0], [4, 0, 0], [0, 0, 1]], np.float32)
    p2t = np.array([[10, 0, 0], [0, 10, 0], [0, 0, 1], [200.3, 300.3, 0]],
                   np.float32)
    batch['v2r'] = np.tile(v2r, (2, 1, 1))
    batch['p2t'] = np.tile(p2t, (2, 1, 1))
    batch['trans_params'] = np.tile(np.float32([[0.0, 0.0, 1.0]]), (2, 1))
    # gt cars on two grid points, where the anchors (and so the proposals)
    # sit: the ROI sampling finds foreground
    batch['gt_boxes'][:, 0] = [3.05, 2.05, -1.0, 3.9, 1.6, 1.56, 0.0, 1]
    batch['gt_boxes'][:, 1] = [12.05, -2.05, -1.0, 3.9, 1.6, 1.56, 0.0, 1]
    return batch


def install_recorders(monkeypatch):
    """Wraps the JAX StVD, ROI sampling and NMS so that every traced train
    forward records, through ordered debug callbacks, the StVD uniforms and
    each stage's ROI-sampling draws (split from the stage's key as
    target_assign.py splits it) with its input and sampled rois; and each
    sample's NMS selection (under ``vmap``, so unordered). Returns the
    lists (stvd, stages, nms) the records go to, in run order."""
    stvd, stages, nms = [], [], []
    orig_discard = jvirconv.layer_voxel_discard
    orig_targets = jted.proposal_targets
    orig_nms = jbox.nms_bev

    def discard(st, rate, rng):
        jax.debug.callback(lambda u: stvd.append(np.asarray(u)),
                           jax.random.uniform(rng, (st.capacity,)),
                           ordered=True)
        return orig_discard(st, rate, rng)

    def targets(rng, rois, roi_scores, roi_labels, gt_boxes, gt_valid, cfg):
        b, r = rois.shape[:2]
        n = int(cfg.ROI_PER_IMAGE)
        keys = jax.random.split(rng, b + 1)
        draws = []
        for i in range(b):
            k1, k2, k3, k4 = jax.random.split(keys[i], 4)
            draws += [jax.random.uniform(k, (r,)) for k in (k1, k2, k3)]
            draws.append(jax.random.randint(k4, (n,), 0, 2 ** 30))
        if cfg.get('ENABLE_HARD_SAMPLING', False):
            teval = int(1 / cfg.HARD_SAMPLING_RATIO[0])
            draws.append(jax.random.randint(keys[b], (), 0, teval))
        out = orig_targets(rng, rois, roi_scores, roi_labels, gt_boxes,
                           gt_valid, cfg)

        def record(rois_in, rois_out, *d):
            stages.append({'rois': np.asarray(rois_in),
                           'out': np.asarray(rois_out),
                           'draws': [np.asarray(x).astype(
                               np.int64 if x.dtype.kind == 'i'
                               else np.float32) for x in d]})
        jax.debug.callback(record, rois, out['rois'], *draws, ordered=True)
        return out

    def nms_bev(*a, **k):
        sel, valid = orig_nms(*a, **k)
        jax.debug.callback(lambda s, v: nms.append((np.asarray(s),
                                                    np.asarray(v))),
                           sel, valid)
        return sel, valid

    monkeypatch.setattr(jvirconv, 'layer_voxel_discard', discard)
    monkeypatch.setattr(jted, 'proposal_targets', targets)
    monkeypatch.setattr(jbox, 'nms_bev', nms_bev)
    return stvd, stages, nms


def run_jax(model, variables, batch, monkeypatch):
    """value_and_grad of the JAX train forward under ``jit`` (eagerly it
    takes ~150 s on a CPU, under ``jit`` ~60 s; this camera puts no
    projection near a pixel boundary, so fusion cannot move a voxel, which
    is why tests/test_torch_detector.py runs JAX eagerly), with the draws
    and NMS selections ``install_recorders`` records."""
    stvd, stages, nms = install_recorders(monkeypatch)
    jbatch = {k: None if v is None else jnp.asarray(v)
              for k, v in batch.items()}
    rngs = {'stvd': jax.random.PRNGKey(4), 'sampling': jax.random.PRNGKey(5),
            'dropout': jax.random.PRNGKey(6)}

    def loss_fn(params):
        out, mut = model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jbatch, train=True, rngs=rngs, mutable=['batch_stats'])
        return out['loss'], (out['tb'], mut['batch_stats'])
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    (loss, (tb, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    jax.effects_barrier()
    return {'loss': loss, 'tb': tb, 'stats': stats, 'grads': grads,
            'stvd': stvd, 'stages': stages, 'nms': nms}


@pytest.fixture(scope='module')
def jax_step():
    """The JAX step (on this CPU the neighbor-map training convs:
    ``VIRCONV_BAND_TRAIN=0``'s route, the JAX package's CPU default) and
    what the port's steps need."""
    model_cfg, data_cfg = tiny_cfg(mm=True)
    shrink_cfg(model_cfg, data_cfg)
    model_cfg.ROI_HEAD.DP_RATIO = 0.0
    # every anchor near the points survives NMS, those on the gt cars too
    nms = model_cfg.ROI_HEAD.NMS_CONFIG.TRAIN
    nms.NMS_PRE_MAXSIZE, nms.NMS_POST_MAXSIZE = 256, 128
    batch = sparse_grid_batch()
    jmodel = JaxRCNN(model_cfg=model_cfg, dataset_cfg=data_cfg)
    variables = random_variables(jmodel, batch)
    # small box residuals: proposals stay near the anchors and the stage-1
    # rois near the stage-0 ones, so both stages sample foreground and
    # every loss term is live
    for box in (variables['params']['dense_head']['conv_box'],
                variables['params']['roi_head']['reg_head']['out']):
        box['kernel'] = box['kernel'] * np.float32(0.01)
        box['bias'] = box['bias'] * np.float32(0.01)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VIRCONV_BAND_TRAIN', '0')
        want = run_jax(jmodel, variables, batch, mp)
    return model_cfg, data_cfg, batch, variables, want


def port_step(jax_step):
    """The port's step from the JAX step's weights with its draws replayed,
    under the environment's switches."""
    model_cfg, data_cfg, batch, variables, want = jax_step
    cfg = CfgNode({'CLASS_NAMES': ['Car'], 'MODEL': dict(model_cfg),
                   'DATA_CONFIG': dict(data_cfg),
                   'OPTIMIZATION': virconv_t_config().OPTIMIZATION})
    trainer = Trainer(cfg, state_dict=from_jax_variables(variables),
                      device='cpu')
    pixels = []
    orig_ctx = tsp.nmap_subm_conv_ctx

    def ctx(st, kernel_size):
        keys = st.keys()[st.mask]
        pixels.append((int(keys.numel()), int(torch.unique(keys).numel())))
        return orig_ctx(st, kernel_size)
    captured = {}
    forward = trainer.model.forward

    def capture(*a, **k):
        captured.update(forward(*a, **k))
        return captured
    replay = want['stvd'] + [d for s in want['stages'] for d in s['draws']]
    draws = Draws(replay=replay)
    trainer.model.forward = capture
    tsp.branch_counts.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsp, 'nmap_subm_conv_ctx', ctx)
        loss, tb = trainer.step(batch, draws)
    assert not draws.replay, 'every JAX draw is used'
    return want, {'loss': loss, 'tb': tb, 'out': captured,
                  'model': trainer.model, 'pixels': pixels,
                  'branches': dict(tsp.branch_counts)}


@pytest.fixture(scope='module')
def steps(jax_step):
    return port_step(jax_step)


@pytest.fixture(scope='module')
def steps_band_train_off(jax_step):
    """The port's step under ``VIRCONV_BAND_TRAIN=0``: its 3D submanifold
    convs on the neighbor map too, as the JAX step's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VIRCONV_BAND_TRAIN', '0')
        return port_step(jax_step)


def test_image_plane_has_no_duplicate_pixels(steps):
    _, got = steps
    assert len(got['pixels']) == 4
    for n, unique in got['pixels']:
        assert n > 0 and unique == n, got['pixels']


def test_nms_keep_sets_and_sampled_rois_identical(steps):
    want, got = steps
    out = got['out']
    post = out['keep'].shape[1]
    jax_sets = sorted((tuple(np.asarray(s).reshape(-1, post)[i][v[i]]),
                       tuple(v[i]))
                      for s, v in ((s, np.asarray(v).reshape(-1, post))
                                   for s, v in want['nms'])
                      for i in range(v.shape[0]))
    keep, valid = out['keep'].numpy(), out['keep_valid'].numpy()
    port_sets = sorted((tuple(keep[i][valid[i]]), tuple(valid[i]))
                       for i in range(keep.shape[0]))
    assert valid.any()
    assert port_sets == jax_sets
    # which entry is which: the stage-0 input rois are the NMS selections
    np.testing.assert_allclose(out['rois'].detach().numpy(),
                               want['stages'][0]['rois'], atol=1e-4,
                               rtol=1e-4)
    assert len(want['stages']) == len(out['stage_targets']) == 2
    for jst, tst in zip(want['stages'], out['stage_targets']):
        idx = tst['targets']['sampled'].numpy()
        rows = np.take_along_axis(jst['rois'], idx[..., None], 1)
        # the port's sampled indices pick JAX's sampled rois from JAX's
        # stage input, and the port's own rois agree with them
        np.testing.assert_array_equal(rows, jst['out'])
        np.testing.assert_allclose(tst['rois'].detach().numpy(),
                                   jst['out'][..., :7], atol=1e-4,
                                   rtol=1e-4)
    fg = sum(float(t) for k, t in want['tb'].items()
             if k.startswith('rcnn_reg_fg'))
    assert fg > 0, 'want foreground rois'


def test_loss_and_tb_terms_match(steps):
    want, got = steps
    np.testing.assert_allclose(float(got['loss']), float(want['loss']),
                               rtol=1e-4)
    assert set(got['tb']) == set(want['tb']) | {'nonfinite_skips'}
    assert got['tb']['nonfinite_skips'] == 0
    for k, v in want['tb'].items():
        np.testing.assert_allclose(float(got['tb'][k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_every_gradient_matches(steps):
    want, got = steps
    jgrads = from_jax_variables({'params': want['grads']})
    params = dict(got['model'].named_parameters())
    assert set(jgrads) == set(params)
    # gradients that are zero in exact arithmetic (a bias that BN or the
    # softmax removes: the cross-attention key, value and out biases) are
    # f32 round-off on both sides, so each parameter's scale has a floor of
    # 1e-4 x the largest gradient of the step
    floor = 1e-4 * max(float(g.abs().max()) for g in jgrads.values())
    for name, g in jgrads.items():
        p = params[name]
        assert p.grad is not None, name
        scale = max(float(g.abs().max()), floor)
        err = float((p.grad - g).abs().max())
        assert err <= 1e-3 * scale, (name, err, scale)


def test_bn_running_stats_after_step(steps):
    want, got = steps
    stats = from_jax_variables({'params': {}, 'batch_stats': want['stats']})
    buffers = dict(got['model'].named_buffers())
    assert stats
    for name, v in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), v.numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_band_train_off_step_matches_jax(steps_band_train_off):
    """Loss, tb terms, every gradient and the BN statistics at the default
    step's tolerances, with no conv on the band training path: 4 image-plane
    and 8 3D submanifold contexts on the neighbor map."""
    _, got = steps_band_train_off
    assert not any(k.startswith('band') for k in got['branches']), \
        got['branches']
    assert len(got['pixels']) == 4 + 8
    test_loss_and_tb_terms_match(steps_band_train_off)
    test_every_gradient_matches(steps_band_train_off)
    test_bn_running_stats_after_step(steps_band_train_off)
