"""VirConv-L against the JAX package. At evaluation: the port's ``VirConvL8x``
and the whole tiny-L detector (``configs/tiny.tiny_l_config``: VirConv-L's
structure at the widths of tests/test_model_forward.py::tiny_cfg(mm=False))
against the JAX package's, with the same carried weights and f32 operands:
plain kernel versions on the port's side; on the JAX side the plain
references of its kernels (``VIRCONV_BAND=0 VIRCONV_DENSE2D=1
VIRCONV_POOL_KERNEL=0``: the neighbor-map convs, the first-wins dense
image-plane convs, the probe pools) under ``jit``. The inputs are 2 frames
of one fused stream each, no test-time replica (``transform_param`` None,
as the JAX loader collates a config without ``X_TRANS``), seen through an
orthographic camera whose projections of voxel centres all end 0.3 or 0.8
px past a pixel boundary, so no rounding order (XLA's fused multiply-adds,
the port's index-order sums) moves a voxel to another pixel.

Tolerances: backbone coords and masks bit-equal, each of x_conv1..4 and
``encoded_spconv_tensor`` within 1e-4 x the scale of the JAX features; BEV
features and proposals at 1e-4; final logits at atol 2e-3 / rtol 1e-3 and
boxes at atol 5e-3 / rtol 1e-3 (test_torch_detector.py's).

In train mode, on test_torch_train_step.py's duplicate-free sparse-grid
batch (its 2 entries, their ``points`` as the fused stream): ``VirConvL8x``
alone with the JAX StVD uniforms replayed (no input draw, then one per
block output but the last), outputs at 1e-4 x scale and the BN running
statistics after it at 1e-5. The whole training step is in
test_torch_virconv_l_step.py."""
import copy
import os

import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.config import CfgNode as JCfg
from virconv_tpu.models.backbones_3d import virconv as jvirconv
from virconv_tpu.models.detectors.voxel_rcnn import VoxelRCNN as JaxRCNN
from virconv_tpu.ops import sparse as jsp
from virconv_tpu_torch.configs.tiny import tiny_l_config
from virconv_tpu_torch.models.backbones_3d.virconv import VirConvL8x
from virconv_tpu_torch.models.detectors.voxel_rcnn import VoxelRCNN
from virconv_tpu_torch.ops import sparse as tsp
from virconv_tpu_torch.train.draws import Draws
from virconv_tpu_torch.utils.jax_weights import (from_jax_variables,
                                                 load_state_dict_checked)

from test_model_forward import make_batch
from test_torch_detector import random_variables
from test_torch_train_step import sparse_grid_batch

torch.set_num_threads(1)

SCALES = ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4')


def jax_cfgs(cfg):
    """The JAX package's (model_cfg, dataset_cfg) of a port config."""
    return (JCfg(copy.deepcopy(dict(cfg.MODEL))),
            JCfg(copy.deepcopy(dict(cfg.DATA_CONFIG))))


PLAIN_JAX = {'VIRCONV_BAND': '0', 'VIRCONV_DENSE2D': '1',
             'VIRCONV_POOL_KERNEL': '0'}


def ortho_camera(batch):
    """Give ``batch`` the orthographic camera u = 10 (x + 4 z) + 200.3,
    v = 10 y + 300.3: with the tiny range's 0.1 m voxels every voxel
    centre, at every stride, projects 0.3 or 0.8 px past a pixel
    boundary."""
    n = batch['points'].shape[0]
    v2r = np.array([[1, 0, 0], [0, 1, 0], [4, 0, 0], [0, 0, 1]], np.float32)
    p2t = np.array([[10, 0, 0], [0, 10, 0], [0, 0, 1], [200.3, 300.3, 0]],
                   np.float32)
    batch['v2r'] = np.tile(v2r, (n, 1, 1))
    batch['p2t'] = np.tile(p2t, (n, 1, 1))
    return batch


class jax_env:
    """Set environment variables for the JAX trace, restore them after."""

    def __init__(self, env):
        self.env = env

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def single_stream(batch):
    """A ``make_batch`` batch as VirConv-L takes it: one fused stream, no
    ``points_mm``, and (at evaluation) no test-time transform."""
    out = {k: None if v is None else np.array(v) for k, v in batch.items()
           if not k.startswith('points_mm')}
    if out.get('transform_param') is not None:
        out['transform_param'] = out['trans_params'] = None
    return out


def assert_sparse_close(got, want, name):
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords),
                                  err_msg=name)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask),
                                  err_msg=name)
    w = np.asarray(want.feats)
    scale = max(1.0, float(np.abs(w).max()))
    err = float(np.abs(got.feats.detach().numpy() - w).max())
    assert err <= 1e-4 * scale, (name, err, scale)


@pytest.fixture(scope='module')
def runs():
    cfg = tiny_l_config()
    model_cfg, data_cfg = jax_cfgs(cfg)
    jmodel = JaxRCNN(model_cfg=model_cfg, dataset_cfg=data_cfg)
    rng = np.random.default_rng(0)
    variables = random_variables(jmodel, single_stream(
        make_batch(rng, n_entries=1, train=True)))
    batch = ortho_camera(single_stream(make_batch(rng, n_entries=2,
                                                  train=False)))
    assert batch['transform_param'] is None and 'points_mm' not in batch
    with jax_env(PLAIN_JAX):
        want, state = jax.jit(lambda v, b: jmodel.apply(
            v, b, train=False, capture_intermediates=True,
            mutable=['intermediates']))(
            jax.tree_util.tree_map(jnp.asarray, variables),
            {k: None if v is None else jnp.asarray(v)
             for k, v in batch.items()})
    tmodel = VoxelRCNN(cfg.MODEL, cfg.DATA_CONFIG)
    assert isinstance(tmodel.backbone, VirConvL8x)
    load_state_dict_checked(tmodel, from_jax_variables(variables))
    got = tmodel({k: None if v is None else torch.from_numpy(v)
                  for k, v in batch.items()}, bf16=False)
    return want, state['intermediates'], got


def test_backbone_matches_jax(runs):
    _, inter, got = runs
    jbb = inter['backbone']['__call__'][0]
    tbb = got['backbone']
    assert set(jbb) == set(tbb)
    for k in SCALES:
        assert_sparse_close(tbb['multi_scale_3d_features'][k],
                            jbb['multi_scale_3d_features'][k], k)
    assert_sparse_close(tbb['encoded_spconv_tensor'],
                        jbb['encoded_spconv_tensor'], 'encoded_spconv_tensor')
    assert int(tbb['encoded_spconv_tensor'].mask.sum()) > 0


def test_bev_and_rpn_match(runs):
    _, inter, got = runs
    want_bev = np.asarray(inter['bev_backbone']['__call__'][0])
    np.testing.assert_allclose(got['bev_feats'].numpy(), want_bev,
                               atol=1e-4, rtol=1e-4)
    jrpn = inter['dense_head']['__call__'][0]
    assert np.asarray(jrpn['roi_valid']).any()
    np.testing.assert_array_equal(got['roi_scores'].numpy() > 0,
                                  np.asarray(jrpn['roi_valid']))
    np.testing.assert_allclose(got['rois'].numpy(), np.asarray(jrpn['rois']),
                               atol=1e-4, rtol=1e-4)


def test_final_predictions_match(runs):
    want, _, got = runs
    np.testing.assert_array_equal(got['roi_valid'].numpy(),
                                  np.asarray(want['roi_valid']))
    np.testing.assert_allclose(got['batch_cls_preds'].numpy(),
                               np.asarray(want['batch_cls_preds']),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got['batch_box_preds'].numpy(),
                               np.asarray(want['batch_box_preds']),
                               atol=5e-3, rtol=1e-3)


# ------------------------------------------------------------ training ----
def train_setup():
    """(port config with dropout off, JAX model, its variables, the
    sparse-grid batch as one fused stream): the tiny-L config with
    test_torch_train_step.py's NMS sizes and small box residuals, so the
    stage samples foreground."""
    cfg = tiny_l_config()
    cfg.MODEL.ROI_HEAD.DP_RATIO = 0.0
    nms = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN
    nms.NMS_PRE_MAXSIZE, nms.NMS_POST_MAXSIZE = 256, 128
    cfg.MODEL.ROI_HEAD.TARGET_CONFIG.STAGE0.ROI_PER_IMAGE = 16
    batch = single_stream(sparse_grid_batch())
    jmodel = JaxRCNN(*jax_cfgs(cfg))
    variables = random_variables(jmodel, batch)
    for box in (variables['params']['dense_head']['conv_box'],
                variables['params']['roi_head']['reg_head']['out']):
        box['kernel'] = box['kernel'] * np.float32(0.01)
        box['bias'] = box['bias'] * np.float32(0.01)
    return cfg, jmodel, variables, batch


@pytest.fixture(scope='module')
def train_backbones():
    """VirConvL8x in train mode on both sides, on the voxels of the
    sparse-grid batch, the JAX StVD uniforms replayed to the port."""
    cfg, _, variables, batch = train_setup()
    proc = cfg.DATA_CONFIG.DATA_PROCESSOR[2]
    pcr = tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    n = batch['points'].shape[0]
    st = tsp.voxelize(
        torch.from_numpy(batch['points'].reshape(-1, 8)),
        torch.from_numpy(batch['points_valid'].reshape(-1)), pcr,
        tuple(proc.VOXEL_SIZE), proc.MAX_NUMBER_OF_VOXELS['train'] * n,
        proc.MAX_POINTS_PER_VOXEL, batch_size=n,
        batch_idx=torch.arange(n, dtype=torch.int32).repeat_interleave(
            batch['points'].shape[1]), indicator_max=True)
    d, h, w = st.spatial_shape
    st = st.replace(spatial_shape=(d + 1, h, w))
    jst = jsp.SparseTensor(feats=jnp.asarray(st.feats.numpy()),
                           coords=jnp.asarray(st.coords.numpy()),
                           mask=jnp.asarray(st.mask.numpy()),
                           spatial_shape=st.spatial_shape, batch_size=n)
    b3 = cfg.MODEL.BACKBONE_3D
    args = dict(num_filters=tuple(b3.NUM_FILTERS),
                out_features=b3.OUT_FEATURES,
                layer_discard_rate=b3.LAYER_DISCARD_RATE,
                voxel_size=tuple(proc.VOXEL_SIZE), point_cloud_range=pcr)
    jbb = jvirconv.VirConvL8x(**args)
    jvars = {c: jax.tree_util.tree_map(jnp.asarray, variables[c]['backbone'])
             for c in ('params', 'batch_stats')}
    stvd = []
    orig = jvirconv.layer_voxel_discard

    def discard(t, rate, rng):
        u = jax.random.uniform(rng, (t.capacity,))
        jax.debug.callback(lambda x: stvd.append(np.asarray(x)), u,
                           ordered=True)
        return orig(t, rate, rng)
    cal = {k: jnp.asarray(batch[k]) for k in ('v2r', 'p2t', 'trans_params')}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvirconv, 'layer_voxel_discard', discard)
        want, mut = jax.jit(lambda v, t: jbb.apply(
            v, t, cal['v2r'], cal['p2t'], cal['trans_params'], True,
            rngs={'stvd': jax.random.PRNGKey(4)},
            mutable=['batch_stats']))(jvars, jst)
        jax.effects_barrier()
    tbb = VirConvL8x(8, **{k: v for k, v in args.items()
                           if k != 'num_filters'},
                     num_filters=args['num_filters'])
    load_state_dict_checked(tbb, from_jax_variables(jvars))
    draws = Draws(replay=stvd)
    got = tbb.train()(st, *(torch.from_numpy(batch[k]) for k in
                            ('v2r', 'p2t', 'trans_params')),
                      bf16=False, rng=draws)
    return want, mut, got, tbb, stvd, draws


def test_backbone_train_mode_matches_jax(train_backbones):
    want, _, got, _, stvd, draws = train_backbones
    assert len(stvd) == 3, 'no input draw, one per block output but the last'
    assert not draws.replay
    for k in SCALES:
        assert_sparse_close(got['multi_scale_3d_features'][k],
                            want['multi_scale_3d_features'][k], k)
    assert_sparse_close(got['encoded_spconv_tensor'],
                        want['encoded_spconv_tensor'],
                        'encoded_spconv_tensor')
    assert int(got['multi_scale_3d_features']['x_conv2'].mask.sum()) > 0


def test_backbone_train_bn_statistics_match_jax(train_backbones):
    _, mut, _, tbb, _, _ = train_backbones
    stats = from_jax_variables({'params': {},
                                'batch_stats': mut['batch_stats']})
    buffers = dict(tbb.named_buffers())
    assert stats
    for name, v in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), v.numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
