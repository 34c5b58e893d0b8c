"""The tiny VirConv-T eval forward on the JAX package's plain routes,
``VIRCONV_BAND=0 VIRCONV_DENSE2D=1 VIRCONV_POOL_KERNEL=0`` on both sides:
every sparse conv on the neighbor map, the NRConv 2D convs dense, every
pool on the probe path (tests/test_torch_detector.py's preset, weights,
batch and tolerances, the batch seen through tests/test_torch_virconv_l.py's
orthographic camera, which keeps every projection off a pixel boundary,
so JAX runs under ``jit``). The port's branch counts show no band conv and
no pooling kernel.

Then the weights: one JAX variable tree loads strictly into the port's
model, and into ``LidarStack(dense_tail=True)``, and the port's forward on
every route gives the default route's ROI valid set, boxes within 5e-3 and
logits within 2e-3 (chip_smoke phase 4's tolerances)."""
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.models.detectors.voxel_rcnn import VoxelRCNN as JaxRCNN
from virconv_tpu_torch.config import CfgNode
from virconv_tpu_torch.models.backbones_3d.virconv import LidarStack
from virconv_tpu_torch.models.detectors.voxel_rcnn import VoxelRCNN
from virconv_tpu_torch.models.roi_heads import voxel_pool as tvp
from virconv_tpu_torch.ops import sparse as tsp
from virconv_tpu_torch.utils.jax_weights import (from_jax_variables,
                                                 load_state_dict_checked)

import test_torch_detector as td
from test_model_forward import make_batch, shrink_cfg, tiny_cfg
from test_torch_virconv_l import ortho_camera

torch.set_num_threads(1)

PLAIN_ENV = {'VIRCONV_BAND': '0', 'VIRCONV_DENSE2D': '1',
             'VIRCONV_POOL_KERNEL': '0'}


def tiny_model():
    """(model_cfg, data_cfg, JAX model, variables, eval batch as numpy)."""
    model_cfg, data_cfg = tiny_cfg(mm=True)
    n_pts = shrink_cfg(model_cfg, data_cfg)
    jmodel = JaxRCNN(model_cfg=model_cfg, dataset_cfg=data_cfg)
    rng = np.random.default_rng(0)
    variables = td.random_variables(jmodel, make_batch(
        rng, n_entries=1, n_pts=n_pts, train=True))
    batch = ortho_camera({k: None if v is None else np.array(v) for k, v in
                          make_batch(rng, n_entries=2, n_pts=n_pts,
                                     train=False, n_rep=2).items()})
    return model_cfg, data_cfg, jmodel, variables, batch


@pytest.fixture(scope='module')
def runs():
    model_cfg, data_cfg, jmodel, variables, batch = tiny_model()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in PLAIN_ENV.items():
            mp.setenv(k, v)
        want, state = jax.jit(lambda v, b: jmodel.apply(
            v, b, train=False, capture_intermediates=True,
            mutable=['intermediates']))(
                jax.tree_util.tree_map(jnp.asarray, variables),
                {k: None if v is None else jnp.asarray(v)
                 for k, v in batch.items()})
        tmodel = VoxelRCNN(CfgNode(model_cfg), CfgNode(data_cfg))
        load_state_dict_checked(tmodel, from_jax_variables(variables))
        tsp.branch_counts.clear()
        tvp.branch_counts.clear()
        got = tmodel({k: None if v is None else torch.from_numpy(v)
                      for k, v in batch.items()}, bf16=False)
    return ((want, state['intermediates'], got), dict(tsp.branch_counts),
            dict(tvp.branch_counts))


def test_plain_routes_launch_no_band_and_no_pool_kernel(runs):
    _, convs, pools = runs
    assert set(convs) == {'nmap'} and convs['nmap'] > 0, convs
    assert pools['probe'] > 0 and 'kernel' not in pools, pools
    assert all(k.startswith('probe') for k in pools), pools


def test_backbone_features_match(runs):
    td.test_backbone_features_match(runs[0])


def test_bev_and_rpn_match(runs):
    td.test_bev_and_rpn_match(runs[0])


def test_final_predictions_match(runs):
    td.test_final_predictions_match(runs[0])


ROUTES = {
    'band_off': {'VIRCONV_BAND': '0'},
    'band_train_off': {'VIRCONV_BAND_TRAIN': '0'},
    'band2d_off': {'VIRCONV_BAND2D': '0'},
    'dense2d': {'VIRCONV_DENSE2D': '1'},
    'pool_kernel_off': {'VIRCONV_POOL_KERNEL': '0'},
    'pool_tile': {'VIRCONV_POOL_TILE': '1'},
}


def test_one_tree_loads_and_runs_on_every_route(monkeypatch):
    model_cfg, data_cfg, _, variables, batch = tiny_model()
    sd = from_jax_variables(variables)
    model = VoxelRCNN(CfgNode(model_cfg), CfgNode(data_cfg))
    load_state_dict_checked(model, sd)
    nf = tuple(model_cfg.BACKBONE_3D.NUM_FILTERS)
    lidar = {k[len('backbone.lidar.'):]: v for k, v in sd.items()
             if k.startswith('backbone.lidar.')}
    for dense_tail in (False, True):
        load_state_dict_checked(
            LidarStack(8, nf, model_cfg.BACKBONE_3D.OUT_FEATURES,
                       dense_tail=dense_tail), lidar)
    batch = {k: None if v is None else torch.from_numpy(v)
             for k, v in batch.items()}
    for k in ('VIRCONV_BAND', 'VIRCONV_BAND_TRAIN', 'VIRCONV_BAND2D',
              'VIRCONV_DENSE2D', 'VIRCONV_POOL_KERNEL', 'VIRCONV_POOL_TILE'):
        monkeypatch.delenv(k, raising=False)
    ref = model(batch, bf16=False)
    assert ref['roi_valid'].any()
    for name, env in ROUTES.items():
        with monkeypatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            tvp.branch_counts.clear()
            out = model(batch, bf16=False)
        if name == 'pool_tile':
            assert any(' tiled ' in k for k in tvp.branch_counts), name
        assert torch.equal(out['roi_valid'], ref['roi_valid']), name
        for key, tol in (('batch_box_preds', 5e-3), ('batch_cls_preds',
                                                     2e-3)):
            err = float((out[key] - ref[key]).abs().max())
            assert err <= tol, (name, key, err)
