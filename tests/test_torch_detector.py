"""Whole-detector parity: the port's VoxelRCNN (plain kernel versions on the
CPU) vs the JAX VoxelRCNN on its band-kernel eval path (interpret mode),
both with f32 conv operands, at the width-shrunk preset of
tests/test_model_forward.py, 2 batch entries (1 frame x 2 replicas),
with the same (carried) weights. Stage by stage: backbone coords bit-equal
and features at 1e-4, BEV features at 1e-4, RPN proposals and NMS keep sets exactly,
final logits at atol 2e-3 / rtol 1e-3 and boxes at atol 5e-3 / rtol 1e-3
(the tolerances of tests/test_band_integration.py)."""
import functools

import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.models.detectors.voxel_rcnn import VoxelRCNN as JaxRCNN
from virconv_tpu.ops import boxes as jbox
from virconv_tpu.ops import sparse as jsp
from virconv_tpu_torch.config import CfgNode
from virconv_tpu_torch.models.detectors.voxel_rcnn import VoxelRCNN
from virconv_tpu_torch.ops import boxes as tbox
from virconv_tpu_torch.utils.jax_weights import (from_jax_variables,
                                                 load_state_dict_checked)

from test_model_forward import make_batch, shrink_cfg, tiny_cfg

torch.set_num_threads(1)


def random_variables(model, batch, seed=0):
    """Flax eval variables with every leaf drawn from numpy (shapes from
    ``eval_shape``, no compile): fan-in-scaled kernels and non-trivial BN
    statistics."""
    shapes = jax.eval_shape(
        functools.partial(model.init, train=True),
        {k: jax.random.PRNGKey(i) for i, k in
         enumerate(('params', 'stvd', 'sampling', 'dropout'))}, batch)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            return rng.standard_normal(shape) / np.sqrt(fan_in)
        if name in ('scale', 'var'):
            return rng.uniform(0.7, 1.3, shape)
        return rng.standard_normal(shape) * 0.1         # bias, mean
    out = {}
    for col in ('params', 'batch_stats'):
        out[col] = jax.tree_util.tree_map_with_path(
            lambda p, l: np.asarray(draw(p, l), np.float32), shapes[col])
    return out


def detector_runs():
    """(JAX output, JAX intermediates, port output) of one eval forward of
    the tiny preset, both sides under the environment's ``VIRCONV_*``
    switches."""
    import os
    model_cfg, data_cfg = tiny_cfg(mm=True)
    n_pts = shrink_cfg(model_cfg, data_cfg)
    jmodel = JaxRCNN(model_cfg=model_cfg, dataset_cfg=data_cfg)
    rng = np.random.default_rng(0)
    train_batch = make_batch(rng, n_entries=1, n_pts=n_pts, train=True)
    variables = random_variables(jmodel, train_batch)
    batch = make_batch(rng, n_entries=2, n_pts=n_pts, train=False, n_rep=2)

    # JAX eval path through both Pallas kernels (band conv, ROI pool) in
    # interpret mode with f32 operands, eagerly as
    # tests/test_band_integration.py runs it. Not under jit: XLA's fusion
    # rounds the NRConv image projection differently, which moves voxels
    # that lie on a pixel boundary to the next pixel; eager JAX, like the
    # port, sums the projection in index order.
    env = {'VIRCONV_BAND': '1', 'VIRCONV_DENSE2D': '0',
           'VIRCONV_POOL_KERNEL': '1'}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    orig = jsp.subm_conv_ctx, jsp.strided_conv_ctx
    jsp.subm_conv_ctx = functools.partial(orig[0], bf16=False)
    jsp.strided_conv_ctx = functools.partial(orig[1], bf16=False)
    try:
        want, state = jmodel.apply(
            jax.tree_util.tree_map(jnp.asarray, variables), batch,
            train=False, capture_intermediates=True,
            mutable=['intermediates'])
        tmodel = VoxelRCNN(CfgNode(model_cfg), CfgNode(data_cfg))
        load_state_dict_checked(tmodel, from_jax_variables(variables))
        tbatch = {k: None if v is None else torch.from_numpy(np.array(v))
                  for k, v in batch.items()}
        got = tmodel(tbatch, bf16=False)
    finally:
        jsp.subm_conv_ctx, jsp.strided_conv_ctx = orig
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return want, state['intermediates'], got


@pytest.fixture(scope='module')
def runs():
    return detector_runs()


def _np(x):
    return np.asarray(x)


def test_backbone_features_match(runs):
    _, inter, got = runs
    jbb = inter['backbone']['__call__'][0]
    tbb = got['backbone']
    pairs = [(jbb['multi_scale_3d_features'], tbb['multi_scale_3d_features']),
             (jbb['multi_scale_3d_features_mm'],
              tbb['multi_scale_3d_features_mm'])]
    for jd, td in pairs:
        for k in ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4'):
            np.testing.assert_array_equal(td[k].coords.numpy(),
                                          _np(jd[k].coords))
            np.testing.assert_array_equal(td[k].mask.numpy(),
                                          _np(jd[k].mask))
            np.testing.assert_allclose(td[k].feats.numpy(), _np(jd[k].feats),
                                       atol=1e-4, rtol=1e-4, err_msg=k)
    jenc, tenc = jbb['encoded_spconv_tensor'], tbb['encoded_spconv_tensor']
    np.testing.assert_array_equal(tenc.coords.numpy(), _np(jenc.coords))
    np.testing.assert_allclose(tenc.feats.numpy(), _np(jenc.feats),
                               atol=1e-4, rtol=1e-4)


def test_bev_and_rpn_match(runs):
    _, inter, got = runs
    np.testing.assert_allclose(got['bev_feats'].numpy(),
                               _np(inter['bev_backbone']['__call__'][0]),
                               atol=1e-4, rtol=1e-4)
    jrpn = inter['dense_head']['__call__'][0]
    np.testing.assert_array_equal(got['roi_scores'].numpy() > 0,
                                  _np(jrpn['roi_valid']))
    assert _np(jrpn['roi_valid']).any()
    np.testing.assert_allclose(got['rois'].numpy(), _np(jrpn['rois']),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got['roi_scores'].numpy(),
                               _np(jrpn['roi_scores']), atol=1e-5)
    # keep sets: the port's NMS on the JAX head's own boxes and scores
    boxes = _np(jrpn['batch_box_preds'])
    scores = _np(jax.nn.sigmoid(jrpn['batch_cls_preds'].max(-1)))
    amask = _np(jrpn['anchor_mask'])
    for b in range(boxes.shape[0]):
        jsel, jval = jbox.nms_bev(jnp.asarray(boxes[b]),
                                  jnp.asarray(scores[b]), 0.75, 64, 16,
                                  valid=jnp.asarray(amask))
        tsel, tval = tbox.nms_bev(torch.tensor(boxes[b]),
                                  torch.tensor(scores[b]), 0.75, 64, 16,
                                  valid=torch.tensor(amask))
        np.testing.assert_array_equal(tval.numpy(), _np(jval))
        np.testing.assert_array_equal(tsel.numpy(), _np(jsel))


def test_final_predictions_match(runs):
    want, _, got = runs
    np.testing.assert_array_equal(got['roi_valid'].numpy(),
                                  _np(want['roi_valid']))
    np.testing.assert_allclose(got['batch_cls_preds'].numpy(),
                               _np(want['batch_cls_preds']),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got['batch_box_preds'].numpy(),
                               _np(want['batch_box_preds']),
                               atol=5e-3, rtol=1e-3)
