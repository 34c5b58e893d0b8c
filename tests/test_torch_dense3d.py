"""The dense 3D tail (``ops/dense3d.py``, ``DenseSubM3DBlock``,
``DenseDown3DBlock``, ``LidarStack(dense_tail=True)``) against the JAX
package's, on tests/test_dense3d.py's and tests/test_lidar_stack_oracle.py's
inputs with the same weights: grids, masks, coords and row order
bit-equal; features at atol 1e-5 / rtol 1e-5 for one block and 2e-4 /
2e-4 through the stack (test_lidar_stack_oracle.py's); BN running
statistics after a training forward at 1e-5."""
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.models import layers as jlayers
from virconv_tpu.models.backbones_3d.virconv import LidarStack as JStack
from virconv_tpu.ops import dense3d as jd3
from virconv_tpu_torch.models import layers as tlayers
from virconv_tpu_torch.models.backbones_3d.virconv import LidarStack
from virconv_tpu_torch.ops import dense3d as td3
from virconv_tpu_torch.ops import sparse as tsp
from virconv_tpu_torch.utils.jax_weights import (from_jax_variables,
                                                 load_state_dict_checked)

from test_dense3d import make_sparse
from test_lidar_stack_oracle import make_scene_sparse
from test_torch_routes import _block_state, _block_variables, _jnp
from test_torch_sparse import assert_same, to_torch_st

torch.set_num_threads(1)


def to_torch_grid(grid):
    return td3.DenseGrid(feats=torch.from_numpy(np.array(grid.feats)),
                         mask=torch.from_numpy(np.array(grid.mask)))


def assert_grid_close(want, got, atol=1e-5):
    assert_same(want.mask, got.mask)
    np.testing.assert_allclose(got.feats.detach().numpy(),
                               np.asarray(want.feats), atol=atol, rtol=atol)


@pytest.mark.parametrize('capacity', [200, 90])
def test_grid_round_trip_matches_jax(capacity):
    """Rows written to the grid and read back in scan order; 90 < the 150
    valid rows: the cap drops the later cells in scan order."""
    st = make_sparse(np.random.default_rng(0))
    want_g = jd3.grid_from_sparse(st)
    got_g = td3.grid_from_sparse(to_torch_st(st))
    assert_same(want_g.mask, got_g.mask)
    assert_same(want_g.feats, got_g.feats)
    noisy = want_g.replace(feats=want_g.feats + 1.0)
    assert_same(jd3.masked(noisy).feats, td3.masked(to_torch_grid(
        noisy)).feats)
    want = jd3.grid_to_sparse(want_g, capacity)
    got = td3.grid_to_sparse(got_g, capacity)
    for f in ('coords', 'mask', 'feats'):
        assert_same(getattr(want, f), getattr(got, f))
    assert got.spatial_shape == tuple(want.spatial_shape)


@pytest.mark.parametrize('ks,stride,pad', [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
    ((3, 1, 1), (2, 1, 1), (0, 0, 0))])
def test_down_mask_matches_jax(ks, stride, pad):
    st = make_sparse(np.random.default_rng(1), spatial=(7, 11, 13))
    grid = jd3.grid_from_sparse(st)
    assert_same(jd3.down_mask(grid.mask, ks, stride, pad),
                td3.down_mask(torch.from_numpy(np.array(grid.mask)), ks,
                              stride, pad))


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('name', ['subm', 'down', 'conv_out'])
def test_dense_blocks_match_jax(name, train):
    rng = np.random.default_rng(2)
    st = make_sparse(rng, spatial=(7, 11, 13))
    grid = jd3.grid_from_sparse(st)
    if name == 'subm':
        jblock = jlayers.DenseSubM3DBlock(16)
        tblock = tlayers.DenseSubM3DBlock(8, 16)
    else:
        ks, stride, pad = (((3, 3, 3), (2, 2, 2), (1, 1, 1)) if name == 'down'
                           else ((3, 1, 1), (2, 1, 1), (0, 0, 0)))
        jblock = jlayers.DenseDown3DBlock(16, ks, stride, pad)
        tblock = tlayers.DenseDown3DBlock(8, 16, ks, stride, pad)
    variables = _block_variables(rng, jblock, grid, True)
    want, mut = jblock.apply(_jnp(variables), grid, train,
                             mutable=['batch_stats'])
    load_state_dict_checked(tblock, _block_state(variables))
    tblock.train(train)
    got = tblock.dense(to_torch_grid(grid))
    assert_grid_close(want, got)
    assert bool(got.mask.any())
    bn = tblock.MaskedBatchNorm_0
    for k, buf in (('mean', bn.running_mean), ('var', bn.running_var)):
        np.testing.assert_allclose(
            buf.numpy(),
            np.asarray(mut["batch_stats"]["MaskedBatchNorm_0"][k]),
            atol=1e-5, rtol=1e-5)


def stack_runs(train):
    rng = np.random.default_rng(42)
    st = make_scene_sparse(rng)
    nf = (8, 8, 16, 16)
    jstack = JStack(num_filters=nf, out_features=16, dense_tail=True)
    variables = JStack(num_filters=nf, out_features=16).init(
        jax.random.PRNGKey(0), st, True)
    variables = {'params': variables['params'], 'batch_stats': jax.tree_util
                 .tree_map(lambda x: x + 0.1 * jnp.asarray(
                     rng.uniform(0, 1, x.shape), x.dtype),
                           variables['batch_stats'])}
    want, mut = jstack.apply(variables, st, train, mutable=['batch_stats'])
    tstack = LidarStack(4, nf, 16, dense_tail=True).train(train)
    load_state_dict_checked(tstack, from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))
    tsp.branch_counts.clear()
    with torch.set_grad_enabled(train):
        got = tstack(to_torch_st(st), bf16=False)
    return want, mut, got, tstack, dict(tsp.branch_counts)


@pytest.mark.parametrize('train', [False, True])
def test_lidar_stack_dense_tail_matches_jax(train):
    """x_conv3, x_conv4 and out row for row (scan order on both sides),
    every BN's running statistics after a training forward; conv3_down on
    the neighbor map, as the JAX tail runs it."""
    want, mut, got, tstack, branches = stack_runs(train)
    for key in ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4', 'out'):
        assert_same(want[key].coords, got[key].coords)
        assert_same(want[key].mask, got[key].mask)
        np.testing.assert_allclose(got[key].feats.detach().numpy(),
                                   np.asarray(want[key].feats), atol=2e-4,
                                   rtol=2e-4, err_msg=key)
    assert bool(got['out'].mask.any())
    if train:
        # conv2's and conv3's downs on the neighbor map ('nmap_train')
        assert branches == {'band_train': 4, 'nmap_train': 2}, branches
        stats = from_jax_variables({'params': {},
                                    'batch_stats': mut['batch_stats']})
        buffers = dict(tstack.named_buffers())
        for name, v in stats.items():
            np.testing.assert_allclose(buffers[name].numpy(), v.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=name)
    else:
        assert branches == {'band': 5, 'nmap': 1}, branches
