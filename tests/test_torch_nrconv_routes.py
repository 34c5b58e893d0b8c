"""The NRConv image-plane 2D routes at evaluation: ``VIRCONV_BAND2D=0``
(the 3D convs on the band kernel, the 2D convs on the neighbor map of the
unsorted tensor) and ``VIRCONV_DENSE2D=1`` (two dense 3x3 convs over the
image grid), the port's ``NRConvBlock`` against the JAX package's under the
same environment, with the same weights, f32 conv operands.

``BAND2D=0`` runs on voxels whose pixels are all distinct (an orthographic
camera, u = 10 (x + 4 z) + 200.3, v = 10 y + 300.3, that keeps every
projection 0.3 or 0.8 px off a pixel boundary, and one voxel kept per
pixel): duplicate pixels resolve to the first row in the port and to the
last in the JAX CPU backend's lookup table (ROADMAP known differences).
``DENSE2D=1`` is first-wins on both sides, so its input keeps duplicates
(tests/test_dense2d.py's), and the port's dense route is also held against
its own band 2D route. Tolerances: coords and masks bit-equal, features
atol 1e-5 / rtol 1e-5 against JAX on one route, and tests/test_dense2d.py's
atol 2e-4 / rtol 1e-3 between two routes."""
import functools

import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.models.backbones_3d.virconv import NRConvBlock as JBlock
from virconv_tpu.ops import sparse as jsp
from virconv_tpu_torch.models.backbones_3d.virconv import NRConvBlock
from virconv_tpu_torch.models.layers import Dense2DSubMBlock
from virconv_tpu_torch.ops import sparse as tsp
from virconv_tpu_torch.utils.jax_weights import (from_jax_variables,
                                                 load_state_dict_checked)

from test_dense2d import PCR, VOX
from test_dense2d import _make_st as dup_pixel_st
from test_torch_sparse import assert_same, to_torch_st

torch.set_num_threads(1)

ORTHO_V2R = np.array([[1, 0, 0], [0, 1, 0], [4, 0, 0], [0, 0, 1]],
                     np.float32)
ORTHO_P2T = np.array([[10, 0, 0], [0, 10, 0], [0, 0, 1], [200.3, 300.3, 0]],
                     np.float32)


def distinct_pixel_st(rng, n_entries=2, n=700, capacity=768, channels=8):
    """Random voxels of PCR at VOX, one per pixel of the orthographic
    camera at stride 1, sorted by key."""
    spatial = (40, 160, 160)
    cells = np.stack([rng.integers(0, n_entries, 4 * n)]
                     + [rng.integers(0, s, 4 * n) for s in spatial], -1)
    x = PCR[0] + (cells[:, 3] + 0.5) * VOX[0]
    y = PCR[1] + (cells[:, 2] + 0.5) * VOX[1]
    z = PCR[2] + (cells[:, 1] + 0.5) * VOX[2]
    pix = np.stack([cells[:, 0], np.floor(10 * (x + 4 * z) + 200.3),
                    np.floor(10 * y + 300.3)], -1)
    _, first = np.unique(pix, axis=0, return_index=True)
    _, first_cell = np.unique(cells[np.sort(first)], axis=0,
                              return_index=True)
    coords = cells[np.sort(first)][np.sort(first_cell)][:n].astype(np.int32)
    k = len(coords)
    feats = np.zeros((capacity, channels), np.float32)
    feats[:k] = rng.standard_normal((k, channels))
    cpad = np.full((capacity, 4), -1, np.int32)
    cpad[:k] = coords
    st = jsp.SparseTensor(feats=jnp.asarray(feats), coords=jnp.asarray(cpad),
                          mask=jnp.asarray(np.arange(capacity) < k),
                          spatial_shape=spatial, batch_size=n_entries)
    return jsp.sort_by_key(st)


def run_both(st, v2r, p2t, params, stride, env, monkeypatch, out_cap=None):
    """(JAX output, the port's output, the port's conv branches) of one
    NRConvBlock (16 channels) at eval under ``env``, one weight tree."""
    block = JBlock(16, stride=stride, out_capacity=out_cap, voxel_size=VOX,
                   point_cloud_range=PCR)
    variables = block.init(jax.random.PRNGKey(stride), st, v2r, p2t, params,
                           stride, False)
    rng = np.random.default_rng(stride)
    variables = {'params': variables['params'],
                 'batch_stats': jax.tree_util.tree_map(
                     lambda x: x + 0.1 * jnp.asarray(rng.uniform(
                         0, 1, x.shape), x.dtype), variables['batch_stats'])}
    monkeypatch.setattr(jsp, 'subm_conv_ctx',
                        functools.partial(jsp.subm_conv_ctx, bf16=False))
    monkeypatch.setattr(jsp, 'strided_conv_ctx',
                        functools.partial(jsp.strided_conv_ctx, bf16=False))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = block.apply(variables, st, v2r, p2t, params, stride, False)
    tblock = NRConvBlock(8, 16, stride=stride, voxel_size=VOX,
                         point_cloud_range=PCR).eval()
    load_state_dict_checked(tblock, from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))
    tsp.branch_counts.clear()
    with torch.no_grad():
        got = tblock(to_torch_st(st), t(v2r), t(p2t), t(params), stride,
                     out_cap, bf16=False)
    return want, got, dict(tsp.branch_counts), (tblock, t(v2r), t(p2t),
                                                t(params))


def assert_rows_close(want, got, atol, rtol):
    assert_same(want.coords, got.coords)
    assert_same(want.mask, got.mask)
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats),
                               atol=atol, rtol=rtol)


def test_band2d_off_matches_jax(monkeypatch):
    st = distinct_pixel_st(np.random.default_rng(0))
    n = int(st.mask.sum())
    v2r = jnp.asarray(np.tile(ORTHO_V2R, (2, 1, 1)))
    p2t = jnp.asarray(np.tile(ORTHO_P2T, (2, 1, 1)))
    params = jnp.asarray([[0.0, 0.0, 1.0]] * 2, jnp.float32)
    want, got, branches, _ = run_both(
        st, v2r, p2t, params, 1,
        {'VIRCONV_BAND': '1', 'VIRCONV_BAND2D': '0',
         'VIRCONV_DENSE2D': '0'}, monkeypatch)
    assert n > 600
    # the 3D convs on K1 (one context, two convs), the 2D ones on the map
    assert branches == {'band': 2, 'nmap': 2}, branches
    assert_rows_close(want, got, 1e-5, 1e-5)


@pytest.mark.parametrize('stride', [1, 2])
def test_dense2d_matches_jax_and_band2d(stride, monkeypatch):
    st = dup_pixel_st(np.random.default_rng(3 + stride),
                      n_entries=2 if stride == 1 else 1,
                      n_pts=4000 if stride == 1 else 2500)
    from virconv_tpu.utils.calibration import identity_calib
    v2r, p2t = identity_calib(fu=200.0, fv=200.0, cu=700.0,
                              cv=300.0).device_matrices()
    b = st.batch_size
    v2r = jnp.asarray(np.tile(np.asarray(v2r), (b, 1, 1)))
    p2t = jnp.asarray(np.tile(np.asarray(p2t), (b, 1, 1)))
    params = (jnp.asarray([[0.2, 0.0, 0.99], [0.1, 1.0, 1.02]], jnp.float32)
              if stride == 1 else None)
    out_cap = None if stride == 1 else 2048
    env = {'VIRCONV_BAND': '0', 'VIRCONV_DENSE2D': '1'}
    occupied = []
    dense = Dense2DSubMBlock.dense

    def spy(self, grid, occ):
        occupied.append(int(occ.sum()))
        return dense(self, grid, occ)
    monkeypatch.setattr(Dense2DSubMBlock, 'dense', spy)
    want, got, branches, (tblock, *args) = run_both(
        st, v2r, p2t, params, stride, env, monkeypatch, out_cap)
    assert branches == {'nmap': 3 if stride > 1 else 2}, branches
    assert_rows_close(want, got, 1e-5, 1e-5)
    # duplicates present: fewer occupied pixels than rows
    assert len(occupied) == 2 and occupied[0] < int(got.mask.sum()) - 50
    monkeypatch.setenv('VIRCONV_BAND', '1')
    monkeypatch.setenv('VIRCONV_DENSE2D', '0')
    with torch.no_grad():
        band2d = tblock(to_torch_st(st), *args, stride, out_cap,
                        bf16=False)
    assert_same(got.mask, band2d.mask)
    np.testing.assert_allclose(got.feats.numpy(), band2d.feats.numpy(),
                               atol=2e-4, rtol=1e-3)
