"""Port sparse substrate (virconv_tpu_torch.ops.sparse) vs the JAX package:
voxelization, key sorts, neighbor maps, downsampling, band plans and gather
patches must be bit-equal; features f32-close."""

import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.ops import sparse as jsp
from virconv_tpu_torch.ops import sparse as tsp

from test_sparse import make_random_sparse

torch.set_num_threads(1)


def to_torch_st(st):
    """JAX SparseTensor -> port SparseTensor (same arrays)."""
    return tsp.SparseTensor(
        feats=torch.from_numpy(np.array(st.feats)),
        coords=torch.from_numpy(np.array(st.coords)),
        mask=torch.from_numpy(np.array(st.mask)),
        spatial_shape=tuple(st.spatial_shape), batch_size=st.batch_size)


def assert_same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy() if
                                  isinstance(b, torch.Tensor) else b)


def random_points(rng, n, pcr):
    """Points in (and slightly out of) range; a third of them share a
    voxel with another point."""
    lo = np.asarray(pcr[:3]) - 0.3
    hi = np.asarray(pcr[3:]) + 0.3
    xyz = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    src = rng.integers(0, n, n // 3)
    xyz[rng.integers(0, n, n // 3)] = xyz[src] + 0.01
    feats = rng.uniform(0, 1, (n, 5)).astype(np.float32)
    return np.concatenate([xyz, feats], 1)


@pytest.mark.parametrize('indicator_max,max_voxels', [(True, 400),
                                                      (False, 64)])
def test_voxelize_matches_jax(indicator_max, max_voxels):
    rng = np.random.default_rng(0)
    pcr = (0.0, -2.0, -1.0, 3.2, 2.0, 1.0)
    vs = (0.2, 0.2, 0.25)
    pts = random_points(rng, 900, pcr)
    mask = rng.uniform(size=900) > 0.1
    bidx = np.repeat(np.arange(2, dtype=np.int32), 450)
    want = jsp.voxelize(jnp.asarray(pts), jnp.asarray(mask), pcr, vs,
                        max_voxels, 3, batch_size=2,
                        batch_idx=jnp.asarray(bidx),
                        indicator_max=indicator_max)
    got = tsp.voxelize(torch.from_numpy(pts), torch.from_numpy(mask), pcr,
                       vs, max_voxels, 3, batch_size=2,
                       batch_idx=torch.from_numpy(bidx),
                       indicator_max=indicator_max)
    assert got.spatial_shape == tuple(want.spatial_shape)
    assert_same(want.coords, got.coords)
    assert_same(want.mask, got.mask)
    assert_same(want.keys(), got.keys())
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats),
                               rtol=1e-6, atol=1e-6)


def test_sort_by_key_with_perm_duplicates_matches_jax():
    """2D image-plane keys with duplicates: stable sorts give one perm."""
    rng = np.random.default_rng(1)
    n = 200
    coords = np.stack([rng.integers(0, 2, n), rng.integers(0, 9, n),
                       rng.integers(0, 7, n)], -1).astype(np.int32)
    mask = rng.uniform(size=n) > 0.2
    coords[~mask] = -1
    feats = rng.standard_normal((n, 3)).astype(np.float32)
    jst = jsp.SparseTensor(jnp.asarray(feats), jnp.asarray(coords),
                           jnp.asarray(mask), (9, 7), 2)
    js, jperm = jsp.sort_by_key_with_perm(jst)
    ts, tperm = tsp.sort_by_key_with_perm(to_torch_st(jst))
    assert_same(jperm, tperm)
    assert_same(js.coords, ts.coords)


@pytest.mark.parametrize('spatial', [(6, 10, 9), (11, 7)])
def test_subm_neighbor_map_matches_jax(spatial):
    rng = np.random.default_rng(2)
    if len(spatial) == 3:
        st = make_random_sparse(rng, 2, spatial, 150, 192, 4)
    else:
        coords = set()
        while len(coords) < 50:
            coords.add((int(rng.integers(2)), int(rng.integers(11)),
                        int(rng.integers(7))))
        c = np.concatenate([np.array(sorted(coords), np.int32),
                            -np.ones((14, 3), np.int32)])
        m = np.arange(64) < 50
        st = jsp.sort_by_key(jsp.SparseTensor(
            jnp.zeros((64, 2)), jnp.asarray(c), jnp.asarray(m), spatial, 2))
    want = jsp.build_subm_neighbor_map(st, 3)
    got = tsp.build_subm_neighbor_map(to_torch_st(st), 3)
    assert_same(want, got)


@pytest.mark.parametrize('stride,padding,ksize', [
    ((2, 2, 2), (1, 1, 1), (3, 3, 3)),
    ((2, 2, 2), (0, 1, 1), (3, 3, 3)),
    ((2, 1, 1), (0, 0, 0), (3, 1, 1))])
def test_downsample_and_strided_maps_match_jax(stride, padding, ksize):
    rng = np.random.default_rng(3)
    st = make_random_sparse(rng, 2, (9, 14, 12), 300, 384, 4)
    want = jsp.downsample_coords(st, stride, padding, ksize, 320)
    got = tsp.downsample_coords(to_torch_st(st), stride, padding, ksize, 320)
    assert got.spatial_shape == tuple(want.spatial_shape)
    assert_same(want.coords, got.coords)
    assert_same(want.mask, got.mask)
    assert_same(jsp.build_strided_neighbor_map(st, want, stride, padding,
                                               ksize),
                tsp.build_strided_neighbor_map(to_torch_st(st), got, stride,
                                               padding, ksize))


def _assert_plan_equal(jplan, tplan):
    for f in ('base_keys', 'valid_bits', 'blk', 'span_ok', 'fits',
              'keys_sorted'):
        assert_same(getattr(jplan, f), getattr(tplan, f))
    for f in ('deltas', 'group_of', 'n_out', 'tile', 'block'):
        assert getattr(jplan, f) == getattr(tplan, f), f


def test_subm_band_plan_and_patch_match_jax():
    rng = np.random.default_rng(4)
    st = make_random_sparse(rng, 2, (6, 24, 20), 700, 768, 4)
    jplan, jkeys = jsp.subm_band_plan(st, 3, tile=32, block=32)
    tplan, tkeys = tsp.subm_band_plan(to_torch_st(st), 3, tile=32, block=32)
    assert_same(jkeys, tkeys)
    _assert_plan_equal(jplan, tplan)
    assert not bool(tplan.span_ok), 'want non-fitting tiles'
    jp = jsp._band_patch(jplan, lambda qk: jsp.lookup(jkeys, qk),
                         patch_cap=256)
    tp = tsp._band_patch(tplan, lambda qk: tsp.lookup(tkeys, qk),
                         patch_cap=256)
    for a, b in zip(jp[:4], tp[:4]):
        assert_same(a, b)
    assert jp[4] == tp[4]


@pytest.mark.parametrize('padding,ksize', [((1, 1, 1), (3, 3, 3)),
                                           ((0, 1, 1), (3, 3, 3)),
                                           ((0, 0, 0), (3, 1, 1))])
def test_strided_band_plan_matches_jax(padding, ksize):
    rng = np.random.default_rng(5)
    st = make_random_sparse(rng, 2, (9, 20, 16), 600, 640, 4)
    stride = (2, 2, 2) if ksize[1] == 3 else (2, 1, 1)
    jout = jsp.downsample_coords(st, stride, padding, ksize, 512)
    tout = tsp.downsample_coords(to_torch_st(st), stride, padding, ksize,
                                 512)
    jplan, jkeys = jsp.strided_band_plan(st, jout, stride, padding, ksize,
                                         tile=32, block=64)
    tplan, tkeys = tsp.strided_band_plan(to_torch_st(st), tout, stride,
                                         padding, ksize, tile=32, block=64)
    assert_same(jkeys, tkeys)
    _assert_plan_equal(jplan, tplan)


def test_first_wins_patch_matches_jax():
    """2D duplicate pixel keys: the patch remaps to the first row of a run
    exactly as the JAX package does."""
    rng = np.random.default_rng(6)
    n = 400
    coords = np.stack([rng.integers(0, 2, n), rng.integers(0, 30, n),
                       rng.integers(0, 12, n)], -1).astype(np.int32)
    jst = jsp.sort_by_key(jsp.SparseTensor(
        jnp.zeros((n, 2)), jnp.asarray(coords), jnp.ones((n,), bool),
        (30, 12), 2))
    jplan, jkeys = jsp.subm_band_plan(jst, 3, tile=16, block=16)
    tplan, tkeys = tsp.subm_band_plan(to_torch_st(jst), 3, tile=16,
                                      block=16)
    _assert_plan_equal(jplan, tplan)
    is_first = jnp.concatenate([jnp.array([True]), jkeys[1:] != jkeys[:-1]])
    jfirst = jax.lax.cummax(jnp.where(is_first, jnp.arange(n), 0))
    tk = tkeys
    t_is_first = torch.ones_like(tk, dtype=torch.bool)
    t_is_first[1:] = tk[1:] != tk[:-1]
    tfirst = torch.cummax(torch.where(t_is_first, torch.arange(n), 0),
                          0).values
    assert_same(jfirst, tfirst)
    jp = jsp._band_patch(jplan, lambda qk: jsp.lookup(jkeys, qk), jfirst,
                         patch_cap=300)
    tp = tsp._band_patch(tplan, lambda qk: tsp.lookup(tkeys, qk), tfirst,
                         patch_cap=300)
    for a, b in zip(jp[:4], tp[:4]):
        assert_same(a, b)


def test_gathered_conv_and_to_dense_match_jax():
    rng = np.random.default_rng(7)
    st = make_random_sparse(rng, 2, (5, 8, 7), 90, 128, 6)
    w = rng.standard_normal((27, 6, 5)).astype(np.float32)
    nmap = jsp.build_subm_neighbor_map(st, 3)
    want = jsp.gathered_conv(st.feats, nmap, jnp.asarray(w), st.mask)
    tst = to_torch_st(st)
    got = tsp.gathered_conv(tst.feats, torch.from_numpy(np.array(nmap)),
                            torch.from_numpy(w), tst.mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(tsp.to_dense(tst).numpy(),
                                  np.asarray(jsp.to_dense(st)))
