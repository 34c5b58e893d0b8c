"""Training parts of the port's sparse substrate vs the JAX package:
``dedup_sorted``, ``compact_sorted`` and ``build_strided_transpose_map``
bit-equal; ``gathered_conv_train`` (gather-only backward) value and both
gradients (tolerances at ``_check``) on the geometries of
tests/test_conv_vjp.py (3D submanifold, strided, the conv_out z compression
and the deduplicated 2D image plane); and the one intended difference,
duplicate keys in the dense lookup table (first row wins in the port, last
on the JAX CPU backend)."""
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.ops import sparse as jsp
from virconv_tpu_torch.ops import sparse as tsp

from test_sparse import make_random_sparse
from test_torch_sparse import assert_same, to_torch_st

torch.set_num_threads(1)


def _image_plane(rng):
    st3 = make_random_sparse(rng, batch_size=2, spatial=(6, 14, 12),
                             n_valid=300, capacity=320, channels=6)
    coords2d = jnp.stack([st3.coords[:, 0], st3.coords[:, 2],
                          st3.coords[:, 3]], -1)
    coords2d = jnp.where(st3.mask[:, None], coords2d, -1)
    return jsp.SparseTensor(feats=st3.feats, coords=coords2d, mask=st3.mask,
                            spatial_shape=(14, 12), batch_size=2)


def test_dedup_and_compact_sorted_bit_equal():
    rng = np.random.default_rng(3)
    st = jsp.sort_by_key(_image_plane(rng))
    tst = to_torch_st(st)
    jd, td = jsp.dedup_sorted(st), tsp.dedup_sorted(tst)
    assert not bool(jd.mask.all()) and int(jd.mask.sum()) < int(st.mask.sum())
    for cap in (st.capacity, 256, 400):
        want = jsp.compact_sorted(jd, cap)
        got = tsp.compact_sorted(td, cap)
        assert_same(want.coords, got.coords)
        assert_same(want.mask, got.mask)
        assert_same(want.feats, got.feats)


GEOMETRIES = {
    'strided': ((2, 2, 2), (1, 1, 1), (3, 3, 3), (2, (6, 14, 12), 500, 576,
                                                  6, 384)),
    'strided_pad011': ((2, 2, 2), (0, 1, 1), (3, 3, 3),
                       (2, (7, 14, 12), 500, 576, 6, 384)),
    'conv_out': ((2, 1, 1), (0, 0, 0), (3, 1, 1),
                 (1, (7, 10, 8), 250, 320, 5, 256)),
}


@pytest.mark.parametrize('name', sorted(GEOMETRIES))
def test_strided_transpose_map_bit_equal(name):
    stride, pad, ks, (b, spatial, n, cap, c, out_cap) = GEOMETRIES[name]
    rng = np.random.default_rng(1)
    st = make_random_sparse(rng, batch_size=b, spatial=spatial, n_valid=n,
                            capacity=cap, channels=c)
    jout = jsp.downsample_coords(st, stride, pad, ks, out_cap)
    want = jsp.build_strided_transpose_map(st, jout, stride, pad, ks)
    tst = to_torch_st(st)
    tout = tsp.downsample_coords(tst, stride, pad, ks, out_cap)
    got = tsp.build_strided_transpose_map(tst, tout, stride, pad, ks)
    assert_same(want, got)
    assert (np.asarray(want) >= 0).sum() > 0


def _grads_jax(fn, feats, w):
    out, vjp = jax.vjp(fn, feats, w)
    cot = 1.0 + 0.1 * jnp.arange(out.size).reshape(out.shape)
    return out, cot, vjp(cot)


def _grads_torch(conv, feats, w, cot):
    f = torch.from_numpy(np.array(feats)).requires_grad_(True)
    wt = torch.from_numpy(np.array(w)).requires_grad_(True)
    out = conv(f, wt)
    out.backward(torch.from_numpy(np.array(cot)))
    return out.detach(), f.grad, wt.grad


def _check(want, got):
    """Value and input gradient at 1e-4; the weight gradient (|dW| up to
    ~4e3 under this cotangent, f32 sums in another order) at atol 1e-3 /
    rtol 5e-3, tests/test_conv_vjp.py's band-train dW tolerance."""
    for a, b, tol in zip(want, got, ((1e-4, 1e-4),) * 2 + ((1e-3, 5e-3),)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol[0],
                                   rtol=tol[1])


@pytest.mark.parametrize('name', ['subm'] + sorted(GEOMETRIES) + ['dedup2d'])
def test_gathered_conv_train_matches_jax(name):
    rng = np.random.default_rng(2)
    if name in GEOMETRIES:
        stride, pad, ks, (b, spatial, n, cap, c, out_cap) = GEOMETRIES[name]
        st = make_random_sparse(rng, batch_size=b, spatial=spatial,
                                n_valid=n, capacity=cap, channels=c)
        jout = jsp.downsample_coords(st, stride, pad, ks, out_cap)
        nmap = jsp.build_strided_neighbor_map(st, jout, stride, pad, ks)
        tmap = jsp.build_strided_transpose_map(st, jout, stride, pad, ks)
        out_mask = jout.mask
        tst = to_torch_st(st)
        tout = tsp.downsample_coords(tst, stride, pad, ks, out_cap)
        conv = tsp.nmap_strided_conv_ctx(tst, tout, stride, pad, ks)
        k = int(np.prod(ks))
    else:
        if name == 'subm':
            st = make_random_sparse(rng, batch_size=2, spatial=(6, 14, 12),
                                    n_valid=500, capacity=576, channels=6)
        else:
            st = jsp.compact_sorted(jsp.dedup_sorted(jsp.sort_by_key(
                _image_plane(rng))), 320)
        c = st.num_channels
        nmap = jsp.build_subm_neighbor_map(st, 3)
        tmap = nmap[:, ::-1]
        out_mask = st.mask
        conv = tsp.nmap_subm_conv_ctx(to_torch_st(st), 3)
        k = nmap.shape[1]
    w = jnp.asarray((rng.standard_normal((k, c, 8)) * 0.3).astype(np.float32))
    want_out, cot, (want_df, want_dw) = _grads_jax(
        lambda f, wt: jsp.gathered_conv_train(f, nmap, tmap, wt, out_mask,
                                              st.mask), st.feats, w)
    got = _grads_torch(conv, st.feats, w, cot)
    _check((want_out, want_df, want_dw), got)


def test_duplicate_pixel_keys_resolve_first_in_port_last_in_jax():
    """The NRConv 2D training conv runs on the neighbor map of the unsorted
    image-plane tensor. Where several rows share a pixel the JAX dense
    lookup table keeps the last row on the CPU backend, the port the first;
    so the centre tap of a non-winning twin reads a different row. Pinned
    here; the whole-step parity test uses duplicate-free inputs."""
    coords = np.array([[0, 3, 4], [0, 5, 5], [0, 3, 4], [0, 3, 5],
                       [0, 3, 4], [-1, -1, -1]], np.int32)
    mask = np.array([1, 1, 1, 1, 1, 0], bool)
    feats = np.arange(12, dtype=np.float32).reshape(6, 2)
    st = jsp.SparseTensor(jnp.asarray(feats), jnp.asarray(coords),
                          jnp.asarray(mask), (8, 8), 1)
    jmap = np.asarray(jsp.build_subm_neighbor_map(st, 3))
    tmap = tsp.build_subm_neighbor_map(to_torch_st(st), 3).numpy()
    centre = 4
    assert list(jmap[[0, 2, 4], centre]) == [4, 4, 4]
    assert list(tmap[[0, 2, 4], centre]) == [0, 0, 0]
    unique = [1, 3]
    np.testing.assert_array_equal(tmap[unique][:, centre], unique)
    np.testing.assert_array_equal(jmap[unique][:, centre], unique)
    # every tap that does not land on the duplicated pixel agrees
    dup_key = (jmap == 4) | (jmap == 0) | (jmap == 2)
    np.testing.assert_array_equal(tmap[~dup_key], jmap[~dup_key])
