"""The training neighbor-map conv of the port on its kernels' contracts vs
the JAX package: the weight gradient over a neighbor map
(``nmap_conv_dw_plain``) against the dW of JAX's ``_gct_bwd`` on
submanifold, strided, conv_out, 2D (duplicate pixels) and patch-row maps,
f32, atol 1e-5 x max(1, the dW scale) (sums of hundreds of rows in another
order; the scale is 5-20 here); ``gathered_conv_train``'s value and both
gradients with the wrappers spied on, so the forward and the input
gradient each go through one ``nmap_conv`` call and the weight gradient
through one ``nmap_conv_dw`` call, and nothing launches on the CPU; and
the band training conv's gather-patch term of dW (one ``nmap_conv_dw``
over the patch map) against JAX's ``_band_train_bwd``."""
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.ops import sparse as jsp
from virconv_tpu.ops.pallas.band_conv import band_conv_dw as jax_band_conv_dw
from virconv_tpu_torch.ops import nmap_conv as tnc
from virconv_tpu_torch.ops import sparse as tsp

from test_sparse import make_random_sparse
from test_torch_band_train import _case as band_case
from test_torch_sparse import to_torch_st
from test_torch_train_sparse import GEOMETRIES, _image_plane, _check

torch.set_num_threads(1)


def _dw_maps(case, rng):
    """(feats, nmap, transpose map) of one map case."""
    if case == 'subm27':
        st = make_random_sparse(rng, 2, (6, 24, 20), 700, 768, 16)
        nmap = jsp.build_subm_neighbor_map(st, 3)
        return st.feats, nmap, nmap[:, ::-1]
    if case in ('strided27', 'conv_out3'):
        stride, pad, ks = ((2, 2, 2), 1, 3) if case == 'strided27' \
            else ((2, 1, 1), 0, (3, 1, 1))
        st = make_random_sparse(rng, 2, (9, 20, 16), 600, 640, 8)
        out = jsp.downsample_coords(st, stride, pad, ks, 512)
        return (st.feats,
                jsp.build_strided_neighbor_map(st, out, stride, pad, ks),
                jsp.build_strided_transpose_map(st, out, stride, pad, ks))
    if case == 'subm2d_k9_dup':
        st = jsp.sort_by_key(_image_plane(rng))
        keys = np.asarray(st.keys())
        valid = np.asarray(st.mask)
        assert (np.diff(keys[valid]) == 0).any(), 'want duplicate pixels'
        nmap = jsp.build_subm_neighbor_map(st, 3)
        return st.feats, nmap, nmap[:, ::-1]
    if case == 'patch_rows':
        st = make_random_sparse(rng, 2, (6, 24, 20), 700, 768, 4)
        nmap = np.asarray(jsp.build_subm_neighbor_map(st, 3))
        rows = np.sort(rng.choice(700, 37, replace=False))
        return (st.feats, jnp.asarray(nmap[rows]),
                jnp.full((768, 27), -1, jnp.int32))
    raise ValueError(case)


@pytest.mark.parametrize('case', ['subm27', 'strided27', 'conv_out3',
                                  'subm2d_k9_dup', 'patch_rows'])
def test_nmap_conv_dw_plain_matches_jax_gct_bwd(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    feats, nmap, tmap = _dw_maps(case, rng)
    (n_out, k), c = nmap.shape, feats.shape[1]
    c_out = 12
    w = jnp.asarray((rng.standard_normal((k, c, c_out)) * 0.3)
                    .astype(np.float32))
    g = rng.standard_normal((n_out, c_out)).astype(np.float32)
    ones = jnp.ones((n_out,), bool)
    res = (feats, nmap, tmap, w, ones, jnp.ones((feats.shape[0],), bool))
    want = np.asarray(jsp._gct_bwd(res, jnp.asarray(g))[3])
    n0 = tnc.dw_launches
    got = tnc.nmap_conv_dw(torch.from_numpy(np.array(feats)),
                           torch.from_numpy(np.array(nmap)),
                           torch.from_numpy(g))
    assert tnc.dw_launches == n0, 'the CPU runs the plain version'
    assert got.shape == (k, c, c_out) and got.dtype == torch.float32
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * max(1.0, scale))


def test_nmap_conv_dw_rejects_shapes_that_disagree():
    feats = torch.zeros((10, 4))
    nmap = torch.zeros((6, 27), dtype=torch.int32)
    with pytest.raises(ValueError, match='disagree'):
        tnc.nmap_conv_dw(feats, nmap, torch.zeros((5, 8)))
    with pytest.raises(ValueError, match='disagree'):
        tnc.nmap_conv_dw(feats, nmap[:, :0], torch.zeros((6, 8)))
    assert tnc.nmap_conv_dw(feats, nmap, torch.zeros((6, 8))).shape == \
        (27, 4, 8)


class Spy:
    """Records the calls of ``nmap_conv`` and ``nmap_conv_dw`` (their
    arguments and results) that the sparse substrate makes; the calls run
    the wrappers."""

    def __init__(self, monkeypatch):
        self.fwd, self.dw = [], []
        conv, dw = tnc.nmap_conv, tnc.nmap_conv_dw

        def spy_conv(*a):
            out = conv(*a)
            self.fwd.append((a, out))
            return out

        def spy_dw(*a):
            out = dw(*a)
            self.dw.append((a, out))
            return out
        monkeypatch.setattr(tnc, 'nmap_conv', spy_conv)
        monkeypatch.setattr(tnc, 'nmap_conv_dw', spy_dw)


def _train_case(name, rng):
    """(JAX tensor, JAX nmap, tmap, out mask, the port's conv function,
    taps)."""
    if name in GEOMETRIES:
        stride, pad, ks, (b, spatial, n, cap, c, out_cap) = GEOMETRIES[name]
        st = make_random_sparse(rng, batch_size=b, spatial=spatial,
                                n_valid=n, capacity=cap, channels=c)
        jout = jsp.downsample_coords(st, stride, pad, ks, out_cap)
        nmap = jsp.build_strided_neighbor_map(st, jout, stride, pad, ks)
        tmap = jsp.build_strided_transpose_map(st, jout, stride, pad, ks)
        tst = to_torch_st(st)
        tout = tsp.downsample_coords(tst, stride, pad, ks, out_cap)
        conv = tsp.nmap_strided_conv_ctx(tst, tout, stride, pad, ks)
        return st, nmap, tmap, jout.mask, conv, int(np.prod(ks))
    if name == 'subm':
        st = make_random_sparse(rng, batch_size=2, spatial=(6, 14, 12),
                                n_valid=500, capacity=576, channels=6)
    else:
        st = jsp.compact_sorted(jsp.dedup_sorted(jsp.sort_by_key(
            _image_plane(rng))), 320)
    nmap = jsp.build_subm_neighbor_map(st, 3)
    conv = tsp.nmap_subm_conv_ctx(to_torch_st(st), 3)
    return st, nmap, nmap[:, ::-1], st.mask, conv, nmap.shape[1]


@pytest.mark.parametrize('name', ['subm'] + sorted(GEOMETRIES) + ['dedup2d'])
def test_gathered_conv_train_runs_each_product_in_one_wrapper_call(
        name, monkeypatch):
    """Value and both gradients against JAX's ``gathered_conv_train``
    (tests/test_torch_train_sparse.py's tolerances) with the wrappers spied
    on: one ``nmap_conv`` over the neighbor map (forward), one over the
    transpose map with ``W[k]^T`` (input gradient), one ``nmap_conv_dw``
    over the neighbor map (weight gradient), each returning what the conv
    then uses; no launch on the CPU; the conv counted as 'nmap_train'."""
    rng = np.random.default_rng(2)
    st, nmap, tmap, out_mask, conv, k = _train_case(name, rng)
    c = st.num_channels
    w = jnp.asarray((rng.standard_normal((k, c, 8)) * 0.3).astype(np.float32))
    fn = lambda f, wt: jsp.gathered_conv_train(f, nmap, tmap, wt, out_mask,
                                               st.mask)
    want_out, vjp = jax.vjp(fn, st.feats, w)
    cot = 1.0 + 0.1 * jnp.arange(want_out.size).reshape(want_out.shape)
    want_df, want_dw = vjp(cot)

    spy = Spy(monkeypatch)
    tsp.branch_counts.clear()
    launches = (tnc.launches, tnc.dw_launches)
    f = torch.from_numpy(np.array(st.feats)).requires_grad_(True)
    wt = torch.from_numpy(np.array(w)).requires_grad_(True)
    out = conv(f, wt)
    out.backward(torch.from_numpy(np.array(cot)))
    _check((want_out, want_df, want_dw), (out.detach(), f.grad, wt.grad))
    assert (tnc.launches, tnc.dw_launches) == launches
    assert tsp.branch_counts == {'nmap_train': 1}, tsp.branch_counts
    assert len(spy.fwd) == 2 and len(spy.dw) == 1
    (fa, fout), (ba, bout) = spy.fwd
    np.testing.assert_array_equal(fa[1].numpy(), np.asarray(nmap))
    assert torch.equal(fa[2], wt.detach())
    np.testing.assert_array_equal(ba[1].numpy(), np.asarray(tmap))
    assert torch.equal(ba[2], wt.detach().transpose(1, 2))
    mask = torch.from_numpy(np.array(out_mask))[:, None].float()
    assert torch.equal(out.detach(), fout * mask)
    in_mask = torch.from_numpy(np.array(st.mask))[:, None].float()
    assert torch.equal(f.grad, bout * in_mask)
    (da, dout), = spy.dw
    np.testing.assert_array_equal(da[1].numpy(), np.asarray(nmap))
    assert torch.equal(wt.grad, dout)


def test_band_train_patch_dw_term_matches_jax(monkeypatch):
    """``_BandTrain``'s weight gradient on a context with patch rows: the
    patch term is one ``nmap_conv_dw`` over the patch map with the patch
    rows' cotangent, equal to JAX's ``_band_train_bwd`` dW less its K4 term
    (Pallas ``band_conv_dw`` in interpret mode) within 1e-4 x the dW
    scale; the whole dW within 1e-4 x scale of JAX's."""
    st, w, tile, block = band_case('patch_rows')
    plan, keys = jsp.subm_band_plan(st, 3, tile, block)
    pidx, pvalid, pnmap, _, _ = jsp._band_patch(
        plan, lambda qk: jsp.lookup(keys, qk))
    bits_dw = jnp.where(plan.fits[:, None], plan.valid_bits, 0)
    statics = jsp._BandStatics(plan.deltas, plan.group_of, plan.n_out, tile,
                               block, False)
    g = np.random.default_rng(5).standard_normal(
        (st.capacity, w.shape[2])).astype(np.float32)
    res = (st.feats, jnp.asarray(w), keys, plan.blk, plan.base_keys,
           plan.valid_bits, bits_dw, pidx, pvalid, pnmap)
    want_dw = np.asarray(jsp._band_train_bwd(statics, res, jnp.asarray(g))[1])
    want_k4 = np.asarray(jax_band_conv_dw(st.feats, keys, plan, jnp.asarray(g),
                                          valid_bits=bits_dw, bf16=False,
                                          interpret=True))

    tst = to_torch_st(st)
    tplan, tkeys = tsp.subm_band_plan(tst, 3, tile, block)
    tpidx, tpnmap = tsp._sized_patch(tplan, lambda qk: tsp.lookup(tkeys, qk))
    spy = Spy(monkeypatch)
    conv = tsp.subm_conv_ctx(tst, 3, tile=tile, block=block, train=True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = conv(tst.feats, wt)
    out.backward(torch.from_numpy(g))
    (args, term), = spy.dw
    assert torch.equal(args[1], tpnmap)
    assert torch.equal(args[2], torch.from_numpy(g)[tpidx])
    scale = np.abs(want_dw).max()
    np.testing.assert_allclose(term.numpy(), want_dw - want_k4, rtol=0,
                               atol=1e-4 * scale)
    assert np.abs(want_dw - want_k4).max() > 1e-2 * scale, 'want a patch term'
    np.testing.assert_allclose(wt.grad.numpy(), want_dw, rtol=0,
                               atol=1e-4 * scale)
