"""The training band conv of the port vs the JAX package: the weight-gradient
contract (K4's plain version) against the Pallas ``band_conv_dw`` in
interpret mode, f32 and bf16 operands, with and without a ``valid_bits``
override (atol 1e-4 x the output scale: f32 sums in another order); then the
differentiable band conv of ``subm_conv_ctx(train=True)`` (K1 forward, K1
with transposed weights for the input gradient, K4 + patch rows for the
weight gradient) against JAX's ``subm_conv_ctx(use_band=True, train=True)``
on the cases of tests/test_conv_vjp.py, value and input gradient at 1e-4,
weight gradient at atol 1e-3 / rtol 5e-3."""
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.ops import sparse as jsp
from virconv_tpu.ops.pallas.band_conv import band_conv_dw as jax_band_conv_dw
from virconv_tpu_torch.ops import band_conv as tbc
from virconv_tpu_torch.ops import sparse as tsp

from test_sparse import make_random_sparse
from test_torch_sparse import to_torch_st

torch.set_num_threads(1)


@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('override', [False, True])
def test_dw_plain_matches_jax_kernel(bf16, override):
    rng = np.random.default_rng(0)
    st = make_random_sparse(rng, 2, (6, 24, 20), 700, 768, 8)
    jplan, jkeys = jsp.subm_band_plan(st, 3, tile=32, block=32)
    tplan, tkeys = tsp.subm_band_plan(to_torch_st(st), 3, tile=32, block=32)
    assert not bool(tplan.span_ok), 'want non-fitting tiles'
    g = rng.standard_normal((768, 12)).astype(np.float32)
    jvb = tvb = None
    if override:
        jvb = jnp.where(jplan.fits[:, None], jplan.valid_bits, 0)
        tvb = torch.where(tplan.fits[:, None], tplan.valid_bits,
                          torch.zeros_like(tplan.valid_bits))
    want = np.asarray(jax_band_conv_dw(st.feats, jkeys, jplan, jnp.asarray(g),
                                       valid_bits=jvb, bf16=bf16,
                                       interpret=True))
    got = tbc.band_conv_dw(torch.from_numpy(np.array(st.feats)), tkeys,
                           tplan, torch.from_numpy(g), tvb, bf16)
    assert got.shape == (27, 8, 12) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)


def _loss(out):
    return (out * (1.0 + 0.1 * jnp.arange(out.size).reshape(out.shape))).sum()


def uneven_slabs(rng, capacity=384, channels=6):
    """A thin-x tensor whose y slabs alternate 16 and 150 voxels: a tile of
    a sparse slab needs the whole dense neighbor slab, more rows than its
    two-block window holds at tile 16 / block 32, so patch rows are
    active. (tests/test_conv_vjp.py's uniform thin-x case fits every
    tile.)"""
    z, y, x = 5, 4, 40
    coords = []
    for yy, n in ((0, 16), (1, 150), (2, 16), (3, 150)):
        cells = rng.choice(z * x, n, replace=False)
        coords += [(0, cz // x, yy, cz % x) for cz in cells]
    n = len(coords)
    c = np.full((capacity, 4), -1, np.int32)
    c[:n] = coords
    f = np.zeros((capacity, channels), np.float32)
    f[:n] = rng.standard_normal((n, channels))
    return jsp.sort_by_key(jsp.SparseTensor(
        jnp.asarray(f), jnp.asarray(c), jnp.asarray(np.arange(capacity) < n),
        (z, y, x), 1))


def _case(name):
    """(sparse tensor, weights, tile, block): tests/test_conv_vjp.py's
    regular band-train case, and one with patch rows."""
    if name == 'regular':
        rng = np.random.default_rng(7)
        st = make_random_sparse(rng, batch_size=2, spatial=(6, 14, 12),
                                n_valid=500, capacity=576, channels=8)
        w = (rng.standard_normal((27, 8, 8)) * 0.3).astype(np.float32)
        return st, w, 32, 64
    rng = np.random.default_rng(8)
    st = uneven_slabs(rng)
    w = (rng.standard_normal((27, 6, 6)) * 0.3).astype(np.float32)
    return st, w, 16, 32


@pytest.mark.parametrize('name', ['regular', 'patch_rows'])
def test_band_train_value_and_grads_match_jax(name):
    st, w, tile, block = _case(name)
    jctx = jsp.subm_conv_ctx(st, 3, use_band=True, train=True, tile=tile,
                             block=block, bf16=False)
    want_out, vjp = jax.vjp(lambda f, wt: jctx.conv(f, wt), st.feats,
                            jnp.asarray(w))
    cot = jax.grad(_loss)(want_out)
    want_df, want_dw = vjp(cot)

    tst = to_torch_st(st)
    tplan, _ = tsp.subm_band_plan(tst, 3, tile, block)
    if name == 'patch_rows':
        assert not bool(tplan.fits.all()), 'want patch rows'
    tsp.branch_counts.clear()
    conv = tsp.subm_conv_ctx(tst, 3, tile=tile, block=block, train=True)
    feats = tst.feats.clone().requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = conv(feats, wt)
    out.backward(torch.from_numpy(np.asarray(cot)))
    assert tsp.branch_counts == {'band_train': 1}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(feats.grad.numpy(), np.asarray(want_df),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw),
                               atol=1e-3, rtol=5e-3)


def test_band_train_equals_the_old_composition():
    """The training conv's forward and input gradient, each one joined
    ``band_conv`` call with the patch, give the bits of K1 without it plus
    ``nmap_conv`` over the patch map and an index put (f32, no epilogue;
    the input gradient with the tap-reversed, transposed weights)."""
    from virconv_tpu_torch.ops import nmap_conv as tnc
    st, w, tile, block = _case('patch_rows')
    tst = to_torch_st(st)
    plan, keys = tsp.subm_band_plan(tst, 3, tile, block)
    pidx, pnmap = tsp._sized_patch(plan, lambda qk: tsp.lookup(keys, qk))
    conv = tsp.subm_conv_ctx(tst, 3, tile=tile, block=block, train=True)
    feats = tst.feats.clone().requires_grad_(True)
    wt = torch.from_numpy(w)
    cot = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (tst.feats.shape[0], w.shape[2])).astype(np.float32))
    out = conv(feats, wt)
    out.backward(cot)

    def old(x, weights):
        y = tbc.band_conv(x, keys, plan, weights, bf16=False)
        y[pidx] = tnc.nmap_conv(x, pnmap, weights)
        return y
    assert torch.equal(out.detach(), old(tst.feats, wt))
    w_t = wt.flip(0).transpose(1, 2).contiguous()
    assert torch.equal(feats.grad, old(cot, w_t))


def test_band_train_skips_input_gradient_of_raw_features():
    """The first conv of each stream reads raw voxel features: no input
    gradient is computed, so K1 runs once (forward) and K4 once."""
    st, w, tile, block = _case('regular')
    tst = to_torch_st(st)
    conv = tsp.subm_conv_ctx(tst, 3, tile=tile, block=block, train=True)
    calls = []
    orig_conv, orig_dw = tbc.band_conv, tbc.band_conv_dw

    def count(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped
    tbc.band_conv = count('fwd', orig_conv)
    tbc.band_conv_dw = count('dw', orig_dw)
    try:
        wt = torch.from_numpy(w).requires_grad_(True)
        conv(tst.feats, wt).sum().backward()
    finally:
        tbc.band_conv, tbc.band_conv_dw = orig_conv, orig_dw
    assert calls == ['fwd', 'dw']
    assert wt.grad is not None and bool(torch.isfinite(wt.grad).all())
