"""``VIRCONV_BAND_TRAIN_BF16``: the port's training band conv
(``subm_conv_ctx(train=True)``: K1 forward, K1 input gradient and K4 with
bf16 operands, the gather-patch terms in f32) against the JAX package's
band train context with the same switch, on the case of
tests/test_conv_vjp.py::test_band_train_vjp_bf16_tolerance and on a case
with patch rows (tests/test_torch_band_train.py's uneven slabs).

Against the f32 neighbor-map oracle, with JAX's own bounds for this mode:
dfeats within atol 10 / rtol 5e-2, dW within atol 1e2 / rtol 5e-2, and
cosine > 0.999 for both. Against JAX's band train context directly: the
output and both gradients within rtol 1e-2 (atol 1e-4 x the JAX scale):
the bf16 products are exact in f32 on both sides and only the order of
the f32 sums differs. Unset or falsy, the switch leaves the operands f32
(the bits of ``bf16=False``)."""
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.ops import sparse as jsp
from virconv_tpu_torch.ops import band_conv as tbc
from virconv_tpu_torch.ops import sparse as tsp

from test_sparse import make_random_sparse
from test_torch_band_train import uneven_slabs
from test_torch_sparse import to_torch_st

torch.set_num_threads(1)


def _loss_weights(n):
    return 1.0 + 0.1 * np.arange(n, dtype=np.float32)


def jax_grads(fn, feats, w):
    def loss(f, wt):
        out = fn(f, wt)
        return (out * _loss_weights(out.size).reshape(out.shape)).sum()
    return jax.grad(loss, argnums=(0, 1))(feats, w)


def case(name):
    """(sparse tensor, weights, tile, block)."""
    if name == 'jax_case':
        rng = np.random.default_rng(9)
        st = make_random_sparse(rng, batch_size=1, spatial=(6, 14, 12),
                                n_valid=400, capacity=448, channels=8)
        w = (rng.standard_normal((27, 8, 8)) * 0.3).astype(np.float32)
        return st, w, 32, 64
    rng = np.random.default_rng(8)
    st = uneven_slabs(rng)
    w = (rng.standard_normal((27, 6, 6)) * 0.3).astype(np.float32)
    return st, w, 16, 32


def port_run(st, w, tile, block, bf16=True):
    """The port's output and (dfeats, dW) under the same loss, with the
    ``bf16`` flags K1 and K4 were called with."""
    tst = to_torch_st(st)
    conv = tsp.subm_conv_ctx(tst, 3, tile=tile, block=block, train=True,
                             bf16=bf16)
    flags = []
    orig_conv, orig_dw = tbc.band_conv, tbc.band_conv_dw

    def spy(fn):
        def wrapped(*a, **k):
            flags.append(k['bf16'])
            return fn(*a, **k)
        return wrapped
    tbc.band_conv, tbc.band_conv_dw = spy(orig_conv), spy(orig_dw)
    try:
        feats = tst.feats.clone().requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        out = conv(feats, wt)
        (out * torch.from_numpy(_loss_weights(out.numel())).reshape(
            out.shape)).sum().backward()
    finally:
        tbc.band_conv, tbc.band_conv_dw = orig_conv, orig_dw
    return out.detach(), (feats.grad, wt.grad), flags


@pytest.mark.parametrize('name', ['jax_case', 'patch_rows'])
def test_band_train_bf16_matches_jax(name, monkeypatch):
    monkeypatch.setenv('VIRCONV_BAND_TRAIN_BF16', '1')
    st, w, tile, block = case(name)
    jctx = jsp.subm_conv_ctx(st, 3, use_band=True, train=True, tile=tile,
                             block=block, bf16=True)
    want_out = np.asarray(jctx.conv(st.feats, jnp.asarray(w)))
    want = jax_grads(lambda f, wt: jctx.conv(f, wt), st.feats,
                     jnp.asarray(w))
    nmap = jsp.build_subm_neighbor_map(st, 3)
    ref = jax_grads(lambda f, wt: jsp.gathered_conv(f, nmap, wt, st.mask),
                    st.feats, jnp.asarray(w))
    tsp.branch_counts.clear()
    out, got, flags = port_run(st, w, tile, block)
    assert tsp.branch_counts == {'band_train': 1}
    assert flags == [True, True, True], 'K1, K1 input gradient, K4'
    if name == 'patch_rows':
        plan, _ = tsp.subm_band_plan(to_torch_st(st), 3, tile, block)
        assert not bool(plan.fits.all()), 'want patch rows'
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-2,
                               atol=1e-4 * np.abs(want_out).max())
    for g, j, r, atol in zip(got, want, ref, (10.0, 1e2)):
        g, j, r = g.numpy(), np.asarray(j), np.asarray(r)
        np.testing.assert_allclose(g, r, atol=atol, rtol=5e-2)
        cos = g.ravel() @ r.ravel() / (np.linalg.norm(g) * np.linalg.norm(r))
        assert cos > 0.999, cos
        np.testing.assert_allclose(g, j, rtol=1e-2,
                                   atol=1e-4 * np.abs(j).max())
    # the mode really rounds: not the f32 gradients
    _, got32, _ = port_run(st, w, tile, block, bf16=False)
    assert not torch.equal(got[1], got32[1])


@pytest.mark.parametrize('value', [None, '0', 'false', 'False'])
def test_switch_off_keeps_f32_operands(value, monkeypatch):
    if value is None:
        monkeypatch.delenv('VIRCONV_BAND_TRAIN_BF16', raising=False)
    else:
        monkeypatch.setenv('VIRCONV_BAND_TRAIN_BF16', value)
    assert tsp.band_train_bf16_enabled() is jsp.band_train_bf16_enabled() \
        is False
    st, w, tile, block = case('jax_case')
    out, got, flags = port_run(st, w, tile, block, bf16=True)
    out32, got32, _ = port_run(st, w, tile, block, bf16=False)
    assert flags == [False, False, False]
    assert torch.equal(out, out32)
    assert all(torch.equal(a, b) for a, b in zip(got, got32))
