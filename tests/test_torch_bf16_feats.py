"""K1's bf16-feature contract (``VIRCONV_BF16_FEATS``): the port's eval conv
contexts against the JAX package's band contexts (Pallas in interpret mode,
``use_band=True``) with the switch set on both sides, on seeded inputs
whose small blocks leave non-fitting tiles (the gather patch in the call):
a 3D submanifold context, a strided context and the NRConv 2D first-wins
context, with f32 and bf16 operands. One layer from f32 rows, then a
second layer fed the first layer's bf16 rows (JAX's, to both sides). Both
outputs are bf16 and agree with JAX's within one bf16 ulp:
|d| <= 2^-7 |ref| + 1e-3 max |ref| (the sums are f32 in another order,
so a value next to a rounding boundary may round the other way); at least
99 % of the values are bit-equal (the share is recorded as the test's
``bit_equal_share`` property, in the junit report). The neighbor-map
branch (unsorted keys) casts its rows the same way. With the switch off,
the rows stay f32."""
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.ops import sparse as jsp
from virconv_tpu_torch.ops import sparse as tsp

from test_sparse import make_random_sparse
from test_torch_band_conv import _affine, _duplicate_2d, _weights
from test_torch_sparse import to_torch_st

torch.set_num_threads(1)


def assert_within_one_ulp(got, want):
    """``got`` (a bf16 tensor) against ``want`` (a bf16 JAX array); returns
    the share of bit-equal values."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    bound = 2.0 ** -7 * np.abs(w) + 1e-3 * np.abs(w).max()
    assert (np.abs(g - w) <= bound).all(), float(np.abs(g - w).max())
    return float((g == w).mean())


def contexts(kind, bf16, rng):
    """(JAX conv, port conv, f32 input rows, K, C) of one context kind."""
    if kind == 'subm':
        st = make_random_sparse(rng, 2, (6, 24, 20), 700, 768, 16)
        jconv = jsp.subm_conv_ctx(st, 3, use_band=True, tile=32, block=32,
                                  bf16=bf16).conv
        tconv = tsp.subm_conv_ctx(to_torch_st(st), 3, tile=32, block=32,
                                  bf16=bf16)
        return jconv, tconv, np.array(st.feats), 27, 16
    if kind == 'strided':
        st = make_random_sparse(rng, 2, (9, 20, 16), 600, 640, 16)
        stride, pad, ks = (2, 2, 2), (1, 1, 1), (3, 3, 3)
        jout = jsp.downsample_coords(st, stride, pad, ks, 512)
        tst = to_torch_st(st)
        tout = tsp.downsample_coords(tst, stride, pad, ks, 512)
        jconv = jsp.strided_conv_ctx(st, jout, stride, pad, ks,
                                     use_band=True, tile=16, block=16,
                                     bf16=bf16).conv
        tconv = tsp.strided_conv_ctx(tst, tout, stride, pad, ks, tile=16,
                                     block=16, bf16=bf16)
        return jconv, tconv, np.array(st.feats), 27, 16
    st = _duplicate_2d(rng, 400, (30, 12))
    jconv = jsp.subm_conv_ctx(st, 3, use_band=True, tile=16, block=16,
                              first_wins_sources=True, bf16=bf16).conv
    tconv = tsp.subm_conv_ctx(to_torch_st(st), 3, tile=16, block=16,
                              first_wins_sources=True, bf16=bf16)
    return jconv, tconv, np.array(st.feats), 9, 4


@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('kind', ['subm', 'strided', 'first_wins_2d'])
def test_bf16_feature_rows_match_jax(kind, bf16, monkeypatch,
                                     record_property):
    monkeypatch.setenv('VIRCONV_BF16_FEATS', '1')
    rng = np.random.default_rng(11)
    jconv, tconv, feats, k, c = contexts(kind, bf16, rng)
    w1 = _weights(rng, k, c, c)
    w2 = _weights(rng, k, c, c)
    scale, bias = _affine(rng, c)
    want1 = jconv(jnp.asarray(feats), jnp.asarray(w1), jnp.asarray(scale),
                  jnp.asarray(bias), relu=True)
    got1 = tconv(torch.from_numpy(feats), torch.from_numpy(w1),
                 torch.from_numpy(scale), torch.from_numpy(bias), relu=True)
    eq1 = assert_within_one_ulp(got1, want1)
    record_property('bit_equal_share', eq1)
    if kind == 'strided':
        assert eq1 >= 0.99, eq1
        return   # its rows live on the output key set, not the input's
    # the second layer reads the first's bf16 rows
    rows = torch.from_numpy(np.asarray(want1, np.float32)).to(torch.bfloat16)
    want2 = jconv(want1, jnp.asarray(w2))
    got2 = tconv(rows, torch.from_numpy(w2))
    eq2 = assert_within_one_ulp(got2, want2)
    record_property('bit_equal_share_second_layer', eq2)
    assert min(eq1, eq2) >= 0.99, (eq1, eq2)
    assert np.abs(np.asarray(want2, np.float32)).max() > 0


def test_strided_layer_reads_bf16_rows(monkeypatch):
    """A strided context fed bf16 rows (the layer before it stored them):
    bf16 out within one ulp of JAX's."""
    monkeypatch.setenv('VIRCONV_BF16_FEATS', '1')
    rng = np.random.default_rng(12)
    jconv, tconv, feats, k, c = contexts('strided', True, rng)
    rows = jnp.asarray(feats).astype(jnp.bfloat16)
    w = _weights(rng, k, c, 2 * c)
    want = jconv(rows, jnp.asarray(w))
    got = tconv(torch.from_numpy(np.asarray(rows, np.float32)).to(
        torch.bfloat16), torch.from_numpy(w))
    assert assert_within_one_ulp(got, want) >= 0.99


def test_neighbor_map_branch_casts_rows(monkeypatch):
    """Unsorted keys send the port's context to the exact neighbor-map conv;
    under the switch its rows are bf16 too, within one ulp of JAX's."""
    monkeypatch.setenv('VIRCONV_BF16_FEATS', '1')
    rng = np.random.default_rng(13)
    st = make_random_sparse(rng, 2, (6, 24, 20), 700, 768, 8)
    w = _weights(rng, 27, 8, 8)
    want = jsp.subm_conv_ctx(st, 3, use_band=True, tile=32, block=32,
                             bf16=False).conv(st.feats, jnp.asarray(w))
    plan_of = tsp.subm_band_plan

    def unsorted_plan(*a, **kw):
        plan, keys = plan_of(*a, **kw)
        return plan._replace(keys_sorted=torch.tensor(False)), keys
    monkeypatch.setattr(tsp, 'subm_band_plan', unsorted_plan)
    tsp.branch_counts.clear()
    tst = to_torch_st(st)
    got = tsp.subm_conv_ctx(tst, 3, tile=32, block=32, bf16=False)(
        tst.feats, torch.from_numpy(w))
    assert tsp.branch_counts == {'nmap_slow': 1}
    assert assert_within_one_ulp(got, want) >= 0.99


@pytest.mark.parametrize('value', [None, '0', 'false', 'False'])
def test_switch_off_keeps_f32_rows(value, monkeypatch):
    """Unset or falsy, as in the JAX package: f32 rows."""
    if value is None:
        monkeypatch.delenv('VIRCONV_BF16_FEATS', raising=False)
    else:
        monkeypatch.setenv('VIRCONV_BF16_FEATS', value)
    assert tsp.feats_bf16_enabled() is jsp.feats_bf16_enabled() is False
    rng = np.random.default_rng(14)
    _, tconv, feats, k, c = contexts('subm', True, rng)
    got = tconv(torch.from_numpy(feats), torch.from_numpy(
        _weights(rng, k, c, c)))
    assert got.dtype == torch.float32
