"""Port band-window conv (virconv_tpu_torch.ops.band_conv) vs the JAX Pallas
kernel in interpret mode on the same plan, f32 operands, atol 1e-5: 3D
submanifold and strided plans with non-fitting tiles (window misses), and
the 2D first-wins layout with duplicate keys. Then the band conv with its
gather patch (one ``band_conv`` call) vs the composition it replaces and
vs the JAX band conv plus its patch, and the port's conv contexts (kernel
+ gather patch, and the full neighbor-map branch) vs the exact gathered
conv."""
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.ops import sparse as jsp
from virconv_tpu.ops.pallas.band_conv import band_conv as jax_band_conv
from virconv_tpu_torch.ops import band_conv as tbc
from virconv_tpu_torch.ops import sparse as tsp

from test_sparse import make_random_sparse
from test_torch_sparse import to_torch_st

torch.set_num_threads(1)
ATOL = 1e-5


def _weights(rng, k, c, co):
    return (rng.standard_normal((k, c, co)) * 0.3).astype(np.float32)


def _affine(rng, co):
    return (rng.uniform(0.5, 2.0, co).astype(np.float32),
            rng.standard_normal(co).astype(np.float32))


def _compare(feats, jkeys, jplan, tkeys, tplan, w, scale=None, bias=None,
             relu=False):
    want = jax_band_conv(jnp.asarray(feats), jkeys, jplan, jnp.asarray(w),
                         scale=None if scale is None else jnp.asarray(scale),
                         bias=None if bias is None else jnp.asarray(bias),
                         relu=relu, bf16=False, interpret=True)
    got = tbc.band_conv(torch.from_numpy(feats), tkeys, tplan,
                        torch.from_numpy(w),
                        None if scale is None else torch.from_numpy(scale),
                        None if bias is None else torch.from_numpy(bias),
                        relu=relu, bf16=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-5)
    return got


@pytest.mark.parametrize('affine', [False, True])
def test_subm_plain_matches_jax_kernel_with_misses(affine):
    rng = np.random.default_rng(0)
    st = make_random_sparse(rng, 2, (6, 24, 20), 700, 768, 8)
    jplan, jkeys = jsp.subm_band_plan(st, 3, tile=32, block=32)
    tplan, tkeys = tsp.subm_band_plan(to_torch_st(st), 3, tile=32, block=32)
    assert not bool(tplan.span_ok), 'want window misses in some tiles'
    w = _weights(rng, 27, 8, 12)
    scale, bias = _affine(rng, 12) if affine else (None, None)
    _compare(np.array(st.feats), jkeys, jplan, tkeys, tplan, w, scale,
             bias, relu=affine)


def test_strided_plain_matches_jax_kernel():
    rng = np.random.default_rng(1)
    st = make_random_sparse(rng, 2, (9, 20, 16), 600, 640, 8)
    stride, pad, ks = (2, 2, 2), (0, 1, 1), (3, 3, 3)
    jout = jsp.downsample_coords(st, stride, pad, ks, 512)
    tout = tsp.downsample_coords(to_torch_st(st), stride, pad, ks, 512)
    jplan, jkeys = jsp.strided_band_plan(st, jout, stride, pad, ks, tile=32,
                                         block=16)
    tplan, tkeys = tsp.strided_band_plan(to_torch_st(st), tout, stride, pad,
                                         ks, tile=32, block=16)
    assert not bool(tplan.span_ok)
    w = _weights(rng, 27, 8, 16)
    scale, bias = _affine(rng, 16)
    _compare(np.array(st.feats), jkeys, jplan, tkeys, tplan, w, scale,
             bias, relu=True)


def _duplicate_2d(rng, n=300, shape=(24, 10)):
    coords = np.stack([rng.integers(0, 2, n), rng.integers(0, shape[0], n),
                       rng.integers(0, shape[1], n)], -1).astype(np.int32)
    mask = np.ones((n,), bool)
    mask[-20:] = False
    coords[~mask] = -1
    feats = rng.standard_normal((n, 4)).astype(np.float32) * mask[:, None]
    return jsp.sort_by_key(jsp.SparseTensor(
        jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(mask), shape, 2))


def test_2d_first_wins_plain_matches_jax_kernel():
    """Duplicate pixel keys with non-first rows zeroed as sources (the
    NRConv ctx's src_sel): window sum == first-row lower bound."""
    rng = np.random.default_rng(2)
    st = _duplicate_2d(rng)
    jplan, jkeys = jsp.subm_band_plan(st, 3, tile=16, block=16)
    tplan, tkeys = tsp.subm_band_plan(to_torch_st(st), 3, tile=16, block=16)
    keys = np.asarray(jkeys)
    assert (keys[1:] == keys[:-1]).any(), 'want duplicate keys'
    first = np.concatenate([[True], keys[1:] != keys[:-1]])
    src = np.array(st.feats) * (first & np.asarray(st.mask))[:, None]
    w = _weights(rng, 9, 4, 4)
    _compare(src.astype(np.float32), jkeys, jplan, tkeys, tplan, w)


def _patched_case(seed, c=8, co=12):
    rng = np.random.default_rng(seed)
    st = make_random_sparse(rng, 2, (6, 24, 20), 700, 768, c)
    tst = to_torch_st(st)
    plan, keys = tsp.subm_band_plan(tst, 3, tile=32, block=32)
    patch = tsp._sized_patch(plan, lambda qk: tsp.lookup(keys, qk))
    assert patch is not None and not bool(plan.fits.all())
    w = _weights(rng, 27, c, co)
    scale, bias = _affine(rng, co)
    return st, tst, plan, keys, patch, w, scale, bias


@pytest.mark.parametrize('bf16', [False, True])
def test_patched_band_conv_equals_the_old_composition(bf16):
    """``band_conv(..., patch=...)`` gives the bits of K1 without it, then
    ``nmap_conv`` over the patch map, the eager ``_epilogue`` and an index
    put (the composition the joined call replaces), with affine and ReLU,
    bf16 and f32 operands."""
    from virconv_tpu_torch.ops import nmap_conv as tnc
    _, tst, plan, keys, patch, w, scale, bias = _patched_case(9)
    feats, w, scale, bias = (tst.feats, torch.from_numpy(w),
                             torch.from_numpy(scale), torch.from_numpy(bias))
    got = tbc.band_conv(feats, keys, plan, w, scale, bias, True, bf16, patch)
    want = tbc.band_conv(feats, keys, plan, w, scale, bias, True, bf16)
    pidx, pnmap = patch
    want[pidx] = tsp._epilogue(tnc.nmap_conv(feats, pnmap, w), None, scale,
                               bias, True)
    assert torch.equal(got, want)
    assert not torch.equal(got, tbc.band_conv(feats, keys, plan, w, scale,
                                              bias, True, bf16))


@pytest.mark.parametrize('bf16', [False, True])
def test_patched_band_conv_matches_jax_band_conv_plus_patch(bf16):
    """The joined call vs the JAX package's band conv (Pallas, interpret
    mode) plus its f32 gather patch (``subm_conv_ctx(use_band=True)``) on
    seeded inputs with non-fitting tiles: atol 1e-5 with f32 operands,
    1e-4 x the output scale with bf16 ones (the same bf16 products, summed
    in another order)."""
    st, tst, plan, keys, patch, w, scale, bias = _patched_case(10)
    jctx = jsp.subm_conv_ctx(st, 3, use_band=True, tile=32, block=32,
                             bf16=bf16)
    want = np.asarray(jctx.conv(st.feats, jnp.asarray(w), jnp.asarray(scale),
                                jnp.asarray(bias), relu=True))
    got = tbc.band_conv(tst.feats, keys, plan, torch.from_numpy(w),
                        torch.from_numpy(scale), torch.from_numpy(bias),
                        True, bf16, patch).numpy()
    atol = 1e-4 * np.abs(want).max() if bf16 else ATOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=0 if bf16 else 1e-5)


@pytest.mark.parametrize('first_wins', [False, True])
def test_subm_ctx_exact_vs_gathered_conv(first_wins, monkeypatch):
    """Band ctx (kernel + gather patch) and its full neighbor-map branch
    (taken when the plan's keys are not sorted) both equal the exact conv
    of the JAX oracle."""
    rng = np.random.default_rng(3)
    if first_wins:
        st = _duplicate_2d(rng, 400, (30, 12))
        keys = np.asarray(jsp.halo_keys(st.coords, st.spatial_shape,
                                        st.batch_size, st.mask))
        first = np.concatenate([[True], keys[1:] != keys[:-1]])
        src = np.array(st.feats) * (first & np.asarray(st.mask))[:, None]
        first_idx = np.maximum.accumulate(
            np.where(first, np.arange(len(keys)), 0))
        # exact first-wins oracle: neighbors resolve to the first row
        nmap = np.asarray(jsp.build_subm_neighbor_map(
            st.replace(feats=jnp.asarray(src)), 3))
        nmap = np.where(nmap >= 0, first_idx[np.maximum(nmap, 0)], nmap)
        k, c = 9, 4
    else:
        st = make_random_sparse(rng, 2, (6, 24, 20), 700, 768, 8)
        src = np.array(st.feats)
        nmap = np.asarray(jsp.build_subm_neighbor_map(st, 3))
        k, c = 27, 8
    w = _weights(rng, k, c, 8)
    scale, bias = _affine(rng, 8)
    raw = np.asarray(jsp.gathered_conv(jnp.asarray(src), jnp.asarray(nmap),
                                       jnp.asarray(w), st.mask))
    mask = np.asarray(st.mask)[:, None]
    want = np.maximum(raw * scale + bias, 0.0) * mask
    tst = to_torch_st(st)
    plan_of = tsp.subm_band_plan

    def unsorted_plan(*a, **k):
        plan, keys = plan_of(*a, **k)
        return plan._replace(keys_sorted=torch.tensor(False)), keys
    for sorted_keys, branch in ((True, 'band'), (False, 'nmap_slow')):
        if not sorted_keys:
            monkeypatch.setattr(tsp, 'subm_band_plan', unsorted_plan)
        tsp.branch_counts.clear()
        conv = tsp.subm_conv_ctx(tst, 3, tile=16, block=16,
                                 first_wins_sources=first_wins, bf16=False)
        got = conv(tst.feats, torch.from_numpy(w),
                       torch.from_numpy(scale), torch.from_numpy(bias),
                       relu=True)
        assert tsp.branch_counts[branch] == 1, tsp.branch_counts
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-5)


def test_ctx_past_the_jax_patch_cap_stays_on_the_band(monkeypatch):
    """A context with more non-fitting rows than the JAX package's patch
    cap: JAX's ctx takes its full neighbor-map branch, the port's patch
    holds every such row and stays on the band kernel; the same output."""
    rng = np.random.default_rng(8)
    st = make_random_sparse(rng, 2, (6, 24, 20), 700, 768, 8)
    w = _weights(rng, 27, 8, 8)
    scale, bias = _affine(rng, 8)
    monkeypatch.setattr(jsp, 'BAND_PATCH_CAP', 8)
    monkeypatch.setattr(jsp, 'BAND_PATCH_FRACTION', 10 ** 9)
    jctx = jsp.subm_conv_ctx(st, 3, use_band=True, tile=16, block=16,
                             bf16=False)
    want = np.asarray(jctx.conv(st.feats, jnp.asarray(w), jnp.asarray(scale),
                                jnp.asarray(bias), relu=True))
    tst = to_torch_st(st)
    plan, keys = tsp.subm_band_plan(tst, 3, tile=16, block=16)
    patch = tsp._sized_patch(plan, lambda qk: tsp.lookup(keys, qk))
    assert patch is not None and patch[0].shape[0] > 8
    tsp.branch_counts.clear()
    conv = tsp.subm_conv_ctx(tst, 3, tile=16, block=16, bf16=False)
    got = conv(tst.feats, torch.from_numpy(w), torch.from_numpy(scale),
               torch.from_numpy(bias), relu=True)
    assert tsp.branch_counts == {'band': 1}
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-5)


def test_strided_ctx_exact_vs_gathered_conv():
    rng = np.random.default_rng(4)
    st = make_random_sparse(rng, 2, (9, 20, 16), 600, 640, 8)
    stride, pad, ks = (2, 2, 2), (1, 1, 1), (3, 3, 3)
    jout = jsp.downsample_coords(st, stride, pad, ks, 512)
    nmap = jsp.build_strided_neighbor_map(st, jout, stride, pad, ks)
    w = _weights(rng, 27, 8, 8)
    want = np.asarray(jsp.gathered_conv(st.feats, nmap, jnp.asarray(w),
                                        jout.mask))
    tst = to_torch_st(st)
    tout = tsp.downsample_coords(tst, stride, pad, ks, 512)
    conv = tsp.strided_conv_ctx(tst, tout, stride, pad, ks, tile=16,
                                block=32, bf16=False)
    got = conv(tst.feats, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-5)


def test_bf16_operands_close_to_f32():
    """bf16 rounding of feats and W only: within bf16 tolerance of f32."""
    rng = np.random.default_rng(5)
    st = make_random_sparse(rng, 1, (6, 16, 14), 300, 384, 8)
    tplan, tkeys = tsp.subm_band_plan(to_torch_st(st), 3, tile=32,
                                      block=64)
    feats = torch.from_numpy(np.array(st.feats))
    w = torch.from_numpy(_weights(rng, 27, 8, 8))
    f32 = tbc.band_conv(feats, tkeys, tplan, w, bf16=False)
    b16 = tbc.band_conv(feats, tkeys, tplan, w, bf16=True)
    np.testing.assert_allclose(b16.numpy(), f32.numpy(), atol=0.05,
                               rtol=0.02)
    assert not torch.equal(b16, f32)
