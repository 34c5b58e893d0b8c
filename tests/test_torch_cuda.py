"""The port's CUDA kernels vs their plain PyTorch versions on small random
inputs. Needs a CUDA device and skips without one. Imports no JAX, so on a
machine with a card and no JAX it runs as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(tests/conftest.py imports JAX). chip_smoke.py makes the same comparisons
at main-path shapes."""
import numpy as np
import pytest
import torch

import nms_cases
from virconv_tpu_torch.ops import band_conv as tbc
from virconv_tpu_torch.ops import boxes as tbox
from virconv_tpu_torch.ops import gather_conv as tgc
from virconv_tpu_torch.ops import nmap_conv as tnc
from virconv_tpu_torch.ops import onehot_conv as toc
from virconv_tpu_torch.ops import roi_pool as trp
from virconv_tpu_torch.ops import sparse as tsp

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def random_sparse(rng, batch, spatial, n_valid, capacity, channels):
    coords = set()
    while len(coords) < n_valid:
        coords.add((int(rng.integers(batch)),)
                   + tuple(int(rng.integers(s)) for s in spatial))
    c = np.full((capacity, len(spatial) + 1), -1, np.int32)
    c[:n_valid] = np.array(sorted(coords), np.int32)
    m = np.arange(capacity) < n_valid
    f = rng.standard_normal((capacity, channels)).astype(np.float32)
    f *= m[:, None]
    return tsp.sort_by_key(tsp.SparseTensor(
        torch.from_numpy(f), torch.from_numpy(c), torch.from_numpy(m),
        tuple(spatial), batch))


def _to(st, dev):
    return st.replace(feats=st.feats.to(dev), coords=st.coords.to(dev),
                      mask=st.mask.to(dev))


def _plan_to(plan, dev):
    return type(plan)(*[x.to(dev) if torch.is_tensor(x) else x
                        for x in plan])


@pytest.mark.parametrize('case', ['subm', 'strided', 'subm2d_dup'])
def test_band_conv_kernel_matches_plain(case):
    dev = _cuda()
    rng = np.random.default_rng(0)
    if case == 'subm2d_dup':
        n = 600
        c = np.stack([rng.integers(0, 2, n), rng.integers(0, 40, n),
                      rng.integers(0, 12, n)], -1).astype(np.int32)
        st = tsp.sort_by_key(tsp.SparseTensor(
            torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32)),
            torch.from_numpy(c), torch.ones(n, dtype=torch.bool), (40, 12),
            2))
        ctx_kw = dict(first_wins_sources=True)
        k = 9
    else:
        st = random_sparse(rng, 2, (6, 24, 20), 700, 768, 16)
        ctx_kw = {}
        k = 27
    w = torch.from_numpy((rng.standard_normal((k, 16 if k == 27 else 8, 24))
                          * 0.3).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 2, 24).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    if case == 'strided':
        out = tsp.downsample_coords(st, 2, 1, 3, 512)
        plan, keys = tsp.strided_band_plan(st, out, 2, 1, 3, tile=32,
                                           block=32)
    else:
        plan, keys = tsp.subm_band_plan(st, 3, tile=32, block=32)
    feats = st.feats
    if ctx_kw:
        first = torch.ones_like(keys, dtype=torch.bool)
        first[1:] = keys[1:] != keys[:-1]
        feats = feats * first[:, None]
    cplan = _plan_to(plan, dev)
    for bf16 in (False, True):
        want = tbc.band_conv(feats, keys, plan, w, scale, bias, True, bf16)
        n0 = tbc.launches
        got = tbc.band_conv(feats.to(dev), keys.to(dev), cplan, w.to(dev),
                            scale.to(dev), bias.to(dev), True, bf16)
        torch.cuda.synchronize()
        assert tbc.launches == n0 + 1
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('case,c,c_out,epilogue', [
    ('row', 8, 16, True), ('row_c8', 4, 8, False), ('tile_slab16', 16, 16,
                                                    True),
    ('tile_64', 64, 64, True), ('tile_two_slabs', 32, 72, True),
    ('tile_cin5', 5, 24, False)])
def test_band_conv_patch_equals_the_old_composition(case, c, c_out,
                                                    epilogue):
    """The gather patch joined to K1's call (row and tile modes; the fma
    mode takes inputs wider than K1's MAX_CIN, which K1 refuses) gives the
    bits of the composition it replaces: K1 without the patch, then
    ``nmap_conv`` over the patch map, the eager ``_epilogue`` and an index
    put, with bf16 and f32 operands; and it is within 1e-4 x the output
    scale of the plain version on the CPU. One K1 and one patch launch
    per call."""
    dev = _cuda()
    assert tgc.kernel_mode(c, c_out) == case.split('_')[0]
    rng = np.random.default_rng(sum(map(ord, case)))
    st = random_sparse(rng, 2, (6, 24, 20), 700, 768, c)
    plan, keys = tsp.subm_band_plan(st, 3, tile=32, block=32)
    pidx, pnmap = tsp._sized_patch(plan, lambda qk: tsp.lookup(keys, qk))
    assert not bool(plan.fits.all())
    w = torch.from_numpy((rng.standard_normal((27, c, c_out)) * 0.3)
                         .astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 2, c_out).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(c_out).astype(np.float32))
    epi = (scale, bias, True) if epilogue else (None, None, False)
    cplan = _plan_to(plan, dev)
    cepi = tuple(x.to(dev) if torch.is_tensor(x) else x for x in epi)
    args = (st.feats.to(dev), keys.to(dev), cplan, w.to(dev))
    patch = (pidx.to(dev), pnmap.to(dev))
    for bf16 in (False, True):
        n0, p0 = tbc.launches, tbc.patch_launches
        got = tbc.band_conv(*args, *cepi, bf16, patch)
        torch.cuda.synchronize()
        assert (tbc.launches - n0, tbc.patch_launches - p0) == (1, 1)
        old = tbc.band_conv(*args, *cepi, bf16)
        old[patch[0]] = tsp._epilogue(tnc.nmap_conv(args[0], patch[1],
                                                    args[3]),
                                      None, *cepi)
        assert torch.equal(got, old), case
        assert torch.equal(got, tbc.band_conv(*args, *cepi, bf16, patch))
        want = tbc.band_conv(st.feats, keys, plan, w, *epi, bf16,
                             (pidx, pnmap))
        np.testing.assert_allclose(
            got.cpu().numpy(), want.numpy(), rtol=0,
            atol=1e-4 * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize('case,c,c_out', [
    ('row', 8, 16), ('row_c4', 4, 8), ('tile_slab16', 16, 16),
    ('tile_64', 64, 64), ('tile_two_slabs', 32, 72), ('tile_cin5', 5, 24)])
def test_band_conv_bf16_features(case, c, c_out):
    """K1's bf16-feature mode (row and tile modes, with and without the
    gather patch, bf16 and f32 operands): bf16 rows give the bits of their
    f32 widening (the kernel widens them exactly), and bf16 output rows are
    the f32 output rounded to nearest even, bit for bit; against the plain
    version on the CPU within 1e-4 x the output scale before the bf16
    store and one bf16 ulp after it. One K1 launch per call, one patch
    launch when patched."""
    dev = _cuda()
    assert tgc.kernel_mode(c, c_out) == case.split('_')[0]
    rng = np.random.default_rng(sum(map(ord, case)) + 1)
    st = random_sparse(rng, 2, (6, 24, 20), 700, 768, c)
    plan, keys = tsp.subm_band_plan(st, 3, tile=32, block=32)
    pidx, pnmap = tsp._sized_patch(plan, lambda qk: tsp.lookup(keys, qk))
    assert not bool(plan.fits.all())
    w = torch.from_numpy((rng.standard_normal((27, c, c_out)) * 0.3)
                         .astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 2, c_out).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(c_out).astype(np.float32))
    rows = st.feats.to(torch.bfloat16)
    cplan = _plan_to(plan, dev)
    cargs = (keys.to(dev), cplan, w.to(dev), scale.to(dev), bias.to(dev),
             True)
    bf16_ulp = 2.0 ** -7
    for bf16 in (False, True):
        for patch in (None, (pidx, pnmap)):
            cpatch = None if patch is None else tuple(x.to(dev)
                                                      for x in patch)
            want = tbc.band_conv(rows, keys, plan, w, scale, bias, True,
                                 bf16, patch)
            scale_out = max(1.0, float(want.abs().max()))
            n0, p0 = tbc.launches, tbc.patch_launches
            f32_out = tbc.band_conv(rows.to(dev), *cargs, bf16, cpatch)
            b16_out = tbc.band_conv(rows.to(dev), *cargs, bf16, cpatch,
                                    out_dtype=torch.bfloat16)
            widened = tbc.band_conv(rows.float().to(dev), *cargs, bf16,
                                    cpatch)
            from_f32 = tbc.band_conv(st.feats.to(dev), *cargs, bf16, cpatch,
                                     out_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            assert tbc.launches - n0 == 4
            assert tbc.patch_launches - p0 == (0 if patch is None else 4)
            assert f32_out.dtype == torch.float32
            assert b16_out.dtype == from_f32.dtype == torch.bfloat16
            assert torch.equal(f32_out, widened), (case, bf16)
            assert torch.equal(b16_out, f32_out.to(torch.bfloat16))
            g32 = f32_out.cpu().numpy()
            np.testing.assert_allclose(g32, want.numpy(), rtol=0,
                                       atol=1e-4 * scale_out)
            g16 = b16_out.float().cpu().numpy()
            assert (np.abs(g16 - want.numpy()) <= bf16_ulp
                    * np.abs(want.numpy()) + 1e-4 * scale_out).all()
            want16 = tbc.band_conv(st.feats, keys, plan, w, scale, bias,
                                   True, bf16, patch,
                                   out_dtype=torch.bfloat16)
            w16 = want16.float().numpy()
            assert (np.abs(from_f32.float().cpu().numpy() - w16)
                    <= bf16_ulp * np.abs(w16) + 1e-4 * scale_out).all()


def test_band_conv_rejects_a_patch_that_disagrees():
    dev = _cuda()
    rng = np.random.default_rng(5)
    st = random_sparse(rng, 1, (4, 8, 8), 60, 64, 4)
    plan, keys = tsp.subm_band_plan(st, 3, tile=32, block=32)
    args = (st.feats.to(dev), keys.to(dev), _plan_to(plan, dev),
            torch.zeros(27, 4, 4, device=dev))
    idx = torch.arange(3, device=dev)
    for patch in ((idx, torch.zeros(3, 9, dtype=torch.int32, device=dev)),
                  (idx.int(), torch.zeros(3, 27, dtype=torch.int32,
                                          device=dev)),
                  (idx, torch.zeros(3, 27, dtype=torch.int64, device=dev))):
        with pytest.raises(ValueError):
            tbc.band_conv(*args, patch=patch)


@pytest.mark.parametrize('case', ['subm_patch_rows', 'wide64'])
def test_band_conv_dw_kernel_matches_plain(case):
    """K4 vs its plain version (atol 1e-4 x the output scale: f32 sums in
    another order), f32 and bf16 operands; two runs give the same bits."""
    dev = _cuda()
    rng = np.random.default_rng(3)
    if case == 'subm_patch_rows':
        st = random_sparse(rng, 2, (6, 24, 20), 700, 768, 8)
        plan, keys = tsp.subm_band_plan(st, 3, tile=32, block=32)
        assert not bool(plan.fits.all()), 'want non-fitting tiles'
        vb = torch.where(plan.fits[:, None], plan.valid_bits,
                         torch.zeros_like(plan.valid_bits))
        c_out = 12
    else:
        st = random_sparse(rng, 2, (10, 40, 40), 6000, 6144, 64)
        plan, keys = tsp.subm_band_plan(st, 3)
        vb, c_out = None, 64
    g = torch.from_numpy(rng.standard_normal(
        (plan.n_out, c_out)).astype(np.float32))
    cplan = _plan_to(plan, dev)
    cvb = None if vb is None else vb.to(dev)
    args = (st.feats.to(dev), keys.to(dev), cplan, g.to(dev), cvb)
    for bf16 in (False, True):
        want = tbc.band_conv_dw(st.feats, keys, plan, g, vb, bf16)
        n0 = tbc.dw_launches
        got = tbc.band_conv_dw(*args, bf16)
        again = tbc.band_conv_dw(*args, bf16)
        torch.cuda.synchronize()
        assert tbc.dw_launches == n0 + 2
        assert torch.equal(got, again)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


def test_band_train_conv_gradients_match_cpu():
    """The differentiable band conv on CUDA (K1 forward, K1 with transposed
    weights as the input gradient, K4 + patch rows for dW) vs the same conv
    on the CPU (plain versions), on a tensor with patch rows; value and
    input gradient at 1e-4, dW at atol 1e-3 / rtol 5e-3."""
    dev = _cuda()
    rng = np.random.default_rng(4)
    st = random_sparse(rng, 2, (6, 24, 20), 700, 768, 8)
    w = (rng.standard_normal((27, 8, 8)) * 0.3).astype(np.float32)
    cot = rng.standard_normal((768, 8)).astype(np.float32)
    res = {}
    for d in ('cpu', dev):
        s = _to(st, d)
        conv = tsp.subm_conv_ctx(s, 3, tile=32, block=32, train=True)
        f = s.feats.clone().requires_grad_(True)
        wt = torch.from_numpy(w).to(d).requires_grad_(True)
        n0, m0 = tbc.launches, tbc.dw_launches
        out = conv(f, wt)
        out.backward(torch.from_numpy(cot).to(d))
        if d != 'cpu':
            torch.cuda.synchronize()
            assert (tbc.launches - n0, tbc.dw_launches - m0) == (2, 1)
        res[str(d)] = [x.detach().cpu().numpy()
                       for x in (out, f.grad, wt.grad)]
    want, got = res['cpu'], res[str(dev)]
    for a, b, (atol, rtol) in zip(want, got, ((1e-4, 1e-4),) * 2
                                  + ((1e-3, 5e-3),)):
        np.testing.assert_allclose(b, a, atol=atol, rtol=rtol)


def test_band_conv_rejects_cpu_plan_with_cuda_feats():
    dev = _cuda()
    rng = np.random.default_rng(1)
    st = random_sparse(rng, 1, (4, 8, 8), 60, 64, 4)
    plan, keys = tsp.subm_band_plan(st, 3, tile=32, block=32)
    with pytest.raises(ValueError):
        tbc.band_conv(st.feats.to(dev), keys.to(dev), plan,
                      torch.zeros(27, 4, 4, device=dev))


def test_roi_pool_kernel_matches_plain_and_selects_identically():
    dev = _cuda()
    from virconv_tpu_torch.models.roi_heads.ted_head import dense_grid_points
    rng = np.random.default_rng(2)
    pcr, vox = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0), (0.1, 0.1, 0.1)
    st = random_sparse(rng, 2, (40, 160, 160), 4000, 4096, 8)
    # a dense cluster so some queries have more than nsample hits
    c = st.coords.clone()
    cell = np.array([20, 80, 80])
    zz, yy, xx = np.meshgrid(*[np.arange(-3, 4)] * 3, indexing='ij')
    blk = np.stack([np.zeros_like(zz), zz + cell[0], yy + cell[1],
                    xx + cell[2]], -1).reshape(-1, 4)
    c[:len(blk)] = torch.from_numpy(blk.astype(np.int32))
    st = tsp.sort_by_key(st.replace(coords=c))
    keys = st.keys()
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    st = tsp.sort_by_key(st.replace(mask=st.mask & first, coords=torch.where(
        (st.mask & first)[:, None], st.coords, -1)))
    g = 4
    rois = np.zeros((8, 7), np.float32)
    rois[:, 0] = rng.uniform(2, 14, 8)
    rois[:, 1] = rng.uniform(-6, 6, 8)
    rois[:, 3:6] = rng.uniform(1.5, 4.5, (8, 3))
    rois[:, 6] = rng.uniform(-np.pi, np.pi, 8)
    rois[0, :3] = (8.05, 0.05, -0.95)
    qxyz = dense_grid_points(torch.from_numpy(rois), g).reshape(-1, 3)
    cells = torch.floor((qxyz - torch.tensor(pcr[:3])) /
                        torch.tensor(vox)).to(torch.int32)
    qc = torch.cat([torch.zeros((len(qxyz), 1), dtype=torch.int32),
                    cells[:, [2, 1, 0]]], 1)
    qmask = torch.ones(len(qxyz), dtype=torch.bool)
    specs = (((2, 2, 2), 0.4, 8), ((4, 4, 4), 0.8, 8))
    fg = [torch.from_numpy(rng.standard_normal((4096, 8)).astype(np.float32))
          for _ in specs]
    we = [torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
          for _ in specs]
    be = [torch.from_numpy(rng.standard_normal(8).astype(np.float32))
          for _ in specs]
    kw = dict(cblk=64, nslab=64, nblk_cap=64)
    plan = trp.roi_pool_plan(st, qxyz, qc, qmask, g ** 3, specs[-1][0], vox,
                             1, pcr, **kw)
    assert bool(plan.ok)
    cplan = trp.roi_pool_plan(_to(st, dev), qxyz.to(dev), qc.to(dev),
                              qmask.to(dev), g ** 3, specs[-1][0], vox, 1,
                              pcr, **kw)
    args_d = ([f.to(dev) for f in fg], [w.to(dev) for w in we],
              [b.to(dev) for b in be], specs, vox, 1, pcr)
    want_sel = trp.roi_pool_selection(plan, specs, vox, 1, pcr)
    got_sel = trp.roi_pool_kernel_selection(cplan, *args_d)
    for a, b in zip(want_sel, got_sel):
        assert torch.equal(a, b.cpu())
    assert any(bool((s >= 0).all(1).any()) for s in want_sel)
    for bf16 in (False, True):
        want = trp.roi_pool_apply(plan, fg, we, be, specs, vox, 1, pcr, bf16)
        got = trp.roi_pool_apply(cplan, *args_d, bf16=bf16)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-5, rtol=1e-5)


def _near_diagonal(rng, n, k, spread, p_valid=0.8):
    idx = np.arange(n)[:, None] + rng.integers(-spread, spread + 1, (n, k))
    return np.where(rng.random((n, k)) < p_valid, np.clip(idx, 0, n - 1),
                    -1).astype(np.int32)


@pytest.mark.parametrize('case', ['k5_k3', 'k5_k27_wide', 'k6_k9_ragged',
                                  'k6_k27_wide'])
def test_gather_conv_kernels_match_plain(case):
    """K5 and K6 vs their plain versions: identical misses, outputs within
    1e-4 x the output scale (f32 sums in another order); K6 with bf16 and
    f32 operands and rows past a multiple of block (its padded tail); two
    runs give identical misses and the same bits."""
    dev = _cuda()
    k, n, spread, c, c_out = {'k5_k3': (3, 1024, 384, 8, 8),
                              'k5_k27_wide': (27, 1024, 900, 40, 72),
                              'k6_k9_ragged': (9, 700, 150, 8, 12),
                              'k6_k27_wide': (27, 1100, 300, 64, 64)}[case]
    rng = np.random.default_rng(k + n)
    nmap = torch.from_numpy(_near_diagonal(rng, n, k, spread))
    feats = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, c, c_out)) * 0.3)
                         .astype(np.float32))
    if case.startswith('k5'):
        mod, modes = tgc, [dict(tile=128 if k == 3 else 32)]
        fn = tgc.fused_gather_conv
    else:
        mod, fn = toc, toc.onehot_gather_conv
        modes = [dict(tile=64, block=128, bf16=b) for b in (False, True)]
    args = (feats.to(dev), nmap.to(dev), w.to(dev))
    for kw in modes:
        want = fn(feats, nmap, w, **kw)
        n0 = mod.launches
        got = fn(*args, **kw)
        again = fn(*args, **kw)
        torch.cuda.synchronize()
        assert mod.launches == n0 + 2
        assert torch.equal(got[1], again[1]) and torch.equal(got[0], again[0])
        np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
        assert int(want[1].sum()) > 0
        np.testing.assert_allclose(
            got[0].cpu().numpy(), want[0].numpy(), rtol=0,
            atol=1e-4 * max(1.0, float(want[0].abs().max())))


def test_gather_conv_kernels_reject_bad_cuda_operands():
    """A CUDA tensor the kernels do not take raises; nothing falls back."""
    dev = _cuda()
    feats = torch.zeros(512, 4, device=dev)
    nmap = torch.full((512, 3), -1, dtype=torch.int64, device=dev)
    w = torch.zeros(3, 4, 4, device=dev)
    before = tgc.launches, toc.launches
    with pytest.raises(ValueError):
        tgc.fused_gather_conv(feats, nmap, w, 128)
    with pytest.raises(ValueError):
        toc.onehot_gather_conv(feats, nmap, w, 64, 128)
    assert (tgc.launches, toc.launches) == before


def test_gather_conv_entries_refuse_a_mode_not_their_rule():
    """The C entry points of K5 and K6 take only the mode their widths give
    (``kernel_mode``): any other returns -1 before a launch."""
    import ctypes
    from virconv_tpu_torch.ops import _cuda as cu
    dev = _cuda()
    lib = cu.load('gather_conv')
    n, k, tile = 512, 3, 128
    feats = torch.zeros(n, 8, device=dev)
    nmap = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    w = torch.zeros(k, 8, 16, device=dev)
    out = torch.empty(n, 16, device=dev)
    misses = torch.zeros(n // tile, dtype=torch.int32, device=dev)
    blk = torch.zeros(n // tile + 2, k, dtype=torch.int32, device=dev)
    wprep = torch.empty(1 << 16, dtype=torch.uint8, device=dev)
    p = [cu.ptr(t) for t in (feats, nmap, w, wprep, out, misses, blk)]
    k5, k6 = lib.gather_conv_fwd, lib.onehot_conv_fwd
    k5.restype = k6.restype = ctypes.c_int
    k5.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 4)
    k6.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p] * 4)
    stream = cu.stream_ptr(dev)
    assert tgc.kernel_mode(8, 16) == 'row'
    for mode in ('fma', 'tile'):
        m = tgc.MODES[mode]
        assert k5(p[0], p[1], p[2], n, 8, 16, k, tile, m, p[3], p[4], p[5],
                  stream) == -1
        for bf16 in (0, 1):
            assert k6(p[0], p[1], p[2], p[6], n, 8, 16, k, tile, tile, bf16,
                      m, p[3], p[4], p[5], stream) == -1
    torch.cuda.synchronize()


def _band_edge_case(case):
    """(feats, keys, plan, weights) of one K1 edge case at the main path's
    geometry (tile 128: two 64-row CTAs per tile; block 256)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    c_in, c_out, n_valid, cap = {
        'cout8': (16, 8, 1500, 1536), 'cout16': (16, 16, 1500, 1536),
        'cout24': (16, 24, 1500, 1536), 'cout128': (32, 128, 1500, 1536),
        'cin8': (8, 16, 1500, 1536), 'cin128': (128, 32, 1500, 1536),
        'cin6': (6, 8, 1500, 1536), 'cin18': (18, 24, 1500, 1536),
        'wide64': (64, 64, 6000, 6144),
        'half_tile_invalid': (16, 16, 1500, 1536),
        'tap_unhit': (16, 16, 1500, 1536), 'ragged': (16, 24, 650, 700),
        'dgrad': (40, 24, 1500, 1536)}.get(case, (16, 16, 0, 0))
    if case == 'dup_first_wins':
        n = 1400
        c = np.stack([rng.integers(0, 2, n), rng.integers(0, 60, n),
                      rng.integers(0, 16, n)], -1).astype(np.int32)
        st = tsp.sort_by_key(tsp.SparseTensor(
            torch.from_numpy(rng.standard_normal((n, c_in)).astype(
                np.float32)), torch.from_numpy(c),
            torch.ones(n, dtype=torch.bool), (60, 16), 2))
        plan, keys = tsp.subm_band_plan(st, 3)
        first = torch.ones_like(keys, dtype=torch.bool)
        first[1:] = keys[1:] != keys[:-1]
        assert not bool(first.all()), 'want duplicate keys'
        feats = st.feats * first[:, None]
        k = 9
    else:
        st = random_sparse(rng, 2, (8, 30, 30), n_valid, cap, c_in)
        plan, keys = tsp.subm_band_plan(st, 3)
        feats, k = st.feats, 27
    if case == 'half_tile_invalid':
        vb = plan.valid_bits.clone()
        vb[0, 64:] = 0           # the second CTA of tile 0 has no valid row
        plan = plan._replace(valid_bits=vb)
    if case == 'tap_unhit':
        vb = plan.valid_bits.clone()
        vb[:, :64] &= ~((1 << 13) | 1)   # no row of a first half hits 0, 13
        plan = plan._replace(valid_bits=vb)
    if case == 'dgrad':      # the input-gradient call: W[K-1-k]^T
        w = (rng.standard_normal((k, c_out, c_in)) * 0.3).astype(np.float32)
        w = np.ascontiguousarray(w[::-1].transpose(0, 2, 1))
    else:
        w = (rng.standard_normal((k, c_in, c_out)) * 0.3).astype(np.float32)
    return feats, keys, plan, torch.from_numpy(w)


@pytest.mark.parametrize('case', [
    'cout8', 'cout16', 'cout24', 'cout128', 'cin8', 'cin128', 'cin6',
    'cin18', 'wide64', 'half_tile_invalid', 'tap_unhit', 'ragged',
    'dup_first_wins', 'dgrad'])
def test_band_conv_kernel_edge_cases(case):
    """K1 vs its plain version at tile 128 / block 256, f32 and bf16
    operands, with and without the affine + ReLU epilogue: partial and
    double output slabs, narrow and wide inputs (and two not a multiple of
    4: row and tile mode), a half tile with no valid row, taps no row of a
    half tile hits,
    n_out not a multiple of the tile, first-wins duplicates and the
    transposed input-gradient weights. Tolerance 1e-4 x the output scale
    (sums in another order)."""
    dev = _cuda()
    feats, keys, plan, w = _band_edge_case(case)
    c_out = w.shape[2]
    rng = np.random.default_rng(5)
    scale = torch.from_numpy(rng.uniform(0.5, 2, c_out).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(c_out).astype(np.float32))
    cplan = _plan_to(plan, dev)
    for bf16 in (False, True):
        for epi in ((None, None, False), (scale, bias, True)):
            want = tbc.band_conv_plain(feats, keys, plan, w, *epi, bf16)
            n0 = tbc.launches
            got = tbc.band_conv(feats.to(dev), keys.to(dev), cplan,
                                w.to(dev), *[None if x is None else x.to(dev)
                                             for x in epi[:2]],
                                epi[2], bf16)
            torch.cuda.synchronize()
            assert tbc.launches == n0 + 1
            assert got.shape == want.shape == (plan.n_out, c_out)
            np.testing.assert_allclose(
                got.cpu().numpy(), want.numpy(), rtol=0,
                atol=1e-4 * max(1.0, float(want.abs().max())))
    if case == 'half_tile_invalid':
        assert not bool(got[64:128].cpu().any())


def _pool_scene(grid, rng):
    """A sparse grid with a dense 7^3 cluster (so the nsample truncation
    binds), a cell-free box around one ROI (no candidates), an ROI with no
    valid query and random invalid queries; the main path's group specs
    (ranges 2 and 4, nsample 16)."""
    from virconv_tpu_torch.models.roi_heads.ted_head import dense_grid_points
    pcr, vox = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0), (0.1, 0.1, 0.1)
    cells = np.stack([rng.integers(0, 40, 4000), rng.integers(0, 160, 4000),
                      rng.integers(0, 160, 4000)], -1)
    empty = (np.abs(cells[:, 1] - 140) < 20) & (np.abs(cells[:, 2] - 140) < 20)
    cells = cells[~empty]
    zz, yy, xx = np.meshgrid(*[np.arange(-3, 4)] * 3, indexing='ij')
    cluster = np.stack([zz + 20, yy + 80, xx + 80], -1).reshape(-1, 3)
    cells = np.unique(np.concatenate([cluster, cells]), axis=0)
    n = len(cells)
    coords = np.concatenate([np.zeros((n, 1), np.int64), cells], 1)
    st = tsp.sort_by_key(tsp.SparseTensor(
        torch.zeros((n, 1)), torch.from_numpy(coords.astype(np.int32)),
        torch.ones(n, dtype=torch.bool), (40, 160, 160), 1))
    rois = np.zeros((8, 7), np.float32)
    rois[:, 0] = rng.uniform(2, 12, 8)
    rois[:, 1] = rng.uniform(-6, 4, 8)
    rois[:, 2] = rng.uniform(-2.5, 0.5, 8)
    rois[:, 3:6] = rng.uniform(0.6, 1.6, (8, 3))
    rois[:, 6] = rng.uniform(-np.pi, np.pi, 8)
    rois[0, :3] = (8.05, 0.05, -0.95)       # on the cluster
    rois[1, :3] = (14.05, 6.05, -0.95)      # in the cell-free box
    qxyz = dense_grid_points(torch.from_numpy(rois), grid).reshape(-1, 3)
    qcell = torch.floor((qxyz - torch.tensor(pcr[:3]))
                        / torch.tensor(vox)).to(torch.int32)
    qc = torch.cat([torch.zeros((len(qxyz), 1), dtype=torch.int32),
                    qcell[:, [2, 1, 0]]], 1)
    q = grid ** 3
    qmask = torch.from_numpy(rng.random(len(qxyz)) > 0.1)
    qmask[2 * q:3 * q] = False              # an ROI with no valid query
    specs = (((2, 2, 2), 0.4, 16), ((4, 4, 4), 0.8, 16))
    return st, qxyz, qc, qmask, q, specs, vox, pcr


@pytest.mark.parametrize('grid', [6, 4])
def test_roi_pool_kernel_edge_cases(grid):
    """K2+K3 vs the plain version at Q = 216 and Q = 64 with the main
    path's specs: identical selections (sel_out) where the nsample
    truncation binds, an ROI with no candidates, an ROI with no valid
    query and random invalid queries; pooled features within 1e-5 with f32
    and bf16 features; zeros where nothing is selected."""
    dev = _cuda()
    rng = np.random.default_rng(grid)
    st, qxyz, qc, qmask, q, specs, vox, pcr = _pool_scene(grid, rng)
    mid = 32
    fg = [torch.from_numpy(rng.standard_normal((st.feats.shape[0], mid))
                           .astype(np.float32)) for _ in specs]
    we = [torch.from_numpy(rng.standard_normal((3, mid)).astype(np.float32))
          for _ in specs]
    be = [torch.from_numpy(rng.standard_normal(mid).astype(np.float32))
          for _ in specs]
    plan = trp.roi_pool_plan(st, qxyz, qc, qmask, q, specs[-1][0], vox, 1,
                             pcr)
    assert bool(plan.ok)
    cplan = trp.roi_pool_plan(_to(st, dev), qxyz.to(dev), qc.to(dev),
                              qmask.to(dev), q, specs[-1][0], vox, 1, pcr)
    want_sel = trp.roi_pool_selection(plan, specs, vox, 1, pcr)
    wide = tuple((rg, rad, 32) for rg, rad, _ in specs)
    assert any(bool(((s >= 0).sum(1) > 16).any()) for s in
               trp.roi_pool_selection(plan, wide, vox, 1, pcr)), \
        'want a query whose hits exceed nsample'
    args_d = ([f.to(dev) for f in fg], [w.to(dev) for w in we],
              [b.to(dev) for b in be], specs, vox, 1, pcr)
    got_sel = trp.roi_pool_kernel_selection(cplan, *args_d)
    for a, b in zip(want_sel, got_sel):
        assert torch.equal(a, b.cpu())
    empty = [int((s[q:2 * q] >= 0).sum()) for s in want_sel]
    assert empty == [0, 0], 'want an ROI with no candidates'
    for bf16 in (False, True):
        want = trp.roi_pool_apply(plan, fg, we, be, specs, vox, 1, pcr, bf16)
        n0 = trp.launches
        got = trp.roi_pool_apply(cplan, *args_d, bf16=bf16)
        torch.cuda.synchronize()
        assert trp.launches == n0 + 1
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-5, rtol=1e-5)
        assert not bool(got[:, q:3 * q].cpu().any())
        assert not bool(got[:, ~qmask.to(dev)].cpu().any())


@pytest.mark.parametrize('grid', [6, 4])
def test_roi_pool_kernel_tiled_layout(grid):
    """K2+K3 on ``VIRCONV_POOL_TILE``'s quadrant segments (Q = 56 or 16
    per segment, 4 segments per ROI, per-tile pad queries masked off, the
    tiled plan's cap of 3 blocks per segment): selections identical to the
    plain version's, features within 1e-5, and un-tiled, bit for bit the
    untiled kernel call's."""
    from virconv_tpu_torch.models.roi_heads.voxel_pool import _tile_layout
    dev = _cuda()
    rng = np.random.default_rng(grid + 20)
    st, qxyz, qc, qmask, q, specs, vox, pcr = _pool_scene(grid, rng)
    gather, tval, inv, qp = (torch.as_tensor(v) for v in _tile_layout(grid))
    r0 = qxyz.shape[0] // q
    tx = qxyz.reshape(r0, q, 3)[:, gather].reshape(-1, 3)
    tc = qc.reshape(r0, q, 4)[:, gather].reshape(-1, 4)
    tm = (qmask.reshape(r0, q)[:, gather] & tval[None]).reshape(-1)
    mid = 32
    fg = [torch.from_numpy(rng.standard_normal((st.feats.shape[0], mid))
                           .astype(np.float32)).to(dev) for _ in specs]
    we = [torch.from_numpy(rng.standard_normal((3, mid)).astype(np.float32))
          .to(dev) for _ in specs]
    be = [torch.from_numpy(rng.standard_normal(mid).astype(np.float32))
          .to(dev) for _ in specs]
    std = _to(st, dev)
    tplan = trp.roi_pool_plan(std, tx.to(dev), tc.to(dev), tm.to(dev),
                              int(qp), specs[-1][0], vox, 1, pcr,
                              nblk_cap=3 * 4 * r0 + 32)
    plan = trp.roi_pool_plan(std, qxyz.to(dev), qc.to(dev), qmask.to(dev),
                             q, specs[-1][0], vox, 1, pcr,
                             nblk_cap=64 * r0 + 64)
    assert bool(tplan.ok) and bool(plan.ok)
    assert (tplan.n_roi, tplan.q_per_roi) == (4 * r0, int(qp))
    args = (fg, we, be, specs, vox, 1, pcr)
    for a, b in zip(trp.roi_pool_selection(tplan, specs, vox, 1, pcr),
                    trp.roi_pool_kernel_selection(tplan, *args)):
        assert torch.equal(a, b)
    for bf16 in (False, True):
        got = trp.roi_pool_apply(tplan, *args, bf16=bf16)
        want = trp.roi_pool_plain(tplan, *args, bf16=bf16)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-5, rtol=1e-5)
        untiled = trp.roi_pool_apply(plan, *args, bf16=bf16)
        got = got.reshape(len(specs), r0, -1, mid)[:, :, inv.to(dev)]
        assert torch.equal(got.reshape(untiled.shape).view(torch.int32),
                           untiled.view(torch.int32))


def _dw_edge_case(case):
    """(feats, keys, plan, g, valid_bits) of one K4 edge case at the
    training geometry (tile 128, block 256)."""
    rng = np.random.default_rng(sum(map(ord, case)) + 11)
    c_in, c_out, n_valid, cap = {
        'cout1': (16, 1, 1500, 1536), 'cin6': (6, 16, 1500, 1536),
        'cin8_cout16': (8, 16, 1500, 1536), 'cin16': (16, 16, 1500, 1536),
        'wide64': (64, 64, 6000, 6144), 'cin128': (128, 24, 1500, 1536),
        'cin128_cout64': (128, 64, 1500, 1536),
        'cout72': (16, 72, 1500, 1536), 'no_hit_tiles': (16, 16, 6000, 6144),
        'ragged': (16, 24, 5950, 6000), 'override': (36, 40, 1500, 1536),
        'misaligned': (16, 16, 1500, 1536)}[case]
    st = random_sparse(rng, 2, (10, 40, 40), n_valid, cap, c_in)
    plan, keys = tsp.subm_band_plan(st, 3)
    feats, vb = st.feats, None
    if case == 'no_hit_tiles':       # whole chunks without a valid row
        vb = plan.valid_bits.clone()
        vb[:12] = 0
    if case == 'override':           # callers zero non-fitting tiles' rows
        vb = plan.valid_bits.clone()
        vb[1::3] = 0
        vb[:, ::5] &= ~(1 << 4)
    g = torch.from_numpy(rng.standard_normal(
        (plan.n_out, c_out)).astype(np.float32))
    return feats, keys, plan, g, vb


@pytest.mark.parametrize('case', [
    'cout1', 'cin6', 'cin8_cout16', 'cin16', 'wide64', 'cin128',
    'cin128_cout64', 'cout72', 'no_hit_tiles', 'ragged', 'override',
    'misaligned'])
def test_band_conv_dw_kernel_edge_cases(case):
    """K4 vs its plain version at tile 128 / block 256, f32 and bf16
    operands, each run twice with identical bits: one output channel,
    inputs not a multiple of 4 and a feats pointer off 16 bytes (4-byte
    copies), narrow blocks (4 x 4 micro-tiles, many thread groups over the
    hit rows), 64 -> 64 (8 x 8), 128 input channels (one thread group of
    4 x 4 tiles; 8 x 8 with 64 outputs), two output slabs, widths that
    pad the 8 x 8 tiles (36 -> 40), chunks with no hit row, a row count
    that ends mid-tile and mid-chunk, and valid_bits overrides. Tolerance
    1e-4 x max(1, the output scale): f32 sums in another order."""
    dev = _cuda()
    feats, keys, plan, g, vb = _dw_edge_case(case)
    n_tiles = plan.base_keys.shape[0]
    per_chunk = tbc.dw_tiles_per_chunk(n_tiles, plan.tile, len(plan.deltas),
                                       g.shape[1])
    if case == 'ragged':
        assert plan.n_out % plan.tile and n_tiles % per_chunk
    cf = feats.to(dev)
    if case == 'misaligned':
        buf = torch.zeros(cf.numel() + 1, device=dev)
        buf[1:] = cf.reshape(-1)
        cf = buf[1:].view(cf.shape)
        assert cf.is_contiguous() and cf.data_ptr() % 16
    cplan = _plan_to(plan, dev)
    args = (cf, keys.to(dev), cplan, g.to(dev),
            None if vb is None else vb.to(dev))
    for bf16 in (False, True):
        want = tbc.band_conv_dw_plain(feats, keys, plan, g, vb, bf16)
        n0 = tbc.dw_launches
        got = tbc.band_conv_dw(*args, bf16)
        again = tbc.band_conv_dw(*args, bf16)
        torch.cuda.synchronize()
        assert tbc.dw_launches == n0 + 2
        assert torch.equal(got, again)
        assert got.shape == want.shape
        np.testing.assert_allclose(
            got.cpu().numpy(), want.numpy(), rtol=0,
            atol=1e-4 * max(1.0, float(want.abs().max())))
    if case == 'no_hit_tiles':
        assert float(want.abs().max()) > 0


@pytest.mark.parametrize('case', [
    'cout12', 'cout72', 'cin5', 'row_cin8', 'row_cin3', 'misses',
    'past_end', 'empty_tap', 'wide64_default_geometry'])
def test_onehot_conv_bf16_edge_cases(case):
    """K6's modes, with bf16 and f32 operands, vs the plain version: output slabs not a multiple of 8 and two slabs, an input width
    not a multiple of 4, row mode (C <= 8, C' <= 16), rows with misses
    (identical counts), window indices in the zero padding past the
    feature rows (no misses), a tap no row hits, and the default tile 256 /
    block 2048. Each run twice with identical bits; outputs within 1e-4 x
    max(1, the output scale)."""
    dev = _cuda()
    k, n, spread, c, c_out, tile, block, mode = {
        'cout12': (27, 1100, 300, 16, 12, 64, 128, 'tile'),
        'cout72': (9, 900, 150, 32, 72, 64, 128, 'tile'),
        'cin5': (9, 900, 150, 5, 24, 64, 128, 'tile'),
        'row_cin8': (27, 1100, 150, 8, 16, 64, 128, 'row'),
        'row_cin3': (9, 700, 150, 3, 5, 64, 128, 'row'),
        'misses': (27, 1100, 300, 16, 16, 64, 128, 'tile'),
        'past_end': (9, 700, 100, 16, 8, 64, 128, 'tile'),
        'empty_tap': (27, 1100, 100, 8, 8, 64, 128, 'row'),
        'wide64_default_geometry': (27, 6000, 900, 64, 64, 256, 2048,
                                    'tile')}[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    nmap = _near_diagonal(rng, n, k, spread)
    if case == 'empty_tap':
        nmap[:, 5] = -1
    if case == 'past_end':         # padding rows of the last block
        nmap[-40:, 2] = n + rng.integers(0, 30, 40)
    nmap = torch.from_numpy(nmap)
    feats = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, c, c_out)) * 0.3)
                         .astype(np.float32))
    args = (feats.to(dev), nmap.to(dev), w.to(dev), tile, block)
    for bf16 in (True, False):
        assert toc.kernel_mode(c, c_out, bf16) == mode
        key = f'{mode} {"bf16" if bf16 else "f32"}'
        want = toc.onehot_gather_conv(feats, nmap, w, tile, block, bf16)
        n0, m0 = toc.launches, toc.mode_launches[key]
        got = toc.onehot_gather_conv(*args, bf16)
        again = toc.onehot_gather_conv(*args, bf16)
        torch.cuda.synchronize()
        assert toc.launches == n0 + 2 and toc.mode_launches[key] == m0 + 2
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
        np.testing.assert_allclose(
            got[0].cpu().numpy(), want[0].numpy(), rtol=0,
            atol=1e-4 * max(1.0, float(want[0].abs().max())))
        if case == 'misses':
            assert int(want[1].sum()) > 0
        if case == 'past_end':
            blk, nm = toc.window_blocks(nmap, tile, block)
            local = nm[..., 2] - blk[:, None, 2].long() * block
            assert bool(((nm[..., 2] >= n) & (local >= 0)
                         & (local < 2 * block)).any())


@pytest.mark.parametrize('case', [
    'row_cin8', 'row_cin3', 'cout12', 'cout72', 'cin5', 'misses_tile32',
    'row_misses_tile32', 'cin130', 'empty_tap', 'wide64_default_geometry'])
def test_gather_conv_edge_cases(case):
    """K5's modes vs the plain version: row mode (C <= 8, C' <= 16), tile
    mode with a 12-wide slab (the narrow instantiation) and with two slabs
    (C' = 72), an input width not a multiple of 4 (4-byte copies), tile 32
    (a CTA spans several row tiles) on maps with misses in both modes
    (identical counts), an input wider than MAX_CIN (the fma mode), a
    tap no row hits, and the default tile 512. Each run twice with
    identical bits; outputs within 1e-4 x max(1, the output scale)."""
    dev = _cuda()
    k, n, spread, c, c_out, tile, mode = {
        'row_cin8': (27, 1024, 150, 8, 16, 32, 'row'),
        'row_cin3': (9, 768, 100, 3, 5, 64, 'row'),
        'cout12': (27, 1024, 300, 16, 12, 32, 'tile'),
        'cout72': (9, 1024, 150, 32, 72, 64, 'tile'),
        'cin5': (9, 1024, 150, 5, 24, 64, 'tile'),
        'misses_tile32': (27, 1024, 700, 16, 16, 32, 'tile'),
        'row_misses_tile32': (27, 1024, 700, 8, 8, 32, 'row'),
        'cin130': (9, 640, 100, 130, 24, 64, 'fma'),
        'empty_tap': (27, 1024, 100, 16, 16, 32, 'tile'),
        'wide64_default_geometry': (27, 27 * 512, 900, 64, 64, 512,
                                    'tile')}[case]
    assert tgc.kernel_mode(c, c_out) == mode
    rng = np.random.default_rng(sum(map(ord, case)))
    nmap = _near_diagonal(rng, n, k, spread)
    if case == 'empty_tap':
        nmap[:, 5] = -1
    nmap = torch.from_numpy(nmap)
    feats = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, c, c_out)) * 0.3)
                         .astype(np.float32))
    want = tgc.fused_gather_conv(feats, nmap, w, tile)
    args = (feats.to(dev), nmap.to(dev), w.to(dev), tile)
    n0, m0 = tgc.launches, tgc.mode_launches[mode]
    got = tgc.fused_gather_conv(*args)
    again = tgc.fused_gather_conv(*args)
    torch.cuda.synchronize()
    assert tgc.launches == n0 + 2 and tgc.mode_launches[mode] == m0 + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
    np.testing.assert_allclose(
        got[0].cpu().numpy(), want[0].numpy(), rtol=0,
        atol=1e-4 * max(1.0, float(want[0].abs().max())))
    if 'misses' in case:
        assert int(want[1].sum()) > 0
    if case == 'empty_tap':
        assert float(want[0].abs().max()) > 0


@pytest.mark.parametrize('case', [
    'row_k27', 'tile_k27_fewer_rows', 'tile_k9_more_rows', 'tile_k3_cout72',
    'cin5', 'fma_cin130', 'empty'])
def test_nmap_conv_edge_cases(case):
    """The exact conv from a neighbor map vs its plain version: each mode
    (row, tile, fma), fewer and more output rows than feature rows (a
    patch, a strided map), K = 27, 9 and 3, an input width not a multiple
    of 4, a map with no output row (no launch). Each run twice with
    identical bits, and the bits of the body it had before its tile mode
    was redesigned (``nmap_conv_prev``); outputs within 1e-4 x max(1, the
    output scale)."""
    dev = _cuda()
    k, n_in, n_out, c, c_out, mode = {
        'row_k27': (27, 1000, 1000, 8, 16, 'row'),
        'tile_k27_fewer_rows': (27, 4000, 333, 64, 64, 'tile'),
        'tile_k9_more_rows': (9, 500, 1500, 16, 32, 'tile'),
        'tile_k3_cout72': (3, 900, 600, 32, 72, 'tile'),
        'cin5': (27, 700, 700, 5, 24, 'tile'),
        'fma_cin130': (9, 640, 640, 130, 24, 'fma'),
        'empty': (27, 100, 0, 16, 16, 'tile')}[case]
    assert tgc.kernel_mode(c, c_out) == mode
    rng = np.random.default_rng(sum(map(ord, case)))
    nmap = torch.from_numpy(np.where(
        rng.random((n_out, k)) < 0.7, rng.integers(0, n_in, (n_out, k)),
        -1).astype(np.int32))
    feats = torch.from_numpy(rng.standard_normal((n_in, c)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((k, c, c_out)) * 0.3)
                         .astype(np.float32))
    want = tnc.nmap_conv_plain(feats, nmap, w)
    args = (feats.to(dev), nmap.to(dev), w.to(dev))
    n0 = tnc.launches
    got = tnc.nmap_conv(*args)
    again = tnc.nmap_conv(*args)
    prev = tnc.nmap_conv_prev(*args)
    torch.cuda.synchronize()
    assert tnc.launches == n0 + (2 if n_out else 0)
    assert got.shape == (n_out, c_out) and torch.equal(got, again)
    # the redesigned tile body gives the previous body's bits
    assert torch.equal(got.view(torch.int32), prev.view(torch.int32))
    np.testing.assert_allclose(
        got.cpu().numpy(), want.numpy(), rtol=0,
        atol=1e-4 * max(1.0, float(want.abs().max()) if n_out else 0.0))


@pytest.mark.parametrize('case', [
    'empty', 'all_missing', 'hot_row', 'k3_c8', 'k9_c16_c64', 'k27_c32',
    'k27_c64', 'k3_c64_c128', 'cin128'])
def test_nmap_conv_dw_edge_cases(case):
    """The neighbor-map weight gradient (a source pass, K4's sums, the
    in-order partial sum) vs its plain version: no output row, a map with
    every tap missing (dW zeros), a hot source row read by every output
    row, K = 3, 9 and 27, C and C' of 8 to 128 (two output slabs at 128),
    row counts that end mid-chunk. Each run twice with identical bits;
    within 1e-4 x max(1, the dW scale): f32 sums in another order."""
    dev = _cuda()
    k, n_in, n_out, c, c_out = {
        'empty': (27, 100, 0, 16, 16), 'all_missing': (27, 500, 700, 16, 32),
        'hot_row': (9, 300, 3000, 32, 32), 'k3_c8': (3, 900, 2500, 8, 8),
        'k9_c16_c64': (9, 1000, 2100, 16, 64),
        'k27_c32': (27, 4000, 4500, 32, 32),
        'k27_c64': (27, 6000, 5000, 64, 64),
        'k3_c64_c128': (3, 3000, 2000, 64, 128),
        'cin128': (27, 800, 900, 128, 64)}[case]
    rng = np.random.default_rng(sum(map(ord, case)) + 5)
    nmap = np.where(rng.random((n_out, k)) < 0.4,
                    rng.integers(0, n_in, (n_out, k)), -1).astype(np.int32)
    if case == 'all_missing':
        nmap[:] = -1
    if case == 'hot_row':
        nmap[:, 4] = 7
    nmap = torch.from_numpy(nmap)
    feats = torch.from_numpy(rng.standard_normal((n_in, c)).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((n_out, c_out)).astype(
        np.float32))
    chunk = tnc.dw_chunk_rows(n_out, k, c_out)
    if case in ('k27_c32', 'k27_c64'):
        assert n_out % chunk and n_out > chunk
    want = tnc.nmap_conv_dw_plain(feats, nmap, g)
    args = (feats.to(dev), nmap.to(dev), g.to(dev))
    n0 = tnc.dw_launches
    got = tnc.nmap_conv_dw(*args)
    again = tnc.nmap_conv_dw(*args)
    torch.cuda.synchronize()
    assert tnc.dw_launches == n0 + 2
    assert got.shape == (k, c, c_out)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    np.testing.assert_allclose(
        got.cpu().numpy(), want.numpy(), rtol=0,
        atol=1e-4 * max(1.0, float(want.abs().max())))
    if case in ('empty', 'all_missing'):
        assert not bool(got.any())


@pytest.mark.parametrize('case', ['subm', 'strided'])
def test_nmap_train_conv_gradients_match_cpu(case):
    """The training neighbor-map conv on CUDA (``nmap_conv`` forward and
    input gradient, ``nmap_conv_dw``) vs the same conv on the CPU (plain
    versions): value and input gradient within 1e-4, dW within 1e-3 x its
    scale (chip_smoke phase 7's gradient rule); one launch of each
    product."""
    dev = _cuda()
    rng = np.random.default_rng(6)
    st = random_sparse(rng, 2, (8, 24, 20), 1500, 1536, 16)
    k = 27
    w = (rng.standard_normal((k, 16, 32)) * 0.3).astype(np.float32)
    res = {}
    for d in ('cpu', dev):
        s = _to(st, d)
        if case == 'subm':
            conv = tsp.nmap_subm_conv_ctx(s, 3)
            n_out = s.capacity
        else:
            out_st = tsp.downsample_coords(s, 2, 1, 3, 1024)
            conv = tsp.nmap_strided_conv_ctx(s, out_st, 2, 1, 3)
            n_out = out_st.capacity
        cot = torch.from_numpy(np.random.default_rng(9).standard_normal(
            (n_out, 32)).astype(np.float32)).to(d)
        f = s.feats.clone().requires_grad_(True)
        wt = torch.from_numpy(w).to(d).requires_grad_(True)
        n0, m0 = tnc.launches, tnc.dw_launches
        out = conv(f, wt)
        out.backward(cot)
        if d != 'cpu':
            torch.cuda.synchronize()
            assert (tnc.launches - n0, tnc.dw_launches - m0) == (2, 1)
        res[str(d)] = [x.detach().cpu().numpy()
                       for x in (out, f.grad, wt.grad)]
    want, got = res['cpu'], res[str(dev)]
    for a, b in zip(want[:2], got[:2]):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=0,
                               atol=1e-3 * np.abs(want[2]).max())


def test_eval_loop_launches_band_conv_and_pool(tmp_path):
    """``eval_one_ckpt`` of the tiny configuration over a 1-frame ``mini``
    tree on the card goes through K1 and K2+K3 and gives the KITTI dicts
    and the R40 metric."""
    import logging
    from virconv_tpu_torch.configs.tiny import tiny_eval_config
    from virconv_tpu_torch.models.detectors.voxel_rcnn import VoxelRCNN
    from virconv_tpu_torch.ops import native
    from virconv_tpu_torch.train.checkpoint import save_checkpoint
    from virconv_tpu_torch.train.eval_loop import eval_one_ckpt
    from virconv_tpu_torch.utils.jax_weights import random_init_
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    _cuda()
    root = write_tree(tmp_path / 'kitti', 'mini', frames=1, seed=0,
                      n_train=0)
    cfg = tiny_eval_config(root)
    model = random_init_(VoxelRCNN(cfg.MODEL, cfg.DATA_CONFIG), seed=1)
    ckpt = save_checkpoint(tmp_path / 'ckpt', model.state_dict(), 1)
    tbc.launches = trp.launches = 0
    res = eval_one_ckpt(cfg, ckpt, logging.getLogger('cuda_eval'),
                        tmp_path / 'out', device='cuda', save_to_file=True)
    assert tbc.launches > 0 and trp.launches > 0
    assert native.available()
    assert res.frames == 1 and len(res.det_annos) == 1
    assert len(res.result_dict) == 9
    assert (tmp_path / 'out/final_result/data/000000.txt').exists()


def test_training_loader_steps_match_cpu(tmp_path):
    """The first two training-loader batches of a ``mini`` tree under the
    tiny training config, one ``Trainer`` step each on the CPU and on the
    card (fresh trainers from one seed, the CPU's draws replayed on the
    card), TF32 off: the loss within rtol 1e-4 and each parameter's
    gradient within 1e-3 x its max |grad| on the CPU (floored at 1e-4 x
    the step's largest), as chip_smoke.py phase 10b; K1 and K4 launched."""
    from virconv_tpu_torch.configs.tiny import tiny_train_config
    from virconv_tpu_torch.datasets import build_dataloader
    from virconv_tpu_torch.train.draws import Draws
    from virconv_tpu_torch.train.trainer import Trainer
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    _cuda()
    root = write_tree(tmp_path / 'kitti', 'mini', frames=5, seed=0,
                      n_train=4)
    cfg = tiny_train_config(root)
    _, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2,
                                 seed=3, training=True)
    batches = [b for b, _ in loader]
    assert len(batches) == 2
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for batch in batches:
            draws = Draws(torch.Generator().manual_seed(7))
            res = {}
            for d in ('cpu', 'cuda'):
                tbc.launches = tbc.dw_launches = 0
                tr = Trainer(cfg=cfg, device=d, seed=1, total_steps=2)
                loss, _ = tr.step(batch, draws if d == 'cpu'
                                  else Draws(replay=draws.log))
                res[d] = (float(loss), {n: p.grad.cpu() for n, p in
                                        tr.model.named_parameters()})
            assert tbc.launches > 0 and tbc.dw_launches > 0
            (l_cpu, g_cpu), (l_gpu, g_gpu) = res['cpu'], res['cuda']
            assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
            floor = 1e-4 * max(float(g.abs().max()) for g in g_cpu.values())
            for n, g in g_cpu.items():
                err = float((g_gpu[n] - g).abs().max())
                assert err <= 1e-3 * max(float(g.abs().max()), floor), n
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def test_tiny_l_forward_launches_band_conv_and_pool():
    """VirConv-L's structure (``tiny_l_config``: one fused stream, one
    refinement stage, no replica) through ``serve.Detector`` on the card
    and on the CPU from one seed, f32 operands, TF32 off: K1 and K2+K3
    launched on the card, roi validity identical, boxes within 5e-3 and
    logits within 2e-3 (chip_smoke.py phase 11d's tolerances)."""
    from virconv_tpu_torch.configs.tiny import tiny_l_config
    from virconv_tpu_torch.serve import Detector
    _cuda()
    rng = np.random.default_rng(0)
    n = 1500
    pts = rng.uniform([0, -8, -3, 0, 0, 0, 0, 1], [16, 8, 1, 1, 1, 1, 1, 2.01],
                      (2, n, 8)).astype(np.float32)
    pts[..., 7] = np.round(pts[..., 7])
    v2r = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0], [0, 0, 0]],
                   np.float32)
    p2t = np.array([[200., 0, 0], [0, 200., 0], [700., 300., 1.],
                    [0, 0, 0]], np.float32)
    frames = {'points': pts, 'points_valid': np.ones((2, n), bool),
              'v2r': np.tile(v2r, (2, 1, 1)), 'p2t': np.tile(p2t, (2, 1, 1))}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        outs = {}
        for d in ('cuda', 'cpu'):
            tbc.launches = trp.launches = 0
            det = Detector(cfg=tiny_l_config(), device=d, seed=1, bf16=False)
            o = det.forward(frames)
            outs[d] = {k: o[k].detach().cpu() for k in
                       ('batch_box_preds', 'batch_cls_preds', 'roi_valid')}
            if d == 'cuda':
                assert tbc.launches > 0 and trp.launches > 0
                assert det.rot_num == 1 and det.params is None
        a, b = outs['cuda'], outs['cpu']
        assert torch.equal(a['roi_valid'], b['roi_valid'])
        assert float((a['batch_box_preds'] - b['batch_box_preds'])
                     .abs().max()) <= 5e-3
        assert float((a['batch_cls_preds'] - b['batch_cls_preds'])
                     .abs().max()) <= 2e-3
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def test_voxelize_is_repeatable_on_the_card():
    """``sparse.voxelize`` of crowded voxels on the card: two runs give the
    same bits, and the CPU's means to within f32 rounding (each voxel's
    points are summed in rank order, no atomics)."""
    dev = _cuda()
    rng = np.random.default_rng(5)
    n = 200000
    pts = rng.uniform([0, -40, -3, 0, 0, 0, 0, 1],
                      [70.4, 40, 1, 1, 1, 1, 1, 2.01], (n, 8)).astype(
                          np.float32)
    pts[:, :3] = np.round(pts[:, :3] * 2) / 2 + np.float32(0.01)
    args = ((0, -40, -3, 70.4, 40, 1), (0.05, 0.05, 0.05), 40000, 5)
    mask = torch.ones(n, dtype=torch.bool)
    runs = [tsp.voxelize(torch.from_numpy(pts).to(dev), mask.to(dev), *args,
                         indicator_max=True) for _ in range(2)]
    assert torch.equal(runs[0].feats, runs[1].feats)
    assert torch.equal(runs[0].coords, runs[1].coords)
    cpu = tsp.voxelize(torch.from_numpy(pts), mask, *args,
                       indicator_max=True)
    assert torch.equal(runs[0].coords.cpu(), cpu.coords)
    torch.testing.assert_close(runs[0].feats.cpu(), cpu.feats, atol=1e-6,
                               rtol=1e-6)


def skewed_rows(case):
    """(n, c, idx, valid, g) of a skewed gather: 'hot4k' a row of over
    4 000 valid positions (past one shared-memory sort run), 'hot9k' one of
    over 9 000 (three runs, two merges), 'long_rows' every row past a
    warp's 256, 'all_invalid' no valid position, 'm0' no position; row 9
    is never gathered and the invalid positions point at row 0, as the
    pool's empty slots do."""
    rng = np.random.default_rng(sum(map(ord, case)))
    n, c, m, hot = {'hot4k': (400, 32, 40000, 0.15),
                    'hot9k': (300, 32, 36000, 0.4),
                    'long_rows': (40, 16, 24000, 0.0),
                    'all_invalid': (50, 32, 5000, 0.0),
                    'm0': (20, 32, 0, 0.0)}[case]
    idx = rng.integers(0, n, m)
    idx[rng.uniform(size=m) < hot] = 5
    idx[idx == 9] = 8
    valid = rng.uniform(size=m) >= (1.0 if case == 'all_invalid' else 0.3)
    idx[~valid] = 0
    g = rng.standard_normal((m, c)).astype(np.float32)
    return n, c, idx, valid, g


@pytest.mark.parametrize('case', ['hot4k', 'hot9k', 'long_rows',
                                  'all_invalid', 'm0'])
def test_gather_rows_csr_and_backward_on_skewed_rows(case):
    """The CSR the card builds (int32 counts, scan, scatter, sort within
    rows) equals the plain stable sort's on its valid positions, and the
    backward (warp rows and ring-streamed long rows) gives the bits of the
    CPU's sequential ``index_add_``, the same on two runs."""
    from virconv_tpu_torch.ops import gather_rows as tgr
    dev = _cuda()
    n, c, idx, valid, g = skewed_rows(case)
    it, vt = torch.from_numpy(idx), torch.from_numpy(valid)
    order, offsets = tgr.csr_of(it, vt, n)
    scratch = tgr._csr_cuda(it.to(dev), vt.to(dev), n)
    got_order, got_offsets = tgr.csr_views(scratch, n)
    torch.cuda.synchronize()
    n_valid = int(valid.sum())
    assert torch.equal(got_offsets.cpu().long(), offsets)
    assert torch.equal(got_order[:n_valid].cpu().long(), order[:n_valid])
    want = torch.zeros(n, c).index_add_(0, it, torch.from_numpy(g)
                                        * vt[:, None])
    b0 = tgr.bwd_launches
    got = [tgr._gather_rows_bwd_cuda(torch.from_numpy(g).to(dev),
                                     it.to(dev), vt.to(dev), n).cpu()
           for _ in range(2)]
    assert tgr.bwd_launches == b0 + 2
    assert torch.equal(got[0], want) and torch.equal(got[0], got[1])


@pytest.mark.parametrize('case', ['hot_and_empty', 'wide_c100', 'empty_idx'])
def test_gather_rows_kernels_match_plain_bit_for_bit(case):
    """The masked row gather and its CSR backward against ``index_select``
    times the mask and a sequential ``index_add_`` of the masked gradient
    on the CPU: the same values (the kernel adds each row's valid
    gradients in ascending position order and leaves out the invalid
    ones' zeros), and two backward passes give the same bits."""
    from virconv_tpu_torch.ops import gather_rows as tgr
    dev = _cuda()
    rng = np.random.default_rng(0)
    n, c, m = {'hot_and_empty': (300, 32, 50000),
               'wide_c100': (64, 100, 3000), 'empty_idx': (10, 8, 0)}[case]
    idx = rng.integers(0, n, m)
    idx[rng.uniform(size=m) < 0.4] = 5            # a hot row
    idx[idx == 9] = 8                             # an empty row
    valid = rng.uniform(size=m) >= 0.3
    idx[~valid] = 0                               # the pool's empty slots
    feats = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((m, c)).astype(np.float32))
    it, vt = torch.from_numpy(idx), torch.from_numpy(valid)
    before = (tgr.launches, tgr.bwd_launches)
    grads = []
    for _ in range(2):
        f = feats.to(dev).requires_grad_(True)
        out = tgr.gather_rows(f, it.to(dev), vt.to(dev))
        out.backward(g.to(dev))
        torch.cuda.synchronize()
        assert torch.equal(out.detach().cpu(), feats[it] * vt[:, None])
        grads.append(f.grad.cpu())
    want = torch.zeros(n, c).index_add_(0, it, g * vt[:, None])
    assert torch.equal(grads[0], want)
    assert torch.equal(grads[0], grads[1])
    assert tgr.bwd_launches == before[1] + 2
    assert tgr.launches == before[0] + (2 if m else 0)


@pytest.mark.parametrize('c,m,unaligned', [
    (1, 5000, False), (3, 5000, False), (4, 5000, False),
    (32, 50000, False), (100, 3000, False), (32, 0, False),
    (32, 5000, True)])
def test_gather_rows_forward_bits(c, m, unaligned):
    """The forward gather against ``index_select`` times the mask, bit for
    bit (int32 views): the 16-byte vector path (C % 4 == 0, aligned), the
    scalar path (C of 1, 3, 100, and a ``feats`` view whose base is not
    16-byte aligned), no position; negative and non-finite features on the
    invalid positions' row 0 give -0 and NaN, as the multiply does (the
    card's NaN bits, which the CPU's differ from: NaN there too)."""
    from virconv_tpu_torch.ops import gather_rows as tgr
    dev = _cuda()
    rng = np.random.default_rng(c + m)
    n = 300
    base = torch.from_numpy(rng.standard_normal((n * c + 1,))
                            .astype(np.float32))
    feats = (base[1:] if unaligned else base[:-1]).view(n, c)
    feats[0] = -feats[0].abs()
    feats[0, 0] = float('-inf')
    feats[1, -1] = float('nan')
    idx = rng.integers(0, n, m)
    valid = rng.uniform(size=m) >= 0.3
    idx[~valid] = 0
    it, vt = torch.from_numpy(idx), torch.from_numpy(valid)
    fd = (base.to(dev)[1:] if unaligned else base.to(dev)[:-1]).view(n, c)
    assert (fd.data_ptr() % 16 != 0) == unaligned
    before = tgr.launches
    got = tgr._gather_rows_cuda(fd, it.to(dev), vt.to(dev))
    torch.cuda.synchronize()
    assert tgr.launches == before + (1 if m else 0)
    assert got.shape == (m, c)
    assert torch.equal(_bits(got), _bits(tgr.gather_rows_plain(
        fd, it.to(dev), vt.to(dev))))
    cpu = feats.index_select(0, it) * vt[:, None].float()
    nan = cpu.isnan()
    assert torch.equal(got.cpu().isnan(), nan)
    assert torch.equal(_bits(got)[~nan], _bits(cpu)[~nan])


def _cspn_inputs(rng, h, w, half_res, dev, batch=2):
    hg, wg = (h // 2, w // 2) if half_res else (h, w)
    guides = [torch.from_numpy(rng.normal(0, 0.3, (batch, k * k, hg, wg))
                               .astype(np.float32)).to(dev)
              for k in (3, 5, 7)]
    ds = [torch.from_numpy(rng.uniform(1, 60, (batch, 1, h, w))
                           .astype(np.float32)).to(dev) for _ in range(3)]
    h0 = torch.from_numpy(rng.uniform(1, 60, (batch, 1, h, w))
                          .astype(np.float32)).to(dev)
    mask = torch.from_numpy((rng.uniform(0, 1, (batch, 1, hg, wg))
                             * (rng.uniform(size=(batch, 1, hg, wg)) < 0.3))
                            .astype(np.float32)).to(dev)
    dsp = torch.from_numpy(rng.uniform(0, 60, (batch, 1, hg, wg))
                           .astype(np.float32)).to(dev)
    return guides, ds, h0, mask, dsp


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.int32)


@pytest.mark.parametrize('h,w,dilation,half_res', [
    (5, 7, 1, False),        # odd sizes, borders everywhere
    (33, 50, 1, False),
    (10, 70, 1, False),      # a width that is no multiple of the tile's 64
    (4, 6, 1, False),        # smaller than the k = 7 halo
    (352, 1216, 1, False),   # s1 at full width: interior and edge tiles
    (12, 18, 2, True),       # the half-resolution stage
    (34, 66, 2, True),
    (8, 70, 2, True),        # half-resolution width 35
    (8, 8, 2, True),         # smaller than the k = 7 halo
    (352, 1216, 2, True),    # s2 at full width
    (3, 4, 2, False),        # the thread-per-pixel kernel's cases: taps
    (9, 13, 3, False),       # past the whole image, dilation 3, half
    (10, 12, 1, True)])      # resolution at dilation 1
def test_cspn_kernel_matches_plain(h, w, dilation, half_res):
    """One CSPN iteration (k = 3, 5, 7, batch 2) on the card against the
    plain version on the same CUDA tensors and on the CPU, bit for bit
    (int32 views): borders, tiles cut by the image's edge, images smaller
    than the halo, the half-resolution reads at (y >> 1, x >> 1), the
    full-width frame, and the general kernel's dilations.
    The sums run in the plain version's order, round to nearest; one
    launch per call."""
    from virconv_tpu_torch.ops import cspn as tcs
    dev = _cuda()
    args = _cspn_inputs(np.random.default_rng(h * w), h, w, half_res, dev)
    before = tcs.launches
    got = tcs.cspn_iteration(*args, dilation, half_res)
    torch.cuda.synchronize()
    assert tcs.launches == before + 1
    plain = tcs.cspn_iteration_plain(*args, dilation, half_res)
    cpu = tcs.cspn_iteration_plain(
        *[[t.cpu() for t in a] if isinstance(a, list) else a.cpu()
          for a in args], dilation, half_res)
    for g, p, c in zip(got, plain, cpu):
        assert torch.equal(_bits(g), _bits(p))
        assert torch.equal(_bits(g), _bits(c))


def test_cspn_kernel_takes_one_tensor_as_all_depths():
    """The first iteration of each stage passes one tensor as the three
    previous depths and as h0 (models/depth_completion/penet.py): the
    same bits as three copies."""
    from virconv_tpu_torch.ops import cspn as tcs
    dev = _cuda()
    guides, ds, h0, mask, dsp = _cspn_inputs(np.random.default_rng(3), 64,
                                             200, True, dev)
    got = tcs.cspn_iteration(guides, (h0,) * 3, h0, mask, dsp, 2, True)
    want = tcs.cspn_iteration(guides, [h0.clone() for _ in range(3)], h0,
                              mask, dsp, 2, True)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


def test_cspn_kernel_rejects_bad_operands():
    from virconv_tpu_torch.ops import cspn as tcs
    dev = _cuda()
    guides, ds, h0, mask, dsp = _cspn_inputs(np.random.default_rng(1), 8,
                                             8, True, dev)
    with pytest.raises(ValueError):          # full-resolution guides
        tcs.cspn_iteration(guides, ds, h0, mask, dsp, 2, False)
    with pytest.raises(ValueError):          # a double guide
        tcs.cspn_iteration([guides[0].double()] + guides[1:], ds, h0, mask,
                           dsp, 2, True)


@pytest.mark.parametrize('case', nms_cases.CASES)
def test_nms_kernel_pair_matches_plain(case):
    """The RPN's NMS on the kernel pair (csrc/nms.cu), entry by entry
    against the plain version on the card: ``nms_overlap_mask``'s bits are
    ``(boxes_iou_bev > thresh) & valid_i & valid_j`` on the strict lower
    triangle, ``nms_select`` on them gives the plain ``nms_bev``'s sel and
    sel_valid; two launches for all the entries. At k <= 512 the test entry's float IoU of the triangle is the
    plain IoU, bit for bit."""
    dev = _cuda()
    c = nms_cases.make(case)
    boxes, scores, valid = (torch.from_numpy(c[k]).to(dev)
                            for k in ('boxes', 'scores', 'valid'))
    b = boxes.shape[0]
    args = (c['thresh'], c['pre'], c['post'])
    n0, e0 = tbox.nms_launches, tbox.nms_counts['kernel']
    sel, sel_valid = tbox.nms_bev_batched(boxes, scores, *args, valid=valid)
    torch.cuda.synchronize()
    assert tbox.nms_launches == n0 + 2
    assert tbox.nms_counts['kernel'] == e0 + b
    _, top_valid, top = tbox.nms_top_k(boxes, scores, c['pre'], valid)
    k = top.shape[1]
    mask, iou = tbox._nms_mask_cuda(top, top_valid, c['thresh'],
                                    iou=k <= 512)
    tri = torch.tril(torch.ones((k, k), dtype=torch.bool, device=dev), -1)
    for i in range(b):
        want = tbox.nms_bev(boxes[i], scores[i], *args, valid=valid)
        assert torch.equal(sel[i], want[0])
        assert torch.equal(sel_valid[i], want[1])
        one = slice(i, i + 1)
        sup = tbox.nms_sup_plain(top[one], top_valid[one], c['thresh'])
        assert torch.equal(tbox.nms_mask_bits(mask[one], k), sup)
        if iou is not None:
            plain = tbox.boxes_iou_bev(top[i], top[i])
            assert torch.equal(_bits(iou[i][tri]), _bits(plain[tri]))
            assert not iou[i][~tri].any()
    if case != 'invalid':
        assert bool(sel_valid.any())


def test_nms_kernels_reject_bad_operands():
    dev = _cuda()
    top = torch.zeros((1, 8, 7), device=dev)
    top_valid = torch.ones((1, 8), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):          # a CPU valid mask
        tbox._nms_mask_cuda(top, top_valid.cpu(), 0.5)
    with pytest.raises(ValueError):          # double boxes
        tbox._nms_mask_cuda(top.double(), top_valid, 0.5)
    big = torch.zeros((1, tbox.NMS_MAX_K + 1, 7), device=dev)
    with pytest.raises(ValueError):          # more keep bits than it holds
        tbox._nms_mask_cuda(big, torch.ones(big.shape[:2], dtype=torch.bool,
                                            device=dev), 0.5)


# ---- the depth2points tail (csrc/depth2points.cu) ------------------------

def _frame_on(dev, frame):
    depth, rgb, k_mat, calib, scan = frame
    from virconv_tpu_torch.models.depth_completion import virtual_points
    from virconv_tpu_torch.ops import depth2points as td2p
    cam = td2p.camera_params(virtual_points.crop_calibration(k_mat, calib))
    return (torch.from_numpy(depth).to(dev), torch.from_numpy(rgb).to(dev),
            cam)


@pytest.mark.parametrize('kind', ['street', 'range_bounds', 'behind',
                                  'all_below_z', 'none_in_range',
                                  'one_in_range', 'one_in_range',
                                  'one_in_range'])
def test_depth2points_project_kernel_matches_plain(kind, request):
    """``project`` against ``project_plain``: counts, c, q, pixels and r
    bit for bit; a frame with one pixel in range takes the sgemv order."""
    dev = _cuda()
    import depth2points_cases as cases
    from virconv_tpu_torch.ops import depth2points as td2p
    seed = 11 + request.node.callspec.indices['kind']
    frame = cases.frame(np.random.default_rng(seed), kind)
    depth, rgb, cam = _frame_on(dev, frame)
    head, pix, r = td2p.project(depth, cam)
    torch.cuda.synchronize()
    want_head, want_pix, want_r = td2p.project_plain(depth.cpu(), cam)
    n, hw = int(want_head[0]), depth.numel()
    head = head.cpu()
    assert torch.equal(head[:2], want_head[:2])
    for part in (slice(4, 4 + n), slice(4 + hw, 4 + hw + n)):   # c, q
        assert torch.equal(head[part], want_head[part])
    assert torch.equal(pix[:n].cpu(), want_pix[:n])
    assert torch.equal(_bits(r[:n]), _bits(want_r[:n]))


@pytest.mark.parametrize('kind', ['street', 'hard_angles', 'ties', 'one',
                                  'one_row'])
def test_depth2points_thin_kernel_matches_plain(kind):
    """The bins (numpy's float32 ``//`` of the angles), the nearest row of
    each and their float16 rows, against ``thin_plain``: rows of a street
    frame; angles on bin edges and their neighbours; every row four times
    (ties in r in each bin); one row; one row of a frame with one pixel in
    range (back-projected in the sgemv order)."""
    dev = _cuda()
    import depth2points_cases as cases
    from virconv_tpu_torch.ops import depth2points as td2p
    rng = np.random.default_rng(3)
    frame = cases.frame(rng, 'street')
    depth, rgb, cam = _frame_on(dev, frame)
    head, pix, r = td2p.project_plain(depth.cpu(), cam)
    n, hw = int(head[0]), depth.numel()
    cq = head[4:].view(torch.float32).numpy()
    theta, fan = td2p.angles(cq[:n], cq[hw:hw + n])
    pix, r = pix[:n], r[:n]
    if kind == 'hard_angles':
        theta = cases.hard_angles(rng, 0.0025, n, 0, np.pi)
        fan = cases.hard_angles(rng, 0.0015, n, -np.pi / 2, np.pi / 2)
        n = min(len(theta), n)
        theta, fan, pix, r = theta[:n], fan[:n], pix[:n], r[:n]
    elif kind == 'ties':
        pick = rng.permutation(n // 4).repeat(4)
        theta, fan, r = theta[pick], fan[pick], r[pick]
        pix, n = pix[:len(pick)], len(pick)
    elif kind in ('one', 'one_row'):
        theta, fan, pix, r, n = theta[:1], fan[:1], pix[:1], r[:1], 1
    one_row = kind == 'one_row'
    theta_fan = torch.from_numpy(np.concatenate([theta, fan]))
    box = td2p.table_box(theta, fan, 0.0025, 0.0015)
    want = td2p.thin_plain(depth.cpu(), rgb.cpu(), cam, pix, r, theta_fan,
                           0.0025, 0.0015, box, one_row)
    got = td2p.thin(depth, rgb, cam, pix.to(dev), r.to(dev),
                    theta_fan.to(dev), 0.0025, 0.0015, box, one_row).cpu()
    k = int(want[0])
    assert int(want[1]) == 0 and k > 0
    assert torch.equal(got[:2], want[:2])
    assert torch.equal(got[4:4 + 4 * k], want[4:4 + 4 * k])
    with pytest.raises(ValueError):
        td2p.thin(depth, rgb, cam, pix.to(dev), r.to(dev), theta_fan.to(dev),
                  1e-5, 1e-5, td2p.table_box(np.float32([0, 3]),
                                             np.float32([-1.5, 1.5]), 1e-5,
                                             1e-5))


@pytest.mark.parametrize('kind', ['street', 'street', 'street',
                                  'range_bounds', 'behind', 'none_in_range',
                                  'one_in_range', 'all_below_z',
                                  'one_in_range', 'one_in_range'])
def test_depth2points_kernels_give_numpy_s_cloud(kind, request):
    """``frame_points`` from the depth and crop on the card, on a stream of
    its own after the frame's event, against numpy's on the host depth:
    float16 bits equal at the 352 x 1216 crop."""
    dev = _cuda()
    import depth2points_cases as cases
    from virconv_tpu_torch.models.depth_completion import virtual_points
    from virconv_tpu_torch.ops import depth2points as td2p
    seed = request.node.callspec.indices['kind']
    frame = cases.frame(np.random.default_rng(100 + seed), kind)
    depth, rgb, k_mat, calib, scan = frame
    d_dev, rgb_dev, _ = _frame_on(dev, frame)
    ready = torch.cuda.Event()
    ready.record()
    before = td2p.counts['kernel']
    got = virtual_points.frame_points(
        depth, rgb, k_mat, calib, scan,
        on_device={'depth': d_dev, 'rgb': rgb_dev, 'ready': ready},
        stream=torch.cuda.Stream(dev))
    want = cases.numpy_cloud(depth, rgb, k_mat, calib, scan)
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.uint16), want.view(np.uint16))
    assert td2p.counts['kernel'] == before + 1


def test_depth2points_stream_and_generate_on_the_card(tmp_path, monkeypatch):
    """A CUDA ``stream`` over a 3-frame scene tree (the refined depth
    replaced by street depths, so that the tails thin ~90 000 points) yields
    numpy's clouds of each frame's depth, ``generate`` writes them byte for
    byte, and every frame's rows came from the kernels."""
    dev = _cuda()
    from virconv_tpu_torch.models.depth_completion import virtual_points
    from virconv_tpu_torch.ops import depth2points as td2p
    from virconv_tpu_torch.utils.mini_kitti import street_depth, write_tree
    split = write_tree(tmp_path / 'kitti', 'scene', frames=3, seed=4) \
        / 'training'
    frames = ['000000', '000001', '000002']
    depths = [street_depth(np.random.default_rng(i)) for i in range(3)]
    gen = virtual_points.VirtualPointGenerator(device='cuda')
    calls = []

    def propagate(heads):
        calls.append(None)
        return torch.from_numpy(depths[(len(calls) - 1) % 3]).to(dev)[None,
                                                                      None]
    monkeypatch.setattr(gen.model, 'propagate', propagate)
    td2p.counts.clear()
    gen.generate(split, frames)
    preps = [(f, virtual_points.prepare_frame(split, f)) for f in frames]
    got = list(gen.stream(iter(preps)))
    assert td2p.counts['kernel'] == 6 and not td2p.counts['plain']
    assert [f for f, _ in got] == frames
    for (fid, cloud), (_, prep), depth in zip(got, preps, depths):
        _, rgb_c, _, _, k_mat, calib, lidar, _ = prep
        want = virtual_points.frame_points(depth, rgb_c, k_mat, calib, lidar)
        assert len(want) > len(lidar) + 50000
        saved = np.load(split / 'velodyne_depth' / f'{fid}.npy')
        assert np.array_equal(cloud.view(np.uint16), want.view(np.uint16))
        assert np.array_equal(saved.view(np.uint16), want.view(np.uint16))
