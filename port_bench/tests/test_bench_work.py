"""The work counts against a brute-force count on a tiny sparse grid."""

import itertools

import numpy as np
import torch

import pytest

from refnet.ops import sparse as sp
from refnet.tally import Tally
from benchlib import peaks, spec, work


def grid(seed, n=60, shape=(6, 7, 8), batch=2):
    rng = np.random.default_rng(seed)
    cells = set()
    while len(cells) < n:
        cells.add((int(rng.integers(batch)),) + tuple(
            int(rng.integers(s)) for s in shape))
    coords = torch.tensor(sorted(cells), dtype=torch.int32)
    st = sp.SparseTensor(feats=torch.randn(n, 4), coords=coords,
                         mask=torch.ones(n, dtype=torch.bool),
                         spatial_shape=shape, batch_size=batch)
    return sp.sort_by_key(st), cells


def test_subm_pairs_brute_force():
    st, cells = grid(0)
    conv = sp.subm_conv_ctx(st, 3)
    w = torch.randn(27, 4, 5)
    with Tally() as t:
        conv(st.feats, w)
    (c,) = t.convs
    pairs = sum((b, z + dz, y + dy, x + dx) in cells
                for b, z, y, x in cells
                for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3))
    assert c['pairs'] == pairs
    assert c['n_out'] == c['n_in'] == len(cells)
    assert (c['c_in'], c['c_out'], c['taps']) == (4, 5, 27)
    ops, nbytes = work.conv_ops_bytes(c)
    assert ops == 2 * pairs * 4 * 5
    assert nbytes == 4 * (len(cells) * 4 + len(cells) * 5 + 27 * 4 * 5)


def test_strided_pairs_brute_force():
    st, cells = grid(1)
    out = sp.downsample_coords(st, 2, 1, 3, 512)
    out = sp.sort_by_key(out)
    conv = sp.strided_conv_ctx(st, out, 2, 1, 3)
    with Tally() as t:
        conv(st.feats, torch.randn(27, 4, 3))
    (c,) = t.convs
    outs = {tuple(r) for r, m in zip(out.coords.tolist(), out.mask.tolist())
            if m}
    pairs = 0
    for b, z, y, x in outs:
        for dz, dy, dx in itertools.product(range(3), repeat=3):
            if (b, 2 * z - 1 + dz, 2 * y - 1 + dy, 2 * x - 1 + dx) in cells:
                pairs += 1
    assert not c['subm'] and c['pairs'] == pairs and c['n_out'] == len(outs)


def test_roofline_and_ideal():
    s = {'mode': 'infer', 'items': 1, 'tf32': {'cudnn': True,
                                               'matmul': False},
         'pool_branch': [[]],
         'work': [{'convs': [{'subm': True, 'taps': 27, 'pairs': 1000,
                              'n_in': 100, 'n_out': 100, 'c_in': 16,
                              'c_out': 16}],
                   'pools': [], 'pool_calls': [], 'gathers': [],
                   'dense': {'conv': 2e9, 'linear': 1e8}}],
         'trace': {'kernel_seq': [(0, 'void band_conv_kernel<1>', 1e-3),
                                  (1, 'band_conv_dw_kernel', 5e-4)]}}
    assert work.kernel_seconds(s, ('band_conv_kernel',)) == 1e-3
    ops, nbytes = work.sparse_work(s, 'band')
    share = work.roofline(s, 1e-3, ops, nbytes, 'bf16')
    assert 0 < share < 100
    assert work.roofline(s, 0.0, ops, nbytes, 'bf16') is None
    ideal = work.step_ideal_s(s)
    assert abs(ideal - (ops / 989e12 + 2e9 / 495e12 + 1e8 / 67e12)) < 1e-15


def pool_summary(branches):
    """Two profiled items of three pool calls each, one group a call; the
    program's calls marked with ``branches``."""
    call = [{'stride': 4, 'q': 216, 'pairs': 5000, 'queries': 400,
             'n_src': 300, 'mid': 16}]
    return {'mode': 'infer', 'items': 2, 'tf32': {'cudnn': False,
                                                  'matmul': False},
            'pool_branch': [branches, branches],
            'work': [{'convs': [], 'pools': call * 3,
                      'pool_calls': [call, call, call], 'gathers': [],
                      'dense': {'conv': 0.0, 'linear': 0.0}}] * 2,
            'trace': {'kernel_seq': [(0, 'roi_pool_kernel', 2e-4)]}}


def test_pool_roofline_counts_only_the_kernels_calls():
    reader = spec.metric_reader('roi_pool_roofline.infer')
    one = reader(pool_summary(['kernel', 'probe', 'probe']))
    two = reader(pool_summary(['kernel', 'kernel', 'probe']))
    o, b = work.pool_ops_bytes(pool_summary([])['work'][0]['pools'][0])
    # per item: the kernel's time is 1e-4 s
    assert abs(one - 100 * peaks.bound_s(o, b, 'bf16') / 1e-4) < 1e-9
    assert abs(two - 2 * one) < 1e-9
    assert reader(pool_summary(['probe'] * 3)) is None
    with pytest.raises(ValueError):
        reader(pool_summary(['kernel']))
