"""The JAX package's six routing switches in the port: the readers (names,
defaults, the values that turn a switch off), the sparse blocks on the
neighbor-map eval context (``use_band=False``: ``VIRCONV_BAND=0``) against
the JAX blocks on theirs, and quadrant-tiled ROI pooling
(``VIRCONV_POOL_TILE=1``) against the untiled module and the JAX package.
Tolerances: features at atol 1e-5 / rtol 1e-5 (f32 sums of 27 taps in
other orders), coords and masks bit-equal; tiled pooling equal to untiled
bit for bit on the kernel branch (within 1e-6 on the probe branch, whose
untiled reference is the kernel's), and to JAX at
tests/test_torch_roi_pool.py's atol 2e-5 / rtol 1e-4."""
import types

import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.models import layers as jlayers
from virconv_tpu.models.roi_heads import voxel_pool as jvp
from virconv_tpu.ops import sparse as jsp
from virconv_tpu_torch.models import layers as tlayers
from virconv_tpu_torch.models.roi_heads import voxel_pool as tvp
from virconv_tpu_torch.ops import roi_pool as trp
from virconv_tpu_torch.ops import sparse as tsp
from virconv_tpu_torch.utils.jax_weights import (from_jax_variables,
                                                 load_state_dict_checked)

from test_roi_pool import PCR, VOX, _make_queries, _make_st
from test_sparse import make_random_sparse
from test_torch_roi_pool import _t
from test_torch_sparse import assert_same, to_torch_st

torch.set_num_threads(1)

# switch: (the port's reader, the JAX package's, the port's default)
READERS = {
    'VIRCONV_BAND': (tsp.band_enabled, jsp.band_enabled, True),
    'VIRCONV_BAND_TRAIN': (tsp.band_train_enabled, jsp.band_train_enabled,
                           True),
    'VIRCONV_BAND2D': (tsp.band2d_enabled, jsp.band2d_enabled, True),
    'VIRCONV_DENSE2D': (tsp.dense2d_enabled, jsp.dense2d_enabled, False),
    'VIRCONV_POOL_KERNEL': (tvp.pool_kernel_enabled, jvp.pool_kernel_enabled,
                            True),
    'VIRCONV_POOL_TILE': (lambda: tvp.pool_tile_enabled(4),
                          lambda: jvp.pool_tile_enabled(4), False),
}
# on only on a TPU in the JAX package; on, on every device, in the port
TPU_GATED = ('VIRCONV_BAND', 'VIRCONV_BAND_TRAIN', 'VIRCONV_POOL_KERNEL')


@pytest.mark.parametrize('name', sorted(READERS))
def test_switch_readers(name, monkeypatch):
    port, jax_reader, default = READERS[name]
    monkeypatch.delenv(name, raising=False)
    assert port() is default
    # the JAX package on this CPU: its TPU-gated switches are off
    assert jax_reader() is (False if name in TPU_GATED else default)
    for value, on in (('0', False), ('false', False), ('False', False),
                      ('1', True), ('true', True)):
        monkeypatch.setenv(name, value)
        assert port() is jax_reader() is on, (name, value)


def test_pool_tile_only_below_stride_8(monkeypatch):
    monkeypatch.setenv('VIRCONV_POOL_TILE', '1')
    for stride, on in ((1, True), (2, True), (4, True), (8, False)):
        assert tvp.pool_tile_enabled(stride) is jvp.pool_tile_enabled(
            stride) is on


@pytest.mark.parametrize('g', [3, 4, 6])
def test_tile_layout_matches_jax(g):
    want = jvp._tile_layout(g)
    got = tvp._tile_layout(g)
    assert got[3] == want[3]
    for a, b in zip(want[:3], got[:3]):
        assert_same(a, b)


def _block_variables(rng, module, *args):
    variables = module.init(jax.random.PRNGKey(0), *args)
    return {'params': jax.tree_util.tree_map(np.asarray,
                                             variables['params']),
            'batch_stats': {'MaskedBatchNorm_0': {
                'mean': rng.standard_normal(module.out_channels).astype(
                    np.float32) * 0.1,
                'var': rng.uniform(0.5, 1.5, module.out_channels).astype(
                    np.float32)}}}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _block_state(variables):
    """The port's state_dict of one block from its flax variables (the
    converter reads a kernel's parent name: the block gets one)."""
    sd = from_jax_variables({k: {'b': v} for k, v in variables.items()})
    return {k[2:]: v for k, v in sd.items()}


BLOCKS = {
    'subm_k27': None,
    'strided_k27': ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    'conv_out_k3': ((3, 1, 1), (2, 1, 1), (0, 0, 0)),
}


@pytest.mark.parametrize('bf16_feats', ['0', '1'])
@pytest.mark.parametrize('name', sorted(BLOCKS))
def test_blocks_on_nmap_ctx_match_jax(name, bf16_feats, monkeypatch):
    """Eval blocks with the folded BN on the neighbor-map context: JAX's
    ``use_band=False`` against the port's, f32 rows out even under
    ``VIRCONV_BF16_FEATS=1`` (which acts on band contexts only)."""
    monkeypatch.setenv('VIRCONV_BF16_FEATS', bf16_feats)
    rng = np.random.default_rng(3)
    st = make_random_sparse(rng, 2, (9, 20, 16), 600, 640, 8)
    tst = to_torch_st(st)
    tsp.branch_counts.clear()
    if BLOCKS[name] is None:
        jblock = jlayers.SubMConvBlock(16)
        jctx = jsp.subm_conv_ctx(st, 3, use_band=False)
        variables = _block_variables(rng, jblock, st, jctx, False)
        want = jblock.apply(_jnp(variables), st, jctx, False)
        tblock = tlayers.SubMConvBlock(8, 16).eval()
        load_state_dict_checked(tblock, _block_state(variables))
        got = tblock(tst, tsp.subm_conv_ctx(tst, 3, use_band=False))
    else:
        ks, stride, pad = BLOCKS[name]
        jblock = jlayers.SparseDownBlock(16, ks, stride, pad,
                                         out_capacity=512)
        variables = _block_variables(rng, jblock, st, False)
        want = jblock.apply(_jnp(variables), st, False, use_band=False)
        tblock = tlayers.SparseDownBlock(8, 16, ks, stride, pad).eval()
        load_state_dict_checked(tblock, _block_state(variables))
        got = tblock(tst, 512, bf16=True, use_band=False)
    assert tsp.branch_counts == {'nmap': 1}, tsp.branch_counts
    assert got.feats.dtype == torch.float32
    assert_same(want.coords, got.coords)
    assert_same(want.mask, got.mask)
    assert bool(got.mask.any())
    np.testing.assert_allclose(got.feats.detach().numpy(),
                               np.asarray(want.feats), atol=1e-5, rtol=1e-5)


def _sa_modules(rng, st, qxyz, qc, qmask):
    mod = jvp.NeighborVoxelSAModule(
        query_ranges=((2, 2, 2), (4, 4, 4)), radii=(0.4, 0.8),
        nsamples=(8, 8), mlps=((8, 16), (8, 16)), voxel_size=VOX,
        point_cloud_range=PCR)
    variables = mod.init(jax.random.PRNGKey(0), st, 1, qxyz, qc, qmask, True)
    variables = jax.tree_util.tree_map(
        lambda x: x * jnp.asarray(rng.uniform(0.5, 1.5, x.shape),
                                  x.dtype) + 0.1, variables)
    tmod = tvp.NeighborVoxelSAModule(16, ((2, 2, 2), (4, 4, 4)), (0.4, 0.8),
                                     (8, 8), ((8, 16), (8, 16)), VOX,
                                     PCR).eval()
    load_state_dict_checked(tmod, from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))
    return mod, variables, tmod


@pytest.mark.parametrize('branch', ['kernel', 'probe'])
def test_tiled_sa_module_matches_untiled_and_jax(branch, monkeypatch):
    """``VIRCONV_POOL_TILE=1`` at stride 1 (g = 4: 16 queries per quadrant
    segment, 4 segments per ROI): the port's module equals its untiled
    self bit for bit on the plain versions, and JAX's probe-path pool. The
    probe case forces a tiled plan whose caps overflowed."""
    rng = np.random.default_rng(17)
    st = _make_st(rng, 2, 2000, 2560, 16, cluster_at=(6.0, 1.0, -1.0))
    g = 4
    qxyz, qc, qmask = _make_queries(rng, 8, g, 2, centers=[(6.0, 1.0, -1.0)])
    qmask = qmask.at[-g ** 3:].set(False)    # an invalid ROI too
    mod, variables, tmod = _sa_modules(rng, st, qxyz, qc, qmask)
    monkeypatch.setenv('VIRCONV_POOL_KERNEL', '0')
    want = np.asarray(mod.apply(variables, st, 1, qxyz, qc, qmask, False,
                                q_per_roi=g ** 3))
    monkeypatch.delenv('VIRCONV_POOL_KERNEL')
    args = (to_torch_st(st), 1, _t(qxyz), _t(qc), _t(qmask))
    with torch.no_grad():
        untiled = tmod(*args, q_per_roi=g ** 3, bf16=False)
        monkeypatch.setenv('VIRCONV_POOL_TILE', '1')
        plans = []
        plan = trp.roi_pool_plan

        def spy(*a, **k):
            p = plan(*a, **k)
            plans.append(p)
            return p if branch == 'kernel' else types.SimpleNamespace(
                ok=torch.tensor(False))
        monkeypatch.setattr(trp, 'roi_pool_plan', spy)
        tvp.branch_counts.clear()
        got = tmod(*args, q_per_roi=g ** 3, bf16=False)
    assert tvp.branch_counts == {
        branch: 1, f'{branch} tiled stride 1 q 64': 1}
    (p,) = plans
    assert (p.n_roi, p.q_per_roi) == (4 * 8, 16) and bool(p.ok)
    if branch == 'kernel':
        assert torch.equal(got, untiled)
    np.testing.assert_allclose(got.numpy(), untiled.numpy(), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


def test_pool_kernel_off_takes_the_probe_without_a_plan(monkeypatch):
    rng = np.random.default_rng(18)
    st = _make_st(rng, 2, 1500, 2048, 16, cluster_at=(6.0, 1.0, -1.0))
    g = 3
    qxyz, qc, qmask = _make_queries(rng, 6, g, 2, centers=[(6.0, 1.0, -1.0)])
    mod, variables, tmod = _sa_modules(rng, st, qxyz, qc, qmask)
    monkeypatch.setenv('VIRCONV_POOL_KERNEL', '0')
    want = np.asarray(mod.apply(variables, st, 1, qxyz, qc, qmask, False,
                                q_per_roi=g ** 3))
    monkeypatch.setattr(trp, 'roi_pool_plan', None)     # never called
    tvp.branch_counts.clear()
    with torch.no_grad():
        got = tmod(to_torch_st(st), 1, _t(qxyz), _t(qc), _t(qmask),
                   q_per_roi=g ** 3, bf16=False)
    assert tvp.branch_counts == {'probe': 1, 'probe stride 1 q 27': 1}
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
