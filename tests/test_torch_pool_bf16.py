"""``VIRCONV_POOL_BF16``: with ``0`` the eval ROI pool keeps f32 feature
operands while the detector runs its convs in bf16 (the module called
with ``bf16=True``). The port's SA module (the pooling kernel's plain
version, the plan's caps holding) against the JAX package's probe-path
pool (f32 on the CPU), with the same carried weights, on f32 rows and on
the bf16 rows the eval convs store under ``VIRCONV_BF16_FEATS`` (``mlp_in``
promotes them to f32 on both sides): within 1e-4 x the output scale. The
switch unset or truthy passes ``bf16`` through to the kernel, as the JAX
package does on the TPU."""
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.models.roi_heads import voxel_pool as jvp
from virconv_tpu_torch.models.roi_heads import voxel_pool as tvp
from virconv_tpu_torch.ops import roi_pool as trp
from virconv_tpu_torch.utils.jax_weights import (from_jax_variables,
                                                 load_state_dict_checked)

from test_roi_pool import PCR, VOX, _make_queries, _make_st
from test_torch_roi_pool import _t
from test_torch_sparse import to_torch_st

torch.set_num_threads(1)


def modules(rng, st, qxyz, qc, qmask):
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


def run(monkeypatch, feats_dtype):
    """(JAX probe-path output, port output with bf16 convs, the ``bf16``
    flags the pooling kernel's wrapper got)."""
    rng = np.random.default_rng(17)
    st = _make_st(rng, 2, 2000, 2560, 16, cluster_at=(6.0, 1.0, -1.0))
    g = 4
    qxyz, qc, qmask = _make_queries(rng, 8, g, 2, centers=[(6.0, 1.0, -1.0)])
    mod, variables, tmod = modules(rng, st, qxyz, qc, qmask)
    if feats_dtype == 'bf16':
        st = st.replace(feats=st.feats.astype(jnp.bfloat16))
    monkeypatch.setenv('VIRCONV_POOL_KERNEL', '0')
    want = np.asarray(mod.apply(variables, st, 1, qxyz, qc, qmask, False,
                                q_per_roi=g ** 3))
    # the switch routes the JAX side only: the port reads it too
    monkeypatch.delenv('VIRCONV_POOL_KERNEL')
    tst = to_torch_st(st.replace(feats=st.feats.astype(jnp.float32)))
    if feats_dtype == 'bf16':
        tst = tst.replace(feats=tst.feats.to(torch.bfloat16))
    flags = []
    apply = trp.roi_pool_apply

    def spy(*a, **k):
        flags.append(k['bf16'])
        return apply(*a, **k)
    monkeypatch.setattr(trp, 'roi_pool_apply', spy)
    tvp.branch_counts.clear()
    with torch.no_grad():
        got = tmod(tst, 1, _t(qxyz), _t(qc), _t(qmask), q_per_roi=g ** 3,
                   bf16=True).numpy()
    assert tvp.branch_counts['kernel'] == 1
    return want, got, flags


@pytest.mark.parametrize('feats_dtype', ['f32', 'bf16'])
def test_pool_f32_operands_under_bf16_convs_match_jax(feats_dtype,
                                                      monkeypatch):
    monkeypatch.setenv('VIRCONV_POOL_BF16', '0')
    want, got, flags = run(monkeypatch, feats_dtype)
    assert flags == [False]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize('value', [None, '1', 'true'])
def test_pool_switch_on_passes_bf16_operands(value, monkeypatch):
    if value is None:
        monkeypatch.delenv('VIRCONV_POOL_BF16', raising=False)
    else:
        monkeypatch.setenv('VIRCONV_POOL_BF16', value)
    assert tvp.pool_bf16_enabled() is jvp.pool_bf16_enabled() is True
    _, got, flags = run(monkeypatch, 'f32')
    assert flags == [True] and np.isfinite(got).all()
