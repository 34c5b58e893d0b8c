"""The exact conv from a neighbor map (virconv_tpu_torch.ops.nmap_conv:
the band conv's gather patch and its neighbor-map branch) vs the JAX
package's gathered conv on the same maps, f32, atol 1e-5: submanifold and
strided maps (fewer output rows than feature rows), 2D and K=3 maps, and a
patch (a few rows of a larger tensor). On the CPU the wrapper runs its
plain version and launches nothing."""
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.ops import sparse as jsp
from virconv_tpu_torch.ops import nmap_conv as tnc

from test_sparse import make_random_sparse

torch.set_num_threads(1)


def _maps(case, rng):
    if case == 'subm27':
        st = make_random_sparse(rng, 2, (6, 24, 20), 700, 768, 16)
        return st.feats, jsp.build_subm_neighbor_map(st, 3), 24
    if case == 'strided27':
        st = make_random_sparse(rng, 2, (9, 20, 16), 600, 640, 8)
        out = jsp.downsample_coords(st, 2, 1, 3, 512)
        return st.feats, jsp.build_strided_neighbor_map(
            st, out, (2, 2, 2), (1, 1, 1), (3, 3, 3)), 16
    if case == 'conv_out3':
        st = make_random_sparse(rng, 1, (9, 20, 16), 500, 512, 8)
        out = jsp.downsample_coords(st, (2, 1, 1), 0, (3, 1, 1), 512)
        return st.feats, jsp.build_strided_neighbor_map(
            st, out, (2, 1, 1), (0, 0, 0), (3, 1, 1)), 8
    if case == 'patch_rows':
        st = make_random_sparse(rng, 2, (6, 24, 20), 700, 768, 4)
        nmap = np.asarray(jsp.build_subm_neighbor_map(st, 3))
        rows = np.sort(rng.choice(700, 37, replace=False))
        return st.feats, jnp.asarray(nmap[rows]), 12
    raise ValueError(case)


@pytest.mark.parametrize('case', ['subm27', 'strided27', 'conv_out3',
                                  'patch_rows'])
def test_nmap_conv_matches_jax_gathered_conv(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    feats, nmap, c_out = _maps(case, rng)
    k, c = nmap.shape[1], feats.shape[1]
    w = (rng.standard_normal((k, c, c_out)) * 0.3).astype(np.float32)
    want = np.asarray(jsp._gathered_conv_raw(feats, nmap, jnp.asarray(w)))
    n0 = tnc.launches
    got = tnc.nmap_conv(torch.from_numpy(np.array(feats)),
                        torch.from_numpy(np.array(nmap)),
                        torch.from_numpy(w))
    assert tnc.launches == n0, 'the CPU runs the plain version'
    assert got.shape == (nmap.shape[0], c_out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_nmap_conv_rejects_shapes_that_disagree():
    feats = torch.zeros((10, 4))
    nmap = torch.zeros((6, 27), dtype=torch.int32)
    with pytest.raises(ValueError, match='disagree'):
        tnc.nmap_conv(feats, nmap, torch.zeros((9, 4, 8)))
    with pytest.raises(ValueError, match='disagree'):
        tnc.nmap_conv(feats, nmap, torch.zeros((27, 5, 8)))
    assert tnc.nmap_conv(feats, nmap, torch.zeros((27, 4, 8))).shape == (6, 8)
