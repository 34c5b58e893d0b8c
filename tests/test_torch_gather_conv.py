"""Port windowed gather convs (virconv_tpu_torch.ops.gather_conv, K5, and
ops.onehot_conv, K6) vs the JAX entry functions on the CPU: K5 with its
Pallas call patched to interpret mode (the JAX file is not edited), K6 with
its own ``interpret=True``. Identical miss counts; outputs within 1e-5 x max(1,
max|JAX|) (f32 sums in another order). Then the slice as a whole on real
submanifold neighbor maps, and the wrappers' no-fallback contract."""
import functools

import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.ops import sparse as jsp
from virconv_tpu.ops.pallas import gather_conv as jgc
from virconv_tpu.ops.pallas.onehot_conv import onehot_gather_conv as jax_k6
from virconv_tpu_torch.ops import gather_conv as gc
from virconv_tpu_torch.ops import onehot_conv as oc
from virconv_tpu_torch.ops import sparse as tsp

from test_sparse import make_random_sparse
from test_torch_sparse import to_torch_st

torch.set_num_threads(1)
TOL = 1e-5


@pytest.fixture
def interpret_k5(monkeypatch):
    """The JAX K5 entry function with its pallas_call run in interpret mode."""
    monkeypatch.setattr(jgc.pl, 'pallas_call', functools.partial(
        jgc.pl.pallas_call, interpret=True))
    return jgc.fused_gather_conv


def _near_diagonal(rng, n, k, spread, p_valid=0.8):
    """(n, k) map of rows within ``spread`` of the diagonal, 1 - p_valid of
    the entries missing."""
    idx = np.arange(n)[:, None] + rng.integers(-spread, spread + 1, (n, k))
    return np.where(rng.random((n, k)) < p_valid, np.clip(idx, 0, n - 1),
                    -1).astype(np.int32)


def _operands(rng, n, k, c, c_out):
    return (rng.standard_normal((n, c)).astype(np.float32),
            (rng.standard_normal((k, c, c_out)) * 0.3).astype(np.float32))


def _assert_same(got, want):
    """Port (out, misses) tensors vs JAX (out, misses) arrays."""
    (out, misses), (jout, jmisses) = got, want
    jout, jmisses = np.asarray(jout), np.asarray(jmisses)
    np.testing.assert_array_equal(misses.numpy(), jmisses)
    assert misses.dtype == torch.int32
    np.testing.assert_allclose(out.numpy(), jout, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(jout).max())))


def _k6_both(feats, nmap, w, **kw):
    want = jax_k6(jnp.asarray(feats), jnp.asarray(nmap), jnp.asarray(w),
                  interpret=True, **kw)
    got = oc.onehot_gather_conv(torch.from_numpy(feats),
                                torch.from_numpy(nmap), torch.from_numpy(w),
                                **kw)
    _assert_same(got, want)
    return got


@pytest.mark.parametrize('wide', [False, True])
@pytest.mark.parametrize('k,tile,n', [(3, 128, 1024), (9, 32, 512),
                                      (27, 16, 512)])
def test_k5_plain_matches_jax_kernel(k, tile, n, wide, interpret_k5):
    """Maps spread within the window (no misses) or three times wider."""
    rng = np.random.default_rng(k + int(wide))
    window = tile * (k - 1) // 2
    nmap = _near_diagonal(rng, n, k, 3 * window if wide else window)
    feats, w = _operands(rng, n, k, 8, 12)
    want = interpret_k5(jnp.asarray(feats), jnp.asarray(nmap),
                        jnp.asarray(w), tile=tile)
    got = gc.fused_gather_conv(torch.from_numpy(feats),
                               torch.from_numpy(nmap), torch.from_numpy(w),
                               tile)
    _assert_same(got, want)
    assert got[1].shape == (n // tile,)
    assert (int(got[1].sum()) > 0) == wide


@pytest.mark.parametrize('bf16', [False, True])
def test_k6_plain_matches_jax_kernel(bf16):
    """A near-diagonal map with no misses, n0 a multiple of block."""
    rng = np.random.default_rng(10)
    n, k = 512, 27
    nmap = _near_diagonal(rng, n, k, 60)
    feats, w = _operands(rng, n, k, 16, 24)
    out, misses = _k6_both(feats, nmap, w, tile=128, block=256, bf16=bf16)
    assert misses.shape == ((n + 256) // 128,) and int(misses.sum()) == 0


@pytest.mark.parametrize('bf16', [False, True])
def test_k6_miss_counting(bf16):
    """The JAX package's own miss case: one tile column spread wider than
    its two-block window drops and counts the far neighbor."""
    rng = np.random.default_rng(1)
    n, k = 512, 3
    feats, w = _operands(rng, n, k, 8, 8)
    nmap = np.full((n, k), -1, np.int32)
    nmap[:, 0] = np.arange(n)
    nmap[0, 1] = 0
    nmap[1, 1] = n - 1
    _, misses = _k6_both(feats, nmap, w, tile=128, block=128, bf16=bf16)
    assert int(misses[0]) == 1 and int(misses.sum()) == 1


@pytest.mark.parametrize('bf16', [False, True])
def test_k6_ragged_rows_empty_tap_and_last_block(bf16):
    """n0 not a multiple of block, one tap column all -1, misses in some
    tiles, and a last tile whose neighbors lie in the last real block (the
    window start clipped to n_blocks - 2)."""
    rng = np.random.default_rng(11)
    n0, k, tile, block = 700, 9, 64, 128
    nmap = _near_diagonal(rng, n0, k, 150)
    tail = np.arange(n0 - 60, n0)
    nmap[tail] = np.clip(tail[:, None] + rng.integers(-5, 6, (60, k)),
                         n0 - 60, n0 - 1)
    nmap[:, 2] = -1
    feats, w = _operands(rng, n0, k, 8, 12)
    _, misses = _k6_both(feats, nmap, w, tile=tile, block=block, bf16=bf16)
    n = n0 + (-n0) % block + block
    assert misses.shape == (n // tile,) and int(misses.sum()) > 0
    blk, _ = oc.window_blocks(torch.from_numpy(nmap), tile, block)
    assert int(blk.max()) == n // block - 2
    assert int(misses[-(-n0 // tile):].sum()) == 0


def _scene_2d(rng, n_valid=300, capacity=384, shape=(30, 12), batch=2):
    """A sorted 2D sparse tensor with distinct keys."""
    cells = rng.choice(batch * shape[0] * shape[1], n_valid, replace=False)
    b, rest = np.divmod(cells, shape[0] * shape[1])
    u, v = np.divmod(rest, shape[1])
    coords = np.full((capacity, 3), -1, np.int32)
    coords[:n_valid] = np.stack([b, u, v], -1)
    mask = np.arange(capacity) < n_valid
    feats = rng.standard_normal((capacity, 8)).astype(np.float32)
    feats *= mask[:, None]
    return jsp.sort_by_key(jsp.SparseTensor(
        jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(mask), shape,
        batch))


@pytest.mark.parametrize('ndim', [3, 2])
def test_slice_on_real_submanifold_map(ndim, interpret_k5):
    """A sorted scene without duplicate keys: the JAX and port neighbor
    maps are equal; both JAX entry functions and both port entry functions
    agree on that map; on rows of tiles with no misses the result equals
    the port's submanifold conv context (f32, no epilogue)."""
    rng = np.random.default_rng(20 + ndim)
    if ndim == 3:
        st = make_random_sparse(rng, 2, (6, 24, 20), 700, 768, 8)
    else:
        st = _scene_2d(rng)
    tst = to_torch_st(st)
    jmap = np.array(jsp.build_subm_neighbor_map(st, 3))
    tmap = tsp.build_subm_neighbor_map(tst, 3)
    np.testing.assert_array_equal(tmap.numpy(), jmap)
    k = jmap.shape[1]
    assert k == 3 ** ndim
    feats = np.array(st.feats)
    w = (rng.standard_normal((k, 8, 12)) * 0.3).astype(np.float32)
    f_t, w_t = torch.from_numpy(feats), torch.from_numpy(w)
    exact = tsp.subm_conv_ctx(tst, 3, tile=16, block=16, bf16=False)(f_t,
                                                                     w_t)

    def agree_where_no_misses(out, misses, tile):
        rows = (misses == 0).repeat_interleave(tile)[:out.shape[0]]
        assert int(rows.sum()) >= out.shape[0] // 2
        np.testing.assert_allclose(out[rows].numpy(), exact[rows].numpy(),
                                   rtol=0, atol=TOL * max(
                                       1.0, float(exact.abs().max())))

    tile = 16
    want = interpret_k5(jnp.asarray(feats), jnp.asarray(jmap),
                        jnp.asarray(w), tile=tile)
    got = gc.fused_gather_conv(f_t, tmap, w_t, tile)
    _assert_same(got, want)
    agree_where_no_misses(*got, tile)
    for bf16 in (False, True):
        got = _k6_both(feats, jmap, w, tile=32, block=64, bf16=bf16)
        if not bf16:
            agree_where_no_misses(*got, 32)


def test_cpu_tensors_never_launch():
    rng = np.random.default_rng(30)
    n, k = 512, 3
    nmap = torch.from_numpy(_near_diagonal(rng, n, k, 100))
    feats, w = map(torch.from_numpy, _operands(rng, n, k, 4, 4))
    before = gc.launches, oc.launches
    gc.fused_gather_conv(feats, nmap, w, 128)
    oc.onehot_gather_conv(feats, nmap, w, 64, 128)
    oc.onehot_gather_conv(feats, nmap, w, 64, 128, bf16=False)
    assert (gc.launches, oc.launches) == before


@pytest.mark.parametrize('case', ['k5_n_not_tiled', 'k5_odd_window',
                                  'k5_too_few_rows', 'k5_shapes',
                                  'k6_block_not_tiled', 'k6_shapes'])
def test_input_checks_raise(case):
    """The entry functions' input checks raise ValueError, before any
    dispatch."""
    def args(n, k, c=4, c_out=4):
        return (torch.zeros(n, c), torch.full((n, k), -1, dtype=torch.int32),
                torch.zeros(k, c, c_out))
    calls = {
        'k5_n_not_tiled': lambda: gc.fused_gather_conv(*args(500, 3), 128),
        'k5_odd_window': lambda: gc.fused_gather_conv(*args(24, 4), 3),
        'k5_too_few_rows': lambda: gc.fused_gather_conv(*args(64, 3), 32),
        'k5_shapes': lambda: gc.fused_gather_conv(
            torch.zeros(512, 4), torch.zeros(512, 3, dtype=torch.int32),
            torch.zeros(3, 5, 4), 128),
        'k6_block_not_tiled': lambda: oc.onehot_gather_conv(
            *args(512, 3), tile=96, block=128),
        'k6_shapes': lambda: oc.onehot_gather_conv(
            torch.zeros(512, 4), torch.zeros(500, 3, dtype=torch.int32),
            torch.zeros(3, 4, 4), 64, 128),
    }
    before = gc.launches, oc.launches
    with pytest.raises(ValueError):
        calls[case]()
    assert (gc.launches, oc.launches) == before
