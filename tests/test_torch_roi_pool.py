"""Port ROI grid pooling (virconv_tpu_torch.ops.roi_pool and the SA module)
vs the JAX package: plans and selected voxel sets bit-equal, pooled
features f32-close (atol 2e-5, the tolerance of tests/test_roi_pool.py).
Covers multi-block ROIs (cross-block rank carry) and more than nsample
in-radius hits (truncation)."""
import types

import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.models.roi_heads import voxel_pool as jvp
from virconv_tpu.ops.pallas.roi_pool import (roi_pool_apply as j_apply,
                                             roi_pool_plan as j_plan)
from virconv_tpu_torch.models.roi_heads import voxel_pool as tvp
from virconv_tpu_torch.ops import roi_pool as trp

from test_roi_pool import PCR, VOX, SPECS, _make_queries, _make_st
from test_torch_sparse import assert_same, to_torch_st

torch.set_num_threads(1)


def _case(seed=11, mid=8):
    rng = np.random.default_rng(seed)
    st = _make_st(rng, n_entries=2, n_valid=2500, capacity=3072,
                  channels=mid, cluster_at=(8.0, 0.0, -1.0))
    g = 4
    qxyz, qc, qmask = _make_queries(rng, 6, g, 2, centers=[(8.0, 0.0, -1.0)])
    qc = qc.at[:g ** 3, 0].set(0)
    feats_g = [rng.standard_normal((st.capacity, mid)).astype(np.float32)
               for _ in SPECS]
    w_pos = [rng.standard_normal((3, mid)).astype(np.float32) for _ in SPECS]
    mult = [rng.uniform(0.5, 2, mid).astype(np.float32) for _ in SPECS]
    bias = [rng.standard_normal(mid).astype(np.float32) for _ in SPECS]
    return st, g, qxyz, qc, qmask, feats_g, w_pos, mult, bias


def _t(x):
    return torch.from_numpy(np.array(x))


PLAN_KW = dict(cblk=64, nslab=64, nblk_cap=64)


def test_plan_matches_jax():
    st, g, qxyz, qc, qmask, *_ = _case()
    jp = j_plan(st, qxyz, qc, qmask, g ** 3, SPECS[-1][0], VOX, 1, PCR,
                **PLAN_KW)
    tp = trp.roi_pool_plan(to_torch_st(st), _t(qxyz), _t(qc), _t(qmask),
                           g ** 3, SPECS[-1][0], VOX, 1, PCR, **PLAN_KW)
    for f in ('cand_pack', 'meta', 'cand_rows', 'cand_valid',
              'q_pack', 'ok'):
        assert_same(getattr(jp, f), getattr(tp, f))
    assert bool(tp.ok)
    counts = tp.cand_valid.reshape(-1, 64).sum(1)
    assert int(counts.max()) == 64, 'want a multi-block ROI'


def test_plain_pool_matches_jax_kernel_and_probe_selection():
    st, g, qxyz, qc, qmask, feats_g, w_pos, mult, bias = _case()
    jp = j_plan(st, qxyz, qc, qmask, g ** 3, SPECS[-1][0], VOX, 1, PCR,
                **PLAN_KW)
    w_eff = [w_pos[i] * mult[i][None] for i in range(len(SPECS))]
    want = j_apply(jp, [jnp.asarray(f) for f in feats_g],
                   [jnp.asarray(w) for w in w_eff],
                   [jnp.asarray(b) for b in bias], SPECS, VOX, 1, PCR,
                   bf16=False, interpret=True)
    tp = trp.roi_pool_plan(to_torch_st(st), _t(qxyz), _t(qc), _t(qmask),
                           g ** 3, SPECS[-1][0], VOX, 1, PCR, **PLAN_KW)
    got = trp.roi_pool_apply(tp, [_t(f) for f in feats_g],
                             [_t(w) for w in w_eff], [_t(b) for b in bias],
                             SPECS, VOX, 1, PCR, bf16=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    # selections: identical to the JAX probe path, slot by slot
    table = jvp.build_pool_tables(st)
    queries = jvp.voxel_query_groups(st, table, qxyz, qc, qmask, SPECS, VOX,
                                     1, PCR)
    sel = trp.roi_pool_selection(tp, SPECS, VOX, 1, PCR)
    truncated = False
    for (idx, valid, _), s in zip(queries, sel):
        rows = np.where(np.asarray(valid), np.asarray(idx), -1)
        assert_same(rows, s)
        truncated |= bool(np.asarray(valid).all(1).any())
    assert truncated, 'want queries with > nsample hits'


def test_probe_path_matches_jax():
    st, g, qxyz, qc, qmask, *_ = _case(seed=12)
    for stride in (1, 2):
        jt = jvp.build_pool_tables(st)
        tst = to_torch_st(st)
        tt = tvp.build_pool_tables(tst)
        assert_same(jt.rows, tt.rows)
        assert_same(np.asarray(jt.occ).astype(np.int64), tt.occ)
        want = jvp.voxel_query_groups(st, jt, qxyz, qc, qmask, SPECS, VOX,
                                      stride, PCR)
        got = tvp.voxel_query_groups(tst, tt, _t(qxyz), _t(qc), _t(qmask),
                                     SPECS, VOX, stride, PCR)
        for (ji, jv, jc), (ti, tv, tc) in zip(want, got):
            assert_same(jv, tv)
            assert_same(np.where(np.asarray(jv), np.asarray(ji), 0), ti)
            assert_same(jc, tc)


def test_probe_chunking_is_output_invariant():
    st, g, qxyz, qc, qmask, *_ = _case(seed=13)
    tst = to_torch_st(st)
    tt = tvp.build_pool_tables(tst)
    args = (tst, tt, _t(qxyz), _t(qc), _t(qmask), SPECS, VOX, 1, PCR)
    whole = tvp.voxel_query_groups(*args)
    chunked = tvp.voxel_query_groups(*args, chunk_budget=5000)
    for a, b in zip(whole, chunked):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize('branch', ['kernel', 'probe'])
def test_sa_module_matches_jax(branch, monkeypatch):
    """Whole SA module with carried weights: the port's kernel branch (plan
    ok) and probe branch (plan caps overflow) vs JAX's eval path."""
    from virconv_tpu_torch.utils.jax_weights import (from_jax_variables,
                                                     load_state_dict_checked)
    rng = np.random.default_rng(17)
    st = _make_st(rng, 2, 2000, 2560, 16, cluster_at=(6.0, 1.0, -1.0))
    g = 4
    qxyz, qc, qmask = _make_queries(rng, 8, g, 2, centers=[(6.0, 1.0, -1.0)])
    mod = jvp.NeighborVoxelSAModule(
        query_ranges=((2, 2, 2), (4, 4, 4)), radii=(0.4, 0.8),
        nsamples=(8, 8), mlps=((8, 16), (8, 16)), voxel_size=VOX,
        point_cloud_range=PCR)
    variables = mod.init(jax.random.PRNGKey(0), st, 1, qxyz, qc, qmask, True)
    # non-trivial BN statistics
    variables = jax.tree_util.tree_map(
        lambda x: x * jnp.asarray(rng.uniform(0.5, 1.5, x.shape),
                                  x.dtype) + 0.1, variables)
    monkeypatch.setenv('VIRCONV_POOL_KERNEL', '0')
    want = mod.apply(variables, st, 1, qxyz, qc, qmask, False,
                     q_per_roi=g ** 3)
    # the switch routes the JAX side only: the port reads it too
    monkeypatch.delenv('VIRCONV_POOL_KERNEL')
    tmod = tvp.NeighborVoxelSAModule(16, ((2, 2, 2), (4, 4, 4)), (0.4, 0.8),
                                     (8, 8), ((8, 16), (8, 16)), VOX,
                                     PCR).eval()
    load_state_dict_checked(tmod, from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))
    if branch == 'probe':
        # a plan whose capacity caps overflowed
        monkeypatch.setattr(trp, 'roi_pool_plan', lambda *a, **k:
                            types.SimpleNamespace(ok=torch.tensor(False)))
    tvp.branch_counts.clear()
    with torch.no_grad():
        got = tmod(to_torch_st(st), 1, _t(qxyz), _t(qc), _t(qmask),
                   q_per_roi=g ** 3, bf16=False)
    assert tvp.branch_counts[branch] == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
