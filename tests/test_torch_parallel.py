"""Data parallelism of the port on the CPU: 2 spawned ranks over gloo.

* ``merge_results_dist``'s three cases, as tests/test_dist_merge.py holds
  the JAX package's, on the port's copy;
* ``MaskedBatchNorm``, ``FlaxBatchNorm2d`` and the ROI pool's position BN
  (``_group_body``) over 2 ranks against the JAX package's
  ``MaskedBatchNorm`` / flax ``BatchNorm`` / ``NeighborVoxelSAModule.
  _group_body`` (``_MomentBN``) on the concatenated rows: outputs, input
  and affine gradients (``jax.grad``; a rank's affine gradient is its
  partial, so the ranks' sum is compared) and the running statistics
  within 1e-5, once with both ranks holding valid rows and once with rank
  1 holding none (it must still join every collective); the dense BN with
  2 frames on rank 0 and 1 on rank 1;
* the hard-sampling stripe of ``proposal_targets`` tested on global entry
  indices: 2 ranks take the one-process sampling of their entries;
* 2-rank evaluation of a ``mini`` tree merged on rank 0, equal to one
  process with per-frame streams;
* ``tools/train_gpu.py`` and ``tools/test_gpu.py`` with ``--launcher
  pytorch --device cpu --dist_backend gloo`` in 2 processes for one tiny
  step and its distributed evaluation;
* no collective without a process group.

The rank functions are module-level (the spawned processes import this
module), and JAX is imported inside the tests only. Every spawned run has
a timeout (``parallel.spawn.run_ranks``)."""
import socket
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from virconv_tpu_torch.parallel import data_parallel as dp
from virconv_tpu_torch.parallel.dist import merge_results_dist
from virconv_tpu_torch.parallel.spawn import run_ranks

ROOT = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)
TIMEOUT = 240


def _noop_barrier(name='x'):
    return None


# ---- merge_results_dist (tests/test_dist_merge.py on the port's copy) ----

def test_merge_results_dist_restores_order(tmp_path):
    size, world = 10, 4
    idx = np.arange(size)
    padded = np.concatenate([idx, idx[:(-size) % world]])
    parts = [list(padded[r::world]) for r in range(world)]
    outs = {}
    for r in list(range(1, world)) + [0]:
        outs[r] = merge_results_dist(
            parts[r], size, tmp_path / 'merge', rank=r, world_size=world,
            _barrier=_noop_barrier)
    for r in range(1, world):
        assert outs[r] is None
    assert outs[0] == list(range(size))
    assert not (tmp_path / 'merge').exists()


def test_merge_results_dist_single_process_passthrough(tmp_path):
    part = [{'frame': i} for i in range(3)]
    out = merge_results_dist(part, 3, tmp_path / 'merge', rank=0,
                             world_size=1, _barrier=_noop_barrier)
    assert out == part


def test_merge_results_dist_ragged_parts(tmp_path):
    parts = [[0, 3, 6], [1, 4], [2, 5]]
    outs = {}
    for r in (1, 2, 0):
        outs[r] = merge_results_dist(
            parts[r], 7, tmp_path / 'm2', rank=r, world_size=3,
            _barrier=_noop_barrier)
    assert outs[0] == [0, 1, 2, 3, 4, 5, 6]


# ---- the three BN layers over 2 ranks against JAX ----------------------

C, MID = 6, 5


def _bn_cases(seed=0):
    """Per case the global inputs and each rank's rows: rank 0 rows [0,
    split), rank 1 the rest."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    cases = {}
    for zero in (False, True):
        n0, n1 = 9, 7
        x = rng.standard_normal((n0 + n1, C)).astype(f32) * 2 + 0.5
        mask = rng.uniform(size=n0 + n1) < 0.7
        mask[:2] = True
        if zero:
            mask[n0:] = False
        cases[('masked', zero)] = dict(
            x=x, mask=mask, g=rng.standard_normal(x.shape).astype(f32),
            split=n0)
        # the pool's group body: rank r's voxels, queries and samples
        m0, m1, s, v0, v1 = 4, 3, 5, 8, 6
        feats = rng.standard_normal((v0 + v1, MID)).astype(f32)
        idx = np.concatenate([rng.integers(0, v0, (m0, s)),
                              rng.integers(0, v1, (m1, s)) + v0])
        valid = rng.uniform(size=(m0 + m1, s)) < 0.8
        qxyz = rng.uniform(-1, 1, (m0 + m1, 3)).astype(f32)
        centers = (qxyz[:, None] + rng.uniform(-0.5, 0.5, (m0 + m1, s, 3))
                   ).astype(f32)
        qmask = np.ones(m0 + m1, bool)
        qmask[1] = False
        if zero:
            qmask[m0:] = False
        cases[('pool', zero)] = dict(
            feats=feats, idx=idx, valid=valid, qxyz=qxyz, centers=centers,
            qmask=qmask, g=rng.standard_normal((m0 + m1, MID)).astype(f32),
            split=m0, vsplit=v0)
    x = rng.standard_normal((3, 4, 5, C)).astype(f32)       # NHWC
    cases[('dense', False)] = dict(
        x=x, g=rng.standard_normal(x.shape).astype(f32), split=2)
    params = dict(scale=rng.uniform(0.5, 1.5, C).astype(f32),
                  bias=rng.standard_normal(C).astype(f32) * 0.1,
                  mean=rng.standard_normal(C).astype(f32) * 0.1,
                  var=rng.uniform(0.5, 1.5, C).astype(f32),
                  w_pos=rng.standard_normal((3, MID)).astype(f32),
                  pscale=rng.uniform(0.5, 1.5, MID).astype(f32),
                  pbias=rng.standard_normal(MID).astype(f32) * 0.1,
                  pmean=rng.standard_normal(MID).astype(f32) * 0.1,
                  pvar=rng.uniform(0.5, 1.5, MID).astype(f32))
    return cases, params


def _load_bn(bn, p, prefix=''):
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p[prefix + 'scale']))
        bn.bias.copy_(torch.from_numpy(p[prefix + 'bias']))
        bn.running_mean.copy_(torch.from_numpy(p[prefix + 'mean']))
        bn.running_var.copy_(torch.from_numpy(p[prefix + 'var']))


def _port_bn(kind, c, p, rows):
    """The port's layer in train mode on ``rows`` (a slice of the case's
    rows; all of them outside a group). Returns outputs, input gradients,
    affine gradients and running statistics."""
    from virconv_tpu_torch.models.layers import (FlaxBatchNorm2d,
                                                 MaskedBatchNorm)
    from virconv_tpu_torch.models.roi_heads.voxel_pool import \
        NeighborVoxelSAModule
    t = torch.from_numpy
    if kind == 'masked':
        bn = MaskedBatchNorm(C).train()
        _load_bn(bn, p)
        x = t(c['x'][rows]).requires_grad_()
        y = bn(x, t(c['mask'][rows]))
        g = t(c['g'][rows])
        ins = [x]
    elif kind == 'dense':
        bn = FlaxBatchNorm2d(C).train()
        _load_bn(bn, p)
        x = t(c['x'][rows]).requires_grad_()
        y = bn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        g = t(c['g'][rows])
        ins = [x]
    else:
        mod = NeighborVoxelSAModule(MID, [[1, 1, 1]], [1.0], [4],
                                    [[MID, MID]], (0.1,) * 3,
                                    (0, -8, -3, 16, 8, 1)).train()
        bn = mod.mlp_pos_bn0
        _load_bn(bn, p, 'p')
        with torch.no_grad():
            mod.mlp_pos0.kernel.copy_(t(p['w_pos']))
        vs = c['vsplit']
        vrows = slice(0, vs) if rows.start in (0, None) and rows.stop == \
            c['split'] else slice(vs, None) if rows.start == c['split'] \
            else slice(None)
        feats = t(c['feats'][vrows]).requires_grad_()
        qxyz = t(c['qxyz'][rows]).requires_grad_()
        idx = t(c['idx'][rows] - (vs if vrows.start == vs else 0))
        y = mod._group_body(0, feats, idx, t(c['valid'][rows]),
                            t(c['centers'][rows]), qxyz,
                            t(c['qmask'][rows]))
        g = t(c['g'][rows])
        ins = [feats, qxyz]
    (y * g).sum().backward()
    return {'y': y.detach(), 'dx': [i.grad for i in ins],
            'dw': bn.weight.grad, 'db': bn.bias.grad,
            'mean': bn.running_mean.clone(), 'var': bn.running_var.clone()}


def bn_rank(rank, world, payload):
    cases, params = payload
    out = {}
    with dp.synced():
        for key, c in cases.items():
            s = c['split']
            rows = slice(0, s) if rank == 0 else slice(s, None)
            out[key] = _port_bn(key[0], c, params, rows)
    return out, {k: dict(v) for k, v in dp.COUNTS.items()}


def _jax_pos_body():
    """The JAX package's train-mode group body of one pool group
    (``NeighborVoxelSAModule._group_body``, voxel_pool.py:594-620: the
    position BN's algebraic moments into ``_MomentBN``, then gather, add,
    ReLU and max), as a module of its own: the method defines its
    submodules inline, so it cannot be applied alone."""
    import flax.linen as fnn
    import jax.numpy as jnp
    from virconv_tpu.models.roi_heads.voxel_pool import (_MomentBN,
                                                         _PosKernel,
                                                         gather_rows)

    class PosBody(fnn.Module):
        @fnn.compact
        def __call__(self, feats, idx, valid, centers, query_xyz,
                     query_mask):
            w_pos = _PosKernel(MID, name='mlp_pos0')()
            rel = (centers - query_xyz[:, None, :]) * valid[..., None]
            qmask_rows = query_mask[:, None] & jnp.ones_like(valid)
            relm = rel * qmask_rows[..., None]
            cnt = jnp.maximum(qmask_rows.sum().astype(jnp.float32), 1.0)
            mean_rel = relm.reshape(-1, 3).sum(0) / cnt
            mean = mean_rel @ w_pos
            rc = (rel - mean_rel) * qmask_rows[..., None]
            s2 = rc.reshape(-1, 3).T @ rc.reshape(-1, 3)
            var = jnp.maximum(
                jnp.einsum('ic,ic->c', w_pos, (s2 / cnt) @ w_pos), 0.0)
            scale, bias = _MomentBN(MID, name='mlp_pos_bn0')(
                mean, var, cnt, True)
            pos = (rel @ w_pos) * scale + bias
            pos = jnp.where(qmask_rows[..., None], pos, 0.0)
            x = fnn.relu(gather_rows(feats, idx, valid) + pos)
            return jnp.where(valid[..., None], x, 0.0).max(axis=1)
    return PosBody()


def _jax_bn(kind, c, p):
    import jax
    import jax.numpy as jnp
    import flax.linen as fnn
    from virconv_tpu.models.layers import MaskedBatchNorm as JBN
    if kind == 'masked':
        mod = JBN(C)
        variables = {'params': {'scale': p['scale'], 'bias': p['bias']},
                     'batch_stats': {'mean': p['mean'], 'var': p['var']}}

        def f(params, x):
            y, mut = mod.apply({'params': params,
                                'batch_stats': variables['batch_stats']},
                               x, c['mask'], True, mutable=['batch_stats'])
            return (y * c['g']).sum(), (y, mut['batch_stats'])
        ins = (c['x'],)
        stats_of = lambda m: (m['mean'], m['var'])           # noqa: E731
    elif kind == 'dense':
        mod = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                            epsilon=1e-3)
        variables = {'params': {'scale': p['scale'], 'bias': p['bias']},
                     'batch_stats': {'mean': p['mean'], 'var': p['var']}}

        def f(params, x):
            y, mut = mod.apply({'params': params,
                                'batch_stats': variables['batch_stats']},
                               x, mutable=['batch_stats'])
            return (y * c['g']).sum(), (y, mut['batch_stats'])
        ins = (c['x'],)
        stats_of = lambda m: (m['mean'], m['var'])           # noqa: E731
    else:
        mod = _jax_pos_body()
        variables = {'params': {'mlp_pos0': {'kernel': p['w_pos']},
                                'mlp_pos_bn0': {'scale': p['pscale'],
                                                'bias': p['pbias']}},
                     'batch_stats': {'mlp_pos_bn0': {'mean': p['pmean'],
                                                     'var': p['pvar']}}}

        def f(params, feats, qxyz):
            y, mut = mod.apply(
                {'params': params, 'batch_stats': variables['batch_stats']},
                feats, jnp.asarray(c['idx']), jnp.asarray(c['valid']),
                jnp.asarray(c['centers']), qxyz, jnp.asarray(c['qmask']),
                mutable=['batch_stats'])
            return (y * c['g']).sum(), (y, mut['batch_stats'])
        ins = (c['feats'], c['qxyz'])
        stats_of = lambda m: (m['mlp_pos_bn0']['mean'],      # noqa: E731
                              m['mlp_pos_bn0']['var'])
    argnums = tuple(range(len(ins) + 1))
    (_, (y, stats)), grads = jax.value_and_grad(
        f, argnums=argnums, has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, variables['params']),
            *[jnp.asarray(i) for i in ins])
    pg = grads[0] if kind != 'pool' else grads[0]['mlp_pos_bn0']
    mean, var = stats_of(stats)
    return {'y': np.asarray(y), 'dx': [np.asarray(g) for g in grads[1:]],
            'dw': np.asarray(pg['scale']), 'db': np.asarray(pg['bias']),
            'mean': np.asarray(mean), 'var': np.asarray(var)}


@pytest.fixture(scope='module')
def bn_runs():
    cases, params = _bn_cases()
    ranks = run_ranks(bn_rank, 2, (cases, params), timeout=TIMEOUT)
    want = {k: _jax_bn(k[0], c, params) for k, c in cases.items()}
    return cases, ranks, want


def _cat(kind, a, b):
    return np.concatenate([np.asarray(a), np.asarray(b)])


@pytest.mark.parametrize('key', [('masked', False), ('masked', True),
                                 ('dense', False), ('pool', False),
                                 ('pool', True)],
                         ids=['masked', 'masked-rank1-empty', 'dense-2-1',
                              'pool', 'pool-rank1-empty'])
def test_bn_over_two_ranks_matches_jax(bn_runs, key):
    cases, ranks, want = bn_runs
    (r0, counts0), (r1, counts1) = ranks
    got0, got1, w = r0[key], r1[key], want[key]
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_cat(key[0], got0['y'], got1['y']), w['y'],
                               **tol)
    for a, b, jw in zip(got0['dx'], got1['dx'], w['dx']):
        np.testing.assert_allclose(_cat(key[0], a, b), jw, **tol)
    for name in ('dw', 'db'):
        np.testing.assert_allclose(got0[name] + got1[name], w[name], **tol)
    for name in ('mean', 'var'):
        np.testing.assert_array_equal(got0[name], got1[name])
        np.testing.assert_allclose(got0[name], w[name], **tol)
    # both ranks ran the same collectives, rank 1 with no valid rows too
    assert counts0 == counts1 and counts0['moments']['calls'] > 0


# ---- the hard-sampling stripe on global entry indices -------------------

def _stripe_inputs(seed=1):
    from virconv_tpu_torch.config import CfgNode
    rng = np.random.default_rng(seed)
    b, r, m = 6, 12, 3
    gt = np.zeros((b, m, 8), np.float32)
    gt[:, :, :7] = [5, 0, -1, 3.9, 1.6, 1.56, 0]
    gt[:, :, 0] += np.arange(m) * 8
    gt[:, :, 7] = 1
    rois = np.repeat(gt[:, :, :7], r // m, 1)
    # shifted copies: IoUs from ~0.9 down to ~0.2, many hard (0.3 - 0.55)
    rois[..., 0] += rng.uniform(-1.5, 1.5, (b, r)).astype(np.float32)
    cfg = CfgNode({'ROI_PER_IMAGE': 8, 'FG_RATIO': 0.5,
                   'SAMPLE_ROI_BY_EACH_CLASS': True, 'CLS_SCORE_TYPE':
                   'roi_iou_x', 'CLS_FG_THRESH': [0.75],
                   'CLS_BG_THRESH': [0.25], 'CLS_BG_THRESH_LO': 0.1,
                   'HARD_BG_RATIO': 0.8, 'REG_FG_THRESH': [0.55],
                   'ENABLE_HARD_SAMPLING': True,
                   'HARD_SAMPLING_THRESH': [0.3],
                   'HARD_SAMPLING_RATIO': [0.5]})
    return {'rois': rois, 'scores': rng.uniform(size=(b, r)).astype(
        np.float32), 'labels': np.ones((b, r), np.int64), 'gt': gt,
        'gt_valid': np.ones((b, m), bool)}, cfg


def _targets(inp, cfg, draws, rows=slice(None)):
    from virconv_tpu_torch.models.roi_heads.target_assign import \
        proposal_targets
    t = torch.from_numpy
    return proposal_targets(draws, t(inp['rois'][rows]),
                            t(inp['scores'][rows]), t(inp['labels'][rows]),
                            t(inp['gt'][rows]), t(inp['gt_valid'][rows]),
                            cfg)


def stripe_rank(rank, world, payload):
    inp, cfg, draws = payload
    b = inp['rois'].shape[0]
    rows = slice(rank * b // world, (rank + 1) * b // world)
    with dp.synced():
        out = _targets(inp, cfg, draws[rank], rows)
    return {k: out[k] for k in ('reg_valid_mask', 'sampled')}


def _replay_with_start(draws, start):
    from virconv_tpu_torch.train.draws import Draws
    return Draws(replay=[torch.tensor(start) if k == ('shared',) else t
                         for t, k in zip(draws.log, draws.kinds)])


def test_hard_sampling_stripe_uses_global_entry_indices():
    """6 entries, 3 per rank, stripe start 1 of 2: the stripe is the odd
    global entries, which on rank 1 (global 3, 4, 5) are its even local
    ones. Every entry holds hard rows, so an entry off its stripe samples
    other regression rows: a stripe on local indices would differ."""
    from virconv_tpu_torch.train.draws import Draws
    inp, cfg = _stripe_inputs()
    first = Draws(torch.Generator().manual_seed(3))
    _targets(inp, cfg, first)
    draws = _replay_with_start(first, 1)
    one = _targets(inp, cfg, draws)
    reg = one['reg_valid_mask'].numpy()
    flipped = _targets(inp, cfg, _replay_with_start(first, 0))[
        'reg_valid_mask'].numpy()
    assert ((reg != flipped).any(1)).all(), 'an entry without hard rows'
    ranks = run_ranks(stripe_rank, 2, (inp, cfg, [draws.for_rank(r, 2)
                                                  for r in range(2)]),
                      timeout=TIMEOUT)
    np.testing.assert_array_equal(
        np.concatenate([r['reg_valid_mask'].numpy() for r in ranks]), reg)
    np.testing.assert_array_equal(
        np.concatenate([r['sampled'].numpy() for r in ranks]),
        one['sampled'].numpy())


def anchor_mask_rank(rank, world, payload):
    from virconv_tpu_torch.models.dense_heads.anchor_head import \
        compute_anchor_mask
    pts, valid = payload
    with dp.synced():
        return compute_anchor_mask(torch.from_numpy(pts[rank]),
                                   torch.from_numpy(valid[rank]),
                                   (0, -40, -3, 70.4, 40, 1), (200, 176))


def test_anchor_mask_is_global_over_ranks():
    """The anchor mask is shared across the batch (the union of every
    entry's points): each rank, holding points in other places, takes the
    mask of all ranks' points."""
    from virconv_tpu_torch.models.dense_heads.anchor_head import \
        compute_anchor_mask
    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform((0, -40), (30, 0), (64, 2)),
                    rng.uniform((35, 0), (70, 40), (64, 2))]).astype(
                        np.float32)
    valid = rng.uniform(size=(2, 64)) < 0.8
    want = compute_anchor_mask(torch.from_numpy(pts.reshape(-1, 2)),
                               torch.from_numpy(valid.reshape(-1)),
                               (0, -40, -3, 70.4, 40, 1), (200, 176))
    local = compute_anchor_mask(torch.from_numpy(pts[0]),
                                torch.from_numpy(valid[0]),
                                (0, -40, -3, 70.4, 40, 1), (200, 176))
    assert not torch.equal(local, want)
    for got in run_ranks(anchor_mask_rank, 2, (pts, valid),
                         timeout=TIMEOUT):
        assert torch.equal(got, want)


# ---- distributed evaluation and the CLIs -------------------------------

@pytest.fixture(scope='module')
def mini_tree(tmp_path_factory):
    """A 5-frame ``mini`` tree (2 train frames with their gt database, 3
    val frames: an odd count, so the 2-rank shards pad one frame) and a
    checkpoint of the tiny config's seeded weights."""
    from virconv_tpu_torch.configs.tiny import tiny_train_config
    from virconv_tpu_torch.train.checkpoint import save_checkpoint
    from virconv_tpu_torch.train.trainer import Trainer
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    tmp = tmp_path_factory.mktemp('parallel')
    root = write_tree(tmp / 'kitti', 'mini', frames=5, seed=3, n_train=2)
    cfg = tiny_train_config(root)
    model = Trainer(cfg, device='cpu', seed=0).model
    ckpt = save_checkpoint(tmp / 'ckpt', model.state_dict(), epoch=1)
    return tmp, root, cfg, ckpt


def _quiet_logger():
    import logging
    logger = logging.getLogger('test_torch_parallel.eval')
    logger.setLevel(logging.WARNING)
    return logger


def eval_rank(rank, world, payload):
    from virconv_tpu_torch.train.eval_loop import eval_one_ckpt
    cfg, ckpt, out = payload
    res = eval_one_ckpt(cfg, ckpt, _quiet_logger(), out, device='cpu',
                        bf16=False, seed=1024, dist_eval=True)
    return None if res is None else (res.det_annos, res.result_dict,
                                     res.frames)


def _annos_equal(got, want):
    assert [a['frame_id'] for a in got] == [a['frame_id'] for a in want]
    for a, b in zip(got, want):
        assert len(a['name']) == len(b['name']), a['frame_id']
        np.testing.assert_allclose(a['boxes_lidar'], b['boxes_lidar'],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(a['score'], b['score'], atol=1e-6)


def test_two_rank_evaluation_merges_to_one_process(mini_tree):
    """Rank 0 evaluates val frames 0 and 2, rank 1 frames 1 and 0 again
    (the pad); rank 0's merged dicts and metric equal one process's with
    the same per-frame streams."""
    from virconv_tpu_torch.train.eval_loop import eval_one_ckpt
    tmp, root, cfg, ckpt = mini_tree
    one = eval_one_ckpt(cfg, ckpt, _quiet_logger(), tmp / 'one',
                        device='cpu', bf16=False, seed=1024,
                        frame_streams=True)
    assert one.frames == 3 and sum(len(a['name']) for a in one.det_annos)
    ranks = run_ranks(eval_rank, 2, (cfg, ckpt, tmp / 'two'),
                      timeout=TIMEOUT)
    assert ranks[1] is None
    annos, result, frames = ranks[0]
    assert frames == 2
    _annos_equal(annos, one.det_annos)
    assert result.keys() == one.result_dict.keys()
    for k, v in one.result_dict.items():
        assert result[k] == pytest.approx(v, abs=1e-6), k


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def cli_rank(rank, world, payload):
    """torchrun's environment for rank ``rank``, then the training CLI for
    one epoch and the evaluation CLI on its checkpoint, in this process."""
    import os
    cfg, root, out, ports = payload
    sys.path.insert(0, str(ROOT / 'tools'))
    sys.modules['torch.utils.tensorboard'] = None
    import test_gpu
    import train_gpu
    train_gpu.CONFIGS['tiny'] = test_gpu.CONFIGS['tiny'] = lambda: cfg
    common = ['--cfg', 'tiny', '--device', 'cpu', '--launcher', 'pytorch',
              '--dist_backend', 'gloo']
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                      MASTER_PORT=str(ports[0]))
    run = train_gpu.main(common + [
        '--batch_size', '2', '--epochs', '1', '--output_dir', str(out),
        '--log_interval', '1', '--fix_random_seed', '--set',
        'DATA_CONFIG.DATA_PATH', str(root)])
    os.environ['MASTER_PORT'] = str(ports[1])
    ckpt = out / 'ckpt' / 'checkpoint_epoch_1.pth'
    evals = test_gpu.main(common + ['--ckpt', str(ckpt), '--output_dir',
                                    str(out / 'test'), '--set',
                                    'DATA_CONFIG.DATA_PATH', str(root)])
    return {'steps': run.steps, 'checkpoints': run.checkpoints,
            'frames': run.frames,
            'eval': None if run.eval is None else run.eval.result_dict,
            'test': [None if e is None else len(e.det_annos)
                     for e in evals]}


def test_clis_launcher_pytorch_two_ranks_on_cpu(mini_tree):
    """``tools/train_gpu.py --launcher pytorch --device cpu --dist_backend
    gloo`` with 2 ranks: one step of the global batch of 2 (a frame per
    rank), the same global loss on both, the checkpoint written by rank 0
    alone, the distributed evaluation after training and ``tools/
    test_gpu.py --launcher pytorch`` on rank 0 only."""
    tmp, root, cfg, _ = mini_tree
    out = tmp / 'cli'
    ranks = run_ranks(cli_rank, 2, (cfg, root, out, (_free_port(),
                                                     _free_port())),
                      backend=None, timeout=TIMEOUT)
    r0, r1 = ranks
    assert [s['step'] for s in r0['steps']] == [1] == \
        [s['step'] for s in r1['steps']]
    assert r0['steps'][0]['loss'] == r1['steps'][0]['loss']
    assert np.isfinite(r0['steps'][0]['loss'])
    assert r0['frames'] == r1['frames'] == 1
    assert [p.name for p in r0['checkpoints']] == ['checkpoint_epoch_1.pth']
    assert r1['checkpoints'] == []
    assert sorted(p.name for p in (out / 'ckpt').iterdir()) == [
        'checkpoint_epoch_1.pth']
    assert r0['eval'] and r1['eval'] is None
    assert any(k.endswith('_R40') for k in r0['eval'])
    assert r0['test'] == [3] and r1['test'] == [None]


def test_no_collective_without_a_process_group(monkeypatch):
    """A tiny training step without a group: nothing of
    ``torch.distributed`` is called and no collective is counted."""
    import torch.distributed as dist
    from virconv_tpu_torch.configs.tiny import tiny_train_config
    from virconv_tpu_torch.train.trainer import Trainer
    from chip_smoke import tiny_train_batch
    assert not dist.is_initialized()

    def refuse(*a, **k):
        raise AssertionError('a collective without a process group')
    for name in ('all_reduce', 'broadcast', 'barrier', 'all_gather'):
        monkeypatch.setattr(dist, name, refuse)
    dp.reset_counts()
    trainer = Trainer(tiny_train_config(), device='cpu', seed=0)
    loss, _ = trainer.step(tiny_train_batch(np.random.default_rng(0)))
    assert np.isfinite(float(loss))
    assert all(v == {'calls': 0, 'bytes': 0} for v in dp.COUNTS.values())
    assert not dp.active()
