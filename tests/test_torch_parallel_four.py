"""Data parallelism of the port over 4 gloo ranks on the CPU, at tiny
sizes:

* ``sync_moments`` (sync-BN): ``MaskedBatchNorm`` and ``FlaxBatchNorm2d``
  in train mode with each rank holding a quarter of the rows give the
  one-process layer's outputs and running statistics (within 1e-5), and
  each all-reduce is one ``sync_bn`` span under ``trace.recording()``,
  none outside it;
* one data-parallel training step of the tiny preset on a 4-entry batch
  (one entry a rank, the one-process step's draws replayed to each rank
  by ``Draws.for_rank``): every rank's loss within rel 1e-5 of the
  one-process step's, its BN statistics within 1e-5, and the four ranks
  end with the same parameter bits.

The rank functions are module-level (the spawned processes import this
module)."""
import numpy as np
import pytest
import torch

from virconv_tpu_torch.parallel import data_parallel as dp
from virconv_tpu_torch.parallel.spawn import run_ranks, step_rank

torch.set_num_threads(1)
WORLD = 4
C = 6


def _bn_inputs():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4 * 5, C)).astype(np.float32) * 2 + 0.5
    mask = rng.uniform(size=len(x)) < 0.7
    dense = rng.standard_normal((4, C, 3, 5)).astype(np.float32)
    return x, mask, dense


def _bns(x, mask, dense, recording):
    from virconv_tpu_torch.models.layers import (FlaxBatchNorm2d,
                                                 MaskedBatchNorm)
    from virconv_tpu_torch.utils import trace
    masked, flax = MaskedBatchNorm(C).train(), FlaxBatchNorm2d(C).train()
    trace.reset()
    if recording:
        with trace.recording():
            y = masked(torch.from_numpy(x), torch.from_numpy(mask))
            z = flax(torch.from_numpy(dense))
    else:
        y = masked(torch.from_numpy(x), torch.from_numpy(mask))
        z = flax(torch.from_numpy(dense))
    spans = trace.snapshot()['spans']
    return {'y': y.detach(), 'z': z.detach(),
            'stats': [b.clone() for m in (masked, flax)
                      for b in (m.running_mean, m.running_var)],
            'sync_bn': spans.get('sync_bn', {}).get('calls', 0),
            'moments': dp.COUNTS['moments']['calls']}


def bn_rank(rank, world, payload):
    x, mask, dense, recording = payload
    rows = slice(rank * len(x) // world, (rank + 1) * len(x) // world)
    dp.reset_counts()
    with dp.synced():
        return _bns(x[rows], mask[rows], dense[rank:rank + 1], recording)


@pytest.mark.parametrize('recording', [True, False])
def test_sync_bn_over_four_ranks(recording):
    x, mask, dense = _bn_inputs()
    one = _bns(x, mask, dense, False)
    ranks = run_ranks(bn_rank, WORLD, (x, mask, dense, recording),
                      timeout=240)
    for r, got in enumerate(ranks):
        rows = slice(r * len(x) // WORLD, (r + 1) * len(x) // WORLD)
        np.testing.assert_allclose(got['y'].numpy(), one['y'][rows].numpy(),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got['z'].numpy(),
                                   one['z'][r:r + 1].numpy(), atol=1e-5,
                                   rtol=1e-5)
        for a, b in zip(got['stats'], one['stats']):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                       rtol=1e-5)
        assert got['moments'] > 0
        assert got['sync_bn'] == (got['moments'] if recording else 0)


def four_entry_batch():
    """test_torch_train_step.sparse_grid_batch with 4 entries, each its
    own grid of 8 valid points and two gt cars on it."""
    from test_model_forward import make_batch
    rng = np.random.default_rng(0)
    batch = {k: None if v is None else np.array(v) for k, v in
             make_batch(rng, n_entries=WORLD, n_pts=64, train=True).items()}
    grid = np.array([(x, y, -2.45) for x in (3.05, 12.05)
                     for y in (-6.05, -2.05, 2.05, 6.05)], np.float32)
    for key in ('points', 'points_mm'):
        for e in range(WORLD):
            batch[key][e, :8, :3] = grid + np.float32(0.3 * e)
    valid = np.zeros((WORLD, 64), bool)
    valid[:, :8] = True
    batch['points_valid'] = batch['points_mm_valid'] = valid
    v2r = np.array([[1, 0, 0], [0, 1, 0], [4, 0, 0], [0, 0, 1]], np.float32)
    p2t = np.array([[10, 0, 0], [0, 10, 0], [0, 0, 1], [200.3, 300.3, 0]],
                   np.float32)
    batch['v2r'] = np.tile(v2r, (WORLD, 1, 1))
    batch['p2t'] = np.tile(p2t, (WORLD, 1, 1))
    batch['trans_params'] = np.tile(np.float32([[0.0, 0.0, 1.0]]),
                                    (WORLD, 1))
    batch['gt_boxes'][:, 0] = [3.05, 2.05, -1.0, 3.9, 1.6, 1.56, 0.0, 1]
    batch['gt_boxes'][:, 1] = [12.05, -2.05, -1.0, 3.9, 1.6, 1.56, 0.0, 1]
    return batch


def test_train_step_over_four_ranks():
    from test_model_forward import shrink_cfg, tiny_cfg
    from virconv_tpu_torch.config import CfgNode, virconv_t_config
    from virconv_tpu_torch.train.draws import Draws
    from virconv_tpu_torch.train.trainer import Trainer
    model_cfg, data_cfg = tiny_cfg(mm=True)
    shrink_cfg(model_cfg, data_cfg)
    model_cfg.ROI_HEAD.DP_RATIO = 0.0
    nms = model_cfg.ROI_HEAD.NMS_CONFIG.TRAIN
    nms.NMS_PRE_MAXSIZE, nms.NMS_POST_MAXSIZE = 256, 128
    cfg = CfgNode({'CLASS_NAMES': ['Car'], 'MODEL': dict(model_cfg),
                   'DATA_CONFIG': dict(data_cfg),
                   'OPTIMIZATION': virconv_t_config().OPTIMIZATION})
    batch = four_entry_batch()
    trainer = Trainer(cfg, device='cpu', seed=3, total_steps=100)
    state_dict = {k: v.clone() for k, v in
                  trainer.model.state_dict().items()}
    draws = Draws(generator=torch.Generator().manual_seed(5))
    loss, _ = trainer.step(batch, draws)
    stats = dict(trainer.model.named_buffers())
    ranks = run_ranks(step_rank, WORLD, {
        'cfg': cfg, 'state_dict': state_dict, 'batch': batch,
        'device': 'cpu', 'total_steps': 100, 'seed': 3,
        'draws': [draws.for_rank(r, WORLD) for r in range(WORLD)]},
        timeout=400)
    for r in ranks:
        assert abs(r['loss'] - float(loss)) <= 1e-5 * abs(float(loss))
        for n, b in stats.items():
            np.testing.assert_allclose(r['buffers'][n].numpy(), b.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=n)
        assert r['steps'][0]['collectives']['grads']['calls'] == 1
        assert r['steps'][0]['collectives']['moments']['calls'] > 0
    for r in ranks[1:]:
        for n, p in ranks[0]['params'].items():
            assert torch.equal(p.view(torch.int32),
                               r['params'][n].view(torch.int32)), n
