"""The training heads of the port vs the JAX package, on numpy-seeded inputs
at the tiny preset of tests/test_model_forward.py: anchor target labels
bit-equal (targets and IoUs at 1e-5); the RPN loss terms; boxes_iou3d,
corner_loss and bb_loss (values at 1e-5, gradients of their sums at 1e-4,
since the losses are differentiated through the proposals); ROI proposal
targets with the JAX draws (split from the stage key as target_assign.py
splits it) handed to the port: sampled indices identical, outputs at 1e-5;
the TED cascade loss per term at rtol 1e-4."""
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.models.dense_heads import anchor_head as janchor
from virconv_tpu.models.detectors.voxel_rcnn import VoxelRCNN as JaxRCNN
from virconv_tpu.models.roi_heads import target_assign as jta
from virconv_tpu.ops import boxes as jbox
from virconv_tpu_torch.config import CfgNode
from virconv_tpu_torch.models.dense_heads import anchor_head as tanchor
from virconv_tpu_torch.models.detectors.voxel_rcnn import VoxelRCNN
from virconv_tpu_torch.models.roi_heads import target_assign as tta
from virconv_tpu_torch.ops import boxes as tbox
from virconv_tpu_torch.train.draws import Draws

from test_model_forward import tiny_cfg

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def models():
    """The tiny preset as a JAX module (its heads' methods run under
    ``apply`` with no variables: they read no parameters) and as the
    port's VoxelRCNN."""
    model_cfg, data_cfg = tiny_cfg(mm=True)
    jmodel = JaxRCNN(model_cfg=model_cfg, dataset_cfg=data_cfg)
    tmodel = VoxelRCNN(CfgNode(dict(model_cfg)), CfgNode(dict(data_cfg)),
                       num_class=1)
    return model_cfg, jmodel, tmodel


def _j(x):
    return jnp.asarray(np.asarray(x))


def _t(x):
    return torch.from_numpy(np.array(x))


def random_boxes(rng, n, center=(8.0, 0.0, -1.0), spread=(6.0, 6.0, 0.5)):
    b = np.zeros((n, 7), np.float32)
    b[:, :3] = rng.uniform(np.subtract(center, spread),
                           np.add(center, spread), (n, 3))
    b[:, 3:6] = rng.uniform([3.2, 1.4, 1.3], [4.6, 1.9, 1.8], (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def gt_near(rng, anchors_or_rois, n, jitter=0.3):
    """n gt cars near randomly chosen boxes (class 1), as (n, 8)."""
    pick = anchors_or_rois[rng.choice(len(anchors_or_rois), n,
                                       replace=False)]
    gt = np.concatenate([pick[:, :7], np.ones((n, 1), np.float32)], -1)
    gt[:, :3] += rng.uniform(-jitter, jitter, (n, 3)).astype(np.float32)
    gt[:, 6] += rng.uniform(-0.2, 0.2, n).astype(np.float32)
    return gt.astype(np.float32)


@pytest.mark.parametrize('any_gt', [True, False])
def test_assign_anchor_targets_labels_bit_equal(models, any_gt):
    _, _, tmodel = models
    anchors = tmodel.dense_head.anchors.numpy()
    rng = np.random.default_rng(0)
    gt = np.zeros((6, 8), np.float32)
    gt[:4] = gt_near(rng, anchors, 4)
    valid = np.zeros(6, bool)
    valid[:4] = any_gt
    args = (0.6, 0.45)
    want = janchor.assign_anchor_targets(
        _j(anchors), _j(gt), _j(valid), jbox.ResidualCoder(), *args)
    got = tanchor.assign_anchor_targets(
        _t(anchors), _t(gt), _t(valid), tbox.ResidualCoder(), *args)
    np.testing.assert_array_equal(got['labels'].numpy(),
                                  np.asarray(want['labels']))
    if any_gt:
        assert (got['labels'].numpy() > 0).sum() >= 4
    for k in ('reg_targets', 'reg_weights', 'ious'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_rpn_loss_terms_match(models):
    model_cfg, jmodel, tmodel = models
    head = tmodel.dense_head
    anchors = head.anchors.numpy()
    n = anchors.shape[0]
    rng = np.random.default_rng(1)
    tgts = []
    for _ in range(2):
        gt = gt_near(rng, anchors, 3)
        tgts.append(tanchor.assign_anchor_targets(
            _t(anchors), _t(gt), torch.ones(3, dtype=torch.bool),
            head.coder, head.matched_threshold, head.unmatched_threshold))
    tgt = {k: torch.stack([t[k] for t in tgts]) for k in tgts[0]}
    tgt['labels'][:, ::7] = -1              # some ignored anchors
    preds = {'cls_preds': rng.standard_normal((2, n, 1)),
             'box_preds': rng.standard_normal((2, n, 7)) * 0.3,
             'dir_preds': rng.standard_normal((2, n, 2))}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    lw = model_cfg.DENSE_HEAD.LOSS_CONFIG.LOSS_WEIGHTS
    cw = lw['code_weights']
    jout = {**{k: _j(v) for k, v in preds.items()},
            'targets': {k: _j(v.numpy()) for k, v in tgt.items()}}
    want_total, want_tb = jmodel.apply(
        {}, jout, lw, cw, method=lambda m, *a: m.dense_head.loss(*a))
    tout = {**{k: _t(v) for k, v in preds.items()}, 'targets': tgt}
    got_total, got_tb = head.loss(tout, lw, cw)
    assert set(got_tb) == set(want_tb)
    for k in want_tb:
        np.testing.assert_allclose(float(got_tb[k]), float(want_tb[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got_total), float(want_total),
                               rtol=1e-5)
    assert (tgt['labels'] > 0).any()


@pytest.mark.parametrize('fn', ['boxes_iou3d', 'corner_loss', 'bb_loss'])
def test_box_losses_and_their_gradients_match(fn):
    rng = np.random.default_rng(2)
    a = random_boxes(rng, 24)
    if fn == 'boxes_iou3d':
        b = np.concatenate([a[:8] + rng.uniform(-0.5, 0.5, (8, 7)).astype(
            np.float32), random_boxes(rng, 8)])
    else:
        b = a + rng.uniform(-0.6, 0.6, a.shape).astype(np.float32)
        b[:, 3:6] = np.abs(b[:, 3:6])
    jf, tf = getattr(jbox, fn), getattr(tbox, fn)
    want, vjp = jax.vjp(lambda x: jf(x, _j(b)), _j(a))
    x = _t(a).requires_grad_(True)
    got = tf(x, _t(b))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    if fn == 'boxes_iou3d':
        assert (np.asarray(want) > 0.3).sum() >= 4
    cot = rng.uniform(0.5, 1.5, np.shape(want)).astype(np.float32)
    got.backward(_t(cot))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(_j(cot))[0]),
                               atol=1e-4, rtol=1e-4)


def _jax_draws(rng_key, b, r, cfg):
    """The random numbers ``proposal_targets`` draws from ``rng_key``, split
    as target_assign.py splits it, in the order the port consumes them."""
    n = int(cfg.ROI_PER_IMAGE)
    keys = jax.random.split(rng_key, b + 1)
    draws = []
    for i in range(b):
        k1, k2, k3, k4 = jax.random.split(keys[i], 4)
        draws += [np.asarray(jax.random.uniform(k, (r,)), np.float32)
                  for k in (k1, k2, k3)]
        draws.append(np.asarray(jax.random.randint(k4, (n,), 0, 2 ** 30),
                                np.int64))
    if cfg.get('ENABLE_HARD_SAMPLING', False):
        teval = int(1 / cfg.HARD_SAMPLING_RATIO[0])
        draws.append(np.asarray(jax.random.randint(keys[b], (), 0, teval),
                                np.int64))
    return draws


@pytest.mark.parametrize('seed', [3, 4])
def test_proposal_targets_sample_identically(models, seed):
    model_cfg, _, _ = models
    cfg = model_cfg.ROI_HEAD.TARGET_CONFIG.STAGE0
    rng = np.random.default_rng(seed)
    b, r = 2, 48
    rois = np.stack([random_boxes(rng, r) for _ in range(b)])
    gt = np.zeros((b, 5, 8), np.float32)
    valid = np.zeros((b, 5), bool)
    for i in range(b):
        gt[i, :3] = gt_near(rng, rois[i], 3, jitter=0.4)
        valid[i, :3] = True
    # rois at every overlap level: some copies of gt boxes, slightly moved
    rois[:, :3] = gt[:, :3, :7] + rng.uniform(-0.3, 0.3, (b, 3, 7))
    scores = rng.uniform(0, 1, (b, r)).astype(np.float32)
    labels = np.ones((b, r), np.int32)
    key = jax.random.PRNGKey(seed)
    want = jta.proposal_targets(key, _j(rois), _j(scores), _j(labels),
                                _j(gt), _j(valid), cfg)
    draws = Draws(replay=_jax_draws(key, b, r, cfg))
    got = tta.proposal_targets(draws, _t(rois), _t(scores),
                               _t(labels).long(), _t(gt), _t(valid), cfg)
    assert not draws.replay
    idx = got['sampled'].numpy()
    np.testing.assert_array_equal(np.take_along_axis(rois, idx[..., None], 1),
                                  np.asarray(want['rois']))
    assert (np.asarray(want['reg_valid_mask']) > 0).any()
    for k in ('roi_labels', 'reg_valid_mask'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ('rois', 'roi_scores', 'gt_iou_of_rois', 'gt_of_rois',
              'gt_of_rois_src', 'rcnn_cls_labels'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_ted_loss_terms_match(models):
    model_cfg, jmodel, tmodel = models
    rng = np.random.default_rng(5)
    b, n = 2, 16
    stages = []
    for _ in range(2):
        rois = np.stack([random_boxes(rng, n) for _ in range(b)])
        src = rois + rng.uniform(-0.4, 0.4, rois.shape).astype(np.float32)
        src = np.concatenate([src, np.ones((b, n, 1), np.float32)], -1)
        canon = np.asarray(jta._canonical_gt(_j(rois), _j(src)))
        tgt = {'rcnn_cls_labels': rng.uniform(0, 1, (b, n)).astype(
                   np.float32),
               'reg_valid_mask': (rng.uniform(0, 1, (b, n)) < 0.5).astype(
                   np.int32),
               'gt_of_rois': canon, 'gt_of_rois_src': src}
        tgt['rcnn_cls_labels'][0, :3] = -1          # ignored rows
        st = {'targets': tgt, 'rois': rois}
        for br in ('', '_pi', '_p'):
            st[f'rcnn_cls{br}'] = rng.standard_normal((b * n, 1)).astype(
                np.float32)
            st[f'rcnn_reg{br}'] = (rng.standard_normal((b * n, 7))
                                   * 0.2).astype(np.float32)
        stages.append(st)
    lw = model_cfg.ROI_HEAD.LOSS_CONFIG.LOSS_WEIGHTS
    cw = lw['code_weights']
    to_j = jax.tree_util.tree_map(_j, stages)
    to_t = jax.tree_util.tree_map(_t, stages)
    want_total, want_tb = jmodel.apply(
        {}, to_j, lw, cw, method=lambda m, *a: m.roi_head.loss(*a))
    got_total, got_tb = tmodel.roi_head.loss(to_t, lw, cw)
    assert set(got_tb) == set(want_tb)
    for k in want_tb:
        np.testing.assert_allclose(float(got_tb[k]), float(want_tb[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(got_total), float(want_total),
                               rtol=1e-4)
    assert float(want_tb['rcnn_reg_fg_s0']) > 0
