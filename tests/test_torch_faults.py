"""Configurations the port does not implement raise instead of training or
serving something other than the JAX package: an optimizer the JAX package
does not build either (it builds ``adam_onecycle``, ``adam`` and ``sgd``,
``virconv_tpu/train/optim.py``, and so does the port). The RPN's ODIoU
loss term (``DENSE_HEAD.OD_LOSS``,
``virconv_tpu/models/dense_heads/anchor_head.py``) builds and reports
``rpn_loss_od`` (its values: tests/test_torch_odiou.py). The shipped
configuration still builds, without the term."""
import numpy as np
import pytest
import torch

from virconv_tpu_torch.config import virconv_t_config
from virconv_tpu_torch.models.dense_heads.anchor_head import AnchorHeadSingle
from virconv_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)


def _head(cfg):
    m, d = cfg.MODEL, cfg.DATA_CONFIG
    return AnchorHeadSingle(m.DENSE_HEAD, 64, len(cfg.CLASS_NAMES),
                            (1408, 1600), d.POINT_CLOUD_RANGE)


@pytest.mark.parametrize('name', ['foo'])
def test_trainer_refuses_optimizers_not_ported(name):
    cfg = virconv_t_config()
    cfg.OPTIMIZATION.OPTIMIZER = name
    with pytest.raises(NotImplementedError, match=name):
        Trainer(cfg=cfg, device='cpu')


@pytest.mark.parametrize('name,cls', [('adam_onecycle', 'AdamOneCycle'),
                                      ('adam', 'Adam'), ('sgd', 'SGD')])
def test_trainer_builds_each_optimizer(name, cls):
    cfg = virconv_t_config()
    assert cfg.OPTIMIZATION.OPTIMIZER == 'adam_onecycle'
    cfg.OPTIMIZATION.OPTIMIZER = name
    tr = Trainer(cfg=cfg, device='cpu')
    assert type(tr.optimizer).__name__ == cls


def _rpn_out(head, n_pos, seed=0):
    """A head output with targets at the head's anchors: n_pos positive
    anchors of one entry, their regression targets and small residuals."""
    rng = np.random.default_rng(seed)
    a = head.anchors.shape[0]

    def t(*shape, scale=0.1):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))
    labels = torch.zeros((1, a), dtype=torch.int64)
    labels[0, rng.choice(a, n_pos, replace=False)] = 1
    return {'cls_preds': t(1, a, 1), 'box_preds': t(1, a, 7),
            'dir_preds': t(1, a, 2),
            'targets': {'labels': labels, 'reg_targets': t(1, a, 7)}}


@pytest.mark.parametrize('flag', [True, 1])
def test_anchor_head_builds_with_od_loss(flag):
    cfg = virconv_t_config()
    cfg.MODEL.DENSE_HEAD.OD_LOSS = flag
    head = _head(cfg)
    lw = cfg.MODEL.DENSE_HEAD.LOSS_CONFIG.LOSS_WEIGHTS
    out = _rpn_out(head, 5)
    out['box_preds'].requires_grad_(True)
    total, tb = head.loss(out, lw, lw['code_weights'])
    assert set(tb) == {'rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir',
                       'rpn_loss_od'}
    od = float(tb['rpn_loss_od'])
    assert np.isfinite(od) and od > 0
    rest = sum(float(v) for k, v in tb.items() if k != 'rpn_loss_od')
    np.testing.assert_allclose(float(total), rest + od, rtol=1e-6)
    total.backward()
    assert torch.isfinite(out['box_preds'].grad).all()


@pytest.mark.parametrize('flag', [None, False, 0])
def test_anchor_head_builds_without_od_loss(flag):
    cfg = virconv_t_config()
    if flag is not None:
        cfg.MODEL.DENSE_HEAD.OD_LOSS = flag
    assert 'OD_LOSS' not in virconv_t_config().MODEL.DENSE_HEAD
    assert _head(cfg).anchors.shape[-1] == 7
