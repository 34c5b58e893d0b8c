"""Configurations the port does not implement yet raise instead of
training or serving something other than the JAX package: an optimizer
other than ``adam_onecycle`` (the JAX package also builds ``adam`` and
``sgd``, ``virconv_tpu/train/optim.py``), and the RPN's ODIoU loss term
(``DENSE_HEAD.OD_LOSS``, ``virconv_tpu/models/dense_heads/anchor_head.py``).
The shipped configuration still builds."""
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


@pytest.mark.parametrize('name', ['adam', 'sgd', 'foo'])
def test_trainer_refuses_optimizers_not_ported(name):
    cfg = virconv_t_config()
    cfg.OPTIMIZATION.OPTIMIZER = name
    with pytest.raises(NotImplementedError, match=name):
        Trainer(cfg=cfg, device='cpu')


def test_trainer_builds_adam_onecycle():
    cfg = virconv_t_config()
    assert cfg.OPTIMIZATION.OPTIMIZER == 'adam_onecycle'
    tr = Trainer(cfg=cfg, device='cpu')
    assert type(tr.optimizer).__name__ == 'AdamOneCycle'


@pytest.mark.parametrize('flag', [True, 1])
def test_anchor_head_refuses_od_loss(flag):
    cfg = virconv_t_config()
    cfg.MODEL.DENSE_HEAD.OD_LOSS = flag
    with pytest.raises(NotImplementedError, match='OD_LOSS'):
        _head(cfg)


@pytest.mark.parametrize('flag', [None, False, 0])
def test_anchor_head_builds_without_od_loss(flag):
    cfg = virconv_t_config()
    if flag is not None:
        cfg.MODEL.DENSE_HEAD.OD_LOSS = flag
    assert 'OD_LOSS' not in virconv_t_config().MODEL.DENSE_HEAD
    assert _head(cfg).anchors.shape[-1] == 7
