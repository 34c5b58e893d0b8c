"""The whole evaluation loop of the tiny configuration (the width-shrunk
preset of tests/test_model_forward.py) on a 3-frame build_mini_kitti tree
(2 val frames, ROT_NUM 2): the port's ``eval_one_ckpt`` on the CPU (plain
kernel versions, f32 operands) against the JAX package's
``eval_one_ckpt``, with the same weights.

JAX runs from an orbax checkpoint written by
``virconv_tpu.train.trainer.save_checkpoint``; the port from the same
variables carried across by ``from_jax_variables`` and written by its
``save_checkpoint``. The JAX loop's ``jax.jit`` is replaced by the
identity while it runs (the port sums the NRConv image projection as eager
JAX does; under ``jit`` XLA rounds it differently). The JAX model runs its
plain paths with f32 operands: neighbour-map gather convs in 3D, the dense
NRConv 2D branch (first-wins duplicate pixels, as the band kernel and the
port) and the probe-path ROI pools, in place of the Pallas kernels that
tests/test_torch_detector.py runs in interpret mode. Tolerances: boxes
5e-3 and scores 2e-3 (absolute, after WBF, on the same frames), recall
counts and the AP dict equal."""
import copy
import logging
import os
import sys
from pathlib import Path

import cv2  # noqa: F401  the real OpenCV, as in test_torch_kitti_eval.py
import jax
import numpy as np
import pytest
import torch

from virconv_tpu.config import CfgNode as JCfg
from virconv_tpu_torch.config import CfgNode, virconv_t_config

from test_model_forward import shrink_cfg, tiny_cfg

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'tools'))
torch.set_num_threads(1)

JAX_ENV = {'VIRCONV_BAND': '0', 'VIRCONV_DENSE2D': '1',
           'VIRCONV_POOL_KERNEL': '0'}


def eval_cfg(root):
    """The tiny model over the VirConv-T data config cut to its range and
    voxels, ROT_NUM 2 (the tiny ROI head's), a low score threshold so
    random weights leave detections to compare."""
    model_cfg, data_cfg = tiny_cfg(mm=True)
    shrink_cfg(model_cfg, data_cfg)
    model_cfg.POST_PROCESSING.SCORE_THRESH = 0.3
    dcfg = virconv_t_config().DATA_CONFIG
    dcfg.DATA_PATH = str(root)
    dcfg.POINT_CLOUD_RANGE = list(data_cfg.POINT_CLOUD_RANGE)
    dcfg.DATA_PROCESSOR[2].VOXEL_SIZE = [0.1, 0.1, 0.1]
    dcfg.DATA_PROCESSOR[2].MAX_NUMBER_OF_VOXELS = dict(
        data_cfg.DATA_PROCESSOR[2].MAX_NUMBER_OF_VOXELS)
    dcfg.MAX_POINTS = {'lidar': 512, 'mm': 512}
    dcfg.ROT_NUM = model_cfg.ROI_HEAD.ROT_NUM
    return CfgNode({'CLASS_NAMES': ['Car'], 'MODEL': dict(model_cfg),
                    'DATA_CONFIG': dict(dcfg)})


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    from make_mini_kitti import build_mini_kitti
    from test_torch_detector import random_variables
    from test_model_forward import make_batch
    from virconv_tpu.datasets.kitti.kitti_dataset_mm import \
        KittiDatasetMM as JKitti
    from virconv_tpu.models.detectors.voxel_rcnn import VoxelRCNN as JRCNN
    from virconv_tpu.train import trainer as jtrainer
    from virconv_tpu.train.eval_loop import eval_one_ckpt as jeval
    from virconv_tpu_torch.train.checkpoint import save_checkpoint
    from virconv_tpu_torch.train.eval_loop import eval_one_ckpt
    from virconv_tpu_torch.utils.jax_weights import from_jax_variables
    from virconv_tpu_torch.utils.mini_kitti import write_infos

    tmp = tmp_path_factory.mktemp('evalloop')
    root = build_mini_kitti(tmp / 'kitti', n_frames=3, seed=0, n_train=1)
    write_infos(root)
    cfg = eval_cfg(root)
    jcfg = JCfg(copy.deepcopy(dict(cfg)))
    jmodel = JRCNN(model_cfg=jcfg.MODEL, dataset_cfg=jcfg.DATA_CONFIG)
    variables = random_variables(jmodel, make_batch(
        np.random.default_rng(0), n_entries=1, n_pts=512, train=True))
    state = jtrainer.TrainState(
        params=variables['params'], batch_stats=variables['batch_stats'],
        opt_state={'count': np.zeros((), np.int32)},
        step=np.zeros((), np.int32))
    jckpt = jtrainer.save_checkpoint(tmp / 'jax_ckpt', state, epoch=1)
    tckpt = save_checkpoint(tmp / 'port_ckpt',
                            from_jax_variables(variables), epoch=1)
    records = {'port': [], 'jax': []}

    def logger_for(name):
        logger = logging.getLogger(f'test_torch_eval_loop.{name}')
        logger.setLevel(logging.INFO)
        handler = logging.Handler()
        handler.emit = lambda r: records[name].append(r.getMessage())
        logger.addHandler(handler)
        return logger

    got = eval_one_ckpt(cfg, tckpt, logger_for('port'), tmp / 'port_out',
                        batch_size=2, device='cpu', save_to_file=True,
                        bf16=False, seed=1024)

    # the JAX loop returns its metric only: record its dicts on the way
    jax_annos = []
    jgen = JKitti.generate_prediction_dicts

    def generate(self, *a, **k):
        out = jgen(self, *a, **k)
        jax_annos.extend(out)
        return out
    saved = {k: os.environ.get(k) for k in JAX_ENV}
    os.environ.update(JAX_ENV)
    jit = jax.jit
    jax.jit = lambda fn, *a, **k: fn
    JKitti.generate_prediction_dicts = generate
    np.random.seed(1024)
    try:
        want = jeval(jcfg, jckpt, logger_for('jax'), tmp / 'jax_out',
                     batch_size=2, save_to_file=True)
    finally:
        jax.jit = jit
        JKitti.generate_prediction_dicts = jgen
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {'got': got, 'want': want, 'want_annos': jax_annos,
            'records': records, 'tmp': tmp}


def test_eval_loop_metric_matches_jax(runs):
    got, want = runs['got'], runs['want']
    assert got.frames == 2
    assert got.result_dict.keys() == want.keys() and len(want) == 9
    for k in want:
        assert got.result_dict[k] == want[k], k


def test_eval_loop_recalls_match_jax(runs):
    """The logged recall lines (hits / gt boxes per IoU threshold) are the
    same text."""
    lines = {name: [m for m in recs if m.startswith('recall_')]
             for name, recs in runs['records'].items()}
    assert len(lines['jax']) == 3
    assert lines['port'] == lines['jax']
    assert runs['got'].recalls['recall_0.3'][1] == 6     # 3 cars x 2


def test_eval_loop_detections_match_jax(runs):
    got, want = runs['got'].det_annos, runs['want_annos']
    assert [a['frame_id'] for a in got] == [a['frame_id'] for a in want]
    assert sum(len(a['score']) for a in got) > 0
    for g, w in zip(got, want):
        assert len(g['score']) == len(w['score']), g['frame_id']
        np.testing.assert_allclose(g['score'], w['score'], atol=2e-3)
        for k in ('boxes_lidar', 'location', 'dimensions', 'rotation_y'):
            np.testing.assert_allclose(g[k], w[k], atol=5e-3, err_msg=k)
        assert list(g['name']) == list(w['name'])
        txt = runs['tmp'] / 'port_out/final_result/data' / \
            f"{g['frame_id']}.txt"
        assert len(txt.read_text().splitlines()) == len(g['score'])
