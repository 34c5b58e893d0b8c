"""The port's LiDAR-only ``KittiDataset``
(virconv_tpu_torch/datasets/kitti/kitti_dataset.py) against the JAX
package's (virconv_tpu/datasets/kitti/kitti_dataset.py) on a
``build_mini_kitti`` tree with the JAX package's infos, under VirConv-T's
data config (its ``_mm`` point encoding) with ``DATASET: 'KittiDataset'``:
every evaluation sample, training samples (the augmentations drawn from a
``RandomState(s)`` on the port and numpy's global state after
``np.random.seed(s)`` in JAX), a training sample that is redrawn when no
gt box is left, and ``build_dataloader`` returning the class. Tolerance:
exact."""
import numpy as np
import pytest
import torch

from virconv_tpu.datasets.kitti.kitti_dataset import \
    KittiDataset as JKittiDataset
from virconv_tpu_torch.datasets import build_dataloader
from virconv_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset

from test_torch_kitti_eval import assert_tree_equal
from test_torch_train_loader import jax_data_cfg, port_data_cfg, raw_tree

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """A 5-frame build_mini_kitti tree (3 train, 2 val) with the JAX
    package's infos and gt database."""
    from make_mini_kitti import build_infos
    return build_infos(raw_tree(tmp_path_factory.mktemp('kitti')))


def both(tree, training, seed=0):
    over = {'DATASET': 'KittiDataset'}
    port = KittiDataset(port_data_cfg(tree, **over), ['Car'],
                        training=training, seed=seed)
    jds = JKittiDataset(jax_data_cfg(tree, **over), ['Car'],
                        training=training)
    return port, jds


def test_eval_samples_equal_jax(tree):
    port, jds = both(tree, training=False)
    assert len(port) == len(jds) == 2
    for i in range(len(port)):
        got, want = port[i], jds[i]
        assert got['points'].shape[1] == want['points'].shape[1]
        assert_tree_equal(got, want)
    assert 'gt_boxes' in got and len(got['points'])


@pytest.mark.parametrize('seed', [3, 7])
def test_training_samples_equal_jax(tree, seed):
    port, jds = both(tree, training=True, seed=seed)
    np.random.seed(seed)
    for i in range(len(port)):
        got, want = port[i], jds[i]
        assert_tree_equal(got, want)
        assert len(got['gt_boxes'])


def test_empty_sample_is_redrawn_as_jax(tree, monkeypatch):
    port, jds = both(tree, training=True, seed=4)
    for ds in (port, jds):
        prepare = ds.prepare_data

        def no_gt_in_frame_0(data_dict, prepare=prepare):
            out = prepare(data_dict)
            return None if data_dict['frame_id'] == '000000' else out
        monkeypatch.setattr(ds, 'prepare_data', no_gt_in_frame_0)
    got = port[0]
    np.random.seed(4)
    want = jds[0]
    assert got['frame_id'] != '000000'
    assert_tree_equal(got, want)


def test_build_dataloader_returns_kitti_dataset(tree):
    cfg = port_data_cfg(tree, DATASET='KittiDataset')
    dataset, loader = build_dataloader(cfg, ['Car'], 1)
    assert type(dataset) is KittiDataset
    batch, _ = next(iter(loader))
    assert batch['points'].shape[-1] >= 4
