"""The loaders of VirConv-S and VirConv-L against the JAX package's.

VirConv-S: ``KittiDatasetSemi`` on a synthetic tree with a semi split
(``utils/mini_kitti.write_tree(n_semi=...)``: ``semi/`` frames whose ids
repeat those of ``training/``, ``ImageSets/semi.txt`` and
``kitti_infos_trainsemi.pkl``): the ``trainsemi`` id list, each frame's raw
data read from its info's ``split`` subdirectory with a road plane only in
``training/``, and the training loader's collated batches over 2 epochs
equal to the JAX loader's, array for array (the port drawing from its
``RandomState(seed)``, JAX from numpy's global state after
``np.random.seed(seed)``).

VirConv-L (``LATER_FUSION`` False): the evaluation and training loaders'
batches equal to the JAX ones, with one fused stream (LiDAR first,
intensity / 10) and no ``points_mm`` keys. Tolerance: exact."""
import pickle

# the real OpenCV, as in test_torch_kitti_eval.py: the JAX dataset reads
# PNGs with it
import cv2  # noqa: F401
import numpy as np
import pytest
import torch

from virconv_tpu.config import CfgNode as JCfg
from virconv_tpu_torch.config import virconv_l_config, virconv_s_config

from test_torch_kitti_eval import assert_tree_equal

torch.set_num_threads(1)

N_FRAMES, N_TRAIN, N_SEMI = 4, 3, 2


@pytest.fixture(scope='module')
def semi_tree(tmp_path_factory):
    """A ``mini`` tree of 4 frames (3 train, 1 val) with its gt database
    and 2 semi frames."""
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    return write_tree(tmp_path_factory.mktemp('semi') / 'kitti', 'mini',
                      frames=N_FRAMES, seed=0, n_train=N_TRAIN,
                      n_semi=N_SEMI)


def data_cfgs(make, root):
    """(port, JAX) DATA_CONFIG of the shipped config ``make`` reading
    ``root``."""
    dcfg = make().DATA_CONFIG
    dcfg.DATA_PATH = str(root)
    return dcfg, JCfg(dict(make().DATA_CONFIG, DATA_PATH=str(root)))


def test_semi_tree_layout(semi_tree):
    with open(semi_tree / 'kitti_infos_trainsemi.pkl', 'rb') as f:
        infos = pickle.load(f)
    assert [i['split'] for i in infos] == ['training'] * N_TRAIN \
        + ['semi'] * N_SEMI
    assert [i['point_cloud']['lidar_idx'] for i in infos] == \
        ['000000', '000001', '000002', '000000', '000001']
    assert (semi_tree / 'ImageSets' / 'semi.txt').read_text().split() == \
        ['000000', '000001']
    for sub in ('velodyne_depth', 'calib', 'label_2', 'image_2'):
        assert (semi_tree / 'semi' / sub).is_dir()
    assert all(len(i['annos']['name']) for i in infos)


def test_semi_ids_and_raw_data_follow_the_split(semi_tree):
    """The trainsemi ids mix both subdirectories; a semi info's points and
    calibration come from ``semi/``, a training one's from ``training/``
    (the same frame ids hold different clouds there), and only training
    frames have a road plane."""
    from virconv_tpu_torch.datasets.kitti.kitti_dataset_semi import \
        KittiDatasetSemi
    dcfg, _ = data_cfgs(virconv_s_config, semi_tree)
    ds = KittiDatasetSemi(dcfg, ['Car'], training=True, seed=0)
    assert ds.sample_id_list == [['training', f'00000{i}']
                                 for i in range(3)] \
        + [['semi', '000000'], ['semi', '000001']]
    assert len(ds) == N_TRAIN + N_SEMI
    semi, train = ds.kitti_infos[N_TRAIN], ds.kitti_infos[0]
    assert semi['point_cloud']['lidar_idx'] == \
        train['point_cloud']['lidar_idx'] == '000000'
    assert ds.frame_root(semi) == semi_tree / 'semi'
    assert ds.frame_root(train) == semi_tree / 'training'
    got = ds.get_lidar_mm('000000', ds.frame_root(semi))
    want = np.load(semi_tree / 'semi' / 'velodyne_depth' / '000000.npy')
    np.testing.assert_array_equal(got, want.astype(np.float32))
    other = ds.get_lidar_mm('000000', ds.frame_root(train))
    assert got.shape != other.shape or not np.array_equal(got, other)
    assert ds.get_road_plane('000000', ds.frame_root(semi)) is None
    assert ds.get_road_plane('000000', ds.frame_root(train)) is not None


def test_semi_samples_equal_jax(semi_tree):
    """Each trainsemi sample (augmented, with the semi frames' own clouds
    and no road plane for them) equals the JAX dataset's."""
    from virconv_tpu.datasets.kitti.kitti_dataset_semi import \
        KittiDatasetSemi as JSemi
    from virconv_tpu_torch.datasets.kitti.kitti_dataset_semi import \
        KittiDatasetSemi
    tcfg, jcfg = data_cfgs(virconv_s_config, semi_tree)
    port = KittiDatasetSemi(tcfg, ['Car'], training=True, seed=5)
    jds = JSemi(jcfg, ['Car'], training=True)
    assert port.sample_id_list == jds.sample_id_list
    got = [port[i] for i in range(len(port))]
    np.random.seed(5)
    want = [jds[i] for i in range(len(jds))]
    for g, w in zip(got, want):
        assert_tree_equal(g, w)
    assert {g['frame_id'] for g in got[N_TRAIN:]} <= {'000000', '000001'}


def both_loaders(make, root, batch_size, seed, training):
    from virconv_tpu.datasets import build_dataloader as jbuild
    from virconv_tpu_torch.datasets import build_dataloader
    tcfg, jcfg = data_cfgs(make, root)
    _, loader = build_dataloader(tcfg, ['Car'], batch_size, seed=seed,
                                 training=training)
    np.random.seed(seed)
    _, jloader, _ = jbuild(jcfg, ['Car'], batch_size, training=training,
                           seed=seed)
    return loader, jloader


@pytest.mark.parametrize('batch_size', [1, 2])
def test_semi_training_batches_equal_jax(semi_tree, batch_size):
    """Two epochs of the VirConv-S training loader over training/ and
    semi/ frames: every collated batch and its meta equal."""
    from virconv_tpu_torch.datasets.kitti.kitti_dataset_semi import \
        KittiDatasetSemi
    loader, jloader = both_loaders(virconv_s_config, semi_tree, batch_size,
                                   9, True)
    assert isinstance(loader.dataset, KittiDatasetSemi)
    n = (N_TRAIN + N_SEMI) // batch_size
    assert len(loader) == len(jloader) == n
    for epoch in range(2):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == n
        for (gb, gm), (wb, wm) in zip(got, want):
            assert_tree_equal(gb, wb)
            assert_tree_equal(gm, wm)
            assert 'points_mm' in gb and gb['transform_param'] is None
    assert loader.frames == 2 * n * batch_size


@pytest.mark.parametrize('training', [False, True])
def test_single_stream_batches_equal_jax(semi_tree, training):
    """VirConv-L's loader (``LATER_FUSION`` False) at evaluation (val
    split) and in training (two epochs): the batches equal the JAX ones,
    with one fused stream and no ``points_mm``."""
    loader, jloader = both_loaders(virconv_l_config, semi_tree, 1, 3,
                                   training)
    n = N_TRAIN if training else N_FRAMES - N_TRAIN
    for epoch in range(2 if training else 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == n
        for (gb, gm), (wb, wm) in zip(got, want):
            assert_tree_equal(gb, wb)
            assert_tree_equal(gm, wm)
            assert not any(k.startswith('points_mm') for k in gb)
            assert gb['transform_param'] is None
            ind = gb['points'][0][gb['points_valid'][0]][:, 7]
            assert set(np.unique(ind)) == {1.0, 2.0}
            if not training:       # (the training shuffle mixes them)
                # LiDAR first, then the virtual points StVD keeps
                assert (np.diff((ind == 1).astype(int)) >= 0).all()
