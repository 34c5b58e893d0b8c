"""The port's KITTI training host path against the JAX package's, on the
same inputs and seeds: each augmentor function (the port drawing from a
``RandomState(s)``, JAX from numpy's global state after
``np.random.seed(s)``: the same outputs, the same in-place changes and the
same number of draws), the gt database (``.bin`` files and
``kitti_dbinfos_train_mm.pkl`` byte for byte), ``create_kitti_infos``, a
sample that is redrawn when no gt box is left, and the training loader's
collated batches over 2 epochs (shuffle, ``drop_last``, ``aug_param`` ->
``trans_params``) on a ``build_mini_kitti`` tree and on a 2-frame
``scene`` tree. Tolerance: exact."""
import copy
import pickle
import shutil
import sys
from pathlib import Path

# the real OpenCV, as in test_torch_kitti_eval.py: build_mini_kitti and the
# JAX dataset read and write PNGs with it
import cv2  # noqa: F401
import numpy as np
import pytest
import torch

from virconv_tpu.config import CfgNode as JCfg
from virconv_tpu.datasets.augmentor import augmentor_utils as jau
from virconv_tpu_torch.config import virconv_t_config
from virconv_tpu_torch.datasets.augmentor import augmentor_utils as tau

from test_torch_kitti_eval import assert_tree_equal

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'tools'))
torch.set_num_threads(1)


# ---------------------------------------------------------- augmentors -----
def street(rng, n_boxes=6, per_box=300, n_bg=2000):
    """Well separated cars with ``per_box`` 8-feature points inside each,
    and background points."""
    boxes = np.zeros((n_boxes, 7), np.float32)
    boxes[:, 0] = 8.0 + 9.0 * np.arange(n_boxes)
    boxes[:, 1] = rng.uniform(-6, 6, n_boxes)
    boxes[:, 2] = -1.0
    boxes[:, 3:6] = [3.9, 1.6, 1.56]
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_boxes)
    pts = []
    for b in boxes:
        lx = rng.uniform(-0.45, 0.45, per_box) * b[3]
        ly = rng.uniform(-0.45, 0.45, per_box) * b[4]
        c, s = np.cos(b[6]), np.sin(b[6])
        p = np.zeros((per_box, 8), np.float32)
        p[:, 0] = b[0] + lx * c - ly * s
        p[:, 1] = b[1] + lx * s + ly * c
        p[:, 2] = b[2] + rng.uniform(-0.45, 0.45, per_box) * b[5]
        p[:, 3:8] = rng.uniform(0, 1, (per_box, 5))
        pts.append(p)
    bg = np.zeros((n_bg, 8), np.float32)
    bg[:, 0] = rng.uniform(0, 70, n_bg)
    bg[:, 1] = rng.uniform(-30, 30, n_bg)
    bg[:, 2] = rng.uniform(-2.5, 0.5, n_bg)
    bg[:, 3:8] = rng.uniform(0, 1, (n_bg, 5))
    return boxes, np.concatenate(pts + [bg])


NOISE = dict(rotation_perturb=[-0.78539816, 0.78539816],
             center_noise_std=[1.0, 1.0, 0.5], extra_width=[0.2, 0.2, 0.0])


def pyramid_chain(m, b, p, *rng):
    """dropout -> sparsify -> swap, passing the pyramids along, as
    ``random_local_pyramid_aug`` does."""
    b, p, pyr = m.local_pyramid_dropout(b, p, 0.4, *rng)
    b, p, pyr = m.local_pyramid_sparsify(b, p, 0.5, 20, *rng, pyr)
    return m.local_pyramid_swap(b, p, 0.9, 20, *rng, pyr)


# name -> f(module, boxes, points, *rng): the JAX function takes no rng
AUGMENTORS = {
    'random_flip_along_x': lambda m, b, p, *r: m.random_flip_along_x(
        b, p, *r),
    'global_rotation': lambda m, b, p, *r: m.global_rotation(
        b, p, [-0.78539816, 0.78539816], *r),
    'global_scaling': lambda m, b, p, *r: m.global_scaling(
        b, p, [0.95, 1.05], *r),
    'noise_per_object': lambda m, b, p, *r: m.noise_per_object(
        b, p, *r, valid_mask=np.arange(len(b)) != 2, **NOISE),
    'local_pyramid_dropout': lambda m, b, p, *r: m.local_pyramid_dropout(
        b, p, 0.5, *r),
    'local_pyramid_sparsify': lambda m, b, p, *r: m.local_pyramid_sparsify(
        b, p, 0.6, 20, *r),
    'local_pyramid_swap': lambda m, b, p, *r: m.local_pyramid_swap(
        b, p, 0.8, 20, *r),
    'pyramid_chain': pyramid_chain,
}


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('name', sorted(AUGMENTORS))
def test_augmentor_equals_jax(name, seed):
    boxes, points = street(np.random.default_rng(10 + seed))
    fn = AUGMENTORS[name]
    tb, tp = boxes.copy(), points.copy()
    rng = np.random.RandomState(seed)
    got = fn(tau, tb, tp, rng)
    jb, jp = boxes.copy(), points.copy()
    np.random.seed(seed)
    want = fn(jau, jb, jp)
    assert_tree_equal([tb, tp], [jb, jp])       # the in-place changes
    if want is not None:
        assert len(got) == len(want)
        assert_tree_equal(list(got), list(want))
    # the same number of draws: both streams are at the same place
    assert rng.random_sample() == np.random.random_sample()
    out_boxes, out_points = (jb, jp) if want is None else want[:2]
    assert name == 'random_flip_along_x' or not (
        np.array_equal(out_boxes, boxes)
        and np.array_equal(out_points, points))


def test_remove_points_in_boxes_equals_jax():
    boxes, points = street(np.random.default_rng(3))
    large = tau.enlarge_box3d(boxes, [0.0, 0.0, -0.2])
    np.testing.assert_array_equal(large, jau.enlarge_box3d(boxes,
                                                           [0.0, 0.0, -0.2]))
    got = tau.remove_points_in_boxes3d(points, large)
    np.testing.assert_array_equal(got, jau.remove_points_in_boxes3d(points,
                                                                    large))
    assert len(got) < len(points) - 1000


# ------------------------------------------------------- trees and infos ---
def port_data_cfg(root, **over):
    dcfg = virconv_t_config().DATA_CONFIG
    dcfg.DATA_PATH = str(root)
    for k, v in over.items():
        dcfg[k] = v
    return dcfg


def jax_data_cfg(root, **over):
    return JCfg(copy.deepcopy(dict(port_data_cfg(root, **over))))


def raw_tree(dst, n_frames=5, n_train=3):
    from make_mini_kitti import build_mini_kitti
    return build_mini_kitti(dst, n_frames=n_frames, seed=0, n_train=n_train)


@pytest.fixture(scope='module')
def mini_tree(tmp_path_factory):
    """A 5-frame build_mini_kitti tree (3 train, 2 val) with the JAX
    package's infos and gt database."""
    from make_mini_kitti import build_infos
    return build_infos(raw_tree(tmp_path_factory.mktemp('kitti')))


@pytest.fixture(scope='module')
def scene_tree(tmp_path_factory):
    """A 2-frame KITTI-scale ``scene`` tree, both frames in the train split,
    with the port's infos and gt database."""
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    return write_tree(tmp_path_factory.mktemp('scene') / 'kitti', 'scene',
                      frames=2, seed=0, n_train=2)


def assert_same_files(got_root, want_root, rel):
    """The file ``rel``, or every file under the directory ``rel``, byte
    for byte."""
    def files(root):
        top = root / rel
        found = [top] if top.is_file() else \
            [p for p in top.rglob('*') if p.is_file()]
        return sorted(p.relative_to(root) for p in found)
    want, got = files(want_root), files(got_root)
    assert got == want and want
    for r in want:
        assert (got_root / r).read_bytes() == (want_root / r).read_bytes(), r


def test_gt_database_equals_jax(mini_tree, tmp_path):
    """The port's ``create_groundtruth_database`` over the JAX infos of the
    same tree writes the same files, byte for byte."""
    from virconv_tpu_torch.datasets.kitti.kitti_dataset_mm import \
        KittiDatasetMM
    root = tmp_path / 'kitti'
    shutil.copytree(mini_tree, root,
                    ignore=shutil.ignore_patterns('gt_database_mm',
                                                  'kitti_dbinfos_*'))
    ds = KittiDatasetMM(port_data_cfg(root), ['Car'], root_path=root)
    infos = ds.create_groundtruth_database(root / 'kitti_infos_train.pkl',
                                           used_classes=['Car'])
    assert len(infos['Car']) == 9                  # 3 frames x 3 cars
    assert_same_files(root, mini_tree, 'gt_database_mm')
    assert_same_files(root, mini_tree, 'kitti_dbinfos_train_mm.pkl')


def test_create_kitti_infos_equals_jax(tmp_path):
    """``create_kitti_infos`` on two copies of one raw tree: the same infos
    (array for array) and the same gt database (byte for byte)."""
    from virconv_tpu.datasets.kitti.kitti_dataset_mm import \
        create_kitti_infos as jcreate
    from virconv_tpu_torch.datasets.kitti.kitti_dataset_mm import \
        create_kitti_infos
    want_root = raw_tree(tmp_path / 'jax')
    got_root = tmp_path / 'port'
    shutil.copytree(want_root, got_root)
    names = ['Car', 'Pedestrian', 'Cyclist']
    jcreate(jax_data_cfg(want_root), names, want_root, want_root, workers=1)
    create_kitti_infos(port_data_cfg(got_root), names, got_root, got_root,
                       workers=1)
    for split in ('train', 'val'):
        with open(got_root / f'kitti_infos_{split}.pkl', 'rb') as f:
            got = pickle.load(f)
        with open(want_root / f'kitti_infos_{split}.pkl', 'rb') as f:
            want = pickle.load(f)
        assert len(got) == len(want) == {'train': 3, 'val': 2}[split]
        assert_tree_equal(got, want)
    assert_same_files(got_root, want_root, 'gt_database_mm')
    assert_same_files(got_root, want_root, 'kitti_dbinfos_train_mm.pkl')


def test_scene_writer_writes_the_gt_database(scene_tree):
    with open(scene_tree / 'kitti_dbinfos_train_mm.pkl', 'rb') as f:
        infos = pickle.load(f)
    cars = infos['Car']
    assert len(cars) >= 10
    n_files = len(list((scene_tree / 'gt_database_mm').glob('*.bin')))
    assert n_files == len(cars)
    obj = np.fromfile(scene_tree / cars[0]['path'], np.float32).reshape(
        -1, 8)
    assert set(np.unique(obj[:, 7])) <= {1.0, 2.0}
    assert cars[0]['num_points_in_gt'] == int((obj[:, 7] == 2).sum())


# ------------------------------------------------------------ the loader ---
def test_empty_sample_is_redrawn_as_jax(mini_tree, monkeypatch):
    """A training sample whose gt boxes are all gone is replaced by the
    sample of an index drawn from the dataset's RandomState, as the JAX
    dataset draws it from numpy's global state."""
    from virconv_tpu.datasets.kitti.kitti_dataset_mm import \
        KittiDatasetMM as JKitti
    from virconv_tpu_torch.datasets.kitti.kitti_dataset_mm import \
        KittiDatasetMM
    port = KittiDatasetMM(port_data_cfg(mini_tree), ['Car'], training=True,
                          seed=4)
    jds = JKitti(jax_data_cfg(mini_tree), ['Car'], training=True)
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


class _Frames:
    """A stand-in training dataset: frame i is i, frame ``bad`` is None."""

    def __init__(self, n, bad):
        self.n, self.bad = n, bad
        self.rng = np.random.RandomState(0)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return None if i == self.bad else i

    @staticmethod
    def collate_batch(samples):
        return samples


def test_loader_shuffles_drops_the_last_batch_and_redraws_none():
    from virconv_tpu_torch.datasets import DataLoader
    loader = DataLoader(_Frames(7, bad=3), 2, shuffle=True, seed=5,
                        drop_last=True)
    assert len(loader) == 3
    epochs = []
    redraw = np.random.RandomState(0)        # the dataset's draws
    for epoch in range(2):
        loader.set_epoch(epoch)
        order = np.arange(7)
        np.random.default_rng(5 + epoch).shuffle(order)
        want = order[:6].reshape(3, 2).tolist()
        got = list(loader)
        for w, g in zip(want, got):
            for wi, gi in zip(w, g):
                while wi == 3:
                    wi = redraw.randint(7)
                assert gi == wi
        epochs.append(got)
    assert epochs[0] != epochs[1]


def both_loaders(tcfg, jcfg, batch_size, seed):
    from virconv_tpu.datasets import build_dataloader as jbuild
    from virconv_tpu_torch.datasets import build_dataloader
    _, loader = build_dataloader(tcfg, ['Car'], batch_size, seed=seed,
                                 training=True)
    np.random.seed(seed)
    _, jloader, _ = jbuild(jcfg, ['Car'], batch_size, training=True,
                           seed=seed)
    return loader, jloader


@pytest.mark.parametrize('tree,batch_size', [('mini', 1), ('mini', 2),
                                             ('scene', 2)])
def test_training_batches_equal_jax(tree, batch_size, mini_tree, scene_tree):
    """Two epochs of the training loader: every collated batch (points,
    masks, calibration, gt boxes, ``trans_params``) and its meta equal."""
    root = mini_tree if tree == 'mini' else scene_tree
    loader, jloader = both_loaders(port_data_cfg(root), jax_data_cfg(root),
                                   batch_size, seed=9)
    n_frames = 3 if tree == 'mini' else 2
    assert len(loader) == len(jloader) == n_frames // batch_size
    for epoch in range(2):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == n_frames // batch_size
        for (gb, gm), (wb, wm) in zip(got, want):
            assert_tree_equal(gb, wb)
            assert_tree_equal(gm, wm)
            assert gb['transform_param'] is None
            assert gb['trans_params'].shape == (batch_size, 3)
            assert gb['points'].shape[0] == batch_size     # rot_num 1
            assert gb['gt_valid'].sum(1).min() > 0
    assert loader.frames == 2 * (n_frames // batch_size) * batch_size
    if tree == 'scene':                 # KITTI-scale streams
        assert gb['points_valid'].sum() > 20000
        assert gb['gt_valid'].sum() > 20
