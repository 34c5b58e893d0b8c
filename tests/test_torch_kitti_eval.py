"""The port's KITTI evaluation host path against the JAX package's, on the
same inputs: the native box ops (bit for bit: the same C++ text built with
the same flags), WBF on clusters near its IoU thresholds, the eval-time
StVD discard, infos, loader samples and collated batches (the port's
``RandomState(s)`` against numpy's global state after ``np.random.seed(s)``),
prediction dicts (fields to 1e-6, ``.txt`` files byte for byte), the
official AP(R40) metric on both of its branches (result dict equal, result
string identical), ``--set`` overrides, checkpoints, and the synthetic
KITTI writer."""
import copy
import pickle
import sys
from pathlib import Path

# imported while the tests are collected, so that the real OpenCV is the
# one in sys.modules: build_mini_kitti and the JAX dataset read and write
# PNGs with it, and tests/reference_torch.py puts an empty stand-in there
# only when none is loaded yet
import cv2
import numpy as np
import pytest
import torch

from virconv_tpu.config import CfgNode as JCfg
from virconv_tpu.ops import native as jnative
from virconv_tpu_torch.config import virconv_t_config
from virconv_tpu_torch.ops import boxes_np as tboxes_np
from virconv_tpu_torch.ops import native as tnative

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'tools'))

torch.set_num_threads(1)


def random_boxes(rng, n, span=20.0):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(-span / 2, span / 2, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:5] = rng.uniform(1.0, 4.5, (n, 2))
    b[:, 5] = rng.uniform(1.0, 2.5, n)
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def assert_tree_equal(got, want, path=''):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_tree_equal(got[k], want[k], f'{path}/{k}')
    elif hasattr(want, 'device_matrices'):             # Calibration
        for a, b in zip(got.device_matrices(), want.device_matrices()):
            np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(want, (list, tuple)) and want \
            and not np.isscalar(want[0]):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f'{path}[{i}]')
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype,
                                                          w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)


# ------------------------------------------------------------ native -------
def test_box_ops_source_equals_the_root_copy():
    """The port's csrc/box_ops.cpp is the root file's text from the first
    #include on (only the header comment differs)."""
    def body(p):
        text = p.read_text()
        return text[text.index('#include <algorithm>'):]
    assert body(ROOT / 'virconv_tpu_torch/csrc/box_ops.cpp') == \
        body(ROOT / 'csrc/box_ops.cpp')


def test_native_library_builds_and_loads():
    assert tnative.available()
    assert jnative.available()
    assert tnative._target()[1].exists()


@pytest.mark.parametrize('seed', [0, 1])
def test_native_pair_ops_equal_jax_native(seed):
    rng = np.random.default_rng(seed)
    a, b = random_boxes(rng, 40), random_boxes(rng, 33)
    b[:10] = a[:10] + rng.normal(0, 0.2, (10, 7)).astype(np.float32)
    for name in ('boxes_overlap_bev', 'boxes_iou_bev', 'boxes_iou3d'):
        np.testing.assert_array_equal(getattr(tnative, name)(a, b),
                                      getattr(jnative, name)(a, b), name)


def test_native_nms_and_points_in_boxes_equal_jax_native():
    rng = np.random.default_rng(2)
    boxes = random_boxes(rng, 200, span=40.0)
    scores = rng.uniform(0, 1, 200).astype(np.float32)
    for pre, post in ((None, 100), (150, 50)):
        np.testing.assert_array_equal(
            tnative.nms_bev(boxes, scores, 0.5, pre, post),
            jnative.nms_bev(boxes, scores, 0.5, pre, post))
    pts = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1, 1, 3000)
    got = tnative.points_in_boxes(pts, boxes[:20])
    np.testing.assert_array_equal(got, jnative.points_in_boxes(pts,
                                                               boxes[:20]))
    assert (got >= 0).any()


@pytest.mark.parametrize('compute_fp,metric', [(False, 2), (True, 0),
                                               (True, 2)])
def test_native_kitti_statistics_equal_jax_native(compute_fp, metric):
    rng = np.random.default_rng(3)
    det, gt = 12, 9
    overlaps = rng.uniform(0, 1, (det, gt))
    args = (overlaps, rng.uniform(0, 1, det), rng.uniform(-3, 3, det),
            rng.uniform(-3, 3, gt), rng.integers(-1, 2, gt),
            rng.integers(-1, 2, det),
            rng.uniform(0, 1, (det, 2)) if metric == 0 else None, metric,
            0.5, 0.3, compute_fp, compute_fp)
    got = tnative.kitti_compute_statistics(*args)
    want = jnative.kitti_compute_statistics(*args)
    assert got[:4] == want[:4]
    np.testing.assert_array_equal(got[4], want[4])


def test_native_fallback_is_the_numpy_path(monkeypatch):
    """Without the library every entry point is ``boxes_np``'s."""
    rng = np.random.default_rng(4)
    a, b = random_boxes(rng, 12), random_boxes(rng, 9)
    monkeypatch.setattr(tnative, '_LIB', None)
    monkeypatch.setattr(tnative, '_TRIED', True)
    assert not tnative.available()
    np.testing.assert_array_equal(tnative.boxes_iou_bev(a, b),
                                  tboxes_np.boxes_iou_bev(a, b))
    assert tnative.kitti_compute_statistics(
        np.zeros((1, 1)), np.zeros(1), np.zeros(1), np.zeros(1),
        np.zeros(1, np.int64), np.zeros(1, np.int64), None, 2, 0.7, 0.0,
        False, False) is None


# --------------------------------------------------------------- WBF -------
def near_threshold_clusters(rng, n_centers=6, per=6):
    """Score-sorted detections around a few centres whose BEV IoUs with
    their centre land near WBF's 0.85 / 0.1 / 0.03 thresholds."""
    boxes, scores = [], []
    for c in random_boxes(rng, n_centers, span=30.0):
        boxes.append(c)
        scores.append(rng.uniform(0.6, 1.0))
        for _ in range(per):
            b = c.copy()
            shift = rng.choice([0.03, 0.08, 0.5, 1.4, 1.9, 2.6]) * c[3]
            ang = rng.uniform(-np.pi, np.pi)
            b[0] += shift * np.cos(ang)
            b[1] += shift * np.sin(ang)
            b[6] += rng.normal(0, 0.1)
            boxes.append(b)
            scores.append(rng.uniform(0.3, 1.0))
    return (np.ones(len(boxes), np.int64), np.asarray(scores),
            np.asarray(boxes, np.float32))


@pytest.mark.parametrize('seed,retain_low', [(0, False), (1, True),
                                             (2, True), (3, False)])
def test_wbf_equals_jax_near_thresholds(seed, retain_low):
    from virconv_tpu.ops.wbf import compute_wbf as jwbf
    from virconv_tpu_torch.ops.wbf import compute_wbf as twbf
    rng = np.random.default_rng(seed)
    labels, scores, boxes = near_threshold_clusters(rng)
    iou = jnative.boxes_iou_bev(boxes, boxes)
    assert ((iou > 0.75) & (iou < 0.95)).any()      # near the 0.85 rule
    kw = dict(iou_thresh=0.85, retain_low=retain_low, score_thresh=0.4)
    got = twbf(labels, scores, boxes, **kw)
    want = jwbf(labels, scores, boxes, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 1 < len(got[1]) < len(scores)


# -------------------------------------------------------------- StVD -------
@pytest.mark.parametrize('bin_num,rate,seed', [(10, 0.8, 0), (10, 0.9, 1),
                                               (2, 0.8, 2), (10, 0.5, 3),
                                               (5, 0.8, 4)])
def test_input_point_discard_equals_jax(bin_num, rate, seed):
    """The port's dataset draws from its RandomState(seed) what the JAX
    dataset draws from numpy's global state after np.random.seed(seed)."""
    from virconv_tpu.datasets.dataset import DatasetTemplate as JTemplate
    from virconv_tpu_torch.datasets.dataset import DatasetTemplate
    rng = np.random.default_rng(100 + seed)
    pts = np.zeros((6000, 8), np.float32)
    pts[:, 0] = np.minimum(rng.exponential(15.0, 6000), 70.0)
    pts[:, 1:7] = rng.normal(size=(6000, 6))
    port = object.__new__(DatasetTemplate)
    port.rng = np.random.RandomState(seed)
    got = [port.input_point_discard(pts, bin_num, rate) for _ in range(2)]
    np.random.seed(seed)
    jax_ds = object.__new__(JTemplate)
    want = [jax_ds.input_point_discard(pts, bin_num, rate)
            for _ in range(2)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) < len(pts)


def test_training_loader_raises(tmp_path):
    """``build_dataloader`` raises for a dataset the port does not register,
    and builds VirConv-S's ``KittiDatasetSemi`` training loader over
    ``training/`` and ``semi/`` frames."""
    from virconv_tpu_torch.config import virconv_s_config
    from virconv_tpu_torch.datasets import build_dataloader
    from virconv_tpu_torch.datasets.kitti.kitti_dataset_semi import \
        KittiDatasetSemi
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    cfg = virconv_s_config()
    cfg.DATA_CONFIG.DATASET = 'KittiDatasetUnknown'
    with pytest.raises(NotImplementedError, match='KittiDatasetUnknown'):
        build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1)
    root = write_tree(tmp_path / 'kitti', 'mini', frames=3, seed=0,
                      n_train=2, n_semi=1)
    cfg = virconv_s_config()
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1,
                                       training=True)
    assert isinstance(dataset, KittiDatasetSemi)
    assert {s[0] for s in dataset.sample_id_list} == {'training', 'semi'}
    batches = list(loader)
    assert len(batches) == 3
    assert all(b['gt_valid'].any() for b, _ in batches)


# ---------------------------------------------------- tree, infos, loader ---
@pytest.fixture(scope='module')
def mini_tree(tmp_path_factory):
    """A 5-frame build_mini_kitti tree (3 train, 2 val) with the JAX
    package's infos."""
    from make_mini_kitti import build_mini_kitti
    from virconv_tpu.datasets.kitti.kitti_dataset_mm import \
        KittiDatasetMM as JKitti
    root = build_mini_kitti(tmp_path_factory.mktemp('kitti'), n_frames=5,
                            seed=0, n_train=3)
    ds = JKitti(jax_data_cfg(root), ['Car'], training=False, root_path=root)
    for split in ('train', 'val'):
        ds.set_split(split)
        with open(root / f'kitti_infos_{split}.pkl', 'wb') as f:
            pickle.dump(ds.get_infos(num_workers=1), f)
    return root


def port_data_cfg(root, **over):
    dcfg = virconv_t_config().DATA_CONFIG
    dcfg.DATA_PATH = str(root)
    for k, v in over.items():
        dcfg[k] = v
    return dcfg


def jax_data_cfg(root, **over):
    return JCfg(copy.deepcopy(dict(port_data_cfg(root, **over))))


def test_get_infos_equal_jax(mini_tree):
    from virconv_tpu_torch.datasets.kitti.kitti_dataset_mm import \
        KittiDatasetMM
    ds = KittiDatasetMM(port_data_cfg(mini_tree), ['Car'],
                        root_path=mini_tree)
    for split in ('train', 'val'):
        ds.set_split(split)
        got = ds.get_infos(num_workers=2)
        with open(mini_tree / f'kitti_infos_{split}.pkl', 'rb') as f:
            want = pickle.load(f)
        assert len(got) == len(want) == {'train': 3, 'val': 2}[split]
        for g, w in zip(got, want):
            assert_tree_equal(g, w)


def test_mini_writer_equals_build_mini_kitti(mini_tree, tmp_path):
    """``utils/mini_kitti`` in ``mini`` mode writes build_mini_kitti's
    frames (every file but the PNG byte for byte; the PNG a valid image of
    the same size) and the same infos."""
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    root = write_tree(tmp_path / 'mini', 'mini', frames=5, seed=0,
                      n_train=3)
    for sub in ('velodyne', 'velodyne_depth', 'calib', 'label_2', 'planes'):
        for f in sorted((mini_tree / 'training' / sub).iterdir()):
            assert (root / 'training' / sub / f.name).read_bytes() == \
                f.read_bytes(), (sub, f.name)
    for f in ('train.txt', 'val.txt'):
        assert (root / 'ImageSets' / f).read_text() == \
            (mini_tree / 'ImageSets' / f).read_text()
    img = cv2.imread(str(root / 'training' / 'image_2' / '000000.png'))
    assert img.shape == (375, 1242, 3) and not img.any()
    for split in ('train', 'val'):
        with open(root / f'kitti_infos_{split}.pkl', 'rb') as f:
            got = pickle.load(f)
        with open(mini_tree / f'kitti_infos_{split}.pkl', 'rb') as f:
            want = pickle.load(f)
        for g, w in zip(got, want):
            assert_tree_equal(g, w)


def test_scene_writer_streams_and_labels(tmp_path):
    """``scene`` mode: KITTI-scale frames whose fused cloud marks virtual
    points 1 and LiDAR points 2 (intensity x 10), stored as float16, and
    labels that load back to the scene's cars."""
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    from virconv_tpu_torch.utils.synth_scene import make_scene
    root = write_tree(tmp_path / 'scene', 'scene', frames=1, seed=5)
    cloud = np.load(root / 'training' / 'velodyne_depth' / '000000.npy')
    scene = make_scene(seed=5)
    assert cloud.dtype == np.float16
    assert set(np.unique(cloud[:, 7])) == {1.0, 2.0}
    assert (cloud[:, 7] == 2).sum() == len(scene['lidar']) > 15000
    assert (cloud[:, 7] == 1).sum() == len(scene['virtual']) > 30000
    lidar = cloud[cloud[:, 7] == 2].astype(np.float32)
    np.testing.assert_allclose(lidar[:, 3], scene['lidar'][:, 3] * 10,
                               rtol=1e-3)
    with open(root / 'kitti_infos_val.pkl', 'rb') as f:
        infos = pickle.load(f)
    boxes = infos[0]['annos']['gt_boxes_lidar']
    assert 5 <= len(boxes) <= len(scene['boxes'])
    d = np.abs(boxes[:, None, :2] - scene['boxes'][None, :, :2]).sum(-1)
    assert (d.min(1) < 0.05).all()          # each label is a scene car
    assert (infos[0]['annos']['num_points_in_gt'] > 0).any()


@pytest.mark.parametrize('max_points,shuffle', [
    ({'lidar': 65536, 'mm': 65536}, False),
    ({'lidar': 384, 'mm': 96}, False),
    ({'lidar': 384, 'mm': 96}, True)])
def test_samples_and_batches_equal_jax(mini_tree, max_points, shuffle):
    """Samples of the val split, then collated batches of the loader, equal
    (StVD, the optional shuffle and the over-capacity choice draw the same
    numbers in the same order)."""
    from virconv_tpu.datasets import build_dataloader as jbuild
    from virconv_tpu.datasets.kitti.kitti_dataset_mm import \
        KittiDatasetMM as JKitti
    from virconv_tpu_torch.datasets import build_dataloader
    from virconv_tpu_torch.datasets.kitti.kitti_dataset_mm import \
        KittiDatasetMM
    over = dict(MAX_POINTS=max_points)
    tcfg, jcfg = port_data_cfg(mini_tree, **over), jax_data_cfg(mini_tree,
                                                               **over)
    for c in (tcfg, jcfg):
        c.DATA_PROCESSOR[1].SHUFFLE_ENABLED.test = shuffle
    port = KittiDatasetMM(tcfg, ['Car'], seed=7)
    jds = JKitti(jcfg, ['Car'], training=False)
    np.random.seed(7)
    want = [jds[i] for i in range(len(jds))]
    got = [port[i] for i in range(len(port))]
    assert len(got) == 2
    for g, w in zip(got, want):
        assert_tree_equal(g, w)
    if max_points['mm'] < 1000:
        assert got[0]['points_valid'].all()       # the cap was hit
        assert got[0]['points_mm_valid'].all()

    _, loader = build_dataloader(tcfg, ['Car'], 2, seed=11)
    np.random.seed(11)
    _, jloader, _ = jbuild(jcfg, ['Car'], 2, training=False)
    got_b, want_b = list(loader), list(jloader)
    assert len(got_b) == len(want_b) == 1
    (gb, gm), (wb, wm) = got_b[0], want_b[0]
    assert_tree_equal(gb, {k: v for k, v in wb.items()})
    assert_tree_equal(gm, wm)
    assert loader.frames == 2 and loader.host_seconds > 0


class _Frames:
    """A stand-in dataset: frame i is i; ``bad`` raises on loading."""

    def __init__(self, n, bad=None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError(f'frame {i} is unreadable')
        return i

    @staticmethod
    def collate_batch(samples):
        return samples


def test_loader_stops_its_producer_and_hands_on_errors():
    import threading
    from virconv_tpu_torch.datasets import PRODUCER, DataLoader

    def producers():
        return [t for t in threading.enumerate() if t.name == PRODUCER]
    loader = DataLoader(_Frames(9), 2)
    assert list(loader) == [[0, 1], [2, 3], [4, 5], [6, 7], [8]]
    it = iter(DataLoader(_Frames(50), 1))
    assert next(it) == [0]
    it.close()                     # the consumer stops early
    assert not producers()
    with pytest.raises(ValueError, match='frame 3'):
        list(DataLoader(_Frames(6, bad=3), 2))
    assert not producers()


def test_loader_shards_pad_and_stride(mini_tree):
    from virconv_tpu_torch.datasets import DataLoader
    ds = list(range(5))
    shards = [DataLoader(ds, 2, num_shards=2, shard_id=i)._indices()
              for i in range(2)]
    np.testing.assert_array_equal(shards[0], [0, 2, 4])
    np.testing.assert_array_equal(shards[1], [1, 3, 0])


# ----------------------------------------------------- prediction dicts -----
def fixed_pred_dicts(rng, n_frames):
    preds = []
    for k in range(n_frames):
        n = 6 + 2 * k
        boxes = np.zeros((n, 7), np.float32)
        boxes[:, 0] = rng.uniform(5, 40, n)
        boxes[:, 1] = rng.uniform(-8, 8, n)
        boxes[:, 2] = rng.uniform(-1.5, -0.5, n)
        boxes[:, 3:6] = [3.9, 1.6, 1.56]
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
        boxes[1] = boxes[0] + [0.05, 0.02, 0, 0, 0, 0, 0.02]   # one cluster
        preds.append({'pred_boxes': boxes,
                      'pred_scores': rng.uniform(0.3, 1, n).astype(
                          np.float32),
                      'pred_labels': np.ones(n, np.int64), 'WBF': True,
                      'IoU': 0.85, 'RL': k % 2 == 1, 'SCORE_THRESH': 0.4})
    preds.append({'pred_boxes': np.zeros((0, 7), np.float32),
                  'pred_scores': np.zeros(0, np.float32),
                  'pred_labels': np.zeros(0, np.int64), 'WBF': True,
                  'IoU': 0.85, 'RL': False, 'SCORE_THRESH': 0.4})
    return preds


def test_prediction_dicts_and_txt_equal_jax(mini_tree, tmp_path):
    """Fields within 1e-6 and the KITTI .txt files byte for byte."""
    from virconv_tpu.datasets.kitti.kitti_dataset_mm import \
        KittiDatasetMM as JKitti
    from virconv_tpu.utils.calibration import Calibration as JCalib
    from virconv_tpu_torch.datasets.kitti.kitti_dataset_mm import \
        KittiDatasetMM
    from virconv_tpu_torch.utils.calibration import Calibration
    calib_file = mini_tree / 'training' / 'calib' / '000000.txt'
    preds = fixed_pred_dicts(np.random.default_rng(5), 3)
    ids = ['000000', '000001', '000002', '000003']

    def meta(calib_cls):
        return {'calib': [calib_cls(calib_file)] * 4, 'frame_id': ids,
                'image_shape': [np.array([375, 1242], np.int32)] * 4}
    outs = {'port': tmp_path / 'port', 'jax': tmp_path / 'jax'}
    for d in outs.values():
        d.mkdir()
    got = KittiDatasetMM(port_data_cfg(mini_tree), ['Car'])\
        .generate_prediction_dicts(meta(Calibration), copy.deepcopy(preds),
                                   ['Car'], output_path=outs['port'])
    want = JKitti(jax_data_cfg(mini_tree), ['Car'], training=False)\
        .generate_prediction_dicts(meta(JCalib), copy.deepcopy(preds),
                                   ['Car'], output_path=outs['jax'])
    assert len(got) == len(want) == 4
    assert sum(len(a['score']) for a in got) > 10
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g['frame_id'] == w['frame_id']
        assert list(g['name']) == list(w['name'])
        for k in set(w) - {'name', 'frame_id'}:
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=0,
                                       err_msg=k)
    for fid in ids:
        assert (outs['port'] / f'{fid}.txt').read_bytes() == \
            (outs['jax'] / f'{fid}.txt').read_bytes(), fid


# ----------------------------------------------------------- AP (R40) -------
def jittered_annos(mini_tree, rng):
    """gt annos of every frame (with a DontCare region and a Van added)
    and detections: gt jittered, one dropped per frame, one false
    positive per frame."""
    infos = []
    for split in ('train', 'val'):
        with open(mini_tree / f'kitti_infos_{split}.pkl', 'rb') as f:
            infos += pickle.load(f)
    gts, dts = [], []
    for info in infos:
        gt = copy.deepcopy(info['annos'])
        n = len(gt['name'])
        gt['bbox'] = gt['bbox'] + rng.uniform(-30, 30, (n, 4)).astype(
            np.float32)
        gt['occluded'] = rng.integers(0, 3, n).astype(np.float64)
        extra = {'name': ['DontCare', 'Van'],
                 'truncated': [0.0, 0.0], 'occluded': [0.0, 0.0],
                 'alpha': [0.0, 0.3], 'bbox': [[10, 10, 90, 80],
                                               [500, 150, 560, 210]],
                 'dimensions': [[1, 1, 1], [4.5, 1.8, 1.9]],
                 'location': [[0, 0, 5], [-4, 1.6, 25]],
                 'rotation_y': [0.0, 0.2], 'score': [-1.0, -1.0]}
        for k, v in extra.items():
            gt[k] = np.concatenate([gt[k], np.asarray(v, gt[k].dtype)])
        gts.append(gt)
        keep = np.arange(1, n)
        dt = {'name': np.array(['Car'] * (len(keep) + 1))}
        loc = gt['location'][keep] + rng.normal(0, 0.15, (len(keep), 3))
        dt['location'] = np.concatenate([loc, [[3.0, 1.6, 40.0]]])
        dt['dimensions'] = np.concatenate(
            [gt['dimensions'][keep] * rng.uniform(0.9, 1.1,
                                                  (len(keep), 3)),
             [[3.9, 1.56, 1.6]]])
        dt['rotation_y'] = np.concatenate(
            [gt['rotation_y'][keep] + rng.normal(0, 0.1, len(keep)), [0.]])
        dt['bbox'] = np.concatenate(
            [gt['bbox'][keep] + rng.normal(0, 4, (len(keep), 4)),
             [[600, 160, 680, 220]]])
        dt['alpha'] = np.concatenate(
            [gt['alpha'][keep] + rng.normal(0, 0.1, len(keep)), [0.5]])
        dt['score'] = rng.uniform(0.2, 1, len(keep) + 1)
        dts.append(dt)
    return gts, dts


@pytest.mark.parametrize('branch', ['native', 'numpy'])
def test_official_eval_equals_jax(mini_tree, monkeypatch, branch):
    from virconv_tpu.datasets.kitti.eval import \
        get_official_eval_result as jeval
    from virconv_tpu_torch.datasets.kitti.eval import \
        get_official_eval_result as teval
    if branch == 'numpy':
        for mod in (tnative, jnative):
            monkeypatch.setattr(mod, '_LIB', None)
            monkeypatch.setattr(mod, '_TRIED', True)
    gts, dts = jittered_annos(mini_tree, np.random.default_rng(9))
    got_str, got = teval(copy.deepcopy(gts), copy.deepcopy(dts), ['Car'])
    want_str, want = jeval(copy.deepcopy(gts), copy.deepcopy(dts), ['Car'])
    assert got_str == want_str
    assert got.keys() == want.keys()
    assert len(got) == 9
    for k in want:
        assert got[k] == want[k], k
    assert 0 < got['Car_3d/moderate_R40'] < 100


def test_official_eval_branches_agree(mini_tree, monkeypatch):
    """The port's native and numpy branches give the same metric."""
    from virconv_tpu_torch.datasets.kitti.eval import \
        get_official_eval_result as teval
    gts, dts = jittered_annos(mini_tree, np.random.default_rng(10))
    native_str, native = teval(copy.deepcopy(gts), copy.deepcopy(dts),
                               ['Car'])
    monkeypatch.setattr(tnative, '_LIB', None)
    monkeypatch.setattr(tnative, '_TRIED', True)
    numpy_str, numpy_res = teval(copy.deepcopy(gts), copy.deepcopy(dts),
                                 ['Car'])
    for k in native:
        np.testing.assert_allclose(numpy_res[k], native[k], atol=1e-6)


# --------------------------------------------------------- config, ckpt ----
def test_cfg_from_list_equals_jax():
    from virconv_tpu.config import cfg_from_list as jset
    from virconv_tpu_torch.config import cfg_from_list
    overrides = ['DATA_CONFIG.DATA_PATH', '/data/kitti',
                 'MODEL.POST_PROCESSING.SCORE_THRESH', '0.3',
                 'DATA_CONFIG.ROT_NUM', '2',
                 'DATA_CONFIG.FOV_POINTS_ONLY', 'false',
                 'DATA_CONFIG.POINT_CLOUD_RANGE', '[0, -8, -3, 16, 8, 1]',
                 'MODEL.POST_PROCESSING.RL', 'True']
    got = cfg_from_list(overrides, virconv_t_config())
    want = jset(overrides, JCfg(copy.deepcopy(dict(virconv_t_config()))))
    assert got == want
    assert got.DATA_CONFIG.FOV_POINTS_ONLY is False
    with pytest.raises(TypeError):
        cfg_from_list(['DATA_CONFIG.ROT_NUM', 'three'], virconv_t_config())
    with pytest.raises(KeyError):
        cfg_from_list(['DATA_CONFIG.NOPE.X', '1'], virconv_t_config())


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    from virconv_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                    load_checkpoint,
                                                    save_checkpoint)
    gen = torch.Generator().manual_seed(0)
    sd = {'a.weight': torch.randn(5, 3, generator=gen),
          'b.running_var': torch.rand(7, generator=gen).double(),
          'c.num_batches_tracked': torch.tensor(3)}
    opt = {'state': {0: {'m': torch.randn(4, generator=gen)}},
           'lr': 1e-3}
    path = save_checkpoint(tmp_path, sd, 4, optimizer_state=opt, step=17)
    assert path.name == 'checkpoint_epoch_4.pth'
    got = load_checkpoint(path)
    assert got['epoch'] == 4 and got['step'] == 17
    for k, v in sd.items():
        assert got['model_state'][k].dtype == v.dtype
        assert torch.equal(got['model_state'][k], v), k
    assert torch.equal(got['optimizer_state']['state'][0]['m'],
                       opt['state'][0]['m'])
    assert latest_checkpoint(tmp_path) == path
    assert 'step' not in load_checkpoint(save_checkpoint(tmp_path, sd, 5))


def test_checkpoint_rotation_keeps_30(tmp_path):
    from virconv_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                    save_checkpoint)
    sd = {'w': torch.zeros(2)}
    for epoch in range(1, 34):
        save_checkpoint(tmp_path, sd, epoch)
    left = sorted(int(p.stem.rsplit('_', 1)[1])
                  for p in tmp_path.glob('checkpoint_epoch_*.pth'))
    assert left == list(range(4, 34))
    assert latest_checkpoint(tmp_path).name == 'checkpoint_epoch_33.pth'


def test_common_helpers_equal_jax():
    from virconv_tpu.utils import common as jcommon
    from virconv_tpu_torch.utils import common as tcommon
    rng = np.random.default_rng(12)
    val = rng.uniform(-10, 10, 50)
    for offset, period in ((0.5, np.pi), (0, 2 * np.pi)):
        np.testing.assert_array_equal(
            tcommon.limit_period(val, offset, period),
            jcommon.limit_period(val, offset, period))
    pts = rng.uniform(-50, 80, (300, 4))
    pcr = [0, -40, -3, 70.4, 40, 1]
    np.testing.assert_array_equal(tcommon.mask_points_by_range(pts, pcr),
                                  jcommon.mask_points_by_range(pts, pcr))
    names = np.array(['Car', 'Van', 'DontCare', 'Car', 'Pedestrian'])
    np.testing.assert_array_equal(
        tcommon.keep_arrays_by_name(names, ['Car', 'Pedestrian']),
        jcommon.keep_arrays_by_name(names, ['Car', 'Pedestrian']))
    info = {'name': names, 'score': np.arange(5.0)}
    assert_tree_equal(tcommon.drop_info_with_name(info, 'DontCare'),
                      jcommon.drop_info_with_name(info, 'DontCare'))
