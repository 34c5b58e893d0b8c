"""Dataset template: the training augmentations, StVD input discard of
virtual points, test-time replicas, batching.

The port's copy of ``virconv_tpu/datasets/dataset.py``: distance-bin
partition and stochastic discard of virtual points (StVD,
``input_point_discard``; 2 bins in training, 10 at evaluation), the split
of the fused cloud by its indicator column (virtual = 1, real LiDAR = 2),
and a collation into fixed-shape padded arrays (per (sample, replica)
point streams, per-entry calibration matrices and transform params,
padded gt boxes with validity masks). In training a sample has one entry
(``rot_num`` 1): the augmentation queue (``augmentor/data_augmentor.py``),
then with probability 1/2 a scene swap along x, then the training StVD
rate; a sample left without a gt box is ``None`` (the caller draws
another), and the collation carries ``aug_param`` as ``trans_params``. At
evaluation the X_TRANS replicas make ``ROT_NUM`` entries per sample.

Random draws: every draw (the augmentors, the scene swap, the StVD
permutations, and in the data processor the shuffle and the
over-capacity ``choice``) comes from one ``np.random.RandomState(seed)``
that the dataset holds, in the order the JAX loader draws them from
numpy's global state in its one producer thread. ``RandomState`` gives
the numbers that the ``np.random`` functions give after
``np.random.seed(seed)``, so the two loaders make the same samples;
``np.random.default_rng`` draws another stream and would not.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils import common as common_utils
from .augmentor.data_augmentor import DataAugmentor
from .augmentor.x_transform import X_TRANS
from .processor.data_processor import DataProcessor
from .processor.point_feature_encoder import PointFeatureEncoder

MAX_GT_BOXES = 64
VIRTUAL, LIDAR = 1, 2        # indicator column of the fused cloud
SCENE_X = 70.4               # the scene swap's x extent (m)


def partition(points, num=10, max_dis=60, rate=0.2):
    """Split points into ``num`` distance bins along x, farthest first;
    find the bin below which subsampling is needed to keep ``rate`` of the
    points. Returns (bins, position, points in the far bins)."""
    inter = max_dis / num
    all_num = max(points.shape[0], 1)
    points_list = []
    acc = 0
    position = num - 1
    distant_acc = 0
    for j in range(num):
        i = num - j - 1
        if i == num - 1:
            mask = points[:, 0] >= inter * i
        else:
            mask = (points[:, 0] >= inter * i) & \
                   (points[:, 0] < inter * (i + 1))
        this = points[mask]
        acc += this.shape[0]
        if (acc + i * this.shape[0]) / all_num < rate:
            position = i
            distant_acc = acc
        points_list.append(this)
    return points_list, max(position, 0), distant_acc


def input_point_discard(points, rng, bin_num=2, rate=0.8):
    """Bin-wise stochastic discard of ``rate`` of the points that keeps the
    distant bins whole (StVD); the permutations come from the
    ``RandomState`` ``rng``."""
    retain = 1 - rate
    parts, pos, distant_acc = partition(points, num=bin_num, rate=retain)
    out_num = int(points.shape[0] * retain)
    per_bin = int((out_num - distant_acc) / (pos + 1e-4))
    for i in range(len(parts) - pos, len(parts)):
        if parts[i].shape[0] > per_bin and per_bin >= 0:
            sel = rng.permutation(parts[i].shape[0])[:per_bin]
            parts[i] = parts[i][sel]
    return np.concatenate(parts) if parts else points


def fuse_streams(points, points_mm):
    """The one stream of ``LATER_FUSION`` False: the LiDAR points first,
    then the kept virtual points, with the intensity column divided by
    10."""
    final = np.concatenate([points, points_mm])
    final[:, 3] /= 10
    return final


class DatasetTemplate:
    def __init__(self, dataset_cfg=None, class_names=None, training=False,
                 root_path=None, logger=None, seed=0):
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = class_names
        self.logger = logger
        self.rng = np.random.RandomState(seed)
        self.root_path = Path(root_path) if root_path is not None \
            else Path(dataset_cfg.DATA_PATH)
        self.rot_num = 1 if training else dataset_cfg.get('ROT_NUM', 1)
        self.point_cloud_range = np.array(dataset_cfg.POINT_CLOUD_RANGE,
                                          dtype=np.float32)
        self.point_feature_encoder = PointFeatureEncoder(
            dataset_cfg.POINT_FEATURE_ENCODING, rot_num=self.rot_num)
        self.data_augmentor = DataAugmentor(
            self.root_path, dataset_cfg.DATA_AUGMENTOR, class_names,
            self.rng, logger=logger) if training else None
        self.data_processor = DataProcessor(
            dataset_cfg.DATA_PROCESSOR,
            point_cloud_range=self.point_cloud_range, rng=self.rng,
            rot_num=self.rot_num,
            max_points=dict(dataset_cfg.get(
                'MAX_POINTS', {'lidar': 65536, 'mm': 65536})),
            training=training)
        x_trans_cfg = dataset_cfg.get('X_TRANS', None)
        self.x_trans = X_TRANS(x_trans_cfg, rot_num=self.rot_num) \
            if x_trans_cfg is not None else None
        self.input_discard_rate = dataset_cfg.get('INPUT_DISCARD_RATE', 0.8)

    @property
    def mode(self):
        return 'train' if self.training else 'test'

    # --------------------------------------------------------- StVD ---------
    def input_point_discard(self, points, bin_num=2, rate=0.8):
        """Bin-wise stochastic discard of ``rate`` of the points that keeps
        the distant bins whole (StVD), drawing from the dataset's
        ``RandomState``."""
        return input_point_discard(points, self.rng, bin_num, rate)

    # ------------------------------------------------------ pipeline --------
    def scene_swap(self, data_dict, sid=''):
        """Cut the scene at a random x and swap the two parts along x
        (points beyond ``SCENE_X`` are zeroed first, in place)."""
        randx = self.rng.random_sample() * SCENE_X
        randx_1 = SCENE_X - randx
        for key in ('points' + sid, 'gt_boxes' + sid):
            arr = data_dict[key]
            if key.startswith('points'):
                arr[arr[:, 0] > SCENE_X] = 0
            near = arr[arr[:, 0] <= randx].copy()
            near[:, 0] += randx_1
            far = arr[arr[:, 0] > randx].copy()
            far[:, 0] -= randx
            data_dict[key] = np.concatenate([near, far])
        return data_dict

    def prepare_data(self, data_dict):
        """One sample: augmentations (training) or replicas (evaluation),
        the class column on the gt boxes, the scene swap (training), the
        stream split with StVD, the feature encoder and the processors.
        ``None`` when training leaves no gt box."""
        if self.training:
            data_dict = self.data_augmentor.forward(data_dict)
        elif self.x_trans is not None:
            data_dict = self.x_trans.input_transform(data_dict)

        if data_dict.get('gt_boxes', None) is not None:
            selected = common_utils.keep_arrays_by_name(
                data_dict['gt_names'], self.class_names)
            data_dict['gt_names'] = data_dict['gt_names'][selected]
            classes = np.array([self.class_names.index(n) + 1
                                for n in data_dict['gt_names']], np.float32)
            data_dict['gt_boxes'] = np.concatenate(
                [data_dict['gt_boxes'][selected], classes.reshape(-1, 1)],
                axis=1)

        later_fusion = self.dataset_cfg.get('LATER_FUSION', True)
        for i in range(self.rot_num):
            sid = '' if i == 0 else str(i)
            if self.training and self.rng.choice([0, 1]):
                data_dict = self.scene_swap(data_dict, sid)
            if 'mm' not in data_dict:
                continue
            pts = data_dict['points' + sid]
            virtual = pts[pts[:, -1] == VIRTUAL]
            points = pts[pts[:, -1] == LIDAR]
            points_mm = self.input_point_discard(
                virtual, rate=self.input_discard_rate) if self.training \
                else self.input_point_discard(
                    virtual, bin_num=10, rate=self.input_discard_rate)
            if later_fusion:
                data_dict['points_mm' + sid] = points_mm
                data_dict['points' + sid] = points
            else:
                data_dict['points' + sid] = fuse_streams(points, points_mm)
        if not later_fusion:
            data_dict.pop('mm', None)

        data_dict = self.point_feature_encoder.forward(data_dict)
        data_dict = self.data_processor.forward(data_dict)
        if self.training and len(data_dict.get('gt_boxes', [])) == 0:
            return None
        data_dict.pop('gt_names', None)
        data_dict.pop('valid_noise', None)
        return data_dict

    # ------------------------------------------------------ collation -------
    def collate_batch(self, batch_list):
        """(batch, meta): the model's fixed-shape arrays (entry = sample *
        ROT_NUM + replica) and the host records of the samples."""
        b = len(batch_list)
        sids = ['' if i == 0 else str(i) for i in range(self.rot_num)]

        def stack_entries(key):
            return np.stack([s[key.format(sid)] for s in batch_list
                             for sid in sids])

        ret = {'points': stack_entries('points{}').astype(np.float32),
               'points_valid': stack_entries('points{}_valid')}
        if any('points_mm' in s for s in batch_list):
            ret['points_mm'] = stack_entries('points_mm{}').astype(
                np.float32)
            ret['points_mm_valid'] = stack_entries('points_mm{}_valid')
        mats = [s['calib'].device_matrices() for s in batch_list]
        ret['v2r'] = np.stack([m[0] for m in mats for _ in sids])
        ret['p2t'] = np.stack([m[1] for m in mats for _ in sids])
        # gt boxes: the training targets, and in the meta the recall
        # records (replica 0)
        if all('gt_boxes' in s for s in batch_list):
            gt = np.zeros((b, MAX_GT_BOXES, 8), np.float32)
            gt_valid = np.zeros((b, MAX_GT_BOXES), bool)
            for k, s in enumerate(batch_list):
                n = min(len(s['gt_boxes']), MAX_GT_BOXES)
                gt[k, :n] = s['gt_boxes'][:n]
                gt_valid[k, :n] = True
        else:
            gt, gt_valid = None, None
        ret['transform_param'] = ret['trans_params'] = None
        ret['gt_boxes'] = ret['gt_valid'] = None
        if self.training:
            ret['gt_boxes'], ret['gt_valid'] = gt, gt_valid
            if 'aug_param' in batch_list[0]:
                ret['trans_params'] = np.stack(
                    [s['aug_param'][:3].astype(np.float32)
                     for s in batch_list])
        elif 'transform_param' in batch_list[0]:
            tp = np.stack([s['transform_param'].astype(np.float32)
                           for s in batch_list])          # (B, R, 3)
            ret['transform_param'] = tp
            ret['trans_params'] = tp.reshape(-1, 3)
        meta = {'gt_boxes': gt, 'gt_valid': gt_valid,
                'frame_id': [s.get('frame_id') for s in batch_list],
                'calib': [s['calib'] for s in batch_list],
                'image_shape': [s.get('image_shape') for s in batch_list],
                'batch_size': b}
        return ret, meta
