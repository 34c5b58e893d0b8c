"""Host-side data processing: range mask, shuffle, pad to capacity.

The port's copy of ``virconv_tpu/datasets/processor/data_processor.py``.
As there, ``transform_points_to_voxels`` does not voxelize on the host:
voxelization runs on the device inside the model
(``ops/sparse.voxelize``). The host step pads each point stream to its
static capacity (``MAX_POINTS``), drawing ``capacity`` points without
replacement from a stream that holds more. In training
(``training=True``) the range mask also drops the gt boxes that have no
corner inside the range (``REMOVE_OUTSIDE_BOXES``), and the shuffle
follows ``SHUFFLE_ENABLED['train']``.

Random draws (``shuffle_points``, the over-capacity ``choice``) come from
the ``np.random.RandomState`` passed in as ``rng``, in the order the JAX
loader draws them from numpy's global state.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from ...ops import boxes_np
from ...utils import common as common_utils


class DataProcessor:
    def __init__(self, processor_configs, point_cloud_range, rng, rot_num,
                 max_points, training=False):
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.rng = rng
        self.training = training
        self.mode = 'train' if training else 'test'
        self.rot_num = rot_num
        self.max_points = max_points
        self.data_processor_queue = [
            getattr(self, c.NAME)(config=c) for c in processor_configs]

    def _streams(self, data_dict):
        """(key, capacity key) of every point stream of every replica."""
        for i in range(self.rot_num):
            sid = '' if i == 0 else str(i)
            for key, cap_key in ((f'points{sid}', 'lidar'),
                                 (f'points_mm{sid}', 'mm')):
                if key in data_dict:
                    yield key, cap_key

    # each processor, called with a config only, returns its closure
    def mask_points_and_boxes_outside_range(self, data_dict=None,
                                            config=None):
        """Drop points outside the range, and in training the gt boxes with
        no corner inside it (gt boxes stay at test time)."""
        if data_dict is None:
            return partial(self.mask_points_and_boxes_outside_range,
                           config=config)
        for key, _ in self._streams(data_dict):
            pts = data_dict[key]
            data_dict[key] = pts[common_utils.mask_points_by_range(
                pts, self.point_cloud_range)]
        if data_dict.get('gt_boxes', None) is not None and self.training \
                and config.get('REMOVE_OUTSIDE_BOXES', True):
            keep = boxes_np.mask_boxes_outside_range(
                data_dict['gt_boxes'], self.point_cloud_range,
                min_num_corners=1)
            data_dict['gt_boxes'] = data_dict['gt_boxes'][keep]
            if 'gt_names' in data_dict and \
                    len(data_dict['gt_names']) == len(keep):
                data_dict['gt_names'] = data_dict['gt_names'][keep]
        return data_dict

    def shuffle_points(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.shuffle_points, config=config)
        if config.SHUFFLE_ENABLED[self.mode]:
            for key, _ in self._streams(data_dict):
                pts = data_dict[key]
                data_dict[key] = pts[self.rng.permutation(len(pts))]
        return data_dict

    def transform_points_to_voxels(self, data_dict=None, config=None):
        """Pad every point stream to its capacity, with a ``<key>_valid``
        mask (voxelization runs on the device, in the model)."""
        if data_dict is None:
            return partial(self.transform_points_to_voxels, config=config)
        for key, cap_key in self._streams(data_dict):
            cap = self.max_points[cap_key]
            pts = data_dict[key]
            if len(pts) > cap:
                pts = pts[self.rng.choice(len(pts), cap, replace=False)]
            padded = np.zeros((cap, pts.shape[1]), np.float32)
            padded[:len(pts)] = pts
            data_dict[key] = padded
            data_dict[key + '_valid'] = np.arange(cap) < len(pts)
        return data_dict

    def forward(self, data_dict):
        for processor in self.data_processor_queue:
            data_dict = processor(data_dict=data_dict)
        return data_dict
