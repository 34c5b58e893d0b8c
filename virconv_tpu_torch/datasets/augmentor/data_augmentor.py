"""The training augmentation queue.

The port's copy of ``virconv_tpu/datasets/augmentor/data_augmentor.py``:
the entries of ``DATA_AUGMENTOR.AUG_CONFIG_LIST`` in order (gt sampling,
DA sampling, per-object local noise, world rotation, flip and scaling with
their recorded parameters, local translation, pyramid augmentations),
then the yaw wrapped to [-pi, pi). ``aug_param`` = [rot, flip, scale] is
what the model's NRConv back-projection reads as ``trans_params``, so the
rotation must come first in the queue (asserted).

Every random number comes from the dataset's ``np.random.RandomState``
(``rng``), in the JAX queue's order.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from ...utils import common as common_utils
from . import augmentor_utils, database_sampler


class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, rng,
                 logger=None):
        self.root_path = root_path
        self.class_names = class_names
        self.rng = rng
        self.logger = logger
        self.data_augmentor_queue = []
        cfg_list = augmentor_configs if isinstance(augmentor_configs, list) \
            else augmentor_configs.AUG_CONFIG_LIST
        for cur_cfg in cfg_list:
            if not isinstance(augmentor_configs, list) and \
                    cur_cfg.NAME in augmentor_configs.DISABLE_AUG_LIST:
                continue
            self.data_augmentor_queue.append(
                getattr(self, cur_cfg.NAME)(config=cur_cfg))

    # each entry, called with a config only, returns its callable
    def gt_sampling(self, config=None):
        return database_sampler.DataBaseSampler(
            self.root_path, config, self.class_names, self.rng, self.logger)

    def da_sampling(self, config=None):
        return database_sampler.DADataBaseSampler(
            self.root_path, config, self.class_names, self.rng, self.logger)

    def random_world_rotation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_rotation, config=config)
        rot_range = config['WORLD_ROT_ANGLE']
        if not isinstance(rot_range, list):
            rot_range = [-rot_range, rot_range]
        gt_boxes, points, param = augmentor_utils.global_rotation(
            data_dict['gt_boxes'], data_dict['points'], rot_range, self.rng)
        data_dict['gt_boxes'] = gt_boxes
        data_dict['points'] = points
        assert 'aug_param' not in data_dict, (
            'random_world_rotation must precede random_world_flip/'
            'random_world_scaling in DATA_AUGMENTOR.AUG_CONFIG_LIST '
            '(aug_param convention is [rot, flip, scale])')
        data_dict['aug_param'] = [param]
        return data_dict

    def random_world_flip(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_flip, config=config)
        gt_boxes, points = data_dict['gt_boxes'], data_dict['points']
        param = 0
        for axis in config['ALONG_AXIS_LIST']:
            assert axis == 'x'
            gt_boxes, points, param = augmentor_utils.random_flip_along_x(
                gt_boxes, points, self.rng)
        data_dict['gt_boxes'] = gt_boxes
        data_dict['points'] = points
        data_dict.setdefault('aug_param', []).append(int(param))
        return data_dict

    def random_world_scaling(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_scaling, config=config)
        gt_boxes, points, param = augmentor_utils.global_scaling(
            data_dict['gt_boxes'], data_dict['points'],
            config['WORLD_SCALE_RANGE'], self.rng)
        data_dict['gt_boxes'] = gt_boxes
        data_dict['points'] = points
        data_dict.setdefault('aug_param', []).append(param)
        return data_dict

    def random_local_noise(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_noise, config=config)
        # the noise works on the negated yaw, as the JAX queue does
        data_dict['gt_boxes'][:, 6] = -data_dict['gt_boxes'][:, 6]
        augmentor_utils.noise_per_object(
            data_dict['gt_boxes'], data_dict['points'], self.rng,
            valid_mask=data_dict.get('valid_noise', None),
            rotation_perturb=config['LOCAL_ROT_RANGE'],
            center_noise_std=config['TRANSLATION_STD'],
            global_rot_range=config['GLOBAL_ROT_RANGE'],
            extra_width=config['EXTRA_WIDTH'])
        data_dict['gt_boxes'][:, 6] = -data_dict['gt_boxes'][:, 6]
        data_dict.pop('valid_noise', None)
        return data_dict

    def random_local_trans(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_trans, config=config)
        shift = (self.rng.random_sample(3) - 0.5) \
            * np.asarray(config.TRANSLATION_STD)
        data_dict['gt_boxes'][:, 0:3] += shift
        data_dict['points'][:, 0:3] += shift
        return data_dict

    def random_local_pyramid_aug(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_pyramid_aug, config=config)
        gt_boxes, points = data_dict['gt_boxes'], data_dict['points']
        gt_boxes, points, pyramids = augmentor_utils.local_pyramid_dropout(
            gt_boxes, points, config['DROP_PROB'], self.rng)
        gt_boxes, points, pyramids = augmentor_utils.local_pyramid_sparsify(
            gt_boxes, points, config['SPARSIFY_PROB'],
            config['SPARSIFY_MAX_NUM'], self.rng, pyramids)
        gt_boxes, points = augmentor_utils.local_pyramid_swap(
            gt_boxes, points, config['SWAP_PROB'], config['SWAP_MAX_NUM'],
            self.rng, pyramids)
        data_dict['gt_boxes'] = gt_boxes
        data_dict['points'] = points
        return data_dict

    def forward(self, data_dict):
        for aug in self.data_augmentor_queue:
            data_dict = aug(data_dict=data_dict)
        data_dict['gt_boxes'][:, 6] = common_utils.limit_period(
            data_dict['gt_boxes'][:, 6], offset=0.5, period=2 * np.pi)
        if 'aug_param' in data_dict:
            data_dict['aug_param'] = np.array(data_dict['aug_param'],
                                              dtype=np.float32)
        data_dict.pop('calib_obj', None)
        data_dict.pop('road_plane', None)
        return data_dict
