"""GT-database paste-in samplers of the training loader.

The port's copy of ``virconv_tpu/datasets/augmentor/database_sampler.py``.
``DataBaseSampler`` pastes object point crops from the gt database
(``kitti_dbinfos_train_mm.pkl``, ``gt_database_mm/*.bin``) at their
recorded pose: the ``PREPARE`` filters, a fixed number per class that
walks a permutation of the database, BEV-IoU collision rejection, road-plane
snapping, and removal of the scene's points inside the enlarged pasted
boxes. ``DADataBaseSampler`` also shifts each class's samples towards the
ego car, resamples every crop on a LiDAR-like spherical grid and drops a
jittered half-space of it (occlusion).

Every random number comes from the ``rng`` the sampler is given (the
dataset's ``np.random.RandomState``), in the JAX sampler's order.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ...ops import native as native_ops
from . import augmentor_utils


class DataBaseSampler:
    def __init__(self, root_path, sampler_cfg, class_names, rng,
                 logger=None):
        self.root_path = Path(root_path)
        self.class_names = class_names
        self.sampler_cfg = sampler_cfg
        self.rng = rng
        self.use_van = sampler_cfg.get('USE_VAN', None)
        self.db_infos = {c: [] for c in class_names}
        if self.use_van:
            self.db_infos['Van'] = []

        for db_info_path in sampler_cfg.DB_INFO_PATH:
            path = self.root_path.resolve() / db_info_path
            if not path.exists():
                if logger is not None:
                    logger.warning(f'gt database missing: {path}')
                continue
            with open(str(path), 'rb') as f:
                infos = pickle.load(f)
            for cls in list(self.db_infos.keys()):
                if cls in infos:
                    self.db_infos[cls].extend(infos[cls])

        for func_name, val in sampler_cfg.PREPARE.items():
            self.db_infos = getattr(self, func_name)(self.db_infos, val)

        self.sample_groups = {}
        self.sample_class_num = {}
        self.limit_whole_scene = sampler_cfg.get('LIMIT_WHOLE_SCENE', False)
        for x in sampler_cfg.SAMPLE_GROUPS:
            class_name, sample_num = x.split(':')
            if class_name not in class_names and \
                    not (self.use_van and class_name == 'Van'):
                continue
            self.sample_class_num[class_name] = sample_num
            self.sample_groups[class_name] = {
                'sample_num': sample_num,
                'pointer': len(self.db_infos[class_name]),
                'indices': np.arange(len(self.db_infos[class_name])),
            }

    def filter_by_difficulty(self, db_infos, removed_difficulty):
        return {key: [i for i in infos
                      if i.get('difficulty', None) not in removed_difficulty]
                for key, infos in db_infos.items()}

    def filter_by_min_points(self, db_infos, min_gt_points_list):
        for name_num in min_gt_points_list:
            name, min_num = name_num.split(':')
            if int(min_num) > 0 and name in db_infos:
                db_infos[name] = [i for i in db_infos[name]
                                  if i['num_points_in_gt'] >= int(min_num)]
        return db_infos

    def sample_with_fixed_number(self, class_name, sample_group):
        """The next ``sample_num`` infos of the class's permutation; a new
        permutation is drawn only when the pointer runs out."""
        n = int(sample_group['sample_num'])
        pointer, indices = sample_group['pointer'], sample_group['indices']
        if pointer >= len(self.db_infos[class_name]):
            indices = self.rng.permutation(len(self.db_infos[class_name]))
            pointer = 0
        sampled = [self.db_infos[class_name][i]
                   for i in indices[pointer: pointer + n]]
        sample_group['pointer'] = pointer + n
        sample_group['indices'] = indices
        return sampled

    @staticmethod
    def put_boxes_on_road_planes(gt_boxes, road_plane, calib):
        a, b, c, d = road_plane
        center_cam = calib.lidar_to_rect(gt_boxes[:, 0:3])
        height_cam = (-d - a * center_cam[:, 0] - c * center_cam[:, 2]) / b
        center_cam[:, 1] = height_cam
        lidar_z = calib.rect_to_lidar(center_cam)[:, 2]
        mv_height = gt_boxes[:, 2] - gt_boxes[:, 5] / 2 - lidar_z
        gt_boxes[:, 2] -= mv_height
        return gt_boxes, mv_height

    def _load_obj_points(self, info):
        path = self.root_path / info['path']
        return np.fromfile(str(path), dtype=np.float32).reshape(
            -1, self.sampler_cfg.NUM_POINT_FEATURES)

    def _transform_obj_points(self, obj_points, box, idx, mv_height):
        obj_points = obj_points.copy()
        obj_points[:, :3] += box[:3]
        if mv_height is not None:
            obj_points[:, 2] -= mv_height[idx]
        return obj_points

    @staticmethod
    def _select_collision_free(sampled, existed_boxes, shift_x=0.0):
        """(indices of the sampled boxes that overlap no existing box and no
        other sample in BEV, the sampled boxes shifted by ``shift_x``)."""
        boxes = np.stack([x['box3d_lidar'] for x in sampled]) \
            .astype(np.float32)
        boxes[:, 0] += shift_x
        iou1 = native_ops.boxes_iou_bev(boxes[:, :7], existed_boxes[:, :7]) \
            if existed_boxes.shape[0] else None
        iou2 = native_ops.boxes_iou_bev(boxes[:, :7], boxes[:, :7])
        np.fill_diagonal(iou2, 0)
        m1 = iou1.max(axis=1) if iou1 is not None else iou2.max(axis=1)
        valid = np.nonzero((m1 + iou2.max(axis=1)) == 0)[0]
        return valid, boxes

    def _shift(self):
        """The x shift of a class's samples (none here)."""
        return 0.0

    def __call__(self, data_dict):
        gt_boxes = data_dict['gt_boxes']
        gt_names = data_dict['gt_names'].astype(str)
        existed_boxes = gt_boxes
        total_valid = []
        for class_name, group in self.sample_groups.items():
            if self.limit_whole_scene:
                num_gt = np.sum(class_name == gt_names)
                group['sample_num'] = str(
                    int(self.sample_class_num[class_name]) - num_gt)
            if int(group['sample_num']) <= 0 or \
                    len(self.db_infos.get(class_name, [])) == 0:
                continue
            sampled = self.sample_with_fixed_number(class_name, group)
            valid_idx, boxes = self._select_collision_free(
                sampled, existed_boxes, shift_x=self._shift())
            existed_boxes = np.concatenate(
                [existed_boxes, boxes[valid_idx]], axis=0)
            total_valid.extend([(sampled[i], boxes[i]) for i in valid_idx])

        sampled_boxes = existed_boxes[gt_boxes.shape[0]:]
        if total_valid:
            data_dict = self.add_sampled_boxes_to_scene(
                data_dict, sampled_boxes, total_valid)
        return data_dict

    def add_sampled_boxes_to_scene(self, data_dict, sampled_boxes,
                                   total_valid):
        keep = np.array([n in self.class_names for n in
                         data_dict['gt_names']], dtype=bool)
        gt_boxes = data_dict['gt_boxes'][keep]
        gt_names = data_dict['gt_names'][keep]
        points = data_dict['points']

        mv_height = None
        if 'road_plane' in data_dict:
            sampled_boxes, mv_height = self.put_boxes_on_road_planes(
                sampled_boxes, data_dict['road_plane'], data_dict['calib'])

        obj_points = np.concatenate([
            self._transform_obj_points(self._load_obj_points(info),
                                       sampled_boxes[idx], idx, mv_height)
            for idx, (info, _) in enumerate(total_valid)], axis=0)

        names = np.array([x[0]['name'] for x in total_valid])
        if self.use_van:
            names = np.array(['Car' if n == 'Van' else n for n in names])

        large = augmentor_utils.enlarge_box3d(
            sampled_boxes[:, :7],
            extra_width=self.sampler_cfg.REMOVE_EXTRA_WIDTH)
        points = augmentor_utils.remove_points_in_boxes3d(points, large)
        points = np.concatenate([obj_points[:, :points.shape[1]], points])

        valid_mask = np.ones(len(gt_names) + len(names), dtype=bool)
        if 'valid_noise' in data_dict:
            valid_mask[:len(gt_names)] = data_dict['valid_noise'][keep]
        else:
            valid_mask[:len(gt_names)] = 0
        data_dict['valid_noise'] = valid_mask
        data_dict['gt_boxes'] = np.concatenate([gt_boxes, sampled_boxes])
        data_dict['gt_names'] = np.concatenate([gt_names, names])
        data_dict['points'] = points
        data_dict.pop('road_plane', None)
        return data_dict


class DADataBaseSampler(DataBaseSampler):
    """The distance-adjusted sampler: samples shifted towards the ego car,
    LiDAR-aware resampling of each crop, random occlusion drop-out."""

    def __init__(self, root_path, sampler_cfg, class_names, rng,
                 logger=None):
        super().__init__(root_path, sampler_cfg, class_names, rng, logger)
        self.min_sampling_dis = sampler_cfg.MIN_SAMPLING_DIS
        self.max_sampling_dis = sampler_cfg.MAX_SAMPLING_DIS
        self.occlusion_noise = sampler_cfg.OCCLUSION_NOISE
        self.occlusion_offset = sampler_cfg.OCCLUSION_OFFSET
        self.sampling_method = sampler_cfg.SAMPLING_METHOD
        self.vert_res = sampler_cfg.VERT_RES
        self.hor_res = sampler_cfg.HOR_RES

    @staticmethod
    def la_sampling(points, vert_res=0.006, hor_res=0.003):
        """Keep the point of smallest polar angle in each cell of a
        spherical grid (the crop as a LiDAR at the origin would see it)."""
        r = np.linalg.norm(points[:, 0:3], axis=-1)
        r = np.clip(r, 1e-6, None)
        theta = np.arccos(np.clip(points[:, 2] / r, -1, 1))
        fan = np.arctan(points[:, 1] / np.clip(points[:, 0], 1e-6, None))
        vert = (theta // vert_res).astype(np.int64)
        hor = (fan // hor_res).astype(np.int64)
        key = vert * 1_000_003 + hor
        order = np.lexsort((theta, key))
        key_s = key[order]
        first = np.ones(len(key_s), bool)
        first[1:] = key_s[1:] != key_s[:-1]
        sampled = points[order[first]]
        return points if len(sampled) < 5 else sampled

    def random_drop_out(self, points, rand_noise=0.2, offset=0.3, depth=0):
        """Drop a jittered half-space of the object (occlusion); redrawn
        while fewer than 5 points would be left, at most 10 times."""
        if depth > 10:
            return points
        axis, sign = [(1, 1), (1, -1), (2, 1), (2, -1)][self.rng.choice(4)]
        noise = self.rng.randn(len(points)) * rand_noise
        if sign > 0:
            keep = points[:, axis] + noise < offset
        else:
            keep = points[:, axis] + noise >= -offset
        new_points = points[keep]
        if len(new_points) < 5:
            return self.random_drop_out(points, rand_noise, offset, depth + 1)
        return new_points

    def _shift(self):
        return self.rng.random_sample() * (self.max_sampling_dis
                                           - self.min_sampling_dis) \
            + self.min_sampling_dis

    def _transform_obj_points(self, obj_points, box, idx, mv_height):
        obj_points = obj_points.copy()
        obj_points[:, :3] += box[:3]
        if self.sampling_method == 'LiDAR-aware':
            obj_points = self.la_sampling(obj_points, self.vert_res,
                                          self.hor_res)
            obj_points[:, :3] -= box[:3]
            obj_points = self.random_drop_out(
                obj_points, self.occlusion_noise, self.occlusion_offset)
            obj_points[:, :3] += box[:3]
        if mv_height is not None:
            obj_points[:, 2] -= mv_height[idx]
        return obj_points
