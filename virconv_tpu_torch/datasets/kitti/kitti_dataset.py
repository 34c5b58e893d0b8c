"""Plain LiDAR-only KITTI dataset.

The port's copy of ``virconv_tpu/datasets/kitti/kitti_dataset.py``
(``tools/cfgs/dataset_configs/kitti_dataset.yaml`` names it; the shipped
VirConv configs use ``KittiDatasetMM``): 4-column ``velodyne/*.bin``
points (x, y, z, intensity), the camera field-of-view crop, the gt boxes
from the camera frame (DontCare dropped) and the road plane. An index
whose sample is left without gt boxes is replaced by a random one, drawn
from the dataset's ``RandomState`` where the JAX dataset draws from
numpy's global state. Infos, the gt database and the prediction dicts
are ``KittiDatasetMM``'s.
"""

from __future__ import annotations

import copy

import numpy as np

from ...utils import common as common_utils
from . import kitti_utils
from .kitti_dataset_mm import KittiDatasetMM


class KittiDataset(KittiDatasetMM):
    def __getitem__(self, index):
        info = copy.deepcopy(self.kitti_infos[index])
        sample_idx = info['point_cloud']['lidar_idx']
        points = self.get_lidar(sample_idx)
        calib = self.get_calib(sample_idx)
        img_shape = info['image']['image_shape']
        if self.dataset_cfg.FOV_POINTS_ONLY:
            pts_rect = calib.lidar_to_rect(points[:, 0:3])
            points = points[self.get_fov_flag(pts_rect, img_shape, calib)]

        input_dict = {'points': points, 'frame_id': sample_idx,
                      'calib': calib}
        if 'annos' in info:
            annos = common_utils.drop_info_with_name(info['annos'],
                                                     name='DontCare')
            cam = np.concatenate([annos['location'], annos['dimensions'],
                                  annos['rotation_y'][..., None]],
                                 axis=1).astype(np.float32)
            input_dict['gt_names'] = annos['name']
            input_dict['gt_boxes'] = \
                kitti_utils.boxes3d_kitti_camera_to_lidar(cam, calib)
            plane = self.get_road_plane(sample_idx)
            if plane is not None:
                input_dict['road_plane'] = plane

        data_dict = self.prepare_data(input_dict)
        if data_dict is None:            # no gt box left: another sample
            return self.__getitem__(self.rng.randint(len(self)))
        data_dict['image_shape'] = img_shape
        data_dict['calib'] = calib
        return data_dict
