"""Point feature encoder: picks and casts the point feature columns of
every replica's streams. The port's copy of
``virconv_tpu/datasets/processor/point_feature_encoder.py``.

``absolute_coordinates_encoding_mm`` keeps all 8 multimodal features;
``absolute_coordinates_encoding`` keeps [x, y, z] and the used features.
"""

from __future__ import annotations

import numpy as np


class PointFeatureEncoder:
    def __init__(self, config, rot_num=1):
        self.rot_num = rot_num
        self.encoding_type = config.encoding_type
        self.used_feature_list = list(config.used_feature_list)
        self.src_feature_list = list(config.src_feature_list)

    def forward(self, data_dict):
        for i in range(self.rot_num):
            sid = '' if i == 0 else str(i)
            for key in (f'points{sid}', f'points_mm{sid}'):
                if key not in data_dict:
                    continue
                pts = data_dict[key]
                if self.encoding_type == 'absolute_coordinates_encoding_mm':
                    data_dict[key] = pts.astype(np.float32)
                elif self.encoding_type == 'absolute_coordinates_encoding':
                    cols = [0, 1, 2] + [
                        3 + self.src_feature_list.index(f)
                        for f in self.used_feature_list
                        if f not in ('x', 'y', 'z')]
                    data_dict[key] = pts[:, cols].astype(np.float32)
                else:
                    raise NotImplementedError(self.encoding_type)
        data_dict['use_lead_xyz'] = True
        return data_dict
