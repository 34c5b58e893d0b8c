"""X_TRANS: the invertible test-time transform ensemble (host side).

The port's copy of ``virconv_tpu/datasets/augmentor/x_transform.py``, over
``utils/transforms.py``: ``input_transform`` replicates a test scene into
``points``, ``points1``, ... with each replica's [rot, flip, scale]
recorded in ``transform_param``.
"""

from __future__ import annotations

import numpy as np

from ...utils import transforms as tr


class X_TRANS:
    def __init__(self, augmentor_configs=None, rot_num=1):
        self.rot_num = rot_num
        self.augmentor_configs = augmentor_configs

    def get_params(self):
        return tr.get_transform_params(self.augmentor_configs, self.rot_num)

    def input_transform(self, data_dict):
        params = self.get_params()
        src_points = data_dict['points'].copy()
        for i in range(self.rot_num):
            sid = '' if i == 0 else str(i)
            data_dict['points' + sid] = tr.transform_points_np(
                src_points, np.asarray(params[i], np.float32))
        data_dict['transform_param'] = params
        return data_dict
