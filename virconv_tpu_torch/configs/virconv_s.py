"""VirConv-S model and KITTI data configuration as a Python dict.

``tools/cfgs/models/kitti/VirConv-S.yaml`` is VirConv-T's file with four
changes: the semi-supervised dataset (``KittiDatasetSemi``), its
``trainsemi`` split (the train frames and the pseudo-labelled ``semi/``
frames) with their info file, and a 5-epoch fine-tune. So the dict is
VirConv-T's with those keys changed; ``tests/test_torch_package.py`` holds
it equal to the parsed YAML.
"""

import copy

from .virconv_t import VIRCONV_T

VIRCONV_S = copy.deepcopy(VIRCONV_T)
VIRCONV_S['DATA_CONFIG']['DATASET'] = 'KittiDatasetSemi'
VIRCONV_S['DATA_CONFIG']['DATA_SPLIT']['train'] = 'trainsemi'
VIRCONV_S['DATA_CONFIG']['INFO_PATH']['train'] = ['kitti_infos_trainsemi.pkl']
VIRCONV_S['OPTIMIZATION']['NUM_EPOCHS'] = 5
