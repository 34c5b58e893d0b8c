"""Common host helpers of the loaders, the training CLI and the eval
loop: angle wrap, range mask, class filters, logger, seeding. The port's
copy of the parts of ``virconv_tpu/utils/common.py`` that they call.
"""

from __future__ import annotations

import logging
import os
import random

import numpy as np


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


def mask_points_by_range(points, limit_range):
    return ((points[:, 0] >= limit_range[0])
            & (points[:, 0] <= limit_range[3])
            & (points[:, 1] >= limit_range[1])
            & (points[:, 1] <= limit_range[4]))


def keep_arrays_by_name(gt_names, used_classes):
    inds = [i for i, name in enumerate(gt_names) if name in used_classes]
    return np.array(inds, dtype=np.int64)


def drop_info_with_name(info, name):
    keep = [i for i, x in enumerate(info['name']) if x != name]
    return {key: info[key][keep] for key in info.keys()}


def create_logger(log_file=None):
    """An INFO logger to the console and, with ``log_file``, to that
    file."""
    logger = logging.getLogger(__name__ + ('%d' % (id(log_file) % 10000)))
    logger.setLevel(logging.INFO)
    formatter = logging.Formatter('%(asctime)s  %(levelname)5s  %(message)s')
    handlers = [logging.StreamHandler()]
    if log_file is not None:
        handlers.append(logging.FileHandler(filename=log_file))
    for h in handlers:
        h.setLevel(logging.INFO)
        h.setFormatter(formatter)
        logger.addHandler(h)
    logger.propagate = False
    return logger


def set_random_seed(seed):
    """Seed Python's and numpy's global generators and the hash seed, as
    the JAX package does. The port's loaders and trainer draw from
    generators of their own, seeded explicitly."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ['PYTHONHASHSEED'] = str(seed)
