"""The frames of the virtual-point cell (``modes/vp.py``), made from
``--seed`` at set-up.

A frame is what ``tools/PENet/main.py --detpath`` reads for one KITTI
frame: a 375 x 1242 RGB image, the LiDAR scan (x, y, z, intensity) and the
calibration. The scan is a street scene of ``streets.make_scene`` (64 rows
over -25 to +2 degrees, the HDL-64E's vertical field, 520 columns over the
front 90 degrees, KITTI's step of about 0.17 degrees); the image is
``textured_image``, a frozen copy of the program's
``utils/mini_kitti.textured_image``; the calibration is KITTI's
(``streets.KITTI_P2``, ``KITTI_R0``, ``KITTI_V2C``). ``prepare`` is a
frozen copy of the arithmetic of the program's ``prepare_frame``: the
bottom-centre crop, the scan projected into it as sparse depth (numpy's
half-to-even rounding, the last write winning on a pixel hit twice), the
normalized pixel positions and the crop's intrinsics.

Traffic keys: ``mode`` ('vp'), ``frames`` (1 a forward), ``cars`` and
``pool`` (scenes made at set-up, each with its own image), ``workers``
(the generator's host threads, the program's ``TAIL_WORKERS``: stated for
the record, and checked by ``modes/vp.py``). Item i is the pool frame that
a generator seeded (seed, i) picks.
"""

from __future__ import annotations

import numpy as np

from . import streets
from refnet.utils.calibration import Calibration


def textured_image(seed, height, width):
    """A seeded (H, W, 3) uint8 image: smooth stripes of random phase and
    period in each channel, plus noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    chans = []
    for _ in range(3):
        fy, fx, ph = rng.uniform(0.01, 0.1, 2).tolist() + [
            rng.uniform(0, 2 * np.pi)]
        chans.append(128 + 80 * np.sin(fy * y + fx * x + ph))
    img = np.stack(chans, -1) + rng.normal(0, 12, (height, width, 3))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def kitti_calib():
    return {'P2': streets.KITTI_P2, 'R0': streets.KITTI_R0,
            'Tr_velo2cam': streets.KITTI_V2C}


def prepare(rgb, calib, lidar, crop):
    """(rgb, rgb_c, sparse, position, k_mat, calib, lidar, (oh, ow)) of one
    frame, as the program's ``prepare_frame`` returns them (``calib`` stays
    the {'P2', 'R0', 'Tr_velo2cam'} dict)."""
    ch, cw = crop
    h, w = rgb.shape[:2]
    oh, ow = h - ch, (w - cw) // 2
    rgb_c = rgb[oh:, ow:ow + cw]
    c = Calibration(calib)
    pts_img, depth = c.lidar_to_img(lidar[:, :3])
    u = np.round(pts_img[:, 0]).astype(np.int64) - ow
    v = np.round(pts_img[:, 1]).astype(np.int64) - oh
    ok = (depth > 0) & (u >= 0) & (u < cw) & (v >= 0) & (v < ch)
    sparse = np.zeros((ch, cw), np.float32)
    sparse[v[ok], u[ok]] = depth[ok]
    us, vs = np.meshgrid(np.arange(cw), np.arange(ch))
    position = np.stack([2 * us / (cw - 1) - 1,
                         2 * vs / (ch - 1) - 1], -1).astype(np.float32)
    k_mat = np.array([[c.fu, 0, c.cu - ow], [0, c.fv, c.cv - oh],
                      [0, 0, 1]], np.float32)
    return rgb, rgb_c, sparse, position, k_mat, calib, lidar, (oh, ow)


class Frames:
    """The pool of prepared frames and the items that pick from it."""

    def __init__(self, params, config, seed):
        self.p = dict(params)
        self.seed = int(seed)
        if self.p['mode'] != 'vp':
            raise ValueError(f'traffic mode {self.p["mode"]!r}')
        self.crop = tuple(config['crop'])
        height, width = config['image']
        rng = np.random.default_rng([self.seed, 2 ** 32])
        scene_seeds = rng.integers(0, 2 ** 62, int(self.p['pool']))
        self.pool = []
        for s in scene_seeds:
            scene = streets.make_scene(seed=int(s),
                                       n_cars=int(self.p['cars']))
            image = textured_image(int(s), height, width)
            self.pool.append(prepare(image, kitti_calib(), scene['lidar'],
                                     self.crop))

    @property
    def frames(self) -> int:
        return int(self.p['frames'])

    @property
    def workers(self) -> int:
        return int(self.p['workers'])

    def item(self, i: int) -> int:
        """The pool index of item ``i``."""
        r = np.random.default_rng([self.seed, int(i)])
        return int(r.integers(len(self.pool)))

    def inputs(self, k, device):
        """The model's inputs of pool frame ``k`` (NCHW float32 tensors on
        ``device``)."""
        import torch
        _, rgb_c, sparse, position, k_mat, _, _, _ = self.pool[k]

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return (t(rgb_c).permute(2, 0, 1)[None].float(),
                t(sparse)[None, None], t(position).permute(2, 0, 1)[None],
                t(k_mat)[None])
