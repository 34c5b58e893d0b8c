"""Synthetic on-disk KITTI trees for the port's loader and eval loop.

Writes the layout of ``tools/make_mini_kitti.py`` (``training/{velodyne,
velodyne_depth, calib, label_2, planes, image_2}``, ``ImageSets``), then
the info files ``kitti_infos_{train,val}.pkl`` with the port's
``KittiDatasetMM.get_infos`` and, when the train split has frames, its gt
database (``gt_database_mm/``, ``kitti_dbinfos_train_mm.pkl``) with
``KittiDatasetMM.create_groundtruth_database``. Two modes:

* ``mini``: the frames ``build_mini_kitti`` writes for the same seed (a
  plane of random points and three car clusters per frame), so the infos
  can be held against the JAX package's;
* ``scene``: KITTI-scale street scenes of ``utils/synth_scene.make_scene``
  (about 17-20k LiDAR points and 40k virtual points per frame), labelled
  with the scene's cars whose centre lies in the camera's view, under the
  calibration of ``utils/bench_inputs.KITTI_CALIB``; every frame is in the
  val split unless ``n_train`` says otherwise.

``velodyne_depth`` holds the fused cloud as PENet writes it, float16:
[x, y, z, intensity, r, g, b, indicator] with indicator 1 for virtual
points and 2 for real LiDAR points, whose intensity is scaled by 10.
Images are PNGs whose rows are written with all five PNG filters
(``utils/png.encode_png``): seeded textured ones (``textured_image``) in
``scene`` mode, so that virtual points made from them have colours,
black ones in ``mini`` mode, as ``build_mini_kitti`` writes them.

With ``n_semi`` the tree also has the semi split of VirConv-S: ``semi/``
frames, ``ImageSets/semi.txt`` and ``kitti_infos_trainsemi.pkl``.

    python -m virconv_tpu_torch.utils.mini_kitti <root> --mode scene \\
        [--frames 4] [--seed 0] [--n_train N] [--n_semi N]
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .calibration import Calibration
from .png import FILTERS, encode_png

IMAGE_SHAPE = (375, 1242)
SUBDIRS = ('velodyne', 'velodyne_depth', 'calib', 'label_2', 'planes',
           'image_2')
MINI_CALIB = (
    'P0: 707.0 0.0 601.8 0.0 0.0 707.0 183.1 0.0 0.0 0.0 1.0 0.0\n'
    'P1: 707.0 0.0 601.8 0.0 0.0 707.0 183.1 0.0 0.0 0.0 1.0 0.0\n'
    'P2: 707.0 0.0 601.8 45.7 0.0 707.0 183.1 -0.3 0.0 0.0 1.0 0.004\n'
    'P3: 707.0 0.0 601.8 0.0 0.0 707.0 183.1 0.0 0.0 0.0 1.0 0.0\n'
    'R0_rect: 0.9999 0.0098 -0.0074 -0.0099 0.9999 -0.0043 0.0074 '
    '0.0044 0.9999\n'
    'Tr_velo_to_cam: 0.0075 -0.9999 -0.0002 -0.0040 0.0029 0.0002 '
    '-1.0 -0.0763 0.9999 0.0075 0.0029 -0.2718\n'
    'Tr_imu_to_velo: 1.0 0.0 0.0 0.0 0.0 1.0 0.0 0.0 0.0 0.0 1.0 0.0\n')
PLANE = '# Plane\nWidth 4\nHeight 1\n0.0 -1.0 0.0 -1.73\n'


def write_png(path, height, width, image=None):
    """An 8-bit RGB PNG of ``height`` x ``width``: ``image`` (H, W, 3)
    uint8, black without one. Its rows cycle through the five PNG
    filters."""
    if image is None:
        image = np.zeros((height, width, 3), np.uint8)
    if image.shape != (height, width, 3):
        raise ValueError(f'image {image.shape} for {height} x {width}')
    Path(path).write_bytes(encode_png(image, FILTERS))


def textured_image(seed, height=IMAGE_SHAPE[0], width=IMAGE_SHAPE[1]):
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


def street_depth(rng, height=352, width=1216, top=23):
    """A completed depth (H, W) float32 of a street as PENet gives it
    for a crop whose first row is image row ``top``: beyond 100 m above
    the horizon, the ground seen from 1.65 m below it, 12 boxes (cars,
    walls) at 4-60 m, 3 % jitter and 1 % holes (0)."""
    v = np.arange(height, dtype=np.float32)[:, None] + top
    ground = 721.5 * 1.65 / np.maximum(v - 172.9, 0.5)
    depth = np.broadcast_to(np.where(v > 180, ground, 150.0),
                            (height, width)).astype(np.float32)
    for _ in range(12):
        y0, x0 = rng.integers(0, height - 20), rng.integers(0, width - 20)
        depth[y0:y0 + rng.integers(20, 80), x0:x0 + rng.integers(20, 200)] = \
            rng.uniform(4, 60)
    depth *= rng.uniform(0.97, 1.03, depth.shape).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.01] = 0
    return depth


def _calib_text(calib):
    """A KITTI calib file of a ``{'P2', 'R0', 'Tr_velo2cam'}`` dict."""
    def row(name, m):
        return name + ': ' + ' '.join('%.12e' % v for v in
                                      np.ravel(m)) + '\n'
    p = calib['P2']
    return (row('P0', p) + row('P1', p) + row('P2', p) + row('P3', p)
            + row('R0_rect', calib['R0'])
            + row('Tr_velo_to_cam', calib['Tr_velo2cam'])
            + row('Tr_imu_to_velo', np.eye(3, 4)))


def _mini_frame(rng, calib):
    """One frame of ``build_mini_kitti``: (label lines, fused cloud),
    drawing from ``rng`` in the same order."""
    labels, boxes_lidar = [], []
    for i in range(3):
        x_l = 10.0 + 12 * i + rng.uniform(-1, 1)
        y_l = rng.uniform(-3, 3)
        z_l = -1.0
        loc_cam = calib.lidar_to_rect(
            np.array([[x_l, y_l, z_l - 1.56 / 2 + 1.56 / 2]]))[0]
        loc_cam[1] += 1.56 / 2                  # bottom centre
        ry = rng.uniform(-np.pi, np.pi)
        labels.append(
            f'Car 0.0 0 0.0 300.0 150.0 400.0 250.0 '
            f'1.56 1.60 3.90 {loc_cam[0]:.2f} {loc_cam[1]:.2f} '
            f'{loc_cam[2]:.2f} {ry:.2f}')
        boxes_lidar.append([x_l, y_l, z_l, 3.9, 1.6, 1.56,
                            -(np.pi / 2 + ry)])
    n_bg = 4000
    pts = np.zeros((n_bg, 8), np.float32)
    pts[:, 0] = rng.uniform(1, 68, n_bg)
    pts[:, 1] = rng.uniform(-30, 30, n_bg)
    pts[:, 2] = rng.uniform(-2.5, 0.5, n_bg)
    pts[:, 3] = rng.uniform(0, 10, n_bg)
    pts[:, 4:7] = rng.uniform(0, 0.33, (n_bg, 3))
    pts[:, 7] = rng.integers(1, 3, n_bg)
    clusters = []
    for b in boxes_lidar:                       # points in each box
        m = 200
        c = np.zeros((m, 8), np.float32)
        lx = rng.uniform(-0.48, 0.48, m) * b[3]
        ly = rng.uniform(-0.48, 0.48, m) * b[4]
        ca, sa = np.cos(b[6]), np.sin(b[6])
        c[:, 0] = b[0] + lx * ca - ly * sa
        c[:, 1] = b[1] + lx * sa + ly * ca
        c[:, 2] = b[2] + rng.uniform(-0.45, 0.45, m) * b[5]
        c[:, 3] = rng.uniform(0, 10, m)
        c[:, 7] = rng.integers(1, 3, m)
        clusters.append(c)
    return labels, np.concatenate([pts] + clusters)


def _scene_frame(seed, calib):
    """One ``make_scene`` frame: (label lines, fused cloud)."""
    from ..datasets.kitti import kitti_utils
    from .synth_scene import fused_cloud, make_scene
    s = make_scene(seed=seed)
    boxes = s['boxes'].astype(np.float64)
    cam = kitti_utils.boxes3d_lidar_to_kitti_camera(boxes, calib)
    uv, depth = calib.rect_to_img(cam[:, 0:3])
    seen = ((depth > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < IMAGE_SHAPE[1])
            & (uv[:, 1] >= 0) & (uv[:, 1] < IMAGE_SHAPE[0]))
    boxes, cam = boxes[seen], cam[seen]
    img = kitti_utils.boxes3d_kitti_camera_to_imageboxes(cam, calib,
                                                         IMAGE_SHAPE)
    alpha = -np.arctan2(-boxes[:, 1], boxes[:, 0]) + cam[:, 6]
    labels = ['Car 0.00 0 %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f '
              '%.2f %.2f %.2f' % (alpha[i], *img[i], cam[i, 4], cam[i, 5],
                                  cam[i, 3], *cam[i, 0:3], cam[i, 6])
              for i in range(len(cam))]
    return labels, fused_cloud(s)


def _write_frames(split_dir, ids, mode, rng, scene_seed):
    """Write the frames ``ids`` under ``split_dir`` (``training/`` or
    ``semi/``); ``scene`` frame k is ``make_scene(scene_seed + k)``."""
    for sub in SUBDIRS:
        (split_dir / sub).mkdir(parents=True, exist_ok=True)
    for k, fid in enumerate(ids):
        write_png(split_dir / 'image_2' / f'{fid}.png', *IMAGE_SHAPE,
                  textured_image((scene_seed, k)) if mode == 'scene'
                  else None)
        if mode == 'mini':
            (split_dir / 'calib' / f'{fid}.txt').write_text(MINI_CALIB)
            calib = Calibration(split_dir / 'calib' / f'{fid}.txt')
            labels, cloud = _mini_frame(rng, calib)
            lidar = cloud.copy()
            lidar[:, 4:8] = 0
        elif mode == 'scene':
            from .bench_inputs import KITTI_CALIB
            (split_dir / 'calib' / f'{fid}.txt').write_text(
                _calib_text(KITTI_CALIB))
            calib = Calibration(split_dir / 'calib' / f'{fid}.txt')
            labels, cloud = _scene_frame(scene_seed + k, calib)
            lidar = cloud[cloud[:, 7] == 2].copy()
            lidar[:, 3] /= 10
        else:
            raise ValueError(f'mode {mode!r}: expected mini or scene')
        (split_dir / 'label_2' / f'{fid}.txt').write_text(
            '\n'.join(labels) + '\n')
        (split_dir / 'planes' / f'{fid}.txt').write_text(PLANE)
        np.save(split_dir / 'velodyne_depth' / f'{fid}.npy',
                cloud.astype(np.float16))
        lidar[:, :4].astype(np.float32).tofile(
            split_dir / 'velodyne' / f'{fid}.bin')


def write_tree(root, mode='scene', frames=4, seed=0, n_train=None,
               n_semi=0):
    """Write ``frames`` frames and their infos under ``root``; returns
    ``root``. ``n_train`` frames go to the train split, the rest to val
    (default: all but the last in ``mini`` mode, as ``build_mini_kitti``;
    none in ``scene`` mode). ``n_semi`` more frames go to ``semi/`` (the
    VirConv-S layout, with ids from 000000 again): ``ImageSets/semi.txt``
    and ``kitti_infos_trainsemi.pkl``, the train infos with ``split``
    'training' then the semi ones with ``split`` 'semi'."""
    root = Path(root)
    (root / 'ImageSets').mkdir(parents=True, exist_ok=True)
    ids = [f'{i:06d}' for i in range(frames)]
    rng = np.random.default_rng(seed)
    _write_frames(root / 'training', ids, mode, rng, seed)
    if n_train is None:
        n_train = max(1, frames - 1) if mode == 'mini' else 0
    for split, part in (('train', ids[:n_train]), ('val', ids[n_train:])):
        (root / 'ImageSets' / f'{split}.txt').write_text(
            ''.join(f'{i}\n' for i in part))
    write_infos(root, gt_database=n_train > 0)
    if n_semi:
        semi_ids = [f'{i:06d}' for i in range(n_semi)]
        _write_frames(root / 'semi', semi_ids, mode, rng, seed + frames)
        (root / 'ImageSets' / 'semi.txt').write_text(
            ''.join(f'{i}\n' for i in semi_ids))
        write_semi_infos(root, semi_ids)
    return root


def write_infos(root, gt_database=False):
    """``kitti_infos_{train,val}.pkl`` of the tree's splits; with
    ``gt_database`` also the train split's gt database."""
    from ..config import virconv_t_config
    from ..datasets.kitti.kitti_dataset_mm import KittiDatasetMM
    root = Path(root)
    cfg = virconv_t_config()
    ds = KittiDatasetMM(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root_path=root)
    for split in ('train', 'val'):
        ds.set_split(split)
        with open(root / f'kitti_infos_{split}.pkl', 'wb') as f:
            pickle.dump(ds.get_infos(num_workers=1), f)
    if gt_database:
        ds.create_groundtruth_database(root / 'kitti_infos_train.pkl',
                                       split='train')


def write_semi_infos(root, semi_ids):
    """``kitti_infos_trainsemi.pkl``: the train infos, each with ``split``
    'training', then the infos of the ``semi/`` frames ``semi_ids`` with
    ``split`` 'semi'."""
    from ..config import virconv_t_config
    from ..datasets.kitti.kitti_dataset_mm import KittiDatasetMM
    root = Path(root)
    with open(root / 'kitti_infos_train.pkl', 'rb') as f:
        infos = pickle.load(f)
    for info in infos:
        info['split'] = 'training'
    cfg = virconv_t_config()
    ds = KittiDatasetMM(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root_path=root)
    ds.root_split_path = root / 'semi'
    for info in ds.get_infos(num_workers=1, sample_id_list=semi_ids):
        info['split'] = 'semi'
        infos.append(info)
    with open(root / 'kitti_infos_trainsemi.pkl', 'wb') as f:
        pickle.dump(infos, f)


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('root')
    ap.add_argument('--mode', choices=('mini', 'scene'), default='scene')
    ap.add_argument('--frames', type=int, default=4)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--n_train', type=int, default=None)
    ap.add_argument('--n_semi', type=int, default=0)
    a = ap.parse_args()
    write_tree(a.root, a.mode, a.frames, a.seed, a.n_train, a.n_semi)
    print(f'{a.mode} KITTI tree of {a.frames} frames at {a.root}')
