"""Virtual-point generation: PENet depth completion over a KITTI split.

The port of ``tools/generate_virtual_points.py`` (the reference's
``tools/PENet/main.py --detpath``). Per frame: read the image, the LiDAR
scan and the calib; crop the image to its bottom-centre 352 x 1216 and
project the LiDAR into it as sparse depth (``prepare_frame``, numpy on
the host, so ``np.round``'s half-to-even and the last-write-wins scatter
of pixels hit twice stay those of the JAX tool); complete the depth with
``PENetC2`` on the device; back-project, fuse with the LiDAR and thin
(``depth2points``, on the host); write ``velodyne_depth/<frame>.npy``
(float16 [x, y, z, i, r/3, g/3, b/3, indicator]).

``VirtualPointGenerator.generate`` keeps the model on the device and
overlaps the host stages: frame k+1 is read and prepared, and frame k-1's
points made and saved, in worker threads while frame k's forward runs.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ... import resolve_device
from ...utils.calibration import Calibration
from ...utils.jax_weights import load_state_dict_checked, random_init_
from ...utils.png import read_png
from .depth2points import depth_to_points_rgb, fuse_virtual_and_lidar
from .penet import PENetC2

CROP_H, CROP_W = 352, 1216
STAGES = ('read_prepare', 'enet', 'cspn', 'depth2points', 'save')


def prepare_frame(root, frame_id):
    """Read frame ``frame_id`` of the split ``root`` and build PENet's
    inputs. Returns (rgb, rgb_c, sparse, position, k_mat, calib, lidar,
    (oh, ow)): the image (H, W, 3) uint8 RGB and its bottom-centre crop,
    the sparse depth (CROP_H, CROP_W), the normalized (u, v) positions
    (CROP_H, CROP_W, 2), the cropped intrinsics (3, 3), the calibration,
    the scan (N, 4) and the crop's offsets."""
    root = Path(root)
    rgb = read_png(root / 'image_2' / f'{frame_id}.png')
    calib = Calibration(root / 'calib' / f'{frame_id}.txt')
    lidar = np.fromfile(str(root / 'velodyne' / f'{frame_id}.bin'),
                        dtype=np.float32).reshape(-1, 4)

    h, w = rgb.shape[:2]
    oh, ow = h - CROP_H, (w - CROP_W) // 2
    rgb_c = rgb[oh:, ow:ow + CROP_W]

    pts_img, depth = calib.lidar_to_img(lidar[:, :3])
    u = np.round(pts_img[:, 0]).astype(np.int64) - ow
    v = np.round(pts_img[:, 1]).astype(np.int64) - oh
    ok = (depth > 0) & (u >= 0) & (u < CROP_W) & (v >= 0) & (v < CROP_H)
    sparse = np.zeros((CROP_H, CROP_W), np.float32)
    sparse[v[ok], u[ok]] = depth[ok]

    us, vs = np.meshgrid(np.arange(CROP_W), np.arange(CROP_H))
    position = np.stack([2 * us / (CROP_W - 1) - 1,
                         2 * vs / (CROP_H - 1) - 1], -1).astype(np.float32)
    k_mat = np.array([[calib.fu, 0, calib.cu - ow],
                      [0, calib.fv, calib.cv - oh],
                      [0, 0, 1]], np.float32)
    return rgb, rgb_c, sparse, position, k_mat, calib, lidar, (oh, ow)


def crop_calibration(k_mat, calib):
    """The calibration of the crop: its intrinsics with the frame's R0 and
    velodyne-to-camera transform."""
    return Calibration({
        'P2': np.array([[k_mat[0, 0], 0, k_mat[0, 2], 0],
                        [0, k_mat[1, 1], k_mat[1, 2], 0],
                        [0, 0, 1, 0]], np.float32),
        'R0': calib.R0, 'Tr_velo2cam': calib.V2C})


def frame_points(depth, rgb_c, k_mat, calib, lidar):
    """The fused float16 cloud of one frame from its completed depth."""
    virtual = depth_to_points_rgb(depth, rgb_c, crop_calibration(k_mat,
                                                                 calib))
    return fuse_virtual_and_lidar(virtual, lidar)


@dataclass
class GenerationResult:
    frames: List[str] = field(default_factory=list)
    points: List[int] = field(default_factory=list)         # per frame
    lidar_points: List[int] = field(default_factory=list)
    seconds: Dict[str, List[float]] = field(
        default_factory=lambda: {s: [] for s in STAGES})    # per frame
    wall_s: float = 0.0
    device: str = ''

    def per_frame(self):
        """Each stage's mean seconds per frame, and the wall's."""
        n = max(len(self.frames), 1)
        return {**{s: sum(v) / n for s, v in self.seconds.items()},
                'wall': self.wall_s / n}


class VirtualPointGenerator:
    """PENetC2 on ``device`` (CUDA by default; raises when it is absent
    unless ``device="cpu"``). ``state_dict``: the port's names (see
    ``penet_import.load_penet_checkpoint``); without one the weights are
    random from seed 0. The forward runs f32 with TF32 off, on cuDNN's
    deterministic algorithms: a transposed conv runs as a conv's
    data gradient, whose fastest algorithms add with atomics, so the same
    frame gave a few points more or fewer from run to run."""

    def __init__(self, state_dict=None, device='cuda'):
        self.device = resolve_device(device)
        model = PENetC2()
        if state_dict is None:
            random_init_(model, 0)
        else:
            load_state_dict_checked(model, state_dict)
        self.model = model.to(self.device).eval()

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def complete(self, rgb_c, sparse, position, k_mat, seconds=None):
        """The completed depth (CROP_H, CROP_W) of one prepared frame;
        ``seconds`` (a dict) gets the 'enet' and 'cspn' times."""
        dev = self.device

        def dev_t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        rgb = dev_t(rgb_c).permute(2, 0, 1)[None].float()
        d = dev_t(sparse)[None, None]
        pos = dev_t(position).permute(2, 0, 1)[None]
        k = dev_t(k_mat)[None]
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        allow_tf32=False):
            t = time.perf_counter()
            heads = self.model.heads(rgb, d, pos, k)
            self._sync()
            t1 = time.perf_counter()
            depth = self.model.propagate(heads)
            self._sync()
            t2 = time.perf_counter()
        if seconds is not None:
            seconds['enet'], seconds['cspn'] = t1 - t, t2 - t1
        return depth[0, 0].cpu().numpy()

    def generate(self, root, frames):
        """Write ``velodyne_depth/<frame>.npy`` for ``frames`` of the split
        ``root``. Returns a ``GenerationResult``."""
        root = Path(root)
        out_dir = root / 'velodyne_depth'
        out_dir.mkdir(parents=True, exist_ok=True)
        res = GenerationResult(device=str(self.device))
        per_frame = [dict.fromkeys(STAGES, 0.0) for _ in frames]
        counts = [None] * len(frames)

        def prepare(k):
            t = time.perf_counter()
            out = prepare_frame(root, frames[k])
            per_frame[k]['read_prepare'] = time.perf_counter() - t
            return out

        def finish(k, depth, prep):
            _, rgb_c, _, _, k_mat, calib, lidar, _ = prep
            t = time.perf_counter()
            fused = frame_points(depth, rgb_c, k_mat, calib, lidar)
            t1 = time.perf_counter()
            np.save(out_dir / f'{frames[k]}.npy', fused)
            per_frame[k]['depth2points'] = t1 - t
            per_frame[k]['save'] = time.perf_counter() - t1
            counts[k] = (len(fused), len(lidar))
            print(f'{frames[k]}: {len(fused)} points', flush=True)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            ahead = pool.submit(prepare, 0) if frames else None
            tails = []
            for k in range(len(frames)):
                prep = ahead.result()
                if k + 1 < len(frames):
                    ahead = pool.submit(prepare, k + 1)
                _, rgb_c, sparse, position, k_mat, _, _, _ = prep
                depth = self.complete(rgb_c, sparse, position, k_mat,
                                      per_frame[k])
                tails.append(pool.submit(finish, k, depth, prep))
            for f in tails:
                f.result()
        res.wall_s = time.perf_counter() - t0
        res.frames = list(frames)
        res.points = [c[0] for c in counts]
        res.lidar_points = [c[1] for c in counts]
        for s in STAGES:
            res.seconds[s] = [p[s] for p in per_frame]
        return res
