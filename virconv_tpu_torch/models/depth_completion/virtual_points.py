"""Virtual-point generation: PENet depth completion over a KITTI split.

The port of ``tools/generate_virtual_points.py`` (the reference's
``tools/PENet/main.py --detpath``). Per frame: read the image, the LiDAR
scan and the calib; crop the image to its bottom-centre 352 x 1216 and
project the LiDAR into it as sparse depth (``prepare_frame``, numpy on
the host, so ``np.round``'s half-to-even and the last-write-wins scatter
of pixels hit twice stay those of the JAX tool); complete the depth with
``PENetC2`` on the device; back-project, fuse with the LiDAR and thin
(``frame_points``); write ``velodyne_depth/<frame>.npy`` (float16 [x, y,
z, i, r/3, g/3, b/3, indicator]).

``frame_points`` is numpy's ``depth2points`` on the host depth, except on
a CUDA device: there the back-projection, the z cut and la_sampling2's
binning and keep-nearest run on the card from the depth and the crop
already there (``ops/depth2points.py``), on a stream of the worker
thread's own that waits for the frame's CSPN, and give numpy's bits; the
host takes only la_sampling2's angles (numpy's arccos and arctan: a device
transcendental one ulp off would move points across bins) and puts the
LiDAR's rows first.

``VirtualPointGenerator.stream`` keeps the model on the device and
overlaps the tail: frame k-1's points are made on a worker thread while
frame k's forward runs. ``generate`` reads and prepares frame k+1 on a
worker thread too, drives ``stream`` and saves what it yields.
Spans (``utils/trace.py``): ``vp.copy`` (a frame's uploads and its
depth's download), ``penet.enet``, ``penet.cspn`` and
``vp.depth2points``; counters per frame: ``vp.sparse_pixels`` (crop
pixels with a LiDAR depth), ``vp.virtual_points`` (before thinning),
``vp.thinned_points`` (kept by ``la_sampling2``), ``vp.fused_points``.
"""

from __future__ import annotations

import collections
import threading
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
from ...utils import trace
from ...utils.png import read_png
from ...ops import depth2points as d2p
from .depth2points import (depth_to_points_rgb, fuse_virtual_and_lidar,
                           lidar_rows)
from .penet import PENetC2

CROP_H, CROP_W = 352, 1216
STAGES = ('read_prepare', 'enet', 'cspn', 'depth2points', 'save')
TAIL_WORKERS = 2        # threads that make the frames' points


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


def frame_points(depth, rgb_c, k_mat, calib, lidar, sparse=None,
                 on_device=None, stream=None):
    """The fused float16 cloud of one frame from its completed depth (span
    ``vp.depth2points``; the counters with ``sparse``, the frame's sparse
    depth, given). ``on_device``, what ``complete`` left there: the
    virtual rows come from ``ops.depth2points.virtual_cloud`` on
    ``stream`` (after the frame's ``ready`` event), else from numpy."""
    with trace.span('vp.depth2points'):
        calib_c = crop_calibration(k_mat, calib)
        if on_device is None:
            virtual = depth_to_points_rgb(depth, rgb_c, calib_c)
            fused = fuse_virtual_and_lidar(virtual, lidar)
            n_virtual = len(virtual)
        else:
            rows, n_virtual = _device_rows(on_device, calib_c, stream)
            fused = np.concatenate([lidar_rows(lidar).astype(np.float16),
                                    rows])
    if sparse is not None and trace.enabled():
        trace.count({'vp.sparse_pixels': int(np.count_nonzero(sparse)),
                     'vp.virtual_points': n_virtual,
                     'vp.thinned_points': len(fused) - len(lidar),
                     'vp.fused_points': len(fused)})
    return fused


def _device_rows(on_device, calib_c, stream):
    """``virtual_cloud`` of a frame's depth and crop on the card, on
    ``stream`` once the frame's ``ready`` event has passed."""
    depth, rgb = on_device['depth'], on_device['rgb']
    stream.wait_event(on_device['ready'])
    depth.record_stream(stream)
    rgb.record_stream(stream)
    with torch.cuda.stream(stream):
        return d2p.virtual_cloud(depth, rgb, d2p.camera_params(calib_c))


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
    def complete(self, rgb_c, sparse, position, k_mat, seconds=None,
                 on_device=None):
        """The completed depth (CROP_H, CROP_W) of one prepared frame.
        ``seconds`` (a dict) gets the 'enet' and 'cspn' times, for which
        the device is synchronized after each stage; without it the two
        run back to back up to the depth's download. ``on_device`` (a dict,
        CUDA) gets what the card's tail reads: the depth ('depth'), the
        crop (H, W, 3) uint8 ('rgb') and an event recorded after the CSPN
        ('ready')."""
        dev = self.device

        def dev_t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        with trace.span('vp.copy'):
            rgb8 = dev_t(rgb_c)
            rgb = rgb8.permute(2, 0, 1)[None].float()
            d = dev_t(sparse)[None, None]
            pos = dev_t(position).permute(2, 0, 1)[None]
            k = dev_t(k_mat)[None]
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        allow_tf32=False):
            t = time.perf_counter()
            heads = self.model.heads(rgb, d, pos, k)
            if seconds is not None:
                self._sync()
                t1 = time.perf_counter()
            depth = self.model.propagate(heads)
            if seconds is not None:
                self._sync()
                seconds['enet'] = t1 - t
                seconds['cspn'] = time.perf_counter() - t1
        if on_device is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
            on_device.update(depth=depth[0, 0], rgb=rgb8, ready=ready)
        with trace.span('vp.copy'):
            return depth[0, 0].cpu().numpy()

    def stream(self, prepared, seconds=None):
        """Yield ``(frame_id, fused float16 cloud)`` for each ``(frame_id,
        prepare_frame's outputs)`` of ``prepared``, in order: each frame's
        forward on the device and one download of its depth, then its
        points (``frame_points``) on one of ``TAIL_WORKERS`` threads while
        the next frames' forwards run (on a CUDA device from the depth on
        the card, on a high-priority stream of each thread's own); a
        frame's cloud is yielded once ``TAIL_WORKERS`` later frames are on
        their way, or at the end. ``seconds`` (a dict) gets each frame's
        stage seconds, by frame id: 'enet', 'cspn' (the device
        synchronized after each) and 'depth2points'."""
        cuda = self.device.type == 'cuda'
        local = threading.local()

        def own_stream():       # high priority: ahead of the forwards' queue
            if cuda:
                local.stream = torch.cuda.Stream(self.device, priority=-1)

        def tail(fid, depth, prep, on_device):
            _, rgb_c, sparse, _, k_mat, calib, lidar, _ = prep
            t = time.perf_counter()
            fused = frame_points(depth, rgb_c, k_mat, calib, lidar, sparse,
                                 on_device, getattr(local, 'stream', None))
            if seconds is not None:
                seconds[fid]['depth2points'] = time.perf_counter() - t
            return fused

        with ThreadPoolExecutor(TAIL_WORKERS, initializer=own_stream) as pool:
            tails = collections.deque()
            for fid, prep in prepared:
                _, rgb_c, sparse, position, k_mat, _, _, _ = prep
                stage = None
                if seconds is not None:
                    stage = seconds.setdefault(fid, {})
                on_device = {} if cuda else None
                depth = self.complete(rgb_c, sparse, position, k_mat, stage,
                                      on_device=on_device)
                tails.append((fid, pool.submit(tail, fid, depth, prep,
                                               on_device)))
                if len(tails) > TAIL_WORKERS:
                    fid0, fut = tails.popleft()
                    yield fid0, fut.result()
            while tails:
                fid0, fut = tails.popleft()
                yield fid0, fut.result()

    def generate(self, root, frames):
        """Write ``velodyne_depth/<frame>.npy`` for ``frames`` of the split
        ``root``: each frame read and prepared ahead on a worker thread,
        ``stream``, and each yielded cloud saved. Returns a
        ``GenerationResult``."""
        root = Path(root)
        out_dir = root / 'velodyne_depth'
        out_dir.mkdir(parents=True, exist_ok=True)
        res = GenerationResult(device=str(self.device))
        stages = {f: dict.fromkeys(STAGES, 0.0) for f in frames}
        lidar_points = {}

        def prepare(fid):
            t = time.perf_counter()
            out = prepare_frame(root, fid)
            stages[fid]['read_prepare'] = time.perf_counter() - t
            lidar_points[fid] = len(out[6])
            return out

        t0 = time.perf_counter()
        with ThreadPoolExecutor(1) as reader:
            def prepared():
                ahead = reader.submit(prepare, frames[0]) if frames else None
                for k, fid in enumerate(frames):
                    prep = ahead.result()
                    if k + 1 < len(frames):
                        ahead = reader.submit(prepare, frames[k + 1])
                    yield fid, prep

            for fid, fused in self.stream(prepared(), seconds=stages):
                t = time.perf_counter()
                np.save(out_dir / f'{fid}.npy', fused)
                stages[fid]['save'] = time.perf_counter() - t
                res.points.append(len(fused))
                print(f'{fid}: {len(fused)} points', flush=True)
        res.wall_s = time.perf_counter() - t0
        res.frames = list(frames)
        res.lidar_points = [lidar_points[f] for f in frames]
        for s in STAGES:
            res.seconds[s] = [stages[f][s] for f in frames]
        return res
