"""Street scenes for the benchmark's traffic, frozen.

Copied from the program's ``utils/synth_scene.py`` (``make_scene``,
``fused_cloud``) and ``utils/bench_inputs.py`` (the KITTI calibration, the
two serving streams, the training replicas' transforms), and from
``datasets/dataset.py`` (``partition``, ``input_point_discard``,
``fuse_streams``) and ``utils/transforms.py`` (the numpy transforms), so
that later changes to the program cannot move the yardstick. A procedural
street (ground, walls, ``n_cars`` cars) ray-cast with a 64-beam LiDAR and a
half-resolution camera grid: ~17-20k LiDAR points and ~60k fused points a
frame, the occupancy, neighbor-hit and NMS statistics of KITTI crops.
"""

from __future__ import annotations

import numpy as np

GROUND_Z = -1.73


def _car_boxes(rng, n_cars):
    """Random car-like OBBs [x, y, z_center, dx, dy, dz, yaw] in range."""
    x = rng.uniform(5.0, 65.0, n_cars)
    y = rng.uniform(-30.0, 30.0, n_cars)
    dx = rng.uniform(3.4, 4.6, n_cars)
    dy = rng.uniform(1.5, 1.9, n_cars)
    dz = rng.uniform(1.4, 1.7, n_cars)
    yaw = np.where(rng.uniform(size=n_cars) < 0.7,
                   rng.normal(0, 0.15, n_cars),           # aligned traffic
                   rng.uniform(-np.pi, np.pi, n_cars))    # parked/clutter
    z = GROUND_Z + dz / 2
    return np.stack([x, y, z, dx, dy, dz, yaw], -1).astype(np.float32)


def _wall_planes(rng, n_walls):
    """Vertical wall segments: [nx, ny, d, y_lo, y_hi, x_lo, x_hi, z_hi]."""
    walls = []
    for side in (-1.0, 1.0):
        yw = side * rng.uniform(12.0, 35.0)
        walls.append((0.0, 1.0, yw, -80.0, 80.0, 0.0, 70.0,
                      GROUND_Z + rng.uniform(4.0, 9.0)))
    for _ in range(max(0, n_walls - 2)):
        xw = rng.uniform(40.0, 69.0)
        walls.append((1.0, 0.0, xw, -40.0, 40.0, 0.0, 70.4,
                      GROUND_Z + rng.uniform(3.0, 8.0)))
    return np.asarray(walls, np.float32)


def _ray_hits(origin, dirs, boxes, walls, max_range=75.0):
    """First-hit distance for each ray against ground/boxes/walls.

    dirs: (R, 3) unit vectors. Returns (t, surf_id) with t=inf for misses;
    surf_id: -1 ground, -2 wall, >=0 box index.
    """
    r = dirs.shape[0]
    t_best = np.full(r, np.inf, np.float32)
    sid = np.full(r, -99, np.int32)

    dz = dirs[:, 2]
    tg = np.where(dz < -1e-6, (GROUND_Z - origin[2]) / np.minimum(dz, -1e-6),
                  np.inf).astype(np.float32)
    hit = tg < t_best
    t_best = np.where(hit, tg, t_best)
    sid = np.where(hit, -1, sid)

    for w in walls:
        n = np.array([w[0], w[1], 0.0], np.float32)
        denom = dirs @ n
        tw = np.where(np.abs(denom) > 1e-6,
                      (w[2] - origin @ n) / np.where(np.abs(denom) > 1e-6,
                                                     denom, 1.0),
                      np.inf).astype(np.float32)
        p = origin[None] + tw[:, None] * dirs
        ok = ((tw > 0.5) & (p[:, 2] <= w[7]) & (p[:, 2] >= GROUND_Z)
              & (p[:, 1] >= w[3]) & (p[:, 1] <= w[4])
              & (p[:, 0] >= w[5]) & (p[:, 0] <= w[6]))
        tw = np.where(ok, tw, np.inf)
        hit = tw < t_best
        t_best = np.where(hit, tw, t_best)
        sid = np.where(hit, -2, sid)

    # OBB slab test, vectorized over (rays, boxes)
    if len(boxes):
        c, dims, yaw = boxes[:, :3], boxes[:, 3:6], boxes[:, 6]
        ca, sa = np.cos(yaw), np.sin(yaw)
        # box frame axes (per box)
        ax = np.stack([np.stack([ca, sa, np.zeros_like(ca)], -1),
                       np.stack([-sa, ca, np.zeros_like(ca)], -1),
                       np.tile(np.array([0, 0, 1.0], np.float32),
                               (len(boxes), 1))], 1)     # (B, 3, 3)
        oo = np.einsum('bk,bjk->bj', origin[None] - c, ax)   # (B, 3)
        dd = np.einsum('rk,bjk->rbj', dirs, ax)           # (R, B, 3)
        half = dims / 2
        inv = 1.0 / np.where(np.abs(dd) > 1e-6, dd, 1e-6)
        t1 = (-half[None] - oo[None]) * inv
        t2 = (half[None] - oo[None]) * inv
        tmin = np.minimum(t1, t2).max(-1)                 # (R, B)
        tmax = np.maximum(t1, t2).min(-1)
        ok = (tmax >= np.maximum(tmin, 0.5)) & (tmin < max_range)
        tb = np.where(ok, tmin, np.inf).astype(np.float32)
        bi = tb.argmin(1)
        tbb = tb[np.arange(r), bi]
        hit = tbb < t_best
        t_best = np.where(hit, tbb, t_best)
        sid = np.where(hit, bi.astype(np.int32), sid)

    t_best = np.where(t_best < max_range, t_best, np.inf)
    return t_best, sid


def make_scene(seed=0, n_cars=25, n_walls=4, lidar_cols=520,
               lidar_rows=64, img_stride=2, crop=(352, 1216),
               noise=0.02, dropout=0.15):
    """Build one synthetic frame.

    Returns dict with:
      lidar:   (N, 4) [x, y, z, intensity]
      virtual: (M, 8) [x, y, z, intensity, r, g, b, 2.0]
      boxes:   (n_cars, 7) gt-like boxes
    """
    rng = np.random.default_rng(seed)
    boxes = _car_boxes(rng, n_cars)
    walls = _wall_planes(rng, n_walls)
    origin = np.array([0.0, 0.0, 0.0], np.float32)

    # ---- LiDAR beam grid over the front 90 degrees ----
    az = np.linspace(-0.785, 0.785, lidar_cols, dtype=np.float32)
    el = np.linspace(-0.4363, 0.0349, lidar_rows, dtype=np.float32)
    aa, ee = np.meshgrid(az, el, indexing='ij')
    dirs = np.stack([np.cos(ee) * np.cos(aa), np.cos(ee) * np.sin(aa),
                     np.sin(ee)], -1).reshape(-1, 3)
    t, sid = _ray_hits(origin, dirs, boxes, walls)
    ok = np.isfinite(t) & (rng.uniform(size=t.shape) >= dropout)
    t = t[ok] + rng.normal(0, noise, ok.sum()).astype(np.float32)
    pts = origin[None] + t[:, None] * dirs[ok]
    intens = np.where(sid[ok] >= 0, rng.uniform(0.3, 0.9, ok.sum()),
                      rng.uniform(0.05, 0.5, ok.sum())).astype(np.float32)
    lidar = np.concatenate([pts, intens[:, None]], -1).astype(np.float32)

    # ---- virtual points: camera half-res pixel grid, same surfaces ----
    ch, cw = crop
    fu = fv = 721.5
    cu, cv = cw / 2, ch / 2
    us = np.arange(0, cw, img_stride, dtype=np.float32) + 0.5
    vs = np.arange(0, ch, img_stride, dtype=np.float32) + 0.5
    uu, vv = np.meshgrid(us, vs, indexing='ij')
    # camera: x_cam right (-y_velo), y_cam down (-z_velo), z_cam fwd (x_velo)
    xc = (uu - cu) / fu
    yc = (vv - cv) / fv
    dirs_c = np.stack([np.ones_like(xc), -xc, -yc], -1).reshape(-1, 3)
    dirs_c /= np.linalg.norm(dirs_c, axis=-1, keepdims=True)
    cam_origin = np.array([0.27, 0.0, 0.08], np.float32)
    t, sid = _ray_hits(cam_origin, dirs_c.astype(np.float32), boxes, walls)
    ok = np.isfinite(t)
    t = t[ok] * (1 + rng.normal(0, 0.004, ok.sum()).astype(np.float32))
    pts = cam_origin[None] + t[:, None] * dirs_c[ok]
    m = ok.sum()
    col = rng.uniform(0.2, 0.8, (len(boxes), 3)).astype(np.float32)
    rgb = np.where((sid[ok] >= 0)[:, None], col[np.clip(sid[ok], 0, None)],
                   rng.uniform(0.3, 0.5, (m, 3)).astype(np.float32))
    virt = np.concatenate([pts, rng.uniform(0, 1, (m, 1)), rgb,
                           np.full((m, 1), 2.0)], -1).astype(np.float32)
    return {'lidar': lidar, 'virtual': virt, 'boxes': boxes}


def fused_cloud(scene):
    """The 8-feature cloud of a ``make_scene`` frame as a KITTI tree's
    ``velodyne_depth`` holds it: the LiDAR points (intensity x 10, no
    colour, indicator 2), then the virtual points (indicator 1)."""
    lidar, virt = scene['lidar'], scene['virtual'].copy()
    n = len(lidar)
    real = np.concatenate([lidar[:, :3], lidar[:, 3:4] * 10,
                           np.zeros((n, 3), np.float32),
                           np.full((n, 1), 2.0, np.float32)], -1)
    virt[:, 7] = 1.0
    return np.concatenate([real, virt])


# a KITTI-typical camera calibration (P2, R0, Tr_velo_to_cam)
KITTI_P2 = np.array([[721.5, 0., 609.6, 44.9], [0., 721.5, 172.9, 0.2],
                     [0., 0., 1., 0.003]], np.float32)
KITTI_R0 = np.eye(3, dtype=np.float32)
KITTI_V2C = np.array([[7.5e-03, -1.0, -1.8e-04, -4.1e-03],
                      [2.0e-03, 1.9e-04, -1.0, -7.6e-02],
                      [1.0, 7.5e-03, 2.0e-03, -2.7e-01]], np.float32)
# the training replicas' world transforms [rot, flip, scale]
TRAIN_TRANSFORMS = np.array([[0.3, 0.0, 0.98], [0.3, 1.0, 1.02],
                             [0.0, 1.0, 1.0]], np.float32)
VIRTUAL, LIDAR = 1, 2        # indicator column of the fused cloud


def kitti_calib():
    """(v2r (4, 3), p2t (4, 3)) float32 of the KITTI calibration."""
    v2r = np.dot(KITTI_V2C.T, KITTI_R0.T).astype(np.float32)
    return v2r, KITTI_P2.T.astype(np.float32)


def lidar8(scene):
    """The LiDAR stream of the two-stream model: x, y, z, intensity, three
    zero colour channels, indicator 1."""
    n = len(scene['lidar'])
    return np.concatenate([scene['lidar'][:, :4],
                           np.zeros((n, 3), np.float32),
                           np.ones((n, 1), np.float32)], -1)


def _rot_np(xy, angle):
    cosa, sina = np.cos(angle), np.sin(angle)
    x = xy[:, 0] * cosa - xy[:, 1] * sina
    y = xy[:, 0] * sina + xy[:, 1] * cosa
    return np.stack([x, y], -1)


def transform_points_np(points, param):
    """points (N, 3+C); param [rot, flip, scale]."""
    rot, flip, scale = float(param[0]), float(param[1]), float(param[2])
    points = points.copy()
    points[:, 0:2] = _rot_np(points[:, 0:2], rot)
    if flip == 1:
        points[:, 1] = -points[:, 1]
    points[:, 0:3] *= scale
    return points


def transform_boxes_np(boxes, param):
    """boxes (N, 7+); param [rot, flip, scale]."""
    rot, flip, scale = float(param[0]), float(param[1]), float(param[2])
    boxes = boxes.copy()
    boxes[:, 0:2] = _rot_np(boxes[:, 0:2], rot)
    boxes[:, 6] += rot
    if flip == 1:
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, 6] = -boxes[:, 6]
    boxes[:, 0:6] *= scale
    return boxes


def partition(points, num=10, max_dis=60, rate=0.2):
    """Split points into ``num`` distance bins along x, farthest first;
    find the bin below which subsampling is needed to keep ``rate`` of the
    points. Returns (bins, position, points in the far bins)."""
    inter = max_dis / num
    all_num = max(points.shape[0], 1)
    points_list = []
    acc = 0
    position = num - 1
    distant_acc = 0
    for j in range(num):
        i = num - j - 1
        if i == num - 1:
            mask = points[:, 0] >= inter * i
        else:
            mask = (points[:, 0] >= inter * i) & \
                   (points[:, 0] < inter * (i + 1))
        this = points[mask]
        acc += this.shape[0]
        if (acc + i * this.shape[0]) / all_num < rate:
            position = i
            distant_acc = acc
        points_list.append(this)
    return points_list, max(position, 0), distant_acc


def input_point_discard(points, rng, bin_num=2, rate=0.8):
    """Bin-wise stochastic discard of ``rate`` of the points that keeps the
    distant bins whole (StVD); permutations from the ``RandomState``
    ``rng``."""
    retain = 1 - rate
    parts, pos, distant_acc = partition(points, num=bin_num, rate=retain)
    out_num = int(points.shape[0] * retain)
    per_bin = int((out_num - distant_acc) / (pos + 1e-4))
    for i in range(len(parts) - pos, len(parts)):
        if parts[i].shape[0] > per_bin and per_bin >= 0:
            sel = rng.permutation(parts[i].shape[0])[:per_bin]
            parts[i] = parts[i][sel]
    return np.concatenate(parts) if parts else points


def fuse_streams(points, points_mm):
    """One stream: the LiDAR points first, then the kept virtual points,
    with the intensity column divided by 10."""
    final = np.concatenate([points, points_mm])
    final[:, 3] /= 10
    return final
