"""Frames for the depth2points tail's tests (``tests/test_torch_depth2points
.py`` on the CPU, ``tests/test_torch_cuda.py`` on the card): completed
depth maps of a street at the 352 x 1216 crop (a ground plane seen from
1.65 m, ``mini_kitti.street_depth``), the crop, a scan and KITTI's
calibration; and the edge frames: depths at exactly float32 0.1
and 100 m and their neighbours, points with x <= 1e-6 (the sensor 5 m
behind the camera), no pixel in range, one pixel in range, every point
below z = 1 m; virtual clouds with many points to a bin and exactly tied
distances. Imports no JAX."""
import numpy as np

from virconv_tpu_torch.models.depth_completion import virtual_points as vp
from virconv_tpu_torch.utils.calibration import Calibration
from virconv_tpu_torch.utils.mini_kitti import street_depth

CROP = (352, 1216)
OFFSET = (23, 13)          # the crop's (oh, ow) in a 375 x 1242 image
EDGES = ('range_bounds', 'behind', 'none_in_range', 'one_in_range',
         'all_below_z')
# KITTI 2011_09_26's calibration
P2 = np.array([[721.5377, 0., 609.5593, 44.85728],
               [0., 721.5377, 172.854, 0.2163791],
               [0., 0., 1., 0.002745884]], np.float32)
R0 = np.array([[0.9999239, 0.00983776, -0.007445048],
               [-0.009869795, 0.9999421, -0.004278459],
               [0.007402527, 0.004351614, 0.9999631]], np.float32)
V2C = np.array([[7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03],
                [1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02],
                [9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01]],
               np.float32)


def calibration(behind=False):
    """KITTI's calibration; ``behind``: the LiDAR 5 m behind the camera, so
    that points nearer than about 5 m have x <= 0."""
    v2c = V2C.copy()
    if behind:
        v2c[2, 3] += 5.0
    return Calibration({'P2': P2, 'R0': R0, 'Tr_velo2cam': v2c})


def k_matrix(calib):
    oh, ow = OFFSET
    return np.array([[calib.fu, 0, calib.cu - ow],
                     [0, calib.fv, calib.cv - oh], [0, 0, 1]], np.float32)


def frame(rng, kind='street', shape=CROP):
    """(depth, rgb crop, k_mat, calib, scan) of a frame of ``kind``:
    'street' or one of ``EDGES``."""
    h, w = shape
    calib = calibration(behind=kind == 'behind')
    depth = street_depth(rng, h, w, OFFSET[0])
    if kind == 'range_bounds':
        edge = np.array([np.float32(0.1), np.float32(100.0),
                         np.nextafter(np.float32(0.1), np.float32(1)),
                         np.nextafter(np.float32(100.0), np.float32(0)),
                         np.nextafter(np.float32(0.1), np.float32(0)),
                         np.nextafter(np.float32(100.0), np.float32(200))],
                        np.float32)
        pick = rng.uniform(size=depth.shape) < 0.2
        depth[pick] = edge[rng.integers(0, len(edge), int(pick.sum()))]
    elif kind == 'behind':
        depth = rng.uniform(0.2, 12, depth.shape).astype(np.float32)
    elif kind == 'none_in_range':
        depth = np.where(depth > 50, np.float32(120), np.float32(0))
    elif kind == 'one_in_range':   # np.dot's one-row path (sgemv)
        depth = np.zeros_like(depth)
        depth[rng.integers(0, h), rng.integers(0, w)] = rng.uniform(0.2, 99)
    elif kind == 'all_below_z':
        depth = rng.uniform(0.5, 2.0, depth.shape).astype(np.float32)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    scan = rng.uniform(-40, 40, (3000, 4)).astype(np.float32)
    scan[:, 3] = rng.uniform(0, 1, 3000)
    return depth.astype(np.float32), rgb, k_matrix(calib), calib, scan


def cloud(rng, kind, n=30000):
    """Virtual rows (n, 8) float32 of ``kind``: 'spread' (a street's range
    of angles, about 5 points a bin), 'dense' (a few hundred bins) or
    'ties' (each point four times, exactly: ties in r in every bin, the
    copies told apart by their colour)."""
    pts = np.zeros((n, 8), np.float32)
    if kind == 'dense':
        pts[:, 0] = rng.uniform(20, 20.2, n)
        pts[:, 1] = rng.uniform(-0.2, 0.2, n)
        pts[:, 2] = rng.uniform(-1.8, -1.7, n)
    else:
        pts[:, 0] = rng.uniform(2, 70, n)
        pts[:, 1] = rng.uniform(-25, 25, n)
        pts[:, 2] = rng.uniform(-3, 1, n)
    if kind == 'ties':
        pts[:, :3] = np.repeat(pts[:n // 4, :3], 4, axis=0)[rng.permutation(n)]
    pts[:, 4] = np.arange(n) % 251
    pts[:, 5] = np.arange(n) // 251
    pts[:, 7] = 1
    return pts


def hard_angles(rng, res, n, lo=-np.pi / 2, hi=np.pi):
    """float32 angles (n,) in [lo, hi] to bin by ``res``: uniform,
    multiples of ``res`` (as float32) and their two neighbours, +-0."""
    b = np.float32(res)
    k = rng.integers(int(lo / res) + 1, int(hi / res), n // 4)
    on = k.astype(np.float32) * b
    return np.concatenate([
        rng.uniform(lo, hi, n // 4).astype(np.float32), on,
        np.nextafter(on, np.float32(np.inf)),
        np.nextafter(on, np.float32(-np.inf)),
        np.array([0.0, -0.0], np.float32)])


def numpy_cloud(depth, rgb, k_mat, calib, scan):
    """The fused cloud numpy makes of the frame (``frame_points`` on the
    host depth)."""
    return vp.frame_points(depth, rgb, k_mat, calib, scan)
