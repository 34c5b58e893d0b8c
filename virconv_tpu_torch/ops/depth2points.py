"""PENet's depth2points tail on the card: the wrappers of
``csrc/depth2points.cu``, their plain PyTorch versions, and
``virtual_cloud``, one frame's thinned virtual points from its completed
depth.

The contract is numpy's: ``models/depth_completion/depth2points.py``
(``depth_to_points_rgb``, the z cut of ``fuse_virtual_and_lidar``,
``la_sampling2``) on the same depth gives the same float16 rows, bit for
bit. The JAX package has no kernel here (its tail is that numpy code).

``virtual_cloud`` runs, on the current stream:

1. ``project``: the pixels in (0.1, 100) m back-projected to the LiDAR
   frame (the 4 x 4 product in np.dot's order: OpenBLAS's sgemm for two
   or more rows, its sgemv for one; ``host_order_holds``), those below
   z = 1 m kept in pixel order, and each kept row's r,
   c = clip(z / r, -1, 1) and q = y / max(x, 1e-6); the counts, c and q
   to the host in one copy;
2. on the host, numpy's ``arccos(c)`` and ``arctan(q)`` (``angles``, which
   ``la_sampling2`` calls too: a device transcendental one ulp off would
   move points across bins), back to the card without a sync;
3. ``thin``: each row's bins, floored as numpy's float32 ``//`` does, its
   bin a slot of a dense (vert, hor) table over the frame's bins
   (``table_box``, from the extreme angles), the nearest row of each
   occupied slot in slot order, and those rows as float16 [x, y, z, 0,
   r/3, g/3, b/3, 1] behind their count, to the host in one copy.

CUDA tensors take the kernels, CPU tensors the plain versions (``*_plain``,
float32 elementwise like numpy; the 4 x 4 product as ``fma_chain_plain``
or, for one row, ``gemv_plain``).
"""

from __future__ import annotations

import collections
import functools
import threading

import numpy as np
import torch

THREADS = 256              # csrc/depth2points.cu's kThreads
HEAD = 4                   # csrc/depth2points.cu's kHead: counts ahead
MAX_TABLE = 16777216       # csrc/depth2points.cu's kMaxTable: table slots
EMPTY = torch.iinfo(torch.int64).max   # the plain table's free slot

# kernel launches (calls of the library, CUDA tensors only), and the
# frames whose rows ``virtual_cloud`` made on the kernels ('kernel') or on
# the plain versions ('plain'), counted under one lock (the generator's
# worker threads call in at once); reset and read by chip_smoke.py and the
# tests
launches = 0
counts = collections.Counter()
_counted = threading.Lock()


def _launched():
    global launches
    with _counted:
        launches += 1


def angles(c, q):
    """``la_sampling2``'s polar angle and azimuth of rows with polar cosine
    ``c`` and azimuth tangent ``q`` (contiguous float32 arrays): numpy's
    arccos and arctan."""
    return np.arccos(c), np.arctan(q)


def bins(c, q, vert_res, hor_res):
    """``la_sampling2``'s bins (vert, hor) int64: ``angles`` floored by
    the resolutions."""
    theta, fan = angles(c, q)
    return ((theta // vert_res).astype(np.int64),
            (fan // hor_res).astype(np.int64))


def table_box(theta, fan, vert_res, hor_res):
    """(v_lo, v_rows, h_lo, h_cols): a dense table over the bins of the
    angles ``theta`` and ``fan`` (non-empty float32 arrays) by the
    resolutions, from the extremes floored as numpy's float32 ``//`` does,
    one bin to spare on each side."""
    vr, hr = np.float32(vert_res), np.float32(hor_res)
    v_lo, v_hi = int(theta.min() // vr) - 1, int(theta.max() // vr) + 1
    h_lo, h_hi = int(fan.min() // hr) - 1, int(fan.max() // hr) + 1
    return v_lo, v_hi - v_lo + 1, h_lo, h_hi - h_lo + 1


def camera_params(calib):
    """The crop's camera as the kernel takes it: cu, cv, fu, fv, tx, ty,
    then ``rect_to_lidar``'s 4 x 4 matrix row-major, float32 (22,)."""
    head = np.array([calib.cu, calib.cv, calib.fu, calib.fv, calib.tx,
                     calib.ty], np.float32)
    return np.concatenate([head, calib.rect_to_lidar_matrix().ravel()
                           .astype(np.float32)])


# ---- plain versions ----------------------------------------------------

def fma_plain(a, b, c):
    """float32 fma(a, b, c) by float64: the product is exact there, the sum
    rounded to odd, then to float32 (one rounding in all)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, torch.copysign(torch.full_like(s, torch.inf),
                                             err))
    return torch.where((err != 0) & even, away, s).float()


def fma_chain_plain(a, m):
    """(N, 4) x (4, 4) float32 as OpenBLAS's sgemm makes a row: acc = +0,
    then acc = fma(a[:, k], m[k], acc) for k = 0..3."""
    acc = torch.zeros((a.shape[0], m.shape[1]), dtype=torch.float32)
    for k in range(4):
        acc = fma_plain(a[:, k:k + 1], m[k][None], acc)
    return acc


def gemv_plain(a, m):
    """Each row of (N, 4) x (4, 4) float32 as OpenBLAS's sgemv makes the
    product of one row (np.dot's path for a (1, 4) operand): the even and
    the odd k each an fma chain from its first product, their sum added to
    y = +0."""
    even = fma_plain(a[:, 2:3], m[2][None], a[:, 0:1] * m[0][None])
    odd = fma_plain(a[:, 3:4], m[3][None], a[:, 1:2] * m[1][None])
    return (even + odd) + 0.0


@functools.cache
def host_order_holds(rows=4096):
    """Whether this host's np.dot of (N, 4) by (4, 4) float32 is
    ``fma_chain_plain`` (N = ``rows``) and, row by row, ``gemv_plain``
    (N = 1), on seeded KITTI-like rows and a random matrix: the kernels
    follow those orders, so numpy on a host whose BLAS sums otherwise would
    make other bits."""
    rng = np.random.default_rng(0)
    a = np.stack([rng.uniform(-60, 60, rows), rng.uniform(-3, 20, rows),
                  rng.uniform(0.1, 100, rows), np.ones(rows)],
                 1).astype(np.float32)
    m = rng.normal(0, 1, (4, 4)).astype(np.float32)
    ta, tm = torch.from_numpy(a), torch.from_numpy(m)
    one = np.concatenate([np.dot(row[None], m) for row in a[:256]])
    return (np.array_equal(fma_chain_plain(ta, tm).numpy().view(np.uint32),
                           np.dot(a, m).view(np.uint32))
            and np.array_equal(gemv_plain(ta[:256], tm).numpy()
                               .view(np.uint32), one.view(np.uint32)))


def floor_divide_plain(a, b):
    """numpy's float32 ``a // b`` (``npy_divmod``) for b > 0: fmod, the
    quotient of the difference, its floor snapped to the nearest integer."""
    b = _f32(b, a)
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    div = torch.where((mod != 0) & ((b < 0) != (mod < 0)), div - 1, div)
    floor = torch.floor(div)
    floor = torch.where(div - floor > 0.5, floor + 1, floor)
    return torch.where(div != 0, floor, torch.copysign(torch.zeros_like(a),
                                                       a / b))


def _f32(x, like):
    return torch.full_like(like, float(np.float32(x)))


def back_project_plain(depth, camera, pix, one_row=False):
    """The LiDAR points (N, 3) of pixels ``pix`` (N,) of ``depth`` (H, W):
    ``img_to_rect`` then ``rect_to_lidar``, float32 operation by operation
    (the product in the sgemv order where the frame had ``one_row`` pixel
    in range)."""
    w = depth.shape[1]
    pix = pix.long()
    d = depth.reshape(-1)[pix]
    u, v = (pix % w).float(), (pix // w).float()
    cu, cv, fu, fv, tx, ty = (_f32(x, d) for x in camera[:6])
    x = ((u - cu) * d) / fu + tx
    y = ((v - cv) * d) / fv + ty
    hom = torch.stack([x, y, d, torch.ones_like(d)], 1)
    m = torch.from_numpy(np.asarray(camera[6:], np.float32).reshape(4, 4))
    return (gemv_plain if one_row else fma_chain_plain)(hom, m)[:, :3]


def project_plain(depth, camera):
    """Plain version of ``project`` (the same arguments and results)."""
    flat = depth.reshape(-1)
    hw = flat.numel()
    inr = (flat > _f32(0.1, flat)) & (flat < _f32(100.0, flat))
    pix = torch.nonzero(inr).squeeze(1)
    xyz = back_project_plain(depth, camera, pix, len(pix) == 1)
    keep = xyz[:, 2] < _f32(1.0, xyz[:, 2])
    pix, xyz = pix[keep], xyz[keep]
    x, y, z = xyz.unbind(1)
    # a float32 square root correctly rounded (torch's CPU sqrt is not, in
    # its vector lanes): the float64 root rounds to the same float32
    r = torch.sqrt(((x * x + y * y) + z * z).double()).float()
    r = torch.maximum(r, _f32(1e-6, r))
    n = len(pix)
    head = torch.zeros(HEAD + 2 * hw, dtype=torch.int32)
    head[:2] = torch.tensor([n, int(inr.sum())])
    cq = head[HEAD:].view(torch.float32)
    cq[:n] = torch.clamp(z / r, -1.0, 1.0)
    cq[hw:hw + n] = y / torch.maximum(x, _f32(1e-6, x))
    out_pix = torch.zeros(hw, dtype=torch.int32)
    out_r = torch.zeros(hw, dtype=torch.float32)
    out_pix[:n], out_r[:n] = pix.int(), r
    return head, out_pix, out_r


def keep_nearest_plain(r, slot, t):
    """The nearest of the rows that share a slot of a ``t``-slot table: per
    slot the least (bits of r) << 32 | row, by ``scatter_reduce``. Returns
    the winning rows (K,) int64 in slot order."""
    key = (r.view(torch.int32).long() << 32) | torch.arange(r.numel())
    table = torch.full((t,), EMPTY, dtype=torch.int64)
    table.scatter_reduce_(0, slot.long(), key, 'amin')
    return table[table != EMPTY] & 0xffffffff


def cloud_rows_plain(depth, rgb, camera, pix, one_row=False):
    """The float16 rows (K, 8) [x, y, z, 0, r/3, g/3, b/3, 1] of pixels
    ``pix`` (K,)."""
    k = len(pix)
    xyz = back_project_plain(depth, camera, pix, one_row)
    col = rgb.reshape(-1, 3)[pix.long()].float()
    col = col / _f32(3.0, col)
    return torch.cat([xyz, torch.zeros((k, 1)), col, torch.ones((k, 1))],
                     1).half()


def thin_plain(depth, rgb, camera, pix, r, theta_fan, vert_res, hor_res,
               box, one_row=False):
    """Plain version of ``thin`` (the same arguments and results)."""
    n = r.numel()
    v_lo, v_rows, h_lo, h_cols = box
    vert = floor_divide_plain(theta_fan[:n], vert_res).long() - v_lo
    hor = floor_divide_plain(theta_fan[n:], hor_res).long() - h_lo
    inside = (vert >= 0) & (vert < v_rows) & (hor >= 0) & (hor < h_cols)
    rows = keep_nearest_plain(r[inside], (vert * h_cols + hor)[inside],
                              v_rows * h_cols)
    rows = torch.nonzero(inside).squeeze(1)[rows]
    out = torch.zeros(HEAD + 4 * n, dtype=torch.int32)
    out[0], out[1] = len(rows), int(not bool(inside.all()))
    out[HEAD:HEAD + 4 * len(rows)] = cloud_rows_plain(
        depth, rgb, camera, pix[rows], one_row).view(torch.int32).reshape(-1)
    return out


# ---- the kernels ---------------------------------------------------------

def _blocks(n):
    return max(1, -(-n // THREADS))


def project(depth, camera):
    """Back-project ``depth`` (H, W) float32 through ``camera``
    (``camera_params``) and keep the points below z = 1 m in pixel order.
    Returns (head, pix, r): ``head`` (HEAD + 2 H W,) int32 = [N kept rows,
    pixels in range, 0, 0], then the N rows' c as float32 from ``HEAD`` and
    their q from ``HEAD + H W``; the first N of ``pix`` (H W,) int32 and
    ``r`` (H W,) float32 the kept rows' pixels and distances. CUDA tensors
    launch the kernel, CPU tensors take ``project_plain``."""
    if not depth.is_cuda:
        return project_plain(depth, camera)
    from . import _cuda
    dev = depth.device
    _cuda.check_cuda_tensor(depth, 'depth', torch.float32, 2, dev)
    h, w = depth.shape
    hw = h * w
    nb = _blocks(hw)
    ws = torch.empty(3 * nb + HEAD + 4 * hw, dtype=torch.int32, device=dev)
    head = ws[3 * nb:3 * nb + HEAD + 2 * hw]
    pix = ws[3 * nb + HEAD + 2 * hw:3 * nb + HEAD + 3 * hw]
    r = ws[3 * nb + HEAD + 3 * hw:].view(torch.float32)
    cam = np.ascontiguousarray(camera, np.float32)
    err = _cuda.load('depth2points').d2p_project(
        _cuda.ptr(depth), h, w, cam.ctypes.data, _cuda.ptr(ws),
        _cuda.ptr(head), _cuda.ptr(pix), _cuda.ptr(r), _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'd2p_project launch failed: CUDA error {err}')
    _launched()
    return head, pix, r


def thin(depth, rgb, camera, pix, r, theta_fan, vert_res, hor_res, box,
         one_row=False):
    """la_sampling2 on the card: the N rows of ``pix`` and ``r``
    (``project``'s first N) with ``theta_fan`` (2 N,) float32, their
    ``angles``, binned by the resolutions (numpy's float32 ``//``) into
    the table ``box`` (``table_box`` of the angles), the nearest row of
    each bin kept (the lower row on a tie in r), in bin order, as float16
    rows [x, y, z, 0, r/3, g/3, b/3, 1] of ``depth`` and ``rgb`` (H, W, 3)
    uint8 (back-projected in the sgemv order with ``one_row``, the frame's
    one pixel in range). Returns ``out`` (HEAD + 4 N,) int32 = [K rows, 1
    if a bin fell outside the table else 0, 0, 0], then the K rows'
    float16 bits. CUDA tensors launch the kernel, CPU tensors take
    ``thin_plain``."""
    v_lo, v_rows, h_lo, h_cols = box
    t = v_rows * h_cols
    if t > MAX_TABLE:
        raise ValueError(f'thin: a table of {t} slots, past MAX_TABLE = '
                         f'{MAX_TABLE}')
    if not depth.is_cuda:
        return thin_plain(depth, rgb, camera, pix, r, theta_fan, vert_res,
                          hor_res, box, one_row)
    from . import _cuda
    dev = depth.device
    h, w = depth.shape
    n = r.numel()
    _cuda.check_cuda_tensor(depth, 'depth', torch.float32, 2, dev)
    _cuda.check_cuda_tensor(rgb, 'rgb', torch.uint8, 3, dev)
    if tuple(rgb.shape) != (h, w, 3):
        raise ValueError(f'thin: rgb {tuple(rgb.shape)} against depth '
                         f'{(h, w)}')
    _cuda.check_cuda_tensor(pix, 'pix', torch.int32, 1, dev)
    for name, x in (('r', r), ('theta_fan', theta_fan)):
        _cuda.check_cuda_tensor(x, name, torch.float32, 1, dev)
    if not 1 <= n <= pix.numel() or theta_fan.numel() != 2 * n:
        raise ValueError(f'thin: {n} rows, {pix.numel()} pixels, '
                         f'{theta_fan.numel()} angles')
    table = torch.empty(t, dtype=torch.int64, device=dev)
    scratch = torch.empty(2 * _blocks(t) + n, dtype=torch.int32, device=dev)
    out = torch.empty(HEAD + 4 * n, dtype=torch.int32, device=dev)
    cam = np.ascontiguousarray(camera, np.float32)
    err = _cuda.load('depth2points').d2p_thin(
        _cuda.ptr(depth), _cuda.ptr(rgb), h, w, cam.ctypes.data,
        _cuda.ptr(pix), _cuda.ptr(r), _cuda.ptr(theta_fan), n,
        float(np.float32(vert_res)), float(np.float32(hor_res)), v_lo,
        v_rows, h_lo, h_cols, int(one_row), _cuda.ptr(table),
        _cuda.ptr(scratch), _cuda.ptr(out), _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'd2p_thin launch failed: CUDA error {err}')
    _launched()
    return out


def virtual_cloud(depth, rgb, camera, vert_res=0.0025, hor_res=0.0015):
    """The thinned virtual points of one frame: ``depth`` (H, W) float32
    and ``rgb`` (H, W, 3) uint8 on one device, ``camera`` the crop's
    (``camera_params``). Returns (rows (K, 8) float16 numpy in
    la_sampling2's order, the pixels in range). Two host syncs: the counts
    with c and q, the rows with their count; the angles go back from
    pinned memory without one. Raises where this host's np.dot takes
    another order than the kernels (``host_order_holds``)."""
    if not host_order_holds():
        raise RuntimeError('depth2points: this host\'s np.dot of (N, 4) by '
                           '(4, 4) sums in another order than the kernels')
    hw = depth.numel()
    head, pix, r = project(depth, camera)
    head = head.cpu().numpy()
    n, n_in = int(head[0]), int(head[1])
    with _counted:
        counts['kernel' if depth.is_cuda else 'plain'] += 1
    if n == 0:
        return np.zeros((0, 8), np.float16), n_in
    cq = head[HEAD:].view(np.float32)
    theta_fan = torch.empty(2 * n, dtype=torch.float32,
                            pin_memory=depth.is_cuda)
    theta, fan = angles(cq[:n], cq[hw:hw + n])
    np.concatenate([theta, fan], out=theta_fan.numpy())
    out = thin(depth, rgb, camera, pix, r[:n],
               theta_fan.to(depth.device, non_blocking=True), vert_res,
               hor_res, table_box(theta, fan, vert_res, hor_res),
               n_in == 1).cpu().numpy()
    if out[1]:
        raise RuntimeError('depth2points: a bin outside the table')
    k = int(out[0])
    return out[HEAD:HEAD + 4 * k].view(np.float16).reshape(k, 8), n_in
