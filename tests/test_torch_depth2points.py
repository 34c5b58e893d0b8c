"""The depth2points tail's plain versions (``ops/depth2points.py``) against
numpy's tail (``models/depth_completion/depth2points.py``), on the CPU:

* the sequential float32 fma chain (``fma_chain_plain``: float64 product
  plus sum, rounded to odd, then to float32) is this host's ``np.dot`` of
  (N, 4) by (4, 4) for 2 to 500 000 rows, signed zeros included, and
  ``gemv_plain`` its ``np.dot`` of one row (``host_order_holds``);
* ``keep_nearest_plain`` (the least packed (bits of r, row) per bin, in
  bin order) keeps ``la_sampling2``'s rows, in its order, on clouds with
  many points to a bin and exactly tied distances;
* ``bins`` is the arithmetic ``la_sampling2`` had inline (whose bits the
  JAX package holds, ``tests/test_torch_virtual_points.py``),
  ``floor_divide_plain``, the kernel's float32 ``//``, is numpy's, and
  ``table_box`` spans every bin of the angles it is given;
* ``virtual_cloud`` on CPU tensors, the whole card-side tail on its plain
  versions, gives numpy's fused cloud bit for bit on street frames at the
  352 x 1216 crop and on the edge frames of ``depth2points_cases``, and
  counts every frame when threads call it at once."""
import sys
import threading

import numpy as np
import pytest
import torch

import depth2points_cases as cases
from virconv_tpu_torch.models.depth_completion import depth2points as td
from virconv_tpu_torch.models.depth_completion import virtual_points as vp
from virconv_tpu_torch.ops import depth2points as d2p

torch.set_num_threads(2)


def bits(a):
    a = np.ascontiguousarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


@pytest.mark.parametrize('rows', [2, 3, 17, 1000, 4097, 65537, 500000])
def test_fma_chain_is_np_dot(rows):
    rng = np.random.default_rng(rows)
    m = cases.calibration().rect_to_lidar_matrix()
    z = rng.uniform(0.1, 100, rows).astype(np.float32)
    a = np.stack([((rng.integers(0, 1216, rows) - np.float32(600.3)) * z
                   / np.float32(721.5)).astype(np.float32),
                  ((rng.integers(0, 352, rows) - np.float32(170.2)) * z
                   / np.float32(721.5)).astype(np.float32),
                  z, np.ones(rows, np.float32)], 1)
    got = d2p.fma_chain_plain(torch.from_numpy(a), torch.from_numpy(m))
    np.testing.assert_array_equal(bits(got.numpy()), bits(np.dot(a, m)))


def test_fma_chain_is_np_dot_on_signed_zeros():
    """Products of +-0 summing to zero: np.dot starts its sums from +0."""
    rng = np.random.default_rng(5)
    vals = np.array([-1.5, -0.0, 0.0, 1.0, 2.5], np.float32)
    for _ in range(20):
        m = vals[rng.integers(0, len(vals), (4, 4))]
        a = vals[rng.integers(0, len(vals), (4000, 4))]
        got = d2p.fma_chain_plain(torch.from_numpy(a), torch.from_numpy(m))
        np.testing.assert_array_equal(bits(got.numpy()), bits(np.dot(a, m)))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_gemv_plain_is_np_dot_of_one_row(seed):
    """np.dot of a (1, 4) row by (4, 4) (OpenBLAS's sgemv), row by row, on
    the crop's matrix and on random ones, with signed zeros."""
    rng = np.random.default_rng(seed)
    vals = np.array([-1.5, -0.0, 0.0, 1.0, 2.5], np.float32)
    mats = [cases.calibration().rect_to_lidar_matrix(),
            rng.normal(0, 1, (4, 4)).astype(np.float32),
            vals[rng.integers(0, len(vals), (4, 4))]]
    for m in mats:
        a = np.stack([rng.uniform(-40, 40, 600), rng.uniform(-3, 2, 600),
                      rng.uniform(0.1, 100, 600), np.ones(600)],
                     1).astype(np.float32)
        a[:200] = vals[rng.integers(0, len(vals), (200, 4))]
        want = np.concatenate([np.dot(row[None], m) for row in a])
        got = d2p.gemv_plain(torch.from_numpy(a), torch.from_numpy(m))
        np.testing.assert_array_equal(bits(got.numpy()), bits(want))


def test_host_order_holds():
    assert d2p.host_order_holds()


@pytest.mark.parametrize('kind', ['spread', 'dense', 'ties'])
def test_keep_nearest_plain_is_la_sampling2(kind):
    rng = np.random.default_rng(len(kind))
    pts = cases.cloud(rng, kind)
    r = np.clip(np.linalg.norm(pts[:, :3], axis=-1), 1e-6, None)
    vert, hor = d2p.bins(np.clip(pts[:, 2] / r, -1, 1),
                         pts[:, 1] / np.clip(pts[:, 0], 1e-6, None),
                         0.0025, 0.0015)
    assert len(np.unique(vert * 1_000_003 + hor)) < len(pts)
    v0, h0 = vert.min(), hor.min()
    width = int(hor.max() - h0 + 1)
    slot = ((vert - v0) * width + (hor - h0)).astype(np.int32)
    rows = d2p.keep_nearest_plain(torch.from_numpy(r),
                                  torch.from_numpy(slot),
                                  int(vert.max() - v0 + 1) * width)
    kept = pts[rows.numpy()]
    np.testing.assert_array_equal(bits(kept), bits(td.la_sampling2(pts)))


@pytest.mark.parametrize('res', [0.0025, 0.0015])
def test_floor_divide_plain_is_numpy_s(res):
    """numpy's float32 ``//`` as the kernel makes it, on the angles'
    range, on multiples of the resolution and their neighbours, and on
    signed zeros."""
    b = np.float32(res)
    a = cases.hard_angles(np.random.default_rng(int(res * 1e4)), res,
                          200000)
    got = d2p.floor_divide_plain(torch.from_numpy(a), res).numpy()
    np.testing.assert_array_equal(bits(got), bits(a // b))


@pytest.mark.parametrize('kind', ['street', 'hard', 'extremes'])
def test_table_spans_every_bin(kind):
    """``table_box`` of a street frame's angles, of angles on bin edges
    and of the extreme angles (arccos of +-1, arctan of +-inf) holds every
    bin with one to spare on each side."""
    rng = np.random.default_rng(8)
    if kind == 'street':
        pts = cases.cloud(rng, 'spread')
        r = np.clip(np.linalg.norm(pts[:, :3], axis=-1), 1e-6, None)
        theta, fan = d2p.angles(np.clip(pts[:, 2] / r, -1, 1),
                                pts[:, 1] / np.clip(pts[:, 0], 1e-6, None))
    elif kind == 'hard':
        theta = cases.hard_angles(rng, 0.0025, 40000, 0, np.pi)
        fan = cases.hard_angles(rng, 0.0015, 40000, -np.pi / 2, np.pi / 2)
    else:
        theta = np.arccos(np.array([-1, 1], np.float32))
        fan = np.arctan(np.array([-np.inf, np.inf, -1e30, 1e30], np.float32))
    v_lo, v_rows, h_lo, h_cols = d2p.table_box(theta, fan, 0.0025, 0.0015)
    vert = theta // np.float32(0.0025)
    hor = fan // np.float32(0.0015)
    assert vert.min() > v_lo and vert.max() < v_lo + v_rows - 1
    assert hor.min() > h_lo and hor.max() < h_lo + h_cols - 1
    assert v_rows * h_cols <= d2p.MAX_TABLE


def test_bins_are_la_sampling2_s_arithmetic():
    pts = cases.cloud(np.random.default_rng(9), 'spread')
    r = np.clip(np.linalg.norm(pts[:, 0:3], axis=-1), 1e-6, None)
    theta = np.arccos(np.clip(pts[:, 2] / r, -1, 1))
    fan = np.arctan(pts[:, 1] / np.clip(pts[:, 0], 1e-6, None))
    vert, hor = d2p.bins(np.clip(pts[:, 2] / r, -1, 1),
                         pts[:, 1] / np.clip(pts[:, 0], 1e-6, None),
                         0.0025, 0.0015)
    np.testing.assert_array_equal(vert, (theta // 0.0025).astype(np.int64))
    np.testing.assert_array_equal(hor, (fan // 0.0015).astype(np.int64))


@pytest.mark.parametrize('kind', ['street', 'behind', 'one_in_range',
                                  'one_in_range', 'one_in_range'])
def test_project_plain_is_numpy_s_rows(kind, request):
    """``project_plain``'s kept rows, pixels and float32 r, c and q are
    numpy's (``depth_to_points_rgb``, the z cut, ``la_sampling2``'s
    arithmetic), bit for bit: a frame with one pixel in range takes np.dot's
    one-row order."""
    seed = 20 + request.node.callspec.indices['kind']
    depth, rgb, k_mat, calib, _ = cases.frame(np.random.default_rng(seed),
                                              kind)
    calib_c = vp.crop_calibration(k_mat, calib)
    pts = td.depth_to_points_rgb(depth, rgb, calib_c)
    v, u = np.nonzero((depth > 0.1) & (depth < 100.0))
    kept = pts[:, 2] < 1.0
    pts, pix = pts[kept], (v * depth.shape[1] + u)[kept]
    r = np.clip(np.linalg.norm(pts[:, 0:3], axis=-1), 1e-6, None)
    head, got_pix, got_r = d2p.project_plain(torch.from_numpy(depth),
                                             d2p.camera_params(calib_c))
    n, hw = int(head[0]), depth.size
    cq = head[d2p.HEAD:].view(torch.float32).numpy()
    assert n == len(pts)
    np.testing.assert_array_equal(got_pix[:n].numpy(), pix)
    np.testing.assert_array_equal(bits(got_r[:n].numpy()), bits(r))
    np.testing.assert_array_equal(bits(cq[:n]),
                                  bits(np.clip(pts[:, 2] / r, -1, 1)))
    np.testing.assert_array_equal(
        bits(cq[hw:hw + n]),
        bits(pts[:, 1] / np.clip(pts[:, 0], 1e-6, None)))


@pytest.mark.parametrize('kind', ['street', 'street', *cases.EDGES,
                                  'one_in_range', 'one_in_range'])
def test_virtual_cloud_plain_is_numpy_s_tail(kind, request):
    seed = request.node.callspec.indices['kind']
    depth, rgb, k_mat, calib, scan = cases.frame(np.random.default_rng(seed),
                                                 kind)
    want = cases.numpy_cloud(depth, rgb, k_mat, calib, scan)
    before = d2p.counts['plain']
    rows, n_in = d2p.virtual_cloud(
        torch.from_numpy(depth), torch.from_numpy(rgb),
        d2p.camera_params(vp.crop_calibration(k_mat, calib)))
    assert d2p.counts['plain'] == before + 1
    got = np.concatenate([td.lidar_rows(scan).astype(np.float16), rows])
    assert n_in == int(((depth > np.float32(0.1))
                        & (depth < np.float32(100))).sum())
    assert got.shape == want.shape
    np.testing.assert_array_equal(bits(got), bits(want))
    if kind == 'none_in_range':
        assert len(rows) == 0
    if kind == 'all_below_z':
        assert len(rows) > 1000


def test_counts_lose_no_frame_across_threads():
    """``counts`` from 12 threads at once, the interpreter switching
    threads every microsecond: every frame counted."""
    depth, rgb, k_mat, calib, _ = cases.frame(np.random.default_rng(4),
                                              'street', (24, 64))
    args = (torch.from_numpy(depth), torch.from_numpy(rgb),
            d2p.camera_params(vp.crop_calibration(k_mat, calib)))
    before = d2p.counts['plain']
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            d2p.virtual_cloud(*args) for _ in range(4)]) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert d2p.counts['plain'] == before + 48
