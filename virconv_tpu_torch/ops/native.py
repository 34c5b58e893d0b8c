"""ctypes bindings for the native host box ops (``csrc/box_ops.cpp``).

The port's counterpart of ``virconv_tpu/ops/native.py``. The C++ source is
the port's own copy; ``g++`` builds it at first use into
``virconv_tpu_torch/_build/`` (listed in ``.gitignore``), under a name
that carries a digest of the source, the flags and the host CPU's
features, so an edit or another machine builds anew. The flags are those
of the root ``csrc/Makefile``, so both libraries compute the same bits.

Every entry point falls back to ``ops/boxes_np`` (with one warning on
stderr) when no compiler is at hand. WBF clustering and the KITTI AP
metric call these on the host. ``build('png')`` builds the PNG row
unfilter of ``utils/png.py`` (``csrc/png.cpp``) the same way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

from . import boxes_np
from ._cuda import BUILD, CSRC

CXX_FLAGS = ['-O3', '-march=native', '-fPIC', '-std=c++17', '-Wall',
             '-shared']
_LIB = None
_TRIED = False
_LOCK = threading.Lock()


def _machine_tag():
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith('flags'):
                    return line.encode()
    except OSError:
        pass
    import platform
    return platform.processor().encode()


def _target(name='box_ops'):
    src = CSRC / f'{name}.cpp'
    h = hashlib.sha1(' '.join(CXX_FLAGS).encode() + b'\0' + _machine_tag()
                     + b'\0' + src.read_bytes())
    return src, BUILD / f'lib{name}_{h.hexdigest()[:12]}.so'


def build(name='box_ops'):
    """Compile the host library of ``csrc/<name>.cpp`` (the box ops by
    default, ``png`` for the image reader) if it is not built yet; returns
    its path."""
    src, out = _target(name)
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cxx = os.environ.get('CXX', 'g++')
        proc = subprocess.run([cxx, *CXX_FLAGS, '-o', str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'{cxx} failed for {out.name}:\n'
                               f'{proc.stdout}{proc.stderr}')
        os.replace(tmp, out)
    return out


def _bind(lib):
    f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
    f64p = np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS')
    i64p = np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS')
    i32p = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
    i64, i32, f64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_double
    for name in ('boxes_overlap_bev', 'boxes_iou_bev', 'boxes_iou3d'):
        fn = getattr(lib, name)
        fn.argtypes = [f32p, i64, f32p, i64, f64p]
        fn.restype = None
    lib.nms_bev.argtypes = [f32p, f32p, i64, f64, i64, i64p]
    lib.nms_bev.restype = i64
    lib.points_in_boxes.argtypes = [f32p, i64, f32p, i64, i32p]
    lib.points_in_boxes.restype = None
    lib.kitti_compute_statistics.argtypes = [
        f64p, i64, i64, f64p, f64p, f64p, i64p, i64p, f64p, i64, i32, f64,
        f64, i32, i32, f64p, f64p]
    lib.kitti_compute_statistics.restype = i64
    lib.kitti_eval_image_pr.argtypes = [
        f64p, i64, i64, f64p, f64p, f64p, i64p, i64p, f64p, i64, i32, f64,
        f64p, i64, i32, f64p]
    lib.kitti_eval_image_pr.restype = None
    return lib


def _load():
    """The loaded library, or None (after one warning) when it cannot be
    built here."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is None and not _TRIED:
            _TRIED = True
            try:
                _LIB = _bind(ctypes.CDLL(str(build())))
            except (OSError, RuntimeError) as e:
                print(f'[virconv_tpu_torch.ops.native] box_ops build '
                      f'FAILED ({e}); host IoU, NMS and the KITTI eval fall '
                      'back to the slow numpy path', file=sys.stderr)
        return _LIB


def available() -> bool:
    return _load() is not None


def _pair_call(name, boxes_a, boxes_b):
    a = np.ascontiguousarray(boxes_a[:, :7], np.float32)
    b = np.ascontiguousarray(boxes_b[:, :7], np.float32)
    out = np.empty((len(a), len(b)), np.float64)
    getattr(_LIB, name)(a, len(a), b, len(b), out)
    return out


def boxes_overlap_bev(boxes_a, boxes_b):
    if _load() is None:
        return boxes_np.boxes_overlap_bev(boxes_a, boxes_b)
    return _pair_call('boxes_overlap_bev', boxes_a, boxes_b)


def boxes_iou_bev(boxes_a, boxes_b):
    if _load() is None:
        return boxes_np.boxes_iou_bev(boxes_a, boxes_b)
    return _pair_call('boxes_iou_bev', boxes_a, boxes_b)


def boxes_iou3d(boxes_a, boxes_b):
    if _load() is None:
        return boxes_np.boxes_iou3d(boxes_a, boxes_b)
    return _pair_call('boxes_iou3d', boxes_a, boxes_b)


def nms_bev(boxes, scores, thresh, pre_max=None, post_max=None):
    if _load() is None:
        return boxes_np.nms_bev(boxes, scores, thresh, pre_max, post_max)
    order = np.argsort(-scores)
    if pre_max is not None:
        order = order[:pre_max]
    b = np.ascontiguousarray(boxes[order][:, :7], np.float32)
    s = np.ascontiguousarray(scores[order], np.float32)
    keep = np.empty(len(b), np.int64)
    post = post_max if post_max is not None else len(b)
    cnt = _LIB.nms_bev(b, s, len(b), float(thresh), post, keep)
    return order[keep[:cnt]]


def points_in_boxes(points, boxes):
    if _load() is None:
        return boxes_np.points_in_boxes(points, boxes)
    p = np.ascontiguousarray(points[:, :3], np.float32)
    b = np.ascontiguousarray(boxes[:, :7], np.float32)
    out = np.empty(len(p), np.int32)
    _LIB.points_in_boxes(p, len(p), b, len(b), out)
    return out


def kitti_eval_image_pr(overlaps, dt_scores, dt_alphas, gt_alphas,
                        ignored_gt, ignored_det, dt_dc_overlap, metric,
                        min_overlap, thresholds, compute_aos, pr):
    """Accumulate one image's (n_thresh, 4) PR rows into ``pr`` in one
    native call. Every array must already be contiguous float64 / int64;
    the library must be loaded."""
    det_size, gt_size = overlaps.shape
    dc = dt_dc_overlap if dt_dc_overlap is not None \
        else np.zeros((det_size, 0), np.float64)
    _LIB.kitti_eval_image_pr(
        overlaps, det_size, gt_size, dt_scores, dt_alphas, gt_alphas,
        ignored_gt, ignored_det, dc, dc.shape[1], int(metric),
        float(min_overlap), thresholds, len(thresholds), int(compute_aos),
        pr)


def kitti_compute_statistics(overlaps, dt_scores, dt_alphas, gt_alphas,
                             ignored_gt, ignored_det, dt_dc_overlap, metric,
                             min_overlap, thresh, compute_fp, compute_aos):
    """The KITTI eval matching loop of one image under one score threshold:
    (tp, fp, fn, similarity, thresholds), or None without the library."""
    if _load() is None:
        return None
    det_size, gt_size = overlaps.shape
    out = np.zeros(4, np.float64)
    thresholds = np.zeros(max(gt_size, 1), np.float64)
    dc = np.ascontiguousarray(dt_dc_overlap, np.float64) \
        if dt_dc_overlap is not None and dt_dc_overlap.size \
        else np.zeros((det_size, 0), np.float64)
    n = _LIB.kitti_compute_statistics(
        np.ascontiguousarray(overlaps, np.float64), det_size, gt_size,
        np.ascontiguousarray(dt_scores, np.float64),
        np.ascontiguousarray(dt_alphas, np.float64),
        np.ascontiguousarray(gt_alphas, np.float64),
        np.ascontiguousarray(ignored_gt, np.int64),
        np.ascontiguousarray(ignored_det, np.int64),
        dc, dc.shape[1], int(metric), float(min_overlap), float(thresh),
        int(compute_fp), int(compute_aos), out, thresholds)
    return (int(out[0]), int(out[1]), int(out[2]), float(out[3]),
            thresholds[:n])
