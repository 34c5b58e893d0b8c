// Host-side box geometry kernels (C shared library, ctypes-bound).
//
// The port's copy of the repository's root csrc/box_ops.cpp: rotated BEV
// overlap, IoU, NMS and points-in-boxes for WBF clustering and the
// KITTI AP metric, and the metric's matching loop. Everything from the
// first #include on is the root file's text unchanged
// (tests/test_torch_kitti_eval.py holds the two equal), so the port's
// host IoU is the JAX package's. Built with g++ by
// virconv_tpu_torch/ops/native.py at first use.
//
// Algorithm: candidate-vertex collection (corners-inside + segment
// intersections), angular sort around the centroid, shoelace area.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr double EPS = 1e-8;

struct Pt {
  double x, y;
};

struct RotBox {
  double cx, cy, dx, dy, angle;  // center, extents, heading
};

void corners_of(const RotBox& b, Pt out[4]) {
  const double c = std::cos(b.angle), s = std::sin(b.angle);
  const double hx = b.dx / 2, hy = b.dy / 2;
  const double ox[4] = {hx, -hx, -hx, hx};
  const double oy[4] = {hy, hy, -hy, -hy};
  for (int i = 0; i < 4; ++i) {
    out[i].x = ox[i] * c - oy[i] * s + b.cx;
    out[i].y = ox[i] * s + oy[i] * c + b.cy;
  }
}

bool point_in_box(const Pt& p, const RotBox& b) {
  const double c = std::cos(b.angle), s = std::sin(b.angle);
  const double dx = p.x - b.cx, dy = p.y - b.cy;
  const double lx = dx * c + dy * s;
  const double ly = -dx * s + dy * c;
  return std::fabs(lx) <= b.dx / 2 + EPS && std::fabs(ly) <= b.dy / 2 + EPS;
}

// overlap area of two rotated rectangles
double rect_overlap(const RotBox& a, const RotBox& b) {
  Pt ca[4], cb[4];
  corners_of(a, ca);
  corners_of(b, cb);

  Pt cand[24];
  int n = 0;
  for (int i = 0; i < 4; ++i)
    if (point_in_box(ca[i], b)) cand[n++] = ca[i];
  for (int i = 0; i < 4; ++i)
    if (point_in_box(cb[i], a)) cand[n++] = cb[i];

  for (int i = 0; i < 4; ++i) {
    const Pt a0 = ca[i], a1 = ca[(i + 1) % 4];
    for (int j = 0; j < 4; ++j) {
      const Pt b0 = cb[j], b1 = cb[(j + 1) % 4];
      const double dax = a1.x - a0.x, day = a1.y - a0.y;
      const double dbx = b1.x - b0.x, dby = b1.y - b0.y;
      const double denom = dax * dby - day * dbx;
      if (std::fabs(denom) < EPS) continue;
      const double d0x = b0.x - a0.x, d0y = b0.y - a0.y;
      const double t = (d0x * dby - d0y * dbx) / denom;
      const double u = (d0x * day - d0y * dax) / denom;
      if (t >= 0 && t <= 1 && u >= 0 && u <= 1)
        cand[n++] = {a0.x + t * dax, a0.y + t * day};
    }
  }
  if (n < 3) return 0.0;

  double cx = 0, cy = 0;
  for (int i = 0; i < n; ++i) {
    cx += cand[i].x;
    cy += cand[i].y;
  }
  cx /= n;
  cy /= n;
  double ang[24];
  int idx[24];
  for (int i = 0; i < n; ++i) {
    ang[i] = std::atan2(cand[i].y - cy, cand[i].x - cx);
    idx[i] = i;
  }
  std::sort(idx, idx + n, [&](int i, int j) { return ang[i] < ang[j]; });
  double area = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt& p = cand[idx[i]];
    const Pt& q = cand[idx[(i + 1) % n]];
    area += p.x * q.y - q.x * p.y;
  }
  return std::fabs(area) / 2.0;
}

RotBox box_from7(const float* b) {
  return RotBox{b[0], b[1], b[3], b[4], b[6]};
}

}  // namespace

extern "C" {

// boxes: (n, 7) [x, y, z, dx, dy, dz, heading]; out: (n, m) overlap areas
void boxes_overlap_bev(const float* boxes_a, int64_t n, const float* boxes_b,
                       int64_t m, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    const RotBox a = box_from7(boxes_a + i * 7);
    for (int64_t j = 0; j < m; ++j) {
      const RotBox b = box_from7(boxes_b + j * 7);
      out[i * m + j] = rect_overlap(a, b);
    }
  }
}

void boxes_iou_bev(const float* boxes_a, int64_t n, const float* boxes_b,
                   int64_t m, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    const RotBox a = box_from7(boxes_a + i * 7);
    const double area_a = a.dx * a.dy;
    for (int64_t j = 0; j < m; ++j) {
      const RotBox b = box_from7(boxes_b + j * 7);
      const double inter = rect_overlap(a, b);
      const double uni = area_a + b.dx * b.dy - inter;
      out[i * m + j] = inter / std::max(uni, EPS);
    }
  }
}

void boxes_iou3d(const float* boxes_a, int64_t n, const float* boxes_b,
                 int64_t m, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    const float* fa = boxes_a + i * 7;
    const RotBox a = box_from7(fa);
    const double vol_a = fa[3] * fa[4] * fa[5];
    const double za1 = fa[2] - fa[5] / 2, za2 = fa[2] + fa[5] / 2;
    for (int64_t j = 0; j < m; ++j) {
      const float* fb = boxes_b + j * 7;
      const RotBox b = box_from7(fb);
      const double inter_bev = rect_overlap(a, b);
      const double zb1 = fb[2] - fb[5] / 2, zb2 = fb[2] + fb[5] / 2;
      const double zi =
          std::max(0.0, std::min(za2, zb2) - std::max(za1, zb1));
      const double inter = inter_bev * zi;
      const double uni = vol_a + fb[3] * fb[4] * fb[5] - inter;
      out[i * m + j] = inter / std::max(uni, EPS);
    }
  }
}

// greedy rotated NMS; scores assumed pre-sorted descending with boxes.
// keep_out must have room for n entries; returns kept count.
int64_t nms_bev(const float* boxes, const float* scores, int64_t n,
                double thresh, int64_t post_max, int64_t* keep_out) {
  (void)scores;
  int64_t kept = 0;
  bool* suppressed = new bool[n]();
  for (int64_t i = 0; i < n && kept < post_max; ++i) {
    if (suppressed[i]) continue;
    keep_out[kept++] = i;
    const RotBox a = box_from7(boxes + i * 7);
    const double area_a = a.dx * a.dy;
    for (int64_t j = i + 1; j < n; ++j) {
      if (suppressed[j]) continue;
      const RotBox b = box_from7(boxes + j * 7);
      const double inter = rect_overlap(a, b);
      const double iou =
          inter / std::max(area_a + b.dx * b.dy - inter, EPS);
      if (iou > thresh) suppressed[j] = true;
    }
  }
  delete[] suppressed;
  return kept;
}

// points (p, 3); boxes (n, 7); out (p,) first containing box index or -1
void points_in_boxes(const float* points, int64_t p, const float* boxes,
                     int64_t n, int32_t* out) {
  for (int64_t i = 0; i < p; ++i) {
    const double x = points[i * 3], y = points[i * 3 + 1],
                 z = points[i * 3 + 2];
    out[i] = -1;
    for (int64_t j = 0; j < n; ++j) {
      const float* b = boxes + j * 7;
      if (std::fabs(z - b[2]) > b[5] / 2) continue;
      const double c = std::cos(b[6]), s = std::sin(b[6]);
      const double dx = x - b[0], dy = y - b[1];
      const double lx = dx * c + dy * s, ly = -dx * s + dy * c;
      if (std::fabs(lx) <= b[3] / 2 && std::fabs(ly) <= b[4] / 2) {
        out[i] = static_cast<int32_t>(j);
        break;
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// KITTI eval inner loop: one image's TP/FP/FN under one score threshold.
// Mirrors virconv_tpu/datasets/kitti/eval.py::compute_statistics (the
// official devkit matching protocol); called ~half a million times per
// full-val evaluation, so the python version is ported here.
// ---------------------------------------------------------------------------

extern "C" {

// overlaps: (det, gt) row-major. Returns via out[4]: tp, fp, fn, similarity.
// thresholds_out (capacity >= gt): scores of newly matched TPs (only when
// compute_fp == 0); returns the count of thresholds written.
int64_t kitti_compute_statistics(
    const double* overlaps, int64_t det_size, int64_t gt_size,
    const double* dt_scores, const double* dt_alphas,
    const double* gt_alphas, const int64_t* ignored_gt,
    const int64_t* ignored_det, const double* dt_dc_overlap,
    int64_t dc_size, int32_t metric, double min_overlap, double thresh,
    int32_t compute_fp, int32_t compute_aos, double* out,
    double* thresholds_out) {
  const double NO_DETECTION = -10000000000.0;
  bool* assigned = new bool[det_size]();
  bool* ignored_threshold = new bool[det_size]();
  if (compute_fp) {
    for (int64_t j = 0; j < det_size; ++j)
      ignored_threshold[j] = dt_scores[j] < thresh;
  }
  int64_t tp = 0, fp = 0, fn = 0;
  double similarity = 0.0;
  int64_t n_thresh = 0;
  double* delta = new double[gt_size];
  int64_t n_delta = 0;

  for (int64_t i = 0; i < gt_size; ++i) {
    if (ignored_gt[i] == -1) continue;
    int64_t det_idx = -1;
    double valid_detection = NO_DETECTION;
    double max_overlap = 0.0;
    bool assigned_ignored_det = false;
    for (int64_t j = 0; j < det_size; ++j) {
      if (ignored_det[j] == -1 || assigned[j] || ignored_threshold[j])
        continue;
      const double overlap = overlaps[j * gt_size + i];
      const double dt_score = dt_scores[j];
      if (!compute_fp && overlap > min_overlap &&
          dt_score > valid_detection) {
        det_idx = j;
        valid_detection = dt_score;
      } else if (compute_fp && overlap > min_overlap &&
                 (overlap > max_overlap || assigned_ignored_det) &&
                 ignored_det[j] == 0) {
        max_overlap = overlap;
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = false;
      } else if (compute_fp && overlap > min_overlap &&
                 valid_detection == NO_DETECTION && ignored_det[j] == 1) {
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = true;
      }
    }
    if (valid_detection == NO_DETECTION && ignored_gt[i] == 0) {
      ++fn;
    } else if (valid_detection != NO_DETECTION &&
               (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
      assigned[det_idx] = true;
    } else if (valid_detection != NO_DETECTION) {
      ++tp;
      thresholds_out[n_thresh++] = dt_scores[det_idx];
      if (compute_aos) delta[n_delta++] = gt_alphas[i] - dt_alphas[det_idx];
      assigned[det_idx] = true;
    }
  }
  if (compute_fp) {
    for (int64_t j = 0; j < det_size; ++j) {
      if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
            ignored_threshold[j]))
        ++fp;
    }
    int64_t nstuff = 0;
    if (metric == 0 && dc_size > 0) {
      for (int64_t i = 0; i < dc_size; ++i) {
        for (int64_t j = 0; j < det_size; ++j) {
          if (ignored_det[j] == -1 || assigned[j] || ignored_threshold[j])
            continue;
          if (dt_dc_overlap[j * dc_size + i] > min_overlap) {
            assigned[j] = true;
            ++nstuff;
          }
        }
      }
    }
    fp -= nstuff;
    if (compute_aos) {
      double sum = 0.0;
      for (int64_t k = 0; k < n_delta; ++k)
        sum += (1.0 + std::cos(delta[k])) / 2.0;
      similarity = (tp > 0 || fp > 0) ? sum : -1.0;
    }
  }
  out[0] = static_cast<double>(tp);
  out[1] = static_cast<double>(fp);
  out[2] = static_cast<double>(fn);
  out[3] = similarity;
  delete[] assigned;
  delete[] ignored_threshold;
  delete[] delta;
  return n_thresh;
}

}  // extern "C"

extern "C" {

// Accumulate PR rows for all thresholds of one image in one call:
// pr (n_thresh, 4) is accumulated in place (tp, fp, fn, similarity).
void kitti_eval_image_pr(
    const double* overlaps, int64_t det_size, int64_t gt_size,
    const double* dt_scores, const double* dt_alphas,
    const double* gt_alphas, const int64_t* ignored_gt,
    const int64_t* ignored_det, const double* dt_dc_overlap,
    int64_t dc_size, int32_t metric, double min_overlap,
    const double* thresholds, int64_t n_thresh, int32_t compute_aos,
    double* pr) {
  double out[4];
  double* tmp = new double[gt_size > 0 ? gt_size : 1];
  for (int64_t t = 0; t < n_thresh; ++t) {
    kitti_compute_statistics(
        overlaps, det_size, gt_size, dt_scores, dt_alphas, gt_alphas,
        ignored_gt, ignored_det, dt_dc_overlap, dc_size, metric,
        min_overlap, thresholds[t], 1, compute_aos, out, tmp);
    pr[t * 4 + 0] += out[0];
    pr[t * 4 + 1] += out[1];
    pr[t * 4 + 2] += out[2];
    if (out[3] != -1.0) pr[t * 4 + 3] += out[3];
  }
  delete[] tmp;
}

}  // extern "C"
