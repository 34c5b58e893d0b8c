// PENet's depth2points tail on the card: a completed 352 x 1216 depth map
// to the thinned virtual points of the frame's fused cloud, bit for bit
// what numpy makes of the same depth (models/depth_completion/
// depth2points.py: depth_to_points_rgb, the z cut of
// fuse_virtual_and_lidar, la_sampling2).
//
// Not a Pallas kernel: the JAX package runs this tail in numpy on the host
// (virconv_tpu/models/depth_completion/depth2points.py), as the reference
// does. On the host it took 184-238 ms a frame on one thread (numpy's
// (N, 4) x (4, 4) product on OpenBLAS's threads, la_sampling2's float32
// floor divisions and lexsort), beside a forward of about 45 ms on the
// card.
//
// Two entry points, each a few kernels on the caller's stream, with the
// host between them only for numpy's arccos and arctan (a device
// transcendental one ulp off would move points across bins):
//
// d2p_project: every pixel whose depth lies in (0.1, 100) m back-projected
//   through the crop's camera (img_to_rect's float32 operations in their
//   order) and rotated to the LiDAR frame by rect_to_lidar's 4 x 4 matrix
//   in the order numpy's np.dot takes on the hosts probed: OpenBLAS's sgemm
//   for two or more rows (acc = 0, then acc = fma(a_k, b_k, acc) for
//   k = 0..3), its sgemv for a frame with one pixel in range (the even and
//   the odd k each an fma chain from its first product, their sum added to
//   +0). Points below z = 1 m are kept, in row-major pixel order (the order
//   of np.nonzero), by an ordered compaction: a count per CTA, one CTA's
//   scan, the rank in the CTA from warp ballots. Each kept row gets
//   r = max(sqrt((x*x + y*y) + z*z), 1e-6) (np.linalg.norm's order),
//   c = clip(z / r, -1, 1) and q = y / max(x, 1e-6); the counts, c and q
//   sit in one buffer that reaches the host in one copy.
// d2p_thin: each kept row's bins from the host's theta = arccos(c) and
//   fan = arctan(q), floored as numpy's float32 floor_divide does
//   (npy_divmod: fmod, the quotient of the difference, its floor snapped),
//   index a dense (vert, hor) table over the frame's bins (the host sizes
//   it from the extreme angles, a bin to spare on each side). One 64-bit
//   atomicMin of (bits of r) << 32 | row a row keeps the nearest row of
//   each bin, the lower row on a tie in r, as the stable lexsort((r, key))
//   does; r > 0, so its bits order as its values. The occupied slots
//   compacted in table order are la_sampling2's rows in key order
//   (|hor| < 500 001, so the (vert, hor) order is the order of
//   vert * 1 000 003 + hor). Each winner is back-projected again from its
//   pixel (the same device function, so the same bits) with RGB / 3 and
//   indicator 1, and written as 8 float16 values rounded to nearest even
//   (one 16-byte store a row) after the count, for one copy to the host.
//
// All float arithmetic is the explicit round-to-nearest intrinsics (and
// the build passes --fmad=false), numpy's float32 operations one by one;
// Python constants are float32, as numpy's promotion makes them.
//
// Bound: the bytes the tail needs, each once: the 1.7 MB depth; the kept
// rows (~235 k) with their pixel, r, c, q written and r and the angles read
// (28 B); the winners' (~90 k) pixel, depth and colour read and their row
// written (27 B): about 10 MB, ~3 us at 3.35 TB/s. The table (~0.2 M slots
// of 8 B, filled and scanned) is this design's. The launches (nine a
// frame), the two copies to the host and the host's arccos and arctan
// between them set the time.

#include "common.cuh"

#include <cuda_fp16.h>

namespace {

constexpr int kThreads = 256;        // a CTA's pixels, rows or slots
constexpr int kScanThreads = 1024;   // the scan's one CTA
constexpr int kMaxTable = 16777216;  // table slots
constexpr int kHead = 4;             // the counts ahead of c and q, or rows

struct Camera {
  float cu, cv, fu, fv, tx, ty;
  float m[16];     // rect_to_lidar's matrix, row-major: lidar = [x y z 1] m
};

// A float64 constant as numpy's promotion makes it against float32 data.
__device__ __forceinline__ float f32(double x) { return (float)x; }

// Pixel p of a w-wide depth map with depth d: the LiDAR point of
// img_to_rect + rect_to_lidar. The 4 x 4 product as np.dot makes it: for
// two or more rows OpenBLAS's sgemm (acc = +0, then acc = fma(a_k, b_k,
// acc) for k = 0..3); for a frame with one_row (one pixel in range) its
// sgemv (the even and the odd k each an fma chain from its first product,
// their sum added to y = +0).
__device__ __forceinline__ void back_project(const Camera& cam, int p, int w,
                                             float d, bool one_row,
                                             float* out) {
  const float u = (float)(p % w), v = (float)(p / w);
  const float x = __fadd_rn(
      __fdiv_rn(__fmul_rn(__fsub_rn(u, cam.cu), d), cam.fu), cam.tx);
  const float y = __fadd_rn(
      __fdiv_rn(__fmul_rn(__fsub_rn(v, cam.cv), d), cam.fv), cam.ty);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (one_row) {
      const float even = __fmaf_rn(d, cam.m[8 + j], __fmul_rn(x, cam.m[j]));
      const float odd =
          __fmaf_rn(1.0f, cam.m[12 + j], __fmul_rn(y, cam.m[4 + j]));
      out[j] = __fadd_rn(__fadd_rn(even, odd), 0.0f);
      continue;
    }
    float acc = 0.0f;
    acc = __fmaf_rn(x, cam.m[j], acc);
    acc = __fmaf_rn(y, cam.m[4 + j], acc);
    acc = __fmaf_rn(d, cam.m[8 + j], acc);
    acc = __fmaf_rn(1.0f, cam.m[12 + j], acc);
    out[j] = acc;
  }
}

// numpy's float32 a // b (npy_floor_divide, npy_divmod) for b > 0.
__device__ __forceinline__ float floor_divide(float a, float b) {
  const float mod = fmodf(a, b);
  float div = __fdiv_rn(__fsub_rn(a, mod), b);
  if (mod != 0.0f && (b < 0.0f) != (mod < 0.0f)) div = __fsub_rn(div, 1.0f);
  if (div == 0.0f) return copysignf(0.0f, __fdiv_rn(a, b));
  float floordiv = floorf(div);
  if (__fsub_rn(div, floordiv) > 0.5f) floordiv = __fadd_rn(floordiv, 1.0f);
  return floordiv;
}

// This thread's rank among the CTA's threads whose flag is set, in thread
// order. Every thread of the CTA calls it; warp_counts: kThreads / 32.
__device__ __forceinline__ int cta_rank(bool flag, int* warp_counts) {
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  for (int i = 0; i < warp; ++i) before += warp_counts[i];
  return before + __popc(ballot & ((1u << lane) - 1u));
}

// Pixel p's in-range and kept flags and, kept, its LiDAR point.
__device__ __forceinline__ bool kept_pixel(const float* depth,
                                           const Camera& cam, int p, int n,
                                           int w, bool one_row, bool* inr,
                                           float* xyz) {
  *inr = false;
  if (p >= n) return false;
  const float d = depth[p];
  if (!(d > f32(0.1) && d < f32(100.0))) return false;
  *inr = true;
  back_project(cam, p, w, d, one_row, xyz);
  return xyz[2] < f32(1.0);
}

__global__ void __launch_bounds__(kThreads) project_count_kernel(
    const float* __restrict__ depth, Camera cam, int n, int w,
    int* __restrict__ counts, int* __restrict__ in_counts) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  bool inr;
  float xyz[3];
  const bool keep = kept_pixel(depth, cam, p, n, w, false, &inr, xyz);
  const int nk = __syncthreads_count(keep);
  const int ni = __syncthreads_count(inr);
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = nk;
    in_counts[blockIdx.x] = ni;
  }
}

// One CTA: offsets = the exclusive scan of counts[0..n), *total their sum;
// with extra, *extra_total the sum of extra[0..n).
__global__ void __launch_bounds__(kScanThreads) scan_kernel(
    const int* __restrict__ counts, int n, int* __restrict__ offsets,
    int* __restrict__ total, const int* __restrict__ extra,
    int* __restrict__ extra_total) {
  __shared__ int sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0, extra_sum = 0;
  for (int base = 0; base < n; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < n ? counts[i] : 0;
    if (extra != nullptr && i < n) extra_sum += extra[i];
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = sums[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      sums[lane] = s;
    }
    __syncthreads();
    if (i < n) offsets[i] = carry + (warp ? sums[warp - 1] : 0) + x - v;
    carry += sums[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (extra != nullptr) {
    for (int o = 16; o > 0; o >>= 1)
      extra_sum += __shfl_down_sync(0xffffffffu, extra_sum, o);
    if (lane == 0) sums[warp] = extra_sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      int s = 0;
      for (int k = 0; k < kScanThreads / 32; ++k) s += sums[k];
      *extra_total = s;
    }
  }
  if (threadIdx.x == 0) *total = carry;
}

// The kept pixels in pixel order: pix, r, and c at cq[o], q at cq[n + o].
// head: [kept rows, pixels in range] from the scan. The counts took the
// sgemm order; with one pixel in range (no other row before it) that
// pixel is back-projected in the sgemv order and sets the kept count.
__global__ void __launch_bounds__(kThreads) project_write_kernel(
    const float* __restrict__ depth, Camera cam, int n, int w,
    const int* __restrict__ offsets, int* __restrict__ head,
    int* __restrict__ pix, float* __restrict__ r_out,
    float* __restrict__ cq) {
  __shared__ int warp_counts[kThreads / 32];
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool one_row = head[1] == 1;
  bool inr;
  float xyz[3];
  const bool keep = kept_pixel(depth, cam, p, n, w, one_row, &inr, xyz);
  const int o = offsets[blockIdx.x] + cta_rank(keep, warp_counts);
  if (one_row && inr) head[0] = keep ? 1 : 0;
  if (!keep) return;
  const float x = xyz[0], y = xyz[1], z = xyz[2];
  const float r = fmaxf(
      __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                           __fmul_rn(z, z))),
      f32(1e-6));
  pix[o] = p;
  r_out[o] = r;
  cq[o] = fminf(fmaxf(__fdiv_rn(z, r), -1.0f), 1.0f);
  cq[n + o] = __fdiv_rn(y, fmaxf(x, f32(1e-6)));
}

struct Table {
  unsigned long long* slots;
  int v_lo, v_rows, h_lo, h_cols;
  float vert_res, hor_res;
};

__global__ void __launch_bounds__(kThreads) table_fill_kernel(
    Table tab, int t, int* __restrict__ bad) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e < t) tab.slots[e] = ~0ull;
  if (e == 0) *bad = 0;
}

// Row i's bins from its angles (theta at angles[i], fan at angles[n + i]);
// the nearest row of each bin. A bin outside the table sets *bad.
__global__ void __launch_bounds__(kThreads) keep_min_kernel(
    const float* __restrict__ r, const float* __restrict__ angles, int n,
    Table tab, int* __restrict__ bad) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int vert = (int)floor_divide(angles[i], tab.vert_res) - tab.v_lo;
  const int hor = (int)floor_divide(angles[n + i], tab.hor_res) - tab.h_lo;
  if (vert < 0 || vert >= tab.v_rows || hor < 0 || hor >= tab.h_cols) {
    atomicOr(bad, 1);
    return;
  }
  atomicMin(&tab.slots[(long long)vert * tab.h_cols + hor],
            (unsigned long long)__float_as_uint(r[i]) << 32 | (unsigned)i);
}

__global__ void __launch_bounds__(kThreads) table_count_kernel(
    const unsigned long long* __restrict__ slots, int t,
    int* __restrict__ counts) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int nk = __syncthreads_count(e < t && slots[e] != ~0ull);
  if (threadIdx.x == 0) counts[blockIdx.x] = nk;
}

__global__ void __launch_bounds__(kThreads) table_write_kernel(
    const unsigned long long* __restrict__ slots, int t,
    const int* __restrict__ offsets, int* __restrict__ win) {
  __shared__ int warp_counts[kThreads / 32];
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const unsigned long long v = e < t ? slots[e] : ~0ull;
  const int o = offsets[blockIdx.x] + cta_rank(v != ~0ull, warp_counts);
  if (v != ~0ull) win[o] = (int)(v & 0xffffffffu);
}

// Two floats as float16 (nearest even), the first in the low half.
__device__ __forceinline__ unsigned half_pair(float lo, float hi) {
  return (unsigned)__half_as_ushort(__float2half_rn(lo)) |
         (unsigned)__half_as_ushort(__float2half_rn(hi)) << 16;
}

__global__ void __launch_bounds__(kThreads) cloud_rows_kernel(
    const float* __restrict__ depth, const unsigned char* __restrict__ rgb,
    Camera cam, int w, bool one_row, const int* __restrict__ pix,
    const int* __restrict__ win, const int* __restrict__ count,
    uint4* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= *count) return;
  const int p = pix[win[j]];
  float xyz[3];
  back_project(cam, p, w, depth[p], one_row, xyz);
  float rgb3[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    rgb3[k] = __fdiv_rn((float)rgb[3 * p + k], 3.0f);
  out[j] = make_uint4(half_pair(xyz[0], xyz[1]), half_pair(xyz[2], 0.0f),
                      half_pair(rgb3[0], rgb3[1]), half_pair(rgb3[2], 1.0f));
}

Camera camera_of(const float* params) {
  Camera cam;
  cam.cu = params[0];
  cam.cv = params[1];
  cam.fu = params[2];
  cam.fv = params[3];
  cam.tx = params[4];
  cam.ty = params[5];
  for (int k = 0; k < 16; ++k) cam.m[k] = params[6 + k];
  return cam;
}

unsigned blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// depth (h, w) f32; camera: 22 floats in host memory (Camera's order);
// scratch: 3 * ceil(h * w / kThreads) ints; head: kHead + 2 * h * w ints:
// [N kept rows, pixels in range, -, -], then c of the N rows (f32) from
// head + kHead and their q from head + kHead + h * w; pix, r: h * w each,
// the first N written.
extern "C" int d2p_project(const float* depth, int h, int w,
                           const float* camera, int* scratch, int* head,
                           int* pix, float* r, cudaStream_t stream) {
  if (h < 1 || w < 1 || (long long)h * w >= (1LL << 30)) return -1;
  const int n = h * w;
  const Camera cam = camera_of(camera);
  const unsigned nb = blocks(n);
  int* counts = scratch;
  int* in_counts = scratch + nb;
  int* offsets = scratch + 2 * nb;
  project_count_kernel<<<nb, kThreads, 0, stream>>>(depth, cam, n, w, counts,
                                                    in_counts);
  scan_kernel<<<1, kScanThreads, 0, stream>>>(counts, (int)nb, offsets, head,
                                              in_counts, head + 1);
  project_write_kernel<<<nb, kThreads, 0, stream>>>(
      depth, cam, n, w, offsets, head, pix, r,
      reinterpret_cast<float*>(head + kHead));
  return (int)cudaGetLastError();
}

// depth, rgb (h, w, 3) uint8, camera as for d2p_project; pix and r its
// first n rows; angles: theta of the n rows, then their fan (f32); a table
// of v_rows x h_cols slots for vert in [v_lo, v_lo + v_rows), hor in
// [h_lo, h_lo + h_cols); one_row: the frame had one pixel in range (the
// sgemv order); scratch: 2 * ceil(v_rows * h_cols / kThreads) + n ints;
// out: kHead + 4 * n ints, written [K winners, a bin outside the table
// (0 or 1), -, -, the K rows of 8 float16].
extern "C" int d2p_thin(const float* depth, const unsigned char* rgb, int h,
                        int w, const float* camera, const int* pix,
                        const float* r, const float* angles, int n,
                        float vert_res, float hor_res, int v_lo, int v_rows,
                        int h_lo, int h_cols, int one_row,
                        unsigned long long* table, int* scratch, int* out,
                        cudaStream_t stream) {
  const long long t = (long long)v_rows * h_cols;
  if (h < 1 || w < 1 || n < 1 || v_rows < 1 || h_cols < 1 || t > kMaxTable ||
      !(vert_res > 0.0f) || !(hor_res > 0.0f))
    return -1;
  const Table tab{table, v_lo, v_rows, h_lo, h_cols, vert_res, hor_res};
  const unsigned nb = blocks(t);
  int* counts = scratch;
  int* offsets = scratch + nb;
  int* win = scratch + 2 * nb;
  table_fill_kernel<<<nb, kThreads, 0, stream>>>(tab, (int)t, out + 1);
  keep_min_kernel<<<blocks(n), kThreads, 0, stream>>>(r, angles, n, tab,
                                                      out + 1);
  table_count_kernel<<<nb, kThreads, 0, stream>>>(table, (int)t, counts);
  scan_kernel<<<1, kScanThreads, 0, stream>>>(counts, (int)nb, offsets, out,
                                              nullptr, nullptr);
  table_write_kernel<<<nb, kThreads, 0, stream>>>(table, (int)t, offsets,
                                                  win);
  cloud_rows_kernel<<<blocks(n), kThreads, 0, stream>>>(
      depth, rgb, camera_of(camera), w, one_row != 0, pix, win, out,
      reinterpret_cast<uint4*>(out + kHead));
  return (int)cudaGetLastError();
}
