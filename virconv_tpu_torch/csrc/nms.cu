// The RPN's rotated BEV NMS on the card, batched over a forward's entries:
// the suppression bitmask (nms_overlap_mask), then the fixed point and the
// compaction of the kept proposals (nms_select).
//
// Not a Pallas kernel: the pair replaces an XLA composition, the JAX
// package's nms_bev (virconv_tpu/ops/boxes.py:272). Its eager PyTorch form
// (ops/boxes.py nms_bev, the plain version) builds the k x k float IoU of
// the top-k proposals in 256-row chunks, about 30 elementwise launches a
// chunk on (256, k, 4, 4) tensors (65 MB each at k = 4000), throws half of
// it away with a lower-triangle mask and ends in a masked scatter that
// waits for the device, once per entry.
//
// nms_overlap_mask: bit j % 64 of mask[b, i, j / 64] is
//   (iou(i, j) > thresh) & valid_i & valid_j  for j < i (score rank),
// the strict lower triangle only; bits j >= i of a row's diagonal word are
// 0 and the words past it are never written or read. A CTA per 64 x 64
// tile (entry, row tile, column tile <= row tile) stages the 64 column
// boxes' corners, half-planes and areas in shared memory; a thread per
// row. Per pair it computes both clipped-edge integrals of Green's theorem
// (each box's edges clipped to the other's half-planes, Liang-Barsky, the
// parallel and on-boundary rules) and the IoU in the plain composition's
// order of operations, one rounding per operation (built with
// --fmad=false), so the bits are the plain version's on the card:
//   - the two-term sums of the dot products (a reduction over the last
//     dimension) are a + b, the four-term sum over the edges is
//     (x0 + x2) + (x1 + x3), as PyTorch's CUDA reduction adds them (its
//     lanes split the last dimension, then shuffle down from offset 2;
//     checked bit for bit against torch.sum on an H100 with PyTorch 2.11),
//     and a sum is never -0, as a sum started from +0 is not;
//   - max, min and clamp propagate a NaN, as torch.amax, torch.amin and
//     torch.clamp do; a comparison with a NaN is false, as in PyTorch;
//   - every constant is the float32 value of PyTorch's Python scalar
//     (1e-4, 1e-8, thresh), which PyTorch compares and adds in float32.
// nms_overlap_iou (tests only) also writes the float IoU of each pair of
// the triangle.
//
// nms_select: a CTA per entry holds the keep bits in shared memory, two
// buffers of k bits (16 KB at the largest k, kNmsMaxK), and runs the JAX
// package's fixed point exactly as written: num_iters passes of
//   keep'[i] = !any_{j < i}(sup[i, j] & keep[j]) & valid[i],
// from all kept (it stops after num_iters passes: not greedy NMS). A warp
// takes kRowsPerWarp rows at a time, its lanes over the row's words, so a
// row's words load coalesced from L2. Then the kept ranks are scanned and
// the r-th kept proposal's input index written to sel[b, r] for
// r < min(count, post), zeros and false after it: the plain version's
// result with no boolean-mask index, so no host sync.
//
// Bound: operations. The plain composition counts about 1 000 f32
// operations a pair (both integrals, the IoU and its tests), k (k - 1) / 2
// pairs an entry: 48 M pairs and 0.73 ms at 67 TFLOP/s for a T training
// step's 6 entries at k = 4000, 4 M pairs and 0.06 ms for a request's 2 at
// k = 2000. The mask, k^2 / 8 bytes an entry, stays in L2. What the design
// does about it: no k x k float tensor is made, only the triangle is
// computed, and each phase is one launch for all entries.

#include "common.cuh"

namespace {

constexpr int kTile = 64;           // rows and columns of a mask tile
constexpr int kNmsMaxK = 65536;     // keep bits: two buffers of 8 KB
constexpr int kSelectThreads = 1024;
constexpr int kRowsPerWarp = 4;
constexpr int kMaxWords = kNmsMaxK / 64;

constexpr float kParEps = 1e-4f;    // par_eps and coincide_tol
constexpr float kEps = 1e-8f;       // boxes.EPS

// One box: corners (4, 2) counter-clockwise, half-plane normals (4, 2)
// and offsets (4,) with n . x <= c inside, the offsets plus kParEps
// (the plain version adds it to the offsets before it compares).
struct Box {
  float cx[4], cy[4], nx[4], ny[4], c[4], c_tol[4];
};

__device__ __forceinline__ float sum2(float a, float b) {
  return (a + b) + 0.0f;
}

__device__ __forceinline__ float sum4(const float x[4]) {
  return ((x[0] + x[2]) + (x[1] + x[3])) + 0.0f;
}

// PyTorch's max_propagate_nan / min_propagate_nan.
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(b) ? b : (a < b ? b : a);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(b) ? b : (b < a ? b : a);
}

__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// Green's-theorem contribution of box u's edges clipped to box q's
// half-planes (boxes._clipped_edge_integrals).
__device__ __forceinline__ float clipped_edge_integral(const Box& u,
                                                       const Box& q) {
  float val[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int f = (e + 1) & 3;
    const float ux = u.cx[e], uy = u.cy[e];
    const float dx = u.cx[f] - ux, dy = u.cy[f] - uy;
    float t_lo[4], t_hi[4];
    bool infeasible = false, on_boundary = false;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float nu = sum2(q.nx[p] * ux, q.ny[p] * uy);
      const float nd = sum2(q.nx[p] * dx, q.ny[p] * dy);
      const float c = q.c[p];
      const float denom = fabsf(nd) < kParEps ? kParEps : nd;
      const float t_hit = (c - nu) / denom;
      t_lo[p] = nd < -kParEps ? t_hit : 0.0f;
      t_hi[p] = nd > kParEps ? t_hit : 1.0f;
      const bool parallel = fabsf(nd) <= kParEps;
      infeasible |= parallel && nu > q.c_tol[p];
      on_boundary |= parallel && fabsf(nu - c) <= kParEps;
    }
    const float t0 = clamp01(max_nan(max_nan(t_lo[0], t_lo[2]),
                                     max_nan(t_lo[1], t_lo[3])));
    const float t1 = clamp01(min_nan(min_nan(t_hi[0], t_hi[2]),
                                     min_nan(t_hi[1], t_hi[3])));
    const bool ok = !infeasible && t1 > t0;
    const float p0x = ux + t0 * dx, p0y = uy + t0 * dy;
    const float p1x = ux + t1 * dx, p1y = uy + t1 * dy;
    const float cross = p0x * p1y - p1x * p0y;
    val[e] = (ok ? cross : 0.0f) * (on_boundary ? 0.5f : 1.0f);
  }
  return sum4(val);
}

__device__ __forceinline__ void load_box(Box& b, const float* corners,
                                         const float* normals,
                                         const float* offsets, long long n) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    b.cx[e] = corners[n * 8 + 2 * e];
    b.cy[e] = corners[n * 8 + 2 * e + 1];
    b.nx[e] = normals[n * 8 + 2 * e];
    b.ny[e] = normals[n * 8 + 2 * e + 1];
    b.c[e] = offsets[n * 4 + e];
    b.c_tol[e] = b.c[e] + kParEps;
  }
}

// (row tile, column tile) of lower-triangle tile x: x = rt (rt + 1) / 2 + ct.
__device__ __forceinline__ void tri_tile(int x, int& rt, int& ct) {
  rt = (int)((sqrtf(8.0f * (float)x + 1.0f) - 1.0f) * 0.5f);
  while (rt * (rt + 1) / 2 > x) --rt;
  while ((rt + 1) * (rt + 2) / 2 <= x) ++rt;
  ct = x - rt * (rt + 1) / 2;
}

template <bool kIou>
__global__ void __launch_bounds__(kTile)
nms_overlap_mask_kernel(const float* __restrict__ corners,
                        const float* __restrict__ normals,
                        const float* __restrict__ offsets,
                        const float* __restrict__ area,
                        const bool* __restrict__ valid, int k, int words,
                        float thresh, unsigned long long* __restrict__ mask,
                        float* __restrict__ iou_out) {
  __shared__ Box s_box[kTile];
  __shared__ float s_area[kTile];
  __shared__ bool s_valid[kTile];
  int rt, ct;
  tri_tile(blockIdx.x, rt, ct);
  const int b = blockIdx.y;
  const long long base = (long long)b * k;
  const int t = threadIdx.x;
  const int j0 = ct * kTile;
  if (j0 + t < k) {
    load_box(s_box[t], corners, normals, offsets, base + j0 + t);
    s_area[t] = area[base + j0 + t];
    s_valid[t] = valid[base + j0 + t];
  }
  __syncthreads();
  const int i = rt * kTile + t;
  if (i >= k) return;
  Box row;
  load_box(row, corners, normals, offsets, base + i);
  const float area_i = area[base + i];
  const bool valid_i = valid[base + i];
  const int n = min(kTile, i - j0);      // columns j0 .. j0 + n - 1 < i
  unsigned long long bits = 0;
  if (valid_i || kIou) {
    for (int jj = 0; jj < n; ++jj) {
      if (!kIou && !s_valid[jj]) continue;
      const Box& col = s_box[jj];
      const float suma = clipped_edge_integral(row, col);
      const float sumb = clipped_edge_integral(col, row);
      const float inter = clamp_min(0.5f * (suma + sumb), 0.0f);
      const float iou =
          inter / clamp_min((area_i + s_area[jj]) - inter, kEps);
      if (kIou) iou_out[(base + i) * k + j0 + jj] = iou;
      if (iou > thresh && valid_i && s_valid[jj]) bits |= 1ull << jj;
    }
  }
  mask[(base + i) * words + ct] = bits;
}

__global__ void __launch_bounds__(kSelectThreads)
nms_select_kernel(const unsigned long long* __restrict__ mask,
                  const bool* __restrict__ valid,
                  const long long* __restrict__ order, int k, int words,
                  int post, int num_iters, long long* __restrict__ sel,
                  bool* __restrict__ sel_valid) {
  __shared__ unsigned long long s_keep[2][kMaxWords];
  __shared__ int s_warp_sum[kSelectThreads / 32];
  const int b = blockIdx.x;
  const long long base = (long long)b * k;
  const unsigned long long* m = mask + base * words;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  constexpr int kWarps = kSelectThreads / 32;
  for (int w = t; w < words; w += kSelectThreads) {
    const int rem = k - w * 64;
    s_keep[0][w] = rem >= 64 ? ~0ull : (1ull << rem) - 1;
  }
  int cur = 0;
  for (int it = 0; it < num_iters; ++it) {
    unsigned long long* keep = s_keep[cur];
    unsigned long long* next = s_keep[cur ^ 1];
    for (int w = t; w < words; w += kSelectThreads) next[w] = 0;
    __syncthreads();
    for (int i0 = warp * kRowsPerWarp; i0 < k; i0 += kWarps * kRowsPerWarp) {
      unsigned long long hit[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int i = i0 + r;
        hit[r] = 0;
        if (i < k && valid[base + i]) {
          const unsigned long long* row = m + (long long)i * words;
          for (int w = lane; w <= (i >> 6); w += 32)
            hit[r] |= row[w] & keep[w];
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int i = i0 + r;
        const bool any = __any_sync(0xffffffffu, hit[r] != 0);
        if (lane == 0 && i < k && !any && valid[base + i])
          atomicOr(&next[i >> 6], 1ull << (i & 63));
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  // the kept proposals' ranks: an exclusive scan of the words' popcounts
  const unsigned long long* keep = s_keep[cur];
  const int w = t;                      // words <= kMaxWords = the threads
  const int pc = w < words ? __popcll(keep[w]) : 0;
  int incl = pc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = s_warp_sum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += v;
    }
    s_warp_sum[lane] = s;               // inclusive, by warp
  }
  __syncthreads();
  const int count = min(s_warp_sum[kWarps - 1], post);
  int rank = incl - pc + (warp ? s_warp_sum[warp - 1] : 0);
  long long* out = sel + (long long)b * post;
  bool* out_valid = sel_valid + (long long)b * post;
  if (w < words) {
    for (unsigned long long bits = keep[w]; bits && rank < post; ++rank) {
      const int i = w * 64 + __ffsll((long long)bits) - 1;
      bits &= bits - 1;
      out[rank] = order[base + i];
      out_valid[rank] = true;
    }
  }
  for (int r = count + t; r < post; r += kSelectThreads) {
    out[r] = 0;
    out_valid[r] = false;
  }
}

template <bool kIou>
int launch_mask(const float* corners, const float* normals,
                const float* offsets, const float* area, const bool* valid,
                int batch, int k, float thresh, unsigned long long* mask,
                float* iou, cudaStream_t stream) {
  if (batch < 0 || k < 0 || k > kNmsMaxK || batch > 65535) return -1;
  if (batch == 0 || k == 0) return 0;
  const int tiles = (k + kTile - 1) / kTile;
  const int words = tiles;
  dim3 grid(tiles * (tiles + 1) / 2, batch);
  nms_overlap_mask_kernel<kIou><<<grid, kTile, 0, stream>>>(
      corners, normals, offsets, area, valid, k, words, thresh, mask, iou);
  return (int)cudaGetLastError();
}

}  // namespace

// corners, normals (B * k, 4, 2), offsets (B * k, 4), area and valid
// (B * k,): the top-k proposals of each entry in score order. mask
// (B, k, ceil(k / 64)) uint64.
extern "C" int nms_overlap_mask(const float* corners, const float* normals,
                                const float* offsets, const float* area,
                                const bool* valid, int batch, int k,
                                float thresh, unsigned long long* mask,
                                cudaStream_t stream) {
  return launch_mask<false>(corners, normals, offsets, area, valid, batch,
                            k, thresh, mask, nullptr, stream);
}

// nms_overlap_mask, and the float IoU of each pair j < i to iou (B, k, k),
// whose other entries it leaves as they are (tests only).
extern "C" int nms_overlap_iou(const float* corners, const float* normals,
                               const float* offsets, const float* area,
                               const bool* valid, int batch, int k,
                               float thresh, unsigned long long* mask,
                               float* iou, cudaStream_t stream) {
  return launch_mask<true>(corners, normals, offsets, area, valid, batch, k,
                           thresh, mask, iou, stream);
}

// mask from nms_overlap_mask; valid (B * k,), order (B, k) int64: the
// proposals' input indices. sel (B, post) int64, sel_valid (B, post).
extern "C" int nms_select(const unsigned long long* mask, const bool* valid,
                          const long long* order, int batch, int k, int post,
                          int num_iters, long long* sel, bool* sel_valid,
                          cudaStream_t stream) {
  if (batch < 0 || k < 0 || k > kNmsMaxK || post < 0 || num_iters < 0)
    return -1;
  if (batch == 0 || post == 0) return 0;
  const int words = (k + 63) / 64;
  nms_select_kernel<<<batch, kSelectThreads, 0, stream>>>(
      mask, valid, order, k, words, post, num_iters, sel, sel_valid);
  return (int)cudaGetLastError();
}
