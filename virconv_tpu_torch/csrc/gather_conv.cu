// Windowed gather convolutions from a neighbor map: K5 (one contiguous
// window per row tile) and K6 (a two-block window per row tile and tap).
//
// K5 replaces virconv_tpu/ops/pallas/gather_conv.py::_conv_kernel. The TPU
// kernel DMAs one contiguous window of span = tile*K feature rows into VMEM
// per row tile and gathers from it; at tile 512, K = 27 and C = 64 that
// window is 3.5 MB of f32, far beyond the 227 KB of shared memory of one SM,
// so the window is kept here only as the rule that decides which neighbors
// count: neighbor idx of row r counts iff it lies in [base, base + span) with
// base = clamp((r / tile) * tile - window, 0, n - span), from the row's own
// tile and not from the CTA's row chunk. Counted rows are read straight from
// global memory (L2); every other valid index is a miss.
//
// K6 replaces virconv_tpu/ops/pallas/onehot_conv.py::_kernel. The TPU kernel
// gathers each (tile, tap) column with a one-hot matmul over a window of two
// `block`-row blocks starting at blk[tile][tap] * block. A one-hot matmul is
// an exact gather, so here it is a direct row read under the same window
// rule, with features and weights rounded to bf16 when asked (f32 sums).
// Window indices at or past the feature rows (the JAX entry function's
// zero padding) contribute zero and are not misses.
//
// Both kernels: one CTA per (64-row chunk, 64-output-channel slab) with 256
// threads, each thread 4 rows x 4 output channels in registers. The CTA
// resolves the source row of each of its (row, tap) pairs once, then per tap
// stages its gathered rows and W[k] 32 input channels at a time in shared
// memory; a tap that no row of the chunk hits is skipped. Misses are summed
// per row tile in shared memory and added with integer atomics (the same
// counts on every run). Sums run in tap order, then channel order, in f32
// with fmaf (the build passes --fmad=false).
//
// Bound: 2*C*C' operations per in-window (row, tap) hit against one gathered
// row of C values, so compute-bound at the model's widths; this version runs
// the multiply-adds on CUDA cores, not tensor cores.

#include "common.cuh"

namespace {

constexpr int kRows = 64;      // output rows per CTA
constexpr int kCols = 64;      // output channels per CTA
constexpr int kCi = 32;        // input channels staged at once
constexpr int kThreads = 256;  // 16 x 16: 4 rows x 4 channels each
constexpr int kMaxTaps = 64;

// kOneHot selects K6's window (blk table) over K5's (tile position).
template <bool kOneHot>
__device__ __forceinline__ void gather_conv_body(
    const float* __restrict__ feats, const int* __restrict__ nmap,
    const float* __restrict__ weights, const int* __restrict__ blk,
    int n_rows, int n_feat, int c_in, int c_out, int n_taps, int tile,
    long window, long span, long base_max, long block, bool bf16,
    float* __restrict__ out, int* __restrict__ misses) {
  extern __shared__ int src_s[];  // [n_taps][kRows]
  __shared__ float g_s[kRows][kCi + 1];
  __shared__ float w_s[kCi][kCols];
  __shared__ int miss_s[kRows];
  __shared__ int tap_hit[kMaxTaps];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int co0 = blockIdx.y * kCols;
  const int tile0 = row0 / tile;  // the chunk spans at most kRows tiles

  for (int i = tid; i < kRows; i += kThreads) miss_s[i] = 0;
  for (int i = tid; i < n_taps; i += kThreads) tap_hit[i] = 0;
  __syncthreads();

  // 1) the source row of every (row, tap) of the chunk: -1 when missing,
  //    outside the row tile's window, or in the padding past the features
  for (int i = tid; i < kRows * n_taps; i += kThreads) {
    const int r = i / n_taps, k = i - r * n_taps;
    const int row = row0 + r;
    int src = -1;
    if (row < n_rows) {
      const int idx = nmap[(long)row * n_taps + k];
      if (idx >= 0) {
        const int t = row / tile;
        long lo, len;
        if (kOneHot) {
          lo = (long)blk[(long)t * n_taps + k] * block;
          len = 2 * block;
        } else {
          lo = (long)t * tile - window;
          lo = lo < 0 ? 0 : (lo > base_max ? base_max : lo);
          len = span;
        }
        if (idx >= lo && idx < lo + len) {
          if (idx < n_feat) src = idx;
        } else {
          atomicAdd(&miss_s[t - tile0], 1);
        }
      }
    }
    src_s[k * kRows + r] = src;
    if (src >= 0) tap_hit[k] = 1;
  }
  __syncthreads();
  if (blockIdx.y == 0 && tid < kRows && miss_s[tid] != 0)
    atomicAdd(&misses[tile0 + tid], miss_s[tid]);

  // 2) out[rows, slab] = sum over taps and channels, staged per tap
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;

  for (int k = 0; k < n_taps; ++k) {
    if (!tap_hit[k]) continue;  // uniform over the CTA
    const float* wk = weights + (long)k * c_in * c_out;
    const int* src_k = src_s + k * kRows;
    for (int c0 = 0; c0 < c_in; c0 += kCi) {
      const int cn = min(kCi, c_in - c0);
      __syncthreads();  // the previous stage is consumed
      for (int i = tid; i < kRows * kCi; i += kThreads) {
        const int r = i / kCi, c = i - r * kCi;
        const int src = src_k[r];
        g_s[r][c] = (src >= 0 && c < cn)
            ? maybe_bf16(feats[(long)src * c_in + c0 + c], bf16) : 0.0f;
      }
      for (int i = tid; i < kCi * kCols; i += kThreads) {
        const int c = i / kCols, j = i - c * kCols;
        const int co = co0 + j;
        w_s[c][j] = (c < cn && co < c_out)
            ? maybe_bf16(wk[(long)(c0 + c) * c_out + co], bf16) : 0.0f;
      }
      __syncthreads();
      for (int c = 0; c < cn; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = g_s[ty * 4 + r][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = w_s[c][tx + 16 * j];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty * 4 + r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx + 16 * j;
      if (co < c_out) out[(long)row * c_out + co] = acc[r][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads) gather_conv_kernel(
    const float* __restrict__ feats, const int* __restrict__ nmap,
    const float* __restrict__ weights, int n, int c_in, int c_out,
    int n_taps, int tile, float* __restrict__ out,
    int* __restrict__ misses) {
  const long window = (long)tile * (n_taps - 1) / 2;
  const long span = (long)tile * n_taps;
  gather_conv_body<false>(feats, nmap, weights, nullptr, n, n, c_in, c_out,
                          n_taps, tile, window, span, n - span, 0, false, out,
                          misses);
}

__global__ void __launch_bounds__(kThreads) onehot_conv_kernel(
    const float* __restrict__ feats, const int* __restrict__ nmap,
    const float* __restrict__ weights, const int* __restrict__ blk, int n0,
    int c_in, int c_out, int n_taps, int tile, int block, int bf16,
    float* __restrict__ out, int* __restrict__ misses) {
  gather_conv_body<true>(feats, nmap, weights, blk, n0, n0, c_in, c_out,
                         n_taps, tile, 0, 0, 0, block, bf16 != 0, out,
                         misses);
}

dim3 grid_of(int n_rows, int c_out) {
  return dim3((unsigned)((n_rows + kRows - 1) / kRows),
              (unsigned)((c_out + kCols - 1) / kCols));
}

}  // namespace

extern "C" int gather_conv_fwd(const float* feats, const int* nmap,
                               const float* weights, int n, int c_in,
                               int c_out, int n_taps, int tile, float* out,
                               int* misses, cudaStream_t stream) {
  // feats (n, c_in), nmap (n, n_taps), weights (n_taps, c_in, c_out);
  // out (n, c_out); misses (n / tile,) zeroed by the caller.
  if (n_taps < 1 || n_taps > kMaxTaps || tile < 1 || c_out < 1 ||
      n % tile != 0 || (tile * (n_taps - 1)) % 2 != 0 ||
      (long)n < (long)tile * n_taps)
    return -1;
  gather_conv_kernel<<<grid_of(n, c_out), kThreads,
                       n_taps * kRows * sizeof(int), stream>>>(
      feats, nmap, weights, n, c_in, c_out, n_taps, tile, out, misses);
  return (int)cudaGetLastError();
}

extern "C" int onehot_conv_fwd(const float* feats, const int* nmap,
                               const float* weights, const int* blk, int n0,
                               int c_in, int c_out, int n_taps, int tile,
                               int block, int bf16, float* out, int* misses,
                               cudaStream_t stream) {
  // feats (n0, c_in), nmap (n0, n_taps); blk (tiles, n_taps) window start
  // blocks over the padded rows; out (n0, c_out); misses (tiles,) zeroed by
  // the caller.
  if (n_taps < 1 || n_taps > kMaxTaps || tile < 1 || block < 1 ||
      c_out < 1)
    return -1;
  if (n0 == 0) return 0;
  onehot_conv_kernel<<<grid_of(n0, c_out), kThreads,
                       n_taps * kRows * sizeof(int), stream>>>(
      feats, nmap, weights, blk, n0, c_in, c_out, n_taps, tile, block, bf16,
      out, misses);
  return (int)cudaGetLastError();
}
