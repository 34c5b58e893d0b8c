// Row gather with a repeatable backward, for the ROI pool's gathers in
// training (models/roi_heads/voxel_pool.py::_group_body).
//
// Not a Pallas kernel: the JAX package's gather_rows
// (virconv_tpu/models/roi_heads/voxel_pool.py:50) is a custom_vjp whose
// backward sorts the indices and segment-sums in XLA, the same bits on
// every run. torch's index_select backward is an
// index_add_, whose CUDA kernel adds with atomics in whatever order they
// land, so two runs of one training step gave gradients that differed in
// their last bits. Here:
//  - gather_rows_fwd: out[i, :] = feats[idx[i], :] * valid[i], one thread
//    per element, neighbouring threads on neighbouring channels
//    (coalesced);
//  - gather_rows_bwd: the wrapper lists, for each source row r, its valid
//    gather positions in ascending order (a stable sort of idx with the
//    invalid positions sent past the last row, offsets from the counts: a
//    CSR); one warp per source row sums those gradient rows in that order,
//    lanes over channels, in f32, with no atomics. Starting from 0 and
//    adding in ascending position order is what a sequential index_add_
//    does on the CPU, so the two give the same values (the invalid
//    positions' gradients are zeros, which the CSR leaves out), and every
//    run gives the same bits. Leaving them out matters: the pool points
//    every empty slot at one row, which would otherwise be one warp's
//    sequential sum over most of the positions.
//
// Bound: bytes. The forward reads idx and the gathered rows and writes
// them; the backward reads every gradient row once plus the CSR and
// writes every source row once. A row gathered many times is summed by
// one warp in sequence: its loads are issued kUnroll at a time ahead of
// the in-order adds, so the warp waits on memory once per kUnroll rows.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads) gather_rows_fwd_kernel(
    const float* __restrict__ feats, const long long* __restrict__ idx,
    const bool* __restrict__ valid, long long total, int c,
    float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= total) return;
  const long long r = i / c;
  const int ch = (int)(i - r * c);
  out[i] = __fmul_rn(feats[idx[r] * c + ch], valid[r] ? 1.0f : 0.0f);
}

__global__ void __launch_bounds__(kThreads) gather_rows_bwd_kernel(
    const float* __restrict__ g, const long long* __restrict__ order,
    const long long* __restrict__ offsets, long long n, int c,
    float* __restrict__ dfeats) {
  const long long row =
      (blockIdx.x * (long long)kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const long long lo = offsets[row], hi = offsets[row + 1];
  for (int ch = lane; ch < c; ch += 32) {
    float acc = 0.0f;
    long long j = lo;
    for (; j + kUnroll <= hi; j += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = g[order[j + u] * c + ch];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, v[u]);
    }
    for (; j < hi; ++j) acc = __fadd_rn(acc, g[order[j] * c + ch]);
    dfeats[row * c + ch] = acc;
  }
}

}  // namespace

extern "C" int gather_rows_fwd(const float* feats, const long long* idx,
                               const bool* valid, long long m, int c,
                               float* out, cudaStream_t stream) {
  // feats (n, c) f32, idx (m,) int64 in [0, n), valid (m,) bool; out
  // (m, c).
  if (m < 0 || c < 1) return -1;
  const long long total = m * c;
  if (total == 0) return 0;
  gather_rows_fwd_kernel<<<(unsigned)((total + kThreads - 1) / kThreads),
                           kThreads, 0, stream>>>(feats, idx, valid, total,
                                                  c, out);
  return (int)cudaGetLastError();
}

extern "C" int gather_rows_bwd(const float* g, const long long* order,
                               const long long* offsets, long long n, int c,
                               float* dfeats, cudaStream_t stream) {
  // g (m, c) f32; order (m,) the gather positions sorted by source row,
  // ascending within a row; offsets (n + 1,) each source row's range of
  // order (the invalid positions lie past offsets[n]); dfeats (n, c), every
  // row written (0 where a row has no valid position).
  if (n < 0 || c < 1) return -1;
  if (n == 0) return 0;
  const long long threads = n * 32;
  gather_rows_bwd_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                           kThreads, 0, stream>>>(g, order, offsets, n, c,
                                                  dfeats);
  return (int)cudaGetLastError();
}
