// Row gather with a repeatable backward, for the ROI pool's gathers in
// training (models/roi_heads/voxel_pool.py::_group_body).
//
// Not a Pallas kernel: the JAX package's gather_rows
// (virconv_tpu/models/roi_heads/voxel_pool.py:50) is a custom_vjp whose
// backward sorts the indices and segment-sums in XLA, the same bits on
// every run. torch's index_select backward is an index_add_, whose CUDA
// kernel adds with atomics in whatever order they land, so two runs of one
// training step gave gradients that differed in their last bits.
//
// gather_rows_fwd: out[i, :] = feats[idx[i], :] * valid[i] (the multiply
// kept on invalid rows, so -0 and non-finite features give index_select x
// mask's bits). Bound: bytes, most of them the (m, c) output, which a
// large pool gather writes at 425 MB beside a 4-7 MB table. A warp per 32
// output rows: lane l reads row l's idx and valid once, and the warp moves
// the rows' 32 * c floats as 16-byte vectors when c % 4 == 0 and the bases
// are 16-byte aligned (else as floats), vector e of the 32 rows by lane
// e % 32, its source row shuffled from the lane that read it (no division
// per element); kFwdUnroll loads in flight before their stores. The table
// is read through the read-only path, the output stored evict-first
// (st.global.cs), so the stream of output lines does not push the table
// out of L2.
//
// The backward adds, for each source row r, the gradient rows of its valid
// gather positions in ascending position order, from 0, with no atomics:
// what a sequential index_add_ does on the CPU, so the two give the same
// values (the invalid positions' gradients are zeros, which it leaves out:
// the pool points every empty slot at one row) and every run the same
// bits. Two calls:
//  - gather_rows_csr builds the CSR on int32 keys: an integer-atomic count
//    of each row's valid positions (the same counts on every run), one CTA's
//    exclusive scan to the offsets in tiles of 8192 rows (it also lists, in
//    row order, the rows of more than kWarpRows positions), a scatter of
//    the positions into their rows (warp-aggregated atomics, so in no set
//    order), then a sort
//    of each row's positions: a warp per row of at most kWarpRows positions
//    (bitonic, in shared memory), a CTA per longer row (bitonic over up to
//    kSortMax, longer rows as sorted runs merged pairwise by rank in global
//    memory). Positions within a row are distinct, so the sorted order is
//    unique: that of a stable sort of idx.
//  - gather_rows_sum adds each row's gradient rows in that order: a warp per
//    row of at most kWarpRows positions (lanes over channels, its positions
//    staged in shared memory, kUnroll loads in flight); a CTA per longer row
//    (hot rows: the pool's densest voxels are gathered thousands of times)
//    stages its positions in shared memory, and 7 warps stream its gradient
//    rows through a ring of kStages stages in shared memory with cp.async,
//    many rows ahead, while one warp adds them in order.
//
// Bound: bytes. The backward reads idx, valid and every gradient row once
// and writes every source row once; the sequential sum of a hot row is a
// chain of dependent adds, which the ring keeps fed from shared memory
// instead of waiting on device memory once per few rows.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 16;       // a warp's gradient loads in flight
constexpr int kWarpRows = 256;    // the longest row a warp sorts and sums
constexpr int kSortMax = 4096;    // the longest run a CTA sorts in shared
constexpr int kLongCtas = 264;    // CTAs over the long rows: two per SM
constexpr int kStageRows = 28;    // gradient rows per ring stage: 7 warps
constexpr int kStages = 8;        // of 32 threads, 8 16-byte chunks a row
constexpr int kPosWindow = 4096;  // a long row's positions staged at once
constexpr int kChans = 32;        // channels per pass of a long row
constexpr int kScanThreads = 1024;
constexpr int kScanPer = 8;       // rows a scan thread takes per tile
constexpr int kFwdUnroll = 8;     // a forward lane's loads in flight

__device__ __forceinline__ float scaled(float x, float s) {
  return __fmul_rn(x, s);
}

__device__ __forceinline__ float4 scaled(float4 x, float s) {
  return make_float4(__fmul_rn(x.x, s), __fmul_rn(x.y, s), __fmul_rn(x.z, s),
                     __fmul_rn(x.w, s));
}

// Vec: float4 or float; v: Vecs per row (c / 4 or c).
template <typename Vec>
__global__ void __launch_bounds__(kThreads) gather_rows_fwd_kernel(
    const Vec* __restrict__ feats, const long long* __restrict__ idx,
    const bool* __restrict__ valid, long long m, int v,
    Vec* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r0 = (blockIdx.x * (long long)kThreads + threadIdx.x -
                        lane);
  if (r0 >= m) return;                 // the whole warp
  const int rows = (int)min(32LL, m - r0);
  long long my_idx = 0;
  float my_keep = 0.0f;
  if (lane < rows) {
    my_idx = idx[r0 + lane];
    my_keep = valid[r0 + lane] ? 1.0f : 0.0f;
  }
  // vector e = lane + 32 * i of the warp's 32 * v: row e / v, column e % v
  const int step_r = 32 / v, step_c = 32 % v;
  int r = lane / v, col = lane - r * v;
  for (int i0 = 0; i0 < v; i0 += kFwdUnroll) {
    Vec x[kFwdUnroll];
    long long dst[kFwdUnroll];
    float keep[kFwdUnroll];
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      dst[u] = -1;
      if (i0 + u < v) {                // uniform across the warp
        const long long src = __shfl_sync(0xffffffffu, my_idx, r & 31);
        keep[u] = __shfl_sync(0xffffffffu, my_keep, r & 31);
        if (r < rows) {
          x[u] = __ldg(feats + src * v + col);
          dst[u] = (r0 + r) * v + col;
        }
        r += step_r;
        col += step_c;
        if (col >= v) {
          col -= v;
          ++r;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u)
      if (dst[u] >= 0) __stcs(out + dst[u], scaled(x[u], keep[u]));
  }
}

// The CSR's scratch, all int32: counts[n] (then the scatter's cursors),
// offsets[n + 1], the long rows' list[n] and its length, order[m], and
// tmp[m] for the merges of rows longer than kSortMax.
struct Csr {
  int *counts, *offsets, *long_rows, *n_long, *order, *tmp;
};

__host__ __device__ inline Csr csr_at(void* scratch, long long m,
                                      long long n) {
  int* p = static_cast<int*>(scratch);
  Csr s;
  s.counts = p;
  s.offsets = s.counts + n;
  s.long_rows = s.offsets + n + 1;
  s.n_long = s.long_rows + n;
  s.order = s.n_long + 1;
  s.tmp = s.order + m;
  return s;
}

// The row of position i when it is valid and in [0, n), else -1.
__device__ __forceinline__ int key_of(const long long* __restrict__ idx,
                                      const bool* __restrict__ valid,
                                      long long i, long long m, long long n) {
  if (i >= m || !valid[i]) return -1;
  const long long r = idx[i];
  return r >= 0 && r < n ? (int)r : -1;
}

// counts[r] += the valid positions of row r: one atomic per row and warp.
__global__ void __launch_bounds__(kThreads) csr_count_kernel(
    const long long* __restrict__ idx, const bool* __restrict__ valid,
    long long m, long long n, int* __restrict__ counts) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  const int key = key_of(idx, valid, i, m, n);
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&counts[key], __popc(peers));
}

// Exclusive scan of v over the CTA's kScanThreads threads; *total gets
// the sum. sums: kScanThreads / 32 shared values.
__device__ __forceinline__ unsigned long long block_scan(
    unsigned long long v, unsigned long long* sums,
    unsigned long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned long long w = sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    sums[lane] = w;
  }
  __syncthreads();
  const unsigned long long out = (warp ? sums[warp - 1] : 0) + x - v;
  *total = sums[kScanThreads / 32 - 1];
  __syncthreads();
  return out;
}

// One CTA: offsets = exclusive scan of counts (offsets[n] = the valid
// positions), counts zeroed for the scatter, and the rows of more than
// kWarpRows positions listed in row order. Tiles of kScanThreads *
// kScanPer rows, thread t the kScanPer rows from t * kScanPer; the scan
// carries each tile's position count (low 32 bits: a tile's count is at
// most m < 2^31) and long-row count (high 32 bits) in one 64-bit value.
__global__ void __launch_bounds__(kScanThreads) csr_scan_kernel(
    Csr s, long long n) {
  __shared__ unsigned long long sums[kScanThreads / 32];
  long long carry_pos = 0;
  int carry_long = 0;
  for (long long base = 0; base < n; base += kScanThreads * kScanPer) {
    const long long r0 = base + (long long)threadIdx.x * kScanPer;
    int c[kScanPer];
    unsigned pos = 0, longs = 0;
#pragma unroll
    for (int u = 0; u < kScanPer; ++u) {
      c[u] = r0 + u < n ? s.counts[r0 + u] : 0;
      pos += c[u];
      longs += c[u] > kWarpRows;
    }
    unsigned long long total;
    const unsigned long long ex = block_scan(
        (unsigned long long)longs << 32 | pos, sums, &total);
    long long p = carry_pos + (long long)(ex & 0xffffffffu);
    int q = carry_long + (int)(ex >> 32);
#pragma unroll
    for (int u = 0; u < kScanPer; ++u) {
      if (r0 + u >= n) break;
      s.offsets[r0 + u] = (int)p;
      p += c[u];
      if (c[u] > kWarpRows) s.long_rows[q++] = (int)(r0 + u);
      s.counts[r0 + u] = 0;
    }
    carry_pos += (long long)(total & 0xffffffffu);
    carry_long += (int)(total >> 32);
  }
  if (threadIdx.x == 0) {
    s.offsets[n] = (int)carry_pos;
    *s.n_long = carry_long;
  }
}

// Each valid position into its row's range of order, in no set order
// within the row (warp-aggregated cursors).
__global__ void __launch_bounds__(kThreads) csr_scatter_kernel(
    const long long* __restrict__ idx, const bool* __restrict__ valid,
    long long m, long long n, Csr s) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  const int key = key_of(idx, valid, i, m, n);
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  int base = 0;
  if (key >= 0 && lane == leader)
    base = atomicAdd(&s.counts[key], __popc(peers));
  base = __shfl_sync(peers, base, leader);
  if (key >= 0)
    s.order[s.offsets[key] + base +
            __popc(peers & ((1u << lane) - 1u))] = (int)i;
}

// Waits until at most N committed cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_all_but() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bitonic sort, ascending, of the p (a power of two) values at v by the
// nt threads of which this is thread t; sync() between steps.
template <typename Sync>
__device__ __forceinline__ void bitonic_sort(int* v, int p, int t, int nt,
                                             Sync sync) {
  for (int k = 2; k <= p; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = t; i < p / 2; i += nt) {
        const int a = (i / j) * 2 * j + (i % j), b = a + j;
        const int x = v[a], y = v[b];
        if ((x > y) == ((a & k) == 0)) {
          v[a] = y;
          v[b] = x;
        }
      }
      sync();
    }
}

__device__ __forceinline__ int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// A warp per row of 2 .. kWarpRows positions sorts them in shared memory.
__global__ void __launch_bounds__(kThreads) csr_sort_warp_kernel(
    Csr s, long long n) {
  __shared__ int buf[kThreads / 32][kWarpRows];
  const long long row = (blockIdx.x * (long long)kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int lo = s.offsets[row], len = s.offsets[row + 1] - lo;
  if (len < 2 || len > kWarpRows) return;
  int* v = buf[threadIdx.x >> 5];
  const int p = pow2_at_least(len);
  for (int i = lane; i < p; i += 32)
    v[i] = i < len ? s.order[lo + i] : 0x7fffffff;
  __syncwarp();
  bitonic_sort(v, p, lane, 32, [] { __syncwarp(); });
  for (int i = lane; i < len; i += 32) s.order[lo + i] = v[i];
}

// The CTAs over the long rows (more than kWarpRows positions): each sorts
// runs of up to kSortMax positions in shared memory, then merges the runs
// pairwise, each position going to its rank (its index in its run plus
// the count of smaller positions in the other run) in tmp and back.
__global__ void __launch_bounds__(kThreads) csr_sort_long_kernel(Csr s) {
  __shared__ int v[kSortMax];
  const int t = threadIdx.x;
  const int n_long = *s.n_long;
  for (int j = blockIdx.x; j < n_long; j += gridDim.x) {
    const int row = s.long_rows[j];
    const int lo = s.offsets[row], len = s.offsets[row + 1] - lo;
    int* seg = s.order + lo;
    for (int r0 = 0; r0 < len; r0 += kSortMax) {
      const int rl = min(kSortMax, len - r0);
      const int p = pow2_at_least(rl);
      for (int i = t; i < p; i += kThreads)
        v[i] = i < rl ? seg[r0 + i] : 0x7fffffff;
      __syncthreads();
      bitonic_sort(v, p, t, kThreads, [] { __syncthreads(); });
      for (int i = t; i < rl; i += kThreads) seg[r0 + i] = v[i];
      __syncthreads();
    }
    int* src = seg;
    int* dst = s.tmp + lo;
    for (int w = kSortMax; w < len; w *= 2) {
      for (int i = t; i < len; i += kThreads) {
        const int a0 = i / (2 * w) * (2 * w);
        const int mid = min(a0 + w, len), end = min(a0 + 2 * w, len);
        const int x = src[i];
        const bool in_a = i < mid;
        int lo2 = in_a ? mid : a0, hi2 = in_a ? end : mid;
        while (lo2 < hi2) {   // lower bound of x in the other run
          const int h = (lo2 + hi2) >> 1;
          if (src[h] < x) lo2 = h + 1; else hi2 = h;
        }
        const int rank = in_a ? (i - a0) + (lo2 - mid)
                              : (i - mid) + (lo2 - a0);
        dst[a0 + rank] = x;
      }
      __syncthreads();
      int* swap = src;
      src = dst;
      dst = swap;
    }
    if (src != seg) {
      for (int i = t; i < len; i += kThreads) seg[i] = src[i];
      __syncthreads();
    }
  }
}

// A warp per row of at most kWarpRows positions (0 included: zeros):
// lanes over channels, the row's positions staged in shared memory, its
// gradient rows added in order with kUnroll loads in flight.
__global__ void __launch_bounds__(kThreads) rows_sum_warp_kernel(
    const float* __restrict__ g, Csr s, long long n, int c,
    float* __restrict__ dfeats) {
  __shared__ int buf[kThreads / 32][kWarpRows];
  const long long row = (blockIdx.x * (long long)kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int lo = s.offsets[row], len = s.offsets[row + 1] - lo;
  if (len > kWarpRows) return;
  int* pos = buf[threadIdx.x >> 5];
  for (int i = lane; i < len; i += 32) pos[i] = s.order[lo + i];
  __syncwarp();
  for (int ch = lane; ch < c; ch += 32) {
    float acc = 0.0f;
    int j = 0;
    for (; j + kUnroll <= len; j += kUnroll) {
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        x[u] = g[(long long)pos[j + u] * c + ch];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, x[u]);
    }
    for (; j < len; ++j) acc = __fadd_rn(acc, g[(long long)pos[j] * c + ch]);
    dfeats[row * c + ch] = acc;
  }
}

// The CTAs over the long rows: for each kChans-channel slab of a long row,
// each window of up to kPosWindow of its positions is staged in shared
// memory; warps 1-7 copy its gradient rows' slab, kStageRows rows a stage,
// into a ring of kStages stages with cp.async (thread (r, q) the 16-byte
// chunk q of row r; 4-byte copies when rows are not 16-byte aligned), and
// warp 0 adds them in order, lane l the slab's channel l.
__global__ void __launch_bounds__(kThreads) rows_sum_long_kernel(
    const float* __restrict__ g, Csr s, int c, int vec4,
    float* __restrict__ dfeats) {
  __shared__ __align__(16) float ring[kStages][kStageRows][kChans];
  __shared__ int pos[kPosWindow];
  const int t = threadIdx.x, lane = t & 31;
  const bool consumer = t < 32;
  const int p = t - 32;                      // producer index, 0..223
  const int pr = p >> 3, pq = (p & 7) * 4;   // its row in a stage, channel
  const int n_long = *s.n_long;
  for (int j = blockIdx.x; j < n_long; j += gridDim.x) {
    const long long row = s.long_rows[j];
    const int lo = s.offsets[row], len = s.offsets[row + 1] - lo;
    for (int c0 = 0; c0 < c; c0 += kChans) {
      float acc = 0.0f;
      for (int w0 = 0; w0 < len; w0 += kPosWindow) {
        const int wl = min(kPosWindow, len - w0);
        __syncthreads();   // the previous window's positions are consumed
        for (int i = t; i < wl; i += kThreads) pos[i] = s.order[lo + w0 + i];
        __syncthreads();
        const int n_st = (wl + kStageRows - 1) / kStageRows;
        auto issue = [&](int st) {   // stage st of the window, this chunk
          const int r = st * kStageRows + pr;
          float* dst = &ring[st % kStages][pr][pq];
          const int ch = c0 + pq;
          const float* src =
              r < wl ? g + (long long)pos[r] * c + ch : g;
          if (vec4) {
            cp_async16_ca(dst, r < wl && ch < c ? src : g,
                          r < wl && ch < c ? 16 : 0);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              cp_async4(dst + e, r < wl && ch + e < c ? src + e : g,
                        r < wl && ch + e < c ? 4 : 0);
          }
        };
        for (int st = 0; st < kStages - 1; ++st) {   // one group a stage
          if (!consumer && st < n_st) issue(st);
          cp_async_commit();
        }
        for (int st = 0; st < n_st; ++st) {
          if (!consumer && st + kStages - 1 < n_st) issue(st + kStages - 1);
          cp_async_commit();
          cp_async_wait_all_but<kStages - 1>();
          __syncthreads();
          if (consumer) {
            const int rows = min(kStageRows, wl - st * kStageRows);
            const float* x = &ring[st % kStages][0][lane];
#pragma unroll
            for (int r = 0; r < kStageRows; ++r)
              if (r < rows) acc = __fadd_rn(acc, x[r * kChans]);
          }
          __syncthreads();
        }
      }
      if (consumer && c0 + lane < c) dfeats[row * c + c0 + lane] = acc;
    }
  }
}

}  // namespace

extern "C" int gather_rows_fwd(const float* feats, const long long* idx,
                               const bool* valid, long long m, int c,
                               float* out, cudaStream_t stream) {
  // feats (n, c) f32, idx (m,) int64 in [0, n), valid (m,) bool; out
  // (m, c).
  if (m < 0 || c < 1) return -1;
  if (m == 0) return 0;
  const unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  if (c % 4 == 0 && (uintptr_t)feats % 16 == 0 && (uintptr_t)out % 16 == 0)
    gather_rows_fwd_kernel<<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(feats), idx, valid, m, c / 4,
        reinterpret_cast<float4*>(out));
  else
    gather_rows_fwd_kernel<<<blocks, kThreads, 0, stream>>>(
        feats, idx, valid, m, c, out);
  return (int)cudaGetLastError();
}

extern "C" long long gather_rows_csr_scratch_bytes(long long m,
                                                   long long n) {
  // the CSR's int32 scratch (struct Csr) for m positions and n rows
  return (3 * n + 2 + 2 * m) * (long long)sizeof(int);
}

extern "C" int gather_rows_csr(const long long* idx, const bool* valid,
                               long long m, long long n, void* scratch,
                               cudaStream_t stream) {
  // idx (m,) int64, valid (m,) bool; scratch holds
  // gather_rows_csr_scratch_bytes(m, n) bytes. Afterwards the int32
  // offsets (n + 1,) start at scratch + n ints and the order (m,) at
  // scratch + 3n + 2 ints: row r's valid positions ascending at
  // order[offsets[r]:offsets[r + 1]] (positions whose index is outside
  // [0, n) are left out, as invalid ones are).
  if (m < 0 || n < 0 || m >= (1LL << 31) || n >= (1LL << 31)) return -1;
  const Csr s = csr_at(scratch, m, n);
  int err = (int)cudaMemsetAsync(s.counts, 0, n * sizeof(int), stream);
  if (err != 0) return err;
  const unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  if (m > 0) {
    csr_count_kernel<<<blocks, kThreads, 0, stream>>>(idx, valid, m, n,
                                                      s.counts);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  csr_scan_kernel<<<1, kScanThreads, 0, stream>>>(s, n);
  err = (int)cudaGetLastError();
  if (err != 0 || m == 0 || n == 0) return err;
  csr_scatter_kernel<<<blocks, kThreads, 0, stream>>>(idx, valid, m, n, s);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  csr_sort_warp_kernel<<<(unsigned)((n * 32 + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(s, n);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  csr_sort_long_kernel<<<kLongCtas, kThreads, 0, stream>>>(s);
  return (int)cudaGetLastError();
}

extern "C" int gather_rows_sum(const float* g, void* scratch, long long m,
                               long long n, int c, float* dfeats,
                               cudaStream_t stream) {
  // g (m, c) f32; scratch the CSR gather_rows_csr built for m positions
  // and n rows; dfeats (n, c), every row written (0 where a row has no
  // valid position).
  if (m < 0 || n < 0 || c < 1) return -1;
  if (n == 0) return 0;
  const Csr s = csr_at(scratch, m, n);
  rows_sum_warp_kernel<<<(unsigned)((n * 32 + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(g, s, n, c, dfeats);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int vec4 = c % 4 == 0 && (uintptr_t)g % 16 == 0;
  rows_sum_long_kernel<<<kLongCtas, kThreads, 0, stream>>>(g, s, c, vec4,
                                                           dfeats);
  return (int)cudaGetLastError();
}
