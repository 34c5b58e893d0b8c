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
// Both take K1's gathered-row conv (common.cuh) once their sources are read
// from nmap under their window rule into a shared (tap, row) source table:
//  - row mode (C <= 8, C' <= 16): a thread per output row of a 128-row
//    CTA sums only the taps its row hits, against every tap's weights
//    resident in shared memory (a 16-row fragment of a narrow layer hits
//    most taps while each of its rows hits 2-4 of 27);
//  - tile mode (other inputs of at most kMaxCin channels): a 64-row CTA
//    with an output slab fitted to C' (at most 64 columns), per-16-row-
//    fragment tap masks, the hit rows copied with cp.async into a ring
//    beside W[k]'s slab tile. bf16 operands: A fragments rounded in
//    registers and mma.sync m16n8k16 against W[k]^T rounded and transposed
//    once per call by the prep kernel; f32 operands: fmaf on CUDA cores.
// Either way the sums run in tap then channel order (f32: fmaf, the build
// passes --fmad=false), so on rows whose sources are K1's, K5 and K6 with
// f32 operands give K1's f32 bits.
//
// Inputs wider than kMaxCin take the fma mode: one CTA per
// (64-row chunk, 64-output-channel slab) with 256 threads, each thread 4
// rows x 4 output channels in registers, gathered rows and W[k] staged 32
// input channels at a time. The caller picks the mode
// (ops/gather_conv.py::kernel_mode); the entry points refuse any other.
//
// The exact conv from a neighbor map (nmap_conv_fwd, ops/nmap_conv.py: the
// eval convs of a context on the neighbor map, and the training
// neighbor-map conv's forward and input gradient) has K5's rule with one
// window over every feature row: n_out output rows, each neighbor index of
// the n_in feature rows counts, and an index at or past n_in is a miss. It
// replaces the JAX package's XLA gather + matmul
// (virconv_tpu/ops/sparse.py::gathered_conv, ::gathered_conv_train). Its
// row and fma modes are K5's; its tile mode has a body of its own
// (nmap_tile_kernel): each tap's hit rows compacted into dense fragments,
// the rows' sums in shared memory, the same bits as K5's body. Bound: 2*C*C'
// operations per (row, tap) hit at the f32 peak; K5's body spends a
// fragment's product on every tap any of its 16 rows hits (1.6-2.6 rows
// per hit at the 3D eval layers, 3-8 at the strided training maps; the
// redesign 1.1-1.5 and 1.4-3.5). nmap_conv_fwd_prev keeps
// K5's body for the tile mode as well: it runs on no path, and is there to
// hold the redesign to it bit for bit on the card.
//
// All kernels count misses per row tile in shared memory and add them with
// integer atomics (the same counts on every run).
//
// Bound: 2*C*C' operations per in-window (row, tap) hit against one gathered
// row of C values: the f32 operations for f32 operands (CUDA cores), the
// bytes of the inputs for K6's bf16 operands on the tensor cores.

#include "common.cuh"

namespace {

constexpr int kRows = 64;      // fma mode: output rows per CTA
constexpr int kCols = 64;      // output channels per CTA
constexpr int kCi = 32;        // input channels staged at once
constexpr int kThreads = 256;  // 16 x 16: 4 rows x 4 channels each
constexpr int kMaxTaps = 64;
constexpr int kMaxCin = 128;   // row and tile modes: widest input row
constexpr int kModeFma = 0;    // the modes (ops/gather_conv.py)
constexpr int kModeTile = 1;
constexpr int kModeRow = 2;

// The window rule of one call: K5's one window [base, base + span) per row
// tile, base = clamp(tile index * tile - window, 0, base_max); or K6's
// two-block window per (row tile, tap) from blk.
struct Window {
  long window, span, base_max;  // K5
  const int* blk;               // K6
  int block;
};

// The source row of (row, tap k) of a row below n_feat: -1 when the
// neighbor is missing, at or past the n_feat feature rows (K6's zero
// padding, not a miss) or outside the tile's window (a miss, counted in
// miss_s[row / tile - tile0]). kOneHot selects K6's rule over K5's.
template <bool kOneHot>
__device__ __forceinline__ int window_source(const int* __restrict__ nmap,
                                             const Window& w, int row, int k,
                                             int n_taps, int n_feat, int tile,
                                             int tile0, int* miss_s) {
  const int idx = nmap[(long)row * n_taps + k];
  if (idx < 0) return -1;
  const int t = row / tile;
  long lo, len;
  if (kOneHot) {
    lo = (long)w.blk[(long)t * n_taps + k] * w.block;
    len = 2L * w.block;
  } else {
    lo = (long)t * tile - w.window;
    lo = lo < 0 ? 0 : (lo > w.base_max ? w.base_max : lo);
    len = w.span;
  }
  if (idx >= lo && idx < lo + len)
    return kOneHot && idx >= n_feat ? -1 : idx;   // K5's windows end at n
  atomicAdd(&miss_s[t - tile0], 1);
  return -1;
}

// Fills the CTA's (tap, row) source table src_s[k * n_cta + r] for its
// n_cta rows from row0 (nmap read in order), then adds the miss counts
// (miss_s[n_cta], zeroed and synced by the caller) once per row slab.
template <bool kOneHot>
__device__ __forceinline__ void fill_sources(
    int* src_s, int n_cta, int nt, const int* __restrict__ nmap,
    const Window& w, int row0, int n_rows, int n_taps, int tile, int* miss_s,
    int* __restrict__ misses) {
  const int tid = threadIdx.x;
  const int tile0 = row0 / tile;   // the CTA spans at most n_cta row tiles
  for (int i = tid; i < n_cta * n_taps; i += nt) {
    const int r = i / n_taps, k = i - r * n_taps;
    const int row = row0 + r;
    src_s[k * n_cta + r] = row < n_rows ? window_source<kOneHot>(
        nmap, w, row, k, n_taps, n_rows, tile, tile0, miss_s) : -1;
  }
  __syncthreads();
  if (blockIdx.y == 0)
    for (int i = tid; i < n_cta; i += nt)
      if (miss_s[i] != 0) atomicAdd(&misses[tile0 + i], miss_s[i]);
}

// fma mode (inputs wider than kMaxCin): CTA (64 rows, 64 output channels).
template <bool kOneHot>
__global__ void __launch_bounds__(kThreads) windowed_fma_kernel(
    const float* __restrict__ feats, const int* __restrict__ nmap, Window w,
    const float* __restrict__ weights, int n_rows, int c_in, int c_out,
    int n_taps, int tile, int bf16, float* __restrict__ out,
    int* __restrict__ misses) {
  extern __shared__ int src_s[];  // [n_taps][kRows]
  __shared__ float g_s[kRows][kCi + 1];
  __shared__ float w_s[kCi][kCols];
  __shared__ int miss_s[kRows];
  __shared__ int tap_hit[kMaxTaps];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int co0 = blockIdx.y * kCols;

  for (int i = tid; i < kRows; i += kThreads) miss_s[i] = 0;
  for (int i = tid; i < n_taps; i += kThreads) tap_hit[i] = 0;
  __syncthreads();

  // 1) the source row of every (row, tap) of the chunk, and the taps hit
  fill_sources<kOneHot>(src_s, kRows, kThreads, nmap, w, row0, n_rows,
                        n_taps, tile, miss_s, misses);
  for (int i = tid; i < kRows * n_taps; i += kThreads)
    if (src_s[i] >= 0) tap_hit[i / kRows] = 1;
  __syncthreads();

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

// Tile mode: CTA (64 rows, output slab). kNT: the most 8-channel column
// tiles of a slab this instantiation takes.
template <bool kOneHot, bool kBf16, int kNT>
__global__ void __launch_bounds__(kTileThreads) windowed_tile_kernel(
    const float* __restrict__ feats, const int* __restrict__ nmap, Window w,
    const void* __restrict__ wprep, int n_rows, int c_in, int c_out,
    int n_taps, int tile, int vec4, float* __restrict__ out,
    int* __restrict__ misses) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tap_mask[kMaxTaps];   // bit f: fragment f has a hit
  __shared__ int tap_list[kMaxTaps];   // taps with any hit, in tap order
  __shared__ int n_active;
  __shared__ int miss_s[kTileRows];
  const Layout L = layout_of(c_in, c_out, n_taps, 0, 0, kBf16);
  int* src_s = reinterpret_cast<int*>(smem);   // [K][kTileRows]
  const int row0 = blockIdx.x * kTileRows;
  const int s0 = blockIdx.y * L.slab;
  if (threadIdx.x < kTileRows) miss_s[threadIdx.x] = 0;
  __syncthreads();
  // 1) the source of every (row, tap) of the CTA
  fill_sources<kOneHot>(src_s, kTileRows, kTileThreads, nmap, w, row0,
                        n_rows, n_taps, tile, miss_s, misses);
  // 2) the taps each 16-row fragment hits and the ring over them
  float acc[4 * kNT];
  tile_sums<kBf16, kNT>(acc, src_s, smem + L.area_off, L, feats, c_in, vec4,
                        wprep, s0, n_taps, tap_mask, tap_list, n_active);
  tile_store<kBf16, kNT>(acc, L, s0, [&](int rl, int co, float v) {
    const int row = row0 + rl;
    if (row < n_rows && co < c_out) out[(long)row * c_out + co] = v;
  });
}

// Row mode (C <= 8, C' <= kCout): a thread per output row; the CTA's
// sources go to a shared (tap, row) table, then each thread sums its hit
// taps against the resident weights.
template <bool kOneHot, bool kBf16, int kCout>
__global__ void __launch_bounds__(kRowThreads) windowed_row_kernel(
    const float* __restrict__ feats, const int* __restrict__ nmap, Window w,
    const float* __restrict__ wprep, int n_rows, int c_in, int c_out,
    int n_taps, int tile, int vec4, float* __restrict__ out,
    int* __restrict__ misses) {
  extern __shared__ __align__(16) float w_s[];  // (K, c_in, kCout), then
                                                // the sources [K][128]
  __shared__ int miss_s[kRowThreads];
  int* src_s = reinterpret_cast<int*>(w_s + n_taps * c_in * kCout);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRowThreads;
  for (int i = tid; i < n_taps * c_in * kCout; i += kRowThreads)
    w_s[i] = wprep[i];
  miss_s[tid] = 0;
  __syncthreads();
  fill_sources<kOneHot>(src_s, kRowThreads, kRowThreads, nmap, w, row0,
                        n_rows, n_taps, tile, miss_s, misses);
  const int row = row0 + tid;
  if (row >= n_rows) return;
  float acc[kCout];
  row_sums<kBf16, kCout>(acc, src_s, n_taps, feats, c_in, vec4, w_s);
#pragma unroll
  for (int j = 0; j < kCout; ++j) {
    if (j >= c_out) break;
    out[(long)row * c_out + j] = acc[j];
  }
}

// ---- the neighbor-map conv's tile mode (nmap_conv_fwd) ---------------------

constexpr int kSumsPad = 4;   // floats past the slab in a row of the sums

// Shared memory of nmap_tile_kernel: the (tap, row) source table, compacted
// in place per tap; the CTA row of each compacted slot (one byte); the
// rows' running sums (64 x (slab + kSumsPad) f32); the ring.
struct NmapLayout {
  long row_off, sums_off, ring_off, smem;
};

__host__ __device__ inline NmapLayout nmap_layout_of(const Layout& l,
                                                  int n_taps) {
  NmapLayout m;
  m.row_off = (long)kTileRows * n_taps * sizeof(int);
  m.sums_off = (m.row_off + (long)kTileRows * n_taps + 15) / 16 * 16;
  m.ring_off = m.sums_off + (long)kTileRows * (l.slab + kSumsPad) * 4;
  m.smem = m.ring_off + (long)l.n_stages * l.tile_pitch;
  return m;
}

// acc += (16 gathered rows) @ kNJ column tiles of one tap's f32 weight
// tile for the calling lane: ap points at the lane's first row (row ty of
// the fragment), wf at its first column (tx + 8 j0); acc[kNJ r + j] = row
// ty + 4r, column tx + 8(j0 + j). tap_product's f32 branch with its column
// tiles cut to [j0, j0 + kNJ): each element sees the same fmaf chain, in
// channel order, and no lane multiplies a column tile it does not own.
template <int kNJ>
__device__ __forceinline__ void frag_product(float* acc, const float* ap,
                                             const float* wf, int slab,
                                             int a_stride, int c_end) {
  for (int c = 0; c < c_end; c += 4) {
    float4 av[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      av[r] = *reinterpret_cast<const float4*>(ap + 4 * r * a_stride + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float bv[kNJ];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) bv[j] = wf[(c + cc) * slab + 8 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = cc == 0 ? av[r].x : cc == 1 ? av[r].y
                      : cc == 2 ? av[r].z : av[r].w;
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
          acc[kNJ * r + j] = fmaf(x, bv[j], acc[kNJ * r + j]);
      }
    }
  }
}

// One warp's unit of a tap: fragment f (compacted slots 16f .. 16f + 15 of
// the tap's n hit rows, rows_k their CTA rows) times column tiles
// [j0, j0 + kNJ): the slots' running sums loaded from shared memory, the
// product, the sums stored back (pad slots past n are neither).
template <int kNJ>
__device__ __forceinline__ void frag_unit(float* sums, int pitch,
                                          const unsigned char* rows_k, int n,
                                          int f, int j0, const float* a,
                                          const float* w, const Layout& L,
                                          int c_end, int lane) {
  const int ty = lane >> 3, tx = lane & 7;
  int off[4];   // shared offset of each of the lane's 4 rows' sums, or -1
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int slot = 16 * f + ty + 4 * r;
    off[r] = slot < n ? rows_k[slot] * pitch + tx + 8 * j0 : -1;
  }
  float acc[4 * kNJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      acc[kNJ * r + j] = off[r] >= 0 ? sums[off[r] + 8 * j] : 0.0f;
  frag_product<kNJ>(acc, a + (16 * f + ty) * L.a_stride, w + tx + 8 * j0,
                    L.slab, L.a_stride, c_end);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      if (off[r] >= 0) sums[off[r] + 8 * j] = acc[kNJ * r + j];
}

// frag_unit with kNJ = nj (1 <= nj <= kMax), instantiated for each width.
template <int kMax>
__device__ __forceinline__ void frag_dispatch(int nj, float* sums, int pitch,
                                              const unsigned char* rows_k,
                                              int n, int f, int j0,
                                              const float* a, const float* w,
                                              const Layout& L, int c_end,
                                              int lane) {
  if (nj == kMax) {
    frag_unit<kMax>(sums, pitch, rows_k, n, f, j0, a, w, L, c_end, lane);
  } else if constexpr (kMax > 1) {
    frag_dispatch<kMax - 1>(nj, sums, pitch, rows_k, n, f, j0, a, w, L,
                            c_end, lane);
  }
}

// The exact conv from a neighbor map, tile mode: CTA (64 rows, output
// slab). K5's tile body multiplies a whole 16-row fragment by W[k] when any
// of its rows hits tap k; here each tap's hit rows are first compacted
// (ballots and prefix counts, in row order) into dense 16-row fragments,
// only those rows are copied into the ring and multiplied. A row then sits
// in another fragment slot at each tap, so the rows' sums live in shared
// memory keyed by row: per tap a warp loads its slots' sums into
// registers, runs the channel loop and stores them back. The tap's
// fragments are spread over the 4 warps (1 fragment: a quarter of the
// slab's column tiles each; 2: halves; 3 or 4: one each). Each output
// element sees the fmaf chain of K5's body in tap then channel order, less
// its zero rows' products (x = 0: they add +0), so the outputs are K5's,
// and K1's f32 rows, bit for bit (apart from a sum of -0, which a zero
// row's product turns into +0 there: only products below 2^-149 give one).
template <int kNT>
__global__ void __launch_bounds__(kTileThreads) nmap_tile_kernel(
    const float* __restrict__ feats, const int* __restrict__ nmap, Window w,
    const void* __restrict__ wprep, int n_rows, int c_in, int c_out,
    int n_taps, int vec4, float* __restrict__ out,
    int* __restrict__ misses) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_hit[kMaxTaps];      // hit rows of each tap
  __shared__ int tap_list[kMaxTaps];   // taps with any hit, in tap order
  __shared__ int n_active;
  __shared__ int miss_s[kTileRows];
  const Layout L = layout_of(c_in, c_out, n_taps, 0, 0, false);
  const NmapLayout M = nmap_layout_of(L, n_taps);
  int* src_s = reinterpret_cast<int*>(smem);         // [K][kTileRows]
  unsigned char* row_s = smem + M.row_off;           // [K][kTileRows]
  float* sums = reinterpret_cast<float*>(smem + M.sums_off);
  unsigned char* ring = smem + M.ring_off;
  const int pitch = L.slab + kSumsPad;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kTileRows;
  const int s0 = blockIdx.y * L.slab;
  if (tid < kTileRows) miss_s[tid] = 0;
  for (int i = tid; i < kTileRows * pitch; i += kTileThreads) sums[i] = 0.0f;
  __syncthreads();
  // 1) the source of every (row, tap) of the CTA
  fill_sources<false>(src_s, kTileRows, kTileThreads, nmap, w, row0, n_rows,
                      n_taps, n_rows, miss_s, misses);
  // 2) per tap (a warp each), its hit rows compacted in row order in place:
  //    slot p holds the source and the CTA row of the p-th hit row; the
  //    slots up to the next multiple of 16 get -1 (rows of zeros)
  const unsigned below = (1u << lane) - 1u;
  for (int k = warp; k < n_taps; k += kTileThreads / 32) {
    int* sk = src_s + k * kTileRows;
    const int v0 = sk[lane], v1 = sk[32 + lane];
    const unsigned m0 = __ballot_sync(0xffffffffu, v0 >= 0);
    const unsigned m1 = __ballot_sync(0xffffffffu, v1 >= 0);
    const int n0 = __popc(m0), n = n0 + __popc(m1);
    __syncwarp();
    if (v0 >= 0) {
      const int p = __popc(m0 & below);
      sk[p] = v0;
      row_s[k * kTileRows + p] = (unsigned char)lane;
    }
    if (v1 >= 0) {
      const int p = n0 + __popc(m1 & below);
      sk[p] = v1;
      row_s[k * kTileRows + p] = (unsigned char)(32 + lane);
    }
    __syncwarp();
    if (n + lane < ((n + 15) & ~15)) sk[n + lane] = -1;
    if (lane == 0) n_hit[k] = n;
  }
  __syncthreads();
  if (tid == 0) {
    int na = 0;
    for (int k = 0; k < n_taps; ++k)
      if (n_hit[k]) tap_list[na++] = k;
    n_active = na;
  }
  // the gathered rows' pad columns [c_in, ck) are zero once for all taps
  const int pad = L.ck - c_in;
  for (int i = tid; i < L.n_stages * kTileRows * pad; i += kTileThreads) {
    const int rr = i / pad, c = c_in + i - rr * pad;  // rr: stage * 64 + row
    reinterpret_cast<float*>(ring + (long)(rr / kTileRows) * L.tile_pitch)
        [(rr % kTileRows) * L.a_stride + c] = 0.0f;
  }
  __syncthreads();

  // 3) a ring of (compacted rows, W[k] tile) stages over the active taps
  const int a_bytes = kTileRows * L.a_stride * 4;
  auto stage = [&](int s) { return ring + (long)s * L.tile_pitch; };
  auto issue = [&](int s, int k) {
    const int frags = (n_hit[k] + 15) >> 4;
    gather_rows(reinterpret_cast<float*>(stage(s)), L.a_stride,
                src_s + k * kTileRows, (1 << frags) - 1, feats, c_in, vec4,
                tid);
    copy_w_tile<false>(stage(s) + a_bytes, wprep, k, s0, L, tid,
                       kTileThreads);
  };
  const int n_tiles = L.slab / 8;
  const int c_end = (c_in + 3) & ~3;  // padded channels are zeros
  const int na = n_active;
  for (int s = 0; s < L.n_stages - 1; ++s) {
    if (s < na) issue(s, tap_list[s]);
    cp_async_commit();
  }
  for (int i = 0; i < na; ++i) {
    const int nxt = i + L.n_stages - 1;
    if (nxt < na) issue(nxt % L.n_stages, tap_list[nxt]);
    cp_async_commit();
    cp_async_wait(L.n_stages - 1);
    __syncthreads();
    const int k = tap_list[i], n = n_hit[k];
    // the tap's units: nf fragments, each cut into ns column ranges, so
    // that up to 4 warps share the work (3 fragments: one warp idles)
    const int nf = (n + 15) >> 4;
    const int ns = min(nf >= 3 ? 1 : (nf == 2 ? 2 : 4), n_tiles);
    const int f = warp / ns, q = warp - f * ns;
    const int per = (n_tiles + ns - 1) / ns;
    const int j0 = q * per, j1 = min(j0 + per, n_tiles);
    if (f < nf && j0 < j1) {
      const unsigned char* st = stage(i % L.n_stages);
      frag_dispatch<kNT>(j1 - j0, sums, pitch, row_s + k * kTileRows, n, f,
                         j0, reinterpret_cast<const float*>(st),
                         reinterpret_cast<const float*>(st + a_bytes), L,
                         c_end, lane);
    }
    __syncthreads();
  }
  cp_async_wait(0);
  // 4) the sums to the output rows, coalesced
  for (int i = tid; i < kTileRows * L.slab; i += kTileThreads) {
    const int r = i / L.slab, c = i - r * L.slab;
    const int row = row0 + r, co = s0 + c;
    if (row < n_rows && co < c_out)
      out[(long)row * c_out + co] = sums[r * pitch + c];
  }
}

// K6's window table, the entry function's index work (ops/onehot_conv.py::
// window_blocks): a CTA per row tile t of the n_pad padded rows takes lo,
// the least valid neighbor index of each tap k over the tile's rows (0 if
// none), and writes blk[t][k] = clamp(lo / block, 0, n_pad / block - 2);
// it zeroes the tile's miss count.
__global__ void __launch_bounds__(256) onehot_window_kernel(
    const int* __restrict__ nmap, int n0, int n_taps, int tile, int block,
    long n_pad, int* __restrict__ blk, int* __restrict__ misses) {
  extern __shared__ int lo_s[];   // [n_taps]
  const int t = blockIdx.x, tid = threadIdx.x;
  for (int k = tid; k < n_taps; k += blockDim.x) lo_s[k] = 0x7fffffff;
  __syncthreads();
  const long r0 = (long)t * tile;
  const long r1 = r0 + tile < n0 ? r0 + tile : n0;
  for (long i = r0 * n_taps + tid; i < r1 * n_taps; i += blockDim.x) {
    const int idx = nmap[i];
    if (idx >= 0) atomicMin(&lo_s[(int)(i % n_taps)], idx);
  }
  __syncthreads();
  const int hi = (int)(n_pad / block) - 2;
  for (int k = tid; k < n_taps; k += blockDim.x) {
    const int lo = lo_s[k] == 0x7fffffff ? 0 : lo_s[k];
    const int b = lo / block;
    blk[(long)t * n_taps + k] = b < 0 ? 0 : (b > hi ? hi : b);
  }
  if (tid == 0) misses[t] = 0;
}

// The mode the host rule (ops/gather_conv.py::kernel_mode) picks.
int mode_of(int c_in, int c_out) {
  return c_in <= kRowMaxCin && c_out <= kRowMaxCout ? kModeRow
       : c_in <= kMaxCin ? kModeTile : kModeFma;
}

long scratch_bytes(int c_in, int c_out, int n_taps, bool bf16, int mode) {
  if (mode == kModeFma) return 0;
  const Layout l = layout_of(c_in, c_out, n_taps, 0, 0, bf16);
  return prepped_weight_bytes(l, n_taps, bf16);
}

// One windowed conv of n_rows output rows in `mode`; wprep holds
// scratch_bytes bytes. Returns the launch error.
template <bool kOneHot, bool kBf16>
int launch(const float* feats, const int* nmap, const Window& w,
           const float* weights, int n_rows, int c_in, int c_out,
           int n_taps, int tile, int mode, void* wprep, float* out,
           int* misses, cudaStream_t stream) {
  if (mode == kModeFma) {
    const dim3 grid((unsigned)((n_rows + kRows - 1) / kRows),
                    (unsigned)((c_out + kCols - 1) / kCols));
    windowed_fma_kernel<kOneHot><<<grid, kThreads,
                                   n_taps * kRows * sizeof(int), stream>>>(
        feats, nmap, w, weights, n_rows, c_in, c_out, n_taps, tile, kBf16,
        out, misses);
    return (int)cudaGetLastError();
  }
  const Layout l = layout_of(c_in, c_out, n_taps, 0, 0, kBf16);
  const int vec4 = c_in % 4 == 0 && (uintptr_t)feats % 16 == 0;
  int err = prep_weights(weights, n_taps, c_in, c_out, l, kBf16, wprep,
                         stream);
  if (err != 0) return err;
  // largest size granted so far: row mode 8, 16; tile mode kNT 2, 8
  static long smem_set[4] = {0, 0, 0, 0};
  if (mode == kModeRow) {
    const auto kernel = l.slab == 8
        ? windowed_row_kernel<kOneHot, kBf16, 8>
        : windowed_row_kernel<kOneHot, kBf16, kRowMaxCout>;
    const long smem = l.smem + (long)n_taps * kRowThreads * sizeof(int);
    err = allow_smem(kernel, smem, &smem_set[l.slab != 8]);
    if (err != 0) return err;
    kernel<<<(unsigned)((n_rows + kRowThreads - 1) / kRowThreads),
             kRowThreads, smem, stream>>>(
        feats, nmap, w, static_cast<const float*>(wprep), n_rows, c_in,
        c_out, n_taps, tile, vec4, out, misses);
    return (int)cudaGetLastError();
  }
  if (l.smem > kSmemMax) return -1;
  const auto kernel = l.slab > 16 ? windowed_tile_kernel<kOneHot, kBf16, 8>
                                  : windowed_tile_kernel<kOneHot, kBf16, 2>;
  err = allow_smem(kernel, l.smem, &smem_set[2 + (l.slab > 16)]);
  if (err != 0) return err;
  const dim3 grid((unsigned)((n_rows + kTileRows - 1) / kTileRows),
                  (unsigned)l.n_slabs);
  kernel<<<grid, kTileThreads, l.smem, stream>>>(
      feats, nmap, w, wprep, n_rows, c_in, c_out, n_taps, tile, vec4, out,
      misses);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long gather_conv_scratch_bytes(int c_in, int c_out, int n_taps,
                                          int mode) {
  // bytes of the prepped weights gather_conv_fwd takes as `wprep`
  return scratch_bytes(c_in, c_out, n_taps, false, mode);
}

extern "C" int gather_conv_fwd(const float* feats, const int* nmap,
                               const float* weights, int n, int c_in,
                               int c_out, int n_taps, int tile, int mode,
                               void* wprep, float* out, int* misses,
                               cudaStream_t stream) {
  // feats (n, c_in), nmap (n, n_taps), weights (n_taps, c_in, c_out);
  // out (n, c_out); misses (n / tile,) zeroed by the caller; wprep holds
  // gather_conv_scratch_bytes bytes. mode: kModeRow for C <= kRowMaxCin
  // and C' <= kRowMaxCout, else kModeTile for C <= kMaxCin, else kModeFma.
  if (n_taps < 1 || n_taps > kMaxTaps || tile < 1 || c_out < 1 ||
      n % tile != 0 || (tile * (n_taps - 1)) % 2 != 0 ||
      (long)n < (long)tile * n_taps || mode != mode_of(c_in, c_out))
    return -1;
  Window w{};
  w.window = (long)tile * (n_taps - 1) / 2;
  w.span = (long)tile * n_taps;
  w.base_max = n - w.span;
  return launch<false, false>(feats, nmap, w, weights, n, c_in, c_out,
                              n_taps, tile, mode, wprep, out, misses,
                              stream);
}

namespace {

// nmap_conv_fwd's checks and its window: one row tile of n_out rows, its
// window [0, n_in). Returns 1 when the call is valid and has rows.
int nmap_window(int n_out, int n_in, int c_in, int c_out, int n_taps,
                int mode, Window* w, int* err) {
  *err = 0;
  if (n_taps < 1 || n_taps > kMaxTaps || c_out < 1 || n_out < 0 ||
      n_in < 0 || mode != mode_of(c_in, c_out))
    *err = -1;
  *w = Window{};
  w->span = n_in;
  return *err == 0 && n_out > 0;
}

}  // namespace

extern "C" int nmap_conv_fwd(const float* feats, const int* nmap,
                             const float* weights, int n_out, int n_in,
                             int c_in, int c_out, int n_taps, int mode,
                             void* wprep, float* out, int* misses,
                             cudaStream_t stream) {
  // feats (n_in, c_in), nmap (n_out, n_taps) of feature rows (-1 =
  // missing), weights (n_taps, c_in, c_out); out (n_out, c_out); misses
  // (1,) zeroed by the caller counts indices at or past n_in; wprep holds
  // gather_conv_scratch_bytes bytes; mode as gather_conv_fwd's. The tile
  // mode runs nmap_tile_kernel, the others K5's bodies.
  Window w;
  int err;
  if (!nmap_window(n_out, n_in, c_in, c_out, n_taps, mode, &w, &err))
    return err;
  if (mode != kModeTile)
    return launch<false, false>(feats, nmap, w, weights, n_out, c_in, c_out,
                                n_taps, n_out, mode, wprep, out, misses,
                                stream);
  const Layout l = layout_of(c_in, c_out, n_taps, 0, 0, false);
  const NmapLayout m = nmap_layout_of(l, n_taps);
  if (m.smem > kSmemMax) return -1;
  err = prep_weights(weights, n_taps, c_in, c_out, l, false, wprep, stream);
  if (err != 0) return err;
  const auto kernel = l.slab > 16 ? nmap_tile_kernel<8> : nmap_tile_kernel<2>;
  static long smem_set[2] = {0, 0};   // largest size granted: kNT 2, 8
  err = allow_smem(kernel, m.smem, &smem_set[l.slab > 16]);
  if (err != 0) return err;
  const int vec4 = c_in % 4 == 0 && (uintptr_t)feats % 16 == 0;
  const dim3 grid((unsigned)((n_out + kTileRows - 1) / kTileRows),
                  (unsigned)l.n_slabs);
  kernel<<<grid, kTileThreads, m.smem, stream>>>(
      feats, nmap, w, wprep, n_out, c_in, c_out, n_taps, vec4, out, misses);
  return (int)cudaGetLastError();
}

extern "C" int nmap_conv_fwd_prev(const float* feats, const int* nmap,
                                  const float* weights, int n_out, int n_in,
                                  int c_in, int c_out, int n_taps, int mode,
                                  void* wprep, float* out, int* misses,
                                  cudaStream_t stream) {
  // nmap_conv_fwd as it was before its tile mode had a body of its own:
  // K5's bodies in every mode. No path runs it; the card's checks hold
  // nmap_conv_fwd to it bit for bit.
  Window w;
  int err;
  if (!nmap_window(n_out, n_in, c_in, c_out, n_taps, mode, &w, &err))
    return err;
  return launch<false, false>(feats, nmap, w, weights, n_out, c_in, c_out,
                              n_taps, n_out, mode, wprep, out, misses,
                              stream);
}

extern "C" int onehot_window_blocks(const int* nmap, int n0, int n_taps,
                                    int tile, int block, int* blk,
                                    int* misses, cudaStream_t stream) {
  // nmap (n0, n_taps); blk (n_pad / tile, n_taps) and misses (n_pad /
  // tile,) with n_pad = n0 + (-n0 mod block) + block: blk gets the window
  // start block of each (row tile, tap), misses zeros.
  if (n_taps < 1 || n_taps > kMaxTaps || tile < 1 || block < 1 ||
      block % tile != 0 || n0 < 0)
    return -1;
  const long n_pad = n0 + (block - n0 % block) % block + block;
  onehot_window_kernel<<<(unsigned)(n_pad / tile), 256,
                         n_taps * sizeof(int), stream>>>(
      nmap, n0, n_taps, tile, block, n_pad, blk, misses);
  return (int)cudaGetLastError();
}

extern "C" long onehot_conv_scratch_bytes(int c_in, int c_out, int n_taps,
                                          int bf16, int mode) {
  // bytes of the prepped weights onehot_conv_fwd takes as `wprep`
  return scratch_bytes(c_in, c_out, n_taps, bf16 != 0, mode);
}

extern "C" int onehot_conv_fwd(const float* feats, const int* nmap,
                               const float* weights, const int* blk, int n0,
                               int c_in, int c_out, int n_taps, int tile,
                               int block, int bf16, int mode, void* wprep,
                               float* out, int* misses,
                               cudaStream_t stream) {
  // feats (n0, c_in), nmap (n0, n_taps); blk (tiles, n_taps) window start
  // blocks over the padded rows; out (n0, c_out); misses (tiles,) zeroed by
  // the caller; wprep holds onehot_conv_scratch_bytes bytes. mode, for
  // either operand type: kModeRow for C <= kRowMaxCin and C' <=
  // kRowMaxCout, else kModeTile for C <= kMaxCin, else kModeFma.
  if (n_taps < 1 || n_taps > kMaxTaps || tile < 1 || block < 1 ||
      c_out < 1 || mode != mode_of(c_in, c_out))
    return -1;
  if (n0 == 0) return 0;
  Window w{};
  w.blk = blk;
  w.block = block;
  return bf16 ? launch<true, true>(feats, nmap, w, weights, n0, c_in, c_out,
                                   n_taps, tile, mode, wprep, out, misses,
                                   stream)
              : launch<true, false>(feats, nmap, w, weights, n0, c_in,
                                    c_out, n_taps, tile, mode, wprep, out,
                                    misses, stream);
}
