// Band-window sparse convolution: the forward (K1: one CTA per 64 output
// rows of a plan tile and output-channel slab, or a thread per row for
// narrow layers) and the weight gradient (K4: a source pass, then one CTA
// per chunk of rows and tap).
//
// K1 replaces virconv_tpu/ops/pallas/band_conv.py::_kernel. The TPU kernel
// gathers each tap's rows with a one-hot matmul built from key equality over
// a 2-block window and runs one (T, K*C) @ (K*C, C') matmul. A one-hot
// matmul is an exact gather, so here the source of (row, tap k) is the
// lower-bound row of base_key + delta[k] inside the tile's window of that
// tap's group, if tap bit k is set; lower bound lands on the first row of a
// duplicate-key run (NRConv 2D first-wins). Output rows are exact iff the
// plan says the tile fits. The training path runs K1 as the input gradient
// too, with tap-reversed transposed weights on the same plan.
//
// Bound: per (row, tap) hit, 2*C*C' operations against one gathered row of
// C floats. At the serving widths (bf16 operands on the tensor cores) that
// is far below the card's ops:byte ratio, so the ideal kernel is bound by
// the bytes of the inputs; in training (f32 on CUDA cores) by the
// operations at the f32 peak. What the design does about it:
//  - tile mode (C > 8 or C' > 16): a CTA takes 64 rows of a plan tile and
//    an output slab fitted to C' (multiples of 8, at most 64; C' = 128 is
//    two slabs). It stages the window keys of each tap group (2*BLOCK
//    int32) in shared memory once, and its 128 threads run the 64 x K
//    lower-bound searches there, four independent searches per thread in
//    flight, into a shared (tap, row) source table. Per tap, the hit rows'
//    C floats are copied with cp.async, neighbouring threads on
//    neighbouring 16-byte chunks of a row (zeros for a row with no
//    source), into a padded shared tile with W[k]'s slab beside it; a ring
//    of 2-4 stages keeps the next taps' copies in flight while a tap
//    computes. Each warp owns 16 rows x the slab, its sums in registers
//    across all taps; a tap no row of the CTA hits is dropped, and a 16-row
//    fragment none of whose rows hits a tap is neither copied nor
//    multiplied. bf16: mma.sync m16n8k16 on the tensor cores, A fragments
//    converted from the staged f32 rows, B fragments read from W[k]
//    pre-rounded to bf16 and transposed by a prep kernel (products of bf16
//    values are exact in f32; only the order of the sum differs from the
//    plain version). f32: CUDA-core fmaf, 4 rows x slab/8 channels per
//    thread, in tap then channel order (no TF32);
//  - row mode (C <= 8, C' <= 16): a 16-row fragment's MMA would spend half
//    its depth on zeros, most fragments hit most taps while few of their
//    rows do, and staging the window keys costs a CTA more than its rows'
//    searches, so a thread per output row searches the window in global
//    memory (through L1), gathers only the rows its taps hit and sums fmaf
//    against every tap's weights resident in shared memory (bf16: both
//    rounded), in tap then channel order.
//
// The gather patch runs in the same call. Rows of tiles whose window does
// not fit (plan.fits) are not exact in K1; the caller passes them as a
// patch, (pidx, pnmap): output rows and their (rows, K) neighbor map of
// feature rows (-1: none). It replaces the JAX package's XLA gather +
// matmul (virconv_tpu/ops/sparse.py::gathered_conv) on those rows. One
// launch runs the exact conv of those rows with f32 operands on K1's
// gathered-row bodies (common.cuh: tile_sums / row_sums in the mode of
// K1's widths, the bodies ops/nmap_conv.py runs on a full neighbor map, so
// the same bits), applies K1's epilogue (affine as __fmul_rn then
// __fadd_rn, ReLU) and stores rows pidx of K1's output. f32 calls share
// K1's prepped weights; bf16 calls get the patch's f32 copy from the same
// prep launch. Bound: 2*C*C' operations per (patch row, tap) hit at the
// f32 rate, a few hundred rows a call, but a few CTAs each walk every tap
// in sequence: the chain of its ring's stages, not the work, is its cost.
// So the patch launches first and K1 runs beside it (programmatic
// dependent launch), leaving the patch's tiles to it (zeroing only their
// invalid rows); K1's last CTA waits for the patch's grid, so the K1 grid
// completes after it.
//
// bf16 features (the TPU kernel's out_dtype; the JAX package's
// VIRCONV_BF16_FEATS): the feature rows may be bf16 and the output rows
// stored as bf16. Every body is templated on both element types. The sums
// and the epilogue stay f32 in registers; a bf16 row is widened to f32 as
// it is staged (tile mode: one 16-byte load of 8 values, widened and
// stored into the ring, where f32 rows go by cp.async; row mode and the
// patch's row mode: loaded and widened in registers), which is exact, so
// the operands are the f32 path's and only the rows' bytes halve. The
// store rounds each value to nearest even. The patch reads the same rows
// and stores the same type, as the JAX composition does (an f32 conv of
// the bf16 rows, the epilogue, then a cast).

// K4 replaces virconv_tpu/ops/pallas/band_conv.py::_dw_kernel:
// dW[k] = gather_k(feats)^T @ (g * row_ok), summed over every tile. The TPU
// kernel keeps the whole (K*C, C') f32 sum resident and revisits it across a
// sequential grid; CTAs here run in no order, so the rows are cut into
// chunks and each CTA sums one chunk's part of one tap's C x C' block.
// Bound: 2*C*C' operations per valid (row, tap) hit against one feats row
// and one g row: the f32 operations on CUDA cores (training's operands).
// What the design does about it:
//  - a source pass (a CTA per plan tile) stages the tile's window keys in
//    shared memory, runs every (row, tap) lower-bound search there once,
//    as K1's tile mode does, and writes src[K][rows] (-1: no source, an
//    invalid row or a row past n_out) to scratch;
//  - one CTA per (chunk of rows, tap, slab of at most 64 output channels:
//    one slab at the training widths) owns the whole C x slab block. It
//    lists the chunk's hit rows in row order in shared memory (ballots),
//    then copies their feats and g rows with cp.async into a ring of 3
//    stages, each hit row once per tap. Each thread keeps an 8 x 8
//    micro-tile of the block in registers: per hit row four float4 shared
//    loads and 64 fmaf, half the shared bytes per FMA of a 4 x 4 tile.
//    When C or C' is below 32 a 4 x 4 tile is faster (smaller group sums,
//    more threads per block). Thread groups take interleaved hit rows and
//    add their partials in shared memory in group order. bf16 operands are
//    rounded in shared memory by the thread that copied them;
//  - the chunk count is chosen by the caller (about three waves of two
//    CTAs per SM: taps hit unevenly, the centre tap every row, and smaller
//    chunks even the waves out); a third kernel sums the per-chunk partials
//    in chunk order. No float atomics: the result has the same bits on
//    every run.
//
// The neighbor-map weight gradient (nmap_conv_dw, ops/nmap_conv.py) is K4's
// contract over a neighbor map instead of band windows: dW[k] = sum over
// rows r with nmap[r][k] >= 0 of feats[nmap[r][k]]^T g[r]. It replaces the
// JAX package's XLA loop in the gather-only backward of the training
// neighbor-map conv (virconv_tpu/ops/sparse.py::_gct_bwd) and the gather
// patch's term of the band conv's weight gradient (::_band_train_bwd). The
// map is transposed into K4's tap-major source table (one small kernel),
// then K4's sums kernel and its in-order partial sum run as they are: the
// same bound (2*C*C' operations per hit at the f32 peak) and the same bits
// on every run.

#include "common.cuh"

namespace {

constexpr int kMaxTaps = 30;       // tap bits lie below the row-valid bit
constexpr int kMaxCin = 128;
constexpr int kMaxGroups = 3;      // dy groups of a 3-wide kernel
constexpr int kMaxBlock = 2048;
constexpr int kRowValidBit = 30;

// Lower-bound row of key q in the window [ws, min(ws + 2 * block, n_in)) of
// the sorted keys, or -1 when q is not there (K4 and K1's row mode).
__device__ __forceinline__ int band_source(const int* __restrict__ keys,
                                           int n_in, int q, long ws,
                                           int block) {
  long lo = ws;
  long hi = ws + 2L * block;
  if (hi > n_in) hi = n_in;
  const long end = hi;
  while (lo < hi) {
    const long mid = (lo + hi) >> 1;
    if (keys[mid] < q) lo = mid + 1; else hi = mid;
  }
  return (lo < end && keys[lo] == q) ? (int)lo : -1;
}

// Programmatic dependent launch (sm_90): the gather patch's grid lets the
// K1 grid launched after it on the stream start at once
// (launch_dependents); K1, launched with programmatic stream
// serialization, waits for the patch's grid to complete before it exits
// (wait), so what follows on the stream sees both grids' rows.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// K1 beside a patch (fits set): only its grid's last CTA waits for the
// patch's grid, so the K1 grid completes after it while every other CTA
// exits and frees its slot as soon as its rows are done.
__device__ __forceinline__ void wait_for_patch(const bool* fits) {
  if (fits != nullptr && blockIdx.x == gridDim.x - 1 &&
      blockIdx.y == gridDim.y - 1)
    griddep_wait();
}

// K1's epilogue of one output value in column co (before the row-valid
// factor): affine as a rounded multiply then a rounded add, ReLU.
__device__ __forceinline__ float epilogue(float v, int co,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias,
                                          int affine, int relu) {
  if (affine) v = __fadd_rn(__fmul_rn(v, scale[co]), bias[co]);
  if (relu) v = fmaxf(v, 0.0f);
  return v;
}

// Stages the window keys [blk_t[g] * block, +2 * block) of each group g
// (clipped to the n_in keys) at keys_s + g * 2 * block; thread t of nt.
__device__ __forceinline__ void stage_windows(int* keys_s, int* win_lo,
                                              int* win_len,
                                              const int* __restrict__ keys,
                                              const int* __restrict__ blk_t,
                                              int n_groups, int n_in,
                                              int block, int t, int nt) {
  const int wlen = 2 * block;
  for (int g = 0; g < n_groups; ++g) {
    const long ws = (long)blk_t[g] * block;
    const long lo = ws < 0 ? 0 : ws;
    long hi = ws + wlen;
    if (hi > n_in) hi = n_in;
    const int len = hi > lo ? (int)(hi - lo) : 0;
    if (t == 0) { win_lo[g] = (int)lo; win_len[g] = len; }
    for (int i = t; i < len; i += nt) keys_s[g * wlen + i] = keys[lo + i];
  }
}

// One row's sources for taps k_first, k_first + k_step, ...: lower-bound
// searches of base key qk + delta[k] in the staged window of the tap's
// group, four independent searches in flight; the source row, or -1 (tap
// bit clear or key absent), goes to out[k * stride].
__device__ __forceinline__ void search_taps(const int* keys_s, int wlen,
                                            const int* win_lo,
                                            const int* win_len,
                                            const int* geo_s, int n_taps,
                                            int bits, int qk, int k_first,
                                            int k_step, int* out,
                                            long stride) {
  for (int k0 = k_first; k0 < n_taps; k0 += 4 * k_step) {
    int lo[4], n[4], q[4], g[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + k_step * u;
      const bool on = k < n_taps && ((bits >> k) & 1);
      g[u] = on ? geo_s[n_taps + k] : 0;
      q[u] = on ? qk + geo_s[k] : 0;
      lo[u] = 0;
      n[u] = on ? win_len[g[u]] : 0;
    }
    bool busy = true;
    while (busy) {
      busy = false;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (n[u] > 0) {
          const int half = n[u] >> 1;
          if (keys_s[g[u] * wlen + lo[u] + half] < q[u]) {
            lo[u] += half + 1;
            n[u] -= half + 1;
          } else {
            n[u] = half;
          }
          busy |= n[u] > 0;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + k_step * u;
      if (k >= n_taps) continue;
      const bool on = (bits >> k) & 1;
      const bool hit = on && lo[u] < win_len[g[u]] &&
                       keys_s[g[u] * wlen + lo[u]] == q[u];
      out[k * stride] = hit ? win_lo[g[u]] + lo[u] : -1;
    }
  }
}

// Row mode: a thread per output row over every output channel (kCout, 8
// or 16, a compile-time stride of the resident weights). The row's sources
// come from lower-bound searches in global memory (the window keys are read
// through L1), all before the sums; the hit taps' rows are summed in tap
// then channel order with fmaf. TIn, TOut: the element types of the feature
// rows read and the output rows stored (f32 or bf16).
template <bool kBf16, int kCout, typename TIn, typename TOut>
__global__ void __launch_bounds__(kRowThreads) band_conv_row_kernel(
    const TIn* __restrict__ feats, const int* __restrict__ keys,
    const int* __restrict__ base_keys, const int* __restrict__ valid_bits,
    const int* __restrict__ blk, const float* __restrict__ wprep,
    int n_in, int c_in, int c_out, int n_taps, int n_groups,
    const int* __restrict__ geo, const float* __restrict__ scale,
    const float* __restrict__ bias, int affine, int relu, int tile,
    int block, long n_rows, int n_out, int vec4,
    const bool* __restrict__ fits, TOut* __restrict__ out) {
  extern __shared__ __align__(16) float w_s[];  // (K, c_in, kCout)
  __shared__ int geo_s[2 * kMaxTaps];
  __shared__ int src_s[kMaxTaps * kRowThreads];
  const int tid = threadIdx.x;
  for (int i = tid; i < n_taps * c_in * kCout; i += kRowThreads)
    w_s[i] = wprep[i];
  for (int i = tid; i < 2 * n_taps; i += kRowThreads) geo_s[i] = geo[i];
  __syncthreads();
  const long row = (long)blockIdx.x * kRowThreads + tid;
  const long t = row / tile;
  const int bits = row < n_rows ? valid_bits[row] : 0;
  const bool ok = (bits >> kRowValidBit) & 1;
  if (row >= n_rows) {
  } else if (fits != nullptr && !fits[t]) {   // the patch's tile
    if (row < n_out && !ok)
      for (int j = 0; j < c_out; ++j) store_as(out + row * c_out + j, 0.0f);
  } else {
    const int qk = base_keys[row];
    // every tap's source first: independent searches, then the sums
    for (int k = 0; k < n_taps; ++k)
      src_s[k * kRowThreads + tid] = ((bits >> k) & 1) ? band_source(
          keys, n_in, qk + geo_s[k],
          (long)blk[t * n_groups + geo_s[n_taps + k]] * block, block) : -1;
    float acc[kCout];
    row_sums<kBf16, kCout>(acc, src_s, n_taps, feats, c_in, vec4, w_s);
    if (row < n_out) {
#pragma unroll
      for (int j = 0; j < kCout; ++j) {
        if (j >= c_out) break;
        store_as(out + row * c_out + j,
                 epilogue(acc[j], j, scale, bias, affine, relu) *
                     (ok ? 1.0f : 0.0f));
      }
    }
  }
  wait_for_patch(fits);
}

// Tile mode. kNT: the most 8-channel column tiles of a slab this
// instantiation takes; TIn, TOut as in row mode.
template <bool kBf16, int kNT, typename TIn, typename TOut>
__global__ void __launch_bounds__(kTileThreads) band_conv_kernel(
    const TIn* __restrict__ feats, const int* __restrict__ keys,
    const int* __restrict__ base_keys, const int* __restrict__ valid_bits,
    const int* __restrict__ blk, const void* __restrict__ wprep,
    int n_in, int c_in, int c_out, int n_taps, int n_groups,
    const int* __restrict__ geo,  // deltas[K] then group_of[K]
    const float* __restrict__ scale, const float* __restrict__ bias,
    int affine, int relu, int tile, int block, int n_out, int vec4,
    const bool* __restrict__ fits, TOut* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int geo_s[2 * kMaxTaps];
  __shared__ int tap_mask[kMaxTaps];   // bit f: fragment f has a hit
  __shared__ int tap_list[kMaxTaps];   // taps with any hit, in tap order
  __shared__ int n_active;
  __shared__ int win_lo[kMaxGroups], win_len[kMaxGroups];
  __shared__ float row_ok[kTileRows];

  const Layout L = layout_of(c_in, c_out, n_taps, n_groups, block, kBf16);
  int* src_s = reinterpret_cast<int*>(smem);              // [K][kTileRows]
  unsigned char* area = smem + L.area_off;
  int* keys_s = reinterpret_cast<int*>(area);             // [G][2 * block]

  const int tid = threadIdx.x;
  const int cpt = (tile + kTileRows - 1) / kTileRows;     // CTAs per tile
  const int t = blockIdx.x / cpt;
  const int r0 = (blockIdx.x - t * cpt) * kTileRows;
  const int n_rows = min(kTileRows, tile - r0);
  const long row_base = (long)t * tile + r0;
  const int n0 = blockIdx.y * L.slab;

  if (fits != nullptr && !fits[t]) {   // the patch's tile: its invalid rows
    for (int i = tid; i < n_rows * L.slab; i += kTileThreads) {
      const long row = row_base + i / L.slab;
      const int co = n0 + i % L.slab;
      if (row < n_out && co < c_out &&
          !((valid_bits[row] >> kRowValidBit) & 1))
        store_as(out + row * c_out + co, 0.0f);
    }
    wait_for_patch(fits);
    return;
  }

  // 1) the tile's window keys of every group
  for (int i = tid; i < 2 * n_taps; i += kTileThreads) geo_s[i] = geo[i];
  stage_windows(keys_s, win_lo, win_len, keys, blk + (long)t * n_groups,
                n_groups, n_in, block, tid, kTileThreads);
  __syncthreads();

  // 2) sources: thread (r, half) searches row r's taps half, half + 2, ...
  //    four at a time, in the staged windows
  {
    const int r = tid & (kTileRows - 1);
    const bool in = r < n_rows;
    const int bits = in ? valid_bits[row_base + r] : 0;
    const int qk = in ? base_keys[row_base + r] : 0;
    if (tid < kTileRows)
      row_ok[r] = ((bits >> kRowValidBit) & 1) ? 1.0f : 0.0f;
    search_taps(keys_s, 2 * block, win_lo, win_len, geo_s, n_taps, bits, qk,
                tid >> 6, 2, src_s + r, kTileRows);
  }
  __syncthreads();

  // 3) the taps each 16-row fragment hits, and 4) the ring over them
  float acc[4 * kNT];
  tile_sums<kBf16, kNT>(acc, src_s, area, L, feats, c_in, vec4, wprep, n0,
                        n_taps, tap_mask, tap_list, n_active);

  // 5) epilogue: affine, ReLU, times the row-valid bit
  tile_store<kBf16, kNT>(acc, L, n0, [&](int rl, int co, float v) {
    const long row = row_base + rl;
    if (rl >= n_rows || row >= n_out || co >= c_out) return;
    store_as(out + row * c_out + co,
             epilogue(v, co, scale, bias, affine, relu) * row_ok[rl]);
  });
  wait_for_patch(fits);
}

// The source of (patch row, tap k): its neighbor map entry when it is a
// feature row, else -1.
__device__ __forceinline__ int patch_source(const int* __restrict__ pnmap,
                                            int row, int k, int n_taps,
                                            int n_in) {
  const int idx = pnmap[(long)row * n_taps + k];
  return idx >= 0 && idx < n_in ? idx : -1;
}

// The gather patch, tile mode: a 64-row CTA and output slab of the patch
// rows, f32 operands (tile_sums), K1's epilogue, stored to rows pidx.
template <int kNT, typename TIn, typename TOut>
__global__ void __launch_bounds__(kTileThreads) patch_tile_kernel(
    const TIn* __restrict__ feats, const int* __restrict__ pnmap,
    const long long* __restrict__ pidx, const void* __restrict__ wprep,
    int n_patch, int n_in, int c_in, int c_out, int n_taps, int vec4,
    const float* __restrict__ scale, const float* __restrict__ bias,
    int affine, int relu, TOut* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tap_mask[kMaxTaps];
  __shared__ int tap_list[kMaxTaps];
  __shared__ int n_active;
  griddep_launch_dependents();   // K1 may start beside this grid
  const Layout L = layout_of(c_in, c_out, n_taps, 0, 0, false);
  int* src_s = reinterpret_cast<int*>(smem);   // [K][kTileRows]
  const int row0 = blockIdx.x * kTileRows;
  const int s0 = blockIdx.y * L.slab;
  for (int i = threadIdx.x; i < kTileRows * n_taps; i += kTileThreads) {
    const int r = i / n_taps, k = i - r * n_taps;
    src_s[k * kTileRows + r] = row0 + r < n_patch
        ? patch_source(pnmap, row0 + r, k, n_taps, n_in) : -1;
  }
  __syncthreads();
  float acc[4 * kNT];
  tile_sums<false, kNT>(acc, src_s, smem + L.area_off, L, feats, c_in, vec4,
                        wprep, s0, n_taps, tap_mask, tap_list, n_active);
  tile_store<false, kNT>(acc, L, s0, [&](int rl, int co, float v) {
    const int row = row0 + rl;
    if (row >= n_patch || co >= c_out) return;
    store_as(out + pidx[row] * c_out + co,
             epilogue(v, co, scale, bias, affine, relu));
  });
}

// The gather patch, row mode (C <= 8, C' <= kCout): a thread per patch
// row against every tap's weights resident in shared memory (row_sums).
template <int kCout, typename TIn, typename TOut>
__global__ void __launch_bounds__(kRowThreads) patch_row_kernel(
    const TIn* __restrict__ feats, const int* __restrict__ pnmap,
    const long long* __restrict__ pidx, const float* __restrict__ wprep,
    int n_patch, int n_in, int c_in, int c_out, int n_taps, int vec4,
    const float* __restrict__ scale, const float* __restrict__ bias,
    int affine, int relu, TOut* __restrict__ out) {
  extern __shared__ __align__(16) float w_s[];  // (K, c_in, kCout), then
                                                // the sources [K][128]
  int* src_s = reinterpret_cast<int*>(w_s + n_taps * c_in * kCout);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRowThreads;
  griddep_launch_dependents();   // K1 may start beside this grid
  for (int i = tid; i < n_taps * c_in * kCout; i += kRowThreads)
    w_s[i] = wprep[i];
  for (int i = tid; i < kRowThreads * n_taps; i += kRowThreads) {
    const int r = i / n_taps, k = i - r * n_taps;
    src_s[k * kRowThreads + r] = row0 + r < n_patch
        ? patch_source(pnmap, row0 + r, k, n_taps, n_in) : -1;
  }
  __syncthreads();
  const int row = row0 + tid;
  if (row >= n_patch) return;
  float acc[kCout];
  row_sums<false, kCout>(acc, src_s, n_taps, feats, c_in, vec4, w_s);
  TOut* o = out + pidx[row] * c_out;
#pragma unroll
  for (int j = 0; j < kCout; ++j) {
    if (j >= c_out) break;
    store_as(o + j, epilogue(acc[j], j, scale, bias, affine, relu));
  }
}

constexpr int kDwMaxTile = 256;     // the source pass: >= 1 thread per row
constexpr int kDwMaxChunk = 2048;   // rows of a chunk (hit list in shared)
constexpr int kDwMaxSlab = 64;      // output channels per CTA
constexpr int kDwThreads = 256;
constexpr int kDwStages = 3;
constexpr int kDwStageBudget = 16 * 1024;
constexpr int kDwRounds = kDwMaxChunk / kDwThreads;   // compaction rounds

// The geometry of one K4 (chunk, tap, slab) CTA: an mt x mt micro-tile
// per thread (mt = 8 for blocks of at least 32 x 32, else 4) over the
// C x slab block, thread groups over the hit rows when the block has fewer
// micro-tiles than threads. A thread's mt rows (columns) are the 4-wide
// chunks tc and tc + TC (to and to + TO) of the block, so each float4
// shared load of a warp covers neighbouring 16-byte chunks. Shared memory:
// the chunk's hit list (rows, then sources), then a ring of kDwStages
// stages of `rows` hit rows (feats rows of cf floats, then g rows of cg
// floats); all of it is reused at the end for the groups' partials.
struct DwLayout {
  int mt;       // micro-tile edge: 4 or 8
  int slab;     // output channels per CTA, a multiple of mt
  int n_slabs;
  int tc, to;   // threads of a group along C and along the slab
  int m;        // threads of a group: tc * to
  int groups;   // thread groups taking interleaved hit rows
  int cf, cg;   // floats per staged feats row and g row
  int rows;     // hit rows per stage
  int stage_floats;
  long ring_off;
  long smem;
};

__host__ __device__ inline DwLayout dw_layout_of(int c_in, int c_out,
                                                 int chunk_rows) {
  DwLayout l;
  l.mt = c_in >= 32 && c_out >= 32 ? 8 : 4;
  l.n_slabs = (c_out + kDwMaxSlab - 1) / kDwMaxSlab;
  l.slab = ((c_out + l.n_slabs - 1) / l.n_slabs + l.mt - 1) / l.mt * l.mt;
  l.cf = (c_in + l.mt - 1) / l.mt * l.mt;
  l.cg = l.slab;
  l.tc = l.cf / l.mt;
  l.to = l.slab / l.mt;
  l.m = l.tc * l.to;   // <= kDwThreads: mt = 4 only when C or C' < 32
  l.groups = kDwThreads / l.m;
  int rows = kDwStageBudget / ((l.cf + l.cg) * 4) / 16 * 16;
  l.rows = rows < 16 ? 16 : (rows > 256 ? 256 : rows);
  l.stage_floats = l.rows * (l.cf + l.cg);
  l.ring_off = (2L * chunk_rows * sizeof(int) + 15) / 16 * 16;
  const long ring = l.ring_off + (long)kDwStages * l.stage_floats * 4;
  const long red = (long)l.groups * l.m * l.mt * l.mt * 4;
  l.smem = ring > red ? ring : red;
  return l;
}

// K4's source pass: a CTA per plan tile writes src[k * n_rows + row] for
// every tap k and row of the tile (-1: tap bit clear, key absent from the
// window, row-valid bit clear or row >= n_out).
__global__ void __launch_bounds__(kDwThreads) band_conv_dw_src_kernel(
    const int* __restrict__ keys, const int* __restrict__ base_keys,
    const int* __restrict__ valid_bits, const int* __restrict__ blk,
    int n_in, int n_taps, int n_groups, const int* __restrict__ geo,
    int tile, int block, int n_out, int* __restrict__ src) {
  extern __shared__ int keys_s[];   // [G][2 * block]
  __shared__ int geo_s[2 * kMaxTaps];
  __shared__ int win_lo[kMaxGroups], win_len[kMaxGroups];
  const int t = blockIdx.x, tid = threadIdx.x;
  for (int i = tid; i < 2 * n_taps; i += kDwThreads) geo_s[i] = geo[i];
  stage_windows(keys_s, win_lo, win_len, keys, blk + (long)t * n_groups,
                n_groups, n_in, block, tid, kDwThreads);
  __syncthreads();
  const int per_row = kDwThreads / tile;   // threads per row
  const int r = tid % tile, part = tid / tile;
  if (part >= per_row) return;
  const int row = t * tile + r;
  int bits = valid_bits[row];
  if (row >= n_out || !((bits >> kRowValidBit) & 1)) bits = 0;
  search_taps(keys_s, 2 * block, win_lo, win_len, geo_s, n_taps, bits,
              base_keys[row], part, per_row, src + row,
              (long)gridDim.x * tile);
}

// K4's sums: CTA (chunk, tap k, slab) writes its part of dW[k] to
// partial[chunk][k] (C x C'). kMT: the layout's micro-tile edge.
template <int kMT>
__global__ void __launch_bounds__(kDwThreads, 2) band_conv_dw_kernel(
    const float* __restrict__ feats, const float* __restrict__ g,
    const int* __restrict__ src, int c_in, int c_out, int n_taps, int bf16,
    int n_rows, int chunk_rows, int vec4f, int vec4g,
    float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_cnt[2][kDwThreads / 32];
  const DwLayout L = dw_layout_of(c_in, c_out, chunk_rows);
  int* hit_row = reinterpret_cast<int*>(smem);
  int* hit_src = hit_row + chunk_rows;
  float* ring = reinterpret_cast<float*>(smem + L.ring_off);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x, k = blockIdx.y;
  const int co0 = blockIdx.z * L.slab;
  const int r_begin = chunk * chunk_rows;
  const int r_end = min(r_begin + chunk_rows, n_rows);

  // 1) the chunk's rows with a tap-k source, in row order; every load
  //    first, so their latencies overlap
  const int* src_k = src + (long)k * n_rows;
  int sv[kDwRounds];
#pragma unroll
  for (int it = 0; it < kDwRounds; ++it) {
    const int row = r_begin + it * kDwThreads + tid;
    sv[it] = row < r_end ? src_k[row] : -1;
  }
  int n_hit = 0;
#pragma unroll
  for (int it = 0; it < kDwRounds; ++it) {
    if (r_begin + it * kDwThreads >= r_end) break;   // uniform
    const int row = r_begin + it * kDwThreads + tid;
    const int s = sv[it];
    const unsigned b = __ballot_sync(0xffffffffu, s >= 0);
    int* cnt = warp_cnt[it & 1];   // double-buffered: one barrier a round
    if (lane == 0) cnt[warp] = __popc(b);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kDwThreads / 32; ++w) {
      before += w < warp ? cnt[w] : 0;
      total += cnt[w];
    }
    if (s >= 0) {
      const int pos = n_hit + before + __popc(b & ((1u << lane) - 1u));
      hit_row[pos] = row;
      hit_src[pos] = s;
    }
    n_hit += total;
  }
  __syncthreads();

  // 2) per stage, the hit rows' feats (cf columns) and g slab (cg columns)
  //    copied with cp.async, zeros past C and C'; the same units walked
  //    again by the same thread to round them to bf16 once they landed
  //    (thread tid takes units tid, tid + kDwThreads, ... of the stage's
  //    rows of w = fw + gw units: row and column stepped without division)
  const int fw = vec4f ? L.cf / 4 : L.cf, gw = vec4g ? L.cg / 4 : L.cg;
  const int w = fw + gw;
  const int r_first = tid / w, j_first = tid - r_first * w;
  const int dr = kDwThreads / w, dj = kDwThreads - dr * w;
  auto units = [&](int s, bool round) {
    const int h0 = s * L.rows, nh = min(L.rows, n_hit - h0);
    float* fd = ring + (long)(s % kDwStages) * L.stage_floats;
    float* gd = fd + L.rows * L.cf;
    int r = r_first, j = j_first;
    for (; r < nh; r += dr, j += dj) {
      if (j >= w) { j -= w; ++r; if (r >= nh) break; }
      const bool is_f = j < fw;
      const bool v4 = is_f ? vec4f : vec4g;
      const int c = (is_f ? j : j - fw) * (v4 ? 4 : 1);
      float* d = is_f ? fd + r * L.cf + c : gd + r * L.cg + c;
      if (round) {
        if (v4) {
          float4 x = *reinterpret_cast<float4*>(d);
          x.x = maybe_bf16(x.x, true); x.y = maybe_bf16(x.y, true);
          x.z = maybe_bf16(x.z, true); x.w = maybe_bf16(x.w, true);
          *reinterpret_cast<float4*>(d) = x;
        } else {
          *d = maybe_bf16(*d, true);
        }
        continue;
      }
      const bool in = is_f ? c < c_in : co0 + c < c_out;
      const float* sp = is_f
          ? (in ? feats + (long)hit_src[h0 + r] * c_in + c : feats)
          : (in ? g + (long)hit_row[h0 + r] * c_out + co0 + c : g);
      if (v4) cp_async16_ca(d, sp, in ? 16 : 0);
      else cp_async4(d, sp, in ? 4 : 0);
    }
  };

  // 3) the ring: each thread's micro-tile (kMT input x kMT output
  //    channels) summed over its group's hit rows, in row order
  const int grp = tid / L.m, i_mt = tid - grp * L.m;
  const bool busy = grp < L.groups;
  const int tc = i_mt / L.to, to = i_mt - tc * L.to;
  // the float offset of chunk q (0 .. kMT/4 - 1) of this thread's rows and
  // columns in a staged row
  auto f_off = [&](int q) { return 4 * (tc + L.tc * q); };
  auto g_off = [&](int q) { return 4 * (to + L.to * q); };
  float acc[kMT * kMT];
#pragma unroll
  for (int q = 0; q < kMT * kMT; ++q) acc[q] = 0.0f;
  const int n_stage = (n_hit + L.rows - 1) / L.rows;
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < n_stage) units(s, false);
    cp_async_commit();
  }
  for (int s = 0; s < n_stage; ++s) {
    if (s + kDwStages - 1 < n_stage) units(s + kDwStages - 1, false);
    cp_async_commit();
    cp_async_wait(kDwStages - 1);
    if (bf16) units(s, true);
    __syncthreads();
    const float* fs = ring + (long)(s % kDwStages) * L.stage_floats;
    const float* gs = fs + L.rows * L.cf;
    const int nh = min(L.rows, n_hit - s * L.rows);
    if (busy) {
#pragma unroll 2
      for (int h = grp; h < nh; h += L.groups) {
        float av[kMT], bv[kMT];
#pragma unroll
        for (int q = 0; q < kMT / 4; ++q) {
          const float4 a = *reinterpret_cast<const float4*>(
              fs + h * L.cf + f_off(q));
          const float4 b = *reinterpret_cast<const float4*>(
              gs + h * L.cg + g_off(q));
          av[4 * q] = a.x; av[4 * q + 1] = a.y;
          av[4 * q + 2] = a.z; av[4 * q + 3] = a.w;
          bv[4 * q] = b.x; bv[4 * q + 1] = b.y;
          bv[4 * q + 2] = b.z; bv[4 * q + 3] = b.w;
        }
#pragma unroll
        for (int u = 0; u < kMT; ++u)
#pragma unroll
          for (int v = 0; v < kMT; ++v)
            acc[kMT * u + v] = fmaf(av[u], bv[v], acc[kMT * u + v]);
      }
    }
    __syncthreads();
  }
  cp_async_wait(0);

  // 4) the block to partial[chunk][k]; groups' partials added in order
  float* dst = partial + ((long)chunk * n_taps + k) * c_in * c_out;
  // element q of micro-tile (tc_, to_): row chunk u / 4, column chunk v / 4
  auto put = [&](int tc_, int to_, int q, float v) {
    const int u = q / kMT, x = q - u * kMT;
    const int ci = 4 * (tc_ + L.tc * (u >> 2)) + (u & 3);
    const int co = co0 + 4 * (to_ + L.to * (x >> 2)) + (x & 3);
    if (ci < c_in && co < c_out) dst[(long)ci * c_out + co] = v;
  };
  if (L.groups == 1) {
    if (busy)
#pragma unroll
      for (int q = 0; q < kMT * kMT; ++q) put(tc, to, q, acc[q]);
    return;
  }
  __syncthreads();     // the hit list and the ring are dead
  float* red = reinterpret_cast<float*>(smem);   // [groups][m][kMT^2]
  if (busy)
#pragma unroll
    for (int q = 0; q < kMT * kMT; ++q)
      red[tid * kMT * kMT + q] = acc[q];   // group grp, thread i_mt
  __syncthreads();
  const int n_el = L.m * kMT * kMT;
  for (int e = tid; e < n_el; e += kDwThreads) {
    float v = 0.0f;
    for (int j = 0; j < L.groups; ++j) v += red[j * n_el + e];
    const int i = e / (kMT * kMT);
    put(i / L.to, i - (i / L.to) * L.to, e - i * kMT * kMT, v);
  }
}

// dW = sum of the per-chunk partials, in chunk order.
__global__ void band_conv_dw_sum_kernel(const float* __restrict__ partial,
                                        int n_chunks, long n,
                                        float* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int ch = 0; ch < n_chunks; ++ch) s += partial[(long)ch * n + i];
  out[i] = s;
}

// Bytes of K4's source table, rounded up; the partials follow it.
long dw_src_bytes(int n_taps, int n_tiles, int tile) {
  return ((long)n_taps * n_tiles * tile * sizeof(int) + 255) / 256 * 256;
}

// K4's sums over the tap-major source table src[K][n_rows] (chunks of
// chunk_rows rows), then the in-order sum of the partials into out
// (n_taps, c_in, c_out); n_chunks 0 writes zeros. Returns the launch error.
int launch_dw_sums(const float* feats, const float* g, const int* src,
                   int c_in, int c_out, int n_taps, int bf16, int n_rows,
                   int chunk_rows, int n_chunks, float* partial, float* out,
                   cudaStream_t stream) {
  const long n = (long)n_taps * c_in * c_out;
  if (n_chunks > 0) {
    const DwLayout l = dw_layout_of(c_in, c_out, chunk_rows);
    if (l.smem > kSmemMax) return -1;
    using Kernel = decltype(&band_conv_dw_kernel<4>);
    static const Kernel kernels[2] = {band_conv_dw_kernel<4>,
                                      band_conv_dw_kernel<8>};
    static long smem_set[2] = {0, 0};
    const int v = l.mt == 8;
    int err = allow_smem(kernels[v], l.smem, &smem_set[v]);
    if (err != 0) return err;
    const int vec4f = c_in % 4 == 0 && (uintptr_t)feats % 16 == 0;
    const int vec4g = c_out % 4 == 0 && (uintptr_t)g % 16 == 0;
    const dim3 grid(n_chunks, n_taps, l.n_slabs);
    kernels[v]<<<grid, kDwThreads, l.smem, stream>>>(
        feats, g, src, c_in, c_out, n_taps, bf16, n_rows, chunk_rows, vec4f,
        vec4g, partial);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  band_conv_dw_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, n_chunks, n, out);
  return (int)cudaGetLastError();
}

// The neighbor-map weight gradient's source pass: a thread per output row
// writes src[k * n_out + row] = nmap[row][k] for every tap k (-1: missing,
// or not one of the n_in feature rows); the row's taps are read from one
// cached line, each tap's column written coalesced.
__global__ void __launch_bounds__(256) nmap_dw_src_kernel(
    const int* __restrict__ nmap, int n_out, int n_in, int n_taps,
    int* __restrict__ src) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_out) return;
  for (int k = 0; k < n_taps; ++k) {
    const int idx = nmap[(long)row * n_taps + k];
    src[(long)k * n_out + row] = idx >= 0 && idx < n_in ? idx : -1;
  }
}

}  // namespace

extern "C" long band_conv_fwd_scratch_bytes(int c_in, int c_out, int n_taps,
                                            int bf16, int patch) {
  // bytes of the prepped weights band_conv_fwd takes as `wprep`: K1's
  // copy, then (bf16 with a patch) the patch's f32 copy
  const Layout l = layout_of(c_in, c_out, n_taps, 1, 1, bf16 != 0);
  long bytes = prepped_weight_bytes(l, n_taps, bf16 != 0);
  if (bf16 && patch)
    bytes = (bytes + 255) / 256 * 256 + prepped_weight_bytes(
        layout_of(c_in, c_out, n_taps, 0, 0, false), n_taps, false);
  return bytes;
}

// Launches K1's kernel; after a patch launch (pdl), with programmatic
// stream serialization, so it runs beside the patch's grid.
template <typename... Params, typename... Args>
int launch_k1(void (*kernel)(Params...), dim3 grid, int threads, long smem,
              cudaStream_t stream, bool pdl, Args... args) {
  if (!pdl) {
    kernel<<<grid, threads, smem, stream>>>(args...);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// band_conv_fwd for feature rows of type TIn and output rows of type TOut.
template <typename TIn, typename TOut>
int band_conv_fwd_typed(
    const TIn* feats, const int* keys, const int* base_keys,
    const int* valid_bits, const int* blk, const float* weights,
    int n_in, int c_in, int c_out, int n_taps, int n_groups,
    const int* geo, const float* scale, const float* bias,
    int affine, int relu, int bf16, int tile, int block, int n_tiles,
    int n_out, const bool* fits, const long long* pidx, const int* pnmap,
    int n_patch, void* wprep, TOut* out, cudaStream_t stream) {
  const bool b16 = bf16 != 0;
  const bool patched = n_patch > 0;
  const Layout l = layout_of(c_in, c_out, n_taps, n_groups, block, b16);
  const Layout lp = layout_of(c_in, c_out, n_taps, 0, 0, false);  // patch
  if (l.smem > kSmemMax || lp.smem > kSmemMax) return -1;
  // 16-byte loads of the feature rows: 4 f32 or 8 bf16 values
  const int vec4 = c_in % (16 / (int)sizeof(TIn)) == 0 &&
                   (uintptr_t)feats % 16 == 0;
  // f32 calls: the patch reads K1's copy; bf16 calls: its own f32 copy
  void* wpatch = wprep;
  WeightCopy second{0, 0, 0, 0, nullptr};
  if (b16 && patched) {
    wpatch = static_cast<char*>(wprep) +
             (prepped_weight_bytes(l, n_taps, true) + 255) / 256 * 256;
    second = weight_copy(lp, false, wpatch);
  }
  int err = prep_weights(weights, n_taps, c_in, c_out, l, b16, wprep, stream,
                         second);
  if (err != 0) return err;
  if (!patched) fits = nullptr;

  // the gather patch, in the mode of the same widths, first
  if (patched && lp.row_mode) {
    const auto kernel = lp.slab == 8
                            ? patch_row_kernel<8, TIn, TOut>
                            : patch_row_kernel<kRowMaxCout, TIn, TOut>;
    static long smem_set[2] = {0, 0};
    const long smem = lp.smem + (long)n_taps * kRowThreads * sizeof(int);
    err = allow_smem(kernel, smem, &smem_set[lp.slab != 8]);
    if (err != 0) return err;
    kernel<<<(unsigned)((n_patch + kRowThreads - 1) / kRowThreads),
             kRowThreads, smem, stream>>>(
        feats, pnmap, pidx, static_cast<const float*>(wpatch), n_patch,
        n_in, c_in, c_out, n_taps, vec4, scale, bias, affine, relu, out);
  } else if (patched) {
    const auto kernel = lp.slab > 16 ? patch_tile_kernel<8, TIn, TOut>
                                     : patch_tile_kernel<2, TIn, TOut>;
    static long smem_set[2] = {0, 0};
    err = allow_smem(kernel, lp.smem, &smem_set[lp.slab > 16]);
    if (err != 0) return err;
    const dim3 grid((unsigned)((n_patch + kTileRows - 1) / kTileRows),
                    (unsigned)lp.n_slabs);
    kernel<<<grid, kTileThreads, lp.smem, stream>>>(
        feats, pnmap, pidx, wpatch, n_patch, n_in, c_in, c_out, n_taps,
        vec4, scale, bias, affine, relu, out);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  if (l.row_mode) {
    const dim3 grid((unsigned)(((long)n_tiles * tile + kRowThreads - 1) /
                               kRowThreads));
    const auto row_kernel =
        l.slab == 8
            ? (b16 ? band_conv_row_kernel<true, 8, TIn, TOut>
                   : band_conv_row_kernel<false, 8, TIn, TOut>)
            : (b16 ? band_conv_row_kernel<true, kRowMaxCout, TIn, TOut>
                   : band_conv_row_kernel<false, kRowMaxCout, TIn, TOut>);
    return launch_k1(row_kernel, grid, kRowThreads, l.smem, stream, patched,
                     feats, keys, base_keys, valid_bits, blk,
                     static_cast<const float*>(wprep), n_in, c_in, c_out,
                     n_taps, n_groups, geo, scale, bias, affine, relu, tile,
                     block, (long)n_tiles * tile, n_out, vec4, fits, out);
  }
  // tile mode: one instantiation per operand type and slab (<= 16, <= 64)
  using Kernel = decltype(&band_conv_kernel<true, 2, TIn, TOut>);
  static const Kernel kernels[4] = {
      band_conv_kernel<false, 2, TIn, TOut>,
      band_conv_kernel<false, 8, TIn, TOut>,
      band_conv_kernel<true, 2, TIn, TOut>,
      band_conv_kernel<true, 8, TIn, TOut>};
  static long smem_set[4] = {0, 0, 0, 0};  // largest size granted
  const int v = 2 * b16 + (l.slab > 16);
  err = allow_smem(kernels[v], l.smem, &smem_set[v]);
  if (err != 0) return err;
  const int cpt = (tile + kTileRows - 1) / kTileRows;
  const dim3 grid((unsigned)((long)n_tiles * cpt), (unsigned)l.n_slabs);
  return launch_k1(kernels[v], grid, kTileThreads, l.smem, stream, patched,
                   feats, keys, base_keys, valid_bits, blk,
                   static_cast<const void*>(wprep), n_in, c_in, c_out,
                   n_taps, n_groups, geo, scale, bias, affine, relu, tile,
                   block, n_out, vec4, fits, out);
}

extern "C" int band_conv_fwd(
    const void* feats, const int* keys, const int* base_keys,
    const int* valid_bits, const int* blk, const float* weights,
    int n_in, int c_in, int c_out, int n_taps, int n_groups,
    const int* geo, const float* scale, const float* bias,
    int affine, int relu, int bf16, int tile, int block, int n_tiles,
    int n_out, const bool* fits, const long long* pidx, const int* pnmap,
    int n_patch, int feats_bf16, int out_bf16, void* wprep, void* out,
    cudaStream_t stream) {
  // feats (n_in, c_in) f32, or bf16 when feats_bf16; out (n_out, c_out)
  // f32, or bf16 when out_bf16 (the sums and the epilogue stay f32, the
  // store rounds to nearest even). base_keys / valid_bits / blk cover
  // n_tiles * tile rows; wprep holds band_conv_fwd_scratch_bytes bytes
  // (patch = n_patch > 0). The patch: pidx (n_patch,) every valid row of
  // the tiles whose fits (n_tiles,) is false, pnmap (n_patch, n_taps) their
  // neighbor map. K1 then computes only the other tiles' rows (and zeros
  // the invalid rows of those tiles), in a grid beside the patch's.
  if (n_taps < 1 || n_taps > kMaxTaps || c_in < 1 || c_in > kMaxCin ||
      c_out < 1 || n_groups < 1 || n_groups > kMaxGroups || tile < 1 ||
      block < 1 || block > kMaxBlock || n_patch < 0 ||
      (n_patch > 0 && (fits == nullptr || pidx == nullptr ||
                       pnmap == nullptr)))
    return -1;
  if (n_tiles == 0) return 0;
#define BAND_CONV_FWD(TIN, TOUT)                                             \
  return band_conv_fwd_typed<TIN, TOUT>(                                     \
      static_cast<const TIN*>(feats), keys, base_keys, valid_bits, blk,     \
      weights, n_in, c_in, c_out, n_taps, n_groups, geo, scale, bias,       \
      affine, relu, bf16, tile, block, n_tiles, n_out, fits, pidx, pnmap,   \
      n_patch, wprep, static_cast<TOUT*>(out), stream)
  if (feats_bf16 && out_bf16) BAND_CONV_FWD(__nv_bfloat16, __nv_bfloat16);
  if (feats_bf16) BAND_CONV_FWD(__nv_bfloat16, float);
  if (out_bf16) BAND_CONV_FWD(float, __nv_bfloat16);
  BAND_CONV_FWD(float, float);
#undef BAND_CONV_FWD
}

extern "C" long band_conv_dw_scratch_bytes(int n_taps, int c_in, int c_out,
                                           int n_tiles, int tile,
                                           int tiles_per_chunk) {
  // the source table src[K][n_tiles * tile] int32, then the per-chunk
  // partials (chunks, K, C, C') f32
  const long n_chunks = (n_tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  return dw_src_bytes(n_taps, n_tiles, tile) +
         n_chunks * n_taps * c_in * c_out * (long)sizeof(float);
}

extern "C" int band_conv_dw(
    const float* feats, const int* keys, const int* base_keys,
    const int* valid_bits, const int* blk, const float* g,
    int n_in, int c_in, int c_out, int n_taps, int n_groups,
    const int* geo, int bf16, int tile, int block, int n_tiles, int n_out,
    int tiles_per_chunk, void* scratch, float* out, cudaStream_t stream) {
  // scratch holds band_conv_dw_scratch_bytes bytes; out is
  // (n_taps, c_in, c_out).
  if (n_taps < 1 || n_taps > kMaxTaps || c_in < 1 || c_in > kMaxCin ||
      c_out < 1 || n_groups < 1 || n_groups > kMaxGroups || tile < 1 ||
      tile > kDwMaxTile || block < 1 || block > kMaxBlock ||
      tiles_per_chunk < 1 || (long)tiles_per_chunk * tile > kDwMaxChunk)
    return -1;
  const int n_chunks = (n_tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  int* src = static_cast<int*>(scratch);
  float* partial = reinterpret_cast<float*>(
      static_cast<char*>(scratch) + dw_src_bytes(n_taps, n_tiles, tile));
  if (n_chunks > 0) {
    const long keys_smem = (long)n_groups * 2 * block * sizeof(int);
    static long src_smem_set = 0;
    int err = allow_smem(band_conv_dw_src_kernel, keys_smem, &src_smem_set);
    if (err != 0) return err;
    band_conv_dw_src_kernel<<<n_tiles, kDwThreads, keys_smem, stream>>>(
        keys, base_keys, valid_bits, blk, n_in, n_taps, n_groups, geo, tile,
        block, n_out, src);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int n_rows = n_tiles * tile;
  return launch_dw_sums(feats, g, src, c_in, c_out, n_taps, bf16, n_rows,
                        min(tiles_per_chunk * tile, n_rows), n_chunks,
                        partial, out, stream);
}

extern "C" long nmap_conv_dw_scratch_bytes(int n_taps, int c_in, int c_out,
                                           int n_out, int chunk_rows) {
  // the source table src[K][n_out] int32, then the per-chunk partials
  // (chunks, K, C, C') f32
  const long n_chunks = ((long)n_out + chunk_rows - 1) / chunk_rows;
  return dw_src_bytes(n_taps, n_out, 1) +
         n_chunks * n_taps * c_in * c_out * (long)sizeof(float);
}

extern "C" int nmap_conv_dw(const float* feats, const int* nmap,
                            const float* g, int n_in, int n_out, int c_in,
                            int c_out, int n_taps, int chunk_rows,
                            void* scratch, float* out, cudaStream_t stream) {
  // feats (n_in, c_in), nmap (n_out, n_taps) of feature rows (-1 =
  // missing), g (n_out, c_out); out (n_taps, c_in, c_out) = sum over rows
  // r with a tap-k source of feats[nmap[r][k]]^T g[r], f32 operands, in
  // K4's CTAs of chunk_rows rows; scratch holds nmap_conv_dw_scratch_bytes
  // bytes.
  if (n_taps < 1 || c_in < 1 || c_in > kMaxCin || c_out < 1 || n_in < 0 ||
      n_out < 0 || chunk_rows < 1 || chunk_rows > kDwMaxChunk)
    return -1;
  const int n_chunks = (n_out + chunk_rows - 1) / chunk_rows;
  int* src = static_cast<int*>(scratch);
  float* partial = reinterpret_cast<float*>(
      static_cast<char*>(scratch) + dw_src_bytes(n_taps, n_out, 1));
  if (n_chunks > 0) {
    nmap_dw_src_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, stream>>>(
        nmap, n_out, n_in, n_taps, src);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return launch_dw_sums(feats, g, src, c_in, c_out, n_taps, 0, n_out,
                        min(chunk_rows, n_out), n_chunks, partial, out,
                        stream);
}
