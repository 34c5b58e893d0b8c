// Band-window sparse convolution: the forward (K1: one CTA per 64 output
// rows of a plan tile and output-channel slab, or a thread per row for
// narrow layers) and the weight gradient (K4, one CTA per tap, channel slab
// and tile chunk).
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

// K4 replaces virconv_tpu/ops/pallas/band_conv.py::_dw_kernel:
// dW[k] = gather_k(feats)^T @ (g * row_ok), summed over every tile. The TPU
// kernel keeps the whole (K*C, C') f32 sum resident and revisits it across a
// sequential grid; CTAs here run in no order and the full dW (442 KB at
// C = C' = 64) does not fit one SM, so each CTA owns dW[k][ci0:+64][co0:+16]
// for one chunk of tiles, compacts the rows of each tile that hit a source
// (warp ballots, in row order), stages their feats and g rows in shared
// memory and accumulates the outer products in registers on CUDA cores. A
// second kernel sums the per-chunk partials in chunk order. No float
// atomics: the result has the same bits on every run.

#include "common.cuh"

namespace {

constexpr int kMaxTaps = 30;       // tap bits lie below the row-valid bit
constexpr int kMaxCin = 128;
constexpr int kMaxGroups = 3;      // dy groups of a 3-wide kernel
constexpr int kMaxBlock = 2048;
constexpr int kRowValidBit = 30;
constexpr int kRows = 64;          // output rows per CTA
constexpr int kThreads = 128;      // warp w owns rows 16w .. 16w + 15
constexpr int kMaxSlab = 64;       // output channels per CTA
constexpr int kMaxStages = 4;
constexpr int kStageBudget = 24 * 1024;  // tile mode's ring
constexpr int kRowMaxCin = 8;            // row mode's widest input
constexpr int kRowMaxCout = 16;          // and output
constexpr int kRowThreads = 128;
constexpr int kSmemMax = 232448 - 4096;  // dynamic, beside the static

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

// The launch geometry of one K1 call, shared by the entry point and the
// kernels. Row mode (C <= kRowMaxCin, C' <= kRowMaxCout): a thread per
// output row walks the taps its row hits and multiplies the rows it
// gathers with every tap's weights resident in shared memory. Tile mode: a
// CTA ring of n_stages (64 gathered rows, W[k] tile) stages over the taps
// any row of the CTA hits, each warp multiplying its 16 rows.
struct Layout {
  int ck;          // input channels rounded up to a power of two >= 16
  int slab;        // output channels per CTA
  int n_slabs;
  int n_pad;       // n_slabs * slab: columns of the prepped weights
  int row_mode;
  int a_stride;    // floats per gathered row (bf16: ck + 8, conflict-free
                   // fragments)
  int w_tap;       // bytes of one tap's weight tile
  int n_stages;    // tile mode's ring depth
  int tile_pitch;  // bytes of one stage: gathered rows, then W[k]
  long area_off;   // window keys, then the resident weights or the ring
  long smem;       // dynamic shared bytes
};

__host__ __device__ inline Layout layout_of(int c_in, int c_out, int n_taps,
                                            int n_groups, int block,
                                            bool bf16) {
  Layout l;
  l.ck = 16;
  while (l.ck < c_in) l.ck *= 2;
  l.n_slabs = (c_out + kMaxSlab - 1) / kMaxSlab;
  l.slab = ((c_out + l.n_slabs - 1) / l.n_slabs + 7) / 8 * 8;
  l.n_pad = l.n_slabs * l.slab;
  l.row_mode = c_in <= kRowMaxCin && c_out <= kRowMaxCout;
  l.a_stride = bf16 ? l.ck + 8 : l.ck;
  const long src_bytes = (long)kRows * n_taps * sizeof(int);
  const long keys_bytes = (long)n_groups * 2 * block * sizeof(int);
  l.area_off = src_bytes;
  if (l.row_mode) {
    // W (K, c_in, 8 or 16) f32, all of it
    l.ck = c_in;
    l.slab = l.n_pad = c_out <= 8 ? 8 : kRowMaxCout;
    l.n_slabs = 1;
    l.w_tap = c_in * l.slab * 4;
    l.n_stages = 0;
    l.tile_pitch = 0;
    l.smem = (long)n_taps * l.w_tap;
  } else {
    // bf16: W^T tile (slab, ck + 8); f32: W tile (ck, slab)
    l.w_tap = bf16 ? l.slab * (l.ck + 8) * 2 : l.ck * l.slab * 4;
    l.tile_pitch = kRows * l.a_stride * 4 + l.w_tap;
    l.n_stages = kStageBudget / l.tile_pitch;
    l.n_stages = l.n_stages < 2 ? 2
               : (l.n_stages > kMaxStages ? kMaxStages : l.n_stages);
    const long ring = (long)l.n_stages * l.tile_pitch;
    l.smem = src_bytes + (keys_bytes > ring ? keys_bytes : ring);
  }
  return l;
}

// The weights of one call rearranged once, zero-padded: for the tile
// mode's bf16 copies (K, n_pad, ck) = W[k]^T rounded to bf16; else
// (K, ck, n_pad) f32 (row mode: ck = C, n_pad = 8 or 16), rounded to
// bf16 values when `round`.
__global__ void band_conv_prep_kernel(const float* __restrict__ w,
                                      int n_taps, int c_in, int c_out,
                                      int ck, int n_pad, int transposed,
                                      int round, void* __restrict__ wprep) {
  const long total = (long)n_taps * ck * n_pad;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    int k, c, n;
    if (transposed) {
      c = (int)(i % ck);
      n = (int)((i / ck) % n_pad);
    } else {
      n = (int)(i % n_pad);
      c = (int)((i / n_pad) % ck);
    }
    k = (int)(i / ((long)ck * n_pad));
    const float v = (c < c_in && n < c_out)
        ? w[((long)k * c_in + c) * c_out + n] : 0.0f;
    if (transposed)
      static_cast<__nv_bfloat16*>(wprep)[i] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(wprep)[i] = maybe_bf16(v, round);
  }
}

// Copies tap k's weight tile of the slab at n0 into dst; thread t of nt.
template <bool kBf16>
__device__ __forceinline__ void copy_w_tile(unsigned char* dst,
                                            const void* wprep, int k,
                                            int n0, const Layout& L, int t,
                                            int nt) {
  if (kBf16) {
    const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(wprep) +
                             ((long)k * L.n_pad + n0) * L.ck;
    __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
    const int sh = __ffs(L.ck / 8) - 1;  // 16-byte chunks per row: 2^sh
    for (int i = t; i < L.slab << sh; i += nt) {
      const int n = i >> sh, c = (i - (n << sh)) * 8;
      cp_async16_cg(d + n * (L.ck + 8) + c, g + (long)n * L.ck + c);
    }
  } else {
    const float* g = static_cast<const float*>(wprep) +
                     (long)k * L.ck * L.n_pad + n0;
    float* d = reinterpret_cast<float*>(dst);
    const int chunks = L.slab / 4;
    for (int i = t; i < L.ck * chunks; i += nt) {
      const int c = i / chunks, j = (i - c * chunks) * 4;
      cp_async16_cg(d + c * L.slab + j, g + (long)c * L.n_pad + j);
    }
  }
}

// Copies the first c_in floats of feats[src[r]] into row r of a, for the
// 64 rows whose 16-row fragment bit is set in frag_mask (zeros where
// src[r] is -1). The pad columns stay as they are (zero).
__device__ __forceinline__ void gather_rows(float* a, int a_stride,
                                            const int* src, int frag_mask,
                                            const float* __restrict__ feats,
                                            int c_in, int vec4, int t) {
  const int width = vec4 ? c_in >> 2 : c_in;  // copies per row
  const bool pow2 = (width & (width - 1)) == 0;
  const int sh = __ffs(width) - 1;
  for (int i = t; i < kRows * width; i += kThreads) {
    const int rr = pow2 ? i >> sh : i / width;
    if (!((frag_mask >> (rr >> 4)) & 1)) continue;
    const int s = src[rr];
    if (vec4) {
      const int c = (i - rr * width) * 4;
      cp_async16_ca(a + rr * a_stride + c,
                    s >= 0 ? feats + (long)s * c_in + c : feats,
                    s >= 0 ? 16 : 0);
    } else {
      const int c = i - rr * width;
      cp_async4(a + rr * a_stride + c,
                s >= 0 ? feats + (long)s * c_in + c : feats,
                s >= 0 ? 4 : 0);
    }
  }
}

// acc += (16 gathered rows at a16) @ (one tap's weight tile w) for the
// calling warp. bf16: mma.sync m16n8k16, acc[4 nt + e] = element e of
// column tile nt's C fragment (rows g, g + 8; columns 8 nt + 2q + (0, 1));
// f32: fmaf in channel order, acc[kNT r + j] = row ty + 4r, column
// tx + 8j.
template <bool kBf16, int kNT>
__device__ __forceinline__ void tap_product(float* acc, const float* a16,
                                            const unsigned char* w,
                                            const Layout& L, int c_in,
                                            int lane) {
  const int n_tiles = L.slab / 8;
  if (kBf16) {
    const int g = lane >> 2, q = lane & 3;
    const float* a0 = a16 + g * L.a_stride + 2 * q;
    const float* a1 = a0 + 8 * L.a_stride;
    const __nv_bfloat16* wb =
        reinterpret_cast<const __nv_bfloat16*>(w) + g * (L.ck + 8) + 2 * q;
    const int k_end = (c_in + 15) & ~15;  // further columns are zeros
    for (int kk = 0; kk < k_end; kk += 16) {
      const float2 x00 = *reinterpret_cast<const float2*>(a0 + kk);
      const float2 x10 = *reinterpret_cast<const float2*>(a1 + kk);
      const float2 x01 = *reinterpret_cast<const float2*>(a0 + kk + 8);
      const float2 x11 = *reinterpret_cast<const float2*>(a1 + kk + 8);
      const uint32_t A0 = pack_bf16x2(x00.x, x00.y);
      const uint32_t A1 = pack_bf16x2(x10.x, x10.y);
      const uint32_t A2 = pack_bf16x2(x01.x, x01.y);
      const uint32_t A3 = pack_bf16x2(x11.x, x11.y);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (nt < n_tiles) {
          const __nv_bfloat16* b = wb + nt * 8 * (L.ck + 8) + kk;
          mma_bf16_16816(acc + 4 * nt, A0, A1, A2, A3,
                         *reinterpret_cast<const uint32_t*>(b),
                         *reinterpret_cast<const uint32_t*>(b + 8));
        }
      }
    }
  } else {
    const int ty = lane >> 3, tx = lane & 7;
    const float* ap = a16 + ty * L.a_stride;
    const float* wf = reinterpret_cast<const float*>(w) + tx;
    const int c_end = (c_in + 3) & ~3;  // padded channels are zeros
    for (int c = 0; c < c_end; c += 4) {
      float4 av[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        av[r] = *reinterpret_cast<const float4*>(ap + 4 * r * L.a_stride + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float bv[kNT];
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          bv[j] = j < n_tiles ? wf[(c + cc) * L.slab + 8 * j] : 0.0f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = cc == 0 ? av[r].x : cc == 1 ? av[r].y
                        : cc == 2 ? av[r].z : av[r].w;
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            if (j < n_tiles)
              acc[kNT * r + j] = fmaf(x, bv[j], acc[kNT * r + j]);
        }
      }
    }
  }
}

// Row mode: a thread per output row over every output channel (kCout, 8
// or 16, a compile-time stride of the resident weights). The row's sources
// come from lower-bound searches in global memory (the window keys are read
// through L1), all before the sums; the hit taps' rows are summed in tap
// then channel order with fmaf.
template <bool kBf16, int kCout>
__global__ void __launch_bounds__(kRowThreads) band_conv_row_kernel(
    const float* __restrict__ feats, const int* __restrict__ keys,
    const int* __restrict__ base_keys, const int* __restrict__ valid_bits,
    const int* __restrict__ blk, const float* __restrict__ wprep,
    int n_in, int c_in, int c_out, int n_taps, int n_groups,
    const int* __restrict__ geo, const float* __restrict__ scale,
    const float* __restrict__ bias, int affine, int relu, int tile,
    int block, long n_rows, int n_out, int vec4, float* __restrict__ out) {
  extern __shared__ __align__(16) float w_s[];  // (K, c_in, kCout)
  __shared__ int geo_s[2 * kMaxTaps];
  __shared__ int src_s[kMaxTaps * kRowThreads];
  const int tid = threadIdx.x;
  for (int i = tid; i < n_taps * c_in * kCout; i += kRowThreads)
    w_s[i] = wprep[i];
  for (int i = tid; i < 2 * n_taps; i += kRowThreads) geo_s[i] = geo[i];
  __syncthreads();
  const long row = (long)blockIdx.x * kRowThreads + tid;
  if (row >= n_rows) return;
  const long t = row / tile;
  const int bits = valid_bits[row];
  const int qk = base_keys[row];
  // every tap's source first: independent searches, then the sums
  for (int k = 0; k < n_taps; ++k)
    src_s[k * kRowThreads + tid] = ((bits >> k) & 1) ? band_source(
        keys, n_in, qk + geo_s[k],
        (long)blk[t * n_groups + geo_s[n_taps + k]] * block, block) : -1;
  float acc[kCout];
#pragma unroll
  for (int j = 0; j < kCout; ++j) acc[j] = 0.0f;
  for (int k = 0; k < n_taps; ++k) {
    const int src = src_s[k * kRowThreads + tid];
    if (src < 0) continue;
    const float* f = feats + (long)src * c_in;
    float x[kRowMaxCin];
#pragma unroll
    for (int c = 0; c < kRowMaxCin; c += 4) {
      if (c < c_in && vec4) {
        const float4 v = *reinterpret_cast<const float4*>(f + c);
        x[c] = v.x; x[c + 1] = v.y; x[c + 2] = v.z; x[c + 3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[c + e] = c + e < c_in ? f[c + e] : 0.0f;
      }
    }
    const float* w = w_s + k * c_in * kCout;
#pragma unroll
    for (int c = 0; c < kRowMaxCin; ++c) {
      if (c >= c_in) break;
      const float xv = maybe_bf16(x[c], kBf16);
#pragma unroll
      for (int j = 0; j < kCout; ++j)
        acc[j] = fmaf(xv, w[c * kCout + j], acc[j]);
    }
  }
  if (row >= n_out) return;
  const float ok = ((bits >> kRowValidBit) & 1) ? 1.0f : 0.0f;
#pragma unroll
  for (int j = 0; j < kCout; ++j) {
    if (j >= c_out) break;
    float v = acc[j];
    if (affine) v = __fadd_rn(__fmul_rn(v, scale[j]), bias[j]);
    if (relu) v = fmaxf(v, 0.0f);
    out[row * c_out + j] = v * ok;
  }
}

// Tile mode. kNT: the most 8-channel column tiles of a slab this
// instantiation takes.
template <bool kBf16, int kNT>
__global__ void __launch_bounds__(kThreads) band_conv_kernel(
    const float* __restrict__ feats, const int* __restrict__ keys,
    const int* __restrict__ base_keys, const int* __restrict__ valid_bits,
    const int* __restrict__ blk, const void* __restrict__ wprep,
    int n_in, int c_in, int c_out, int n_taps, int n_groups,
    const int* __restrict__ geo,  // deltas[K] then group_of[K]
    const float* __restrict__ scale, const float* __restrict__ bias,
    int affine, int relu, int tile, int block, int n_out, int vec4,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int geo_s[2 * kMaxTaps];
  __shared__ int tap_mask[kMaxTaps];   // bit f: fragment f has a hit
  __shared__ int tap_list[kMaxTaps];   // taps with any hit, in tap order
  __shared__ int n_active;
  __shared__ int win_lo[kMaxGroups], win_len[kMaxGroups];
  __shared__ float row_ok[kRows];

  const Layout L = layout_of(c_in, c_out, n_taps, n_groups, block, kBf16);
  int* src_s = reinterpret_cast<int*>(smem);              // [K][kRows]
  unsigned char* area = smem + L.area_off;
  int* keys_s = reinterpret_cast<int*>(area);             // [G][2 * block]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cpt = (tile + kRows - 1) / kRows;             // CTAs per tile
  const int t = blockIdx.x / cpt;
  const int r0 = (blockIdx.x - t * cpt) * kRows;
  const int n_rows = min(kRows, tile - r0);
  const long row_base = (long)t * tile + r0;
  const int n0 = blockIdx.y * L.slab;
  const int wlen = 2 * block;

  // 1) the tile's window keys of every group
  for (int i = tid; i < 2 * n_taps; i += kThreads) geo_s[i] = geo[i];
  for (int g = 0; g < n_groups; ++g) {
    const long ws = (long)blk[(long)t * n_groups + g] * block;
    const long lo = ws < 0 ? 0 : ws;
    long hi = ws + wlen;
    if (hi > n_in) hi = n_in;
    const int len = hi > lo ? (int)(hi - lo) : 0;
    if (tid == 0) { win_lo[g] = (int)lo; win_len[g] = len; }
    for (int i = tid; i < len; i += kThreads)
      keys_s[g * wlen + i] = keys[lo + i];
  }
  __syncthreads();

  // 2) sources: thread (r, half) searches row r's taps half, half + 2, ...
  //    four at a time, in the staged windows
  {
    const int r = tid & (kRows - 1);
    const bool in = r < n_rows;
    const int bits = in ? valid_bits[row_base + r] : 0;
    const int qk = in ? base_keys[row_base + r] : 0;
    if (tid < kRows) row_ok[r] = ((bits >> kRowValidBit) & 1) ? 1.0f : 0.0f;
    for (int k0 = tid >> 6; k0 < n_taps; k0 += 8) {
      int lo[4], n[4], q[4], g[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + 2 * u;
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
        const int k = k0 + 2 * u;
        if (k >= n_taps) continue;
        const bool on = (bits >> k) & 1;
        const bool hit = on && lo[u] < win_len[g[u]] &&
                         keys_s[g[u] * wlen + lo[u]] == q[u];
        src_s[k * kRows + r] = hit ? win_lo[g[u]] + lo[u] : -1;
      }
    }
  }
  __syncthreads();

  // 3) per tap, which 16-row fragments hit; the list of taps with any hit
  for (int k = warp; k < n_taps; k += kThreads / 32) {
    const unsigned m0 = __ballot_sync(0xffffffffu, src_s[k * kRows + lane] >= 0);
    const unsigned m1 =
        __ballot_sync(0xffffffffu, src_s[k * kRows + 32 + lane] >= 0);
    if (lane == 0)
      tap_mask[k] = ((m0 & 0xffffu) ? 1 : 0) | ((m0 >> 16) ? 2 : 0) |
                    ((m1 & 0xffffu) ? 4 : 0) | ((m1 >> 16) ? 8 : 0);
  }
  __syncthreads();  // the window keys are dead: the ring reuses their room
  if (tid == 0) {
    int na = 0;
    for (int k = 0; k < n_taps; ++k)
      if (tap_mask[k]) tap_list[na++] = k;
    n_active = na;
  }
  // the gathered rows' pad columns [c_in, ck) are zero once for all taps
  const int pad = L.ck - c_in;
  for (int i = tid; i < L.n_stages * kRows * pad; i += kThreads) {
    const int rr = i / pad, c = c_in + i - rr * pad;  // rr: stage * 64 + row
    reinterpret_cast<float*>(area + (long)(rr / kRows) * L.tile_pitch)
        [(rr % kRows) * L.a_stride + c] = 0.0f;
  }
  __syncthreads();

  // 4) a ring of n_stages (64 gathered rows, W[k] tile) stages over the
  //    taps any row hits; warp w multiplies its 16 rows where they hit
  float acc[4 * kNT];
#pragma unroll
  for (int i = 0; i < 4 * kNT; ++i) acc[i] = 0.0f;
  const int a_bytes = kRows * L.a_stride * 4;
  auto stage = [&](int s) { return area + (long)s * L.tile_pitch; };
  auto issue = [&](int s, int k) {
    gather_rows(reinterpret_cast<float*>(stage(s)), L.a_stride,
                src_s + k * kRows, tap_mask[k], feats, c_in, vec4, tid);
    copy_w_tile<kBf16>(stage(s) + a_bytes, wprep, k, n0, L, tid, kThreads);
  };
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
    if ((tap_mask[tap_list[i]] >> warp) & 1) {
      const unsigned char* st = stage(i % L.n_stages);
      tap_product<kBf16, kNT>(
          acc, reinterpret_cast<const float*>(st) + warp * 16 * L.a_stride,
          st + a_bytes, L, c_in, lane);
    }
    __syncthreads();
  }
  cp_async_wait(0);

  // 5) epilogue: affine, ReLU, times the row-valid bit
  auto epilogue = [&](int rl, int co, float v) {
    const long row = row_base + rl;
    if (rl >= n_rows || row >= n_out || co >= c_out) return;
    if (affine) v = __fadd_rn(__fmul_rn(v, scale[co]), bias[co]);
    if (relu) v = fmaxf(v, 0.0f);
    out[row * c_out + co] = v * row_ok[rl];
  };
  const int n_tiles = L.slab / 8;
  if (kBf16) {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (nt >= n_tiles) continue;
      const int co = n0 + nt * 8 + 2 * q;
      epilogue(warp * 16 + g, co, acc[4 * nt]);
      epilogue(warp * 16 + g, co + 1, acc[4 * nt + 1]);
      epilogue(warp * 16 + g + 8, co, acc[4 * nt + 2]);
      epilogue(warp * 16 + g + 8, co + 1, acc[4 * nt + 3]);
    }
  } else {
    const int ty = lane >> 3, tx = lane & 7;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        if (j < n_tiles) epilogue(warp * 16 + ty + 4 * r, n0 + tx + 8 * j,
                                  acc[kNT * r + j]);
  }
}

constexpr int kDwMaxTile = 256;

constexpr int kDwCi = 64;        // input channels per CTA
constexpr int kDwCo = 16;        // output channels per CTA
constexpr int kDwStage = 64;     // hit rows staged in shared memory at once
constexpr int kDwThreads = 256;  // >= kDwMaxTile: one thread per tile row

__global__ void __launch_bounds__(kDwThreads) band_conv_dw_kernel(
    const float* __restrict__ feats, const int* __restrict__ keys,
    const int* __restrict__ base_keys, const int* __restrict__ valid_bits,
    const int* __restrict__ blk, const float* __restrict__ g,
    int n_in, int c_in, int c_out, int n_taps, int n_groups,
    const int* __restrict__ geo, int bf16, int tile, int block,
    int n_tiles, int n_out, int tiles_per_chunk,
    float* __restrict__ partial) {
  __shared__ int row_s[kDwMaxTile];
  __shared__ int src_s[kDwMaxTile];
  __shared__ int warp_hits[kDwThreads / 32];
  __shared__ float f_s[kDwStage][kDwCi];
  __shared__ float g_s[kDwStage][kDwCo];

  const int chunk = blockIdx.x;
  const int n_co = (c_out + kDwCo - 1) / kDwCo;
  const int co0 = (blockIdx.y % n_co) * kDwCo;
  const int ci0 = (blockIdx.y / n_co) * kDwCi;
  const int k = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int delta = geo[k], group = geo[n_taps + k];
  const int c = tid >> 2;            // this thread's input channel
  const int j0 = (tid & 3) * 4;      // and its 4 output channels
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  const int t_end = min((chunk + 1) * tiles_per_chunk, n_tiles);
  for (int t = chunk * tiles_per_chunk; t < t_end; ++t) {
    // 1) the source of each valid row for tap k, compacted in row order
    const int row = t * tile + tid;
    int src = -1;
    if (tid < tile && row < n_out) {
      const int bits = valid_bits[row];
      if (((bits >> kRowValidBit) & 1) && ((bits >> k) & 1))
        src = band_source(keys, n_in, base_keys[row] + delta,
                          (long)blk[t * n_groups + group] * block, block);
    }
    const unsigned hits = __ballot_sync(0xffffffffu, src >= 0);
    if (lane == 0) warp_hits[warp] = __popc(hits);
    __syncthreads();
    int before = 0, n_hit = 0;
    for (int w = 0; w < kDwThreads / 32; ++w) {
      before += w < warp ? warp_hits[w] : 0;
      n_hit += warp_hits[w];
    }
    if (src >= 0) {
      const int pos = before + __popc(hits & ((1u << lane) - 1u));
      row_s[pos] = row;
      src_s[pos] = src;
    }
    __syncthreads();

    // 2) outer products of the hit rows, kDwStage rows at a time
    for (int h0 = 0; h0 < n_hit; h0 += kDwStage) {
      const int nh = min(kDwStage, n_hit - h0);
      for (int i = tid; i < nh * kDwCi; i += kDwThreads) {
        const int r = i / kDwCi, ci = ci0 + i % kDwCi;
        f_s[r][i % kDwCi] = ci < c_in
            ? maybe_bf16(feats[(long)src_s[h0 + r] * c_in + ci], bf16)
            : 0.0f;
      }
      for (int i = tid; i < nh * kDwCo; i += kDwThreads) {
        const int r = i / kDwCo, co = co0 + i % kDwCo;
        g_s[r][i % kDwCo] = co < c_out
            ? maybe_bf16(g[(long)row_s[h0 + r] * c_out + co], bf16)
            : 0.0f;
      }
      __syncthreads();
      for (int r = 0; r < nh; ++r) {
        const float x = f_s[r][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(x, g_s[r][j0 + j], acc[j]);
      }
      __syncthreads();
    }
  }

  const int ci = ci0 + c;
  if (ci < c_in) {
    float* dst = partial + ((long)chunk * n_taps + k) * c_in * c_out
        + (long)ci * c_out;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + j0 + j;
      if (co < c_out) dst[co] = acc[j];
    }
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

}  // namespace

extern "C" long band_conv_fwd_scratch_bytes(int c_in, int c_out, int n_taps,
                                            int bf16) {
  // bytes of the prepped weights band_conv_fwd takes as `wprep`
  const Layout l = layout_of(c_in, c_out, n_taps, 1, 1, bf16 != 0);
  const bool transposed = bf16 && !l.row_mode;
  return (long)n_taps * l.ck * l.n_pad * (transposed ? 2 : 4);
}

extern "C" int band_conv_fwd(
    const float* feats, const int* keys, const int* base_keys,
    const int* valid_bits, const int* blk, const float* weights,
    int n_in, int c_in, int c_out, int n_taps, int n_groups,
    const int* geo, const float* scale, const float* bias,
    int affine, int relu, int bf16, int tile, int block, int n_tiles,
    int n_out, void* wprep, float* out, cudaStream_t stream) {
  // base_keys / valid_bits / blk cover n_tiles * tile rows; out has the
  // n_out unpadded rows; wprep holds band_conv_fwd_scratch_bytes bytes.
  if (n_taps < 1 || n_taps > kMaxTaps || c_in < 1 || c_in > kMaxCin ||
      c_out < 1 || n_groups < 1 || n_groups > kMaxGroups || tile < 1 ||
      block < 1 || block > kMaxBlock)
    return -1;
  if (n_tiles == 0) return 0;
  const Layout l = layout_of(c_in, c_out, n_taps, n_groups, block, bf16 != 0);
  if (l.smem > kSmemMax) return -1;
  const int vec4 = c_in % 4 == 0 && (uintptr_t)feats % 16 == 0;

  const long total = (long)n_taps * l.ck * l.n_pad;
  const int prep_blocks = (int)((total + 255) / 256 < 1024
                                ? (total + 255) / 256 : 1024);
  band_conv_prep_kernel<<<prep_blocks, 256, 0, stream>>>(
      weights, n_taps, c_in, c_out, l.ck, l.n_pad, bf16 && !l.row_mode,
      bf16, wprep);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  if (l.row_mode) {
    const dim3 grid((unsigned)(((long)n_tiles * tile + kRowThreads - 1) /
                               kRowThreads));
    const auto row_kernel =
        l.slab == 8 ? (bf16 ? band_conv_row_kernel<true, 8>
                            : band_conv_row_kernel<false, 8>)
                    : (bf16 ? band_conv_row_kernel<true, kRowMaxCout>
                            : band_conv_row_kernel<false, kRowMaxCout>);
    row_kernel<<<grid, kRowThreads, l.smem, stream>>>(
        feats, keys, base_keys, valid_bits, blk,
        static_cast<const float*>(wprep), n_in, c_in, c_out, n_taps,
        n_groups, geo, scale, bias, affine, relu, tile, block,
        (long)n_tiles * tile, n_out, vec4, out);
    return (int)cudaGetLastError();
  }
  // tile mode: one instantiation per operand type and slab (<= 16, <= 64)
  using Kernel = decltype(&band_conv_kernel<true, 2>);
  static const Kernel kernels[4] = {
      band_conv_kernel<false, 2>, band_conv_kernel<false, 8>,
      band_conv_kernel<true, 2>, band_conv_kernel<true, 8>};
  static long smem_set[4] = {0, 0, 0, 0};  // largest size granted
  const int v = 2 * (bf16 != 0) + (l.slab > 16);
  if (l.smem > 48 * 1024 && l.smem > smem_set[v]) {
    err = (int)cudaFuncSetAttribute(
        kernels[v], cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)l.smem);
    if (err != 0) return err;
    smem_set[v] = l.smem;
  }
  const int cpt = (tile + kRows - 1) / kRows;
  const dim3 grid((unsigned)((long)n_tiles * cpt), (unsigned)l.n_slabs);
  kernels[v]<<<grid, kThreads, l.smem, stream>>>(
      feats, keys, base_keys, valid_bits, blk, wprep, n_in, c_in, c_out,
      n_taps, n_groups, geo, scale, bias, affine, relu, tile, block, n_out,
      vec4, out);
  return (int)cudaGetLastError();
}

extern "C" int band_conv_dw(
    const float* feats, const int* keys, const int* base_keys,
    const int* valid_bits, const int* blk, const float* g,
    int n_in, int c_in, int c_out, int n_taps, int n_groups,
    const int* geo, int bf16, int tile, int block, int n_tiles, int n_out,
    int tiles_per_chunk, float* partial, float* out, cudaStream_t stream) {
  // partial holds ceil(n_tiles / tiles_per_chunk) * n_taps * c_in * c_out
  // floats; out is (n_taps, c_in, c_out).
  if (n_taps > kMaxTaps || tile > kDwMaxTile || tiles_per_chunk < 1)
    return -1;
  const long n = (long)n_taps * c_in * c_out;
  const int n_chunks = (n_tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  if (n_chunks > 0) {
    const int n_slabs =
        ((c_in + kDwCi - 1) / kDwCi) * ((c_out + kDwCo - 1) / kDwCo);
    const dim3 grid(n_chunks, n_slabs, n_taps);
    band_conv_dw_kernel<<<grid, kDwThreads, 0, stream>>>(
        feats, keys, base_keys, valid_bits, blk, g, n_in, c_in, c_out,
        n_taps, n_groups, geo, bf16, tile, block, n_tiles, n_out,
        tiles_per_chunk, partial);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  band_conv_dw_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, n_chunks, n, out);
  return (int)cudaGetLastError();
}
