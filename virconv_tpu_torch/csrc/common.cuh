// Device helpers shared by the port's kernels: bf16 rounding, cp.async
// copies into shared memory, the bf16 tensor-core product, and the
// gathered-row convolution that K1 (band_conv.cu), K5 and K6
// (gather_conv.cu) share once each has its (row, tap) source table: the
// weight prep kernel, the tile mode's ring of gathered rows with its
// epilogue mapping, and the row mode's per-thread sums.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float maybe_bf16(float x, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Two floats rounded to bf16 and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared through L1; src_bytes < 16 zero-fills the
// rest (0: all zeros, the source is not read).
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src,
                                              int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

// 16-byte copy global -> shared, L2 only.
__device__ __forceinline__ void cp_async16_cg(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

// 4-byte copy global -> shared; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most n (0..3) committed groups are still in flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

// d += a (16 x 16, row major) @ b (16 x 8, column major), bf16 operands and
// f32 sums, in mma.sync's fragment layout.
__device__ __forceinline__ void mma_bf16_16816(float d[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---- gathered-row convolution ---------------------------------------------

constexpr int kTileRows = 64;       // output rows per CTA of the tile mode
constexpr int kTileThreads = 128;   // warp w owns rows 16w .. 16w + 15
constexpr int kTileMaxSlab = 64;    // output channels per CTA
constexpr int kTileMaxStages = 4;
constexpr int kTileStageBudget = 24 * 1024;  // the ring
constexpr int kRowMaxCin = 8;       // row mode's widest input
constexpr int kRowMaxCout = 16;     // and output
constexpr int kRowThreads = 128;    // a thread per output row
constexpr int kSmemMax = 232448 - 4096;  // dynamic, beside the static

// The launch geometry of one gathered-row conv. Row mode (C <= kRowMaxCin,
// C' <= kRowMaxCout): a thread per output row walks the taps its row hits
// and multiplies the rows it gathers with every tap's weights resident in
// shared memory. Tile mode: a CTA ring of n_stages (64 gathered rows, W[k]
// tile) stages over the taps any row of the CTA hits, each warp
// multiplying its 16 rows. Shared memory: the (tap, row) source table,
// then `area`: the window keys of n_groups groups (K1) and after them the
// ring in the same room, or the resident weights.
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
  l.n_slabs = (c_out + kTileMaxSlab - 1) / kTileMaxSlab;
  l.slab = ((c_out + l.n_slabs - 1) / l.n_slabs + 7) / 8 * 8;
  l.n_pad = l.n_slabs * l.slab;
  l.row_mode = c_in <= kRowMaxCin && c_out <= kRowMaxCout;
  l.a_stride = bf16 ? l.ck + 8 : l.ck;
  const long src_bytes = (long)kTileRows * n_taps * sizeof(int);
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
    l.tile_pitch = kTileRows * l.a_stride * 4 + l.w_tap;
    l.n_stages = kTileStageBudget / l.tile_pitch;
    l.n_stages = l.n_stages < 2 ? 2
               : (l.n_stages > kTileMaxStages ? kTileMaxStages : l.n_stages);
    const long ring = (long)l.n_stages * l.tile_pitch;
    l.smem = src_bytes + (keys_bytes > ring ? keys_bytes : ring);
  }
  return l;
}

// Bytes of the prepped weights of one call (weight_prep_kernel's output).
inline long prepped_weight_bytes(const Layout& l, int n_taps, bool bf16) {
  const bool transposed = bf16 && !l.row_mode;
  return (long)n_taps * l.ck * l.n_pad * (transposed ? 2 : 4);
}

// One rearranged copy of a call's weights (weight_prep_kernel's output):
// for the tile mode's bf16 copies (K, n_pad, ck) = W[k]^T rounded to
// bf16 (transposed); else (K, ck, n_pad) f32 (row mode: ck = C, n_pad = 8
// or 16), rounded to bf16 values when `round`; zero-padded.
struct WeightCopy {
  int ck, n_pad, transposed, round;
  void* out;   // null: no copy
};

inline WeightCopy weight_copy(const Layout& l, bool bf16, void* out) {
  return WeightCopy{l.ck, l.n_pad, bf16 && !l.row_mode, bf16, out};
}

__device__ __forceinline__ void write_weight_copy(
    const float* __restrict__ w, int n_taps, int c_in, int c_out,
    const WeightCopy& d) {
  const long total = d.out ? (long)n_taps * d.ck * d.n_pad : 0;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    int k, c, n;
    if (d.transposed) {
      c = (int)(i % d.ck);
      n = (int)((i / d.ck) % d.n_pad);
    } else {
      n = (int)(i % d.n_pad);
      c = (int)((i / d.n_pad) % d.ck);
    }
    k = (int)(i / ((long)d.ck * d.n_pad));
    const float v = (c < c_in && n < c_out)
        ? w[((long)k * c_in + c) * c_out + n] : 0.0f;
    if (d.transposed)
      static_cast<__nv_bfloat16*>(d.out)[i] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(d.out)[i] = maybe_bf16(v, d.round);
  }
}

// The weights of one call rearranged once into copy a, and into copy b
// when its `out` is set (the band conv's gather patch at bf16: its f32
// operands need their own copy).
__global__ void weight_prep_kernel(const float* __restrict__ w, int n_taps,
                                   int c_in, int c_out, WeightCopy a,
                                   WeightCopy b) {
  write_weight_copy(w, n_taps, c_in, c_out, a);
  write_weight_copy(w, n_taps, c_in, c_out, b);
}

// Launches weight_prep_kernel for layout l (and, when b.out is set, the
// second copy b); returns the launch error.
inline int prep_weights(const float* w, int n_taps, int c_in, int c_out,
                        const Layout& l, bool bf16, void* wprep,
                        cudaStream_t stream,
                        WeightCopy b = WeightCopy{0, 0, 0, 0, nullptr}) {
  const long total = (long)n_taps * l.ck * l.n_pad +
                     (b.out ? (long)n_taps * b.ck * b.n_pad : 0);
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256
                                                      : 1024);
  weight_prep_kernel<<<blocks, 256, 0, stream>>>(
      w, n_taps, c_in, c_out, weight_copy(l, bf16, wprep), b);
  return (int)cudaGetLastError();
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
  for (int i = t; i < kTileRows * width; i += kTileThreads) {
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

// Tile mode's sums, from the CTA's (tap, row) source table src_s
// [n_taps][64] (written and synced; area, past it, is free): per tap the
// 16-row fragments that hit it and the list of taps any row hits, then a
// ring of n_stages (64 gathered rows, W[k] tile) stages over those taps;
// warp w multiplies its 16 rows where they hit. tap_mask and tap_list are
// shared arrays of n_taps ints, n_active a shared int.
template <bool kBf16, int kNT>
__device__ __forceinline__ void tile_sums(
    float* acc, const int* src_s, unsigned char* area, const Layout& L,
    const float* __restrict__ feats, int c_in, int vec4, const void* wprep,
    int n0, int n_taps, int* tap_mask, int* tap_list, int& n_active) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = warp; k < n_taps; k += kTileThreads / 32) {
    const unsigned m0 =
        __ballot_sync(0xffffffffu, src_s[k * kTileRows + lane] >= 0);
    const unsigned m1 =
        __ballot_sync(0xffffffffu, src_s[k * kTileRows + 32 + lane] >= 0);
    if (lane == 0)
      tap_mask[k] = ((m0 & 0xffffu) ? 1 : 0) | ((m0 >> 16) ? 2 : 0) |
                    ((m1 & 0xffffu) ? 4 : 0) | ((m1 >> 16) ? 8 : 0);
  }
  __syncthreads();  // whatever lay in area is dead: the ring reuses it
  if (tid == 0) {
    int na = 0;
    for (int k = 0; k < n_taps; ++k)
      if (tap_mask[k]) tap_list[na++] = k;
    n_active = na;
  }
  // the gathered rows' pad columns [c_in, ck) are zero once for all taps
  const int pad = L.ck - c_in;
  for (int i = tid; i < L.n_stages * kTileRows * pad; i += kTileThreads) {
    const int rr = i / pad, c = c_in + i - rr * pad;  // rr: stage * 64 + row
    reinterpret_cast<float*>(area + (long)(rr / kTileRows) * L.tile_pitch)
        [(rr % kTileRows) * L.a_stride + c] = 0.0f;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4 * kNT; ++i) acc[i] = 0.0f;
  const int a_bytes = kTileRows * L.a_stride * 4;
  auto stage = [&](int s) { return area + (long)s * L.tile_pitch; };
  auto issue = [&](int s, int k) {
    gather_rows(reinterpret_cast<float*>(stage(s)), L.a_stride,
                src_s + k * kTileRows, tap_mask[k], feats, c_in, vec4, tid);
    copy_w_tile<kBf16>(stage(s) + a_bytes, wprep, k, n0, L, tid,
                       kTileThreads);
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
}

// Hands each of the calling thread's tile-mode sums to
// store(row in the CTA, output channel, value).
template <bool kBf16, int kNT, typename Store>
__device__ __forceinline__ void tile_store(const float* acc, const Layout& L,
                                           int n0, Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_tiles = L.slab / 8;
  if (kBf16) {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (nt >= n_tiles) continue;
      const int co = n0 + nt * 8 + 2 * q;
      store(warp * 16 + g, co, acc[4 * nt]);
      store(warp * 16 + g, co + 1, acc[4 * nt + 1]);
      store(warp * 16 + g + 8, co, acc[4 * nt + 2]);
      store(warp * 16 + g + 8, co + 1, acc[4 * nt + 3]);
    }
  } else {
    const int ty = lane >> 3, tx = lane & 7;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        if (j < n_tiles) store(warp * 16 + ty + 4 * r, n0 + tx + 8 * j,
                               acc[kNT * r + j]);
  }
}

// Row mode's sums for the calling thread's output row: its hit taps'
// sources src_s[k * kRowThreads + tid] (-1: none), each row's c_in floats
// times that tap's weights resident at w_s (K, c_in, kCout), in tap then
// channel order with fmaf (bf16: the row rounded, the weights prepped so).
template <bool kBf16, int kCout>
__device__ __forceinline__ void row_sums(float* acc, const int* src_s,
                                         int n_taps,
                                         const float* __restrict__ feats,
                                         int c_in, int vec4,
                                         const float* w_s) {
  const int tid = threadIdx.x;
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
}

// Lets a kernel take `smem` dynamic shared bytes beside its static ones
// (needed past 48 KB in all); *granted keeps the largest size set so far.
template <typename Kernel>
inline int allow_smem(Kernel kernel, long smem, long* granted) {
  if (smem <= 32 * 1024 || smem <= *granted) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == 0) *granted = smem;
  return err;
}

}  // namespace
