// Band-window sparse convolution: the forward (K1, one CTA per output tile)
// and the weight gradient (K4, one CTA per tap, channel slab and tile
// chunk), sharing one lower-bound search.
//
// K1 replaces virconv_tpu/ops/pallas/band_conv.py::_kernel. The TPU kernel
// gathers each tap's rows with a one-hot matmul built from key equality over
// a 2-block window and runs one (T, K*C) @ (K*C, C') matmul. Here each thread
// owns one output row: per tap it finds the lower-bound row of
// base_key + delta inside the tile's window of that tap's group (binary
// search over the sorted int32 keys), then accumulates feats[row] . W[k]
// with W[k] staged in shared memory 16 output channels at a time. Output
// rows are exact iff the plan says the tile fits; lower bound returns the
// first row of a duplicate-key run (NRConv 2D first-wins). The training
// path also runs K1 as the input gradient, with tap-reversed transposed
// weights on the same plan.
//
// K4 replaces virconv_tpu/ops/pallas/band_conv.py::_dw_kernel:
// dW[k] = gather_k(feats)^T @ (g * row_ok), summed over every tile. The TPU
// kernel keeps the whole (K*C, C') f32 sum resident and revisits it across a
// sequential grid; CTAs here run in no order and the full dW (442 KB at
// C = C' = 64) does not fit one SM, so each CTA owns dW[k][ci0:+64][co0:+16]
// for one chunk of tiles, compacts the rows of each tile that hit a source
// (warp ballots, in row order), stages their feats and g rows in shared
// memory and accumulates the outer products in registers. A second kernel
// sums the per-chunk partials in chunk order. No float atomics: the result
// has the same bits on every run.
//
// Bound: compute-bound in principle (2*K*C*C' flops per row); both kernels
// use CUDA-core FMAs, not tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 27;
constexpr int kMaxTile = 256;
constexpr int kMaxCin = 128;
constexpr int kChunk = 16;       // output channels per accumulation pass
constexpr int kRowValidBit = 30;

__device__ __forceinline__ float maybe_bf16(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Lower-bound row of key q in the window [ws, min(ws + 2 * block, n_in)) of
// the sorted keys, or -1 when q is not there.
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

__global__ void band_conv_kernel(
    const float* __restrict__ feats, const int* __restrict__ keys,
    const int* __restrict__ base_keys, const int* __restrict__ valid_bits,
    const int* __restrict__ blk, const float* __restrict__ weights,
    int n_in, int c_in, int c_out, int n_taps, int n_groups,
    const int* __restrict__ geo,  // deltas[K] then group_of[K]
    const float* __restrict__ scale, const float* __restrict__ bias,
    int affine, int relu, int bf16, int tile, int block, int n_out,
    float* __restrict__ out) {
  __shared__ int src_s[kMaxTaps * kMaxTile];
  __shared__ float w_s[kMaxCin * kChunk];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int row = t * tile + tid;
  const int qk = base_keys[row];
  const int bits = valid_bits[row];

  // 1) per-tap source rows by lower-bound search in the group's window
  for (int k = 0; k < n_taps; ++k) {
    int src = -1;
    if ((bits >> k) & 1)
      src = band_source(keys, n_in, qk + geo[k],
                        (long)blk[t * n_groups + geo[n_taps + k]] * block,
                        block);
    src_s[k * tile + tid] = src;
  }
  const float row_ok = ((bits >> kRowValidBit) & 1) ? 1.0f : 0.0f;

  // 2) accumulate 16 output channels per pass over all taps
  for (int co0 = 0; co0 < c_out; co0 += kChunk) {
    float acc[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) acc[j] = 0.0f;
    for (int k = 0; k < n_taps; ++k) {
      __syncthreads();
      for (int i = tid; i < c_in * kChunk; i += blockDim.x) {
        const int c = i / kChunk, j = i % kChunk;
        const int co = co0 + j;
        const float w = co < c_out
            ? weights[((long)k * c_in + c) * c_out + co] : 0.0f;
        w_s[i] = maybe_bf16(w, bf16);
      }
      __syncthreads();
      const int src = src_s[k * tile + tid];
      if (src >= 0) {
        const float* f = feats + (long)src * c_in;
        for (int c = 0; c < c_in; ++c) {
          const float x = maybe_bf16(f[c], bf16);
#pragma unroll
          for (int j = 0; j < kChunk; ++j)
            acc[j] = fmaf(x, w_s[c * kChunk + j], acc[j]);
        }
      }
    }
    if (row < n_out) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int co = co0 + j;
        if (co < c_out) {
          float v = acc[j];
          if (affine) v = __fadd_rn(__fmul_rn(v, scale[co]), bias[co]);
          if (relu) v = fmaxf(v, 0.0f);
          out[(long)row * c_out + co] = v * row_ok;
        }
      }
    }
  }
}

constexpr int kDwCi = 64;        // input channels per CTA
constexpr int kDwCo = 16;        // output channels per CTA
constexpr int kDwStage = 64;     // hit rows staged in shared memory at once
constexpr int kDwThreads = 256;  // >= kMaxTile: one thread per tile row

__global__ void __launch_bounds__(kDwThreads) band_conv_dw_kernel(
    const float* __restrict__ feats, const int* __restrict__ keys,
    const int* __restrict__ base_keys, const int* __restrict__ valid_bits,
    const int* __restrict__ blk, const float* __restrict__ g,
    int n_in, int c_in, int c_out, int n_taps, int n_groups,
    const int* __restrict__ geo, int bf16, int tile, int block,
    int n_tiles, int n_out, int tiles_per_chunk,
    float* __restrict__ partial) {
  __shared__ int row_s[kMaxTile];
  __shared__ int src_s[kMaxTile];
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

extern "C" int band_conv_fwd(
    const float* feats, const int* keys, const int* base_keys,
    const int* valid_bits, const int* blk, const float* weights,
    int n_in, int c_in, int c_out, int n_taps, int n_groups,
    const int* geo, const float* scale, const float* bias,
    int affine, int relu, int bf16, int tile, int block, int n_tiles,
    int n_out, float* out, cudaStream_t stream) {
  // base_keys / valid_bits / blk cover n_tiles * tile rows; out has the
  // n_out unpadded rows.
  if (n_taps > kMaxTaps || tile > kMaxTile || c_in > kMaxCin) return -1;
  if (n_tiles == 0) return 0;
  band_conv_kernel<<<n_tiles, tile, 0, stream>>>(
      feats, keys, base_keys, valid_bits, blk, weights, n_in, c_in, c_out,
      n_taps, n_groups, geo, scale, bias, affine, relu, bf16, tile, block,
      n_out, out);
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
  if (n_taps > kMaxTaps || tile > kMaxTile || tiles_per_chunk < 1)
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
