// Band-window sparse convolution forward (eval), one CTA per output tile.
//
// Replaces virconv_tpu/ops/pallas/band_conv.py::_kernel. The TPU kernel
// gathers each tap's rows with a one-hot matmul built from key equality over
// a 2-block window and runs one (T, K*C) @ (K*C, C') matmul. Here each thread
// owns one output row: per tap it finds the lower-bound row of
// base_key + delta inside the tile's window of that tap's group (binary
// search over the sorted int32 keys), then accumulates feats[row] . W[k]
// with W[k] staged in shared memory 16 output channels at a time. Output
// rows are exact iff the plan says the tile fits; lower bound returns the
// first row of a duplicate-key run (NRConv 2D first-wins).
//
// Bound: compute-bound in principle (2*K*C*C' flops per row); this version
// uses CUDA-core FMAs, not tensor cores.

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
    if ((bits >> k) & 1) {
      const int q = qk + geo[k];
      const long ws = (long)blk[t * n_groups + geo[n_taps + k]] * block;
      long lo = ws;
      long hi = ws + 2L * block;
      if (hi > n_in) hi = n_in;
      const long end = hi;
      while (lo < hi) {
        const long mid = (lo + hi) >> 1;
        if (keys[mid] < q) lo = mid + 1; else hi = mid;
      }
      if (lo < end && keys[lo] == q) src = (int)lo;
    }
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
