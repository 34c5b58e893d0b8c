// One DA-CSPN++ propagation iteration of PENet for all three kernel sizes.
//
// Not a Pallas kernel: the JAX package writes the step as a shifted sum
// (virconv_tpu/models/depth_completion/penet.py::cspn_step) and XLA fuses
// the loop. In eager PyTorch the same sum is about 4 000 small launches a
// frame (83 taps x slice, multiply, shift, add, per iteration and stage).
// Here one launch does one iteration of one stage: for each pixel p and
// k in {3, 5, 7},
//   dk'(p) = sum_t g_t(p - o_t) * src_t(p - o_t)   (t = 0..k^2-1 in order;
//            src = h0 on the centre tap, the previous dk elsewhere; a tap
//            outside the image adds 0, the shift's zero fill)
//   dk(p)  = mask(p) * dsparse(p) + (1 - mask(p)) * dk'(p)
// with o_t = (dy, dx) * dilation. At the half-resolution stage (dilation
// 2) the guides, mask and sparse depth are the half-resolution maps read at
// (y >> 1, x >> 1), which is exactly the nearest upsample the plain version
// materialises. The products and sums are round-to-nearest in tap order
// (built with --fmad=false), as the plain version computes them.
//
// Bound: bytes. An iteration reads 83 guide planes, the three previous
// depths, h0, the mask and the sparse depth, and writes three depths: at
// 352 x 1216 about 157 MB at full resolution and 48 MB at half. A thread
// per pixel, threads along x, so every plane is read coalesced; the
// neighbours' reads of one tap hit L1/L2. Tiling the halo into shared
// memory is left for later.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Maps {
  const float* g[3];       // (B, k^2, hg, wg) for k = 3, 5, 7
  const float* prev[3];    // (B, h, w)
  const float* h0;         // (B, h, w)
  const float* mask;       // (B, hg, wg)
  const float* dsparse;    // (B, hg, wg)
  float* out[3];           // (B, h, w)
};

template <int K>
__device__ __forceinline__ float propagate(const float* __restrict__ g,
                                           const float* __restrict__ hn,
                                           const float* __restrict__ h0,
                                           int b, int y, int x, int h, int w,
                                           int hg, int wg, int dil, int sh) {
  constexpr int kHalf = K / 2;
  const long long plane = (long long)hg * wg;
  const float* gb = g + (long long)b * K * K * plane;
  const float* hb = hn + (long long)b * h * w;
  const float* cb = h0 + (long long)b * h * w;
  float acc = 0.0f;
  int t = 0;
#pragma unroll
  for (int dy = -kHalf; dy <= kHalf; ++dy) {
    const int yy = y - dy * dil;
    const bool row_ok = yy >= 0 && yy < h;
#pragma unroll
    for (int dx = -kHalf; dx <= kHalf; ++dx, ++t) {
      const int xx = x - dx * dil;
      float term = 0.0f;
      if (row_ok && xx >= 0 && xx < w) {
        const float gv = gb[t * plane + (long long)(yy >> sh) * wg +
                            (xx >> sh)];
        const float* src = (dy == 0 && dx == 0) ? cb : hb;
        term = __fmul_rn(gv, src[(long long)yy * w + xx]);
      }
      acc = __fadd_rn(acc, term);
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads) cspn_kernel(
    Maps m, int batch, int h, int w, int hg, int wg, int dil, int sh) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long hw = (long long)h * w;
  if (i >= batch * hw) return;
  const int b = (int)(i / hw);
  const int y = (int)((i - b * hw) / w);
  const int x = (int)(i - b * hw - (long long)y * w);
  const long long q = ((long long)b * hg + (y >> sh)) * wg + (x >> sh);
  const float mk = m.mask[q];
  const float mds = __fmul_rn(mk, m.dsparse[q]);
  const float keep = __fsub_rn(1.0f, mk);
  const float d3 = propagate<3>(m.g[0], m.prev[0], m.h0, b, y, x, h, w, hg,
                                wg, dil, sh);
  m.out[0][i] = __fadd_rn(mds, __fmul_rn(keep, d3));
  const float d5 = propagate<5>(m.g[1], m.prev[1], m.h0, b, y, x, h, w, hg,
                                wg, dil, sh);
  m.out[1][i] = __fadd_rn(mds, __fmul_rn(keep, d5));
  const float d7 = propagate<7>(m.g[2], m.prev[2], m.h0, b, y, x, h, w, hg,
                                wg, dil, sh);
  m.out[2][i] = __fadd_rn(mds, __fmul_rn(keep, d7));
}

}  // namespace

extern "C" int cspn_iteration(const float* g3, const float* g5,
                              const float* g7, const float* d3,
                              const float* d5, const float* d7,
                              const float* h0, const float* mask,
                              const float* dsparse, int batch, int h, int w,
                              int dilation, int half_res, float* o3,
                              float* o5, float* o7, cudaStream_t stream) {
  // Full resolution (h, w); with half_res the guides, mask and dsparse are
  // (h / 2, w / 2) and h, w are even. Outputs must not alias the inputs.
  if (batch < 0 || h < 1 || w < 1 || dilation < 1 ||
      (half_res && (h % 2 || w % 2)))
    return -1;
  const int sh = half_res ? 1 : 0;
  const long long total = (long long)batch * h * w;
  if (total == 0) return 0;
  Maps m{{g3, g5, g7}, {d3, d5, d7}, h0, mask, dsparse, {o3, o5, o7}};
  cspn_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                stream>>>(m, batch, h, w, h >> sh, w >> sh, dilation, sh);
  return (int)cudaGetLastError();
}
