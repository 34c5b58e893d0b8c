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
// (built with --fmad=false), as the plain version computes them, so the
// kernel gives the plain version's bits.
//
// Bound: bytes. An iteration reads 83 guide planes, the three previous
// depths, h0, the mask and the sparse depth, and writes three depths: at
// 352 x 1216 about 157 MB at full resolution and 48 MB at half. A thread
// per pixel (the first design) read every depth value once per tap through
// L1, with a bounds branch and 64-bit address arithmetic per tap and 91
// registers (two CTAs an SM): on an H100 (700 W) s1 and s2 took about the
// same time, 0.25 and 0.23 ms, although s2 moves a third of the bytes.
//
// cspn_tile_kernel, for the two stages PENet runs: dilation 1 at full
// resolution (s1) and dilation 2 on half-resolution guides (s2). A CTA
// per output tile of kTileW columns stages the three previous depths with
// their halo (k / 2 * dilation a side, +0 outside the image) in shared
// memory. A thread owns Run columns of S output rows (S = 2 at half
// resolution, where a guide cell is 2 x 2 outputs): at s1 a run of 4
// pixels, at s2 one 2 x 2 cell, so a half-resolution guide value is loaded
// once for its four outputs. Per row of taps the thread reads
// each of its output rows' depth segment once, as Run-float vectors
// (Run + 2 * halo values serve Run * k products), and per tap one guide
// value per cell straight from device memory (a warp's loads coalesce
// along x; each guide element has one reader, so the guides stream once
// from DRAM). Tiles whose taps all stay inside the image run the tap loop
// with no bounds test; the others zero the guide of a tap outside the
// image, whose staged depth is +0 too. Offsets inside a plane are 32-bit.
// The rows of taps stay a loop (unrolled, the hoisted loads spilled past
// 128 registers), two CTAs an SM. The tile shapes are the fastest of the
// few tried on an H100.
//
// cspn_any_kernel: any other dilation and resolution, or an image of
// 2^31 / 49 pixels or more (no model path): a thread per pixel reading
// device memory, with 64-bit offsets.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 64;     // output columns per CTA
constexpr int kMaxHalf = 3;    // the largest kernel size's half width

struct Maps {
  const float* g[3];       // (B, k^2, hg, wg) for k = 3, 5, 7
  const float* prev[3];    // (B, h, w)
  const float* h0;         // (B, h, w)
  const float* mask;       // (B, hg, wg)
  const float* dsparse;    // (B, hg, wg)
  float* out[3];           // (B, h, w)
};

// Run-float vectors: a thread's run of outputs, and its depth segments.
template <int N> struct VecOf;
template <> struct VecOf<2> {
  using T = float2;
  __device__ static void split(T q, float* d) { d[0] = q.x; d[1] = q.y; }
  __device__ static T join(const float* v) { return make_float2(v[0], v[1]); }
};
template <> struct VecOf<4> {
  using T = float4;
  __device__ static void split(T q, float* d) {
    d[0] = q.x; d[1] = q.y; d[2] = q.z; d[3] = q.w;
  }
  __device__ static T join(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// The tile of one mode: dilation Dil, guides at (y >> Sh, x >> Sh), a
// thread's Run output columns. A guide cell is kS x kS outputs; a tap
// (dy, dx) moves a cell by (dy, dx) * kE cells. Threads: kTx along x, kTy
// rows of them, each kS output rows high.
template <int Dil, int Sh, int Run>
struct Tile {
  static constexpr int kDil = Dil, kSh = Sh, kS = 1 << Sh, kE = Dil / kS;
  static constexpr int kRun = Run, kCells = Run / kS;
  static constexpr int kTx = kTileW / Run, kTy = kThreads / kTx;
  static constexpr int kH = kTy * kS;         // output rows per CTA
  __host__ __device__ static constexpr int halo(int k) {
    return k / 2 * Dil;
  }
  __host__ __device__ static constexpr int rows(int k) {
    return kH + 2 * halo(k);
  }
  __host__ __device__ static constexpr int cols(int k) {
    return kTileW + 2 * halo(k);
  }
  __host__ __device__ static constexpr int stride(int k) {
    return (cols(k) + 3) / 4 * 4;
  }
  __host__ __device__ static constexpr int size(int k) {
    return rows(k) * stride(k);
  }
  // a thread's depth segment of one output row: Run + 2 * halo values,
  // read as Run-float vectors from its first column (a multiple of Run)
  __host__ __device__ static constexpr int seg(int k) {
    return (Run + 2 * halo(k) + Run - 1) / Run * Run;
  }
  static constexpr int kFloats = size(3) + size(5) + size(7);
  static_assert(Dil % kS == 0 && Run % kS == 0 && kTy * kTx == kThreads,
                "a tap must move whole guide cells");
};

// The depth plane's window of the tile with its halo for kernel size K,
// +0 outside the image, into buf (rows of stride(K) floats).
template <class T, int K>
__device__ __forceinline__ void stage(float* buf,
                                      const float* __restrict__ src, int y0,
                                      int x0, int h, int w) {
  constexpr int R = T::halo(K), kCols = T::cols(K);
  for (int i = threadIdx.x; i < T::rows(K) * kCols; i += kThreads) {
    const int r = i / kCols, c = i - r * kCols;
    const int gy = y0 - R + r, gx = x0 - R + c;
    buf[r * T::stride(K) + c] =
        gy >= 0 && gy < h && gx >= 0 && gx < w ? __ldg(src + gy * w + gx)
                                               : 0.0f;
  }
}

// dK' at the thread's kS x kRun outputs, in tap order: g is plane 0 of the
// batch entry's guides for K, buf the staged depth, hc h0 at the outputs,
// (ty, tx) the thread's place in the tile and (yc, xc) its first guide
// cell. kEdge: some tap of the tile leaves the image. The rows of taps
// stay a loop: unrolled, the hoisted guide loads of all rows spilled.
template <class T, int K, bool kEdge>
__device__ __forceinline__ void propagate(
    float (&acc)[T::kS][T::kRun], const float* __restrict__ g, int plane,
    int hg, int wg, const float* buf, const float (&hc)[T::kS][T::kRun],
    int ty, int tx, int yc, int xc) {
  using V = VecOf<T::kRun>;
  constexpr int kHalf = K / 2, R = T::halo(K), kSeg = T::seg(K);
#pragma unroll
  for (int a = 0; a < T::kS; ++a)
#pragma unroll
    for (int j = 0; j < T::kRun; ++j) acc[a][j] = 0.0f;
#pragma unroll 1
  for (int dy = -kHalf; dy <= kHalf; ++dy) {
    float seg[T::kS][kSeg];
#pragma unroll
    for (int a = 0; a < T::kS; ++a) {
      const auto* row = reinterpret_cast<const typename V::T*>(
          buf + (ty * T::kS + a - dy * T::kDil + R) * T::stride(K) +
          tx * T::kRun);
#pragma unroll
      for (int v = 0; v < kSeg / T::kRun; ++v)
        V::split(row[v], &seg[a][v * T::kRun]);
    }
    const int gy = yc - dy * T::kE;
    const bool row_ok = gy >= 0 && gy < hg;
    const int t0 = (dy + kHalf) * K + kHalf;     // the row's centre tap
#pragma unroll
    for (int dx = -kHalf; dx <= kHalf; ++dx) {
      const int off = (t0 + dx) * plane + gy * wg + xc - dx * T::kE;
      float gv[T::kCells];
#pragma unroll
      for (int c = 0; c < T::kCells; ++c) {
        const int gx = xc + c - dx * T::kE;
        gv[c] = !kEdge || (row_ok && gx >= 0 && gx < wg)
                    ? __ldg(g + off + c) : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < T::kS; ++a)
#pragma unroll
        for (int j = 0; j < T::kRun; ++j) {
          const float src = dx == 0 && dy == 0
                                ? hc[a][j] : seg[a][j - dx * T::kDil + R];
          acc[a][j] = __fadd_rn(acc[a][j],
                                __fmul_rn(gv[j >> T::kSh], src));
        }
    }
  }
}

// The blend and the store of one kernel size's outputs.
template <class T, bool kEdge>
__device__ __forceinline__ void blend_store(
    float* __restrict__ out, const float (&acc)[T::kS][T::kRun],
    const float (&mds)[T::kCells], const float (&keep)[T::kCells], int oy,
    int ox, int h, int w, bool vec) {
  using V = VecOf<T::kRun>;
#pragma unroll
  for (int a = 0; a < T::kS; ++a) {
    float v[T::kRun];
#pragma unroll
    for (int j = 0; j < T::kRun; ++j)
      v[j] = __fadd_rn(mds[j >> T::kSh], __fmul_rn(keep[j >> T::kSh],
                                                   acc[a][j]));
    float* o = out + (oy + a) * w + ox;
    if (!kEdge && vec) {
      *reinterpret_cast<typename V::T*>(o) = V::join(v);
    } else if (oy + a < h) {
#pragma unroll
      for (int j = 0; j < T::kRun; ++j)
        if (ox + j < w) o[j] = v[j];
    }
  }
}

// The three kernel sizes of one thread, the depths already staged.
template <class T, bool kEdge>
__device__ __forceinline__ void tile_body(
    const Maps& m, const float* buf, int b, int h, int w, int ty, int tx,
    int oy, int ox, bool vec) {
  const int hg = h >> T::kSh, wg = w >> T::kSh, plane = hg * wg;
  const int yc = oy >> T::kSh, xc = ox >> T::kSh;
  const long long hw = (long long)h * w;
  float hc[T::kS][T::kRun];
#pragma unroll
  for (int a = 0; a < T::kS; ++a)
#pragma unroll
    for (int j = 0; j < T::kRun; ++j)
      hc[a][j] = !kEdge || (oy + a < h && ox + j < w)
                     ? __ldg(m.h0 + b * hw + (oy + a) * w + ox + j) : 0.0f;
  float mds[T::kCells], keep[T::kCells];
#pragma unroll
  for (int c = 0; c < T::kCells; ++c) {
    float mk = 0.0f, ds = 0.0f;
    if (!kEdge || (yc < hg && xc + c < wg)) {
      const long long q = (long long)b * plane + yc * wg + xc + c;
      mk = __ldg(m.mask + q);
      ds = __ldg(m.dsparse + q);
    }
    mds[c] = __fmul_rn(mk, ds);
    keep[c] = __fsub_rn(1.0f, mk);
  }
  float acc[T::kS][T::kRun];
  propagate<T, 3, kEdge>(acc, m.g[0] + (long long)b * 9 * plane, plane, hg,
                         wg, buf, hc, ty, tx, yc, xc);
  blend_store<T, kEdge>(m.out[0] + b * hw, acc, mds, keep, oy, ox, h, w,
                        vec);
  propagate<T, 5, kEdge>(acc, m.g[1] + (long long)b * 25 * plane, plane,
                         hg, wg, buf + T::size(3), hc, ty, tx, yc, xc);
  blend_store<T, kEdge>(m.out[1] + b * hw, acc, mds, keep, oy, ox, h, w,
                        vec);
  propagate<T, 7, kEdge>(acc, m.g[2] + (long long)b * 49 * plane, plane,
                         hg, wg, buf + T::size(3) + T::size(5), hc, ty, tx,
                         yc, xc);
  blend_store<T, kEdge>(m.out[2] + b * hw, acc, mds, keep, oy, ox, h, w,
                        vec);
}

// A CTA per output tile, blockIdx.x = (b * tiles_y + tile row) * tiles_x
// + tile column; vec: the outputs' rows are 16-byte aligned.
template <int Dil, int Sh, int Run>
__global__ void __launch_bounds__(kThreads, 2) cspn_tile_kernel(
    Maps m, int h, int w, int vec) {
  using T = Tile<Dil, Sh, Run>;
  __shared__ __align__(16) float buf[T::kFloats];
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles_y = (h + T::kH - 1) / T::kH;
  const int row_tile = blockIdx.x / tiles_x;
  const int b = row_tile / tiles_y;
  const int y0 = (row_tile - b * tiles_y) * T::kH;
  const int x0 = (blockIdx.x - row_tile * tiles_x) * kTileW;
  const long long hw = (long long)h * w;
  stage<T, 3>(buf, m.prev[0] + b * hw, y0, x0, h, w);
  stage<T, 5>(buf + T::size(3), m.prev[1] + b * hw, y0, x0, h, w);
  stage<T, 7>(buf + T::size(3) + T::size(5), m.prev[2] + b * hw, y0, x0, h,
              w);
  __syncthreads();
  const int ty = threadIdx.x / T::kTx, tx = threadIdx.x % T::kTx;
  const int oy = y0 + ty * T::kS, ox = x0 + tx * Run;
  // the tile's guide cells and their farthest taps inside the image
  constexpr int kReach = kMaxHalf * T::kE;
  const int cy0 = y0 >> Sh, cx0 = x0 >> Sh;
  const bool inside = cy0 - kReach >= 0 &&
                      cy0 + T::kTy - 1 + kReach < (h >> Sh) &&
                      cx0 - kReach >= 0 &&
                      cx0 + (kTileW >> Sh) - 1 + kReach < (w >> Sh);
  if (inside)
    tile_body<T, false>(m, buf, b, h, w, ty, tx, oy, ox, vec);
  else
    tile_body<T, true>(m, buf, b, h, w, ty, tx, oy, ox, vec);
}

template <int K>
__device__ __forceinline__ float propagate_any(
    const float* __restrict__ g, const float* __restrict__ hn,
    const float* __restrict__ h0, int b, int y, int x, int h, int w, int hg,
    int wg, int dil, int sh) {
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

__global__ void __launch_bounds__(kThreads) cspn_any_kernel(
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
  const float d3 = propagate_any<3>(m.g[0], m.prev[0], m.h0, b, y, x, h, w,
                                    hg, wg, dil, sh);
  m.out[0][i] = __fadd_rn(mds, __fmul_rn(keep, d3));
  const float d5 = propagate_any<5>(m.g[1], m.prev[1], m.h0, b, y, x, h, w,
                                    hg, wg, dil, sh);
  m.out[1][i] = __fadd_rn(mds, __fmul_rn(keep, d5));
  const float d7 = propagate_any<7>(m.g[2], m.prev[2], m.h0, b, y, x, h, w,
                                    hg, wg, dil, sh);
  m.out[2][i] = __fadd_rn(mds, __fmul_rn(keep, d7));
}

template <int Dil, int Sh, int Run>
void launch_tile(const Maps& m, int batch, int h, int w, int vec,
                 cudaStream_t stream) {
  using T = Tile<Dil, Sh, Run>;
  const long long tiles = (long long)((w + kTileW - 1) / kTileW) *
                          ((h + T::kH - 1) / T::kH) * batch;
  cspn_tile_kernel<Dil, Sh, Run><<<(unsigned)tiles, kThreads, 0, stream>>>(
      m, h, w, vec);
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
  if (batch == 0) return 0;
  Maps m{{g3, g5, g7}, {d3, d5, d7}, h0, mask, dsparse, {o3, o5, o7}};
  const int vec = w % 4 == 0 && (uintptr_t)o3 % 16 == 0 &&
                  (uintptr_t)o5 % 16 == 0 && (uintptr_t)o7 % 16 == 0;
  // the tile kernel's offsets inside a guide tensor are 32-bit
  const bool tiled = (long long)h * w * 49 < (1LL << 31);
  if (tiled && dilation == 1 && !half_res) {
    launch_tile<1, 0, 4>(m, batch, h, w, vec, stream);     // s1
  } else if (tiled && dilation == 2 && half_res) {
    launch_tile<2, 1, 2>(m, batch, h, w, vec, stream);     // s2
  } else {
    const long long total = (long long)batch * h * w;
    cspn_any_kernel<<<(unsigned)((total + kThreads - 1) / kThreads),
                      kThreads, 0, stream>>>(m, batch, h, w, h >> sh,
                                             w >> sh, dilation, sh);
  }
  return (int)cudaGetLastError();
}
