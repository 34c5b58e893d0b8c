// ROI-local voxel-query grid pooling (eval), one CTA per ROI.
//
// Replaces virconv_tpu/ops/pallas/roi_pool.py::_count_kernel (pass 1) and
// ::_kernel (pass 2). On the TPU both passes ran over a sequential grid of
// (ROI, candidate block) programs, revisiting an ROI's count and output
// blocks and carrying the within-bucket running count in VMEM scratch. Blocks
// of a CUDA grid run in no order, so here one CTA owns one ROI and loops over
// that ROI's candidate blocks twice; the carries are loop state in
// registers. One thread per query (grid point):
//   pass 1: count in-window, in-radius hits per (group, dz bucket);
//   pass 2: walk the candidates again in slot order; a hit's scan rank is
//           (hits in earlier dz buckets) + (running count in its bucket),
//           an exact integer count; the first nsample hits add
//           relu(feat + pos) into a running max.
// Candidate centers and distances use round-to-nearest intrinsics in the
// JAX order (built with --fmad=false too), so the selected sets are
// bit-equal to voxel_query_groups.
//
// Bound: compare work (Q x candidates x G per ROI) on the CUDA cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxGroups = 2;
constexpr int kMaxMid = 32;
constexpr int kMaxBuckets = 9;      // 2 * rz + 1 with rz <= 4
constexpr int kMaxCblk = 512;
constexpr float kBigNeg = -1048576.0f;

__device__ __forceinline__ float maybe_bf16(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ float center(float c, float vs, float mn) {
  return __fadd_rn(__fmul_rn(__fadd_rn(c, 0.5f), vs), mn);
}

__global__ void roi_pool_kernel(
    const float* __restrict__ cand_pack,  // (NBLK, 3, CBLK) z, y, x
    const float* __restrict__ meta,       // (NBLK*CBLK, 4) ctr xyz, valid
    const float* __restrict__ q_pack,     // (R, Q, 8)
    const int* __restrict__ cand_rows,    // (NBLK*CBLK)
    const int* __restrict__ blk_start,    // (R+1)
    const float* __restrict__ feats,      // (G, n_rows, mid)
    const float* __restrict__ wb,         // (4G, mid)
    const int* __restrict__ spec,         // (G, 4) rz, ry, rx, nsample
    const float* __restrict__ rad2,       // (G)
    int n_q, int cblk, int n_groups, int mid, int n_rows, int bf16,
    float vsx, float vsy, float vsz, float minx, float miny, float minz,
    float* __restrict__ out,              // (R, Q, G*mid)
    int* __restrict__ sel_out, int ns_max) {  // optional (R, Q, G, ns_max)
  __shared__ float s_z[kMaxCblk], s_y[kMaxCblk], s_x[kMaxCblk];
  __shared__ float s_cx[kMaxCblk], s_cy[kMaxCblk], s_cz[kMaxCblk];
  __shared__ int s_row[kMaxCblk];
  __shared__ float s_wb[4 * kMaxGroups * kMaxMid];

  const int r = blockIdx.x;
  const int q = threadIdx.x;
  const bool active = q < n_q;
  for (int i = q; i < 4 * n_groups * mid; i += blockDim.x) s_wb[i] = wb[i];

  float qz = 0.f, qy = 0.f, qx = 0.f, qfx = 0.f, qfy = 0.f, qfz = 0.f;
  bool qok = false;
  if (active) {
    const float* qp = q_pack + ((long)r * n_q + q) * 8;
    qz = qp[0]; qy = qp[1]; qx = qp[2]; qok = qp[3] > 0.f;
    qfx = qp[4]; qfy = qp[5]; qfz = qp[6];
  }
  int rz[kMaxGroups], ry[kMaxGroups], rx[kMaxGroups], ns[kMaxGroups];
  float r2[kMaxGroups];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    const bool on = g < n_groups;
    rz[g] = on ? spec[4 * g] : -1;
    ry[g] = on ? spec[4 * g + 1] : -1;
    rx[g] = on ? spec[4 * g + 2] : -1;
    ns[g] = on ? spec[4 * g + 3] : 0;
    r2[g] = on ? rad2[g] : 0.f;
  }
  const int b0 = blk_start[r], b1 = blk_start[r + 1];

  int cnt[kMaxGroups][kMaxBuckets];
  int run[kMaxGroups][kMaxBuckets];
  float acc[kMaxGroups][kMaxMid];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
#pragma unroll
    for (int b = 0; b < kMaxBuckets; ++b) { cnt[g][b] = 0; run[g][b] = 0; }
#pragma unroll
    for (int j = 0; j < kMaxMid; ++j) acc[g][j] = 0.f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {  // cnt -> exclusive prefix over dz buckets
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        int s = 0;
#pragma unroll
        for (int b = 0; b < kMaxBuckets; ++b) {
          const int c = cnt[g][b]; cnt[g][b] = s; s += c;
        }
      }
    }
    for (int blk = b0; blk < b1; ++blk) {
      __syncthreads();
      for (int i = q; i < cblk; i += blockDim.x) {
        const float* cp = cand_pack + (long)blk * 3 * cblk;
        s_z[i] = cp[i]; s_y[i] = cp[cblk + i]; s_x[i] = cp[2 * cblk + i];
        const long sl = (long)blk * cblk + i;
        s_cx[i] = meta[sl * 4]; s_cy[i] = meta[sl * 4 + 1];
        s_cz[i] = meta[sl * 4 + 2];
        s_row[i] = cand_rows[sl];
      }
      __syncthreads();
      if (!(active && qok)) continue;
      for (int i = 0; i < cblk; ++i) {
        const float cz = s_z[i];
        if (!(cz > kBigNeg + 1.f)) continue;
        const int dz = (int)(cz - qz);
        const int dy = (int)(s_y[i] - qy);
        const int dx = (int)(s_x[i] - qx);
        const float ex = __fsub_rn(center(s_x[i], vsx, minx), qfx);
        const float ey = __fsub_rn(center(s_y[i], vsy, miny), qfy);
        const float ez = __fsub_rn(center(cz, vsz, minz), qfz);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex),
                                             __fmul_rn(ey, ey)),
                                   __fmul_rn(ez, ez));
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g) {
          if (g >= n_groups) continue;
          if (abs(dz) > rz[g] || abs(dy) > ry[g] || abs(dx) > rx[g] ||
              !(d2 < r2[g]))
            continue;
          const int b = dz + rz[g];
          if (pass == 0) { cnt[g][b] += 1; continue; }
          run[g][b] += 1;
          const int rank = cnt[g][b] + run[g][b];
          if (rank > ns[g]) continue;
          if (sel_out)
            sel_out[(((long)r * n_q + q) * n_groups + g) * ns_max + rank - 1]
                = s_row[i];
          const float relx = __fsub_rn(s_cx[i], qfx);
          const float rely = __fsub_rn(s_cy[i], qfy);
          const float relz = __fsub_rn(s_cz[i], qfz);
          const float* w = s_wb + 4 * g * mid;
          const float* f = feats + ((long)g * n_rows + s_row[i]) * mid;
#pragma unroll
          for (int j = 0; j < kMaxMid; ++j) {
            if (j < mid) {
              float pos = __fmul_rn(relx, w[j]);
              pos = __fadd_rn(pos, __fmul_rn(rely, w[mid + j]));
              pos = __fadd_rn(pos, __fmul_rn(relz, w[2 * mid + j]));
              pos = __fadd_rn(pos, w[3 * mid + j]);
              const float x = __fadd_rn(maybe_bf16(f[j], bf16), pos);
              acc[g][j] = fmaxf(acc[g][j], x);   // acc >= 0: relu + max
            }
          }
        }
      }
    }
  }
  if (!active) return;
  float* o = out + ((long)r * n_q + q) * n_groups * mid;
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    if (g >= n_groups) continue;
#pragma unroll
    for (int j = 0; j < kMaxMid; ++j)
      if (j < mid) o[g * mid + j] = acc[g][j];
  }
}

}  // namespace

extern "C" int roi_pool_fwd(
    const float* cand_pack, const float* meta, const float* q_pack,
    const int* cand_rows, const int* blk_start, const float* feats,
    const float* wb, const int* spec, const float* rad2,
    int n_roi, int n_q, int cblk, int n_groups, int mid,
    int n_rows, int bf16, float vsx, float vsy, float vsz, float minx,
    float miny, float minz, float* out, int* sel_out, int ns_max,
    cudaStream_t stream) {
  if (n_groups > kMaxGroups || mid > kMaxMid || cblk > kMaxCblk ||
      n_q > 1024)
    return -1;
  if (n_roi == 0) return 0;
  const int threads = ((n_q + 31) / 32) * 32;
  roi_pool_kernel<<<n_roi, threads, 0, stream>>>(
      cand_pack, meta, q_pack, cand_rows, blk_start, feats, wb, spec, rad2,
      n_q, cblk, n_groups, mid, n_rows, bf16, vsx, vsy, vsz, minx, miny,
      minz, out, sel_out, ns_max);
  return (int)cudaGetLastError();
}
