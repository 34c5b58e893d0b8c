// ROI-local voxel-query grid pooling (eval), one warp per (ROI, query).
//
// Replaces virconv_tpu/ops/pallas/roi_pool.py::_count_kernel (pass 1) and
// ::_kernel (pass 2). On the TPU both passes ran over a sequential grid of
// (ROI, candidate block) programs, revisiting an ROI's count and output
// blocks and carrying the within-bucket running count in VMEM scratch.
// Blocks of a CUDA grid run in no order, so here a CTA of 8 warps takes 8
// queries of one ROI, and the two passes become one walk over the ROI's
// candidate slots in slot order:
//  - the CTA stages the candidates' cell coordinates (z, y, x) in shared
//    memory, up to 1024 slots at a time, once for all its warps;
//  - a warp's 32 lanes take 32 consecutive slots; per (group, dz bucket) a
//    warp ballot marks the in-window, in-radius hits, and a hit's rank in
//    its bucket is the bucket's running count plus the popcount of the
//    ballot below its lane: exact integers, no atomics. The first nsample
//    hits of each bucket are listed, in slot order, in the warp's shared
//    memory;
//  - after the walk the buckets' lists are read in dz order up to nsample:
//    the first nsample hits in (dz, dy, dx) scan order, the selection of
//    voxel_query_groups. For each selected hit the lanes take the channels
//    (lane j and j + 32), read the feature row coalesced and keep the max
//    of relu(feat + pos), which is exact in any order.
// Candidate centers and distances use round-to-nearest intrinsics in the
// JAX order (built with --fmad=false too), so the selected sets are
// bit-equal to voxel_query_groups.
//
// Bound: the bytes (candidates, queries, <= nsample feature rows per query
// and group, the output) and the compare work (Q x candidates x G per ROI)
// are both small; the first version's serial walk of one thread per query
// was bound by its latency, and the lanes now spread it 32 ways.

#include "common.cuh"

namespace {

constexpr int kMaxGroups = 2;
constexpr int kMaxMid = 64;         // channels: lanes j and j + 32
constexpr int kMaxRz = 4;
constexpr int kMaxBuckets = 2 * kMaxRz + 1;
constexpr int kMaxNs = 32;          // nsample: one lane per selected slot
constexpr int kMaxQ = 4096;
constexpr int kMaxCblk = 512;
constexpr int kWarps = 8;           // queries per CTA
constexpr int kStageSlots = 1024;   // candidate slots staged at once
constexpr float kBigNeg = -1048576.0f;

__device__ __forceinline__ float center(float c, float vs, float mn) {
  return __fadd_rn(__fmul_rn(__fadd_rn(c, 0.5f), vs), mn);
}

__global__ void __launch_bounds__(kWarps * 32) roi_pool_kernel(
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
  __shared__ float s_z[kStageSlots], s_y[kStageSlots], s_x[kStageSlots];
  __shared__ float s_wb[4 * kMaxGroups * kMaxMid];
  __shared__ int s_list[kWarps][kMaxGroups][kMaxBuckets][kMaxNs];
  __shared__ int s_sel[kWarps][kMaxGroups][kMaxNs];

  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.y * kWarps + warp;
  const bool active = q < n_q;
  const unsigned lt = (1u << lane) - 1u;
  for (int i = tid; i < 4 * n_groups * mid; i += kWarps * 32) s_wb[i] = wb[i];

  float qz = 0.f, qy = 0.f, qx = 0.f, qfx = 0.f, qfy = 0.f, qfz = 0.f;
  bool qok = false;
  if (active) {
    const float* qp = q_pack + ((long)r * n_q + q) * 8;
    qz = qp[0]; qy = qp[1]; qx = qp[2]; qok = qp[3] > 0.f;
    qfx = qp[4]; qfy = qp[5]; qfz = qp[6];
  }
  const bool go = active && qok;  // uniform over the warp
  int rz[kMaxGroups], ry[kMaxGroups], rx[kMaxGroups], ns[kMaxGroups];
  float r2[kMaxGroups];
  int cnt[kMaxGroups][kMaxBuckets];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    const bool on = g < n_groups;
    rz[g] = on ? spec[4 * g] : -1;
    ry[g] = on ? spec[4 * g + 1] : -1;
    rx[g] = on ? spec[4 * g + 2] : -1;
    ns[g] = on ? spec[4 * g + 3] : 0;
    r2[g] = on ? rad2[g] : 0.f;
#pragma unroll
    for (int b = 0; b < kMaxBuckets; ++b) cnt[g][b] = 0;
  }

  // 1) one walk over the ROI's slots: per bucket, the first nsample hits
  const long s0 = (long)blk_start[r] * cblk, s1 = (long)blk_start[r + 1] * cblk;
  for (long c0 = s0; c0 < s1; c0 += kStageSlots) {
    const int n = (int)(s1 - c0 < kStageSlots ? s1 - c0 : kStageSlots);
    __syncthreads();  // the previous stage is consumed
    for (int i = tid; i < n; i += kWarps * 32) {
      const long slot = c0 + i;
      const long b = slot / cblk;
      const int j = (int)(slot - b * cblk);
      const float* cp = cand_pack + b * 3 * cblk;
      s_z[i] = cp[j]; s_y[i] = cp[cblk + j]; s_x[i] = cp[2 * cblk + j];
    }
    __syncthreads();
    if (!go) continue;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      bool hit[kMaxGroups];
      int bkt[kMaxGroups];
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) { hit[g] = false; bkt[g] = 0; }
      if (i < n && s_z[i] > kBigNeg + 1.f) {
        const float cz = s_z[i];
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
          hit[g] = g < n_groups && abs(dz) <= rz[g] && abs(dy) <= ry[g] &&
                   abs(dx) <= rx[g] && d2 < r2[g];
          bkt[g] = dz + rz[g];
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        if (!__any_sync(0xffffffffu, hit[g])) continue;
#pragma unroll
        for (int b = 0; b < kMaxBuckets; ++b) {
          if (b > 2 * rz[g]) continue;
          const bool mine = hit[g] && bkt[g] == b;
          const unsigned m = __ballot_sync(0xffffffffu, mine);
          if (!m) continue;
          const int pos = cnt[g][b] + __popc(m & lt);
          if (mine && pos < ns[g]) s_list[warp][g][b][pos] = (int)(c0 + i);
          cnt[g][b] += __popc(m);
        }
      }
    }
  }
  if (!active) return;  // no barrier follows
  __syncwarp();         // the lists written by every lane are visible

  // 2) the selection in (dz, slot) order, then the pooled max per channel
  float* o = out + ((long)r * n_q + q) * n_groups * mid;
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    if (g >= n_groups) continue;
    int taken = 0;
    if (go) {
#pragma unroll
      for (int b = 0; b < kMaxBuckets; ++b) {
        if (b > 2 * rz[g]) continue;
        const int take = min(cnt[g][b], ns[g] - taken);
        if (take <= 0) continue;
        if (lane < take) s_sel[warp][g][taken + lane] = s_list[warp][g][b][lane];
        taken += take;
      }
    }
    __syncwarp();
    if (sel_out && lane < taken)
      sel_out[(((long)r * n_q + q) * n_groups + g) * ns_max + lane] =
          cand_rows[s_sel[warp][g][lane]];
    float acc0 = 0.f, acc1 = 0.f;  // >= 0: relu + max
    const float* w = s_wb + 4 * g * mid;
    const int j0 = lane, j1 = lane + 32;
#pragma unroll 4
    for (int s = 0; s < taken; ++s) {
      const int slot = s_sel[warp][g][s];
      const float* m = meta + (long)slot * 4;
      const float relx = __fsub_rn(m[0], qfx);
      const float rely = __fsub_rn(m[1], qfy);
      const float relz = __fsub_rn(m[2], qfz);
      const float* f = feats + ((long)g * n_rows + cand_rows[slot]) * mid;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = h ? j1 : j0;
        if (j >= mid) continue;
        float pos = __fmul_rn(relx, w[j]);
        pos = __fadd_rn(pos, __fmul_rn(rely, w[mid + j]));
        pos = __fadd_rn(pos, __fmul_rn(relz, w[2 * mid + j]));
        pos = __fadd_rn(pos, w[3 * mid + j]);
        const float x = __fadd_rn(maybe_bf16(f[j], bf16), pos);
        if (h) acc1 = fmaxf(acc1, x); else acc0 = fmaxf(acc0, x);
      }
    }
    if (j0 < mid) o[g * mid + j0] = acc0;
    if (j1 < mid) o[g * mid + j1] = acc1;
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
  // spec's ranges and nsamples are checked by the wrapper (rz <= kMaxRz,
  // nsample <= kMaxNs).
  if (n_groups < 1 || n_groups > kMaxGroups || mid > kMaxMid ||
      cblk < 1 || cblk > kMaxCblk || n_q > kMaxQ)
    return -1;
  if (n_roi == 0 || n_q == 0) return 0;
  const dim3 grid((unsigned)n_roi, (unsigned)((n_q + kWarps - 1) / kWarps));
  roi_pool_kernel<<<grid, kWarps * 32, 0, stream>>>(
      cand_pack, meta, q_pack, cand_rows, blk_start, feats, wb, spec, rad2,
      n_q, cblk, n_groups, mid, n_rows, bf16, vsx, vsy, vsz, minx, miny,
      minz, out, sel_out, ns_max);
  return (int)cudaGetLastError();
}
