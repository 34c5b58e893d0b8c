"""ROI-local voxel-query grid pooling: plan, plain PyTorch version and the
CUDA kernel wrapper.

Replaces ``virconv_tpu/ops/pallas/roi_pool.py::_count_kernel`` (pass 1)
and ``::_kernel`` (pass 2, driver ``roi_pool_apply``). The plan lays each
ROI's candidate voxels (the rows of its grid-point AABB dilated by the
union query window, found by binary search on the sorted keys) out as a
run of CBLK-slot blocks. For every grid point (query) and group the pooled
feature is

    max(0, max over selected candidates c of relu(feat_g[c] + pos_g(c)))

where the selected candidates are the first ``nsample`` in-window,
in-radius hits in (dz, dy, dx) window-scan order -- the reference CUDA
voxel query's truncation rule, bit-equal to
``voxel_pool.voxel_query_groups`` -- and ``pos_g(c) = (center_c - q) @ W_g
+ b_g`` is the position MLP with eval BN folded in. Within one dz bucket,
slot order is (dy, dx) scan order, so the scan rank of a hit is (hits of
the query in earlier dz buckets over the whole ROI) + (its running count in
its own bucket). ``bf16`` rounds the gathered features to bf16, as the TPU
kernel's bf16 feature operands do.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .sparse import key_strides

BIGNEG = -1048576.0          # invalid-candidate sentinel (cell coords f32)

# kernel launches (CUDA tensors only), reset and read by chip_smoke.py
launches = 0


class RoiPoolPlan(NamedTuple):
    cand_pack: torch.Tensor     # (NBLK, 3, CBLK) f32 cell (z, y, x)
    meta: torch.Tensor          # (NBLK*CBLK, 4) f32 [ctr_xyz, valid]
    cand_rows: torch.Tensor     # (NBLK*CBLK,) i32 source row
    cand_valid: torch.Tensor    # (NBLK*CBLK,) bool
    q_pack: torch.Tensor        # (R, Q, 8) f32 [cell_zyx, valid, xyz, 0]
    blk_start: torch.Tensor     # (R+1,) i32 first block of each ROI
    ok: torch.Tensor            # () bool: caps held, else probe path
    n_roi: int
    q_per_roi: int
    cblk: int


def roi_pool_plan(st, query_xyz, query_coords, query_mask, q_per_roi: int,
                  union_ranges, voxel_size, stride, point_cloud_range,
                  nslab: int = 64, cblk: int = 256,
                  nblk_cap: int | None = None) -> RoiPoolPlan:
    """Flat candidate bands of one SA call; bit-equal to
    ``virconv_tpu.ops.pallas.roi_pool.roi_pool_plan``."""
    m_all = query_xyz.shape[0]
    q = q_per_roi
    r = m_all // q
    if r * q != m_all:
        raise ValueError(f'{m_all} queries are not {q} per ROI')
    if nblk_cap is None:
        nblk_cap = 2 * r + 32
    dev = query_xyz.device
    d, h, w = st.spatial_shape
    strides, m_entry = key_strides(st.spatial_shape)
    keys = st.keys()
    i32 = torch.int32

    vs = torch.as_tensor(voxel_size, dtype=torch.float32, device=dev) * stride
    mins = torch.as_tensor(point_cloud_range[:3], dtype=torch.float32,
                           device=dev)
    rz, ry, rx = union_ranges
    qx = query_xyz.reshape(r, q, 3)
    qc = query_coords.reshape(r, q, 4)
    qm = query_mask.reshape(r, q)

    big = 1e9
    cyf = qc[..., 2].float()
    cxf = qc[..., 3].float()
    cy_min = torch.where(qm, cyf, torch.full_like(cyf, big)).amin(1).to(i32)
    cy_max = torch.where(qm, cyf, torch.full_like(cyf, -big)).amax(1).to(i32)
    cx_min = torch.where(qm, cxf, torch.full_like(cxf, big)).amin(1).to(i32)
    cx_max = torch.where(qm, cxf, torch.full_like(cxf, -big)).amax(1).to(i32)
    roi_valid = qm.any(1)
    y0 = torch.clamp(cy_min - ry, 0, h - 1)
    y1 = torch.clamp(cy_max + ry, 0, h - 1)
    x0 = torch.clamp(cx_min - rx, 0, w - 1)
    x1 = torch.clamp(cx_max + rx, 0, w - 1)
    yext = torch.where(roi_valid, y1 - y0 + 1, torch.zeros_like(y1))
    ok_slab = (yext <= nslab).all()

    entry = qc[:, 0, 0]
    ys = y0[:, None] + torch.arange(nslab, dtype=i32, device=dev)[None]
    slab_ok = roi_valid[:, None] & (ys <= y1[:, None])
    base_key = entry[:, None] * m_entry + ys * strides[1]
    k_lo = base_key + x0[:, None] * strides[2]
    k_hi = base_key + (x1[:, None] + 1) * strides[2]
    k_lo = torch.where(slab_ok, k_lo, torch.zeros_like(k_lo))
    k_hi = torch.where(slab_ok, k_hi, torch.zeros_like(k_hi))
    lo = torch.searchsorted(keys, k_lo.reshape(-1)).to(i32).reshape(r, nslab)
    hi = torch.searchsorted(keys, k_hi.reshape(-1)).to(i32).reshape(r, nslab)
    lens = torch.where(slab_ok, hi - lo, torch.zeros_like(hi))
    counts = lens.sum(1, dtype=i32)

    nblk_r = torch.clamp(-torch.div(-counts, cblk, rounding_mode='floor'),
                         min=1).to(i32)
    base_blk = torch.zeros((r,), dtype=i32, device=dev)
    base_blk[1:] = torch.cumsum(nblk_r, 0, dtype=i32)[:-1]
    total_blk = base_blk[-1] + nblk_r[-1]
    ok = ok_slab & (total_blk <= nblk_cap)

    pid = torch.arange(nblk_cap, dtype=i32, device=dev)
    roi_of = (pid[:, None] >= base_blk[None, :]).sum(1, dtype=i32) - 1
    roi_of = torch.clamp(roi_of, 0, r - 1)

    flat = nblk_cap * cblk
    sid = torch.arange(flat, dtype=i32, device=dev)
    s_roi = roi_of[sid // cblk]
    j = sid - base_blk[s_roi] * cblk
    run_off = torch.cumsum(lens, 1, dtype=i32) - lens
    run_off_r = run_off[s_roi]
    run = (j[:, None] >= run_off_r).sum(1, dtype=i32) - 1
    run = torch.clamp(run, 0, nslab - 1).long()
    ar = torch.arange(flat, device=dev)
    row = lo[s_roi, run] + j - run_off_r[ar, run]
    valid = (j < counts[s_roi]) & (j >= 0)
    row = torch.where(valid, row, torch.zeros_like(row))

    ckey = keys[row.long()]
    in_entry = ckey - torch.div(ckey, m_entry, rounding_mode='floor') \
        * m_entry
    cy = torch.div(in_entry, strides[1], rounding_mode='floor')
    cx = torch.div(in_entry - cy * strides[1], strides[2],
                   rounding_mode='floor')
    cz = in_entry - cy * strides[1] - cx * strides[2]
    neg = torch.full((flat,), BIGNEG, dtype=torch.float32, device=dev)
    czf = torch.where(valid, cz.float(), neg)
    cyf = torch.where(valid, cy.float(), neg)
    cxf = torch.where(valid, cx.float(), neg)
    cand_pack = torch.stack([czf, cyf, cxf], 1).reshape(
        nblk_cap, cblk, 3).transpose(1, 2).contiguous()
    ctr = (torch.stack([cxf, cyf, czf], -1) + 0.5) * vs[None] + mins[None]
    meta = torch.cat([torch.where(valid[:, None], ctr, torch.zeros_like(ctr)),
                      valid[:, None].float()], -1)

    q_pack = torch.cat([qc[..., 1:].float(), qm[..., None].float(), qx,
                        torch.zeros((r, q, 1), dtype=torch.float32,
                                    device=dev)], -1)
    blk_start = torch.cat([base_blk, total_blk.reshape(1)]).to(i32)
    return RoiPoolPlan(cand_pack=cand_pack, meta=meta,
                       cand_rows=row, cand_valid=valid,
                       q_pack=q_pack.contiguous(), blk_start=blk_start,
                       ok=ok, n_roi=r, q_per_roi=q, cblk=cblk)


def _kernel_specs(specs):
    """((rz, ry, rx), f32 radius^2 as the JAX package compares, nsample)."""
    return tuple((tuple(int(v) for v in rg),
                  float(torch.tensor(float(rad) * float(rad),
                                     dtype=torch.float32)),
                  int(ns)) for rg, rad, ns in specs)


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _selection(plan, specs, voxel_size, stride, point_cloud_range):
    """Per ROI padded candidate slots and, per group, the (R, Q, NS)
    selected slot indices and hit flags, in the kernel's arithmetic."""
    dev = plan.q_pack.device
    cblk = plan.cblk
    r, q = plan.n_roi, plan.q_per_roi
    bs = plan.blk_start.long()
    nb = (bs[1:] - bs[:-1])
    maxb = int(nb.max()) if r else 1
    jj = torch.arange(maxb * cblk, device=dev)
    slot = bs[:-1, None] * cblk + jj[None]                  # (R, C)
    in_roi = jj[None] < nb[:, None] * cblk
    slot = torch.where(in_roi, slot, torch.zeros_like(slot))
    cp = plan.cand_pack.transpose(1, 2).reshape(-1, 3)      # (FLAT, zyx)
    czr, cyr, cxr = (cp[slot, i] for i in range(3))         # (R, C)
    czr = torch.where(in_roi, czr, torch.full_like(czr, BIGNEG))

    vs = [float(v) * stride for v in voxel_size]           # x, y, z
    vs = [float(_f32(v)) for v in vs]
    mins = [float(_f32(float(v))) for v in point_cloud_range[:3]]
    qp = plan.q_pack
    qzc, qyc, qxc, qok = (qp[..., i:i + 1] for i in range(4))
    qfx, qfy, qfz = (qp[..., i:i + 1] for i in range(4, 7))
    ddz = czr[:, None] - qzc                                # (R, Q, C)
    ddy = cyr[:, None] - qyc
    ddx = cxr[:, None] - qxc
    ctx = (cxr + 0.5) * vs[0] + mins[0]
    cty = (cyr + 0.5) * vs[1] + mins[1]
    ctz = (czr + 0.5) * vs[2] + mins[2]
    dist2 = ((ctx[:, None] - qfx) ** 2 + (cty[:, None] - qfy) ** 2) \
        + (ctz[:, None] - qfz) ** 2
    base_ok = (czr[:, None] > BIGNEG + 1) & (qok > 0)
    sels = []
    for (rz, ry, rx), rad2, ns in _kernel_specs(specs):
        okg = (base_ok & (ddz.abs() <= rz) & (ddy.abs() <= ry)
               & (ddx.abs() <= rx) & (dist2 < rad2))
        rank = torch.zeros(okg.shape, dtype=torch.int32, device=dev)
        pref = torch.zeros(okg.shape[:2] + (1,), dtype=torch.int32,
                           device=dev)
        for dzv in range(-rz, rz + 1):
            m_d = okg & (ddz == dzv)
            cs = torch.cumsum(m_d.to(torch.int32), -1, dtype=torch.int32)
            rank = rank + torch.where(m_d, cs + pref, torch.zeros_like(cs))
            pref = pref + cs[..., -1:]
        keep = okg & (rank <= ns)
        # slot s of query (r, q) is the candidate of rank s + 1
        dst = torch.where(keep, rank - 1, torch.full_like(rank, ns)).long()
        idx = torch.zeros((r, q, ns + 1), dtype=torch.long, device=dev)
        idx.scatter_(2, dst, slot[:, None].expand_as(dst))
        hit = torch.zeros((r, q, ns + 1), dtype=torch.bool, device=dev)
        hit.scatter_(2, dst, keep)
        sels.append((idx[..., :ns], hit[..., :ns]))
    return sels


def roi_pool_selection(plan, specs, voxel_size, stride, point_cloud_range):
    """Selected source rows per group, (R*Q, NS) int32 with -1 for empty
    slots (for holding the kernel's selection against the probe path)."""
    out = []
    for idx, hit in _selection(plan, specs, voxel_size, stride,
                               point_cloud_range):
        rows = plan.cand_rows.long()[idx]
        out.append(torch.where(hit, rows, torch.full_like(rows, -1))
                   .reshape(plan.n_roi * plan.q_per_roi, -1).to(torch.int32))
    return out


def roi_pool_plain(plan, feats_groups, w_eff, b_eff, specs, voxel_size,
                   stride, point_cloud_range, bf16=True):
    """Plain PyTorch version of the kernel contract. Returns (G, M, mid)."""
    sels = _selection(plan, specs, voxel_size, stride, point_cloud_range)
    qxyz = plan.q_pack[..., 4:7]                            # (R, Q, 3)
    qok = plan.q_pack[..., 3] > 0
    outs = []
    for g, (idx, hit) in enumerate(sels):
        f = feats_groups[g].float()
        if bf16:
            f = f.to(torch.bfloat16).float()
        rows = plan.cand_rows.long()[idx]                   # (R, Q, NS)
        gath = f[rows]                                      # (R, Q, NS, mid)
        rel = plan.meta[idx, 0:3] - qxyz[:, :, None]
        pos = rel @ w_eff[g].float() + b_eff[g].float()
        x = torch.relu(gath + pos)
        sel = hit & qok[..., None]
        x = torch.where(sel[..., None], x, torch.zeros_like(x))
        outs.append(x.amax(2).reshape(plan.n_roi * plan.q_per_roi, -1))
    return torch.stack(outs)


def roi_pool_kernel_selection(plan, feats_groups, w_eff, b_eff, specs,
                              voxel_size, stride, point_cloud_range,
                              bf16: bool = True):
    """The CUDA kernel's selected source rows, in the layout of
    :func:`roi_pool_selection` (for holding the kernel against it)."""
    ns_max = max(int(ns) for _, _, ns in specs)
    sel = torch.full((plan.n_roi, plan.q_per_roi, len(specs), ns_max), -1,
                     dtype=torch.int32, device=plan.q_pack.device)
    _roi_pool_cuda(plan, feats_groups, w_eff, b_eff, specs, voxel_size,
                   stride, point_cloud_range, bf16, sel_out=sel)
    m = plan.n_roi * plan.q_per_roi
    return [sel[:, :, g, :int(ns)].reshape(m, -1)
            for g, (_, _, ns) in enumerate(specs)]


def roi_pool_apply(plan, feats_groups, w_eff, b_eff, specs, voxel_size,
                   stride, point_cloud_range, bf16: bool = True):
    """Pooled (G, M, mid) features of one SA call (caller gates on
    plan.ok): the CUDA kernel for CUDA tensors, else the plain version."""
    if not plan.q_pack.is_cuda:
        return roi_pool_plain(plan, feats_groups, w_eff, b_eff, specs,
                              voxel_size, stride, point_cloud_range, bf16)
    return _roi_pool_cuda(plan, feats_groups, w_eff, b_eff, specs,
                          voxel_size, stride, point_cloud_range, bf16)


# CUDA kernel limits (csrc/roi_pool.cu): one warp per query, lanes over
# candidate slots, then over channels (j and j + 32) and selected slots.
MAX_GROUPS, MAX_MID, MAX_Q, MAX_RZ, MAX_NS, MAX_CBLK = 2, 64, 4096, 4, 32, 512


def _roi_pool_cuda(plan, feats_groups, w_eff, b_eff, specs, voxel_size,
                   stride, point_cloud_range, bf16, sel_out=None):
    """Launch ``roi_pool_fwd`` (csrc/roi_pool.cu): both passes of the TPU
    kernels in one walk, one warp per (ROI, query) with 8 queries of one
    ROI per CTA; the lanes take 32 candidate slots at a time (ranks from
    warp ballots), then the channels of each selected hit.

    Replaces virconv_tpu/ops/pallas/roi_pool.py::_count_kernel and
    ::_kernel. Bound: the bytes (candidates, queries, <= nsample feature
    rows per query and group) and the compare work, Q * candidates * G per
    ROI, are both small. Ranks are exact integer counts, and the center and
    distance arithmetic uses round-to-nearest intrinsics in the JAX order,
    so selections are bit-equal to the probe path."""
    global launches
    from . import _cuda
    dev = plan.q_pack.device
    g_n = len(feats_groups)
    mid = feats_groups[0].shape[1]
    kspecs = _kernel_specs(specs)
    if (g_n > MAX_GROUPS or mid > MAX_MID or plan.q_per_roi > MAX_Q
            or plan.cblk > MAX_CBLK
            or any(rg[0] > MAX_RZ or ns > MAX_NS for rg, _, ns in kspecs)):
        raise ValueError(f'roi_pool kernel limits: G={g_n} mid={mid} '
                         f'Q={plan.q_per_roi} cblk={plan.cblk} '
                         f'specs={kspecs}')
    feats = torch.stack([f.float() for f in feats_groups]).contiguous()
    wb = torch.cat([torch.cat([w_eff[g].float(),
                               b_eff[g].float().reshape(1, mid)], 0)
                    for g in range(g_n)], 0).contiguous()
    spec_i = torch.tensor([v for rg, _, ns in kspecs for v in (*rg, ns)],
                          dtype=torch.int32, device=dev)
    rad2 = torch.tensor([r2 for _, r2, _ in kspecs], dtype=torch.float32,
                        device=dev)
    rows = plan.cand_rows.contiguous()
    for name, t, dt in (('cand_pack', plan.cand_pack, torch.float32),
                        ('meta', plan.meta, torch.float32),
                        ('q_pack', plan.q_pack, torch.float32),
                        ('cand_rows', rows, torch.int32),
                        ('blk_start', plan.blk_start, torch.int32),
                        ('feats', feats, torch.float32),
                        ('wb', wb, torch.float32)):
        _cuda.check_cuda_tensor(t, name, dt, device=dev)
    vs = [float(_f32(float(v) * stride)) for v in voxel_size]
    mins = [float(_f32(float(v))) for v in point_cloud_range[:3]]
    out = torch.empty((plan.n_roi, plan.q_per_roi, g_n * mid),
                      dtype=torch.float32, device=dev)
    err = _cuda.load('roi_pool').roi_pool_fwd(
        _cuda.ptr(plan.cand_pack), _cuda.ptr(plan.meta),
        _cuda.ptr(plan.q_pack), _cuda.ptr(rows), _cuda.ptr(plan.blk_start),
        _cuda.ptr(feats), _cuda.ptr(wb), _cuda.ptr(spec_i), _cuda.ptr(rad2),
        plan.n_roi, plan.q_per_roi, plan.cblk, g_n, mid, feats.shape[1],
        int(bf16), *vs, *mins, _cuda.ptr(out),
        ctypes.c_void_p(0) if sel_out is None else _cuda.ptr(sel_out),
        0 if sel_out is None else sel_out.shape[-1], _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'roi_pool_fwd launch failed: CUDA error {err}')
    launches += 1
    return out.reshape(plan.n_roi * plan.q_per_roi, g_n, mid).transpose(0, 1)
