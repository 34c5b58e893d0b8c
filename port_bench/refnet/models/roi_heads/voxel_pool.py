"""Voxel-query ROI grid pooling. Counterpart of
``virconv_tpu/models/roi_heads/voxel_pool.py``.

The reference pools on the per-query probe path only
(``voxel_query_groups``: a packed-occupancy window probe, first ``nsample``
in-radius hits in (dz, dy, dx) scan order), the measured program's
pooling kernel's selection. Training takes the probe path too, with batch-statistics BN (the
position BN from algebraic moments of the 3-wide relative positions) and
the pool gathers on ``gather_rows``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ...ops import sparse as sp
from ...ops.gather_rows import gather_rows
from ... import tally
from ...precision import operand
from ..layers import MaskedBatchNorm, promote

CHUNK_BUDGET_EVAL = 64_000_000


@functools.lru_cache(maxsize=None)
def _flat_cells(st):
    d, h, w = st.spatial_shape
    return ((st.coords[:, 0].long() * d + st.coords[:, 1]) * h
            + st.coords[:, 2]) * w + st.coords[:, 3]


def build_row_table(st: sp.SparseTensor):
    """Dense (B*D*H*W,) int32 table: voxel cell -> row index (-1 empty)."""
    d, h, w = st.spatial_shape
    size = st.batch_size * d * h * w
    flat = torch.where(st.mask, _flat_cells(st),
                       torch.full((st.capacity,), size, dtype=torch.long,
                                  device=st.coords.device))
    table = torch.full((size + 1,), -1, dtype=torch.int32,
                       device=st.coords.device)
    table[flat[st.mask]] = torch.arange(
        st.capacity, dtype=torch.int32, device=st.coords.device)[st.mask]
    return table[:size]


class PoolTables(NamedTuple):
    """``rows``: cell -> row. ``occ``: occupancy words at a 16-bit stride
    (word k covers cell bits [16k, 16k+32)), held in int64."""
    rows: torch.Tensor
    occ: torch.Tensor


def build_pool_tables(st: sp.SparseTensor) -> PoolTables:
    d, h, w = st.spatial_shape
    size = st.batch_size * d * h * w
    dev = st.coords.device
    rows = build_row_table(st)
    npad = -size % 16 + 32
    occ_bool = torch.zeros((size + npad,), dtype=torch.int64, device=dev)
    occ_bool[_flat_cells(st)[st.mask]] = 1
    half = occ_bool.reshape(-1, 16)
    weights = torch.tensor([1 << i for i in range(16)], dtype=torch.int64,
                           device=dev)
    half = (half * weights[None]).sum(1)
    hi = torch.cat([half[1:], torch.zeros((1,), dtype=torch.int64,
                                          device=dev)])
    return PoolTables(rows=rows, occ=half | (hi << 16))


def _expanded_window(ranges, radius, voxel_size, stride):
    """(z, y) lane offsets pruned by the 2-D reachability bound, and the
    full (lane x x-offset) enumeration in z-major scan order."""
    rz, ry, rx = ranges
    nine = 2 * rx + 1
    if nine > 17:
        raise ValueError('x window must fit one 16-bit-stride word')
    vs = np.asarray(voxel_size, np.float64)[::-1] * stride
    zz, yy = np.meshgrid(np.arange(-rz, rz + 1), np.arange(-ry, ry + 1),
                         indexing='ij')
    lanes = np.stack([zz, yy], -1).reshape(-1, 2).astype(np.int32)
    gap = np.clip(np.abs(lanes) - 0.5, 0, None) * vs[:2][None]
    lanes = lanes[np.linalg.norm(gap, axis=1) < radius]
    dx = np.arange(-rx, rx + 1, dtype=np.int32)
    offs = np.concatenate([np.repeat(lanes, nine, 0),
                           np.tile(dx, len(lanes))[:, None]], 1)
    return lanes, offs


def _bit_probe(occ, lanes, nine, n_cells, qcoords, qmask, d, h, w):
    """(m, L*nine) occupancy of every window candidate from one word per
    (query, lane)."""
    rx = (nine - 1) // 2
    qb, qz, qy, qx = (qcoords[:, i].long() for i in range(4))
    x0 = qx - rx
    x0c = torch.clamp(x0, 0, w - nine)
    dpos = x0c - x0
    z = qz[:, None] + lanes[None, :, 0]
    y = qy[:, None] + lanes[None, :, 1]
    lane_ok = qmask[:, None] & (z >= 0) & (z < d) & (y >= 0) & (y < h)
    s = ((qb[:, None] * d + z) * h + y) * w + x0c[:, None]
    s = torch.clamp(s, 0, n_cells - 1)
    word = occ[s >> 4]
    mask9 = (1 << nine) - 1
    win = (word >> (s & 15)) & mask9
    up = win << torch.clamp(dpos, 0, 31)[:, None]
    down = win >> torch.clamp(-dpos, 0, 31)[:, None]
    win = torch.where((dpos >= 0)[:, None], up, down) & mask9
    win = torch.where(lane_ok, win, torch.zeros_like(win))
    bits = (win[:, :, None] >> torch.arange(nine, device=occ.device)) & 1
    return (bits > 0).reshape(qcoords.shape[0], -1)


def _select_first_idx(ok, nsample):
    """Scan indices of the first ``nsample`` valid candidates:
    (topidx (m, ns), hit (m, ns))."""
    m, k = ok.shape
    rank = torch.cumsum(ok.to(torch.int32), 1, dtype=torch.int32)
    dst = torch.where(ok & (rank <= nsample), rank - 1,
                      torch.full_like(rank, nsample)).long()
    j = torch.arange(k, device=ok.device).expand(m, k)
    topidx = torch.zeros((m, nsample + 1), dtype=torch.long,
                         device=ok.device)
    topidx.scatter_(1, dst, j)
    hit = torch.arange(1, nsample + 1, device=ok.device)[None] \
        <= rank[:, -1:]
    return topidx[:, :nsample], hit


def voxel_query_groups(st, table: PoolTables, query_xyz, query_coords,
                       query_mask, group_specs, voxel_size, stride,
                       point_cloud_range, chunk_budget=None):
    """Multi-group voxel query sharing one window probe. Returns per group
    (rows (M, ns) int64, valid (M, ns) bool, centers (M, ns, 3))."""
    union_ranges, union_radius = group_specs[-1][0], group_specs[-1][1]
    for rg, rad, _ in group_specs:
        if not (all(a <= b for a, b in zip(rg, union_ranges))
                and rad <= union_radius):
            raise ValueError('group windows and radii must nest')
    dev = query_xyz.device
    lanes_np, offs_np = _expanded_window(union_ranges, union_radius,
                                         voxel_size, stride)
    lanes = torch.as_tensor(lanes_np, dtype=torch.long, device=dev)
    nine = 2 * union_ranges[2] + 1
    offs = torch.as_tensor(offs_np, dtype=torch.long, device=dev)
    members = []
    for rg, rad, _ in group_specs:
        box = ((abs(offs_np[:, 0]) <= rg[0]) & (abs(offs_np[:, 1]) <= rg[1])
               & (abs(offs_np[:, 2]) <= rg[2]))
        members.append(torch.as_tensor(box, device=dev))
    d, h, w = st.spatial_shape
    n_cells = st.batch_size * d * h * w
    vs = torch.as_tensor(voxel_size, dtype=torch.float32, device=dev) * stride
    mins = torch.as_tensor(point_cloud_range[:3], dtype=torch.float32,
                           device=dev)
    k = offs.shape[0]
    m = query_xyz.shape[0]

    def probe(qxyz, qcoords, qmask):
        occupied = _bit_probe(table.occ, lanes, nine, n_cells, qcoords,
                              qmask, d, h, w)
        cand = (qcoords[:, None, 1:].long() + offs[None]).flip(-1).float()
        centers = (cand + 0.5) * vs + mins                   # (m, K) x,y,z
        diff = centers - qxyz[:, None, :]
        dist2 = (diff[..., 0] ** 2 + diff[..., 1] ** 2) + diff[..., 2] ** 2
        out = []
        for (rg, rad, nsample), member in zip(group_specs, members):
            ok_g = occupied & member[None] & (dist2 < float(rad) * rad)
            topidx, hit = _select_first_idx(ok_g, nsample)
            neigh = qcoords[:, None, 1:].long() + offs[topidx]
            flat = ((qcoords[:, None, 0].long() * d + neigh[..., 0]) * h
                    + neigh[..., 1]) * w + neigh[..., 2]
            rows = table.rows[torch.clamp(flat, 0, n_cells - 1)].long()
            rows = torch.where(hit, rows.clamp(min=0), torch.zeros_like(rows))
            csel = (neigh.flip(-1).float() + 0.5) * vs + mins
            csel = torch.where(hit[..., None], csel, torch.zeros_like(csel))
            out.append((rows, hit, csel))
        return out

    budget = CHUNK_BUDGET_EVAL if chunk_budget is None else chunk_budget
    if m * k <= budget:
        return probe(query_xyz, query_coords, query_mask)
    csize = -(-m // -(-(m * k) // budget))
    parts = [probe(query_xyz[i:i + csize], query_coords[i:i + csize],
                   query_mask[i:i + csize]) for i in range(0, m, csize)]
    return [tuple(torch.cat([p[g][j] for p in parts]) for j in range(3))
            for g in range(len(group_specs))]


class PosKernel(nn.Module):
    """Bare (3, mid) position kernel under the flax path ``mlp_pos{g}``."""

    def __init__(self, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, features))


class NeighborVoxelSAModule(nn.Module):
    """Multi-scale-group voxel SA module (NeighborVoxelSAModuleMSG), eval."""

    def __init__(self, in_channels: int, query_ranges, radii, nsamples, mlps,
                 voxel_size, point_cloud_range):
        super().__init__()
        self.query_ranges = tuple(tuple(q) for q in query_ranges)
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.mlps = tuple(tuple(m) for m in mlps)
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        for g, (mid, out_c) in enumerate(self.mlps):
            setattr(self, f'mlp_in{g}', nn.Linear(in_channels, mid,
                                                  bias=False))
            setattr(self, f'mlp_in_bn{g}', MaskedBatchNorm(mid))
            setattr(self, f'mlp_pos{g}', PosKernel(mid))
            setattr(self, f'mlp_pos_bn{g}', MaskedBatchNorm(mid))
            setattr(self, f'mlp_out{g}', nn.Linear(mid, out_c, bias=False))
            setattr(self, f'mlp_out_bn{g}', MaskedBatchNorm(out_c))

    def forward(self, st: sp.SparseTensor, stride, query_xyz, query_coords,
                query_mask, table_fn=None, q_per_roi=None):
        """Pooled (M, sum of out widths) features of M queries.
        ``table_fn`` returns the PoolTables of ``st`` (built on demand);
        ``q_per_roi`` (queries per ROI) is recorded for the work tally;
        """
        specs = tuple((self.query_ranges[g], self.radii[g], self.nsamples[g])
                      for g in range(len(self.query_ranges)))
        self.tally_q = q_per_roi
        n_g = len(specs)
        if self.training:
            return self._train_pool(st, stride, query_xyz, query_coords,
                                    query_mask, table_fn, specs)
        feats_g = []
        for g in range(n_g):
            mlp_in = getattr(self, f'mlp_in{g}')
            f = mlp_in(promote(st.feats, mlp_in.weight))
            feats_g.append(getattr(self, f'mlp_in_bn{g}')(f, st.mask))

        # the reference's one route: the probe path (no pooling kernel)
        pooled = self._probe_pool(st, stride, query_xyz, query_coords,
                                  query_mask, table_fn, specs, feats_g)
        outs = []
        for g in range(n_g):
            x = getattr(self, f'mlp_out{g}')(pooled[g])
            x = getattr(self, f'mlp_out_bn{g}')(x, query_mask)
            outs.append(torch.relu(x))
        return torch.cat(outs, -1)

    def _probe_pool(self, st, stride, query_xyz, query_coords, query_mask,
                    table_fn, specs, feats_g):
        tbl = table_fn() if table_fn is not None else build_pool_tables(st)
        queries = voxel_query_groups(st, tbl, query_xyz, query_coords,
                                     query_mask, specs, self.voxel_size,
                                     stride, self.point_cloud_range)
        outs = []
        for g in range(len(specs)):
            idx, valid, centers = queries[g]
            tally.pool(stride, getattr(self, 'tally_q', None), idx, valid,
                       query_mask, st.mask.sum(), feats_g[g].shape[1])
            mult, bias = getattr(self, f'mlp_pos_bn{g}').fold()
            w_pos = getattr(self, f'mlp_pos{g}').kernel
            grouped = operand(feats_g[g])[idx] \
                * valid[..., None].to(feats_g[g].dtype)
            rel = (centers - query_xyz[:, None, :]) * valid[..., None]
            pos = rel @ w_pos * mult + bias
            pos = torch.where(query_mask[:, None, None], pos,
                              torch.zeros_like(pos))
            x = torch.relu(grouped + pos)
            x = torch.where(valid[..., None], x, torch.zeros_like(x))
            outs.append(x.amax(1))
        return torch.stack(outs)

    def _train_pool(self, st, stride, query_xyz, query_coords, query_mask,
                    table_fn, specs):
        """Train-mode pooling: the probe selects (no gradient), then per
        group the gathered features plus the batch-normalized position
        encoding, ReLU, max over the samples."""
        tbl = table_fn() if table_fn is not None else build_pool_tables(st)
        with torch.no_grad():
            queries = voxel_query_groups(st, tbl, query_xyz.detach(),
                                         query_coords, query_mask, specs,
                                         self.voxel_size, stride,
                                         self.point_cloud_range)
        outs = []
        for g, (idx, valid, centers) in enumerate(queries):
            f = getattr(self, f'mlp_in{g}')(st.feats)
            tally.pool(stride, getattr(self, 'tally_q', None), idx, valid,
                       query_mask, st.mask.sum(), f.shape[1])
            f = getattr(self, f'mlp_in_bn{g}')(f, st.mask)
            x = self._group_body(g, f, idx, valid, centers, query_xyz,
                                 query_mask)
            x = getattr(self, f'mlp_out{g}')(x)
            outs.append(torch.relu(getattr(self, f'mlp_out_bn{g}')(
                x, query_mask)))
        return torch.cat(outs, -1)

    def _group_body(self, g, feats, idx, valid, centers, query_xyz,
                    query_mask):
        """Gather, position-encode and max-reduce one group (M, mid). The
        position BN's batch moments come algebraically from the (M, S, 3)
        relative positions (pos = rel @ W is linear in rel): mean =
        mean(rel) @ W and var = diag(W^T cov(rel) W), over the samples of
        valid queries, as the JAX package computes them. The rows are
        gathered with ``ops.gather_rows``, whose backward sums each voxel's
        gradient rows in gather order without atomics (the same bits on
        every run; ``index_select``'s ``index_add_`` adds with atomics in
        any order). The backward of ``feats[idx]`` (a sort-based
        ``index_put_``) serializes the many queries of one voxel and took
        13 of the 16.7 s of a full-width step on an H100."""
        w_pos = getattr(self, f'mlp_pos{g}').kernel
        rel = (centers - query_xyz[:, None, :]) * valid[..., None]
        qm = query_mask[:, None] & torch.ones_like(valid)
        qmf = qm[..., None].to(rel.dtype)
        # two passes: the count and sum of rel, then the centered 3 x 3
        # rc^T rc
        sum_rel = (rel * qmf).reshape(-1, 3).sum(0)
        n = qm.sum().float()
        cnt = torch.clamp(n, min=1.0)
        mean_rel = sum_rel / cnt
        rc = ((rel - mean_rel) * qmf).reshape(-1, 3)
        s2 = rc.T @ rc
        var = torch.clamp(torch.einsum('ic,ic->c', w_pos,
                                       (s2 / cnt) @ w_pos), min=0.0)
        mult, bias = getattr(self, f'mlp_pos_bn{g}').fold_moments(
            mean_rel @ w_pos, var, cnt)
        pos = rel @ (w_pos * mult) + bias
        pos = torch.where(qm[..., None], pos, torch.zeros_like(pos))
        rows = gather_rows(feats, idx, valid).reshape(*idx.shape,
                                                      feats.shape[1])
        x = torch.relu(rows + pos)
        x = torch.where(valid[..., None], x, torch.zeros_like(x))
        return x.amax(1)
