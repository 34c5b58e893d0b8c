"""Sparse voxel tensor substrate of the reference: every conv on the
neighbor map (eval, and training with a gather-only backward), and
voxelization.

A sparse tensor is a fixed-capacity triple:

    feats  : (N, C)  float   -- padded rows are zero
    coords : (N, D+1) int32  -- [b, z, y, x] (3D) or [b, u, v] (2D); padded
                                rows are -1
    mask   : (N,)    bool    -- row validity

Rows are sorted by the linearized int32 voxel key (batch-major, then the
``key_order`` axes) with invalid rows keyed to INVALID_KEY so they sort last.
Neighbor lookup is a binary search over the sorted keys. Coords, keys,
masks and neighbor maps are the measured program's; keys stay int32
throughout (a widening to int64 would change every key).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import tally

INVALID_KEY = 2 ** 31 - 1

@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """Fixed-capacity sparse voxel tensor (rows sorted by voxel key)."""

    feats: torch.Tensor                # (N, C)
    coords: torch.Tensor               # (N, ndim+1) int32, [b, *spatial]
    mask: torch.Tensor                 # (N,) bool
    spatial_shape: Tuple[int, ...]
    batch_size: int

    @property
    def capacity(self) -> int:
        return self.feats.shape[0]

    @property
    def num_channels(self) -> int:
        return self.feats.shape[-1]

    @property
    def ndim(self) -> int:
        return len(self.spatial_shape)

    def keys(self) -> torch.Tensor:
        return coords_to_keys(self.coords, self.spatial_shape,
                              self.batch_size, self.mask)

    def replace(self, **kw) -> "SparseTensor":
        return dataclasses.replace(self, **kw)


def _full_like_invalid(x):
    return torch.full_like(x, INVALID_KEY)


def key_order(ndim: int) -> Tuple[int, ...]:
    """3D keys are linearized (b, y, x, z), z fastest, so all 27 neighbors
    of a site lie in three narrow key bands (one per y-slab); 2D keys keep
    (u, v) order."""
    return (1, 2, 0) if ndim == 3 else tuple(range(ndim))


def key_strides(spatial_shape: Sequence[int]):
    """Per-spatial-axis multiplier in the linearized key, and the total
    cell count per batch entry."""
    order = key_order(len(spatial_shape))
    strides = [0] * len(spatial_shape)
    m = 1
    for ax in reversed(order):
        strides[ax] = m
        m *= int(spatial_shape[ax])
    return tuple(strides), m


def coords_to_keys(coords, spatial_shape, batch_size, mask):
    """Linearize [b, *spatial] int32 coords into sortable int32 keys."""
    strides, m = key_strides(spatial_shape)
    total = batch_size * m
    if total >= 2 ** 31:
        raise ValueError(f'key space {total} overflows int32')
    key = coords[:, 0] * m
    for i, s in enumerate(strides):
        key = key + coords[:, i + 1] * s
    return torch.where(mask, key.to(torch.int32), _full_like_invalid(key))


def sort_by_key_with_perm(st: SparseTensor):
    """Sort rows by key (stable); also return the permutation (new <- old)."""
    order = torch.argsort(st.keys(), stable=True)
    return st.replace(feats=st.feats[order], coords=st.coords[order],
                      mask=st.mask[order]), order


def sort_by_key(st: SparseTensor) -> SparseTensor:
    return sort_by_key_with_perm(st)[0]


def lookup(sorted_keys, query_keys):
    """Row index of each query key in a sorted key array, -1 if absent.
    Duplicate keys resolve to the first row of their run."""
    pos = torch.searchsorted(sorted_keys, query_keys).to(torch.int32)
    n = sorted_keys.shape[0]
    pos_c = torch.clamp(pos, max=n - 1)
    hit = (sorted_keys[pos_c] == query_keys) & (query_keys != INVALID_KEY)
    return torch.where(hit, pos_c, torch.full_like(pos_c, -1))


# Key spaces up to this many cells use a dense table for neighbor lookup
# instead of a sorted binary search (as in the JAX package).
DENSE_LOOKUP_MAX = 128_000_000


def make_lookup(st: SparseTensor):
    """key -> row lookup function for one coordinate set (dense table when
    the key space fits DENSE_LOOKUP_MAX, sorted search otherwise).

    Duplicate keys resolve to their lowest row index, as the sorted search
    does. (The JAX dense table leaves the winner of a duplicate scatter to
    the backend; only the 2D image-plane tensor has duplicates.)"""
    total = st.batch_size
    for s in st.spatial_shape:
        total *= int(s)
    keys = st.keys()
    if total <= DENSE_LOOKUP_MAX:
        dev = keys.device
        slot = torch.where(st.mask, keys.long(),
                           torch.full_like(keys, total, dtype=torch.long))
        rows = torch.arange(st.capacity, dtype=torch.int32, device=dev)
        table = torch.full((total + 1,), st.capacity, dtype=torch.int32,
                           device=dev)
        table.scatter_reduce_(0, slot, rows, 'amin')
        table = torch.where(table == st.capacity,
                            torch.full_like(table, -1), table)
        table[total] = -1

        def dense_fn(qk):
            qc = torch.where((qk >= 0) & (qk < total), qk.long(),
                             torch.full_like(qk, total, dtype=torch.long))
            return table[qc]
        return dense_fn
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]

    def sorted_fn(qk):
        r = lookup(skeys, qk)
        return torch.where(r >= 0, order.to(torch.int32)[r.clamp(min=0)], r)
    return sorted_fn


def _kernel_offsets(kernel_size, centered=True):
    ranges = [np.arange(k) - (k // 2 if centered else 0) for k in kernel_size]
    grid = np.stack(np.meshgrid(*ranges, indexing='ij'), axis=-1)
    return grid.reshape(-1, len(kernel_size)).astype(np.int32)


def _triple(v, ndim):
    return (v,) * ndim if isinstance(v, int) else tuple(v)


def build_subm_neighbor_map(st: SparseTensor, kernel_size):
    """(N, K) row indices of each site's submanifold-conv neighbors, -1 if
    missing."""
    kernel_size = _triple(kernel_size, st.ndim)
    offsets = torch.as_tensor(_kernel_offsets(kernel_size),
                              device=st.coords.device)     # (K, ndim)
    strides, m = key_strides(st.spatial_shape)
    neigh = st.coords[:, None, 1:] + offsets[None]
    ok = st.mask[:, None]
    for i, s in enumerate(st.spatial_shape):
        ok = ok & (neigh[:, :, i] >= 0) & (neigh[:, :, i] < s)
    nkey = st.coords[:, None, 0] * m
    for i, s in enumerate(strides):
        nkey = nkey + neigh[:, :, i] * s
    nkey = torch.where(ok, nkey, _full_like_invalid(nkey))
    return make_lookup(st)(nkey.reshape(-1)).reshape(nkey.shape)


def _gather(feats, idx):
    """feats rows at ``idx``, zero where idx is -1."""
    return feats[idx.clamp(min=0).long()] * (idx >= 0)[:, None].to(
        feats.dtype)


def _gathered_conv_raw(feats, neighbor_map, weights):
    from ..precision import operand
    out = None
    feats = operand(feats.float())
    for j in range(neighbor_map.shape[1]):
        contrib = _gather(feats, neighbor_map[:, j]) \
            @ operand(weights[j].float())
        out = contrib if out is None else out + contrib
    return out


def gathered_conv(feats, neighbor_map, weights, out_mask):
    """Sparse conv from a neighbor map: one gather + matmul per tap.

    feats (N_in, C), neighbor_map (N_out, K) with -1 = no contribution,
    weights (K, C, C'), out_mask (N_out,). Returns (N_out, C') float32."""
    out = _gathered_conv_raw(feats, neighbor_map, weights)
    return out * out_mask[:, None].to(out.dtype)


class _GatheredConvTrain(torch.autograd.Function):
    """``gathered_conv`` with the gather-only backward of the JAX package's
    ``gathered_conv_train``: dfeats is the transpose conv over the
    transpose map, ``dfeats[p] = sum_k g[tmap[p, k]] @ W[k]^T``, and
    ``dW[k] = gather_k(feats)^T @ g``; no scatter. Every product is one
    call: the forward and the input gradient ``nmap_conv``, the weight
    gradient ``nmap_conv_dw`` (their plain versions)."""

    @staticmethod
    def forward(ctx, feats, weights, nmap, tmap, out_mask, in_mask):
        from .nmap_conv import nmap_conv
        ctx.save_for_backward(feats, weights, nmap, tmap, out_mask, in_mask)
        out = nmap_conv(feats, nmap, weights)
        return out * out_mask[:, None].to(out.dtype)

    @staticmethod
    def backward(ctx, g):
        from .nmap_conv import nmap_conv, nmap_conv_dw
        feats, w, nmap, tmap, out_mask, in_mask = ctx.saved_tensors
        g = g * out_mask[:, None].to(g.dtype)
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            dfeats = nmap_conv(g, tmap, w.transpose(1, 2).contiguous()) \
                * in_mask[:, None].to(g.dtype)
        if ctx.needs_input_grad[1]:
            dw = nmap_conv_dw(feats, nmap, g)
        return dfeats, dw, None, None, None, None


def gathered_conv_train(feats, weights, neighbor_map, transpose_map,
                        out_mask, in_mask, subm=False):
    """Differentiable neighbor-map conv (see ``_GatheredConvTrain``).
    ``transpose_map`` (N_in, K): the output row whose tap k reads each
    input row, -1 if none."""
    tally.conv(neighbor_map, out_mask, weights, subm)
    return _GatheredConvTrain.apply(feats, weights, neighbor_map,
                                    transpose_map, out_mask, in_mask)


def downsample_coords(st: SparseTensor, stride, padding, kernel_size,
                      out_capacity: int) -> SparseTensor:
    """Output sites of a strided sparse conv (spconv SparseConv3d rule),
    sorted by key and compacted to ``out_capacity``. Feats are a (cap, 1)
    zero placeholder."""
    ndim = st.ndim
    stride = _triple(stride, ndim)
    padding = _triple(padding, ndim)
    kernel_size = _triple(kernel_size, ndim)
    out_shape = tuple(
        (st.spatial_shape[i] + 2 * padding[i] - kernel_size[i]) // stride[i]
        + 1 for i in range(ndim))
    key_mul, m_total = key_strides(out_shape)
    if st.batch_size * m_total >= 2 ** 31:
        raise ValueError('out key space overflows int32')
    dev = st.coords.device
    cand_per_dim, n_cand_per_dim = [], []
    for i in range(ndim):
        p = st.coords[:, i + 1] + padding[i]
        lo = -torch.div(-(p - kernel_size[i] + 1), stride[i],
                        rounding_mode='floor')
        hi = torch.div(p, stride[i], rounding_mode='floor')
        max_c = (kernel_size[i] + stride[i] - 1) // stride[i]
        c = lo[:, None] + torch.arange(max_c, dtype=torch.int32,
                                       device=dev)[None]
        valid = (c <= hi[:, None]) & (c >= 0) & (c < out_shape[i])
        cand_per_dim.append(torch.where(valid, c * key_mul[i],
                                        torch.full_like(c, -1)))
        n_cand_per_dim.append(max_c)
    total = int(np.prod(n_cand_per_dim))
    n = st.capacity
    key = torch.zeros((n, total), dtype=torch.int32, device=dev)
    ok = st.mask[:, None].expand(n, total)
    rep = total
    for i in range(ndim):
        rep //= n_cand_per_dim[i]
        tile = total // (rep * n_cand_per_dim[i])
        col = cand_per_dim[i].repeat_interleave(rep, dim=1).repeat(1, tile)
        ok = ok & (col >= 0)
        key = key + col.clamp(min=0)
    key = key + st.coords[:, :1] * m_total
    keys = torch.where(ok, key, _full_like_invalid(key)).reshape(-1)

    srt = torch.sort(keys).values
    is_first = torch.ones_like(srt, dtype=torch.bool)
    is_first[1:] = srt[1:] != srt[:-1]
    out_keys = torch.sort(torch.where(is_first, srt,
                                      _full_like_invalid(srt))).values
    if out_capacity <= out_keys.shape[0]:
        out_keys = out_keys[:out_capacity]
    else:
        out_keys = torch.cat([out_keys, torch.full(
            (out_capacity - out_keys.shape[0],), INVALID_KEY,
            dtype=torch.int32, device=dev)])
    out_mask = out_keys != INVALID_KEY
    safe = torch.where(out_mask, out_keys, torch.zeros_like(out_keys))
    cols = [torch.div(safe, m_total, rounding_mode='floor')]
    for i in range(ndim):
        cols.append(torch.div(safe, key_mul[i], rounding_mode='floor')
                    % out_shape[i])
    out_coords = torch.where(out_mask[:, None],
                             torch.stack(cols, 1).to(torch.int32),
                             torch.full((out_capacity, ndim + 1), -1,
                                        dtype=torch.int32, device=dev))
    return SparseTensor(
        feats=torch.zeros((out_capacity, 1), dtype=st.feats.dtype,
                          device=dev),
        coords=out_coords, mask=out_mask, spatial_shape=out_shape,
        batch_size=st.batch_size)


def build_strided_neighbor_map(st_in, st_out, stride, padding, kernel_size):
    """(N_out, K) input row at ``coords_out*stride - pad + offset_k``, -1
    if absent."""
    ndim = st_in.ndim
    stride = _triple(stride, ndim)
    padding = _triple(padding, ndim)
    kernel_size = _triple(kernel_size, ndim)
    offsets = torch.as_tensor(_kernel_offsets(kernel_size, centered=False),
                              device=st_in.coords.device)
    base = torch.stack([st_out.coords[:, i + 1] * stride[i] - padding[i]
                        for i in range(ndim)], -1)
    neigh = base[:, None, :] + offsets[None]
    ok = st_out.mask[:, None]
    for i, s in enumerate(st_in.spatial_shape):
        ok = ok & (neigh[:, :, i] >= 0) & (neigh[:, :, i] < s)
    strides_in, m = key_strides(st_in.spatial_shape)
    nkey = st_out.coords[:, None, 0] * m
    for i, s in enumerate(strides_in):
        nkey = nkey + neigh[:, :, i] * s
    nkey = torch.where(ok, nkey, _full_like_invalid(nkey))
    return make_lookup(st_in)(nkey.reshape(-1)).reshape(nkey.shape)


def build_strided_transpose_map(st_in, st_out, stride, padding,
                                kernel_size):
    """(N_in, K) map of the strided-conv transpose: the output row whose tap
    k reads input row p, at ``(coords_in[p] + pad - offset_k) / stride``
    when that division is exact and in bounds, else -1."""
    ndim = st_in.ndim
    stride = _triple(stride, ndim)
    padding = _triple(padding, ndim)
    kernel_size = _triple(kernel_size, ndim)
    dev = st_in.coords.device
    offsets = torch.as_tensor(_kernel_offsets(kernel_size, centered=False),
                              device=dev)
    num = (st_in.coords[:, None, 1:]
           + torch.tensor(padding, dtype=torch.int32, device=dev)
           - offsets[None])
    sv = torch.tensor(stride, dtype=torch.int32, device=dev)
    q = torch.div(num, sv, rounding_mode='floor')
    ok = st_in.mask[:, None] & (num % sv == 0).all(-1) & (q >= 0).all(-1)
    for i, s in enumerate(st_out.spatial_shape):
        ok = ok & (q[:, :, i] < s)
    strides_out, m = key_strides(st_out.spatial_shape)
    qkey = st_in.coords[:, None, 0] * m
    for i, s in enumerate(strides_out):
        qkey = qkey + q[:, :, i] * s
    qkey = torch.where(ok, qkey, _full_like_invalid(qkey))
    return make_lookup(st_out)(qkey.reshape(-1)).reshape(qkey.shape)


def nmap_subm_conv_ctx(st: SparseTensor, kernel_size):
    """Training conv function ``conv(feats, weights)`` of a submanifold conv
    on the neighbor map (any row order; the NRConv 2D image-plane tensor).
    The transpose map of a centered kernel is the tap-reversed map."""
    nmap = build_subm_neighbor_map(st, kernel_size)
    tmap = nmap.flip(1)
    return lambda feats, weights: gathered_conv_train(
        feats, weights, nmap, tmap, st.mask, st.mask, subm=True)


def nmap_strided_conv_ctx(st_in, st_out, stride, padding, kernel_size):
    """Training conv function ``conv(feats, weights)`` of a strided conv on
    the neighbor map, with the transpose map for its backward."""
    nmap = build_strided_neighbor_map(st_in, st_out, stride, padding,
                                      kernel_size)
    tmap = build_strided_transpose_map(st_in, st_out, stride, padding,
                                       kernel_size)
    return lambda feats, weights: gathered_conv_train(
        feats, weights, nmap, tmap, st_out.mask, st_in.mask)


def _epilogue(out, mask, scale, bias, relu):
    if scale is not None:
        out = out * scale + bias
    if relu:
        out = torch.relu(out)
    if scale is not None and mask is not None:   # bias may un-zero them
        out = torch.where(mask[:, None], out, torch.zeros_like(out))
    return out


def _nmap_ctx(nmap, out_mask, subm=True):
    """Eval conv function of a context on the neighbor map ``nmap``: the
    exact conv (``nmap_conv``) on f32 operands, then the epilogue on f32
    rows."""
    def conv(feats, weights, scale=None, bias=None, relu=False):
        from .nmap_conv import nmap_conv
        tally.conv(nmap, out_mask, weights, subm)
        out = nmap_conv(feats, nmap, weights)
        return _epilogue(out * out_mask[:, None].to(out.dtype), out_mask,
                         scale, bias, relu)
    return conv


def subm_conv_ctx(st: SparseTensor, kernel_size, train: bool = False):
    """Conv function of a submanifold conv on ``st``, on the neighbor map:
    at eval ``_nmap_ctx``, in training ``nmap_subm_conv_ctx``."""
    kernel_size = _triple(kernel_size, st.ndim)
    if train:
        return nmap_subm_conv_ctx(st, kernel_size)
    return _nmap_ctx(build_subm_neighbor_map(st, kernel_size), st.mask)


def strided_conv_ctx(st_in, st_out, stride, padding, kernel_size):
    """Eval conv function of a strided conv st_in -> st_out on the
    neighbor map (``_nmap_ctx``)."""
    kernel_size = _triple(kernel_size, st_in.ndim)
    return _nmap_ctx(build_strided_neighbor_map(
        st_in, st_out, stride, padding, kernel_size), st_out.mask,
        subm=False)


def to_dense(st: SparseTensor) -> torch.Tensor:
    """Scatter a 3D sparse tensor into dense (B, D, H, W, C)."""
    d, h, w = st.spatial_shape
    c = st.num_channels
    size = st.batch_size * d * h * w
    flat = ((st.coords[:, 0].long() * d + st.coords[:, 1]) * h
            + st.coords[:, 2]) * w + st.coords[:, 3]
    flat = torch.where(st.mask, flat, torch.full_like(flat, size - 1))
    contrib = torch.where(st.mask[:, None], st.feats,
                          torch.zeros_like(st.feats))
    out = torch.zeros((size, c), dtype=st.feats.dtype,
                      device=st.feats.device)
    out.index_add_(0, flat, contrib)
    return out.reshape(st.batch_size, d, h, w, c)


def voxelize(points, points_mask, point_cloud_range, voxel_size,
             max_voxels: int, max_points_per_voxel: int, batch_size: int = 1,
             batch_idx=None, indicator_max: bool = False) -> SparseTensor:
    """Fused voxelization + mean-VFE (``virconv_tpu.ops.sparse.voxelize``).

    Only the first ``max_points_per_voxel`` points (input order) of a voxel
    count; with ``indicator_max`` the last channel takes their max; voxels
    past ``max_voxels`` in key order are dropped. Returns a tensor sorted by
    key with coords [b, z, y, x]."""
    dev = points.device
    pcr = torch.as_tensor(point_cloud_range[:3], dtype=torch.float32,
                          device=dev)
    vs = torch.as_tensor(voxel_size, dtype=torch.float32, device=dev)
    grid = [int(round(float((point_cloud_range[i + 3]
                             - point_cloud_range[i]) / voxel_size[i])))
            for i in range(3)]
    gx, gy, gz = grid
    spatial_shape = (gz, gy, gx)

    vox = torch.floor((points[:, :3] - pcr) / vs).to(torch.int32)
    in_range = ((vox >= 0).all(1) & (vox[:, 0] < gx) & (vox[:, 1] < gy)
                & (vox[:, 2] < gz))
    valid = points_mask & in_range
    p = points.shape[0]
    if batch_idx is None:
        batch_idx = torch.zeros((p,), dtype=torch.int32, device=dev)
    strides, m = key_strides(spatial_shape)
    key = (batch_idx * m + vox[:, 2] * strides[0] + vox[:, 1] * strides[1]
           + vox[:, 0] * strides[2])
    key = torch.where(valid, key.to(torch.int32), _full_like_invalid(key))

    order = torch.argsort(key, stable=True)
    key_s = key[order]
    pts_s = points[order]
    valid_s = valid[order]
    is_first = torch.ones_like(valid_s)
    is_first[1:] = key_s[1:] != key_s[:-1]
    is_first = is_first & valid_s
    voxel_id = torch.cumsum(is_first.to(torch.int32), 0,
                            dtype=torch.int32) - 1
    voxel_id = torch.where(valid_s, voxel_id,
                           torch.full_like(voxel_id, max_voxels))
    pos = torch.arange(p, dtype=torch.int32, device=dev)
    seg_start = torch.cummax(torch.where(is_first, pos,
                                         torch.full_like(pos, -1)), 0).values
    rank = pos - seg_start
    keep = valid_s & (rank < max_points_per_voxel) & (voxel_id < max_voxels)
    slot = torch.clamp(voxel_id, max=max_voxels).long()

    # each voxel's kept points summed in rank order, as a sequential
    # index_add_ on the CPU sums them: every kept point has its own
    # (voxel, rank) row, so no two writes meet and the means are the same
    # bits on every run (index_add_ on CUDA adds with atomics in whatever
    # order they land)
    c = points.shape[1]
    rows = torch.where(keep, slot * max_points_per_voxel + rank.long(),
                       torch.full_like(slot, (max_voxels + 1)
                                       * max_points_per_voxel))
    by_rank = torch.zeros(((max_voxels + 1) * max_points_per_voxel + 1, c),
                          dtype=pts_s.dtype, device=dev)
    by_rank[rows] = pts_s
    by_rank = by_rank[:-1].view(max_voxels + 1, max_points_per_voxel, c)
    sums = by_rank[:, 0]
    for r in range(1, max_points_per_voxel):
        sums = sums + by_rank[:, r]
    cnts = torch.zeros((max_voxels + 1,), dtype=torch.float32, device=dev)
    cnts.index_add_(0, slot, keep.float())
    mean = sums[:max_voxels] / torch.clamp(cnts[:max_voxels, None], min=1.0)
    if indicator_max:
        last = torch.where(keep, pts_s[:, -1],
                           torch.full_like(pts_s[:, -1], -float('inf')))
        mx = torch.full((max_voxels + 1,), -float('inf'), dtype=pts_s.dtype,
                        device=dev)
        mx.scatter_reduce_(0, slot, last, 'amax')
        mx = mx[:max_voxels]
        mean[:, -1] = torch.where(torch.isfinite(mx), mx,
                                  torch.zeros_like(mx))

    vb = batch_idx[order]
    vo = vox[order]
    crow = torch.stack([vb, vo[:, 2], vo[:, 1], vo[:, 0]], -1)
    first_ok = is_first & (voxel_id < max_voxels)
    tgt = torch.where(first_ok, voxel_id,
                      torch.full_like(voxel_id, max_voxels)).long()
    vcoords = torch.full((max_voxels + 1, 4), -1, dtype=torch.int32,
                         device=dev)
    vcoords[tgt[first_ok]] = crow[first_ok].to(torch.int32)
    vmask = cnts[:max_voxels] > 0
    return SparseTensor(
        feats=torch.where(vmask[:, None], mean, torch.zeros_like(mean)),
        coords=torch.where(vmask[:, None], vcoords[:max_voxels],
                           torch.full_like(vcoords[:max_voxels], -1)),
        mask=vmask, spatial_shape=spatial_shape, batch_size=batch_size)
