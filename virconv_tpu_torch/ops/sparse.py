"""Sparse voxel tensor substrate (PyTorch counterpart of
``virconv_tpu/ops/sparse.py``): eval conv contexts (the band conv, or the
neighbor-map conv with ``use_band=False``) and the training ones (band
conv with a K1 + K4 backward, neighbor-map convs with a gather-only
backward), and the readers of the JAX package's switches that pick them.

A sparse tensor is a fixed-capacity triple:

    feats  : (N, C)  float   -- padded rows are zero
    coords : (N, D+1) int32  -- [b, z, y, x] (3D) or [b, u, v] (2D); padded
                                rows are -1
    mask   : (N,)    bool    -- row validity

Rows are sorted by the linearized int32 voxel key (batch-major, then the
``key_order`` axes) with invalid rows keyed to INVALID_KEY so they sort last.
Neighbor lookup is a binary search over the sorted keys. Coords, keys,
masks, neighbor maps and band plans are bit-equal to the JAX package; keys
stay int32 throughout (a widening to int64 would change every key).
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils import trace

INVALID_KEY = 2 ** 31 - 1
# rows each capacity cap was asked to hold: (site, capacity, rows) appended
# by ``voxelize`` and ``downsample_coords`` while it is a list (a host
# sync per cap; None, the default, records nothing). rows > capacity means
# the cap dropped rows.
CAP_LOG = None
ROW_VALID_BIT = 30           # bit of valid_bits marking "output row valid"

# Which branch each conv took, counted per conv call ('band', 'nmap_slow',
# 'band_train', 'band_train_nmap', 'nmap' for an eval context on the
# neighbor map, and 'nmap_train' for every training conv on the neighbor
# map); read by chip_smoke.py (a slow branch on the main path is a
# performance fault).
branch_counts = collections.Counter()


def env_flag(name: str, default: str) -> bool:
    """A switch of the JAX package's environment: off for '0', 'false' or
    'False', on for any other value; ``default`` when unset."""
    return os.environ.get(name, default) not in ('0', 'false', 'False')


def band_enabled() -> bool:
    """``VIRCONV_BAND`` (default on): the eval sparse convs run on the band
    kernel (K1); ``0`` puts every eval conv on the neighbor map
    (``nmap_conv``) and takes training's 3D convs off the band path too.
    The JAX package turns it on only on a TPU; the card is the port's
    accelerator, so the port's default is on, on every device. Read while
    a forward builds its conv contexts."""
    return env_flag('VIRCONV_BAND', '1')


def band_train_enabled() -> bool:
    """``VIRCONV_BAND_TRAIN`` (default on, on every device, as
    ``band_enabled``): training 3D submanifold convs run the differentiable
    band conv (K1 + K4) when ``band_enabled()`` too; ``0`` puts them on
    the neighbor-map conv with its gather-only backward."""
    return env_flag('VIRCONV_BAND_TRAIN', '1')


def band2d_enabled() -> bool:
    """``VIRCONV_BAND2D`` (default on): the NRConv image-plane 2D eval convs
    sort, run K1 with first-wins sources and un-sort; ``0`` runs them on
    the neighbor map of the unsorted tensor."""
    return env_flag('VIRCONV_BAND2D', '1')


def dense2d_enabled() -> bool:
    """``VIRCONV_DENSE2D`` (default off): the NRConv image-plane 2D eval
    convs run as two dense 3x3 convs over the image grid; it takes
    precedence over ``band2d_enabled``."""
    return env_flag('VIRCONV_DENSE2D', '0')


def band_train_bf16_enabled() -> bool:
    """``VIRCONV_BAND_TRAIN_BF16`` (default off): the training band conv
    (K1 forward and input gradient, K4) takes bf16 operands with f32
    sums; its gather-patch terms stay f32. Read when a training conv
    context is built."""
    return env_flag('VIRCONV_BAND_TRAIN_BF16', '0')


def feats_bf16_enabled() -> bool:
    """``VIRCONV_BF16_FEATS`` (default off): the eval band convs store their
    (N, C') rows as bf16 (sums and epilogue f32), so the next layer reads
    bf16 rows. Read when an eval conv context is built."""
    return env_flag('VIRCONV_BF16_FEATS', '0')


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


def dedup_sorted(st: SparseTensor) -> SparseTensor:
    """Drop duplicate-key rows of an already-sorted tensor (keep first)."""
    keys = st.keys()
    is_first = torch.ones_like(keys, dtype=torch.bool)
    is_first[1:] = keys[1:] != keys[:-1]
    new_mask = st.mask & is_first
    return st.replace(mask=new_mask,
                      coords=torch.where(new_mask[:, None], st.coords,
                                         torch.full_like(st.coords, -1)),
                      feats=torch.where(new_mask[:, None], st.feats,
                                        torch.zeros_like(st.feats)))


def compact_sorted(st: SparseTensor, capacity: int) -> SparseTensor:
    """Re-sort (invalid rows last) and truncate or pad to ``capacity``."""
    st = sort_by_key(st)
    n = st.capacity
    if capacity <= n:
        return st.replace(feats=st.feats[:capacity],
                          coords=st.coords[:capacity],
                          mask=st.mask[:capacity])
    pad = capacity - n
    return st.replace(
        feats=torch.nn.functional.pad(st.feats, (0, 0, 0, pad)),
        coords=torch.nn.functional.pad(st.coords, (0, 0, 0, pad), value=-1),
        mask=torch.nn.functional.pad(st.mask, (0, pad)))


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
    out = None
    for j in range(neighbor_map.shape[1]):
        contrib = _gather(feats, neighbor_map[:, j]).float() \
            @ weights[j].float()
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
    gradient ``nmap_conv_dw`` (CUDA kernels on the card, their plain
    versions on the CPU)."""

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
                        out_mask, in_mask):
    """Differentiable neighbor-map conv (see ``_GatheredConvTrain``).
    ``transpose_map`` (N_in, K): the output row whose tap k reads each
    input row, -1 if none. Counted as ``branch_counts['nmap_train']``."""
    branch_counts['nmap_train'] += 1
    return _GatheredConvTrain.apply(feats, weights, neighbor_map,
                                    transpose_map, out_mask, in_mask)


def downsample_coords(st: SparseTensor, stride, padding, kernel_size,
                      out_capacity: int) -> SparseTensor:
    """Output sites of a strided sparse conv (spconv SparseConv3d rule),
    sorted by key and compacted to ``out_capacity``. Feats are a (cap, 1)
    zero placeholder."""
    with trace.span('sparse_plan'):
        ndim = st.ndim
        stride = _triple(stride, ndim)
        padding = _triple(padding, ndim)
        kernel_size = _triple(kernel_size, ndim)
        out_shape = tuple(
            (st.spatial_shape[i] + 2 * padding[i] - kernel_size[i])
            // stride[i] + 1 for i in range(ndim))
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
        if CAP_LOG is not None:
            CAP_LOG.append(('downsample', out_capacity,
                            int((out_keys != INVALID_KEY).sum())))
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
    with trace.span('sparse_plan'):
        nmap = build_subm_neighbor_map(st, kernel_size)
        tmap = nmap.flip(1)
        return lambda feats, weights: gathered_conv_train(
            feats, weights, nmap, tmap, st.mask, st.mask)


def nmap_strided_conv_ctx(st_in, st_out, stride, padding, kernel_size):
    """Training conv function ``conv(feats, weights)`` of a strided conv on
    the neighbor map, with the transpose map for its backward."""
    with trace.span('sparse_plan'):
        nmap = build_strided_neighbor_map(st_in, st_out, stride, padding,
                                          kernel_size)
        tmap = build_strided_transpose_map(st_in, st_out, stride, padding,
                                           kernel_size)
        return lambda feats, weights: gathered_conv_train(
            feats, weights, nmap, tmap, st_out.mask, st_in.mask)


# --------------------------------------------------------------------------
# Band-window conv plans (ops/band_conv.py), shared by every layer on one
# key set.
# --------------------------------------------------------------------------

def _band_geometry(spatial_shape, offsets_np):
    """Static (deltas, group_of) for taps given in coordinate offsets."""
    strides, _ = key_strides(spatial_shape)
    deltas = tuple(int(v) for v in (offsets_np * np.asarray(strides)).sum(1))
    major = key_order(len(spatial_shape))[0]
    vals = sorted(set(int(v) for v in offsets_np[:, major]))
    group_of = tuple(vals.index(int(v)) for v in offsets_np[:, major])
    return deltas, group_of


def halo_keys(coords, spatial_shape, batch_size, mask):
    """Keys in a +1-halo key space (every axis grown by 2, coords shifted by
    +1): out-of-bounds taps then miss instead of aliasing a real voxel."""
    ss_h = tuple(int(s) + 2 for s in spatial_shape)
    strides, m = key_strides(ss_h)
    if batch_size * m >= 2 ** 31:
        raise ValueError(f'halo key space {batch_size * m} overflows int32')
    key = coords[:, 0] * m
    for i, s in enumerate(strides):
        key = key + (coords[:, i + 1] + 1) * s
    return torch.where(mask, key.to(torch.int32), _full_like_invalid(key))


def subm_band_plan(st: SparseTensor, kernel_size, tile=128, block=256):
    """Band-conv plan for a submanifold conv on ``st`` (sorted by key)."""
    from .band_conv import band_plan
    kernel_size = _triple(kernel_size, st.ndim)
    if not all(k <= 3 for k in kernel_size):
        raise ValueError(f'halo keys de-alias offsets of at most 1: '
                         f'{kernel_size}')
    offsets_np = _kernel_offsets(kernel_size)
    ss_h = tuple(int(s) + 2 for s in st.spatial_shape)
    deltas, group_of = _band_geometry(ss_h, offsets_np)
    keys = halo_keys(st.coords, st.spatial_shape, st.batch_size, st.mask)
    base = torch.where(st.mask, keys, torch.zeros_like(keys))
    k = offsets_np.shape[0]
    mask_i = st.mask.to(torch.int32)
    bits = (mask_i * ((1 << k) - 1)) | (mask_i << ROW_VALID_BIT)
    return band_plan(keys, base, bits, deltas, group_of, tile, block), keys


def strided_band_plan(st_in, st_out, stride, padding, kernel_size,
                      tile=128, block=512):
    """Band-conv plan for a strided conv st_in -> st_out (both sorted)."""
    from .band_conv import band_plan
    ndim = st_in.ndim
    stride = _triple(stride, ndim)
    padding = _triple(padding, ndim)
    kernel_size = _triple(kernel_size, ndim)
    offsets_np = _kernel_offsets(kernel_size, centered=False)
    if not all(p <= 1 for p in padding):
        raise ValueError(f'halo keys need padding <= 1: {padding}')
    ss_h = tuple(int(s) + 2 for s in st_in.spatial_shape)
    deltas, group_of = _band_geometry(ss_h, offsets_np)
    strides_h, m = key_strides(ss_h)
    base = st_out.coords[:, 0] * m
    for i, s in enumerate(strides_h):
        base = base + (st_out.coords[:, i + 1] * stride[i] - padding[i]
                       + 1) * s
    base = torch.where(st_out.mask, base.to(torch.int32),
                       torch.zeros_like(base, dtype=torch.int32))
    keys_in = halo_keys(st_in.coords, st_in.spatial_shape,
                        st_in.batch_size, st_in.mask)
    k = offsets_np.shape[0]
    mask_i = st_out.mask.to(torch.int32)
    bits = (mask_i * ((1 << k) - 1)) | (mask_i << ROW_VALID_BIT)
    return (band_plan(keys_in, base, bits, deltas, group_of, tile, block),
            keys_in)


def _epilogue(out, mask, scale, bias, relu):
    if scale is not None:
        out = out * scale + bias
    if relu:
        out = torch.relu(out)
    if scale is not None and mask is not None:   # bias may un-zero them
        out = torch.where(mask[:, None], out, torch.zeros_like(out))
    return out


def _band_patch(plan, lookup_fn, first_index=None, patch_cap=None):
    """Gather patch for rows of non-fitting band tiles: (idx, valid, pnmap,
    cnt, cap) -- up to ``cap`` row indices, their validity, a (cap, K)
    neighbor map, the true bad-row count and the cap. ``patch_cap`` None
    sizes the patch to the bad rows (every entry valid); a number caps it
    there, as the JAX package's static patch does."""
    n_out = plan.n_out
    k = len(plan.deltas)
    dev = plan.base_keys.device
    flat_base = plan.base_keys.reshape(-1)[:n_out]
    flat_bits = plan.valid_bits.reshape(-1)[:n_out]
    row_ok = ((flat_bits >> ROW_VALID_BIT) & 1) == 1
    bad = (~plan.fits).repeat_interleave(plan.tile)[:n_out] & row_ok
    cnt = bad.sum()
    cap = int(cnt) if patch_cap is None else min(patch_cap, n_out)
    sel = bad.to(torch.int32) * (n_out + 1) - torch.arange(
        n_out, dtype=torch.int32, device=dev)
    idx = torch.topk(sel, cap).indices          # distinct values: exact order
    valid = bad[idx]
    deltas = torch.as_tensor(plan.deltas, dtype=torch.int32, device=dev)
    tap_ok = ((flat_bits[idx][:, None] >> torch.arange(
        k, dtype=torch.int32, device=dev)) & 1) == 1
    nkey = flat_base[idx][:, None] + deltas[None]
    nkey = torch.where(tap_ok & valid[:, None], nkey,
                       _full_like_invalid(nkey))
    pnmap = lookup_fn(nkey.reshape(-1)).reshape(cap, k)
    if first_index is not None:
        pnmap = torch.where(pnmap >= 0, first_index[pnmap.clamp(min=0)],
                            pnmap)
    return idx, valid, pnmap, cnt, cap


def _sized_patch(plan, lookup_fn, first_index=None):
    """``(idx, nmap)`` of every row of the plan's non-fitting tiles, or
    None when every tile fits. The JAX package caps its patch (a static
    shape) and sends a context that overflows the cap to the full
    neighbor map; the port's shapes are dynamic, so its patch holds every
    such row and the band kernel runs on every context with sorted keys
    (the same values)."""
    idx, _, pnmap, _, cap = _band_patch(plan, lookup_fn, first_index)
    return (idx, pnmap) if cap else None


def _band_ctx(plan, keys, out_mask, slow_nmap, bf16, src_sel=None,
              first_index=None):
    """The conv function of one (key set, geometry) context, shared by the
    layers on it: ``conv(feats (N_in, C), weights (K, C, C'), scale=None,
    bias=None, relu=False) -> (N_out, C')`` with the affine + ReLU epilogue
    fused and invalid output rows zero. The rows are bf16 when
    ``feats_bf16_enabled()`` at the context's build, else f32; feats may be
    either.

    It runs the band-window kernel plus an exact gather patch for the rows
    of tiles whose window does not fit, in one ``band_conv`` call. If the
    keys are unsorted every conv of the context takes the exact conv over
    the full neighbor map instead."""
    fast_ok = bool(plan.keys_sorted)
    patch = _sized_patch(plan, lambda qk: lookup(keys, qk),
                         first_index) if fast_ok else None
    slow_map = [None]
    out_dtype = torch.bfloat16 if feats_bf16_enabled() else torch.float32

    def conv(feats, weights, scale=None, bias=None, relu=False):
        from .band_conv import band_conv
        from .nmap_conv import nmap_conv
        src = feats if src_sel is None else torch.where(
            src_sel, feats, torch.zeros_like(feats))
        if fast_ok:
            branch_counts['band'] += 1
            return band_conv(src, keys, plan, weights, scale, bias, relu,
                             bf16, patch, out_dtype)
        branch_counts['nmap_slow'] += 1
        if slow_map[0] is None:
            slow_map[0] = slow_nmap()
        out = nmap_conv(src, slow_map[0], weights)
        return _epilogue(out * out_mask[:, None].to(out.dtype), out_mask,
                         scale, bias, relu).to(out_dtype)
    return conv


class _BandTrain(torch.autograd.Function):
    """Exact submanifold band conv (K1 + gather patch), f32 out, with the
    backward of the JAX package's ``_band_train``: the input gradient is the
    same conv with tap-reversed, transposed weights ``W_T[k] = W[K-1-k]^T``
    (offset_{K-1-k} == -offset_k, so plan, windows and patch are reused as
    they are); the weight gradient is K4 over the rows of fitting tiles
    (``bits_dw``) plus the patch rows' exact contribution
    (``nmap_conv_dw`` over the patch map). ``bf16``: bf16
    operands in K1 (forward and input gradient) and K4; the patch terms
    keep f32 operands, as in the JAX package."""

    @staticmethod
    def forward(ctx, feats, weights, keys, plan, bits_dw, patch, bf16):
        from .band_conv import band_conv
        ctx.save_for_backward(feats, weights)
        ctx.rest = keys, plan, bits_dw, patch, bf16
        return band_conv(feats, keys, plan, weights, bf16=bf16, patch=patch)

    @staticmethod
    def backward(ctx, g):
        from .band_conv import band_conv, band_conv_dw
        from .nmap_conv import nmap_conv_dw
        feats, weights = ctx.saved_tensors
        keys, plan, bits_dw, patch, bf16 = ctx.rest
        g = g.contiguous()
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            wt = weights.flip(0).transpose(1, 2).contiguous()
            dfeats = band_conv(g, keys, plan, wt, bf16=bf16, patch=patch)
        if ctx.needs_input_grad[1]:
            dw = band_conv_dw(feats, keys, plan, g, valid_bits=bits_dw,
                              bf16=bf16)
            if patch is not None:
                pidx, pnmap = patch
                dw = dw + nmap_conv_dw(feats, pnmap, g[pidx])
        return dfeats, dw, None, None, None, None, None


def _subm_conv_train_ctx(st, kernel_size, tile, block, bf16):
    """Training conv function ``conv(feats, weights)`` of a 3D submanifold
    conv: ``_BandTrain`` (its patch holds every row of the non-fitting
    tiles) when the plan's keys are sorted, else the neighbor-map conv.
    The band conv takes bf16 operands when ``bf16`` and
    ``band_train_bf16_enabled()`` at the context's build, as the JAX
    package's ``_BandStatics``.

    StVD leaves its dropped rows (INVALID keys) between valid ones; such a
    tensor is convolved in key order and its rows are put back, so the
    band kernels run where the JAX package's ctx would fall back to the
    neighbor map (same values)."""
    with trace.span('sparse_plan'):
        keys = st.keys()
        if not bool((keys[1:] >= keys[:-1]).all()):
            st_s, perm = sort_by_key_with_perm(st)
            inv = torch.argsort(perm)
            conv_s = _subm_conv_train_ctx(st_s, kernel_size, tile, block, bf16)
            return lambda feats, weights: conv_s(feats[perm], weights)[inv]
        plan, keys = subm_band_plan(st, kernel_size, tile, block)
        fast_ok = bool(plan.keys_sorted)
        patch = _sized_patch(plan, lambda qk: lookup(keys, qk)) if fast_ok \
            else None
        bits_dw = torch.where(plan.fits[:, None], plan.valid_bits,
                              torch.zeros_like(plan.valid_bits))
        slow = [None]
        op_bf16 = bool(bf16) and band_train_bf16_enabled()

        def conv(feats, weights):
            if fast_ok:
                branch_counts['band_train'] += 1
                return _BandTrain.apply(feats, weights, keys, plan, bits_dw,
                                        patch, op_bf16)
            branch_counts['band_train_nmap'] += 1
            if slow[0] is None:
                slow[0] = nmap_subm_conv_ctx(st, kernel_size)
            return slow[0](feats, weights)
        return conv


def _nmap_ctx(nmap, out_mask):
    """Eval conv function of a context on the neighbor map ``nmap``: the
    exact conv (``nmap_conv``) on f32 operands, then the epilogue on f32
    rows, as the JAX package's 'nmap' context (which has no bf16 mode)."""
    def conv(feats, weights, scale=None, bias=None, relu=False):
        from .nmap_conv import nmap_conv
        branch_counts['nmap'] += 1
        out = nmap_conv(feats, nmap, weights)
        return _epilogue(out * out_mask[:, None].to(out.dtype), out_mask,
                         scale, bias, relu)
    return conv


def subm_conv_ctx(st: SparseTensor, kernel_size, tile: int = 128,
                  block: int = 256, first_wins_sources: bool = False,
                  bf16: bool = True, train: bool = False,
                  use_band: bool = True):
    """Conv function of a submanifold conv on ``st`` (sorted by key): eval
    (see ``_band_ctx``), or with ``train`` the differentiable band conv
    ``conv(feats, weights)`` with f32 rows (``_subm_conv_train_ctx``).
    With ``use_band`` False, the neighbor-map conv on ``st`` in any row
    order: at eval ``_nmap_ctx``, in training ``nmap_subm_conv_ctx``.

    ``first_wins_sources`` (eval band only): for key sets with duplicates
    (the NRConv 2D image-plane tensor) all but the first row of each key
    are zeroed as sources, so the kernel's lower-bound search and the
    patch agree on one representative per key."""
    with trace.span('sparse_plan'):
        kernel_size = _triple(kernel_size, st.ndim)
        if not use_band:
            if train:
                return nmap_subm_conv_ctx(st, kernel_size)
            return _nmap_ctx(build_subm_neighbor_map(st, kernel_size), st.mask)
        if train:
            if first_wins_sources:
                raise ValueError('the band training conv takes no '
                                 'duplicate-key sources')
            return _subm_conv_train_ctx(st, kernel_size, tile, block, bf16)
        plan, keys = subm_band_plan(st, kernel_size, tile, block)
        src_sel = first_index = None
        if first_wins_sources:
            is_first = torch.ones_like(keys, dtype=torch.bool)
            is_first[1:] = keys[1:] != keys[:-1]
            src_sel = (st.mask & is_first)[:, None]
            ar = torch.arange(keys.shape[0], dtype=torch.int32,
                              device=keys.device)
            first_index = torch.cummax(
                torch.where(is_first, ar, torch.zeros_like(ar)), 0).values
        return _band_ctx(plan, keys, st.mask,
                         lambda: build_subm_neighbor_map(st, kernel_size),
                         bf16, src_sel=src_sel, first_index=first_index)


def strided_conv_ctx(st_in, st_out, stride, padding, kernel_size,
                     tile: int = 128, block: int = 512, bf16: bool = True,
                     use_band: bool = True):
    """Eval conv function (see ``_band_ctx``) of a strided conv
    st_in -> st_out (both sorted); with ``use_band`` False, on the
    neighbor map (``_nmap_ctx``)."""
    with trace.span('sparse_plan'):
        kernel_size = _triple(kernel_size, st_in.ndim)
        if not use_band:
            return _nmap_ctx(build_strided_neighbor_map(
                st_in, st_out, stride, padding, kernel_size), st_out.mask)
        plan, keys = strided_band_plan(st_in, st_out, stride, padding,
                                       kernel_size, tile, block)
        return _band_ctx(
            plan, keys, st_out.mask,
            lambda: build_strided_neighbor_map(st_in, st_out, stride, padding,
                                               kernel_size),
            bf16)


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
    if CAP_LOG is not None:
        CAP_LOG.append(('voxelize', max_voxels, int(is_first.sum())))
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
