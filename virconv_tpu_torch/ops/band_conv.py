"""Band-window sparse convolution: plan, plain PyTorch versions and the CUDA
kernel wrappers of the forward (K1) and the weight gradient (K4).

Replaces ``virconv_tpu/ops/pallas/band_conv.py::_kernel`` (driver
``band_conv``). Rows are sorted by the (b, y, x, z) key, so the neighbors of
one T-row output tile under each dy "group" of taps lie in one narrow key
band. ``band_plan`` picks, per (tile, group), a window of two BLOCK-row
blocks (``blk``) and flags the tiles whose window covers the band
(``fits``). The output of a tile is exact iff it fits; callers patch the
rows of the other tiles (ops/sparse.py).

Contract of one tap k of output row r in tile t: the source is the
lower-bound row of key ``base_keys[r] + deltas[k]`` inside the window
``[blk[t, group_of[k]] * BLOCK, +2 * BLOCK)`` if tap bit k of
``valid_bits[r]`` is set and the key is there, else none. Lower bound lands
on the first row of a duplicate-key run, which is the NRConv 2D first-wins
source (callers zero the other rows of a run, as the JAX package does).
``out = epilogue(sum_k feats[src_k] @ W[k])`` with epilogue = affine, ReLU,
times row-valid bit. ``bf16`` rounds feats and W to bf16 before the f32
multiply-add, as the TPU kernel's bf16 operands do. ``feats`` may be f32 or
bf16 (a bf16 row widens to f32 exactly); the sums and the epilogue are
f32, and the stored rows are ``out_dtype`` (f32 or bf16, rounded to nearest
even), the TPU kernel's ``out_dtype``.

``patch = (pidx, pnmap)`` (``ops/sparse._sized_patch``: every valid row of
the non-fitting tiles and their neighbor map) replaces rows ``pidx`` with the
exact conv over ``pnmap`` in f32 operands (``nmap_conv``) through the same
affine and ReLU; on the card it runs inside the band conv's call.

The weight gradient (``band_conv_dw``, replacing ``_dw_kernel``) uses the
same sources: ``dW[k] = sum over rows r with a tap-k source s of
feats[s]^T (g[r] * row_valid[r])``, with an optional ``valid_bits``
override (callers zero the rows of non-fitting tiles and add those rows'
exact contribution from the gather patch).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

from .sparse import INVALID_KEY, ROW_VALID_BIT, _epilogue

# kernel launches (CUDA tensors only) of K1, of the gather patch that K1's
# call runs beside it, and of K4, reset and read by chip_smoke.py
launches = 0
patch_launches = 0
dw_launches = 0


class BandPlan(NamedTuple):
    """Per-scale conv plan, reusable by every layer sharing a key set."""
    base_keys: torch.Tensor    # (n_tiles, T) int32 query-origin keys
    valid_bits: torch.Tensor   # (n_tiles, T) int32 tap bits + row bit 30
    blk: torch.Tensor          # (n_tiles, G) int32 window start block
    span_ok: torch.Tensor      # () bool: every tile fits
    fits: torch.Tensor         # (n_tiles,) bool
    keys_sorted: torch.Tensor  # () bool: keys ascending, INVALID tail
    deltas: Tuple[int, ...]
    group_of: Tuple[int, ...]
    n_out: int
    tile: int
    block: int


def band_plan(keys, base_keys, valid_bits, deltas: Sequence[int],
              group_of: Sequence[int], tile: int = 128,
              block: int = 256) -> BandPlan:
    """Window table for one (key set, kernel geometry) pair; bit-equal to
    ``virconv_tpu.ops.pallas.band_conv.band_plan``."""
    deltas = tuple(int(d) for d in deltas)
    group_of = tuple(int(g) for g in group_of)
    n_groups = max(group_of) + 1
    dev = keys.device
    n_out = base_keys.shape[0]
    pad_out = (-n_out) % tile
    bq = torch.nn.functional.pad(base_keys, (0, pad_out))
    vb = torch.nn.functional.pad(valid_bits, (0, pad_out))
    n_tiles = bq.shape[0] // tile
    bq_t = bq.reshape(n_tiles, tile)
    vb_t = vb.reshape(n_tiles, tile)

    row_ok = ((vb_t >> ROW_VALID_BIT) & 1) == 1
    big = 2 ** 30
    bmin = torch.where(row_ok, bq_t, torch.full_like(bq_t, big)).amin(1)
    bmax = torch.where(row_ok, bq_t, torch.full_like(bq_t, -big)).amax(1)
    any_valid = row_ok.any(1)
    bmin = torch.where(any_valid, bmin, torch.zeros_like(bmin))
    bmax = torch.where(any_valid, bmax, torch.zeros_like(bmax))

    n_in = keys.shape[0]
    n_blocks = -(-n_in // block) + 1
    lo_q = torch.stack([bmin + min(d for d, g in zip(deltas, group_of)
                                   if g == gi)
                        for gi in range(n_groups)], 1)
    hi_q = torch.stack([bmax + max(d for d, g in zip(deltas, group_of)
                                   if g == gi)
                        for gi in range(n_groups)], 1)
    jb = torch.arange(1, n_blocks - 1, dtype=torch.int64,
                      device=dev) * block - 1
    sb = keys[torch.clamp(jb, max=n_in - 1)]
    blk = (sb[None, :] < lo_q.reshape(-1, 1)).sum(1).to(torch.int32)
    blk = torch.clamp(blk.reshape(n_tiles, n_groups), 0, n_blocks - 2)
    e = (blk.long() + 2) * block
    fits_g = (e >= n_in) | (keys[torch.clamp(e, max=n_in - 1)] > hi_q)
    fits = torch.where(any_valid[:, None], fits_g,
                       torch.ones_like(fits_g)).all(1)
    keys_sorted = (keys[1:] >= keys[:-1]).all()
    fits = fits & keys_sorted
    return BandPlan(bq_t, vb_t, blk, fits.all(), fits, keys_sorted, deltas,
                    group_of, n_out, tile, block)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tap_sources(keys, plan: BandPlan, valid_bits, n_in):
    """Per tap: (src, hit) over the n_tiles * tile plan rows -- the
    lower-bound row of the tap's key in the tile's window, and whether the
    tap bit is set and the key is there."""
    tile, block = plan.tile, plan.block
    n_tiles = plan.base_keys.shape[0]
    keys_p = torch.cat([keys, torch.full((block,), INVALID_KEY,
                                         dtype=torch.int32,
                                         device=keys.device)]).long()
    q = plan.base_keys.long()
    bits = valid_bits.reshape(-1)
    for t, (d, g) in enumerate(zip(plan.deltas, plan.group_of)):
        qk = (q + d).reshape(-1)
        ws = (plan.blk[:, g].long() * block)[:, None].expand(
            n_tiles, tile).reshape(-1)
        we = torch.clamp(ws + 2 * block, max=n_in)
        pos = torch.minimum(torch.maximum(torch.searchsorted(keys_p, qk),
                                          ws), we)
        hit = (((bits >> t) & 1) == 1) & (pos < we) & (keys_p[pos] == qk)
        yield torch.where(hit, pos, torch.zeros_like(pos)), hit


def band_conv_plain(feats, keys, plan: BandPlan, weights, scale=None,
                    bias=None, relu=False, bf16=True, patch=None,
                    out_dtype=torch.float32):
    """Plain PyTorch version of the kernel contract (module docstring),
    the patch applied after it as ``nmap_conv_plain``, ``_epilogue`` and
    an index put, all in f32; the rows are cast to ``out_dtype`` last."""
    f = feats.float()
    w = weights.float()
    if bf16:
        f, w = _bf16(f), _bf16(w)
    row_ok = ((plan.valid_bits >> ROW_VALID_BIT) & 1).float()
    out = torch.zeros((plan.base_keys.numel(), w.shape[2]),
                      dtype=torch.float32, device=feats.device)
    for t, (src, hit) in enumerate(_tap_sources(keys, plan, plan.valid_bits,
                                                feats.shape[0])):
        out += (f[src] * hit[:, None].float()) @ w[t]
    if scale is not None:
        out = out * scale + bias
    if relu:
        out = torch.relu(out)
    out = out * row_ok.reshape(-1, 1)
    out = out[:plan.n_out]
    if patch is not None:
        from .nmap_conv import nmap_conv_plain
        pidx, pnmap = patch
        out[pidx] = _epilogue(nmap_conv_plain(feats, pnmap, weights), None,
                              scale, bias, relu)
    return out.to(out_dtype)


def band_conv_dw_plain(feats, keys, plan: BandPlan, g, valid_bits=None,
                       bf16=True):
    """Plain PyTorch version of the weight-gradient contract: (K, C, C')
    f32 (module docstring)."""
    vb = plan.valid_bits if valid_bits is None else valid_bits
    f = feats.float()
    n_rows = plan.base_keys.numel()
    row_ok = ((vb.reshape(-1) >> ROW_VALID_BIT) & 1).float()
    gp = torch.zeros((n_rows, g.shape[1]), dtype=torch.float32,
                     device=g.device)
    gp[:plan.n_out] = g.float()
    gp = gp * row_ok[:, None]
    if bf16:
        f, gp = _bf16(f), _bf16(gp)
    return torch.stack([(f[src] * hit[:, None].float()).T @ gp
                        for src, hit in _tap_sources(keys, plan, vb,
                                                     feats.shape[0])])


def band_conv(feats, keys, plan: BandPlan, weights, scale=None, bias=None,
              relu: bool = False, bf16: bool = True, patch=None,
              out_dtype=torch.float32):
    """One sparse conv through the band window, with the gather ``patch``
    ``(pidx, pnmap)`` of its non-fitting rows when given: the CUDA kernels
    for CUDA tensors, the plain version for CPU tensors. ``feats`` f32 or
    bf16; returns (N_out, C') ``out_dtype`` (f32 or bf16)."""
    if not feats.is_cuda:
        return band_conv_plain(feats, keys, plan, weights, scale, bias,
                               relu, bf16, patch, out_dtype)
    return _band_conv_cuda(feats, keys, plan, weights, scale, bias, relu,
                           bf16, patch, out_dtype)


def band_conv_dw(feats, keys, plan: BandPlan, g, valid_bits=None,
                 bf16: bool = True):
    """Weight gradient of a band conv, (K, C, C') f32: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if not feats.is_cuda:
        return band_conv_dw_plain(feats, keys, plan, g, valid_bits, bf16)
    return _band_conv_dw_cuda(feats, keys, plan, g, valid_bits, bf16)


# CUDA kernel limits (csrc/band_conv.cu): K1's tile mode stages 2 * block
# keys per tap group and up to MAX_CIN input channels per row in shared
# memory; K4's source pass does the same with a CTA per tile of at most
# DW_MAX_TILE rows, and a K4 CTA lists the hit rows of its chunk (at most
# DW_MAX_CHUNK rows) in shared memory and owns at most DW_MAX_SLAB output
# channels.
MAX_TAPS, MAX_CIN, MAX_GROUPS, MAX_BLOCK = 30, 128, 3, 2048
DW_MAX_TILE, DW_MAX_CHUNK, DW_MAX_SLAB = 256, 2048, 64
# K4 CTAs a call aims at: three waves of two per SM of an H100 (132 SMs).
# Taps hit unevenly (the centre tap every row); smaller chunks even the
# waves out.
DW_TARGET_CTAS = 6 * 132


def dw_tiles_per_chunk(n_tiles: int, tile: int, n_taps: int,
                       c_out: int) -> int:
    """Plan tiles per K4 chunk: enough chunks that the (chunk, tap, output
    slab) grid holds about DW_TARGET_CTAS CTAs, each chunk at most
    DW_MAX_CHUNK rows."""
    slabs = -(-c_out // DW_MAX_SLAB)
    chunks = -(-DW_TARGET_CTAS // (n_taps * slabs))
    return max(1, min(-(-n_tiles // chunks), DW_MAX_CHUNK // tile))


_geometry_cache = {}


def _geometry(plan, dev):
    key = (plan.deltas, plan.group_of, str(dev))
    g = _geometry_cache.get(key)
    if g is None:
        g = torch.tensor(list(plan.deltas) + list(plan.group_of),
                         dtype=torch.int32, device=dev)
        _geometry_cache[key] = g
    return g


FEATURE_DTYPES = (torch.float32, torch.bfloat16)


def _band_conv_cuda(feats, keys, plan, weights, scale, bias, relu, bf16,
                    patch=None, out_dtype=torch.float32):
    """Launch ``band_conv_fwd`` (csrc/band_conv.cu): a prep kernel lays the
    weights out (bf16: rounded; with a patch at bf16, an f32 copy too),
    then in tile mode one CTA per 64 rows of a
    plan tile and output-channel slab searches its sources in the tile's
    window keys staged in shared memory, gathers the hit rows tap by tap
    with cp.async into a ring of stages, and sums on the tensor cores
    (bf16, mma.sync) or in f32 on CUDA cores; in row mode (C <= 8, C' <= 16)
    a thread per row sums the rows its taps hit against weights resident
    in shared memory. With a patch, a launch before K1's gives its rows
    the exact conv with f32 operands on the same bodies, K1's epilogue
    fused into their store to ``out[pidx]``, and K1 runs beside it
    (programmatic dependent launch) on the tiles that fit. bf16 feature
    rows are widened to f32 as they are staged, and ``out_dtype`` bf16
    rounds each stored value (the bodies are templated on both types).

    Replaces virconv_tpu/ops/pallas/band_conv.py::_kernel (with its
    ``out_dtype``). Bound: at the main path's widths (C, C' <= 64) the work
    is 2*C*C' operations per (row, tap) hit against one gathered row of C
    values: bytes at the bf16 peak (serving; bf16 rows halve them),
    operations at the f32 peak (training). The row gather is a lower-bound
    binary search of the tile's 2-block window: no one-hot matmul, no
    neighbor map."""
    global launches, patch_launches
    from . import _cuda
    dev = feats.device
    n_in, c_in = feats.shape
    k, _, c_out = weights.shape
    if feats.dtype not in FEATURE_DTYPES or out_dtype not in FEATURE_DTYPES:
        raise ValueError(f'band_conv: feats {feats.dtype}, out_dtype '
                         f'{out_dtype}: the kernel takes f32 or bf16')
    _cuda.check_cuda_tensor(feats, 'feats', feats.dtype, 2)
    _cuda.check_cuda_tensor(keys, 'keys', torch.int32, 1, dev)
    _cuda.check_cuda_tensor(weights, 'weights', torch.float32, 3, dev)
    for name in ('base_keys', 'valid_bits', 'blk'):
        _cuda.check_cuda_tensor(getattr(plan, name), name, torch.int32, 2,
                                dev)
    if keys.shape[0] != n_in or weights.shape[1] != c_in \
            or k != len(plan.deltas):
        raise ValueError('band_conv: inconsistent feats/keys/weights/plan')
    n_groups = max(plan.group_of) + 1
    if (k > MAX_TAPS or c_in > MAX_CIN or n_groups > MAX_GROUPS
            or plan.block > MAX_BLOCK):
        raise ValueError(f'band_conv kernel limits: K={k} C={c_in} '
                         f'groups={n_groups} block={plan.block}')
    affine = scale is not None
    if affine:
        scale = scale.float().contiguous()
        bias = bias.float().contiguous()
        _cuda.check_cuda_tensor(scale, 'scale', torch.float32, 1, dev)
        _cuda.check_cuda_tensor(bias, 'bias', torch.float32, 1, dev)
    n_patch, pidx, pnmap = 0, None, None
    if patch is not None:
        pidx, pnmap = patch
        _cuda.check_cuda_tensor(pidx, 'pidx', torch.int64, 1, dev)
        _cuda.check_cuda_tensor(pnmap, 'pnmap', torch.int32, 2, dev)
        _cuda.check_cuda_tensor(plan.fits, 'fits', torch.bool, 1, dev)
        n_patch = pidx.shape[0]
        if tuple(pnmap.shape) != (n_patch, k) or n_patch > plan.n_out:
            raise ValueError(f'band_conv: patch of {n_patch} rows, map '
                             f'{tuple(pnmap.shape)}, for {plan.n_out} rows '
                             f'and {k} taps')
    n_tiles = plan.base_keys.shape[0]
    out = torch.empty((plan.n_out, c_out), dtype=out_dtype, device=dev)
    lib = _cuda.load('band_conv')
    wprep = torch.empty((lib.band_conv_fwd_scratch_bytes(
        c_in, c_out, k, int(bf16), int(n_patch > 0)),), dtype=torch.uint8,
        device=dev)
    null = ctypes.c_void_p(0)
    err = lib.band_conv_fwd(
        _cuda.ptr(feats), _cuda.ptr(keys), _cuda.ptr(plan.base_keys),
        _cuda.ptr(plan.valid_bits), _cuda.ptr(plan.blk), _cuda.ptr(weights),
        n_in, c_in, c_out, k, n_groups,
        _cuda.ptr(_geometry(plan, dev)),
        _cuda.ptr(scale) if affine else null,
        _cuda.ptr(bias) if affine else null,
        int(affine), int(relu), int(bf16), plan.tile, plan.block, n_tiles,
        plan.n_out, _cuda.ptr(plan.fits) if n_patch else null,
        _cuda.ptr(pidx) if n_patch else null,
        _cuda.ptr(pnmap) if n_patch else null, n_patch,
        int(feats.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        _cuda.ptr(wprep), _cuda.ptr(out), _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'band_conv_fwd launch failed: CUDA error {err}')
    launches += 1
    if n_patch and n_tiles:
        patch_launches += 1
    return out


def _band_conv_dw_cuda(feats, keys, plan, g, valid_bits, bf16):
    """Launch ``band_conv_dw`` (csrc/band_conv.cu): a source pass searches
    every (row, tap) source once in the tile's window keys staged in shared
    memory; then one CTA per (chunk of ``dw_tiles_per_chunk`` tiles, tap,
    output slab) lists its chunk's hit rows, gathers their feats and g rows
    with cp.async into a ring and sums the whole C x C' block in registers
    (8 x 8 or 4 x 4 per thread, fmaf on CUDA cores) into a partial; a third
    kernel adds the partials in chunk order.

    Replaces virconv_tpu/ops/pallas/band_conv.py::_dw_kernel, whose single
    resident (K*C, C') accumulator over a sequential grid has no
    counterpart across unordered CTAs. Bound: 2*C*C' operations per valid
    (row, tap) hit against one gathered feats row and one g row, at the
    f32 peak (the training path's operands)."""
    global dw_launches
    from . import _cuda
    dev = feats.device
    n_in, c_in = feats.shape
    k = len(plan.deltas)
    c_out = g.shape[1]
    vb = plan.valid_bits if valid_bits is None else valid_bits
    _cuda.check_cuda_tensor(feats, 'feats', torch.float32, 2)
    _cuda.check_cuda_tensor(keys, 'keys', torch.int32, 1, dev)
    _cuda.check_cuda_tensor(g, 'g', torch.float32, 2, dev)
    for name, t in (('base_keys', plan.base_keys), ('valid_bits', vb),
                    ('blk', plan.blk)):
        _cuda.check_cuda_tensor(t, name, torch.int32, 2, dev)
    if keys.shape[0] != n_in or g.shape[0] != plan.n_out \
            or vb.shape != plan.base_keys.shape:
        raise ValueError('band_conv_dw: inconsistent feats/keys/g/plan')
    n_groups = max(plan.group_of) + 1
    if (k > MAX_TAPS or c_in > MAX_CIN or n_groups > MAX_GROUPS
            or plan.block > MAX_BLOCK or plan.tile > DW_MAX_TILE):
        raise ValueError(f'band_conv_dw kernel limits: K={k} C={c_in} '
                         f'groups={n_groups} block={plan.block} '
                         f'tile={plan.tile}')
    n_tiles = plan.base_keys.shape[0]
    per_chunk = dw_tiles_per_chunk(n_tiles, plan.tile, k, c_out)
    lib = _cuda.load('band_conv')
    scratch = torch.empty((lib.band_conv_dw_scratch_bytes(
        k, c_in, c_out, n_tiles, plan.tile, per_chunk),), dtype=torch.uint8,
        device=dev)
    out = torch.empty((k, c_in, c_out), dtype=torch.float32, device=dev)
    err = lib.band_conv_dw(
        _cuda.ptr(feats), _cuda.ptr(keys), _cuda.ptr(plan.base_keys),
        _cuda.ptr(vb), _cuda.ptr(plan.blk), _cuda.ptr(g),
        n_in, c_in, c_out, k, n_groups, _cuda.ptr(_geometry(plan, dev)),
        int(bf16), plan.tile, plan.block, n_tiles, plan.n_out, per_chunk,
        _cuda.ptr(scratch), _cuda.ptr(out), _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'band_conv_dw launch failed: CUDA error {err}')
    dw_launches += 1
    return out
