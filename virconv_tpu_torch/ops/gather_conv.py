"""Windowed gather convolution from a neighbor map (K5): the entry
function, its plain PyTorch version and the CUDA kernel wrapper.

Replaces ``virconv_tpu/ops/pallas/gather_conv.py::_conv_kernel`` (entry
function ``fused_gather_conv``), with its contract: feats (N, C) f32,
nmap (N, K) int32 row indices (-1 = missing), weights (K, C, C').
``window = tile*(K-1)//2`` and ``span = tile*K``; row tile i reads the rows
``[base, base + span)`` with ``base = clip(i*tile - window, 0, N - span)``.
A neighbor counts when it is >= 0 and inside its tile's window; any other
valid index is a miss: it contributes zero and is counted in ``misses[i]``.
There is no output mask and no epilogue. Returns ((N, C') f32, misses
(N/tile,) int32). N must be a multiple of ``tile`` and at least ``tile*K``,
and ``tile*(K-1)`` even (the TPU kernel's window DMA needs all three).
"""

from __future__ import annotations

import collections

import torch

from .sparse import _gathered_conv_raw

# kernel launches (CUDA tensors only), in all and by mode, reset and read
# by chip_smoke.py
launches = 0
mode_launches = collections.Counter()

# CUDA kernel limits (csrc/gather_conv.cu, csrc/common.cuh): taps per conv;
# the tile mode stages rows of at most MAX_CIN input channels; the row
# mode takes at most ROW_MAX_CIN input and ROW_MAX_COUT output channels.
MAX_TAPS = 64
MAX_CIN, ROW_MAX_CIN, ROW_MAX_COUT = 128, 8, 16
MODES = {'fma': 0, 'tile': 1, 'row': 2}   # the kernel's mode numbers


def kernel_mode(c_in: int, c_out: int) -> str:
    """The kernel body K5 (and K6, for either operand type) runs for these
    widths: ``'row'`` (C <= ROW_MAX_CIN and C' <= ROW_MAX_COUT: a thread
    per row over its hit taps), ``'tile'`` (C <= MAX_CIN: 64-row CTAs with
    an output slab fitted to C') or ``'fma'`` (wider inputs: 64 rows x 64
    output channels per CTA)."""
    if c_in <= ROW_MAX_CIN and c_out <= ROW_MAX_COUT:
        return 'row'
    return 'tile' if c_in <= MAX_CIN else 'fma'


def _check(feats, nmap, weights, tile):
    n, c_in = feats.shape
    k = nmap.shape[1]
    if nmap.shape[0] != n or weights.shape[:2] != (k, c_in) or k < 1:
        raise ValueError(f'fused_gather_conv: feats {tuple(feats.shape)}, '
                         f'nmap {tuple(nmap.shape)}, weights '
                         f'{tuple(weights.shape)} disagree')
    if tile < 1 or n % tile:
        raise ValueError(f'fused_gather_conv: N={n} is not a multiple of '
                         f'tile={tile}')
    if (tile * (k - 1)) % 2:
        raise ValueError(f'fused_gather_conv: tile*(K-1)={tile * (k - 1)} '
                         'is odd')
    if n < tile * k:
        raise ValueError(f'fused_gather_conv: N={n} < tile*K={tile * k}')


def window_hits(nmap, tile):
    """(in_window (N, K) bool, misses (N/tile,) int32) of the contract."""
    n, k = nmap.shape
    n_tiles = n // tile
    window, span = tile * (k - 1) // 2, tile * k
    tiles = torch.arange(n_tiles, dtype=torch.int64, device=nmap.device)
    base = torch.clamp(tiles * tile - window, 0, n - span)
    nm = nmap.reshape(n_tiles, tile, k).long()
    local = nm - base[:, None, None]
    valid = nm >= 0
    inside = valid & (local >= 0) & (local < span)
    misses = (valid & ~inside).sum((1, 2)).to(torch.int32)
    return inside.reshape(n, k), misses


def fused_gather_conv_plain(feats, nmap, weights, tile: int = 512):
    """Plain PyTorch version of the contract (module docstring): the map
    with out-of-window entries set to -1 through the neighbor-map conv."""
    _check(feats, nmap, weights, tile)
    inside, misses = window_hits(nmap, tile)
    masked = torch.where(inside, nmap, torch.full_like(nmap, -1))
    return _gathered_conv_raw(feats.float(), masked, weights), misses


def fused_gather_conv(feats, nmap, weights, tile: int = 512):
    """Windowed gather conv: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns ((N, C') f32, misses (N/tile,))."""
    _check(feats, nmap, weights, tile)
    if not feats.is_cuda:
        return fused_gather_conv_plain(feats, nmap, weights, tile)
    return _fused_gather_conv_cuda(feats, nmap, weights, tile)


def _fused_gather_conv_cuda(feats, nmap, weights, tile):
    """Launch ``gather_conv_fwd`` (csrc/gather_conv.cu) in the mode
    ``kernel_mode`` picks.

    Replaces virconv_tpu/ops/pallas/gather_conv.py::_conv_kernel, whose
    per-tile VMEM window (3.5 MB at tile 512, K 27, C 64) has no shared-
    memory counterpart: the window decides only which neighbors count, and
    counted rows are gathered from global memory. Bound: 2*C*C' operations
    per in-window (row, tap) hit, at the f32 rate. The row and tile modes
    are K1's gathered-row conv on CUDA cores, its sources read from the
    map: a thread per row for C <= 8, C' <= 16, else 64-row CTAs with an
    output slab fitted to C', per-16-row-fragment tap skip and cp.async
    gathers of the hit rows into a ring beside W[k]."""
    global launches
    from . import _cuda
    dev = feats.device
    n, c_in = feats.shape
    k, _, c_out = weights.shape
    _cuda.check_cuda_tensor(feats, 'feats', torch.float32, 2)
    _cuda.check_cuda_tensor(nmap, 'nmap', torch.int32, 2, dev)
    _cuda.check_cuda_tensor(weights, 'weights', torch.float32, 3, dev)
    if k > MAX_TAPS or c_out < 1:
        raise ValueError(f'gather_conv kernel limits: K={k} C\'={c_out}')
    mode = kernel_mode(c_in, c_out)
    out = torch.empty((n, c_out), dtype=torch.float32, device=dev)
    misses = torch.zeros((n // tile,), dtype=torch.int32, device=dev)
    lib = _cuda.load('gather_conv')
    wprep = torch.empty((lib.gather_conv_scratch_bytes(
        c_in, c_out, k, MODES[mode]),), dtype=torch.uint8, device=dev)
    err = lib.gather_conv_fwd(
        _cuda.ptr(feats), _cuda.ptr(nmap), _cuda.ptr(weights), n, c_in,
        c_out, k, tile, MODES[mode], _cuda.ptr(wprep), _cuda.ptr(out),
        _cuda.ptr(misses), _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'gather_conv_fwd launch failed: CUDA error {err}')
    launches += 1
    mode_launches[mode] += 1
    return out, misses
