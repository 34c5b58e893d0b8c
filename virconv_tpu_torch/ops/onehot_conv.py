"""Gather convolution over per-(tile, tap) two-block windows (K6): the
entry function's index work, its plain PyTorch version and the CUDA kernel
wrapper.

Replaces ``virconv_tpu/ops/pallas/onehot_conv.py::_kernel`` (entry
function ``onehot_gather_conv``), with its contract: feats (N0, C),
nmap (N0, K) int32 row indices (-1 = missing), weights (K, C, C'), ``block``
a multiple of ``tile``. Rows are padded by ``(-N0) % block + block`` (zero
features, -1 map rows), so the padded count N is a multiple of ``block``
with at least one block past the data. Per (row tile, tap), ``lo`` is the
least valid index of the tile's column (0 if none), ``blk = clip(lo //
block, 0, N/block - 2)`` and the window is ``[blk*block, blk*block +
2*block)``. A neighbor counts when it is >= 0 and inside the window; any
other valid index is a miss, counted per tile of the padded rows. With
``bf16`` features and weights are rounded to bf16 and the products summed in
f32 (the TPU kernel's one-hot gather is exact). Returns ((N0, C') f32,
misses (N/tile,) int32).
"""

from __future__ import annotations

import collections

import torch

from . import gather_conv
from .gather_conv import MAX_TAPS, MODES
from .sparse import _gathered_conv_raw

# kernel launches (CUDA tensors only), in all and by mode and operand type
# ('row bf16', 'tile f32', ...), reset and read by chip_smoke.py
launches = 0
mode_launches = collections.Counter()


def kernel_mode(c_in: int, c_out: int, bf16: bool) -> str:
    """The kernel body K6 runs for these widths, with bf16 or f32 operands
    alike: K5's rule (``gather_conv.kernel_mode``), ``'row'`` for C <= 8
    and C' <= 16, ``'tile'`` for C <= 128 (bf16 on the tensor cores, f32
    on CUDA cores), else ``'fma'``."""
    del bf16   # both operand types take the same modes
    return gather_conv.kernel_mode(c_in, c_out)


def _check(feats, nmap, weights, tile, block):
    n0, c_in = feats.shape
    k = nmap.shape[1]
    if nmap.shape[0] != n0 or weights.shape[:2] != (k, c_in) or k < 1:
        raise ValueError(f'onehot_gather_conv: feats {tuple(feats.shape)}, '
                         f'nmap {tuple(nmap.shape)}, weights '
                         f'{tuple(weights.shape)} disagree')
    if tile < 1 or block % tile:
        raise ValueError(f'onehot_gather_conv: block={block} is not a '
                         f'multiple of tile={tile}')


def window_blocks(nmap, tile: int, block: int):
    """The entry function's index work: (blk (N/tile, K) int32 window start
    blocks, the padded map (N/tile, tile, K) int64)."""
    n0, k = nmap.shape
    pad = (-n0) % block + block
    n = n0 + pad
    nm = torch.nn.functional.pad(nmap, (0, 0, 0, pad), value=-1)
    nm = nm.reshape(n // tile, tile, k).long()
    big = 2 ** 30
    lo = torch.where(nm >= 0, nm, torch.full_like(nm, big)).amin(1)
    lo = torch.where(lo == big, torch.zeros_like(lo), lo)
    blk = torch.clamp(torch.div(lo, block, rounding_mode='floor'), 0,
                      n // block - 2)
    return blk.to(torch.int32), nm


def onehot_gather_conv_plain(feats, nmap, weights, tile: int = 256,
                             block: int = 2048, bf16: bool = True):
    """Plain PyTorch version of the contract (module docstring): the padded
    map with out-of-window entries set to -1 through the neighbor-map
    conv."""
    _check(feats, nmap, weights, tile, block)
    n0 = feats.shape[0]
    blk, nm = window_blocks(nmap, tile, block)
    local = nm - (blk.long() * block)[:, None, :]
    valid = nm >= 0
    inside = valid & (local >= 0) & (local < 2 * block)
    misses = (valid & ~inside).sum((1, 2)).to(torch.int32)
    masked = torch.where(inside, nm, torch.full_like(nm, -1)).reshape(
        -1, nm.shape[2])
    f = torch.nn.functional.pad(feats.float(),
                                (0, 0, 0, masked.shape[0] - n0))
    w = weights.float()
    if bf16:
        f = f.to(torch.bfloat16).float()
        w = w.to(torch.bfloat16).float()
    return _gathered_conv_raw(f, masked, w)[:n0], misses


def onehot_gather_conv(feats, nmap, weights, tile: int = 256,
                       block: int = 2048, bf16: bool = True):
    """Two-block windowed gather conv: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Returns ((N0, C') f32, misses)."""
    _check(feats, nmap, weights, tile, block)
    if not feats.is_cuda:
        return onehot_gather_conv_plain(feats, nmap, weights, tile, block,
                                        bf16)
    return _onehot_gather_conv_cuda(feats, nmap, weights, tile, block, bf16)


def _onehot_gather_conv_cuda(feats, nmap, weights, tile, block, bf16):
    """Launch ``onehot_window_blocks`` (csrc/gather_conv.cu: the window
    table of ``window_blocks`` in one pass over nmap, and zeroed miss
    counts), then ``onehot_conv_fwd`` in the mode ``kernel_mode`` picks.

    Replaces virconv_tpu/ops/pallas/onehot_conv.py::_kernel: the one-hot
    matmul over two VMEM blocks is an exact gather, done here as a direct
    row read under the same window rule. Bound: 2*C*C' operations per
    in-window (row, tap) hit, at the bf16 tensor-core rate for bf16
    operands, so the bytes of the inputs, and at the f32 rate for f32
    operands. Both take K1's gathered-row conv: 64-row CTAs with an output
    slab fitted to C', cp.async gathers of the rows a 16-row fragment hits,
    and mma.sync on W rounded and transposed once per call (bf16) or fmaf
    on CUDA cores (f32) (tile mode), or a thread per row for C <= 8,
    C' <= 16 (row mode)."""
    global launches
    from . import _cuda
    dev = feats.device
    n0, c_in = feats.shape
    k, _, c_out = weights.shape
    _cuda.check_cuda_tensor(feats, 'feats', torch.float32, 2)
    _cuda.check_cuda_tensor(nmap, 'nmap', torch.int32, 2, dev)
    _cuda.check_cuda_tensor(weights, 'weights', torch.float32, 3, dev)
    if k > MAX_TAPS or c_out < 1:
        raise ValueError(f'onehot_conv kernel limits: K={k} C\'={c_out}')
    mode = kernel_mode(c_in, c_out, bf16)
    n_tiles = (n0 + (-n0) % block + block) // tile
    blk = torch.empty((n_tiles, k), dtype=torch.int32, device=dev)
    misses = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    out = torch.empty((n0, c_out), dtype=torch.float32, device=dev)
    lib = _cuda.load('gather_conv')
    err = lib.onehot_window_blocks(_cuda.ptr(nmap), n0, k, tile, block,
                                   _cuda.ptr(blk), _cuda.ptr(misses),
                                   _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'onehot_window_blocks failed: CUDA error {err}')
    wprep = torch.empty((lib.onehot_conv_scratch_bytes(
        c_in, c_out, k, int(bf16), MODES[mode]),), dtype=torch.uint8,
        device=dev)
    err = lib.onehot_conv_fwd(
        _cuda.ptr(feats), _cuda.ptr(nmap), _cuda.ptr(weights),
        _cuda.ptr(blk), n0, c_in, c_out, k, tile, block, int(bf16),
        MODES[mode], _cuda.ptr(wprep), _cuda.ptr(out), _cuda.ptr(misses),
        _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'onehot_conv_fwd launch failed: CUDA error {err}')
    launches += 1
    mode_launches[f'{mode} {"bf16" if bf16 else "f32"}'] += 1
    return out, misses
