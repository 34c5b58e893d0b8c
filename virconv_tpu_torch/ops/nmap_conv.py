"""Exact sparse conv from a neighbor map and its weight gradient on the
card: the CUDA kernel wrappers and their plain PyTorch versions.

``nmap_conv`` is the conv of an eval context on the neighbor map (every
eval conv under ``VIRCONV_BAND=0``, a context with unsorted keys) and the
forward and input gradient of the training neighbor-map conv
(``ops/sparse._GatheredConvTrain``: every training strided conv, the NRConv
2D convs, and the 3D convs under ``VIRCONV_BAND_TRAIN=0``). The band conv's
gather patch runs on the same arithmetic inside K1's call
(``ops/band_conv.py``). The JAX package computes these with XLA's gather +
matmul (``virconv_tpu/ops/sparse.py::gathered_conv``,
``gathered_conv_train``; no Pallas kernel). Contract: feats (N_in, C) f32,
nmap (N_out, K) int32 rows of feats (-1 = missing), weights (K, C, C');
returns (N_out, C') f32 = sum over taps of the gathered rows times W[k],
with no output mask and no epilogue.

``nmap_conv_dw`` is the weight gradient over the same map (the JAX
package's ``_gct_bwd`` dW and the gather patch's term of
``_band_train_bwd``): feats (N_in, C), nmap (N_out, K), g (N_out, C') ->
dW (K, C, C') f32, ``dW[k] = sum over rows r with nmap[r, k] >= 0 of
feats[nmap[r, k]]^T g[r]``.
"""

from __future__ import annotations

import torch

from . import band_conv as _band_conv
from .gather_conv import MAX_TAPS, MODES, kernel_mode
from .sparse import _gather, _gathered_conv_raw

# kernel launches (CUDA tensors only) of nmap_conv and of nmap_conv_dw,
# reset and read by chip_smoke.py
launches = 0
dw_launches = 0


def _check(feats, nmap, weights):
    k = nmap.shape[1] if nmap.ndim == 2 else 0
    if (feats.ndim != 2 or nmap.ndim != 2 or weights.ndim != 3 or k < 1
            or tuple(weights.shape[:2]) != (k, feats.shape[1])):
        raise ValueError(f'nmap_conv: feats {tuple(feats.shape)}, nmap '
                         f'{tuple(nmap.shape)}, weights '
                         f'{tuple(weights.shape)} disagree')


def _check_dw(feats, nmap, g):
    if (feats.ndim != 2 or nmap.ndim != 2 or g.ndim != 2
            or nmap.shape[1] < 1 or g.shape[0] != nmap.shape[0]):
        raise ValueError(f'nmap_conv_dw: feats {tuple(feats.shape)}, nmap '
                         f'{tuple(nmap.shape)}, g {tuple(g.shape)} disagree')


def nmap_conv_plain(feats, nmap, weights):
    """Plain PyTorch version: one gather + matmul per tap."""
    _check(feats, nmap, weights)
    return _gathered_conv_raw(feats.float(), nmap, weights)


def nmap_conv(feats, nmap, weights):
    """Exact conv from a neighbor map: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Returns (N_out, C') f32."""
    _check(feats, nmap, weights)
    if not feats.is_cuda:
        return nmap_conv_plain(feats, nmap, weights)
    return _nmap_conv_cuda(feats.float().contiguous(),
                           nmap.to(torch.int32).contiguous(),
                           weights.float().contiguous())


def _launch_fwd(entry, feats, nmap, weights):
    """Checks the operands and runs the C entry ``entry`` of
    csrc/gather_conv.cu; returns (output, whether it launched)."""
    from . import _cuda
    dev = feats.device
    n_in, c_in = feats.shape
    n_out, k = nmap.shape
    c_out = weights.shape[2]
    _cuda.check_cuda_tensor(feats, 'feats', torch.float32, 2)
    _cuda.check_cuda_tensor(nmap, 'nmap', torch.int32, 2, dev)
    _cuda.check_cuda_tensor(weights, 'weights', torch.float32, 3, dev)
    if k > MAX_TAPS or c_out < 1:
        raise ValueError(f'nmap_conv kernel limits: K={k} C\'={c_out}')
    mode = kernel_mode(c_in, c_out)
    out = torch.empty((n_out, c_out), dtype=torch.float32, device=dev)
    misses = torch.zeros((1,), dtype=torch.int32, device=dev)
    lib = _cuda.load('gather_conv')
    wprep = torch.empty((lib.gather_conv_scratch_bytes(
        c_in, c_out, k, MODES[mode]),), dtype=torch.uint8, device=dev)
    err = getattr(lib, entry)(
        _cuda.ptr(feats), _cuda.ptr(nmap), _cuda.ptr(weights), n_out, n_in,
        c_in, c_out, k, MODES[mode], _cuda.ptr(wprep), _cuda.ptr(out),
        _cuda.ptr(misses), _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'{entry} launch failed: CUDA error {err}')
    return out, n_out > 0


def _nmap_conv_cuda(feats, nmap, weights):
    """Launch ``nmap_conv_fwd`` (csrc/gather_conv.cu) in the mode
    ``kernel_mode`` picks. Tile mode (C > 8 or C' > 16, C <= 128): a CTA
    of 64 rows and an output slab fitted to C' compacts each tap's hit
    rows into dense 16-row fragments, gathers only them with cp.async into
    a ring beside W[k]'s slab tile and keeps the rows' sums in shared
    memory, so no fragment multiplies rows that miss the tap; row mode (a
    thread per row, C <= 8, C' <= 16) and the fma mode (C > 128) are K5's
    bodies. Sums in tap then channel order, f32 on CUDA cores (K1's f32
    bits on the same sources). Bound: 2*C*C' operations per (row, tap) hit
    at the f32 rate."""
    global launches
    out, launched = _launch_fwd('nmap_conv_fwd', feats, nmap, weights)
    if launched:
        launches += 1
    return out


def nmap_conv_prev(feats, nmap, weights):
    """``nmap_conv`` on the body it had before its tile mode was
    redesigned (``nmap_conv_fwd_prev``: K5's tile body with one window,
    which multiplies a 16-row fragment by W[k] whenever any of its rows
    hits tap k). No path runs it: chip_smoke.py and the card tests hold
    ``nmap_conv`` to it bit for bit and time the two side by side. CUDA
    tensors only; counts no launch."""
    _check(feats, nmap, weights)
    return _launch_fwd('nmap_conv_fwd_prev', feats.float().contiguous(),
                       nmap.to(torch.int32).contiguous(),
                       weights.float().contiguous())[0]


def nmap_conv_dw_plain(feats, nmap, g):
    """Plain PyTorch version of the weight gradient: one gather + matmul
    per tap, (K, C, C') f32."""
    _check_dw(feats, nmap, g)
    f, g = feats.float(), g.float()
    return torch.stack([_gather(f, nmap[:, j]).T @ g
                        for j in range(nmap.shape[1])])


def nmap_conv_dw(feats, nmap, g):
    """Weight gradient of the conv over a neighbor map, (K, C, C') f32: the
    CUDA kernels for CUDA tensors, the plain version for CPU tensors."""
    _check_dw(feats, nmap, g)
    if not feats.is_cuda:
        return nmap_conv_dw_plain(feats, nmap, g)
    return _nmap_conv_dw_cuda(feats.float().contiguous(),
                              nmap.to(torch.int32).contiguous(),
                              g.float().contiguous())


# rows of a K4 chunk are counted in blocks of this many (the unit of K4's
# chunk rule, ``band_conv.dw_tiles_per_chunk``)
DW_ROW_BLOCK = 64


def dw_chunk_rows(n_out: int, n_taps: int, c_out: int) -> int:
    """Rows per K4 chunk of a neighbor-map weight gradient: K4's rule
    (about ``band_conv.DW_TARGET_CTAS`` CTAs over chunks, taps and output
    slabs, at most ``band_conv.DW_MAX_CHUNK`` rows) on blocks of
    DW_ROW_BLOCK rows."""
    n_blocks = -(-n_out // DW_ROW_BLOCK)
    return DW_ROW_BLOCK * _band_conv.dw_tiles_per_chunk(
        n_blocks, DW_ROW_BLOCK, n_taps, c_out)


def _nmap_conv_dw_cuda(feats, nmap, g):
    """Launch ``nmap_conv_dw`` (csrc/band_conv.cu): a source pass writes
    the map tap-major (K4's source table), then K4's sums kernel (a CTA
    per chunk of ``dw_chunk_rows`` rows, tap and output slab lists its hit
    rows, gathers their feats and g rows with cp.async into a ring and
    sums the C x C' block in registers, fmaf on CUDA cores) and K4's sum of
    the partials in chunk order: the same bits on every run. Bound:
    2*C*C' operations per (row, tap) hit at the f32 rate."""
    global dw_launches
    from . import _cuda
    dev = feats.device
    n_in, c_in = feats.shape
    n_out, k = nmap.shape
    c_out = g.shape[1]
    _cuda.check_cuda_tensor(feats, 'feats', torch.float32, 2)
    _cuda.check_cuda_tensor(nmap, 'nmap', torch.int32, 2, dev)
    _cuda.check_cuda_tensor(g, 'g', torch.float32, 2, dev)
    if c_in > _band_conv.MAX_CIN or c_out < 1:
        raise ValueError(f'nmap_conv_dw kernel limits: C={c_in} '
                         f'C\'={c_out}')
    chunk = dw_chunk_rows(n_out, k, c_out)
    lib = _cuda.load('band_conv')
    scratch = torch.empty((lib.nmap_conv_dw_scratch_bytes(
        k, c_in, c_out, n_out, chunk),), dtype=torch.uint8, device=dev)
    out = torch.empty((k, c_in, c_out), dtype=torch.float32, device=dev)
    err = lib.nmap_conv_dw(
        _cuda.ptr(feats), _cuda.ptr(nmap), _cuda.ptr(g), n_in, n_out, c_in,
        c_out, k, chunk, _cuda.ptr(scratch), _cuda.ptr(out),
        _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'nmap_conv_dw launch failed: CUDA error {err}')
    dw_launches += 1
    return out
