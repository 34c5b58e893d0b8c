"""Exact sparse conv from a neighbor map on the card: the CUDA kernel
wrapper and its plain PyTorch version.

The band conv (K1) leaves the rows of tiles whose window does not fit to
an exact gather patch, and a context whose keys are unsorted to the full
neighbor map; both are this conv. The patch runs inside K1's call
(``ops/band_conv.py``, the same bodies and bits); this wrapper serves the
neighbor-map branch. The JAX package computes them with XLA's
gather + matmul (``virconv_tpu/ops/sparse.py::gathered_conv``, no Pallas
kernel). Contract: feats (N_in, C) f32, nmap (N_out, K) int32 rows of feats
(-1 = missing), weights (K, C, C'); returns (N_out, C') f32 = sum over taps
of the gathered rows times W[k], with no output mask and no epilogue.
"""

from __future__ import annotations

import torch

from .gather_conv import MAX_TAPS, MODES, kernel_mode
from .sparse import _gathered_conv_raw

# kernel launches (CUDA tensors only), reset and read by chip_smoke.py
launches = 0


def _check(feats, nmap, weights):
    k = nmap.shape[1] if nmap.ndim == 2 else 0
    if (feats.ndim != 2 or nmap.ndim != 2 or weights.ndim != 3 or k < 1
            or tuple(weights.shape[:2]) != (k, feats.shape[1])):
        raise ValueError(f'nmap_conv: feats {tuple(feats.shape)}, nmap '
                         f'{tuple(nmap.shape)}, weights '
                         f'{tuple(weights.shape)} disagree')


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


def _nmap_conv_cuda(feats, nmap, weights):
    """Launch ``nmap_conv_fwd`` (csrc/gather_conv.cu): K5's kernel with one
    window over every feature row, in the mode ``kernel_mode`` picks (a
    thread per row for C <= 8, C' <= 16, else 64-row CTAs with an output
    slab fitted to C'); sums in tap then channel order, f32 on CUDA
    cores. Bound: 2*C*C' operations per (row, tap) hit at the f32 rate."""
    global launches
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
    err = lib.nmap_conv_fwd(
        _cuda.ptr(feats), _cuda.ptr(nmap), _cuda.ptr(weights), n_out, n_in,
        c_in, c_out, k, MODES[mode], _cuda.ptr(wprep), _cuda.ptr(out),
        _cuda.ptr(misses), _cuda.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f'nmap_conv_fwd launch failed: CUDA error {err}')
    if n_out:
        launches += 1
    return out
