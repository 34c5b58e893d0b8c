"""Exact sparse conv from a neighbor map and its weight gradient, in plain
PyTorch: one gather + matmul per tap (frozen copy of the measured
program's plain versions; no kernel).

``nmap_conv``: feats (N_in, C), nmap (N_out, K) rows of feats (-1 =
missing), weights (K, C, C') -> (N_out, C') f32. ``nmap_conv_dw``: the
weight gradient over the same map, (K, C, C') f32.
"""

from __future__ import annotations

import torch

from .sparse import _gather, _gathered_conv_raw


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
    """Exact conv from a neighbor map, (N_out, C') f32."""
    return nmap_conv_plain(feats, nmap, weights)


def nmap_conv_dw_plain(feats, nmap, g):
    """Plain PyTorch version of the weight gradient: one gather + matmul
    per tap, (K, C, C') f32."""
    _check_dw(feats, nmap, g)
    f, g = feats.float(), g.float()
    return torch.stack([_gather(f, nmap[:, j]).T @ g
                        for j in range(nmap.shape[1])])


def nmap_conv_dw(feats, nmap, g):
    """Weight gradient of the conv over a neighbor map, (K, C, C') f32."""
    return nmap_conv_dw_plain(feats, nmap, g)

