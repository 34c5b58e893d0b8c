"""Masked sparse-row BatchNorm (eval) and the sparse and dense conv blocks.

Parameter names follow the flax module paths of ``virconv_tpu/models/
layers.py`` (``kernel``, ``MaskedBatchNorm_0``, ``Conv_0``, ``BatchNorm_0``)
so ``utils/jax_weights.py`` converts a flax tree by walking it. Sparse conv
kernels keep the JAX (K, C, C') layout.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops import sparse as sp


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid rows of (N, C) features, eval mode (running
    statistics; eps 1e-3)."""

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def fold(self):
        """(mult, bias') of the folded affine y = x * mult + bias'."""
        mult = self.weight / torch.sqrt(self.running_var + self.eps)
        return mult, self.bias - self.running_mean * mult

    def forward(self, x, mask):
        mult, bias = self.fold()
        y = x * mult + bias
        return torch.where(mask[:, None], y, torch.zeros_like(y))


class SubMConvBlock(nn.Module):
    """Submanifold sparse conv + folded BN + ReLU; the conv context is built
    by the caller and shared by the layers of one key set."""

    def __init__(self, in_channels: int, out_channels: int, n_taps: int = 27,
                 use_relu: bool = True):
        super().__init__()
        self.use_relu = use_relu
        self.kernel = nn.Parameter(torch.zeros(n_taps, in_channels,
                                               out_channels))
        self.MaskedBatchNorm_0 = MaskedBatchNorm(out_channels)

    def forward(self, st: sp.SparseTensor, conv):
        """``conv``: the conv function of st's key set
        (``sp.subm_conv_ctx``)."""
        mult, bias = self.MaskedBatchNorm_0.fold()
        feats = conv(st.feats, self.kernel, scale=mult, bias=bias,
                         relu=self.use_relu)
        return st.replace(feats=feats)


class SparseDownBlock(nn.Module):
    """Strided sparse conv + folded BN + ReLU (band kernel path)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size=(3, 3, 3), stride=(2, 2, 2), padding=(1, 1, 1)):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        k = 1
        for s in self.kernel_size:
            k *= s
        self.kernel = nn.Parameter(torch.zeros(k, in_channels, out_channels))
        self.MaskedBatchNorm_0 = MaskedBatchNorm(out_channels)

    def forward(self, st: sp.SparseTensor, out_capacity: int | None = None,
                bf16: bool = True):
        cap = out_capacity or st.capacity
        st_out = sp.downsample_coords(st, self.stride, self.padding,
                                      self.kernel_size, cap)
        conv = sp.strided_conv_ctx(st, st_out, self.stride, self.padding,
                                   self.kernel_size, bf16=bf16)
        mult, bias = self.MaskedBatchNorm_0.fold()
        feats = conv(st.feats, self.kernel, scale=mult, bias=bias,
                         relu=True)
        return st_out.replace(feats=feats)


class DenseConvBlock(nn.Module):
    """3x3 conv + BN + ReLU on NHWC maps, with the explicit symmetric
    (k//2, k//2) padding of the reference (not flax 'SAME')."""

    def __init__(self, in_channels: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel, stride=stride,
                                padding=tuple(k // 2 for k in kernel),
                                bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-3)

    def forward(self, x):
        """x (B, H, W, C) -> (B, H', W', C')."""
        y = self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2)))
        return torch.relu(y).permute(0, 2, 3, 1)
