"""Masked sparse-row BatchNorm and the sparse and dense conv blocks, in
eval mode (BN folded into the conv epilogue) and train mode (``.train()``:
conv, batch-statistics BN, ReLU, nothing fused).

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
from ..parallel import data_parallel as dp


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid rows of (N, C) features (eps 1e-3). Train mode
    normalizes by the masked batch moments and moves the running statistics
    by momentum 0.01 towards the mean and the unbiased variance, as torch's
    BatchNorm1d (and the JAX package) do. In a data-parallel step
    (``parallel.data_parallel.synced``) the moments and the count are the
    global batch's."""

    def __init__(self, features: int, eps: float = 1e-3,
                 momentum: float = 0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def fold(self):
        """(mult, bias') of the folded running-statistics affine
        y = x * mult + bias'."""
        return self.fold_moments(self.running_mean, self.running_var)

    def fold_moments(self, mean, var, count=None):
        """(mult, bias') of the affine that normalizes by ``mean`` / ``var``.
        With ``count`` (train mode) these are batch moments over ``count``
        rows, and the running statistics move towards them."""
        if count is not None:
            self._update_running(mean, var, count)
        mult = self.weight / torch.sqrt(var + self.eps)
        return mult, self.bias - mean * mult

    @torch.no_grad()
    def _update_running(self, mean, var, count):
        unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * unbiased)

    def forward(self, x, mask):
        if not self.training:
            mult, bias = self.fold()
            y = x * mult + bias
            return torch.where(mask[:, None], y, torch.zeros_like(y))
        # two passes, each summed over the ranks in a data-parallel step
        # (dp.sync_moments): the mean, then the centered squares
        w = mask.to(x.dtype)[:, None]
        sum_x, n = dp.sync_moments((x * w).sum(0), w.sum())
        cnt = torch.clamp(n, min=1.0)
        mean = sum_x / cnt
        (sum_sq,) = dp.sync_moments(((x - mean) ** 2 * w).sum(0))
        var = sum_sq / cnt
        self._update_running(mean, var, cnt)
        y = (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
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
        (``sp.subm_conv_ctx``; in train mode one built with ``train=True``
        or ``sp.nmap_subm_conv_ctx``)."""
        if self.training:
            feats = self.MaskedBatchNorm_0(conv(st.feats, self.kernel),
                                           st.mask)
            if self.use_relu:
                feats = torch.relu(feats)
            return st.replace(feats=feats)
        mult, bias = self.MaskedBatchNorm_0.fold()
        feats = conv(st.feats, self.kernel, scale=mult, bias=bias,
                         relu=self.use_relu)
        return st.replace(feats=feats)


class SparseDownBlock(nn.Module):
    """Strided sparse conv + BN + ReLU: the band kernel with the BN folded
    in at eval, the neighbor-map conv with batch-statistics BN in train
    mode."""

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
        if self.training:
            conv = sp.nmap_strided_conv_ctx(st, st_out, self.stride,
                                            self.padding, self.kernel_size)
            feats = self.MaskedBatchNorm_0(conv(st.feats, self.kernel),
                                           st_out.mask)
            return st_out.replace(feats=torch.relu(feats))
        conv = sp.strided_conv_ctx(st, st_out, self.stride, self.padding,
                                   self.kernel_size, bf16=bf16)
        mult, bias = self.MaskedBatchNorm_0.fold()
        feats = conv(st.feats, self.kernel, scale=mult, bias=bias,
                         relu=True)
        return st_out.replace(feats=feats)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-3) whose train mode follows flax
    ``nn.BatchNorm(momentum=0.99)``, the JAX package's dense BN: batch
    variance E[x^2] - E[x]^2 (biased) both to normalize and in the running
    statistics, which move by 0.01 per step. (torch's train mode puts the
    unbiased variance in the running statistics.) In a data-parallel step
    the moments are the global batch's."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-3)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        axes = (0, 2, 3)
        mean, mean_sq = x.mean(axes), (x * x).mean(axes)
        if dp.active():
            # the global moments: the ranks' means weighted by their share
            # of the rows (exactly 1 for a group of one)
            n = x.numel() // x.shape[1]
            share = n / dp.global_int(n, x.device)
            mean, mean_sq = dp.sync_moments(mean * share, mean_sq * share)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(0.99 * self.running_mean + 0.01 * mean)
            self.running_var.copy_(0.99 * self.running_var + 0.01 * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[None, :, None, None]) * mul[None, :, None, None]
                + self.bias[None, :, None, None])


def promote(x, weight):
    """``x`` in the type flax's ``nn.Dense`` and ``nn.Conv`` compute in for
    input ``x`` and kernel ``weight`` (``promote_dtype``: bf16 features
    with f32 kernels compute in f32, a widening that is exact). Torch's
    layers take no mixed types, so the port writes the promotion out."""
    return x.to(torch.promote_types(x.dtype, weight.dtype))


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
        self.BatchNorm_0 = FlaxBatchNorm2d(features)

    def forward(self, x):
        """x (B, H, W, C) -> (B, H', W', C')."""
        x = promote(x, self.Conv_0.weight)
        y = self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2)))
        return torch.relu(y).permute(0, 2, 3, 1)
