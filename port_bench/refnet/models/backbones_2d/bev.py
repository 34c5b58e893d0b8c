"""BEV modules: height compression and the 2D conv pyramid.
Counterpart of ``virconv_tpu/models/backbones_2d/bev.py``; maps are NHWC
at the module boundary, like the JAX package."""

from __future__ import annotations

import torch
from torch import nn

from ...ops import sparse as sp
from ..layers import DenseConvBlock, FlaxBatchNorm2d


def height_compression(st: sp.SparseTensor) -> torch.Tensor:
    """Sparse (B, D, H, W, C) -> dense BEV (B, H, W, D*C), channel d*C + c."""
    dense = sp.to_dense(st)
    b, d, h, w, c = dense.shape
    return dense.permute(0, 2, 3, 1, 4).reshape(b, h, w, d * c)


class BaseBEVBackbone(nn.Module):
    """Two-level conv pyramid with upsample-concat."""

    def __init__(self, in_channels: int, layer_nums=(4, 4),
                 layer_strides=(1, 2), num_filters=(64, 128),
                 upsample_strides=(1, 2), num_upsample_filters=(128, 128)):
        super().__init__()
        self.layer_nums = tuple(layer_nums)
        c = in_channels
        for i, n_layers in enumerate(self.layer_nums):
            nf = num_filters[i]
            s = layer_strides[i]
            setattr(self, f'block{i}_down',
                    DenseConvBlock(c, nf, stride=(s, s)))
            for k in range(n_layers):
                setattr(self, f'block{i}_conv{k}', DenseConvBlock(nf, nf))
            u = upsample_strides[i]
            if u > 1:
                de = nn.ConvTranspose2d(nf, num_upsample_filters[i], u,
                                        stride=u, bias=False)
            else:
                de = nn.Conv2d(nf, num_upsample_filters[i], u, stride=u,
                               bias=False)
            setattr(self, f'deblock{i}', de)
            setattr(self, f'deblock{i}_bn',
                    FlaxBatchNorm2d(num_upsample_filters[i]))
            c = nf

    def forward(self, x):
        """x (B, H, W, C) -> (B, H, W, sum(num_upsample_filters))."""
        ups = []
        for i, n_layers in enumerate(self.layer_nums):
            x = getattr(self, f'block{i}_down')(x)
            for k in range(n_layers):
                x = getattr(self, f'block{i}_conv{k}')(x)
            u = getattr(self, f'deblock{i}')(x.permute(0, 3, 1, 2))
            u = torch.relu(getattr(self, f'deblock{i}_bn')(u))
            ups.append(u.permute(0, 2, 3, 1))
        return torch.cat(ups, -1) if len(ups) > 1 else ups[0]
