"""VirConv 3D backbones: NRConv blocks, the LiDAR stack, the dual-stream
VirConv8x of VirConv-T/S and the single fused-stream VirConvL8x of
VirConv-L. Counterpart of ``virconv_tpu/models/backbones_3d/virconv.py``.

Transform replicas ride the batch axis (entry = b * rot_num + i). Every
sparse conv runs on the neighbor map (``ops/sparse``), the NRConv
image-plane 2D convs on the unsorted tensor, duplicate pixels resolving to
their first row. In train mode the multimodal stream drops voxels at
random (StVD).
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops import sparse as sp
from ...utils.calibration import project_lidar_to_img
from ..layers import SparseDownBlock, SubMConvBlock

IMG_GRID = (1600, 600)   # 2D sparse grid of the image plane (u, v)


def layer_voxel_discard(st: sp.SparseTensor, rate: float, u):
    """Drop the valid rows whose uniform draw ``u`` (one per row of
    capacity) is below ``rate`` (train-time StVD)."""
    keep = st.mask & (u >= rate)
    return st.replace(mask=keep,
                      coords=torch.where(keep[:, None], st.coords,
                                         torch.full_like(st.coords, -1)),
                      feats=torch.where(keep[:, None], st.feats,
                                        torch.zeros_like(st.feats)))


def voxel_centers(coords, stride: int, voxel_size, pcr):
    """Voxel-center xyz of [b, z, y, x] coords at a feature stride."""
    dev = coords.device
    vs = torch.as_tensor(voxel_size, dtype=torch.float32, device=dev) * stride
    mins = torch.as_tensor(pcr[:3], dtype=torch.float32, device=dev)
    idx_xyz = coords[:, [3, 2, 1]].float()
    return (idx_xyz + 0.5) * vs + mins


class NRConvBlock(nn.Module):
    """Noise-resistant conv: 3D submanifold convs + image-plane 2D convs."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 padding=(1, 1, 1), voxel_size=(0.05, 0.05, 0.05),
                 point_cloud_range=(0, -40, -3, 70.4, 40, 1)):
        super().__init__()
        self.stride = stride
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        half = out_channels // 2
        c = in_channels
        if stride > 1:
            self.down = SparseDownBlock(c, out_channels, (3, 3, 3),
                                        (stride,) * 3, padding)
            c = out_channels
        self.d3_conv1 = SubMConvBlock(c, half)
        self.d3_conv2 = SubMConvBlock(half, half)
        self.d2_conv1 = SubMConvBlock(half, half, n_taps=9)
        self.d2_conv2 = SubMConvBlock(half, half, n_taps=9)

    def forward(self, st: sp.SparseTensor, v2r, p2t, trans_params,
                feat_stride: int, out_capacity: int | None = None):
        """v2r, p2t (B_e, 4, 3) calibration; trans_params (B_e, 3)
        [rot, flip, scale] world transform of each entry or None;
        feat_stride: voxel stride of this block's output; out_capacity:
        row capacity of a strided block's output."""
        train = self.training
        if self.stride > 1:
            st = self.down(st, out_capacity)
        ctx3d = sp.subm_conv_ctx(st, 3, train=train)
        d3 = self.d3_conv1(st, ctx3d)
        d3 = self.d3_conv2(d3, ctx3d)

        xyz = voxel_centers(d3.coords, feat_stride, self.voxel_size,
                            self.point_cloud_range)
        b = torch.clamp(d3.coords[:, 0], min=0).long()
        if trans_params is not None:
            p = trans_params[b]
            rot, flip, scale = p[:, 0], p[:, 1], p[:, 2]
            sign = torch.where(flip == 1, -1.0, 1.0)
            x = xyz[:, 0] / scale
            y = xyz[:, 1] / scale * sign
            z = xyz[:, 2] / scale
            cosa, sina = torch.cos(-rot), torch.sin(-rot)
            xyz = torch.stack([x * cosa - y * sina, x * sina + y * cosa, z],
                              -1)
        uv, _ = project_lidar_to_img(xyz, v2r[b], p2t[b])
        u = torch.div(torch.clamp(uv[:, 0].to(torch.int32), 0, 1400 - 1),
                      feat_stride, rounding_mode='floor')
        v = torch.div(torch.clamp(uv[:, 1].to(torch.int32), 0, 600 - 1),
                      feat_stride, rounding_mode='floor')
        coords2d = torch.stack([d3.coords[:, 0], u, v], -1)
        coords2d = torch.where(d3.mask[:, None], coords2d,
                               torch.full_like(coords2d, -1))
        st2d = sp.SparseTensor(feats=d3.feats, coords=coords2d, mask=d3.mask,
                               spatial_shape=IMG_GRID,
                               batch_size=st.batch_size)
        # the dense lookup table needs no sort; duplicate pixels resolve to
        # the first row
        ctx2d = sp.subm_conv_ctx(st2d, 3, train=train)
        d2 = self.d2_conv2(self.d2_conv1(st2d, ctx2d), ctx2d)
        return d3.replace(feats=torch.cat([d3.feats, d2.feats], -1))


def _cap(n: int, ratio: float) -> int:
    """Scale a row capacity, keeping a multiple of 512."""
    return max(512, int(n * ratio) // 512 * 512)


class LidarStack(nn.Module):
    """The 4-stage LiDAR sparse stack + conv_out of VirConv8x."""

    def __init__(self, in_channels: int, num_filters=(16, 32, 64, 64),
                 out_features: int = 64, cap_ratios=(1.0, 0.6, 0.35)):
        super().__init__()
        nf = tuple(num_filters)
        self.cap_ratios = tuple(cap_ratios)
        self.conv_input = SubMConvBlock(in_channels, nf[0])
        self.conv1 = SubMConvBlock(nf[0], nf[0])
        self.conv2_down = SparseDownBlock(nf[0], nf[1])
        self.conv2_a = SubMConvBlock(nf[1], nf[1])
        self.conv2_b = SubMConvBlock(nf[1], nf[1])
        self.conv3_down = SparseDownBlock(nf[1], nf[2])
        self.conv3_a = SubMConvBlock(nf[2], nf[2])
        self.conv3_b = SubMConvBlock(nf[2], nf[2])
        self.conv4_down = SparseDownBlock(nf[2], nf[3], padding=(0, 1, 1))
        self.conv4_a = SubMConvBlock(nf[3], nf[3])
        self.conv4_b = SubMConvBlock(nf[3], nf[3])
        self.conv_out = SparseDownBlock(
            nf[3], out_features, kernel_size=(3, 1, 1), stride=(2, 1, 1),
            padding=(0, 0, 0))

    def forward(self, st: sp.SparseTensor):
        caps = [_cap(st.capacity, r) for r in self.cap_ratios]
        train = self.training

        def ctx(t):
            return sp.subm_conv_ctx(t, 3, train=train)
        ctx1 = ctx(st)
        x = self.conv_input(st, ctx1)
        x1 = self.conv1(x, ctx1)
        x2 = self.conv2_down(x1, caps[0])
        ctx2 = ctx(x2)
        x2 = self.conv2_b(self.conv2_a(x2, ctx2), ctx2)
        x3 = self.conv3_down(x2, caps[1])
        ctx3 = ctx(x3)
        x3 = self.conv3_b(self.conv3_a(x3, ctx3), ctx3)
        x4 = self.conv4_down(x3, caps[2])
        ctx4 = ctx(x4)
        x4 = self.conv4_b(self.conv4_a(x4, ctx4), ctx4)
        out = self.conv_out(x4, caps[2])
        return {'x_conv1': x1, 'x_conv2': x2, 'x_conv3': x3, 'x_conv4': x4,
                'out': out}


class NRConvStack(nn.Module):
    """Four NRConv blocks; in train mode StVD drops ``layer_discard_rate``
    of the voxels of each block's output but the last, and of the input
    too when ``discard_input``."""

    def __init__(self, in_channels: int, num_filters=(16, 32, 64, 64),
                 voxel_size=(0.05, 0.05, 0.05),
                 point_cloud_range=(0, -40, -3, 70.4, 40, 1),
                 layer_discard_rate: float = 0.15,
                 discard_input: bool = True):
        super().__init__()
        nf = tuple(num_filters)
        self.layer_discard_rate = layer_discard_rate
        self.discard_input = discard_input
        kw = dict(voxel_size=voxel_size, point_cloud_range=point_cloud_range)
        self.vir_conv1 = NRConvBlock(in_channels, nf[0], stride=1, **kw)
        self.vir_conv2 = NRConvBlock(nf[0], nf[1], stride=2, **kw)
        self.vir_conv3 = NRConvBlock(nf[1], nf[2], stride=2, **kw)
        self.vir_conv4 = NRConvBlock(nf[2], nf[3], stride=2,
                                     padding=(0, 1, 1), **kw)

    def forward(self, st, v2r, p2t, trans_params, rng=None):
        """``rng`` (train mode): the step's draws (``train.draws.Draws``)."""
        def discard(t):
            if not (self.training and self.layer_discard_rate > 0):
                return t
            return layer_voxel_discard(t, self.layer_discard_rate,
                                       rng.voxel_uniform(t))

        if self.discard_input:
            st = discard(st)
        n0 = st.capacity
        x1 = self.vir_conv1(st, v2r, p2t, trans_params, 1, None)
        x2 = self.vir_conv2(discard(x1), v2r, p2t, trans_params, 2,
                            _cap(n0, 1.0))
        x3 = self.vir_conv3(discard(x2), v2r, p2t, trans_params, 4,
                            _cap(n0, 0.6))
        x4 = self.vir_conv4(discard(x3), v2r, p2t, trans_params, 8,
                            _cap(n0, 0.35))
        return {'x_conv1': x1, 'x_conv2': x2, 'x_conv3': x3, 'x_conv4': x4}


class VirConv8x(nn.Module):
    """Dual-stream backbone (VirConv-T): LiDAR stack + MM NRConv stack."""

    def __init__(self, in_channels: int, num_filters=(16, 32, 64, 64),
                 out_features: int = 64, voxel_size=(0.05, 0.05, 0.05),
                 point_cloud_range=(0, -40, -3, 70.4, 40, 1),
                 layer_discard_rate: float = 0.15):
        super().__init__()
        self.lidar = LidarStack(in_channels, num_filters, out_features)
        self.mm = NRConvStack(in_channels, num_filters, voxel_size,
                              point_cloud_range, layer_discard_rate)

    def forward(self, st_lidar, st_mm, v2r, p2t, trans_params,
                rng=None):
        lidar = self.lidar(st_lidar)
        mm = self.mm(st_mm, v2r, p2t, trans_params, rng)
        return {'multi_scale_3d_features': {k: lidar[k] for k in
                                            ('x_conv1', 'x_conv2', 'x_conv3',
                                             'x_conv4')},
                'multi_scale_3d_features_mm': mm,
                'encoded_spconv_tensor': lidar['out'],
                'multi_scale_3d_strides': {'x_conv1': 1, 'x_conv2': 2,
                                           'x_conv3': 4, 'x_conv4': 8}}


class VirConvL8x(nn.Module):
    """Single fused-stream backbone (VirConv-L): an NRConv stack over the
    real + virtual voxels with their RGB channels zeroed and no input StVD,
    then its own K=3 ``conv_out`` on ``x_conv4``."""

    def __init__(self, in_channels: int, num_filters=(16, 32, 64, 64),
                 out_features: int = 64, voxel_size=(0.05, 0.05, 0.05),
                 point_cloud_range=(0, -40, -3, 70.4, 40, 1),
                 layer_discard_rate: float = 0.1):
        super().__init__()
        nf = tuple(num_filters)
        self.mm = NRConvStack(in_channels, nf, voxel_size,
                              point_cloud_range, layer_discard_rate,
                              discard_input=False)
        self.conv_out = SparseDownBlock(
            nf[3], out_features, kernel_size=(3, 1, 1), stride=(2, 1, 1),
            padding=(0, 0, 0))

    def forward(self, st, v2r, p2t, trans_params, rng=None):
        feats = st.feats.clone()
        feats[:, 4:7] = 0.0
        mm = self.mm(st.replace(feats=feats), v2r, p2t, trans_params, rng)
        return {'multi_scale_3d_features': mm,
                'encoded_spconv_tensor': self.conv_out(mm['x_conv4']),
                'multi_scale_3d_strides': {'x_conv1': 1, 'x_conv2': 2,
                                           'x_conv3': 4, 'x_conv4': 8}}
