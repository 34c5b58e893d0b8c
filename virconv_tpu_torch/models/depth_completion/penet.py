"""PENet depth completion (ENet backbone and two-scale DA-CSPN++) in NCHW.

The port of ``virconv_tpu/models/depth_completion/penet.py`` (the
reference's ``tools/PENet/model.py`` PENet_C2). Module and parameter names
are the flax module paths (``backbone.rgb_enc1.conv1``,
``guide3_s2.generate.Conv_0``, ``BatchNorm_0``, ``ConvTranspose_0``), so
``utils/jax_weights.from_jax_variables`` carries a flax tree across by
walking it. Every BN runs on its running statistics (eps 1e-5): the
model is used for inference only. The dense convs stay cuDNN, as the JAX
package leaves them to XLA; the propagation loops run on
``ops/cspn.cspn_iteration`` (``csrc/cspn.cu`` on the card).

Inputs (NCHW): ``rgb`` (B, 3, H, W) on the 0-255 scale, sparse depth ``d``
(B, 1, H, W) in metres, ``position`` (B, 2, H, W) the normalized (u, v) in
[-1, 1], intrinsics ``k_mat`` (B, 3, 3). H and W are multiples of 32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.cspn import KERNEL_SIZES, cspn_iteration, nn_up

BN_EPS = 1e-5
CROP_H, CROP_W = 352, 1216


class ConvBnRelu(nn.Module):
    """Conv (symmetric padding (k - 1) // 2, no bias) + BN [+ ReLU]."""

    def __init__(self, cin, features, kernel=3, stride=1, use_relu=True):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, kernel, stride,
                                (kernel - 1) // 2, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.use_relu = use_relu

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return torch.relu(x) if self.use_relu else x


class DeconvBnRelu(nn.Module):
    """ConvTranspose2d(k, s, padding (k - 1) // 2, output_padding s - 1,
    no bias) + BN + ReLU: k=5 s=2 doubles the size, k=3 s=1 keeps it."""

    def __init__(self, cin, features, kernel=5, stride=2):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(
            cin, features, kernel, stride, (kernel - 1) // 2,
            output_padding=stride - 1, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=BN_EPS)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.ConvTranspose_0(x)))


class BasicBlockGeo(nn.Module):
    """ResNet basic block with 3 geometry channels before each conv: conv1
    reads cat(x, g1), conv2 cat(g2, out); the 1x1 down conv (when the
    stride or the width changes) reads cat(x, g1) too."""

    def __init__(self, inplanes, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes + 3, planes, 3, stride, 1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.conv2 = nn.Conv2d(planes + 3, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.has_down = stride != 1 or inplanes != planes
        if self.has_down:
            self.down_conv = nn.Conv2d(inplanes + 3, planes, 1, stride,
                                       bias=False)
            self.down_bn = nn.BatchNorm2d(planes, eps=BN_EPS)

    def forward(self, x, g1, g2):
        inp = torch.cat([x, g1], 1)
        out = torch.relu(self.bn1(self.conv1(inp)))
        out = self.bn2(self.conv2(torch.cat([g2, out], 1)))
        identity = self.down_bn(self.down_conv(inp)) if self.has_down else x
        return torch.relu(out + identity)


def sparse_downsample_close(d, mask, stride=2):
    """Keep-nearest downsample of valid depths (a min-pool by a max-pool of
    the negated, 600-encoded depths) and the max-pooled mask."""
    large = 600.0
    enc = -(1 - mask) * large - d
    enc = -F.max_pool2d(enc, stride, stride)
    new_mask = F.max_pool2d(mask, stride, stride)
    return enc - (1 - new_mask) * large, new_mask


def geometry_feature(z, vnorm, unorm, h, w, ch, cw, fh, fw):
    x = z * (0.5 * h * (vnorm + 1) - ch) / fh
    y = z * (0.5 * w * (unorm + 1) - cw) / fw
    return torch.cat([x, y, z], 1)


def avg_pool2(x):
    return F.avg_pool2d(x, 2, 2)


# (name, in, out, stride) of the encoder blocks; the depth branch's odd
# blocks 3, 5, 7, 9 read cat(rgb decoder skip, previous) and so are wider
_RGB_ENC = [(1, 32, 64, 2), (2, 64, 64, 1), (3, 64, 128, 2),
            (4, 128, 128, 1), (5, 128, 256, 2), (6, 256, 256, 1),
            (7, 256, 512, 2), (8, 512, 512, 1), (9, 512, 1024, 2),
            (10, 1024, 1024, 1)]
_D_IN = {3: 128, 5: 256, 7: 512, 9: 1024}


class ENet(nn.Module):
    """Two-branch (RGB and depth) encoder-decoder with geometry features.
    The geometry features use the 352 x 1216 crop constants whatever the
    input size, as the reference does (weight parity)."""

    def __init__(self):
        super().__init__()
        self.rgb_init = ConvBnRelu(4, 32, 5)
        self.d_init = ConvBnRelu(2, 32, 5)
        for i, cin, cout, stride in _RGB_ENC:
            setattr(self, f'rgb_enc{i}', BasicBlockGeo(cin, cout, stride))
            setattr(self, f'd_enc{i}',
                    BasicBlockGeo(_D_IN.get(i, cin), cout, stride))
        for i, cin, cout in ((8, 1024, 512), (6, 512, 256), (4, 256, 128),
                             (2, 128, 64), (0, 64, 32)):
            setattr(self, f'rgb_dec{i}', DeconvBnRelu(cin, cout))
        self.rgb_out = DeconvBnRelu(32, 2, 3, 1)
        for i, cin, cout in ((1, 1024, 512), (2, 512, 256), (3, 256, 128),
                             (4, 128, 64), (5, 64, 32)):
            setattr(self, f'dec{i}', DeconvBnRelu(cin, cout))
        self.dec6 = ConvBnRelu(32, 2, 3)

    def forward(self, rgb, d, position, k_mat):
        h, w = CROP_H, CROP_W
        unorm = position[:, 0:1]
        vnorm = position[:, 1:2]
        fh = k_mat[:, 1, 1].reshape(-1, 1, 1, 1)
        ch = k_mat[:, 1, 2].reshape(-1, 1, 1, 1)
        fw = k_mat[:, 0, 0].reshape(-1, 1, 1, 1)
        cw = k_mat[:, 0, 2].reshape(-1, 1, 1, 1)

        vs, us = [vnorm], [unorm]
        for _ in range(5):
            vs.append(avg_pool2(vs[-1]))
            us.append(avg_pool2(us[-1]))
        ds, ms = [d], [(d > 0).to(d.dtype)]
        for _ in range(5):
            nd, nm = sparse_downsample_close(ds[-1], ms[-1])
            ds.append(nd)
            ms.append(nm)
        geos = [geometry_feature(ds[i], vs[i], us[i], h / 2 ** i,
                                 w / 2 ** i, ch, cw, fh, fw)
                for i in range(6)]

        def geo(i):          # encoder block i: g1, g2 at its in, out scale
            return geos[i // 2], geos[(i + 1) // 2]

        # rgb branch: odd encoder blocks downsample
        rf = self.rgb_init(torch.cat([rgb, d], 1))
        r = [rf]
        for i in range(1, 11):
            r.append(getattr(self, f'rgb_enc{i}')(r[-1], *geo(i)))
        r8_plus = self.rgb_dec8(r[10]) + r[8]
        r6_plus = self.rgb_dec6(r8_plus) + r[6]
        r4_plus = self.rgb_dec4(r6_plus) + r[4]
        r2_plus = self.rgb_dec2(r4_plus) + r[2]
        r0_plus = self.rgb_dec0(r2_plus) + rf
        rgb_out = self.rgb_out(r0_plus)
        rgb_depth, rgb_conf = rgb_out[:, 0:1], rgb_out[:, 1:2]

        # depth branch, fused with the rgb decoder's skip features
        skip = {3: r2_plus, 5: r4_plus, 7: r6_plus, 9: r8_plus}
        x = self.d_init(torch.cat([d, rgb_depth], 1))
        dd = [x]
        for i in range(1, 11):
            inp = torch.cat([skip[i], dd[-1]], 1) if i in skip else dd[-1]
            dd.append(getattr(self, f'd_enc{i}')(inp, *geo(i)))

        dd1 = self.dec1(r[10] + dd[10])
        dd2 = self.dec2(dd[8] + dd1)
        dd3 = self.dec3(dd[6] + dd2)
        dd4 = self.dec4(dd[4] + dd3)
        dd5 = self.dec5(dd[2] + dd4)
        d_out = self.dec6(dd5)
        d_depth, d_conf = d_out[:, 0:1], d_out[:, 1:2]

        conf = torch.softmax(torch.cat([rgb_conf, d_conf], 1), 1)
        output = conf[:, 0:1] * rgb_depth + conf[:, 1:2] * d_depth
        feature_s1 = torch.cat([r0_plus, dd5], 1)     # 64 ch, full res
        feature_s2 = torch.cat([r2_plus, dd4], 1)     # 128 ch, half res
        return feature_s1, feature_s2, output


class CSPNGuide(nn.Module):
    """The k^2 normalized propagation weights: the k^2 - 1 generated
    weights over their abs-sum, the centre weight 1 - their sum."""

    def __init__(self, cin, kernel_size):
        super().__init__()
        self.kernel_size = kernel_size
        self.generate = ConvBnRelu(cin, kernel_size ** 2 - 1, 3,
                                   use_relu=False)

    def forward(self, feature):
        k2 = self.kernel_size ** 2
        guide = self.generate(feature)
        gsum = guide.abs().sum(1, keepdim=True)
        guide = guide / torch.where(gsum == 0, torch.ones_like(gsum), gsum)
        mid = 1.0 - guide.sum(1, keepdim=True)
        half = (k2 - 1) // 2
        return torch.cat([guide[:, :half], mid, guide[:, half:]], 1)


class PENetC2(nn.Module):
    """ENet and two-scale DA-CSPN++: ``iters`` propagation iterations at
    half resolution (dilation 2, guides from the 1/2-scale features), then
    ``iters`` at full resolution, each mixed by its kernel confidences."""

    def __init__(self, iters=6):
        super().__init__()
        self.iters = iters
        self.backbone = ENet()
        for suffix, cin in (('_s2', 128), ('', 64)):
            setattr(self, f'mask{suffix}',
                    ConvBnRelu(cin, 1, 3, use_relu=False))
            setattr(self, f'kconf{suffix}',
                    ConvBnRelu(cin, 3, 3, use_relu=False))
            for k in KERNEL_SIZES:
                setattr(self, f'guide{k}{suffix}', CSPNGuide(cin, k))

    def heads(self, rgb, d, position, k_mat):
        """ENet and the propagation inputs of both stages: a dict with the
        coarse depth, the guides, masks, kernel confidences and sparse
        depths."""
        valid = (d > 0).to(d.dtype)
        f_s1, f_s2, coarse = self.backbone(rgb, d, position, k_mat)
        d_s2, vm_s2 = sparse_downsample_close(d, valid)
        return {
            'coarse': coarse, 'd': d, 'd_s2': d_s2,
            'mask_s2': torch.sigmoid(self.mask_s2(f_s2)) * vm_s2,
            'kconf_s2': torch.softmax(self.kconf_s2(f_s2), 1),
            'guides_s2': [getattr(self, f'guide{k}_s2')(f_s2)
                          for k in KERNEL_SIZES],
            'mask': torch.sigmoid(self.mask(f_s1)) * valid,
            'kconf': torch.softmax(self.kconf(f_s1), 1),
            'guides': [getattr(self, f'guide{k}')(f_s1)
                       for k in KERNEL_SIZES]}

    def propagate(self, p):
        """The two propagation stages over ``heads``' dict: 2 x ``iters``
        ``cspn_iteration`` calls. Returns the refined depth."""
        coarse = p['coarse']
        ds = (coarse,) * 3
        for _ in range(self.iters):
            ds = cspn_iteration(p['guides_s2'], ds, coarse, p['mask_s2'],
                                p['d_s2'], dilation=2, half_res=True)
        kc = [nn_up(p['kconf_s2'][:, i:i + 1]) for i in range(3)]
        depth_s2 = kc[0] * ds[0] + kc[1] * ds[1] + kc[2] * ds[2]
        ds = (depth_s2,) * 3
        for _ in range(self.iters):
            ds = cspn_iteration(p['guides'], ds, depth_s2, p['mask'], p['d'],
                                dilation=1, half_res=False)
        kconf = p['kconf']
        return (kconf[:, 0:1] * ds[0] + kconf[:, 1:2] * ds[1]
                + kconf[:, 2:3] * ds[2])

    def forward(self, rgb, d, position, k_mat):
        return self.propagate(self.heads(rgb, d, position, k_mat))
