"""PENet_C2 (Hu et al., "PENet: Towards Precise and Efficient Image Guided
Depth Completion", ICRA 2021, arXiv:2103.00783; ``model.py`` ``PENet_C2``
of JUGGHM/PENet_ICRA2021, which VirConv vendors in ``tools/PENet/``) in
plain PyTorch, NCHW, float32, for inference: the reference of the
``penet_vp`` cell.

ENet: an RGB and a depth encoder-decoder, each of 10 ResNet blocks that
read 3 geometry channels (x, y, z back-projected from the sparse depth
pooled to the block's scale) before each conv, 32 to 1 024 channels at
1/32 scale; the depth branch's odd blocks read the RGB decoder's skip
features; transposed-conv decoders; the two depth estimates fused by a
softmax over their confidences. DA-CSPN++: 6 iterations at half
resolution (dilation 2, guides from the 1/2-scale features), then 6 at
full resolution, each over kernel sizes 3, 5 and 7, each followed by the
blend with the sparse depth under a learned mask, the three results mixed
by per-pixel kernel confidences. The propagation is the plain shifted sum
(``shift2d``), one tap at a time.

Parameter names are the measured program's (``backbone.rgb_enc1.conv1``,
``guide3_s2.generate.Conv_0``, ``BatchNorm_0``, ``ConvTranspose_0``), so
one state_dict loads into both. Departures from the published model, all
shared with the program: every batch norm runs on its running statistics
(inference only); the geometry features use the 352 x 1216 crop's
constants whatever the input size; the propagation's shifted sums take
zeros outside the map; the blend and the kernel-confidence mix are
written out as sums in a fixed order. It imports nothing of the program.

``tf32_operands(model)``: inside the block every conv's input and weights
are rounded to TF32's 10-bit mantissa, which is what TF32 tensor cores do
to the operands (the check's control; on a card TF32 is switched on as
well).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from .models.layers import FlaxBatchNorm2d

BN_EPS = 1e-5
CROP_H, CROP_W = 352, 1216
KERNEL_SIZES = (3, 5, 7)


class BatchNorm2d(FlaxBatchNorm2d):
    """``nn.BatchNorm2d`` with eps 1e-5 on its running statistics; a
    ``FlaxBatchNorm2d`` so that the benchmark's batch-norm calibration
    (``benchlib/weights.calibrate_bn``) sets it."""

    def __init__(self, features):
        super().__init__(features)
        self.eps = BN_EPS


class ConvBnRelu(nn.Module):
    def __init__(self, cin, features, kernel=3, stride=1, use_relu=True):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, kernel, stride,
                                (kernel - 1) // 2, bias=False)
        self.BatchNorm_0 = BatchNorm2d(features)
        self.use_relu = use_relu

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return torch.relu(x) if self.use_relu else x


class DeconvBnRelu(nn.Module):
    def __init__(self, cin, features, kernel=5, stride=2):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(
            cin, features, kernel, stride, (kernel - 1) // 2,
            output_padding=stride - 1, bias=False)
        self.BatchNorm_0 = BatchNorm2d(features)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.ConvTranspose_0(x)))


class BasicBlockGeo(nn.Module):
    def __init__(self, inplanes, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes + 3, planes, 3, stride, 1,
                               bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes + 3, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.has_down = stride != 1 or inplanes != planes
        if self.has_down:
            self.down_conv = nn.Conv2d(inplanes + 3, planes, 1, stride,
                                       bias=False)
            self.down_bn = BatchNorm2d(planes)

    def forward(self, x, g1, g2):
        inp = torch.cat([x, g1], 1)
        out = torch.relu(self.bn1(self.conv1(inp)))
        out = self.bn2(self.conv2(torch.cat([g2, out], 1)))
        identity = self.down_bn(self.down_conv(inp)) if self.has_down else x
        return torch.relu(out + identity)


def sparse_downsample_close(d, mask, stride=2):
    """Keep-nearest 2x downsample of the valid depths and the pooled
    mask."""
    large = 600.0
    enc = -(1 - mask) * large - d
    enc = -F.max_pool2d(enc, stride, stride)
    new_mask = F.max_pool2d(mask, stride, stride)
    return enc - (1 - new_mask) * large, new_mask


def geometry_feature(z, vnorm, unorm, h, w, ch, cw, fh, fw):
    x = z * (0.5 * h * (vnorm + 1) - ch) / fh
    y = z * (0.5 * w * (unorm + 1) - cw) / fw
    return torch.cat([x, y, z], 1)


RGB_ENC = [(1, 32, 64, 2), (2, 64, 64, 1), (3, 64, 128, 2),
           (4, 128, 128, 1), (5, 128, 256, 2), (6, 256, 256, 1),
           (7, 256, 512, 2), (8, 512, 512, 1), (9, 512, 1024, 2),
           (10, 1024, 1024, 1)]
D_IN = {3: 128, 5: 256, 7: 512, 9: 1024}


class ENet(nn.Module):
    def __init__(self):
        super().__init__()
        self.rgb_init = ConvBnRelu(4, 32, 5)
        self.d_init = ConvBnRelu(2, 32, 5)
        for i, cin, cout, stride in RGB_ENC:
            setattr(self, f'rgb_enc{i}', BasicBlockGeo(cin, cout, stride))
            setattr(self, f'd_enc{i}',
                    BasicBlockGeo(D_IN.get(i, cin), cout, stride))
        for i, cin, cout in ((8, 1024, 512), (6, 512, 256), (4, 256, 128),
                             (2, 128, 64), (0, 64, 32)):
            setattr(self, f'rgb_dec{i}', DeconvBnRelu(cin, cout))
        self.rgb_out = DeconvBnRelu(32, 2, 3, 1)
        for i, cin, cout in ((1, 1024, 512), (2, 512, 256), (3, 256, 128),
                             (4, 128, 64), (5, 64, 32)):
            setattr(self, f'dec{i}', DeconvBnRelu(cin, cout))
        self.dec6 = ConvBnRelu(32, 2, 3)

    def forward(self, rgb, d, position, k_mat):
        unorm, vnorm = position[:, 0:1], position[:, 1:2]
        fh = k_mat[:, 1, 1].reshape(-1, 1, 1, 1)
        ch = k_mat[:, 1, 2].reshape(-1, 1, 1, 1)
        fw = k_mat[:, 0, 0].reshape(-1, 1, 1, 1)
        cw = k_mat[:, 0, 2].reshape(-1, 1, 1, 1)
        vs, us, ds, ms = [vnorm], [unorm], [d], [(d > 0).to(d.dtype)]
        for _ in range(5):
            vs.append(F.avg_pool2d(vs[-1], 2, 2))
            us.append(F.avg_pool2d(us[-1], 2, 2))
            nd, nm = sparse_downsample_close(ds[-1], ms[-1])
            ds.append(nd)
            ms.append(nm)
        geos = [geometry_feature(ds[i], vs[i], us[i], CROP_H / 2 ** i,
                                 CROP_W / 2 ** i, ch, cw, fh, fw)
                for i in range(6)]

        def geo(i):
            return geos[i // 2], geos[(i + 1) // 2]

        rf = self.rgb_init(torch.cat([rgb, d], 1))
        r = [rf]
        for i in range(1, 11):
            r.append(getattr(self, f'rgb_enc{i}')(r[-1], *geo(i)))
        r8 = self.rgb_dec8(r[10]) + r[8]
        r6 = self.rgb_dec6(r8) + r[6]
        r4 = self.rgb_dec4(r6) + r[4]
        r2 = self.rgb_dec2(r4) + r[2]
        r0 = self.rgb_dec0(r2) + rf
        rgb_out = self.rgb_out(r0)
        rgb_depth, rgb_conf = rgb_out[:, 0:1], rgb_out[:, 1:2]

        skip = {3: r2, 5: r4, 7: r6, 9: r8}
        dd = [self.d_init(torch.cat([d, rgb_depth], 1))]
        for i in range(1, 11):
            inp = torch.cat([skip[i], dd[-1]], 1) if i in skip else dd[-1]
            dd.append(getattr(self, f'd_enc{i}')(inp, *geo(i)))
        x = self.dec1(r[10] + dd[10])
        x = self.dec2(dd[8] + x)
        x = self.dec3(dd[6] + x)
        dd4 = self.dec4(dd[4] + x)
        dd5 = self.dec5(dd[2] + dd4)
        d_out = self.dec6(dd5)
        d_depth, d_conf = d_out[:, 0:1], d_out[:, 1:2]
        conf = torch.softmax(torch.cat([rgb_conf, d_conf], 1), 1)
        coarse = conf[:, 0:1] * rgb_depth + conf[:, 1:2] * d_depth
        return torch.cat([r0, dd5], 1), torch.cat([r2, dd4], 1), coarse


class CSPNGuide(nn.Module):
    """The k^2 propagation weights: the k^2 - 1 generated ones over their
    abs-sum, and the centre weight 1 - their sum, in tap order."""

    def __init__(self, cin, kernel_size):
        super().__init__()
        self.kernel_size = kernel_size
        self.generate = ConvBnRelu(cin, kernel_size ** 2 - 1, 3,
                                   use_relu=False)

    def forward(self, feature):
        guide = self.generate(feature)
        gsum = guide.abs().sum(1, keepdim=True)
        guide = guide / torch.where(gsum == 0, torch.ones_like(gsum), gsum)
        mid = 1.0 - guide.sum(1, keepdim=True)
        half = (self.kernel_size ** 2 - 1) // 2
        return torch.cat([guide[:, :half], mid, guide[:, half:]], 1)


def nn_up(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def shift2d(x, dy, dx):
    """out[..., i, j] = x[..., i - dy, j - dx], zero outside."""
    h, w = x.shape[-2:]
    out = torch.zeros_like(x)
    if abs(dy) >= h or abs(dx) >= w:
        return out
    ys, yd = (slice(0, h - dy), slice(dy, h)) if dy >= 0 else \
        (slice(-dy, h), slice(0, h + dy))
    xs, xd = (slice(0, w - dx), slice(dx, w)) if dx >= 0 else \
        (slice(-dx, w), slice(0, w + dx))
    out[..., yd, xd] = x[..., ys, xs]
    return out


def cspn_step(guide, hn, h0, k, dilation):
    """sum over taps t of shift(g_t * src_t): src is h0 at the centre tap
    and hn elsewhere."""
    half = k // 2
    out = torch.zeros_like(hn)
    t = 0
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            src = h0 if (dy == 0 and dx == 0) else hn
            out = out + shift2d(guide[:, t:t + 1] * src, dy * dilation,
                                dx * dilation)
            t += 1
    return out


def cspn_iteration(guides, ds, h0, mask, dsparse, dilation, half_res):
    if half_res:
        guides = [nn_up(g) for g in guides]
        mask, dsparse = nn_up(mask), nn_up(dsparse)
    return tuple(mask * dsparse + (1 - mask) * cspn_step(g, d, h0, k,
                                                         dilation)
                 for k, g, d in zip(KERNEL_SIZES, guides, ds))


class PENetC2(nn.Module):
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
        coarse = p['coarse']
        ds = (coarse,) * 3
        for _ in range(self.iters):
            ds = cspn_iteration(p['guides_s2'], ds, coarse, p['mask_s2'],
                                p['d_s2'], 2, True)
        kc = [nn_up(p['kconf_s2'][:, i:i + 1]) for i in range(3)]
        depth_s2 = kc[0] * ds[0] + kc[1] * ds[1] + kc[2] * ds[2]
        ds = (depth_s2,) * 3
        for _ in range(self.iters):
            ds = cspn_iteration(p['guides'], ds, depth_s2, p['mask'],
                                p['d'], 1, False)
        kconf = p['kconf']
        return (kconf[:, 0:1] * ds[0] + kconf[:, 1:2] * ds[1]
                + kconf[:, 2:3] * ds[2])

    def forward(self, rgb, d, position, k_mat):
        return self.propagate(self.heads(rgb, d, position, k_mat))


def _tf32(x):
    """``x`` (float32) rounded to the nearest value with a 10-bit
    mantissa."""
    i = x.detach().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def tf32_operands(model):
    """Every conv of ``model`` on TF32-rounded inputs and weights inside
    the block; the weights are put back after it."""
    convs = [m for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    saved = [m.weight.detach().clone() for m in convs]
    handles = [m.register_forward_pre_hook(
        lambda m, args: (_tf32(args[0]),) + tuple(args[1:])) for m in convs]
    with torch.no_grad():
        for m in convs:
            m.weight.copy_(_tf32(m.weight))
    try:
        yield
    finally:
        for h in handles:
            h.remove()
        with torch.no_grad():
            for m, w in zip(convs, saved):
                m.weight.copy_(w)
