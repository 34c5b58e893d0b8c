"""Weights from ``--seed``, made on the device in one generator call.

The leaves and their shapes come from the reference model's state_dict
(built on the meta device, so nothing is allocated); the program's
checkpoint layout is the same. Kernels are fan-in-scaled normals, 1-D
weights (BN scales) ones, biases zero, BN statistics zero mean and unit
variance; the RPN's class bias takes the 0.01 prior and its box kernel is
scaled down, as the program's own seeded initialisation does.
"""

from __future__ import annotations

import math

import torch

from refnet.config import CfgNode
from refnet.models.detectors.voxel_rcnn import VoxelRCNN


def _fan_in(name, shape):
    leaf = name.rsplit('.', 1)[-1]
    if leaf == 'kernel' and len(shape) == 3:
        return shape[0] * shape[1]
    if leaf == 'kernel':
        return shape[0]
    return math.prod(shape[1:])


def make_state_dict(cfg: CfgNode, seed: int, device) -> dict:
    """The state_dict of ``cfg``'s VoxelRCNN, float32 on ``device``."""
    with torch.device('meta'):
        model = VoxelRCNN(cfg.MODEL, cfg.DATA_CONFIG,
                          num_class=len(cfg.CLASS_NAMES))
    params = dict(model.named_parameters())
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    dense = [k for k in shapes if k in params and len(shapes[k]) >= 2]
    total = sum(math.prod(shapes[k]) for k in dense)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    sd, off = {}, 0
    for k in dense:
        n = math.prod(shapes[k])
        sd[k] = flat[off:off + n].view(shapes[k]) / math.sqrt(
            _fan_in(k, shapes[k]))
        off += n
    for k, shape in shapes.items():
        if k in sd:
            continue
        leaf = k.rsplit('.', 1)[-1]
        if leaf == 'num_batches_tracked':
            sd[k] = torch.zeros(shape, dtype=torch.long, device=device)
        elif leaf in ('weight', 'running_var'):
            sd[k] = torch.ones(shape, device=device)
        else:
            sd[k] = torch.zeros(shape, device=device)
    if 'dense_head.conv_cls.bias' in sd:
        sd['dense_head.conv_cls.bias'].fill_(-math.log((1 - 0.01) / 0.01))
        w = sd['dense_head.conv_box.weight']
        sd['dense_head.conv_box.weight'] = w * (1e-3 * math.sqrt(w[0].numel()))
    return sd


def clone(sd: dict) -> dict:
    return {k: v.clone() for k, v in sd.items()}


@torch.no_grad()
def calibrate_bn(model, run_forward):
    """Set every batch norm's running statistics, in the order the data
    reaches them, to the moments of its input in one eval forward
    (``run_forward``), so that seeded weights give activations of a
    trained network's scale instead of ones that shrink layer by layer.
    Returns the model's state_dict."""
    from refnet.models.layers import FlaxBatchNorm2d, MaskedBatchNorm

    def masked(module, inputs):
        x, mask = inputs[0].float(), inputs[1]
        rows = x[mask] if bool(mask.any()) else x
        module.running_mean.copy_(rows.mean(0))
        module.running_var.copy_(rows.var(0, unbiased=False))

    def dense(module, inputs):
        x = inputs[0].float()
        module.running_mean.copy_(x.mean((0, 2, 3)))
        module.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    handles = []
    for m in model.modules():
        if isinstance(m, MaskedBatchNorm):
            handles.append(m.register_forward_pre_hook(masked))
        elif isinstance(m, FlaxBatchNorm2d):
            handles.append(m.register_forward_pre_hook(dense))
    try:
        run_forward()
    finally:
        for h in handles:
            h.remove()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
