"""PENet_C2's weights from ``--seed`` and their calibration, the reference
of the virtual-point cell, and the faults planted under the program.

Weights: fan-in-scaled normal kernels made on the device in one generator
call, batch-norm scales one and shifts zero, statistics zero mean and unit
variance (the leaves and shapes of ``refnet.penet.PENetC2``, whose names
are the program's). Calibration on one frame of the pool: every batch
norm's statistics set to the moments of its input (``weights.
calibrate_bn``); then the depth channel of the last batch norm of each of
the two depth outputs (``backbone.rgb_out``, ``backbone.dec6``) is scaled
and shifted so that its median and interquartile range are those of the
frame's sparse LiDAR depths, and the batch norms after it are calibrated
again. A trained PENet fills nearly the whole crop with depths in (0.1,
100) m; random weights would not, and then the host tail would do none of
a deployment's work.

Faults (``plant``): ``skip_iteration`` (the last full-resolution CSPN
iteration of every frame returns its input), ``no_guide_norm`` (the
guides' abs-sum normalisation left out), ``kconf_swap`` (the
half-resolution kernel confidences of kernels 3 and 7 swapped).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from . import weights

FAULTS = ('skip_iteration', 'no_guide_norm', 'kconf_swap')
DEPTH_OUTPUTS = ('backbone.rgb_out', 'backbone.dec6')


def make_state_dict(seed, device):
    from refnet.penet import PENetC2
    with torch.device('meta'):
        model = PENetC2()
    params = dict(model.named_parameters())
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    dense = [k for k in shapes if k in params and len(shapes[k]) >= 2]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(math.prod(shapes[k]) for k in dense),
                       generator=gen, device=device)
    sd, off = {}, 0
    for k in dense:
        n = math.prod(shapes[k])
        sd[k] = flat[off:off + n].view(shapes[k]) / math.sqrt(
            math.prod(shapes[k][1:]))
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
    return sd


def _quartiles(x):
    q1, q2, q3 = np.quantile(np.asarray(x, np.float64), [0.25, 0.5, 0.75])
    return float(q2), float(q3 - q1)


@torch.no_grad()
def calibrate(model, inputs, sparse):
    """Calibrate ``model`` (the reference, eval mode) on one frame's
    ``inputs`` and its sparse depth (module docstring); returns its
    state_dict."""
    def run():
        model.heads(*inputs)
    weights.calibrate_bn(model, run)
    median, spread = _quartiles(sparse[sparse > 0])
    for name in DEPTH_OUTPUTS:
        bn = model.get_submodule(name).BatchNorm_0
        bn.weight[0], bn.bias[0] = 1.0, 0.0
        seen = []
        h = bn.register_forward_hook(
            lambda m, i, o: seen.append(o[0, 0].flatten().cpu().numpy()))
        try:
            run()
        finally:
            h.remove()
        z_median, z_spread = _quartiles(seen[0])
        scale = spread / max(z_spread, 1e-6)
        bn.weight[0], bn.bias[0] = scale, median - scale * z_median
        weights.calibrate_bn(model, run)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def reference(frames, seed, device):
    """The reference on the seed's weights, calibrated on pool frame 0,
    and those weights."""
    from refnet.penet import PENetC2
    model = PENetC2().to(device).eval()
    model.load_state_dict(make_state_dict(seed, device))
    sd = calibrate(model, frames.inputs(0, device), frames.pool[0][2])
    return model, sd


class _SkipLast:
    """``cspn_iteration`` whose last call of each frame's 2 x ``iters``
    returns the previous depths."""

    def __init__(self, fn, per_frame):
        self.fn, self.per_frame, self.calls = fn, per_frame, 0

    def __call__(self, guides, ds, *args, **kw):
        self.calls += 1
        if self.calls % self.per_frame == 0:
            return ds
        return self.fn(guides, ds, *args, **kw)


def _unnormalized(self, feature):
    guide = self.generate(feature)
    mid = 1.0 - guide.sum(1, keepdim=True)
    half = (self.kernel_size ** 2 - 1) // 2
    return torch.cat([guide[:, :half], mid, guide[:, half:]], 1)


@contextlib.contextmanager
def plant(model, fault):
    """The program's PENetC2 ``model`` under ``fault`` inside the block."""
    import types
    from virconv_tpu_torch.models.depth_completion import penet
    undo = []
    if fault == 'skip_iteration':
        prev = penet.cspn_iteration
        penet.cspn_iteration = _SkipLast(prev, 2 * model.iters)
        undo.append(lambda: setattr(penet, 'cspn_iteration', prev))
    elif fault == 'no_guide_norm':
        for m in model.modules():
            if isinstance(m, penet.CSPNGuide):
                m.forward = types.MethodType(_unnormalized, m)
                undo.append(lambda m=m: delattr(m, 'forward'))
    elif fault == 'kconf_swap':
        h = model.kconf_s2.register_forward_hook(
            lambda m, i, o: o[:, [2, 1, 0]])
        undo.append(h.remove)
    elif fault is not None:
        raise ValueError(f'unknown fault {fault!r}: {FAULTS}')
    try:
        yield
    finally:
        for u in undo:
            u()
