"""Operations and bytes of one PENet_C2 frame, for the virtual-point
cell's per-layer metrics.

ENet and its heads: every Conv2d and ConvTranspose2d of the reference's
``heads`` forward at 2 x MACs from its shapes (``work.dense_counter``),
all at float32 (the generator runs with TF32 off).

``cspn_iteration`` (``csrc/cspn.cu``, one launch per iteration and stage
for the three kernel sizes): per output pixel and kernel size k, 2 k^2
operations for the shifted sum and 4 for the blend with the sparse depth.
Bytes, each tensor read once and each output written once, at 4 bytes: the
guides (9 + 25 + 49 channels), the mask and the sparse depth at the
stage's resolution (a quarter of the pixels at the half-resolution
stage), the three previous depths and h0 at full resolution, the three new
depths. The first iteration of a stage reads one tensor for its three
previous depths and h0 (all the same one), which counts once.
"""

from __future__ import annotations

from . import work

GUIDE_CHANNELS = 9 + 25 + 49
OPS_PER_PIXEL = 2 * GUIDE_CHANNELS + 3 * 4


def cspn_ops_bytes(h, w, iters=6):
    """(operations, bytes) of one frame's 2 x ``iters`` iterations on an
    H x W crop."""
    hw = h * w
    ops = 2 * iters * OPS_PER_PIXEL * hw
    nbytes = 0.0
    for quarter in (True, False):
        stage = (GUIDE_CHANNELS + 2) * (hw / 4 if quarter else hw)
        for t in range(iters):
            depths = 1 if t == 0 else 4      # d3, d5, d7, h0
            nbytes += 4.0 * (stage + depths * hw + 3 * hw)
    return float(ops), nbytes


def enet_ops(model, inputs):
    """2 x MACs of every dense conv of ``model.heads(*inputs)``."""
    import torch
    counter = work.dense_counter(model)
    counter['on'] = True
    try:
        with torch.no_grad():
            model.heads(*inputs)
    finally:
        for h in counter['handles']:
            h.remove()
    return counter['conv'] + counter['linear']


def span_kernels(path, names):
    """{name: {'kernel_s', 'count'}} of the program spans ``names`` in the
    Chrome trace at ``path``: the device seconds of the kernels that run
    inside each of the span's device intervals (its
    ``gpu_user_annotation`` events, from its first kernel's start to its
    last one's end), summed, and the number of intervals. Copies and the
    gaps between kernels are not counted."""
    import bisect
    import gzip
    import json
    with gzip.open(path, 'rt') as f:
        ev = json.load(f)['traceEvents']
    kern = sorted((e['ts'], e['dur']) for e in ev
                  if e.get('cat') == 'kernel' and 'dur' in e)
    starts = [ts for ts, _ in kern]
    out = {}
    for e in ev:
        if e.get('cat') != 'gpu_user_annotation' or e.get('name') not in \
                names or 'dur' not in e:
            continue
        a, b = e['ts'], e['ts'] + e['dur']
        i = bisect.bisect_left(starts, a)
        sec = 0.0
        while i < len(kern) and kern[i][0] < b:
            sec += min(kern[i][0] + kern[i][1], b) - kern[i][0]
            i += 1
        o = out.setdefault(e['name'], {'kernel_s': 0.0, 'count': 0})
        o['kernel_s'] += sec / 1e6
        o['count'] += 1
    return out


def span_kernel_ms(s, name):
    """Kernel milliseconds per call of the program span ``name``
    (``span_kernels``); None without its device intervals."""
    if s['mode'] != 'vp':
        return None
    span = s.get('span_kernels', {}).get(name)
    if not span or not span['count'] or span['kernel_s'] <= 0:
        return None
    return 1e3 * span['kernel_s'] / span['count']
