"""Where the time of one full-width VirConv-T request goes, on one card.

    python -m virconv_tpu_torch.profile_serve [--out DIR]

Serves FRAMES synthetic frames twice to warm up (which builds the kernels),
then traces one request with ``torch.profiler`` (CPU + CUDA). Prints the
request's wall time, the device busy time (union of kernel intervals) and
its share of the wall time, each named stage's host and device span
(make_batch, voxelize, backbone_3d, bev, rpn, roi_head, postprocess_wbf)
and the kernels with the most device time. Writes the Chrome trace under
DIR (default chiprun_out/).
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import os
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

STAGES = ('make_batch', 'voxelize', 'backbone_3d', 'bev', 'rpn', 'roi_head',
          'postprocess_wbf')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default='chiprun_out')
    args = ap.parse_args(argv)

    from .serve import Detector
    from .utils.bench_inputs import FRAMES, synth_frames
    torch.set_grad_enabled(False)
    det = Detector(device='cuda', seed=0)
    frames = synth_frames(FRAMES)
    for _ in range(2):
        det(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det(frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, 'serve_trace.json.gz')
    prof.export_chrome_trace(path)
    with gzip.open(path, 'rt') as f:
        report = summarize(json.load(f), wall_ms)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    report.update(card=smi.splitlines()[0] if smi else
                  torch.cuda.get_device_name(0), frames=FRAMES)
    print(json.dumps(report, indent=1))


def summarize(trace, wall_ms, top=15, stages=STAGES):
    """Device busy time (union of kernel intervals), per-stage host and
    device spans of the named ``stages``, and the kernels with the most
    device time."""
    ev = trace['traceEvents'] if isinstance(trace, dict) else trace
    kernels = [e for e in ev if e.get('cat') == 'kernel']
    busy, end = 0.0, None
    for a, b in sorted((e['ts'], e['ts'] + e['dur']) for e in kernels):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e['name']][0] += e['dur'] / 1e3
        by_name[e['name']][1] += 1
    spans = {}
    for e in ev:
        if e.get('name') in stages and e.get('cat') in (
                'user_annotation', 'gpu_user_annotation'):
            side = 'host' if e['cat'] == 'user_annotation' else 'device'
            span = spans.setdefault(e['name'], {})
            span[side + '_ms'] = span.get(side + '_ms', 0.0) + e['dur'] / 1e3
    return {
        'request_wall_ms': wall_ms, 'kernel_launches': len(kernels),
        'device_busy_ms': busy / 1e3, 'device_busy_share': busy / 1e3
        / wall_ms, 'stages': spans,
        'top_kernels_ms_launches': sorted(
            ([n[:100], round(v[0], 3), v[1]] for n, v in by_name.items()),
            key=lambda x: -x[1])[:top]}


if __name__ == '__main__':
    main()
