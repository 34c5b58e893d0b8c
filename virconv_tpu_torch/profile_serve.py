"""What one traced request or step did on the card, from the Chrome trace
``torch.profiler`` exports: the device busy time, each program span's host
and device time, and the kernels with the most device time
(``chip_smoke.py``'s profiled request). The benchmark's ``port_bench/run.py
--trace 1`` traces requests and steps with the same spans.
"""

from __future__ import annotations

import collections

from .utils.trace import SPANS


def summarize(trace, wall_ms, top=15, stages=SPANS):
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
