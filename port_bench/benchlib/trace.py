"""What the traced run reads from ``torch.profiler``'s Chrome trace.

The union of device intervals is the arithmetic of the program's
``profile_serve.summarize`` (kernel intervals merged in start order),
copied here and frozen; memcpy and memset count as device work too. The
window is the harness's own ``bench_window`` span around the profiled
requests or steps, so busy time and idle gaps are clipped to it.
"""

from __future__ import annotations

import collections

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
WINDOW = 'bench_window'


def union(intervals):
    """Total length of the union of (start, end) intervals, and the
    merged intervals in order."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def _innermost(ops, points):
    """For each time in ``points`` (ascending), the name of the host op
    (any thread) with the latest start that is open at that time."""
    out, open_, i = [], [], 0
    for t in points:
        while i < len(ops) and ops[i][0] <= t:
            open_.append(ops[i])
            i += 1
        open_ = [o for o in open_ if o[1] >= t]
        out.append(max(open_, key=lambda o: o[0])[2] if open_ else 'none')
    return out


def summarize(trace, stages, top=10):
    """Seconds and counts of the traced window: ``window_s``, ``busy_s``
    (union of device intervals in it), ``launches`` (kernels),
    ``kernels`` {name: [seconds, launches]} in stream order's first
    appearance, ``kernel_seq`` [(ts, name, seconds)], ``spans`` {stage:
    {'host_s', 'device_s', 'count'}}, and the ``breakdown`` lists."""
    ev = trace['traceEvents'] if isinstance(trace, dict) else trace
    wins = [e for e in ev if e.get('name') == WINDOW
            and e.get('cat') == 'user_annotation']
    if not wins:
        raise ValueError(f'no {WINDOW} span in the trace')
    w0 = min(e['ts'] for e in wins)
    w1 = max(e['ts'] + e['dur'] for e in wins)
    dev = [e for e in ev if e.get('cat') in DEVICE_CATS and 'dur' in e
           and e['ts'] < w1 and e['ts'] + e['dur'] > w0]
    busy, merged = union((max(e['ts'], w0), min(e['ts'] + e['dur'], w1))
                         for e in dev)
    kern = sorted((e for e in dev if e['cat'] == 'kernel'),
                  key=lambda e: e['ts'])
    kernels = {}
    for e in kern:
        k = kernels.setdefault(e['name'], [0.0, 0])
        k[0] += e['dur'] / 1e6
        k[1] += 1
    spans = {}
    for e in ev:
        if e.get('name') in stages and e.get('cat') in (
                'user_annotation', 'gpu_user_annotation') \
                and w0 <= e['ts'] <= w1:
            side = 'host_s' if e['cat'] == 'user_annotation' else 'device_s'
            s = spans.setdefault(e['name'], {'host_s': 0.0, 'device_s': 0.0,
                                             'count': 0})
            s[side] += e['dur'] / 1e6
            if side == 'host_s':
                s['count'] += 1
    # idle gaps inside the window, named by the innermost host op open
    # at the gap's start (the program's record_function spans included)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    ops = sorted((e['ts'], e['ts'] + e['dur'], e['name']) for e in ev
                 if e.get('cat') in ('cpu_op', 'user_annotation')
                 and 'dur' in e and e.get('name') != WINDOW)
    names = _innermost(ops, [a for a, _ in gaps])
    by_host = collections.Counter()
    for (a, b), n in zip(gaps, names):
        by_host[n[:100]] += (b - a) / 1e6
    return {
        'window_s': (w1 - w0) / 1e6, 'busy_s': busy / 1e6,
        'launches': len(kern), 'kernels': kernels,
        'kernel_seq': [(e['ts'], e['name'], e['dur'] / 1e6) for e in kern],
        'spans': spans,
        'breakdown': {
            'device_ops': sorted(([n[:100], v[0]] for n, v in
                                  kernels.items()),
                                 key=lambda x: -x[1])[:top],
            'idle_gaps': [[n, s] for n, s in by_host.most_common(top)]}}
