"""What every run mode shares (``modes/<mode>.py``, found by the traffic's
``mode``): the window's items, the traced stretch, the per-layer metrics,
the check against the limits and the result line, and the device's
numbers. A mode brings the program, its reference and its spans and
counters as arguments; nothing here knows a model.
"""

from __future__ import annotations

import gc
import gzip
import json
import os
import time

import torch

from . import judge, spec
from .trace import summarize

WARM = 1 << 40          # item indices of the warm-up requests and steps


class Items:
    """The window's requests or steps, made before it opens: about
    ``AHEAD`` times as many as the warm-up's pace fits in the window, and
    any further one on demand, so that the window times the system and
    not the client's numpy."""

    AHEAD = 1.25

    def __init__(self, traffic, first, seconds, pace_s):
        n = int(self.AHEAD * seconds / max(pace_s, 1e-3)) + 2
        self.traffic, self.first = traffic, first
        self.made = [traffic.item(first + k) for k in range(n)]

    def __call__(self, i):
        k = i - self.first
        if 0 <= k < len(self.made):
            item, self.made[k] = self.made[k], None
            return item
        return self.traffic.item(i)


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def counter_delta(before, after):
    return [{k: a.get(k, 0) - b.get(k, 0) for k in a}
            for b, a in zip(before, after)]


class Profiled:
    """``torch.profiler`` around items ``start`` .. ``start + n`` of a
    traced run, inside a ``bench_window`` span; the trace's summary keeps
    the program's spans named in ``stages``, and ``counters()`` (a tuple
    of the program's counter dicts) is read before and after."""

    def __init__(self, cell, args, bench_dir, start, n, stages,
                 counters=tuple):
        self.start, self.n = start, n
        self.path = os.path.join(bench_dir, 'out',
                                 f'{cell.name}.{args.seed}.trace.json.gz')
        self.stages, self.program_counters = stages, counters
        self.prof = self.window = None
        self.trace = None
        self.done = False

    def covers(self, i):
        return self.start <= i < self.start + self.n

    def before(self, i, device):
        if i == self.start:
            from torch.profiler import ProfilerActivity, profile
            sync(device)
            self.counters0 = self.program_counters()
            acts = [ProfilerActivity.CPU]
            if torch.device(device).type == 'cuda':
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.window = torch.profiler.record_function('bench_window')
            self.window.__enter__()

    def after(self, i, device):
        if i == self.start + self.n - 1:
            sync(device)
            self.window.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.counters = counter_delta(self.counters0,
                                          self.program_counters())
            self.done = True

    def finish(self):
        """Write the trace and read it, once the window has closed."""
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        with gzip.open(self.path, 'rt') as f:
            self.trace = summarize(json.load(f), self.stages)


def window(made, i, seconds, device, prof, serve, keep=None):
    """The measured window: ``serve(i, item)`` on the items from ``i`` on,
    each timed on the host clock outside the traced stretch and then given
    with its output to ``keep``, until ``seconds`` have passed and the
    traced stretch is done. Returns its start, its seconds, the index past
    the last item, and the host seconds of each timed item."""
    host_s = []
    reset_peak(device)
    sync(device)
    t0 = time.perf_counter()
    while True:
        item = made(i)
        if prof is not None:
            prof.before(i, device)
        t = time.perf_counter()
        out = serve(i, item)
        if prof is not None and prof.covers(i):
            prof.after(i, device)
        else:
            host_s.append(time.perf_counter() - t)
        if keep is not None:
            keep(i, out)
        i += 1
        if time.perf_counter() - t0 >= seconds and (
                prof is None or prof.done):
            break
    sync(device)
    return t0, time.perf_counter() - t0, i, host_s


def device_info(device, peak):
    if torch.device(device).type == 'cuda':
        return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                'count': 1, 'memory_peak_bytes': int(peak)}
    return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
            'memory_peak_bytes': int(peak)}


def peak_bytes(device):
    if torch.device(device).type == 'cuda':
        return torch.cuda.max_memory_allocated()
    return 0


def reset_peak(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.reset_peak_memory_stats()


def free(device):
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()


def reference_precision():
    """The reference computes in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def limits_of(cell, bench_dir):
    with open(os.path.join(bench_dir, 'limits', cell.name + '.json')) as f:
        return json.load(f)


def checks_of(numbers, limits):
    """Each held number beside its limit; one the check could not read
    counts as a mismatch."""
    return {k: {'value': numbers.get(k, judge.MISMATCH), 'limit': limits[k]}
            for k in limits}


def per_layer(cell, summary, bench_dir):
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m['name'], bench_dir)(summary)
        if value is not None:
            out[m['name']] = {'value': float(value), 'unit': m['unit']}
    return out


def run_cell(cell, args, device, t_start, bench_dir, hooks=None):
    return spec.run_mode(cell.traffic['mode'], bench_dir).run(
        cell, args, device, t_start, bench_dir, hooks or {})


def finish(cell, bench_dir, device, n_done, peak, numbers, prof=None,
           metrics=None, summary=None, extra=None):
    """The result line: an untraced run's end-to-end ``metrics``, or a
    traced run's per-layer metrics read from ``summary`` with the trace's
    breakdown and ``extra``; the device; ``checks`` last."""
    result = {'correct': None, 'attempted': n_done, 'failed': 0}
    if prof is None:
        result['metrics'] = {m['name']: {'value': metrics[m['name']],
                                         'unit': m['unit']}
                             for m in cell.end_to_end}
    else:
        result['metrics'] = per_layer(cell, summary, bench_dir)
        result['breakdown'] = prof.trace['breakdown']
        result.update(extra or {})
    result['device'] = device_info(device, peak)
    if prof is not None:
        result['device'].update(busy_s=prof.trace['busy_s'],
                                window_s=prof.trace['window_s'])
    checks = checks_of(numbers, limits_of(cell, bench_dir))
    result['correct'] = all(c['value'] <= c['limit'] for c in checks.values())
    result['checks'] = checks
    return result
