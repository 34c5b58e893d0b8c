"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line.

Serving (``mode`` 'infer') drives ``virconv_tpu_torch.serve.Detector``
with one client in a closed loop; training ('train') drives
``virconv_tpu_torch.train.trainer.Trainer.step``. The program runs at its
defaults, with weights that the benchmark made from the seed.
"""

from __future__ import annotations

import copy
import gc
import gzip
import json
import os
import time

import numpy as np
import torch

from . import judge, spec, weights
from .capture import Capture
from .trace import summarize
from .traffic import Traffic

WARM = 1 << 40          # item indices of the warm-up requests and steps
CALIBRATE = WARM - 1    # the item of the batch-norm calibration
SAMPLE = 3              # requests the check draws, besides the longest
PROFILED = {'infer': 3, 'train': 1}
STAGES = ('make_batch', 'voxelize', 'backbone_3d', 'bev', 'rpn',
          'roi_head', 'postprocess_wbf', 'loss', 'backward',
          'allreduce_grads', 'optimizer')


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


def program_counters():
    """The program's branch counters (sparse conv routes, ROI pool routes),
    copied."""
    from virconv_tpu_torch.models.roi_heads import voxel_pool
    from virconv_tpu_torch.ops import sparse
    return (dict(sparse.branch_counts), dict(voxel_pool.branch_counts))


def counter_delta(before, after):
    return [{k: after[i].get(k, 0) - before[i].get(k, 0)
             for k in after[i]} for i in range(2)]


class Profiled:
    """``torch.profiler`` around items ``start`` .. ``start + n`` of a
    traced run, inside a ``bench_window`` span."""

    def __init__(self, start, n, path):
        self.start, self.n, self.path = start, n, path
        self.prof = self.window = None
        self.trace = None
        self.done = False

    def covers(self, i):
        return self.start <= i < self.start + self.n

    def before(self, i, device):
        if i == self.start:
            from torch.profiler import ProfilerActivity, profile
            sync(device)
            self.counters0 = program_counters()
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
                                          program_counters())
            self.done = True

    def finish(self):
        """Write the trace and read it, once the window has closed."""
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        with gzip.open(self.path, 'rt') as f:
            self.trace = summarize(json.load(f), STAGES)


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


def _cfgs(cell):
    from refnet.config import CfgNode as RefCfg
    from virconv_tpu_torch.config import CfgNode as ProgCfg
    d = cell.config['config']
    return ProgCfg(copy.deepcopy(d)), RefCfg(copy.deepcopy(d)), d


def count_work(run_forward, model, device):
    """The reference's tally and dense operation counts of one forward,
    its pool groups also split by grid pool call (``pool_calls``)."""
    from refnet.tally import Tally
    from .capture import pool_modules
    from .work import dense_counter
    counter = dense_counter(model)
    counter['on'] = True
    t = Tally()
    starts = []
    handles = counter['handles'] + [
        m.register_forward_pre_hook(lambda *_: starts.append(len(t.pools)))
        for _, m in pool_modules(model)]
    try:
        with t:
            run_forward()
    finally:
        for h in handles:
            h.remove()
    ends = starts[1:] + [len(t.pools)]
    return {'convs': t.convs, 'pools': t.pools, 'gathers': t.gathers,
            'pool_calls': [t.pools[a:b] for a, b in zip(starts, ends)],
            'dense': {'conv': counter['conv'], 'linear': counter['linear']}}


def run_cell(cell, args, device, t_start, bench_dir, hooks=None):
    mode = cell.traffic['mode']
    fn = run_infer if mode == 'infer' else run_train
    return fn(cell, args, device, t_start, bench_dir, hooks or {})


def _summary(cell, prof, works, host_s, frames, tf32, pool_branch=None):
    return {'mode': cell.traffic['mode'], 'items': prof.n, 'frames': frames,
            'trace': prof.trace, 'work': works, 'item_host_s': host_s,
            'tf32': tf32, 'branch_counts': prof.counters[0],
            'pool_counts': prof.counters[1], 'pool_branch': pool_branch}


FEATS = ('bev', 'pooled', 'stage_cls', 'stage_reg')


def run_infer(cell, args, device, t_start, bench_dir, hooks):
    from virconv_tpu_torch.models.roi_heads import voxel_pool
    from virconv_tpu_torch.serve import Detector
    from refnet.runner import RefDetector
    pcfg, rcfg, cfg_dict = _cfgs(cell)
    traffic = Traffic(cell.traffic, cfg_dict, args.seed)
    # the reference, and the batch norms' calibration by one of its
    # forwards, are the check's work: their seconds are not set-up's
    t_ref = time.perf_counter()
    ref = RefDetector(rcfg, weights.make_state_dict(rcfg, args.seed, device),
                      device)
    calib = traffic.item(CALIBRATE)
    sd = weights.calibrate_bn(ref.model, lambda: ref.forward(calib))
    sync(device)
    ref_s = time.perf_counter() - t_ref
    det = Detector(cfg=pcfg, state_dict=weights.clone(sd), device=device)
    if 'detector' in hooks:
        det = hooks['detector'](det)
    tf32 = {'cudnn': torch.backends.cudnn.allow_tf32,
            'matmul': torch.backends.cuda.matmul.allow_tf32}
    warm = 0.0
    for k in range(2):
        frames = traffic.item(WARM + k)
        t = time.perf_counter()
        det(frames)
        sync(device)
        warm = time.perf_counter() - t
    n_lo = max(SAMPLE + 1, int(0.5 * args.seconds / max(warm, 1e-3)))
    rs = np.random.default_rng([args.seed, 2 ** 33])
    sample = set(int(i) for i in rs.choice(n_lo, SAMPLE, replace=False))
    sample.add(max(range(n_lo), key=traffic.size))
    prof = Profiled(max(1, n_lo // 3), PROFILED['infer'], os.path.join(
        bench_dir, 'out', f'{cell.name}.{args.seed}.trace.json.gz')) \
        if args.trace else None
    cap = Capture(det.model, branches=voxel_pool.branch_counts)
    served, items, host_s = {}, {}, []
    made = Items(traffic, 0, args.seconds, warm)
    reset_peak(device)
    sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start - ref_s
    i = 0
    while True:
        frames = made(i)
        cap.armed = i in sample or (prof is not None and prof.covers(i))
        if prof is not None:
            prof.before(i, device)
        t = time.perf_counter()
        res = det(frames)
        if prof is not None and prof.covers(i):
            prof.after(i, device)
        else:
            host_s.append(time.perf_counter() - t)
        if cap.armed:
            items[i] = cap.items.pop()
            served[i] = res
            if i not in sample:     # profiled only: no features to keep
                for key in FEATS:
                    items[i].pop(key, None)
        i += 1
        if time.perf_counter() - t0 >= args.seconds and (
                prof is None or prof.done):
            break
    sync(device)
    window_s = time.perf_counter() - t0
    n_done = i
    peak = peak_bytes(device)
    del made
    cap.armed = True
    for k in sorted(j for j in sample if j >= n_done):
        # a sampled request the window did not reach: served after it,
        # outside the metrics, so that the check sees as many requests
        items[k], served[k] = None, det(traffic.item(k))
        items[k] = cap.items.pop()
    cap.remove()
    del det, cap
    free(device)

    reference_precision()
    numbers = {}
    for k in sorted(sample):
        for name, v in judge.judge_request(ref, traffic.item(k), items[k],
                                           served[k]).items():
            numbers[name] = max(numbers.get(name, 0.0), v)
    result = {'correct': None, 'attempted': n_done, 'failed': 0}
    frames_per = traffic.frames
    if prof is None:
        metrics = {'infer_frames_per_s': n_done * frames_per / window_s,
                   'setup_s': setup_s}
        result['metrics'] = {m['name']: {'value': metrics[m['name']],
                                         'unit': m['unit']}
                             for m in cell.end_to_end}
    else:
        prof.finish()
        works = []
        for k in range(prof.start, prof.start + prof.n):
            with judge.following(ref.model, items[k]):
                works.append(count_work(lambda: ref.forward(traffic.item(k)),
                                        ref.model, device))
        summary = _summary(cell, prof, works, host_s, frames_per, tf32,
                           [items[k].get('pool_branch', []) for k in
                            range(prof.start, prof.start + prof.n)])
        result['metrics'] = per_layer(cell, summary, bench_dir)
        result['breakdown'] = prof.trace['breakdown']
        result['counters'] = {'branch': summary['branch_counts'],
                              'pool': summary['pool_counts']}
    result['device'] = device_info(device, peak)
    if prof is not None:
        result['device'].update(busy_s=prof.trace['busy_s'],
                                window_s=prof.trace['window_s'])
    return finish(result, numbers, cell, bench_dir)


def finish(result, numbers, cell, bench_dir):
    checks = checks_of(numbers, limits_of(cell, bench_dir))
    result['correct'] = all(c['value'] <= c['limit'] for c in checks.values())
    result['checks'] = checks
    return result


def run_train(cell, args, device, t_start, bench_dir, hooks):
    from virconv_tpu_torch.train.trainer import Trainer
    from refnet.runner import RefTrainer
    pcfg, rcfg, cfg_dict = _cfgs(cell)
    total = int(cell.traffic['total_steps'])
    sd = weights.make_state_dict(rcfg, args.seed, device)
    traffic = Traffic(cell.traffic, cfg_dict, args.seed)
    trainer = Trainer(cfg=pcfg, state_dict=weights.clone(sd), device=device,
                      seed=args.seed, total_steps=total)
    step = hooks.get('step', lambda tr, batch: tr.step(batch))
    tf32 = {'cudnn': torch.backends.cudnn.allow_tf32,
            'matmul': torch.backends.cuda.matmul.allow_tf32}
    params = lambda: {n: p.detach().clone()
                      for n, p in trainer.model.named_parameters()}
    cap = Capture(trainer.model, keep_feats=False)
    cap.armed = True
    side = {'p0': params(), 'losses': []}
    first = 0.0
    for t in range(3):      # the checked steps, which warm up too
        tt = time.perf_counter()
        loss, _ = step(trainer, traffic.item(t))
        sync(device)
        first = time.perf_counter() - tt
        side['losses'].append(float(loss))
        if t == 0:
            side['grads'] = {n: (p.grad if p.grad is not None else
                                 torch.zeros_like(p)).detach().clone()
                             for n, p in trainer.model.named_parameters()}
    side['p3'] = params()
    side['items'] = cap.items
    cap.items = []
    cap.armed = False
    n_lo = max(2, int(0.5 * args.seconds / max(first, 1e-3)))
    prof = Profiled(3 + max(1, n_lo // 3), PROFILED['train'], os.path.join(
        bench_dir, 'out', f'{cell.name}.{args.seed}.trace.json.gz')) \
        if args.trace else None
    host_s, prof_item = [], None
    made = Items(traffic, 3, args.seconds, first)
    reset_peak(device)
    sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    i = 3
    while True:
        batch = made(i)
        cap.armed = prof is not None and prof.covers(i)
        if prof is not None:
            prof.before(i, device)
        t = time.perf_counter()
        step(trainer, batch)
        sync(device)
        if prof is not None and prof.covers(i):
            prof.after(i, device)
            prof_item = (i, cap.items.pop())
        else:
            host_s.append(time.perf_counter() - t)
        i += 1
        if time.perf_counter() - t0 >= args.seconds and (
                prof is None or prof.done):
            break
    window_s = time.perf_counter() - t0
    n_done = i - 3
    window_peak = peak_bytes(device)
    del made
    peak = max(window_peak, peak_bytes(device))
    cap.remove()
    del trainer, cap
    free(device)

    reference_precision()
    ref = RefTrainer(rcfg, weights.clone(sd), device, args.seed, total)
    numbers, _ = judge.judge_steps(ref, [traffic.item(t) for t in range(3)],
                                   side)
    result = {'correct': None, 'attempted': n_done, 'failed': 0}
    frames_per = traffic.frames
    if prof is None:
        metrics = {'train_frames_per_s': n_done * frames_per / window_s,
                   'peak_mem_gib': window_peak / 2 ** 30,
                   'setup_s': setup_s}
        result['metrics'] = {m['name']: {'value': metrics[m['name']],
                                         'unit': m['unit']}
                             for m in cell.end_to_end}
    else:
        prof.finish()
        k, item = prof_item
        with judge.following(ref.model, item):
            works = [count_work(lambda: ref.forward(traffic.item(k), k),
                                ref.model, device)]
        summary = _summary(cell, prof, works, host_s, frames_per, tf32)
        result['metrics'] = per_layer(cell, summary, bench_dir)
        result['breakdown'] = prof.trace['breakdown']
        result['counters'] = {'branch': summary['branch_counts'],
                              'pool': summary['pool_counts']}
    result['device'] = device_info(device, peak)
    if prof is not None:
        result['device'].update(busy_s=prof.trace['busy_s'],
                                window_s=prof.trace['window_s'])
    return finish(result, numbers, cell, bench_dir)
