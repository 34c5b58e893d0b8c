"""The port's tracing module (``virconv_tpu_torch/utils/trace.py``): off, a
span is a shared no-op; under ``torch.profiler`` the registry agrees with
the exported Chrome trace on every span's count and clock, for the tiny T
and L detectors' eval forward and training step; same-name nesting counts
once; CUDA's sync warnings are counted under the innermost span and their
site, print nothing, and the hooks are undone when tracing stops."""

import collections
import json
import threading
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from virconv_tpu_torch.configs.tiny import (tiny_config, tiny_l_config,
                                            tiny_l_train_config,
                                            tiny_train_config)
from virconv_tpu_torch.utils import trace
from virconv_tpu_torch.utils.bench_inputs import tiny_batch

CLOCK_US = 20.0      # registry interval inside its trace event, within


@pytest.fixture(autouse=True)
def fresh_registry():
    trace.reset()
    yield
    trace.reset()


def tiny_frames(seed):
    b = tiny_batch(np.random.default_rng(seed), n_entries=2, n_pts=300)
    return {k: b[k] for k in ('points', 'points_valid', 'points_mm',
                              'points_mm_valid', 'v2r', 'p2t')}


def eval_forward(cfg):
    from virconv_tpu_torch.serve import Detector
    det = Detector(cfg=cfg(), device='cpu', seed=0)
    frames = tiny_frames(0)
    return lambda: det(frames)


def train_step(cfg):
    from virconv_tpu_torch.train.trainer import Trainer
    tr = Trainer(cfg=cfg(), device='cpu', seed=0)
    batch = tiny_batch(np.random.default_rng(1), n_entries=2, n_pts=300,
                       train=True)
    return lambda: tr.step(batch)


def test_off_is_a_shared_noop(monkeypatch):
    def boom(*a, **k):
        raise AssertionError('called while tracing is off')

    class NoClock:
        time_ns = perf_counter = perf_counter_ns = time = boom

    monkeypatch.setattr(torch.profiler, 'record_function', boom)
    monkeypatch.setattr(trace, 'time', NoClock)
    assert trace.span('rpn') is trace.span('roi_head')
    with trace.span('rpn'), trace.span('rpn.nms'):
        pass
    eval_forward(tiny_l_config)()
    assert trace.snapshot()['spans'] == {}
    assert trace.snapshot()['timeline'] == {'spans': [], 'syncs': []}


PATHS = {'T eval': (eval_forward, tiny_config),
         'T train': (train_step, tiny_train_config),
         'L eval': (eval_forward, tiny_l_config),
         'L train': (train_step, tiny_l_train_config)}


@pytest.mark.parametrize('path', sorted(PATHS))
def test_registry_matches_the_profiler_trace(path, tmp_path):
    make, cfg = PATHS[path]
    run = make(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    snap = trace.snapshot()
    out = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(out))
    events = collections.defaultdict(list)
    for e in json.loads(out.read_text())['traceEvents']:
        if e.get('cat') == 'user_annotation':
            events[e['name']].append(e)
    new = {'sparse_plan', 'rpn.nms', 'roi_head.grid_pool'}
    if 'train' in path:
        new.add('rpn.anchor_targets')
    assert new <= set(snap['spans']) <= set(trace.SPANS)
    assert set(events) == set(snap['spans'])
    timeline = collections.defaultdict(list)
    for name, t0, t1 in snap['timeline']['spans']:
        timeline[name].append((t0, t1))
    for name, entry in snap['spans'].items():
        evs = sorted(events[name], key=lambda e: e['ts'])
        assert entry['calls'] == len(evs) == len(timeline[name]), name
        for (t0, t1), e in zip(sorted(timeline[name]), evs):
            assert e['ts'] - CLOCK_US <= t0 <= t1 \
                <= e['ts'] + e['dur'] + CLOCK_US, (name, t0, t1, e)
        assert entry['host_s'] == pytest.approx(
            sum(t1 - t0 for t0, t1 in timeline[name]) / 1e6, abs=1e-5)


def test_same_name_nesting_counts_once():
    with trace.recording():
        with trace.span('rpn'):
            with trace.span('rpn'):
                with trace.span('rpn.nms'):
                    pass
            with trace.span('rpn.nms'):
                pass
    spans = trace.snapshot()['spans']
    assert spans['rpn']['calls'] == 1
    assert spans['rpn.nms']['calls'] == 2


def warn_sync():
    warnings.warn(trace.SYNC_MESSAGE)
    return 'tests/test_torch_trace.py:%d' % (
        warn_sync.__code__.co_firstlineno + 1)


class FakeSyncMode:
    def __init__(self):
        self.mode, self.set_to = 0, []

    def get(self):
        return self.mode

    def set(self, mode):
        self.set_to.append(mode)


def test_sync_warnings_are_counted_and_silent(monkeypatch, capsys):
    fake = FakeSyncMode()
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
    monkeypatch.setattr(torch.cuda, 'get_sync_debug_mode', fake.get)
    monkeypatch.setattr(torch.cuda, 'set_sync_debug_mode', fake.set)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter('always')
        filters, show = list(warnings.filters), warnings.showwarning
        with trace.recording():
            with trace.span('roi_head'):
                with trace.span('roi_head.grid_pool'):
                    site = warn_sync()
                warnings.warn('another warning')
            warn_sync()                   # no program span open
            with trace.span('backward'):  # a thread with no span open
                th = threading.Thread(target=warn_sync)
                th.start()
                th.join(timeout=30)
            assert not th.is_alive()
        assert warnings.filters == filters
        assert warnings.showwarning is show
    assert [str(w.message) for w in seen] == ['another warning']
    assert capsys.readouterr().err == ''
    assert fake.set_to == ['warn', 0]
    snap = trace.snapshot()
    assert {n: e['syncs'] for n, e in snap['spans'].items()} == {
        'roi_head': 0, 'roi_head.grid_pool': 1, 'backward': 1}
    assert snap['sites'] == {site: 2}
    stamps = snap['timeline']['syncs']
    assert [s[1:] for s in stamps] == [('roi_head.grid_pool', site),
                                       ('backward', site)]
    (t0, t1), = [(a, b) for n, a, b in snap['timeline']['spans']
                 if n == 'roi_head.grid_pool']
    assert t0 <= stamps[0][0] <= t1


def test_profiler_stop_undoes_the_hooks_at_the_next_span():
    filters, show = list(warnings.filters), warnings.showwarning
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span('rpn'):
            warn_sync()
        assert warnings.showwarning is not show
    assert trace.snapshot()['spans']['rpn']['syncs'] == 1
    with trace.span('rpn'):
        pass
    assert warnings.filters == filters
    assert warnings.showwarning is show
    assert trace.snapshot()['spans']['rpn']['calls'] == 1
