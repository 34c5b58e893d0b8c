"""The metrics read from the program's tracing module
(``benchlib/program_trace.py``): each metric file on a hand-built summary
and snapshot, the sync idle split on a kernel sequence with known gaps,
None from a program without the module, the registry of a tiny traced run
on the CPU, and on a card a 10 s traced t_infer_b2 (skips without one)."""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

import run
from benchlib import program_trace, spec
from conftest import ROOT

NAMES = ('host_syncs_per_frame', 'sync_idle_share', 'sparse_plan_ms',
         'rpn_nms_ms', 'roi_grid_pool_ms')

# five kernels merged into [0, 15], [30, 40], [100, 120], [125, 130]
# (microseconds): idle gaps 15, 60 and 5; sync stamps in the first and the
# last, one before the first kernel and one after the last
KERNELS = [(0.0, 'a', 10e-6), (5.0, 'b', 10e-6), (30.0, 'c', 10e-6),
           (100.0, 'd', 20e-6), (125.0, 'e', 5e-6)]
STAMPS = [20.0, 123.0, 124.0, -5.0, 200.0]

SNAPSHOT = {
    'spans': {
        'backbone_3d': {'calls': 3, 'host_s': 0.3, 'syncs': 6},
        'sparse_plan': {'calls': 60, 'host_s': 0.12, 'syncs': 30},
        'rpn': {'calls': 3, 'host_s': 0.09, 'syncs': 0},
        'rpn.nms': {'calls': 3, 'host_s': 0.06, 'syncs': 12},
        'roi_head.grid_pool': {'calls': 24, 'host_s': 0.15, 'syncs': 0}},
    'sites': {'virconv_tpu_torch/ops/sparse.py:1': 30,
              'virconv_tpu_torch/ops/boxes.py:2': 12,
              'virconv_tpu_torch/models/layers.py:3': 6},
    'timeline': {'spans': [], 'syncs': [(t, 'sparse_plan', 's')
                                        for t in STAMPS]}}


def summary(mode, kernels=KERNELS):
    return {'mode': mode, 'items': 3, 'frames': 2,
            'trace': {'kernel_seq': kernels}}


EXPECTED = {'host_syncs_per_frame': 48 / 6, 'sync_idle_share': 25.0,
            'sparse_plan_ms': 40.0, 'rpn_nms_ms': 20.0,
            'roi_grid_pool_ms': 50.0}


@pytest.mark.parametrize('mode', ['infer', 'train'])
@pytest.mark.parametrize('name', NAMES)
def test_metric_file_reads_the_snapshot(name, mode, monkeypatch):
    monkeypatch.setattr(program_trace, 'program_snapshot',
                        lambda: SNAPSHOT)
    read = spec.metric_reader(f'{name}.{mode}')
    assert read(summary(mode)) == pytest.approx(EXPECTED[name])
    other = 'train' if mode == 'infer' else 'infer'
    assert read(summary(other)) is None


def test_sync_idle_split():
    idle, sync = program_trace.sync_idle(KERNELS, STAMPS)
    assert (idle, sync) == (80.0, 20.0)
    assert program_trace.sync_idle(KERNELS, []) == (80.0, 0.0)
    # a stamp on a gap's edge is inside it
    assert program_trace.sync_idle(KERNELS, [40.0])[1] == 60.0


@pytest.mark.parametrize('name', NAMES)
def test_program_without_the_module_gives_none(name, monkeypatch):
    import virconv_tpu_torch.utils as utils
    monkeypatch.delattr(utils, 'trace', raising=False)
    monkeypatch.setitem(sys.modules, 'virconv_tpu_torch.utils.trace', None)
    assert program_trace.program_snapshot() is None
    for mode in ('infer', 'train'):
        assert spec.metric_reader(f'{name}.{mode}')(summary(mode)) is None


def test_tiny_traced_run_reads_the_registry(tiny_bench, tmp_path):
    """The tiny T serving cell, traced on the CPU, with the new metrics
    listed: the spans' metrics read the profiled requests' registry, the
    sync count reads 0 (no CUDA), the idle split nothing (no kernel)."""
    spec_path, bench_dir = tiny_bench
    doc = json.load(open(spec_path))
    for c in doc['configs']:
        c['file'] = os.path.join(os.path.dirname(spec_path), c['file'])
    doc['per_layer'] += [{'name': f'{n}.infer', 'unit': 'x',
                          'workloads': ['tt_infer']} for n in NAMES]
    path = tmp_path / 'bench.json'
    path.write_text(json.dumps(doc))
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(['--workload', 'tt_infer', '--seed', str(2 ** 31 + 5),
                       '--seconds', '2', '--trace', '1'], device='cpu',
                      spec_path=str(path), bench_dir=bench_dir)
    assert rc == 0
    metrics = json.loads(out.getvalue().strip().splitlines()[-1])['metrics']
    assert metrics['host_syncs_per_frame.infer']['value'] == 0.0
    assert 'sync_idle_share.infer' not in metrics
    for n in ('sparse_plan_ms', 'rpn_nms_ms', 'roi_grid_pool_ms'):
        assert metrics[f'{n}.infer']['value'] > 0
    assert metrics['rpn_nms_ms.infer']['value'] \
        <= metrics['rpn_ms.infer']['value']
    assert metrics['roi_grid_pool_ms.infer']['value'] \
        <= metrics['roi_head_ms.infer']['value']
    snap = program_trace.program_snapshot()
    assert snap['spans']['rpn']['calls'] == 3     # the profiled requests


@pytest.mark.cuda
def test_traced_t_infer_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    proc = subprocess.run(
        [sys.executable, 'port_bench/run.py', '--workload', 't_infer_b2',
         '--seed', str(2 ** 31 + 907), '--seconds', '10', '--trace', '1'],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['correct'], result['checks']
    metrics = result['metrics']
    assert {f'{n}.infer' for n in NAMES} <= set(metrics)
    assert metrics['host_syncs_per_frame.infer']['value'] > 0
