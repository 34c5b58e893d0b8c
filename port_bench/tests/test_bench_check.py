"""The check that decides ``correct``, driven through a whole run on the
CPU at the tiny sizes (the look for a card skipped): the program reads
correct; the control (the reference in the program's place in the
precision below the configuration's) and every planted fault read not
correct."""

import contextlib
import io
import json

import pytest

import calibrate
import run
from benchlib import faults

SEED = 2 ** 31 + 77


def run_cell(tiny_bench, cell, fault=None, trace=0):
    spec_path, bench_dir = tiny_bench
    mode = 'infer' if 'infer' in cell else 'train'
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(['--workload', cell, '--seed', str(SEED), '--seconds',
                       '2', '--trace', str(trace)], device='cpu',
                      spec_path=spec_path, bench_dir=bench_dir,
                      hooks=faults.hooks(mode, fault))
    assert rc == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(result)[-1] == 'checks'
    return result


@pytest.mark.parametrize('cell', ['tt_infer', 'tl_train'])
def test_program_is_correct(tiny_bench, cell):
    result = run_cell(tiny_bench, cell)
    assert result['correct'], result['checks']
    assert result['attempted'] >= 1 and 'setup_s' in result['metrics']


@pytest.mark.parametrize('cell,fault', [
    ('tt_infer', 'half_batch'), ('tt_infer', 'answer'),
    ('tt_infer', 'proposal'), ('tt_infer', 'late_stage'),
    ('tl_infer', 'late_stage'), ('tl_infer', 'query'),
    ('tt_train', 'unchanged'), ('tt_train', 'half_batch'),
    ('tt_train', 'answer'), ('tt_train', 'query')])
def test_fault_is_caught(tiny_bench, cell, fault):
    assert not run_cell(tiny_bench, cell, fault)['correct']


@pytest.mark.parametrize('cell', ['tt_infer', 'tt_train'])
def test_control_fails(tiny_bench, cell):
    spec_path, bench_dir = tiny_bench
    with contextlib.redirect_stdout(io.StringIO()):
        (line,) = calibrate.main(['--workload', cell, '--seeds', str(SEED),
                                  '--sides', 'control'], device='cpu',
                                 spec_path=spec_path, bench_dir=bench_dir)
    limits = json.load(open(f'{bench_dir}/limits/{cell}.json'))
    assert any(line['numbers'][k] > v for k, v in limits.items())


def test_traced_run_reads_layers(tiny_bench):
    result = run_cell(tiny_bench, 'tt_train', trace=1)
    assert 'backward_ms.train' in result['metrics']
    assert result['device']['window_s'] > 0
    assert 'idle_gaps' in result['breakdown']
