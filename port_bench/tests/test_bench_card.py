"""Each proven cell once on the card, untraced and traced, at 10 seconds:
the run exits 0 and its last line is a result with the cell's metrics
and a correct check. Skips without a card.

    python -m pytest port_bench/tests/test_bench_card.py -q
"""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

SPEC = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
CELLS = [w['name'] for w in SPEC['workloads']]


def reports(metric, cell):
    return 'workloads' not in metric or cell in metric['workloads']


@pytest.mark.cuda
@pytest.mark.parametrize('trace', [0, 1])
@pytest.mark.parametrize('cell', CELLS)
def test_cell_runs(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    proc = subprocess.run(
        [sys.executable, 'port_bench/run.py', '--workload', cell, '--seed',
         str(2 ** 31 + 901), '--seconds', '10', '--trace', str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['correct'], result['checks']
    assert result['device']['platform'] == 'gpu'
    if trace:
        assert result['device']['busy_s'] > 0
        assert set(result['metrics']) <= {m['name'] for m in SPEC['per_layer']
                                          if reports(m, cell)}
    else:
        assert set(result['metrics']) == {m['name']
                                          for m in SPEC['end_to_end']
                                          if reports(m, cell)}
