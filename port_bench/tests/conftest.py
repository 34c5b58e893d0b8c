"""The benchmark's own tests (``python -m pytest port_bench/tests``): CPU
tests at tiny sizes, and card tests marked ``cuda`` that skip without a
card."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line('markers',
                            'cuda: needs a CUDA card; skips without one')


@pytest.fixture
def tiny_bench(tmp_path):
    """A benchmark directory of the tiny cells: the shipped metric and
    mode files, tiny traffic and limits; returns (spec path, bench dir)."""
    data = os.path.join(BENCH, 'tests', 'data')
    for name, src in (('metrics', os.path.join(BENCH, 'metrics')),
                      ('modes', os.path.join(BENCH, 'modes')),
                      ('traffic', os.path.join(data, 'traffic')),
                      ('limits', os.path.join(data, 'limits'))):
        os.symlink(src, tmp_path / name)
    return os.path.join(data, 'bench_tiny.json'), str(tmp_path)
