"""BENCHMARK.json against the benchmark contract's rules: names, units,
keys, what each cell reports, and that every piece it names exists."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

SPEC = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


def test_top_level_keys():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= SPEC['run_seconds'] <= 51
    assert isinstance(SPEC['run_seconds'], int)
    assert SPEC['paths'] == ['port_bench']
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize('entry', SPEC['configs'] + SPEC['workloads']
                         + SPEC['end_to_end'] + SPEC['per_layer'],
                         ids=lambda e: e['name'])
def test_names_and_text(entry):
    assert NAME.match(entry['name'])
    for k in ('why', 'layer', 'source'):
        if k in entry:
            assert 1 <= len(entry[k]) <= 200 and '\n' not in entry[k] \
                and '\t' not in entry[k]
    if 'unit' in entry:
        assert UNIT.match(entry['unit'])
        assert entry['better'] in ('lower', 'higher')


def test_metric_keys_and_sources():
    for m in SPEC['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in SPEC['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['source'] in SOURCES
    assert 'setup_s' in {m['name'] for m in SPEC['end_to_end']}


def reports(metric, cell):
    return 'workloads' not in metric or cell in metric['workloads']


@pytest.mark.parametrize('cell', SPEC['workloads'], ids=lambda w: w['name'])
def test_cell_reports(cell):
    name = cell['name']
    e2e = {m['name'] for m in SPEC['end_to_end'] if reports(m, name)}
    assert 'setup_s' in e2e and len(e2e) >= 2
    layers = [m for m in SPEC['per_layer'] if reports(m, name)]
    assert layers
    for m in layers:
        assert m['moves'] in e2e, (m['name'], name)
    assert cell['chips'] in (1, 4)
    assert NAME.match(cell['config']) and NAME.match(cell['traffic'])


def test_pieces_exist():
    for c in SPEC['configs']:
        path = os.path.join(ROOT, c['file'])
        assert c['file'].startswith('port_bench/') and os.path.isfile(path)
        conf = json.load(open(path))
        assert conf['source'] == c['source']
        assert conf['reduced'] == c['reduced'] == []
    for w in SPEC['workloads']:
        traffic = os.path.join(BENCH, 'traffic', w['traffic'] + '.json')
        assert os.path.isfile(traffic)
        assert os.path.isfile(os.path.join(
            BENCH, 'modes', json.load(open(traffic))['mode'] + '.py'))
        assert os.path.isfile(os.path.join(BENCH, 'limits',
                                           w['name'] + '.json'))
    for m in SPEC['per_layer']:
        assert os.path.isfile(os.path.join(BENCH, 'metrics',
                                           m['name'] + '.py'))


def test_unique_names():
    for key in ('configs', 'workloads'):
        names = [e['name'] for e in SPEC[key]]
        assert len(names) == len(set(names))
    metrics = [m['name'] for m in SPEC['end_to_end'] + SPEC['per_layer']]
    assert len(metrics) == len(set(metrics))
    pairs = [(w['config'], w['traffic']) for w in SPEC['workloads']]
    assert len(pairs) == len(set(pairs))
