"""The benchmark as data: ``BENCHMARK.json`` at the checkout's root names
the cells, and each piece is found by its name under ``port_bench/``:
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py``. Adding a cell or a metric adds files and
entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    config: dict          # the configuration file: port_config, config, ...
    traffic: dict
    chips: int
    end_to_end: list      # metric entries of BENCHMARK.json
    per_layer: list


def _reports(metric, cell_name):
    return 'workloads' not in metric or cell_name in metric['workloads']


def load_cell(name: str, spec_path: str, bench_dir: str = HERE) -> Cell:
    with open(spec_path) as f:
        spec = json.load(f)
    cells = {w['name']: w for w in spec['workloads']}
    if name not in cells:
        raise KeyError(f'no workload {name!r} in {spec_path}: '
                       f'{sorted(cells)}')
    w = cells[name]
    conf = {c['name']: c for c in spec['configs']}[w['config']]
    with open(os.path.join(os.path.dirname(spec_path), conf['file'])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, 'traffic',
                           w['traffic'] + '.json')) as f:
        traffic = json.load(f)
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(w['chips']),
                end_to_end=[m for m in spec['end_to_end']
                            if _reports(m, name)],
                per_layer=[m for m in spec['per_layer']
                           if _reports(m, name)])


def metric_reader(name: str, bench_dir: str = HERE):
    """``read(summary) -> float | None`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, 'metrics', name + '.py')
    mod_spec = importlib.util.spec_from_file_location(
        'metric_' + name.replace('.', '_').replace('-', '_'), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
