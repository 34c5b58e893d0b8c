"""The benchmark as data: ``BENCHMARK.json`` at the checkout's root names
the cells, and each piece is found by its name under ``port_bench/``:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` and ``modes/<mode>.py`` (the traffic's ``mode``).
Adding a cell, a metric or a run mode adds files and entries; nothing
here names one."""

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


def _load(kind: str, name: str, bench_dir: str):
    """The module ``<kind>/<name>.py`` of the bench directory, by path."""
    path = os.path.join(bench_dir, kind, name + '.py')
    if not os.path.isfile(path):
        raise FileNotFoundError(f'no {kind} file for {name!r}: {path}')
    mod_spec = importlib.util.spec_from_file_location(
        f'{kind}_' + name.replace('.', '_').replace('-', '_'), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = HERE):
    """``read(summary) -> float | None`` of ``metrics/<name>.py``."""
    return _load('metrics', name, bench_dir).read


def run_mode(name: str, bench_dir: str = HERE):
    """The run mode ``modes/<name>.py`` that a traffic file's ``mode``
    names: ``run(cell, args, device, t_start, bench_dir, hooks)``, the
    whole of one run, and ``side(cell, seed, side, device)``, the check's
    numbers of one side (``calibrate.py``)."""
    return _load('modes', name, bench_dir)
