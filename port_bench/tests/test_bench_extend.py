"""A cell, a traffic mix and a per-layer metric added as new files and
entries resolve without an edit to any file the benchmark has."""

import json
import os
import shutil

from conftest import BENCH, ROOT
from benchlib import spec


def test_new_cell_and_metric(tmp_path):
    bench = tmp_path / 'bench'
    shutil.copytree(os.path.join(BENCH, 'traffic'), bench / 'traffic')
    shutil.copytree(os.path.join(BENCH, 'metrics'), bench / 'metrics')
    # the new pieces: a traffic file and a metric file, nothing edited
    mix = json.load(open(bench / 'traffic' / 'infer_b2.json'))
    mix.update(frames=3, cars=60)
    json.dump(mix, open(bench / 'traffic' / 'infer_b3_dense.json', 'w'))
    (bench / 'metrics' / 'frames_profiled.infer.py').write_text(
        'def read(s):\n    return s["items"] * s["frames"]\n')
    spec_doc = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    for c in spec_doc['configs']:
        c['file'] = os.path.join(ROOT, c['file'])
    spec_doc['workloads'].append(
        {'name': 't_infer_b3_dense', 'config': 'virconv_t',
         'traffic': 'infer_b3_dense', 'chips': 1, 'why': 'test'})
    spec_doc['per_layer'].append(
        {'name': 'frames_profiled.infer', 'unit': 'frames', 'better':
         'higher', 'source': 'program_counter', 'layer': 'serve',
         'moves': 'infer_frames_per_s', 'workloads': ['t_infer_b3_dense']})
    for m in spec_doc['end_to_end']:
        if m['name'] == 'infer_frames_per_s':
            m['workloads'].append('t_infer_b3_dense')
    path = tmp_path / 'BENCHMARK.json'
    json.dump(spec_doc, open(path, 'w'))
    cell = spec.load_cell('t_infer_b3_dense', str(path), str(bench))
    assert cell.traffic['frames'] == 3 and cell.traffic['cars'] == 60
    assert cell.config['port_config'] == 'virconv_t'
    assert 'frames_profiled.infer' in [m['name'] for m in cell.per_layer]
    assert {m['name'] for m in cell.end_to_end} == {'infer_frames_per_s',
                                                    'setup_s'}
    read = spec.metric_reader('frames_profiled.infer', str(bench))
    assert read({'items': 3, 'frames': 3}) == 9
    # the shipped cells resolve as before
    t = spec.load_cell('t_train_b2', os.path.join(ROOT, 'BENCHMARK.json'))
    assert t.traffic['mode'] == 'train'
