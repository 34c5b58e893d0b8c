"""A cell, a traffic mix, a per-layer metric and a run mode added as new
files and entries resolve and run without an edit to any file the
benchmark has."""

import contextlib
import io
import json
import os
import re
import shutil

import pytest

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


TOY_MODE = '''"""A toy run mode: a seeded two-layer conv net as the program, its
float32 plain copy (``conv2d`` on the same weights) as the reference."""
import time

import torch
import torch.nn.functional as F

from benchlib import cells


class Traffic:
    def __init__(self, p, seed):
        self.p, self.seed, self.frames = p, seed, int(p['frames'])

    def item(self, i):
        g = torch.Generator().manual_seed(self.seed * 1000003 + i)
        return torch.randn(self.frames, self.p['channels'], self.p['size'],
                           self.p['size'], generator=g)


def weights(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    c, w = cfg['channels'], cfg['width']
    return [torch.randn(w, c, 3, 3, generator=g) / 3,
            torch.randn(c, w, 3, 3, generator=g) / 3]


def program(ws):
    net = torch.nn.Sequential(torch.nn.Conv2d(*ws[0].shape[:2][::-1], 3,
                                              padding=1, bias=False),
                              torch.nn.ReLU(),
                              torch.nn.Conv2d(*ws[1].shape[:2][::-1], 3,
                                              padding=1, bias=False))
    with torch.no_grad():
        net[0].weight.copy_(ws[0])
        net[2].weight.copy_(ws[1])
    return net


def reference(ws, x, dtype=torch.float32):
    h = F.relu(F.conv2d(x.to(dtype), ws[0].to(dtype), padding=1))
    return F.conv2d(h, ws[1].to(dtype), padding=1).float()


def gap(mine, ref):
    return float((mine - ref).abs().max() / ref.abs().max())


def run(cell, args, device, t_start, bench_dir, hooks):
    traffic = Traffic(cell.traffic, args.seed)
    ws = weights(cell.config['config'], args.seed)
    net = program(ws)
    warm = 0.0
    for k in range(2):
        t = time.perf_counter()
        with torch.no_grad():
            net(traffic.item(cells.WARM + k))
        warm = time.perf_counter() - t
    prof = cells.Profiled(cell, args, bench_dir, 1, 2, ('toy',)) \\
        if args.trace else None
    outs = {}

    def serve(i, x):
        with torch.no_grad(), torch.profiler.record_function('toy'):
            return net(x)

    def keep(i, y):
        if i < 4:
            outs[i] = y
    t0, window_s, n_done, host_s = cells.window(
        cells.Items(traffic, 0, args.seconds, warm), 0, args.seconds,
        device, prof, serve, keep)
    setup_s = t0 - t_start
    numbers = {'out_gap': max(gap(y, reference(ws, traffic.item(k)))
                              for k, y in outs.items())}
    if prof is None:
        return cells.finish(cell, bench_dir, device, n_done, 0, numbers,
                            metrics={'infer_frames_per_s': n_done *
                                     traffic.frames / window_s,
                                     'setup_s': setup_s})
    prof.finish()
    summary = {'mode': 'infer', 'items': prof.n, 'frames': traffic.frames,
               'trace': prof.trace, 'item_host_s': host_s}
    return cells.finish(cell, bench_dir, device, n_done, 0, numbers, prof,
                        summary=summary)


def side(cell, seed, side, device):
    traffic = Traffic(cell.traffic, seed)
    ws = weights(cell.config['config'], seed)
    xs = [traffic.item(i) for i in range(4)]
    if side == 'control':
        mine = [reference(ws, x, torch.bfloat16) for x in xs]
    else:
        with torch.no_grad():
            mine = [program(ws)(x) for x in xs]
    return {'out_gap': max(gap(m, reference(ws, x))
                           for m, x in zip(mine, xs))}
'''


def link_shipped(bench):
    """Directories of the tmp bench that hold a link to each shipped file,
    so that new files land in the tmp bench and not under port_bench."""
    for name in ('metrics', 'traffic', 'limits'):
        (bench / name).mkdir(parents=True)
        for f in os.listdir(os.path.join(BENCH, name)):
            if not f.startswith('__'):
                os.symlink(os.path.join(BENCH, name, f), bench / name / f)


def shipped_files():
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, dirs, files in os.walk(BENCH)
            if '__pycache__' not in d for f in files}


def run_quiet(entry, argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        got = entry(argv, device='cpu', **kw)
    return got, out.getvalue()


def test_new_mode_as_files(tmp_path):
    """A model that is not the detector, added as files only: a mode, a
    traffic mix, a configuration, limits, a metric, and entries in a copy
    of BENCHMARK.json; the run, the traced run and calibrate.py take it."""
    import calibrate
    import run
    before = shipped_files()
    bench = tmp_path / 'bench'
    link_shipped(bench)
    (bench / 'modes').mkdir()
    (bench / 'configs').mkdir()
    (bench / 'modes' / 'toy.py').write_text(TOY_MODE)
    (bench / 'traffic' / 'toy.json').write_text(json.dumps(
        {'mode': 'toy', 'frames': 2, 'channels': 4, 'size': 16}))
    (bench / 'configs' / 'toy.json').write_text(json.dumps(
        {'config': {'channels': 4, 'width': 8}, 'precision': 'float32'}))
    (bench / 'limits' / 'toy_cell.json').write_text('{"out_gap": 1e-4}')
    (bench / 'metrics' / 'toy_ms.infer.py').write_text(
        'from benchlib.readers import span_ms\n\n\n'
        'def read(s):\n    return span_ms(s, "infer", "toy")\n')
    doc = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    for c in doc['configs']:
        c['file'] = os.path.join(ROOT, c['file'])
    doc['configs'].append({'name': 'toy', 'source': 'test', 'reduced': [],
                           'file': 'bench/configs/toy.json', 'why': 'test'})
    doc['workloads'].append({'name': 'toy_cell', 'config': 'toy',
                             'traffic': 'toy', 'chips': 1, 'why': 'test'})
    doc['per_layer'].append(
        {'name': 'toy_ms.infer', 'unit': 'ms', 'better': 'lower',
         'source': 'program_span', 'layer': 'toy', 'workloads': ['toy_cell'],
         'moves': 'infer_frames_per_s'})
    for m in doc['end_to_end']:
        if m['name'] == 'infer_frames_per_s':
            m['workloads'].append('toy_cell')
    path = tmp_path / 'BENCHMARK.json'
    path.write_text(json.dumps(doc))
    kw = dict(spec_path=str(path), bench_dir=str(bench))
    for trace in (0, 1):
        rc, out = run_quiet(run.main, [
            '--workload', 'toy_cell', '--seed', str(2 ** 31 + 3),
            '--seconds', '0.5', '--trace', str(trace)], **kw)
        assert rc == 0
        result = json.loads(out.strip().splitlines()[-1])
        assert list(result)[-1] == 'checks'
        assert result['correct'], result['checks']
        if trace:
            assert result['metrics']['toy_ms.infer']['value'] > 0
            assert result['device']['window_s'] > 0
        else:
            assert set(result['metrics']) == {'infer_frames_per_s',
                                              'setup_s'}
    lines, _ = run_quiet(calibrate.main, [
        '--workload', 'toy_cell', '--seeds', '5,6',
        '--sides', 'program,control'], **kw)
    gaps = {(x['seed'], x['side']): x['numbers']['out_gap'] for x in lines}
    assert max(gaps[s, 'program'] for s in (5, 6)) <= 1e-4 \
        < min(gaps[s, 'control'] for s in (5, 6))
    assert shipped_files() == before


@pytest.mark.parametrize('entry', ['run', 'calibrate'])
def test_unknown_mode_fails(tmp_path, tiny_bench, entry):
    """A traffic file whose mode has no file fails, naming the path it
    looked for, in either entry point; nothing runs in its place."""
    import calibrate
    import run
    spec_path, bench_dir = tiny_bench
    bench = tmp_path / 'bench'
    (bench / 'traffic').mkdir(parents=True)
    for name in ('metrics', 'modes', 'limits'):
        os.symlink(os.path.join(bench_dir, name), bench / name)
    (bench / 'traffic' / 'tiny_infer.json').write_text(
        '{"mode": "serve_twice", "frames": 2}')
    argv = {'run': ['--seed', '1', '--seconds', '1'],
            'calibrate': ['--seeds', '1']}[entry]
    missing = os.path.join(str(bench), 'modes', 'serve_twice.py')
    with pytest.raises(FileNotFoundError, match=re.escape(missing)):
        run_quiet({'run': run.main, 'calibrate': calibrate.main}[entry],
                  ['--workload', 'tt_infer'] + argv, spec_path=spec_path,
                  bench_dir=str(bench))
