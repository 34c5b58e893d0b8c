"""The virtual-point cell (``modes/vp.py``) on the CPU at a 64 x 128 crop
of the 375 x 1242 frame: a run and a traced run complete and read
correct, the control and each planted fault read not correct, and the
work counts equal a hand count."""

import contextlib
import io
import json
import os

import pytest
import torch

import calibrate
import run
from conftest import BENCH, ROOT
from benchlib import spec, vp_model, vp_work

SEED = 2 ** 31 + 91
CROP = (64, 128)


@pytest.fixture(scope='module')
def tiny_vp(tmp_path_factory):
    """A bench directory whose cell ``tp_vp`` is ``penet_vp`` at the tiny
    crop with a pool of 2 scenes; returns (spec path, bench dir)."""
    tmp = tmp_path_factory.mktemp('vp')
    bench = tmp / 'bench'
    bench.mkdir()
    for name in ('metrics', 'modes'):
        os.symlink(os.path.join(BENCH, name), bench / name)
    for name in ('traffic', 'limits', 'configs'):
        (bench / name).mkdir()
    config = json.load(open(os.path.join(BENCH, 'configs',
                                         'penet_c2.json')))
    config['crop'] = list(CROP)
    (bench / 'configs' / 'penet_tiny.json').write_text(json.dumps(config))
    mix = json.load(open(os.path.join(BENCH, 'traffic', 'vp_f1.json')))
    mix['pool'] = 2
    (bench / 'traffic' / 'vp_tiny.json').write_text(json.dumps(mix))
    (bench / 'limits' / 'tp_vp.json').write_text(json.dumps(
        {'coarse_gap': 1e-4, 'depth_gap': 1e-4, 'points_miss': 0,
         'count_gap': 1e-3}))
    doc = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    doc['configs'] = [{'name': 'penet_tiny', 'source': 'test',
                       'file': str(bench / 'configs' / 'penet_tiny.json'),
                       'reduced': ['crop'], 'why': 'test'}]
    doc['workloads'] = [{'name': 'tp_vp', 'config': 'penet_tiny',
                         'traffic': 'vp_tiny', 'chips': 1, 'why': 'test'}]
    for m in doc['end_to_end'] + doc['per_layer']:
        if 'penet_vp' in m.get('workloads', []):
            m['workloads'].append('tp_vp')
    path = tmp / 'BENCHMARK.json'
    path.write_text(json.dumps(doc))
    return str(path), str(bench)


def run_vp(tiny_vp, trace=0, fault=None):
    spec_path, bench_dir = tiny_vp
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(['--workload', 'tp_vp', '--seed', str(SEED),
                       '--seconds', '1', '--trace', str(trace)],
                      device='cpu', spec_path=spec_path, bench_dir=bench_dir,
                      hooks={'fault': fault} if fault else None)
    assert rc == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(result)[-1] == 'checks'
    return result


def test_shipped_cell_loads():
    cell = spec.load_cell('penet_vp', os.path.join(ROOT, 'BENCHMARK.json'))
    assert cell.traffic['mode'] == 'vp' and cell.chips == 1
    assert cell.config['crop'] == [352, 1216] and cell.config['reduced'] == []
    assert {m['name'] for m in cell.end_to_end} == {'infer_frames_per_s',
                                                    'setup_s'}
    names = {m['name'] for m in cell.per_layer}
    assert names == {'enet_ms.vp', 'cspn_ms.vp', 'depth2points_ms.vp',
                     'cspn_roofline.vp', 'mfu.vp', 'device_idle_share.vp',
                     'launches_per_frame.vp', 'host_syncs_per_frame.vp'}
    for name in names:
        assert spec.metric_reader(name)({'mode': 'infer'}) is None
    limits = json.load(open(os.path.join(BENCH, 'limits', 'penet_vp.json')))
    assert set(limits) == {'coarse_gap', 'depth_gap', 'points_miss',
                           'count_gap'}
    assert spec.run_mode('vp').side


@pytest.mark.parametrize('trace', [0, 1])
def test_run_is_correct(tiny_vp, trace):
    result = run_vp(tiny_vp, trace)
    assert result['correct'], result['checks']
    assert result['attempted'] >= 1
    if trace:
        # the card's readings (device spans, kernels) are absent here;
        # the CPU makes no CUDA syncs
        assert {'depth2points_ms.vp', 'device_idle_share.vp',
                'host_syncs_per_frame.vp'} <= set(result['metrics'])
        assert result['metrics']['host_syncs_per_frame.vp']['value'] == 0
        counters = result['counters']
        assert counters['vp.fused_points'] > counters['vp.thinned_points']
        assert counters['vp.virtual_points'] >= counters['vp.thinned_points']
        assert counters['vp.sparse_pixels'] > 0
        assert result['depth_in_range_share'] >= 80
    else:
        assert set(result['metrics']) == {'infer_frames_per_s', 'setup_s'}


@pytest.mark.parametrize('fault', vp_model.FAULTS)
def test_fault_is_caught(tiny_vp, fault):
    assert not run_vp(tiny_vp, fault=fault)['correct']


def test_control_fails(tiny_vp):
    spec_path, bench_dir = tiny_vp
    with contextlib.redirect_stdout(io.StringIO()):
        (line,) = calibrate.main(['--workload', 'tp_vp', '--seeds',
                                  str(SEED), '--sides', 'control'],
                                 device='cpu', spec_path=spec_path,
                                 bench_dir=bench_dir)
    limits = json.load(open(f'{bench_dir}/limits/tp_vp.json'))
    assert any(line['numbers'][k] > v for k, v in limits.items())


def hand_conv_ops(h, w):
    """2 x MACs of ENet and the heads at an H x W input, layer by layer."""
    ops = 0.0

    def conv(cin, cout, k, hw_out):
        nonlocal ops
        ops += 2.0 * hw_out * cin * cout * k * k

    def deconv(cin, cout, k, hw_in):
        nonlocal ops
        ops += 2.0 * hw_in * cin * cout * k * k
    hw = [h * w // 4 ** i for i in range(6)]
    conv(4, 32, 5, hw[0])                  # rgb_init, d_init
    conv(2, 32, 5, hw[0])
    enc = [(32, 64, 2), (64, 64, 1), (64, 128, 2), (128, 128, 1),
           (128, 256, 2), (256, 256, 1), (256, 512, 2), (512, 512, 1),
           (512, 1024, 2), (1024, 1024, 1)]
    d_in = {3: 128, 5: 256, 7: 512, 9: 1024}
    for i, (cin, cout, stride) in enumerate(enc, 1):
        out = hw[(i + 1) // 2]
        for c_in in (cin, d_in.get(i, cin)):   # rgb_enc i, d_enc i
            conv(c_in + 3, cout, 3, out)
            conv(cout + 3, cout, 3, out)
            if stride != 1 or c_in != cout:
                conv(c_in + 3, cout, 1, out)
    for s, (cin, cout) in zip((5, 4, 3, 2, 1), ((1024, 512), (512, 256),
                                                (256, 128), (128, 64),
                                                (64, 32))):
        deconv(cin, cout, 5, hw[s])        # rgb_dec and dec, alike
        deconv(cin, cout, 5, hw[s])
    deconv(32, 2, 3, hw[0])                # rgb_out
    conv(32, 2, 3, hw[0])                  # dec6
    for cin, scale in ((128, 1), (64, 0)):
        conv(cin, 1, 3, hw[scale])         # mask
        conv(cin, 3, 3, hw[scale])         # kconf
        for k in (3, 5, 7):
            conv(cin, k * k - 1, 3, hw[scale])
    return ops


def test_work_counts_equal_a_hand_count():
    from refnet.penet import PENetC2
    h, w = 64, 128
    model = PENetC2().eval()
    inputs = (torch.rand(1, 3, h, w) * 255, torch.zeros(1, 1, h, w),
              torch.zeros(1, 2, h, w), torch.eye(3)[None] * 700)
    assert vp_work.enet_ops(model, inputs) == hand_conv_ops(h, w)
    # cspn: two pixels' worth at a 2 x 2 crop, by hand
    ops, nbytes = vp_work.cspn_ops_bytes(2, 2, iters=1)
    assert ops == 2 * 4 * (2 * (9 + 25 + 49) + 12)
    # half-resolution stage: 85 quarter maps + 1 + 3 full maps;
    # full resolution: 85 maps + 1 + 3
    assert nbytes == 4 * (85 * 1 + 4 * 4) + 4 * (85 * 4 + 4 * 4)
    full_ops, full_bytes = vp_work.cspn_ops_bytes(352, 1216)
    assert 0.365e-3 < full_bytes / 3.35e12 < 0.367e-3


def test_span_kernels_sum_the_kernels_inside_each_interval(tmp_path):
    """Kernel time inside a span's device intervals: the gaps and the
    copies between its kernels, and kernels outside it, are not counted."""
    import gzip
    ev = [{'cat': 'gpu_user_annotation', 'name': 'penet.enet', 'ts': 100,
           'dur': 100},
          {'cat': 'gpu_user_annotation', 'name': 'penet.enet', 'ts': 300,
           'dur': 50},
          {'cat': 'gpu_user_annotation', 'name': 'penet.cspn', 'ts': 200,
           'dur': 40},
          {'cat': 'kernel', 'name': 'a', 'ts': 100, 'dur': 20},
          {'cat': 'gpu_memcpy', 'name': 'm', 'ts': 130, 'dur': 30},
          {'cat': 'kernel', 'name': 'b', 'ts': 170, 'dur': 30},
          {'cat': 'kernel', 'name': 'c', 'ts': 205, 'dur': 10},
          {'cat': 'kernel', 'name': 'd', 'ts': 260, 'dur': 10},
          {'cat': 'kernel', 'name': 'e', 'ts': 300, 'dur': 50}]
    path = tmp_path / 't.json.gz'
    with gzip.open(path, 'wt') as f:
        json.dump({'traceEvents': ev}, f)
    got = vp_work.span_kernels(str(path), ('penet.enet', 'penet.cspn'))
    assert got == {'penet.enet': {'kernel_s': 100e-6, 'count': 2},
                   'penet.cspn': {'kernel_s': 10e-6, 'count': 1}}
    s = {'mode': 'vp', 'span_kernels': got}
    assert metric('enet_ms.vp')(s) == pytest.approx(0.05)
    assert metric('cspn_ms.vp')(s) == pytest.approx(0.01)
    assert metric('enet_ms.vp')({'mode': 'vp', 'span_kernels': {}}) is None


def metric(name):
    return spec.metric_reader(name)
