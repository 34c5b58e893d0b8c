"""PENet_C2 on the port's normal path, on the CPU:

* the port's ``PENetC2`` against the benchmark's plain reference
  (``port_bench/refnet/penet.py``) at a 64 x 256 crop of a street frame,
  on seeded weights calibrated as the benchmark calibrates them: the
  coarse (ENet) and the refined (both CSPN stages) depth within 1e-5 of
  the largest magnitude (both compute the same float32 operations; the
  reference sums its propagation taps one shift at a time);
* ``VirtualPointGenerator.stream`` against ``generate``: the same clouds
  as the files ``generate`` writes, and those files the bits of a frame's
  depth through ``frame_points``, as ``generate`` wrote them frame by
  frame before ``stream`` existed;
* the spans ``vp.copy``, ``penet.enet``, ``penet.cspn``,
  ``vp.depth2points`` and the per-frame counters recorded under
  ``trace.recording()`` only."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from virconv_tpu_torch.models.depth_completion import virtual_points as vp
from virconv_tpu_torch.models.depth_completion.penet import PENetC2
from virconv_tpu_torch.utils import trace
from virconv_tpu_torch.utils.mini_kitti import write_tree

BENCH = Path(__file__).resolve().parent.parent / 'port_bench'
torch.set_num_threads(2)
TOL = 1e-5


def bench_modules():
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from benchlib import vp_frames, vp_model
    from refnet import penet as ref_penet
    return vp_frames, vp_model, ref_penet


@pytest.mark.parametrize('seed', [3, 2 ** 31 + 5])
def test_penet_c2_matches_the_plain_reference(seed):
    vp_frames, vp_model, _ = bench_modules()
    frames = vp_frames.Frames({'mode': 'vp', 'frames': 1, 'cars': 25,
                               'pool': 1, 'workers': 2},
                              {'image': [375, 1242], 'crop': [64, 256]},
                              seed)
    ref, sd = vp_model.reference(frames, seed, 'cpu')
    model = PENetC2().eval()
    model.load_state_dict(sd)
    inputs = frames.inputs(0, 'cpu')
    with torch.no_grad():
        want = ref.heads(*inputs)
        want_depth = ref.propagate(want)
        got = model.heads(*inputs)
        got_depth = model.propagate(got)
    for a, b in ((got['coarse'], want['coarse']), (got_depth, want_depth)):
        scale = float(b.abs().max())
        assert scale > 1.0
        assert float((a - b).abs().max()) <= TOL * scale
    # the calibrated weights put the depth where a trained net does
    inside = ((want_depth > 0.1) & (want_depth < 100)).float().mean()
    assert float(inside) > 0.8


@pytest.fixture(scope='module')
def split(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp('vps') / 'kitti', 'scene',
                      frames=3, seed=4) / 'training'


@pytest.fixture
def small_crop(monkeypatch):
    monkeypatch.setattr(vp, 'CROP_H', 64)
    monkeypatch.setattr(vp, 'CROP_W', 96)


def test_stream_gives_generate_s_files(split, small_crop):
    gen = vp.VirtualPointGenerator(device='cpu')
    frames = ['000000', '000001', '000002']
    res = gen.generate(split, frames)
    assert res.frames == frames and len(res.points) == 3
    preps = [(f, vp.prepare_frame(split, f)) for f in frames]
    got = list(gen.stream(iter(preps)))
    assert [f for f, _ in got] == frames
    for (fid, cloud), (_, prep) in zip(got, preps):
        saved = np.load(split / 'velodyne_depth' / f'{fid}.npy')
        np.testing.assert_array_equal(cloud.view(np.uint16),
                                      saved.view(np.uint16))
        _, rgb_c, sparse, pos, k_mat, calib, lidar, _ = prep
        depth = gen.complete(rgb_c, sparse, pos, k_mat)
        np.testing.assert_array_equal(
            vp.frame_points(depth, rgb_c, k_mat, calib, lidar).view(
                np.uint16), saved.view(np.uint16))


@pytest.mark.parametrize('recording', [False, True])
def test_spans_and_counters_only_while_recording(split, small_crop,
                                                 recording):
    gen = vp.VirtualPointGenerator(device='cpu')
    preps = [(f, vp.prepare_frame(split, f)) for f in ('000000', '000001')]
    trace.reset()
    if recording:
        with trace.recording():
            clouds = dict(gen.stream(iter(preps)))
    else:
        clouds = dict(gen.stream(iter(preps)))
    snap = trace.snapshot()
    names = {'penet.enet', 'penet.cspn', 'vp.depth2points'}
    if not recording:
        assert not names & set(snap['spans']) and not snap['counters']
        return
    assert names <= set(snap['spans']) <= set(trace.SPANS)
    assert all(snap['spans'][n]['calls'] == 2 for n in names)
    assert snap['spans']['vp.copy']['calls'] == 4      # up and down
    counters = snap['counters']
    assert set(counters) == set(trace.COUNTERS)
    # a frame's four counts share an index; the frames come in the order
    # their tails ended
    got = sorted(zip(counters['vp.fused_points'],
                     counters['vp.thinned_points'],
                     counters['vp.sparse_pixels']))
    want = sorted((len(clouds[fid]), len(clouds[fid]) - len(prep[6]),
                   int(np.count_nonzero(prep[2]))) for fid, prep in preps)
    assert got == want
    for n_virt, n_thin in zip(counters['vp.virtual_points'],
                              counters['vp.thinned_points']):
        assert n_virt >= n_thin
    trace.reset()
