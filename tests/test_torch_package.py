"""Hygiene of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points refuse a missing CUDA device instead of falling back, its
shipped configs (VirConv-T, -L, -S) equal their YAML, flax weights carry
across by name at the full VirConv-T and VirConv-L widths, the serving
entry point runs end to end on the CPU when asked to, the CUDA build
digest covers every header a source includes, and each kernel wrapper's
limits are the ones its ``.cu`` file declares."""
import ctypes
import functools
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from virconv_tpu_torch.ops import (_cuda, band_conv, boxes, depth2points,
                                   gather_conv, nmap_conv, onehot_conv,
                                   roi_pool)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / 'virconv_tpu_torch'

torch.set_num_threads(1)


EVAL_MODULES = (
    'virconv_tpu_torch.ops.native', 'virconv_tpu_torch.ops.wbf',
    'virconv_tpu_torch.config', 'virconv_tpu_torch.configs.tiny',
    'virconv_tpu_torch.configs.virconv_l',
    'virconv_tpu_torch.configs.virconv_s',
    'virconv_tpu_torch.utils.bench_inputs',
    'virconv_tpu_torch.utils.reference_import',
    'virconv_tpu_torch.utils.common', 'virconv_tpu_torch.utils.metrics',
    'virconv_tpu_torch.utils.mini_kitti',
    'virconv_tpu_torch.datasets',
    'virconv_tpu_torch.datasets.dataset',
    'virconv_tpu_torch.datasets.kitti.kitti_utils',
    'virconv_tpu_torch.datasets.kitti.kitti_dataset_mm',
    'virconv_tpu_torch.datasets.kitti.kitti_dataset_semi',
    'virconv_tpu_torch.datasets.kitti.eval',
    'virconv_tpu_torch.datasets.processor.point_feature_encoder',
    'virconv_tpu_torch.datasets.processor.data_processor',
    'virconv_tpu_torch.datasets.augmentor.x_transform',
    'virconv_tpu_torch.datasets.augmentor.augmentor_utils',
    'virconv_tpu_torch.datasets.augmentor.database_sampler',
    'virconv_tpu_torch.datasets.augmentor.data_augmentor',
    'virconv_tpu_torch.train.checkpoint',
    'virconv_tpu_torch.train.eval_loop',
    'virconv_tpu_torch.ops.gather_rows', 'virconv_tpu_torch.ops.cspn',
    'virconv_tpu_torch.utils.png',
    'virconv_tpu_torch.models.depth_completion.penet',
    'virconv_tpu_torch.models.depth_completion.penet_import',
    'virconv_tpu_torch.models.depth_completion.depth2points',
    'virconv_tpu_torch.models.depth_completion.virtual_points',
    'virconv_tpu_torch.ops.depth2points',
    'virconv_tpu_torch.parallel', 'virconv_tpu_torch.parallel.dist',
    'virconv_tpu_torch.parallel.data_parallel',
    'virconv_tpu_torch.parallel.spawn',
    'virconv_tpu_torch.parallel.fullwidth', 'virconv_tpu_torch.entry')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'virconv_tpu', 'triton',
             'cv2', 'yaml', 'orbax')


def test_import_loads_no_jax_and_no_jax_package():
    """Every module of the port, tools/test_gpu.py, tools/train_gpu.py,
    tools/generate_virtual_points_gpu.py and tools/run_fullwidth_dp_gpu.py
    import without JAX, the JAX package, an image library, YAML or
    orbax."""
    code = (
        'import sys, runpy, virconv_tpu_torch, virconv_tpu_torch.serve, '
        'virconv_tpu_torch.train.trainer, virconv_tpu_torch.train.optim, '
        'virconv_tpu_torch.utils.jax_weights, '
        'virconv_tpu_torch.utils.synth_scene, '
        'virconv_tpu_torch.ops.gather_conv, '
        'virconv_tpu_torch.ops.onehot_conv, '
        'virconv_tpu_torch.ops.nmap_conv, ' + ', '.join(EVAL_MODULES)
        + '\n'
        "runpy.run_path('tools/test_gpu.py', run_name='imported')\n"
        "runpy.run_path('tools/train_gpu.py', run_name='imported')\n"
        "runpy.run_path('tools/generate_virtual_points_gpu.py', "
        "run_name='imported')\n"
        "runpy.run_path('tools/run_fullwidth_dp_gpu.py', "
        "run_name='imported')\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        'print(bad)\n'
        'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


_IMPORT = re.compile(r'^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|'
                     r'virconv_tpu|cv2|yaml|orbax)\b', re.M)


def test_sources_import_no_jax():
    files = sorted(PKG.rglob('*.py')) + [
        ROOT / 'chip_smoke.py', ROOT / 'tools' / 'test_gpu.py',
        ROOT / 'tools' / 'train_gpu.py',
        ROOT / 'tools' / 'generate_virtual_points_gpu.py',
        ROOT / 'tools' / 'run_fullwidth_dp_gpu.py']
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m.group(0).strip())
           for f in files for m in _IMPORT.finditer(f.read_text())]
    assert not bad, bad


def test_entry_points_refuse_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from virconv_tpu_torch import resolve_device
    from virconv_tpu_torch.serve import Detector
    from virconv_tpu_torch.train.trainer import Trainer
    with pytest.raises(RuntimeError, match='CUDA'):
        Detector()
    with pytest.raises(RuntimeError, match='CUDA'):
        Trainer()
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device('cuda')
    assert resolve_device('cpu').type == 'cpu'
    import runpy
    train_cli = runpy.run_path(str(ROOT / 'tools' / 'train_gpu.py'),
                               run_name='imported')
    with pytest.raises(RuntimeError, match='CUDA'):
        train_cli['main'](['--output_dir', str(tmp_path / 'out')])
    assert not (tmp_path / 'out').exists()
    from virconv_tpu_torch.models.depth_completion.virtual_points import \
        VirtualPointGenerator
    with pytest.raises(RuntimeError, match='CUDA'):
        VirtualPointGenerator()
    vp_cli = runpy.run_path(str(ROOT / 'tools' /
                                'generate_virtual_points_gpu.py'),
                            run_name='imported')
    (tmp_path / 'split' / 'velodyne').mkdir(parents=True)
    with pytest.raises(RuntimeError, match='CUDA'):
        vp_cli['main'](['--detpath', str(tmp_path / 'split')])
    assert not (tmp_path / 'split' / 'velodyne_depth').exists()


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card, or alone in a directory, chip_smoke.py exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    alone = tmp_path / 'chip_smoke.py'
    alone.write_text((ROOT / 'chip_smoke.py').read_text())
    for script in (ROOT / 'chip_smoke.py', alone):
        res = subprocess.run([sys.executable, str(script)],
                             cwd=str(script.parent), capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout


SHIPPED = {'virconv_t': 'VirConv-T', 'virconv_l': 'VirConv-L',
           'virconv_s': 'VirConv-S'}


@pytest.mark.parametrize('name', sorted(SHIPPED))
def test_config_dict_equals_yaml(name):
    from virconv_tpu.config import CfgNode as JCfg, cfg_from_yaml_file
    from virconv_tpu_torch.config import CONFIGS
    want = cfg_from_yaml_file(
        str(ROOT / f'tools/cfgs/models/kitti/{SHIPPED[name]}.yaml'),
        JCfg({'ROOT_DIR': ROOT}))
    got = CONFIGS[name]()
    assert set(got) == {'CLASS_NAMES', 'DATA_CONFIG', 'MODEL',
                        'OPTIMIZATION'}
    for k in got:
        assert got[k] == want[k], k


@pytest.mark.parametrize('name', ['virconv_t', 'virconv_l'])
def test_full_width_weights_carry_across(name):
    """Every parameter and BN statistic of the full-width flax tree
    (VirConv-T, VirConv-L) lands on a port parameter of the same shape, and
    nothing is left over."""
    from virconv_tpu.config import CfgNode as JCfg, cfg_from_yaml_file
    from virconv_tpu.models.detectors.voxel_rcnn import VoxelRCNN as JRCNN
    from virconv_tpu_torch.config import CONFIGS
    from virconv_tpu_torch.models.detectors.voxel_rcnn import VoxelRCNN
    from virconv_tpu_torch.utils.jax_weights import (from_jax_variables,
                                                     load_state_dict_checked)
    cfg = cfg_from_yaml_file(
        str(ROOT / f'tools/cfgs/models/kitti/{SHIPPED[name]}.yaml'),
        JCfg({'ROOT_DIR': ROOT}))
    jm = JRCNN(model_cfg=cfg.MODEL, dataset_cfg=cfg.DATA_CONFIG)
    n = 4096
    pts = np.zeros((1, n, 8), np.float32)
    batch = {'points': pts, 'points_valid': np.ones((1, n), bool),
             'v2r': np.zeros((1, 4, 3), np.float32),
             'p2t': np.zeros((1, 4, 3), np.float32),
             'trans_params': np.zeros((1, 3), np.float32),
             'transform_param': None,
             'gt_boxes': np.zeros((1, 4, 8), np.float32),
             'gt_valid': np.zeros((1, 4), bool)}
    if cfg.MODEL.BACKBONE_3D.get('MM', False):
        batch.update(points_mm=pts, points_mm_valid=np.ones((1, n), bool))
    shapes = jax.eval_shape(
        functools.partial(jm.init, train=True),
        {k: jax.random.PRNGKey(i) for i, k in
         enumerate(('params', 'stvd', 'sampling', 'dropout'))}, batch)
    rng = np.random.default_rng(0)
    variables = {c: jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        shapes[c]) for c in ('params', 'batch_stats')}
    c = CONFIGS[name]()
    model = VoxelRCNN(c.MODEL, c.DATA_CONFIG)
    load_state_dict_checked(model, from_jax_variables(variables))
    bb = variables['params']['backbone']
    spots = [(bb['mm']['vir_conv2']['down']['kernel'],
              model.backbone.mm.vir_conv2.down.kernel)]
    if name == 'virconv_t':
        spots.append((bb['lidar']['conv1']['kernel'],
                      model.backbone.lidar.conv1.kernel))
    else:
        spots.append((bb['conv_out']['kernel'],
                      model.backbone.conv_out.kernel))
    for w, p in spots:
        assert torch.equal(p, torch.from_numpy(w))


def _tiny_detector_cfg():
    from test_model_forward import shrink_cfg, tiny_cfg
    from virconv_tpu_torch.config import CfgNode, virconv_t_config
    mc, dc = tiny_cfg(mm=True)
    shrink_cfg(mc, dc)
    dc = dict(dc)
    dc['X_TRANS'] = virconv_t_config().DATA_CONFIG.X_TRANS
    return CfgNode({'CLASS_NAMES': ['Car'], 'MODEL': dict(mc),
                    'DATA_CONFIG': dc})


def test_detector_serves_frames_on_cpu():
    from test_model_forward import make_batch
    from virconv_tpu_torch.serve import Detector
    from virconv_tpu.utils.calibration import identity_calib
    det = Detector(cfg=_tiny_detector_cfg(), device='cpu', seed=3)
    rng = np.random.default_rng(0)
    b = make_batch(rng, n_entries=2, n_pts=512, train=True)
    v2r, p2t = identity_calib(fu=200.0, fv=200.0, cu=700.0,
                              cv=300.0).device_matrices()
    frames = {'points': np.array(b['points']),
              'points_valid': np.array(b['points_valid']),
              'points_mm': np.array(b['points_mm']),
              'points_mm_valid': np.array(b['points_mm_valid']),
              'v2r': np.tile(v2r, (2, 1, 1)), 'p2t': np.tile(p2t, (2, 1, 1))}
    batch = det.make_batch(frames)
    assert batch['points'].shape[0] == 4                 # 2 frames x R=2
    np.testing.assert_array_equal(batch['points'][1].numpy()[:, 3:],
                                  frames['points'][0][:, 3:])
    launches = band_conv.launches, roi_pool.launches
    res = det(frames)
    assert (band_conv.launches, roi_pool.launches) == launches, \
        'CPU tensors never launch a kernel'
    assert len(res) == 2
    for r in res:
        assert r['boxes'].shape == (len(r['scores']), 7)
        assert np.isfinite(r['boxes']).all()
        assert np.isfinite(r['scores']).all()


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / 'csrc'
    shutil.copytree(_cuda.CSRC, copy)
    monkeypatch.setattr(_cuda, 'CSRC', copy)
    return copy


@pytest.mark.parametrize('name', _cuda.SOURCES)
def test_build_target_changes_with_an_included_header(csrc_copy, name):
    """Editing a header the source includes renames its library, so a stale
    build is never loaded; a file it does not include changes nothing."""
    src, lib = _cuda._target(name)
    headers = [p for p in _cuda._sources(src) if p.suffix == '.cuh']
    assert headers, f'{name}.cu includes no csrc header'
    (csrc_copy / 'unused.cuh').write_text('// not included\n')
    assert _cuda._target(name)[1] == lib
    for h in headers:
        h.write_text(h.read_text() + '\n// edited\n')
        edited = _cuda._target(name)[1]
        assert edited != lib
        lib = edited
    src.write_text(src.read_text() + '\n// edited\n')
    assert _cuda._target(name)[1] != lib


def _constexprs(name):
    """The integer constexprs of ``csrc/<name>.cu`` and of every header it
    includes."""
    consts = {}
    for path in _cuda._sources(_cuda.CSRC / f'{name}.cu'):
        consts.update((m[0], int(m[1])) for m in re.findall(
            r'constexpr int (k\w+) = (\d+);', path.read_text()))
    return consts


def _cuda_name(py_name):
    """MAX_CIN -> kMaxCin, DW_MAX_TILE -> kDwMaxTile."""
    return 'k' + ''.join(w.capitalize() for w in py_name.split('_'))


@pytest.mark.parametrize('module,source', [
    (band_conv, 'band_conv'), (roi_pool, 'roi_pool'),
    (gather_conv, 'gather_conv'), (onehot_conv, 'gather_conv'),
    (nmap_conv, 'gather_conv'), (boxes, 'nms'),
    (depth2points, 'depth2points')])
def test_wrapper_limits_match_kernel_constexprs(module, source):
    limits = {n: getattr(module, n) for n in dir(module)
              if re.fullmatch(r'([A-Z]+_)?MAX_[A-Z_]+', n)}
    assert limits
    consts = _constexprs(source)
    for py_name, value in limits.items():
        assert consts.get(_cuda_name(py_name)) == value, py_name


@pytest.mark.parametrize('source', sorted(_cuda.SIGNATURES))
def test_entry_point_signatures_match_their_c_prototypes(source):
    """Each C entry point takes as many parameters as ctypes passes it, a
    pointer (or the stream) where ctypes passes c_void_p: a call with one
    argument too few or too many would read garbage there."""
    text = (_cuda.CSRC / f'{source}.cu').read_text()
    for fn, (_, argtypes) in _cuda.SIGNATURES[source].items():
        m = re.search(r'extern "C" [\w ]+?\b' + fn + r'\(([^)]*)\)', text)
        assert m, fn
        params = [p.strip() for p in m.group(1).split(',')]
        assert len(params) == len(argtypes), (fn, len(params),
                                              len(argtypes))
        for p, t in zip(params, argtypes):
            pointer = '*' in p or p.startswith('cudaStream_t')
            assert pointer == (t is ctypes.c_void_p), (fn, p, t)


def test_onehot_mode_numbers_match_kernel():
    consts = _constexprs('gather_conv')
    for name, number in onehot_conv.MODES.items():
        assert consts[f'kMode{name.capitalize()}'] == number, name


def test_gather_mode_numbers_match_kernel():
    consts = _constexprs('gather_conv')
    assert set(gather_conv.MODES) == {'fma', 'tile', 'row'}
    for name, number in gather_conv.MODES.items():
        assert consts[f'kMode{name.capitalize()}'] == number, name


@pytest.mark.parametrize('c_in,c_out,bf16,mode', [
    (8, 16, True, 'row'), (3, 5, True, 'row'), (8, 17, True, 'tile'),
    (9, 16, True, 'tile'), (64, 64, True, 'tile'), (128, 200, True, 'tile'),
    (129, 16, True, 'fma'), (8, 16, False, 'row'), (64, 64, False, 'tile'),
    (129, 16, False, 'fma')])
def test_onehot_kernel_mode(c_in, c_out, bf16, mode):
    """K6's body by widths, for bf16 and f32 operands alike: a thread per
    row for C <= 8 and C' <= 16, the tile mode (tensor cores for bf16, CUDA
    cores for f32) for other inputs of at most MAX_CIN channels, the fma
    mode for wider ones."""
    assert onehot_conv.kernel_mode(c_in, c_out, bf16) == mode


@pytest.mark.parametrize('c_in,c_out,mode', [
    (8, 16, 'row'), (3, 5, 'row'), (8, 8, 'row'), (16, 16, 'tile'),
    (8, 17, 'tile'), (9, 16, 'tile'), (32, 16, 'tile'), (64, 64, 'tile'),
    (5, 24, 'tile'), (128, 200, 'tile'), (129, 16, 'fma'), (130, 8, 'fma')])
def test_gather_kernel_mode(c_in, c_out, mode):
    """K5's body by widths, the same rule as K6's: a thread per row for
    C <= ROW_MAX_CIN and C' <= ROW_MAX_COUT, the tile mode for other inputs
    of at most MAX_CIN channels, the fma mode for wider ones."""
    assert gather_conv.kernel_mode(c_in, c_out) == mode
    assert onehot_conv.kernel_mode(c_in, c_out, False) == mode


@pytest.mark.parametrize('n_tiles,tile,n_taps,c_out,min_ctas', [
    (448, 128, 27, 64, 2 * 132),    # the widest training call
    (750, 128, 27, 16, 2 * 132),    # the first training layers
    (31, 128, 27, 64, 0), (12, 128, 27, 16, 0), (1, 128, 27, 8, 0),
    (0, 128, 27, 8, 0), (3000, 32, 9, 130, 0), (5, 256, 3, 1, 0)])
def test_dw_tiles_per_chunk(n_tiles, tile, n_taps, c_out, min_ctas):
    """K4's chunks: at most DW_MAX_CHUNK rows each; at least half of the
    DW_TARGET_CTAS CTAs where the tiles allow, else a tile per chunk; two
    CTAs per SM or more at the training widths."""
    per = band_conv.dw_tiles_per_chunk(n_tiles, tile, n_taps, c_out)
    assert per >= 1 and per * tile <= band_conv.DW_MAX_CHUNK
    slabs = -(-c_out // band_conv.DW_MAX_SLAB)
    chunks = -(-n_tiles // per)
    full = -(-band_conv.DW_TARGET_CTAS // (n_taps * slabs))
    if n_tiles >= full:
        assert 2 * chunks >= full
    elif n_tiles:
        assert per == 1
    assert chunks * n_taps * slabs >= min_ctas


def test_depth2points_layout_matches_kernel():
    """The wrapper sizes the per-CTA counts from THREADS and reads the
    counts ahead of c, q and the rows from HEAD: the kernel's kThreads and
    kHead."""
    consts = _constexprs('depth2points')
    assert consts['kThreads'] == depth2points.THREADS
    assert consts['kHead'] == depth2points.HEAD
