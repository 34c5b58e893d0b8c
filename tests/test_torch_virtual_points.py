"""The port's virtual-point generation on the host, on the CPU: its
``depth2points`` copy and ``prepare_frame`` give the JAX package's bits
(``virconv_tpu/models/depth_completion/depth2points.py``,
``tools/generate_virtual_points.py``); the PNG reader (``utils/png.py``)
gives ``cv2.imread(...)[..., ::-1]`` under each of the five row filters
and refuses the PNGs it does not read; the CLI
(``tools/generate_virtual_points_gpu.py``) writes well-formed
``velodyne_depth`` files for a small tree (crop cut to 64 x 96)."""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from virconv_tpu.models.depth_completion import depth2points as jd
from virconv_tpu.utils.calibration import Calibration as JaxCalibration
from virconv_tpu_torch.models.depth_completion import depth2points as td
from virconv_tpu_torch.models.depth_completion import penet_import as pi
from virconv_tpu_torch.models.depth_completion import virtual_points as vp
from virconv_tpu_torch.utils.mini_kitti import textured_image, write_tree
from virconv_tpu_torch.utils.png import FILTERS, encode_png, read_png

ROOT = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        'jax_generate_virtual_points',
        ROOT / 'tools' / 'generate_virtual_points.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp('vp') / 'kitti', 'scene',
                      frames=2, seed=3)


def virtual_cloud(rng, n=20000):
    pts = np.zeros((n, 8), np.float32)
    pts[:, 0] = rng.uniform(2, 70, n)
    pts[:, 1] = rng.uniform(-25, 25, n)
    pts[:, 2] = rng.uniform(-3, 2, n)
    pts[:, 4:7] = rng.uniform(0, 85, (n, 3))
    pts[:, 7] = 1
    return pts


def test_la_sampling2_and_fuse_are_the_jax_bits():
    rng = np.random.default_rng(0)
    virt = virtual_cloud(rng)
    lidar = rng.uniform(-40, 40, (3000, 4)).astype(np.float32)
    lidar[:, 3] = rng.uniform(0, 1, 3000)
    np.testing.assert_array_equal(td.la_sampling2(virt),
                                  jd.la_sampling2(virt))
    got = td.fuse_virtual_and_lidar(virt, lidar)
    want = jd.fuse_virtual_and_lidar(virt, lidar)
    assert got.dtype == want.dtype == np.float16
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def test_depth_to_points_rgb_is_the_jax_bits(tree):
    calib_file = tree / 'training' / 'calib' / '000000.txt'
    k_mat = np.array([[721.5, 0, 600.1], [0, 721.5, 160.3], [0, 0, 1]],
                     np.float32)
    rng = np.random.default_rng(1)
    depth = rng.uniform(-5, 120, (40, 64)).astype(np.float32)
    rgb = rng.integers(0, 256, (40, 64, 3), dtype=np.uint8)
    ours = vp.crop_calibration(k_mat, vp.Calibration(calib_file))
    jc = JaxCalibration(calib_file)
    theirs = JaxCalibration({
        'P2': np.array([[k_mat[0, 0], 0, k_mat[0, 2], 0],
                        [0, k_mat[1, 1], k_mat[1, 2], 0], [0, 0, 1, 0]],
                       np.float32), 'R0': jc.R0, 'Tr_velo2cam': jc.V2C})
    got = td.depth_to_points_rgb(depth, rgb, ours)
    want = jd.depth_to_points_rgb(depth, rgb, theirs)
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)


def test_prepare_frame_is_the_jax_bits(tree):
    pytest.importorskip('cv2')
    split = tree / 'training'
    got = vp.prepare_frame(split, '000001')
    want = jax_tool().prepare_frame(split, '000001')
    names = ('rgb', 'rgb_c', 'sparse', 'position', 'k_mat')
    for name, g, w in zip(names, got[:5], want[:5]):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got[6], want[6])
    assert got[7] == want[7]
    assert (got[2] > 0).sum() > 1000          # the scan reaches the crop
    assert got[1].std() > 10                  # a textured image


@pytest.mark.parametrize('filters', [(f,) for f in FILTERS] + [FILTERS])
def test_png_reader_equals_cv2(tmp_path, filters):
    cv2 = pytest.importorskip('cv2')
    img = textured_image(len(filters), 75, 121)
    path = tmp_path / 'img.png'
    path.write_bytes(encode_png(img, filters))
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == (75, 121, 3)
    np.testing.assert_array_equal(got, cv2.imread(str(path))[..., ::-1])
    np.testing.assert_array_equal(got, img)


def test_png_reader_reads_cv2_files_and_refuses_others(tmp_path):
    cv2 = pytest.importorskip('cv2')
    img = textured_image(9, 50, 70)
    rgb = tmp_path / 'rgb.png'
    cv2.imwrite(str(rgb), np.ascontiguousarray(img[..., ::-1]))
    np.testing.assert_array_equal(read_png(rgb), img)
    gray = tmp_path / 'gray.png'
    cv2.imwrite(str(gray), img[..., 0])
    with pytest.raises(ValueError, match='8-bit RGB'):
        read_png(gray)
    deep = tmp_path / 'deep.png'
    cv2.imwrite(str(deep), img.astype(np.uint16) * 200)
    with pytest.raises(ValueError, match='8-bit RGB'):
        read_png(deep)
    (tmp_path / 'not.png').write_bytes(b'GIF89a' + bytes(40))
    with pytest.raises(ValueError, match='not a PNG'):
        read_png(tmp_path / 'not.png')


def test_load_penet_checkpoint_reads_reference_files(tmp_path):
    w = torch.arange(12.).reshape(1, 3, 2, 2)
    torch.save({'model': {'module.mask_layer.0.weight': w,
                          'module.mask_layer.1.num_batches_tracked':
                          torch.tensor(4)}, 'epoch': 3},
               tmp_path / 'pe.pth.tar')
    sd = pi.load_penet_checkpoint(tmp_path / 'pe.pth.tar')
    assert list(sd) == ['mask.Conv_0.weight']
    assert torch.equal(sd['mask.Conv_0.weight'], w)


def test_cli_writes_velodyne_depth(tree, monkeypatch):
    """The CLI on the CPU over the tree's two frames, the crop cut to
    64 x 96: one float16 file of 8 columns per frame, the scan first
    (indicator 2, intensity x 10) then the virtual points (indicator 1,
    z < 1, colours of the image), and the result's counts and stages."""
    monkeypatch.setattr(vp, 'CROP_H', 64)
    monkeypatch.setattr(vp, 'CROP_W', 96)
    sys.path.insert(0, str(ROOT / 'tools'))
    try:
        import generate_virtual_points_gpu as cli
    finally:
        sys.path.remove(str(ROOT / 'tools'))
    split = tree / 'training'
    res = cli.main(['--detpath', str(split), '--device', 'cpu',
                    '--limit', '2'])
    assert res.frames == ['000000', '000001'] and res.device == 'cpu'
    assert set(res.seconds) == set(vp.STAGES)
    for fid, n, n_lidar in zip(res.frames, res.points, res.lidar_points):
        pts = np.load(split / 'velodyne_depth' / f'{fid}.npy')
        lidar = np.fromfile(split / 'velodyne' / f'{fid}.bin',
                            np.float32).reshape(-1, 4)
        assert pts.dtype == np.float16 and pts.shape == (n, 8)
        assert n_lidar == len(lidar) and n > n_lidar
        ind = pts[:, 7].astype(np.float32)
        assert (ind[:n_lidar] == 2).all() and (ind[n_lidar:] == 1).all()
        np.testing.assert_array_equal(
            pts[:n_lidar, 3], (lidar[:, 3] * 10).astype(np.float16))
        virt = pts[n_lidar:].astype(np.float32)
        assert (virt[:, 2] < 1.001).all()          # float16 of z < 1
        assert (virt[:, 4:7] > 0).any(1).mean() > 0.9
        assert np.isfinite(pts.astype(np.float32)).all()
