"""The tiny configurations: VirConv-T's and VirConv-L's graphs at a few
narrow layers.

The detector of the JAX package's model tests (``tests/test_model_forward.
py::tiny_cfg``: a 16 x 16 x 4 m range at 0.1 m voxels, 8-32 channels, ROT_NUM
2) over VirConv-T's data config, for comparing the CUDA kernels with their
plain versions on a whole model (``chip_smoke.py`` phases 4, 7, 9b, 10b and
11d, ``tests/test_torch_cuda.py``), and for training and evaluating on the
CPU in the tests. ``tiny_l_config`` is VirConv-L's structure (the fused
single stream, one refinement stage, no PART, no test-time replicas) at
the same widths (``tiny_cfg(mm=False)``'s). ``small_config`` is the tiny
detector at narrower widths, the preset of the multi-rank dry run
(``entry.dryrun_multichip``).
"""

from __future__ import annotations

from ..config import virconv_l_config, virconv_t_config


def _shrink(cfg):
    """The tiny widths and range, in place, on a shipped config."""
    m, d = cfg.MODEL, cfg.DATA_CONFIG
    d.POINT_CLOUD_RANGE = [0, -8, -3, 16, 8, 1]
    proc = d.DATA_PROCESSOR[2]
    proc.VOXEL_SIZE = [0.1, 0.1, 0.1]
    proc.MAX_NUMBER_OF_VOXELS = {'train': 2048, 'test': 2048}
    m.BACKBONE_3D.NUM_FILTERS = [8, 16, 32, 32]
    m.BACKBONE_3D.OUT_FEATURES = 32
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 64
    b2 = m.BACKBONE_2D
    b2.LAYER_NUMS, b2.NUM_FILTERS = [2, 2], [32, 64]
    b2.NUM_UPSAMPLE_FILTERS = [32, 32]
    rh = m.ROI_HEAD
    rh.SHARED_FC = rh.CLS_FC = rh.REG_FC = [64, 64]
    rh.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE = 128
    rh.NMS_CONFIG.TEST.NMS_POST_MAXSIZE = 32
    for key in ('ROI_GRID_POOL', 'ROI_GRID_POOL_MM'):
        rh[key].GRID_SIZE = 4
        for src, radii in (('x_conv3', [0.8, 1.6]), ('x_conv4', [1.6, 3.2])):
            lc = rh[key].POOL_LAYERS[src]
            lc.MLPS = [[16, 16], [16, 16]]
            lc.QUERY_RANGES = [[2, 2, 2], [3, 3, 3]]
            lc.POOL_RADIUS = radii
            lc.NSAMPLE = [8, 8]
    return cfg


def tiny_config():
    """The tiny detector of the JAX package's model tests (a few layers,
    narrow widths, a 16 x 16 x 4 m range at 0.1 m voxels)."""
    cfg = _shrink(virconv_t_config())
    rh = cfg.MODEL.ROI_HEAD
    rh.ROT_NUM = 2
    rh.PART.IN_CHANNEL = 64
    rh.PART.GRID_OFFSETS = [0., 8.]
    rh.PART.FEATMAP_STRIDE = 0.8
    return cfg


# the suggested points per entry of a ``small_config`` batch
SMALL_N_PTS = 512


def small_config():
    """``tiny_config()`` at the widths of the JAX package's width-shrunk
    "small" preset (``tests/test_model_forward.py::shrink_cfg``, which
    ``__graft_entry__.dryrun_multichip`` steps on its mesh): the same
    modules and parameter names, narrower layers, fewer ROIs, 1024 voxels,
    and ``tiny_cfg``'s ROI target stages, so that its training step is the
    JAX preset's.
    Batches of it take ``SMALL_N_PTS`` points per entry."""
    cfg = tiny_config()
    m = cfg.MODEL
    b3 = m.BACKBONE_3D
    b3.NUM_FILTERS = [8, 8, 16, 16]
    b3.OUT_FEATURES = 16
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 32
    b2 = m.BACKBONE_2D
    b2.NUM_FILTERS = [16, 32]
    b2.NUM_UPSAMPLE_FILTERS = [16, 16]
    m.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.SAMPLE_SIZE = 256
    rh = m.ROI_HEAD
    rh.PART.IN_CHANNEL = 32
    rh.SHARED_FC = [32, 32]
    rh.CLS_FC = [32, 32]
    rh.REG_FC = [32, 32]
    for mode in ('TRAIN', 'TEST'):
        rh.NMS_CONFIG[mode].NMS_PRE_MAXSIZE = 64
        rh.NMS_CONFIG[mode].NMS_POST_MAXSIZE = 16
    for s in ('STAGE0', 'STAGE1'):
        # the JAX tests' one target stage for both (``tiny_cfg``'s), where
        # the shipped config leaves stage 0 without hard sampling and
        # sets stage 1's REG_FG_THRESH 0.55
        t = rh.TARGET_CONFIG[s]
        t.ROI_PER_IMAGE = 16
        t.REG_FG_THRESH = [0.5]
        t.ENABLE_HARD_SAMPLING = True
    for key in ('ROI_GRID_POOL', 'ROI_GRID_POOL_MM'):
        rh[key].GRID_SIZE = 3
        for lc in rh[key].POOL_LAYERS.values():
            lc.QUERY_RANGES = [[1, 1, 1], [2, 2, 2]]
            lc.NSAMPLE = [4, 4]
            lc.MLPS = [[8, 8], [8, 8]]
    cfg.DATA_CONFIG.DATA_PROCESSOR[2].MAX_NUMBER_OF_VOXELS = {
        'train': 1024, 'test': 1024}
    return cfg


def tiny_l_config():
    """VirConv-L's structure at the tiny widths: ``VirConvL8x`` over the
    fused stream, ROT_NUM 1 with one target stage, no PART, no X_TRANS."""
    return _shrink(virconv_l_config())


def tiny_eval_config(data_path, base=tiny_config):
    """``base()`` (the tiny T or L config) reading the KITTI tree at
    ``data_path`` (a ``utils/mini_kitti`` tree), with the loader's ROT_NUM
    the ROI head's and a score threshold of 0.3, which leaves random
    weights detections."""
    cfg = base()
    d = cfg.DATA_CONFIG
    d.DATA_PATH = str(data_path)
    d.ROT_NUM = cfg.MODEL.ROI_HEAD.ROT_NUM
    d.MAX_POINTS = {'lidar': 4096, 'mm': 4096}
    cfg.MODEL.POST_PROCESSING.SCORE_THRESH = 0.3
    return cfg


def tiny_train_config(data_path=None, base=tiny_config):
    """``base()`` (the tiny T or L config) with training sizes: NMS 128 ->
    32 proposals and 32 sampled ROIs per image per stage. With
    ``data_path``, the data settings of ``tiny_eval_config(data_path)``
    (the loader's KITTI tree)."""
    cfg = base() if data_path is None else \
        tiny_eval_config(data_path, base)
    rh = cfg.MODEL.ROI_HEAD
    rh.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE = 128
    rh.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE = 32
    for stage in rh.TARGET_CONFIG.values():
        if isinstance(stage, dict) and 'ROI_PER_IMAGE' in stage:
            stage.ROI_PER_IMAGE = 32
    return cfg


def tiny_l_train_config(data_path=None):
    """``tiny_train_config`` of the tiny L config."""
    return tiny_train_config(data_path, tiny_l_config)
