"""The port's point feature encoder
(``virconv_tpu_torch/datasets/processor/point_feature_encoder.py``) under
``absolute_coordinates_encoding`` keeps [x, y, z] and each used feature
from its column ``src_feature_list.index(f)``, as OpenPCDet does; the
``_mm`` encoding keeps every column. The JAX package's copy reads column
3 + that index, which on ``kitti_dataset.yaml``'s 4-column
``x, y, z, intensity`` points is out of range: that ``IndexError`` is the
recorded difference (ROADMAP.md, "Known differences")."""
import numpy as np
import pytest

from virconv_tpu.config import CfgNode as JCfg
from virconv_tpu.datasets.processor.point_feature_encoder import \
    PointFeatureEncoder as JaxEncoder
from virconv_tpu_torch.config import CfgNode
from virconv_tpu_torch.datasets.processor.point_feature_encoder import \
    PointFeatureEncoder

XYZI = ['x', 'y', 'z', 'intensity']


def _points(rng, n, c, rot_num=1):
    return {f'points{"" if i == 0 else i}':
            rng.standard_normal((n, c)).astype(np.float64)
            for i in range(rot_num)}


def _encode(used, src, data, encoding='absolute_coordinates_encoding',
            rot_num=1):
    cfg = CfgNode({'encoding_type': encoding, 'used_feature_list': used,
                   'src_feature_list': src})
    return PointFeatureEncoder(cfg, rot_num=rot_num).forward(dict(data))


def test_four_columns_keep_their_intensity():
    rng = np.random.default_rng(0)
    data = _points(rng, 50, 4, rot_num=2)
    out = _encode(XYZI, XYZI, data, rot_num=2)
    for key in ('points', 'points1'):
        assert out[key].dtype == np.float32
        np.testing.assert_array_equal(out[key],
                                      data[key].astype(np.float32))
    assert out['use_lead_xyz']


@pytest.mark.parametrize('used,cols', [
    (['x', 'y', 'z'], [0, 1, 2]),
    (['x', 'y', 'z', 'intensity'], [0, 1, 2, 3]),
    (['x', 'y', 'z', 'elongation'], [0, 1, 2, 5]),
    (['x', 'y', 'z', 'elongation', 'intensity'], [0, 1, 2, 5, 3])])
def test_used_subset_keeps_the_named_columns(used, cols):
    """OpenPCDet's rule: feature f comes from ``src_feature_list.index(f)``,
    in ``used_feature_list``'s order."""
    src = ['x', 'y', 'z', 'intensity', 'timestamp', 'elongation']
    data = _points(np.random.default_rng(1), 30, len(src))
    out = _encode(used, src, data)
    np.testing.assert_array_equal(out['points'],
                                  data['points'][:, cols].astype(np.float32))


def test_mm_encoding_keeps_every_column():
    rng = np.random.default_rng(2)
    data = _points(rng, 40, 8, rot_num=3)
    data['points_mm'] = rng.standard_normal((20, 8))
    out = _encode(XYZI, XYZI, data, 'absolute_coordinates_encoding_mm',
                  rot_num=3)
    for key in ('points', 'points1', 'points2', 'points_mm'):
        np.testing.assert_array_equal(out[key],
                                      data[key].astype(np.float32))


def test_jax_encoder_index_error_is_the_recorded_difference():
    """The JAX package's encoder reads column 3 + index on the same 4-column
    input: column 6, past the end."""
    data = _points(np.random.default_rng(3), 10, 4)
    cfg = JCfg({'encoding_type': 'absolute_coordinates_encoding',
                'used_feature_list': XYZI, 'src_feature_list': XYZI})
    with pytest.raises(IndexError):
        JaxEncoder(cfg).forward(dict(data))
    assert _encode(XYZI, XYZI, data)['points'].shape == (10, 4)
