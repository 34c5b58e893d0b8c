"""Port box ops, anchors and anchor mask (virconv_tpu_torch.ops.boxes,
models.dense_heads.anchor_head) vs the JAX package: rotated BEV IoU at
atol 1e-5, box decoding f32-close, NMS keep sets and anchor masks exactly
(ties keep the lower index first, as XLA's top_k does)."""
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.models.dense_heads import anchor_head as jah
from virconv_tpu.ops import boxes as jbox
from virconv_tpu_torch.models.dense_heads import anchor_head as tah
from virconv_tpu_torch.ops import boxes as tbox

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x)


def _random_boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(-6, 6, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(1, 4, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[:5] = b[5:10]                                   # identical boxes
    b[10:15, :6] = b[15:20, :6]
    b[10:15, 6] = b[15:20, 6] + np.pi / 2             # rotated copies
    return b


def test_box_ops_match_jax():
    rng = np.random.default_rng(3)
    a, b = _random_boxes(rng, 60), _random_boxes(rng, 40)
    np.testing.assert_allclose(
        tbox.boxes_iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        _np(jbox.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b))), atol=1e-5)
    enc = rng.standard_normal((60, 7)).astype(np.float32)
    enc[0, 3] = 30.0                                   # exercises the clamp
    coder_j, coder_t = jbox.ResidualCoder(), tbox.ResidualCoder()
    np.testing.assert_allclose(
        coder_t.decode(torch.from_numpy(enc), torch.from_numpy(a)).numpy(),
        _np(coder_j.decode(jnp.asarray(enc), jnp.asarray(a))), rtol=1e-6,
        atol=1e-5)
    scores = rng.uniform(size=60).astype(np.float32)
    scores[20:30] = scores[30:40]                      # exact ties
    valid = rng.uniform(size=60) > 0.2
    jsel, jval = jbox.nms_bev(jnp.asarray(a), jnp.asarray(scores), 0.1, 50,
                              30, valid=jnp.asarray(valid))
    tsel, tval = tbox.nms_bev(torch.from_numpy(a), torch.from_numpy(scores),
                              0.1, 50, 30, valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(tsel.numpy(), _np(jsel))
    np.testing.assert_array_equal(tval.numpy(), _np(jval))


@pytest.mark.parametrize('bev_shape', [(200, 176), (160, 160)])
def test_anchor_mask_and_anchors_match_jax(bev_shape):
    rng = np.random.default_rng(4)
    pcr = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
    xy = rng.uniform([-2, -45], [75, 45], (3000, 2)).astype(np.float32)
    m = rng.uniform(size=3000) > 0.3
    want = jah.compute_anchor_mask(jnp.asarray(xy), jnp.asarray(m), pcr,
                                   bev_shape)
    got = tah.compute_anchor_mask(torch.from_numpy(xy), torch.from_numpy(m),
                                  pcr, bev_shape)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert not got[:, -(bev_shape[1] % 10 or 1):].any() or \
        bev_shape[1] % 10 == 0
    args = (pcr, (1408, 1600), 8, [[3.9, 1.6, 1.56]], [0, 1.57], [-1.78])
    np.testing.assert_array_equal(tah.generate_anchors(*args)[0],
                                  jah.generate_anchors(*args)[0])
