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

import nms_cases
from virconv_tpu.models.dense_heads import anchor_head as jah
from virconv_tpu.ops import boxes as jbox
from virconv_tpu_torch.models.dense_heads import anchor_head as tah
from virconv_tpu_torch.ops import boxes as tbox
from virconv_tpu_torch.ops import boxes_np

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


def masked_scatter_select(sup, top_valid, order, post_max, num_iters=8):
    """The fixed point and compaction ``nms_bev`` ran per entry before the
    kernel pair: a scatter through a boolean-mask index (one host sync)."""
    k = top_valid.shape[0]
    keep = torch.ones((k,), dtype=torch.bool)
    for _ in range(num_iters):
        keep = ~(sup & keep[None, :]).any(1) & top_valid
    rank = torch.cumsum(keep.to(torch.int32), 0) - 1
    src = torch.where(keep & (rank < post_max), rank,
                      torch.full_like(rank, post_max)).long()
    sel = torch.zeros((post_max + 1,), dtype=torch.long)
    sel[src[keep & (rank < post_max)]] = order[keep & (rank < post_max)]
    sel = sel[:post_max]
    count = torch.clamp(keep.sum(), max=post_max)
    sel_valid = torch.arange(post_max) < count
    return torch.where(sel_valid, sel, torch.zeros_like(sel)), sel_valid


@pytest.mark.parametrize('case', nms_cases.CASES)
def test_batched_nms_equals_the_plain_loop_and_jax(case):
    """``nms_bev_batched`` on CPU tensors (``nms_bev_plain``, counted as
    ``nms_counts['plain']``) gives each entry's ``nms_bev``, which is
    JAX's; and its compaction, with no boolean-mask index, gives the same
    selections as the old masked scatter on the same suppression."""
    c = nms_cases.make(case, full=False)
    boxes, scores, valid = (torch.from_numpy(c[k])
                            for k in ('boxes', 'scores', 'valid'))
    b = boxes.shape[0]
    args = (c['thresh'], c['pre'], c['post'])
    n0 = tbox.nms_counts['plain']
    sel, sel_valid = tbox.nms_bev_batched(boxes, scores, *args, valid=valid)
    assert tbox.nms_counts['plain'] == n0 + b
    assert sel.shape == sel_valid.shape == (b, c['post'])
    order, top_valid, top = tbox.nms_top_k(boxes, scores, c['pre'], valid)
    sup = tbox.nms_sup_plain(top, top_valid, c['thresh'])
    jax_nms = jax.jit(jbox.nms_bev, static_argnums=(2, 3, 4))
    for i in range(b):
        want = tbox.nms_bev(boxes[i], scores[i], *args, valid=valid)
        jsel, jval = jax_nms(jnp.asarray(c['boxes'][i]),
                             jnp.asarray(c['scores'][i]), *args,
                             valid=jnp.asarray(c['valid']))
        old = masked_scatter_select(sup[i], top_valid[i], order[i],
                                    c['post'])
        for got_sel, got_valid in ((sel[i], sel_valid[i]), old):
            np.testing.assert_array_equal(got_sel.numpy(), want[0].numpy())
            np.testing.assert_array_equal(got_valid.numpy(),
                                          want[1].numpy())
        np.testing.assert_array_equal(sel[i].numpy(), _np(jsel))
        np.testing.assert_array_equal(sel_valid[i].numpy(), _np(jval))
    kept = int(sel_valid.sum())
    if case == 'invalid':
        assert kept == 0
    elif case == 'few':
        assert 0 < int(sel_valid.sum(1).max()) < c['post']
    elif case == 'chain':
        # 8 passes of the fixed point are not greedy NMS here
        greedy = boxes_np.nms_bev(c['boxes'][0], c['scores'][0],
                                  c['thresh'], c['pre'], c['post'])
        assert set(sel[0][sel_valid[0]].tolist()) != set(greedy.tolist())
    else:
        assert kept > 0 and bool(sup.any())


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


@pytest.mark.parametrize('seed', [0, 1])
def test_points_in_boxes_matches_jax(seed):
    """``points_in_boxes`` exactly (int32): points inside one box, inside
    several overlapping boxes (the first wins), on no box, and boxes
    given twice."""
    rng = np.random.default_rng(seed)
    boxes = _random_boxes(rng, 24)
    boxes[20:] = boxes[:4]                             # repeated boxes
    inside = boxes[rng.integers(0, 24, 300), :3] + rng.uniform(
        -0.6, 0.6, (300, 3)).astype(np.float32)
    far = rng.uniform(-30, 30, (100, 3)).astype(np.float32)
    far[:, 2] += 20.0                                  # above every box
    pts = np.concatenate([inside, far, rng.uniform(
        -8, 8, (200, 3)).astype(np.float32)])
    want = _np(jbox.points_in_boxes(jnp.asarray(pts), jnp.asarray(boxes)))
    got = tbox.points_in_boxes(torch.from_numpy(pts),
                               torch.from_numpy(boxes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the cases are there: points in no box, and points in two or more
    # boxes (repeated or overlapping), which take the first
    multi = np.zeros(len(pts), int)
    for j in range(len(boxes)):
        multi += _np(jbox.points_in_boxes(jnp.asarray(pts),
                                          jnp.asarray(boxes[j:j + 1]))) == 0
    assert (want == -1).any() and (multi >= 2).any()
