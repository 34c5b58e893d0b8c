"""``ops/gather_rows.py`` on the CPU: the masked row gather whose backward
the ROI pool's training gathers use (``models/roi_heads/voxel_pool.py``),
with a hot source row (gathered many times), an empty one, rows gathered
once and invalid positions (all pointing at row 0, as the pool's empty
slots do). Its forward equals ``index_select`` times the mask; its
backward equals a sequential ``index_add_`` of the masked gradient bit for
bit (the CPU's order, which the CUDA kernel keeps), and JAX's gradients of
``jnp.take`` and of the JAX pool's ``gather_rows``
(``virconv_tpu/models/roi_heads/voxel_pool.py``, a sorted segment sum)
within 1e-6 x the scale (XLA may add the duplicates in another order); its
CSR lists each row's valid positions in ascending order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.models.roi_heads import voxel_pool as jvp
from virconv_tpu_torch.ops import gather_rows as gr

torch.set_num_threads(1)


def inputs(seed, n=40, c=24, m=900):
    """feats (n, c), idx (m,) with row 3 hot (half the positions) and row 7
    never gathered, valid (m,) with a quarter invalid (pointing at row 0),
    and gradient rows (m, c)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, m)
    idx[rng.uniform(size=m) < 0.5] = 3
    idx[idx == 7] = 8
    valid = rng.uniform(size=m) >= 0.25
    idx[~valid] = 0
    feats = rng.normal(0, 1, (n, c)).astype(np.float32)
    g = rng.normal(0, 1, (m, c)).astype(np.float32)
    return feats, idx, valid, g


@pytest.mark.parametrize('seed', [0, 1])
def test_forward_and_backward_against_index_add_and_jax(seed):
    feats, idx, valid, g = inputs(seed)
    f = torch.tensor(feats, requires_grad=True)
    it, vt = torch.tensor(idx), torch.tensor(valid)
    out = gr.gather_rows(f, it, vt)
    assert torch.equal(out, torch.tensor(feats)[it] * vt[:, None])
    out.backward(torch.tensor(g))
    want = torch.zeros(feats.shape).index_add_(
        0, it, torch.tensor(g) * vt[:, None])
    assert torch.equal(f.grad, want)
    assert (f.grad[7] == 0).all()
    jv = jnp.asarray(valid)[:, None]
    jgrad = jax.grad(lambda x: jnp.sum(
        jnp.take(x, jnp.asarray(idx), axis=0) * jv * jnp.asarray(g)))(
        jnp.asarray(feats))
    pgrad = jax.grad(lambda x: jnp.sum(jvp.gather_rows(
        x, jnp.asarray(idx), jnp.asarray(valid)) * jnp.asarray(g)))(
        jnp.asarray(feats))
    for jax_grad in (jgrad, pgrad):
        scale = float(np.abs(np.asarray(jax_grad)).max())
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(jax_grad),
                                   rtol=0, atol=1e-6 * scale)


def test_sequential_sum_order():
    """The hot row's gradient is the left-to-right float32 sum of its
    valid rows in position order (what the kernel computes)."""
    feats, idx, valid, g = inputs(2)
    f = torch.tensor(feats, requires_grad=True)
    gr.gather_rows(f, torch.tensor(idx), torch.tensor(valid)).backward(
        torch.tensor(g))
    acc = np.zeros(feats.shape[1], np.float32)
    for i in np.flatnonzero((idx == 3) & valid):
        acc = acc + g[i]
    np.testing.assert_array_equal(f.grad[3].numpy(), acc)


def test_csr_lists_valid_positions_in_ascending_order():
    _, idx, valid, _ = inputs(3, n=12, m=200)
    order, offsets = gr.csr_of(torch.tensor(idx), torch.tensor(valid), 12)
    assert offsets[0] == 0 and offsets[-1] == valid.sum()
    for r in range(12):
        pos = order[offsets[r]:offsets[r + 1]].numpy()
        np.testing.assert_array_equal(pos, np.flatnonzero((idx == r)
                                                          & valid))


def test_index_shape_and_no_grad():
    feats, idx, valid, _ = inputs(4, m=60)
    idx2 = torch.tensor(idx).reshape(6, 10)
    valid2 = torch.tensor(valid).reshape(6, 10)
    with torch.no_grad():
        out = gr.gather_rows(torch.tensor(feats), idx2, valid2)
    assert out.shape == (60, feats.shape[1]) and not out.requires_grad
    assert torch.equal(out, torch.tensor(feats)[idx2.reshape(-1)]
                       * valid2.reshape(-1, 1))
    with pytest.raises(ValueError):
        gr.gather_rows(torch.zeros(5), idx2, valid2)
    with pytest.raises(ValueError):
        gr.gather_rows(torch.tensor(feats), idx2, valid2[:3])
