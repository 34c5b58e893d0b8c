"""The port's ODIoU loss (virconv_tpu_torch/ops/odiou.py) against the JAX
package's (virconv_tpu/ops/odiou.py) on seeded box pairs: random pairs,
pairs with coincident corners (a box and itself, and a box and its copy
turned by pi), pairs whose boxes share a center, headings of +-pi/2, and
pairs with a zero or negative size, which ``ok`` masks. ``odiou_3d``,
``odiou_3d_weighted`` and ``odiou_3d_loss`` within rtol 1e-4 / atol 1e-5;
the gradients of ``odiou_3d_weighted`` with respect to both box sets
against ``jax.grad`` within 1e-3 x the max |JAX gradient|, with no NaN on
either side.

The pairs whose headings differ by pi (a box and its copy turned by pi,
headings pi/2 and -pi/2) carry weight 0 in the gradient test: their
edges are anti-parallel, so candidate directions of the minimum-area
rectangle tie up to the round-off of sin(pi) (~1e-7), and which one the
argmin takes, and with it the gradient (up to ~25 against 0 for one
heading), follows each library's cos and sin. Their forward values agree
(the test above), and their zero weight still carries any NaN into the
gradient."""
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.ops import odiou as jod
from virconv_tpu_torch.ops import odiou as tod

torch.set_num_threads(1)


def box_pairs(seed, n=48):
    """(gt, pred, weights) of n seeded pairs covering the edge cases."""
    rng = np.random.default_rng(seed)
    g = np.zeros((n, 7), np.float32)
    g[:, 0:2] = rng.uniform(-20, 20, (n, 2))
    g[:, 2] = rng.uniform(-2, 1, n)
    g[:, 3:6] = rng.uniform(0.5, 4.5, (n, 3))
    g[:, 6] = rng.uniform(-np.pi, np.pi, n)
    q = g + np.concatenate([rng.normal(0, 0.3, (n, 3)),
                            rng.normal(0, 0.2, (n, 3)),
                            rng.normal(0, 0.4, (n, 1))], 1).astype(np.float32)
    q[:, 3:6] = np.abs(q[:, 3:6]) + 0.1
    q[0:4] = g[0:4]                                   # coincident corners
    q[4:6] = g[4:6]
    q[4:6, 6] += np.float32(np.pi)                    # the same corners
    q[6:9, :3] = g[6:9, :3]                           # a shared center
    g[9:13, 6] = [np.pi / 2, -np.pi / 2, np.pi / 2, -np.pi / 2]
    q[9:13, 6] = [np.pi / 2, np.pi / 2, -np.pi / 2, 0.0]
    g[13, 3] = 0.0                                    # masked by ok
    q[14, 5] = 0.0
    q[15, 4] = -1.0
    w = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return g, q, w


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_odiou_forward_matches_jax(seed):
    g, q, w = box_pairs(seed)
    tg, tq, tw = (torch.from_numpy(x) for x in (g, q, w))
    want = np.asarray(jod.odiou_3d(jnp.asarray(g), jnp.asarray(q)))
    got = tod.odiou_3d(tg, tq).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert (got[13:16] == 0).all() and (want[13:16] == 0).all()
    np.testing.assert_allclose(
        float(tod.odiou_3d_weighted(tg, tq, tw, 2)),
        float(jod.odiou_3d_weighted(jnp.asarray(g), jnp.asarray(q),
                                    jnp.asarray(w), 2)),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        tod.odiou_3d_loss(tq, tg, tw).numpy(),
        np.asarray(jod.odiou_3d_loss(jnp.asarray(q), jnp.asarray(g),
                                     jnp.asarray(w))),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        tod.odiou_3d_loss(tq, tg).numpy(),
        np.asarray(jod.odiou_3d_loss(jnp.asarray(q), jnp.asarray(g))),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_odiou_gradients_match_jax(seed):
    g, q, w = box_pairs(seed)
    w[[4, 5, 10, 11]] = 0.0
    jg, jq = jax.grad(lambda a, b: jod.odiou_3d_weighted(
        a, b, jnp.asarray(w), 2), argnums=(0, 1))(jnp.asarray(g),
                                                   jnp.asarray(q))
    tg = torch.from_numpy(g).requires_grad_(True)
    tq = torch.from_numpy(q).requires_grad_(True)
    tod.odiou_3d_weighted(tg, tq, torch.from_numpy(w), 2).backward()
    for got, want in ((tg.grad, jg), (tq.grad, jq)):
        want = np.asarray(want)
        assert np.isfinite(want).all() and torch.isfinite(got).all()
        scale = float(np.abs(want).max())
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-3 * scale, (err, scale)
    # the masked pairs get no gradient
    assert (tg.grad[13:16] == 0).all() and (tq.grad[13:16] == 0).all()
