"""The port's PENet (``virconv_tpu_torch/models/depth_completion/penet.py``,
``ops/cspn.py``) against the JAX package's
(``virconv_tpu/models/depth_completion/penet.py``) on the CPU, with the
JAX variables carried across by ``utils/jax_weights.from_jax_variables``
and every BN's scale, bias, mean and variance (> 0) drawn from a seed, so
that no BN is the identity.

Blocks (stride-1 and stride-2 ``ConvBnRelu``, both ``DeconvBnRelu``s,
``BasicBlockGeo`` with and without its down conv,
``sparse_downsample_close``, ``CSPNGuide``, ``cspn_step`` for k = 3, 5, 7
at dilation 1 and 2) agree within 1e-5 x the output scale; the whole
``PENetC2`` at 64 x 96 (JAX under ``jit``, compiled once per iteration
count) within 1e-4 x max|depth| at 2 and 6 iterations. The reference
checkpoint name map (``penet_import.py``) equals the JAX importer plus the
carry-across on a synthetic full reference state dict, and raises on a key
it cannot map."""
import functools

import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.models.depth_completion import penet as jp
from virconv_tpu.models.depth_completion import torch_import as jti
from virconv_tpu_torch.models.depth_completion import penet as tp
from virconv_tpu_torch.models.depth_completion import penet_import as pi
from virconv_tpu_torch.ops import cspn
from virconv_tpu_torch.utils.jax_weights import (from_jax_variables,
                                                 load_state_dict_checked)

torch.set_num_threads(2)
H, W = 64, 96
BLOCK_TOL = 1e-5
MODEL_TOL = 1e-4


def randomize(variables, seed):
    """The flax variables with every BN scale, bias, mean and variance
    drawn from ``seed`` (variance > 0)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, 'items'):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            if k in ('scale', 'var'):
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k in ('mean', 'bias'):
                v = rng.normal(0, 0.2, v.shape)
            out[k] = v.astype(np.float32)
        return out
    return {col: walk(tree) for col, tree in variables.items()}


def carried(module, variables):
    sd = from_jax_variables(variables)
    return load_state_dict_checked(module, sd).eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(x), -1, 1)))


def check(got, want, tol=BLOCK_TOL):
    got = got.detach().numpy()
    want = np.moveaxis(np.asarray(want), -1, 1)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def apply_block(jmod, tmod, inputs, seed=0, **kw):
    """Init ``jmod`` on the NHWC ``inputs``, randomize its BNs, carry it
    into ``tmod``; returns (JAX output, port output)."""
    jin = [jnp.asarray(x) for x in inputs]
    variables = randomize(jmod.init(jax.random.PRNGKey(seed), *jin,
                                    train=False, **kw), seed)
    want = jmod.apply(variables, *jin, train=False, **kw)
    tmod = carried(tmod, variables)
    with torch.no_grad():
        got = tmod(*[nchw(x) for x in inputs])
    return want, got


def feats(rng, c, h=16, w=24):
    return rng.normal(0, 1, (1, h, w, c)).astype(np.float32)


@pytest.mark.parametrize('stride', [1, 2])
def test_conv_bn_relu(stride):
    rng = np.random.default_rng(stride)
    want, got = apply_block(jp.ConvBnRelu(8, 5, stride),
                            tp.ConvBnRelu(6, 8, 5, stride), [feats(rng, 6)])
    check(got, want)


@pytest.mark.parametrize('kernel,stride', [(5, 2), (3, 1)])
def test_deconv_bn_relu(kernel, stride):
    rng = np.random.default_rng(kernel)
    want, got = apply_block(jp.DeconvBnRelu(4, kernel, stride),
                            tp.DeconvBnRelu(6, 4, kernel, stride),
                            [feats(rng, 6)])
    check(got, want)


@pytest.mark.parametrize('cin,planes,stride', [(8, 8, 1), (8, 16, 2),
                                               (12, 8, 1)])
def test_basic_block_geo(cin, planes, stride):
    rng = np.random.default_rng(cin + planes + stride)
    x, g1 = feats(rng, cin), feats(rng, 3)
    g2 = feats(rng, 3, 16 // stride, 24 // stride)
    tmod = tp.BasicBlockGeo(cin, planes, stride)
    assert tmod.has_down == (stride != 1 or cin != planes)
    want, got = apply_block(jp.BasicBlockGeo(planes, stride), tmod,
                            [x, g1, g2])
    check(got, want)


def test_sparse_downsample_close():
    rng = np.random.default_rng(3)
    d = (rng.uniform(size=(1, 16, 24, 1)) < 0.3) * rng.uniform(
        1, 80, (1, 16, 24, 1))
    d = d.astype(np.float32)
    mask = (d > 0).astype(np.float32)
    want = jp.sparse_downsample_close(jnp.asarray(d), jnp.asarray(mask))
    got = tp.sparse_downsample_close(nchw(d), nchw(mask))
    for g, w in zip(got, want):
        check(g, w, 0.0)


@pytest.mark.parametrize('k', [3, 5, 7])
def test_cspn_guide(k):
    rng = np.random.default_rng(k)
    want, got = apply_block(jp.CSPNGuide(k), tp.CSPNGuide(6, k),
                            [feats(rng, 6)])
    check(got, want)


@pytest.mark.parametrize('dilation', [1, 2])
@pytest.mark.parametrize('k', [3, 5, 7])
def test_cspn_step(k, dilation):
    rng = np.random.default_rng(10 * k + dilation)
    guide = rng.normal(0, 0.3, (1, 13, 17, k * k)).astype(np.float32)
    hn = rng.uniform(1, 60, (1, 13, 17, 1)).astype(np.float32)
    h0 = rng.uniform(1, 60, (1, 13, 17, 1)).astype(np.float32)
    want = jp.cspn_step(jnp.asarray(guide), jnp.asarray(hn),
                        jnp.asarray(h0), k, dilation)
    got = cspn.cspn_step(nchw(guide), nchw(hn), nchw(h0), k, dilation)
    check(got, want)


def test_cspn_iteration_plain_is_three_steps_and_the_blend():
    """One half-resolution iteration of ``ops/cspn`` against the JAX
    loop body on nearest-upsampled maps (the JAX s2 stage)."""
    rng = np.random.default_rng(5)
    hg, wg = 6, 9
    guides = [rng.normal(0, 0.3, (1, hg, wg, k * k)).astype(np.float32)
              for k in (3, 5, 7)]
    ds = [rng.uniform(1, 60, (1, 2 * hg, 2 * wg, 1)).astype(np.float32)
          for _ in range(3)]
    h0 = rng.uniform(1, 60, (1, 2 * hg, 2 * wg, 1)).astype(np.float32)
    mask = rng.uniform(0, 1, (1, hg, wg, 1)).astype(np.float32)
    dsp = rng.uniform(0, 60, (1, hg, wg, 1)).astype(np.float32)

    def up(x):
        return jnp.repeat(jnp.repeat(jnp.asarray(x), 2, 1), 2, 2)
    got = cspn.cspn_iteration([nchw(g) for g in guides],
                              [nchw(d) for d in ds], nchw(h0), nchw(mask),
                              nchw(dsp), 2, True)
    for k, g, d, out in zip((3, 5, 7), guides, ds, got):
        step = jp.cspn_step(up(g), jnp.asarray(d), jnp.asarray(h0), k, 2)
        want = up(mask) * up(dsp) + (1 - up(mask)) * step
        check(out, want, 0.0)


def penet_inputs(seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32)
    d = ((rng.uniform(size=(1, H, W, 1)) < 0.08)
         * rng.uniform(2, 60, (1, H, W, 1))).astype(np.float32)
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    pos = np.stack([2 * us / (W - 1) - 1, 2 * vs / (H - 1) - 1],
                   -1).astype(np.float32)[None]
    k = np.array([[[721.5, 0, W / 2], [0, 721.5, H / 2], [0, 0, 1]]],
                 np.float32)
    return rgb, d, pos, k


@pytest.fixture(scope='module')
def jax_penet():
    """Seeded JAX PENetC2 variables (BNs randomized) and its ``jit``
    forward per iteration count, each compiled once."""
    inputs = [jnp.asarray(x) for x in penet_inputs()]
    variables = jax.jit(functools.partial(jp.PENetC2().init, train=False))(
        jax.random.PRNGKey(0), *inputs)
    variables = randomize(jax.device_get(variables), 1)
    fwd = {it: jax.jit(functools.partial(jp.PENetC2(iters=it).apply,
                                         train=False))
           for it in (2, 6)}
    return variables, fwd


@pytest.mark.parametrize('iters', [2, 6])
def test_penet_c2_matches_jax(jax_penet, iters):
    variables, fwd = jax_penet
    inputs = penet_inputs()
    want = np.asarray(fwd[iters](variables, *[jnp.asarray(x)
                                              for x in inputs]))
    model = carried(tp.PENetC2(iters), variables)
    rgb, d, pos, k = inputs
    with torch.no_grad():
        got = model(nchw(rgb), nchw(d), nchw(pos), torch.from_numpy(k))
    scale = float(np.abs(want).max())
    err = float(np.abs(got.numpy() - np.moveaxis(want, -1, 1)).max())
    assert np.isfinite(want).all() and scale > 0
    assert err <= MODEL_TOL * scale, (err, scale)


def reference_state_dict(model, seed=0, prefix='module.'):
    """A synthetic reference PENet_C2 state dict: every parameter and BN
    statistic of ``model`` under its reference name (from the JAX
    importer's tables) with seeded values, the BN step counters and the
    one-hot ``encoder3/5/7`` buffers, behind the DataParallel prefix."""
    ours = model.state_dict()
    inverse = {}
    bn = ('weight', 'bias', 'running_mean', 'running_var',
          'num_batches_tracked')

    def seq(ref, port, deconv):
        inverse[f'{ref}.0.weight'] = \
            f'{port}.{"ConvTranspose_0" if deconv else "Conv_0"}.weight'
        for leaf in bn:
            inverse[f'{ref}.1.{leaf}'] = f'{port}.BatchNorm_0.{leaf}'
    for ref, (port, kind) in jti._ENET.items():
        if kind == 'basic':
            for rsub, (psub, k) in jti._BASIC.items():
                for leaf in (('weight',) if k == 'conv2d' else bn):
                    inverse[f'backbone.{ref}.{rsub}.{leaf}'] = \
                        f'backbone.{port}.{psub}.{leaf}'
        else:
            seq(f'backbone.{ref}', f'backbone.{port}', kind == 'deconv')
    for ref, port in jti._HEAD.items():
        if ref.startswith('iter_guide'):
            seq(f'{ref}.generate', f'{port}.generate', False)
        else:
            seq(ref, port, False)
    rng = np.random.default_rng(seed)
    sd = {}
    for ref, port in inverse.items():
        if port not in ours:
            continue                      # blocks without a down conv
        t = ours[port]
        val = rng.normal(0, 0.1, tuple(t.shape)).astype(np.float32)
        if ref.endswith('running_var'):
            val = np.abs(val) + 0.5
        sd[prefix + ref] = torch.tensor(val) if t.is_floating_point() \
            else torch.tensor(3)
    for k in (3, 5, 7):
        sd[f'{prefix}encoder{k}.weight'] = torch.zeros(k * k, 1, k, k)
    return sd


def test_reference_name_map_equals_jax_import(jax_penet):
    model = tp.PENetC2()
    sd = reference_state_dict(model)
    got = pi.import_penet_state_dict(sd)
    imported, unmapped = jti.import_penet_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    assert all(k.endswith('num_batches_tracked') for k in unmapped)
    want = from_jax_variables(imported)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the import covers the JAX model's tree and loads into the port
    jax_vars, _ = jax_penet
    for col in ('params', 'batch_stats'):
        have = {p for p, _ in jti._tree_paths(jax_vars[col])}
        assert have == {p for p, _ in jti._tree_paths(imported[col])}
    load_state_dict_checked(model, got)


@pytest.mark.parametrize('bad', ['backbone.rgb_conv_init.0.bias',
                                 'module.some_layer.weight',
                                 'iter_guide_layer3.conv.0.weight'])
def test_reference_name_map_raises_on_unknown_keys(bad):
    sd = {'backbone.rgb_conv_init.0.weight': torch.zeros(32, 4, 5, 5),
          bad: torch.zeros(1)}
    with pytest.raises(KeyError, match='do not map'):
        pi.import_penet_state_dict(sd)


def test_generation_slice_matches_jax(jax_penet, tmp_path, monkeypatch):
    """One frame of a scene tree through the whole slice at a 64 x 96
    crop: the port's ``prepare_frame`` and the JAX tool's give the same
    bits, the port's PENet on the carried weights gives the JAX depth
    within 1e-4 x max|depth|, and on the JAX depth the port's point fusion
    gives the JAX tool's float16 cloud bit for bit."""
    pytest.importorskip('cv2')
    import importlib.util
    from pathlib import Path
    from virconv_tpu.models.depth_completion import depth2points as jd
    from virconv_tpu.utils.calibration import Calibration as JaxCalibration
    from virconv_tpu_torch.models.depth_completion import virtual_points as vp
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    spec = importlib.util.spec_from_file_location(
        'jax_generate_virtual_points', Path(__file__).resolve().parent.parent
        / 'tools' / 'generate_virtual_points.py')
    jt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jt)
    for mod in (vp, jt):
        monkeypatch.setattr(mod, 'CROP_H', H)
        monkeypatch.setattr(mod, 'CROP_W', W)
    split = write_tree(tmp_path / 'kitti', 'scene', frames=1,
                       seed=2) / 'training'
    ours, theirs = vp.prepare_frame(split, '000000'), \
        jt.prepare_frame(split, '000000')
    for g, w in zip(ours[:5], theirs[:5]):
        np.testing.assert_array_equal(g, w)
    _, rgb_c, sparse, pos, k_mat, calib, lidar, _ = ours
    variables, fwd = jax_penet
    want = np.asarray(fwd[6](
        variables, jnp.asarray(rgb_c[None], jnp.float32),
        jnp.asarray(sparse[None, :, :, None]), jnp.asarray(pos[None]),
        jnp.asarray(k_mat[None])))[0, :, :, 0]
    gen = vp.VirtualPointGenerator(from_jax_variables(variables),
                                   device='cpu')
    got = gen.complete(rgb_c, sparse, pos, k_mat)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= MODEL_TOL * scale
    jc = theirs[5]
    crop = JaxCalibration({
        'P2': np.array([[k_mat[0, 0], 0, k_mat[0, 2], 0],
                        [0, k_mat[1, 1], k_mat[1, 2], 0], [0, 0, 1, 0]],
                       np.float32), 'R0': jc.R0, 'Tr_velo2cam': jc.V2C})
    fused = jd.fuse_virtual_and_lidar(
        jd.depth_to_points_rgb(want, rgb_c, crop), lidar)
    np.testing.assert_array_equal(
        vp.frame_points(want, rgb_c, k_mat, calib, lidar).view(np.uint16),
        fused.view(np.uint16))
