"""The port's map of reference VirConv (OpenPCDet) checkpoints
(``utils/reference_import.py``) against the JAX package's
(``virconv_tpu/utils/torch_import.py`` followed by
``utils/jax_weights.from_jax_variables``).

No reference checkpoint is in the repository, so the state dicts are
synthetic: every parameter and BN statistic of the port's full-width
VirConv-T and VirConv-L, under its reference name and in the reference's
layout (spconv 1.x and 2.x kernels, the image-plane convs as 4-D 2D
kernels, ``ConvTranspose2d`` deblocks, packed attention projections, 1x1
conv pool MLPs, a ``num_batches_tracked`` beside every BN), with seeded
values. The JAX importer reads 5-D spconv kernels only, so it is handed
the 2D kernels with a unit z axis, (1, ky, kx, in, out), which is the same
array.

For VirConv-T the two maps agree key for key and bit for bit; for VirConv-L
on every key but ``backbone_3d.conv_out.*``, which the JAX map sends to the
LiDAR stack that L does not have and the port to L's own ``conv_out``. No
key is left unmapped and the BN step counters are reported as skipped.
Then a conv, the first BEV conv (the height-compression channel order) and
the attention give the same outputs under the reference's layout and both
imports (1e-4 / 1e-5)."""
import jax
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virconv_tpu.utils import torch_import as ti
from virconv_tpu_torch.config import CONFIGS
from virconv_tpu_torch.models.detectors.voxel_rcnn import VoxelRCNN
from virconv_tpu_torch.utils import reference_import as ri
from virconv_tpu_torch.utils.jax_weights import (from_jax_variables,
                                                 load_state_dict_checked)

torch.set_num_threads(1)

LIDAR = {'conv_input': 'conv_input', 'conv1': 'conv1.0',
         'conv2_down': 'conv2.0', 'conv2_a': 'conv2.1', 'conv2_b': 'conv2.2',
         'conv3_down': 'conv3.0', 'conv3_a': 'conv3.1', 'conv3_b': 'conv3.2',
         'conv4_down': 'conv4.0', 'conv4_a': 'conv4.1', 'conv4_b': 'conv4.2',
         'conv_out': 'conv_out'}
NR = {'down': 'down_layer.0', 'd3_conv1': 'd3_conv1.0',
      'd3_conv2': 'd3_conv2.0', 'd2_conv1': 'd2_conv1.0',
      'd2_conv2': 'd2_conv2.0'}
HEADS = {'shared_fc': 'shared_fc_layers',
         'shared_fc_mm': 'shared_fc_layers_mm',
         'cls_head': 'cls_layers', 'reg_head': 'reg_layers',
         'cls_head_pi': 'cls_layers_PI', 'reg_head_pi': 'reg_layers_PI',
         'cls_head_p': 'cls_layers_P', 'reg_head_p': 'reg_layers_P'}
MLPS = {'mlp_in': 'mlps_in', 'mlp_pos': 'mlps_pos', 'mlp_out': 'mlps_out'}


def spconv_ref(name, shape, rng):
    """A reference spconv weight for a port kernel (K, in, out): spconv 1.x
    (*spatial, in, out) for the LiDAR stack, the image-plane 2D convs
    (4-D) and the NRConv down convs, spconv 2.x (out, *spatial, in) for
    the NRConv 3D convs."""
    k, c_in, c_out = shape
    spatial = {27: (3, 3, 3), 9: (3, 3), 3: (3, 1, 1)}[k]
    w = rng.standard_normal(spatial + (c_in, c_out)).astype(np.float32)
    if '.d3_conv' in name:
        return np.ascontiguousarray(np.moveaxis(w, -1, 0))
    return w


def bn_entries(ref, port_name, shape, rng):
    leaf = port_name.rsplit('.', 1)[1]
    if leaf == 'running_var':
        v = rng.uniform(0.5, 1.5, shape)
    else:
        v = rng.standard_normal(shape)
    out = {f'{ref}.{leaf}': v.astype(np.float32)}
    if leaf == 'weight':
        out[f'{ref}.num_batches_tracked'] = np.int64(7)
    return out


def reference_state_dict(model, seed):
    """A reference-named, reference-laid-out state dict with one entry (and
    its BN counter) for every parameter and statistic of ``model``."""
    rng = np.random.default_rng(seed)
    sd = {}
    attn = {}
    for name, t in model.state_dict().items():
        if name.endswith('num_batches_tracked'):
            continue
        shape = tuple(t.shape)
        parts = name.split('.')
        head, *rest = parts
        leaf = parts[-1]
        if head == 'backbone':
            if rest[0] == 'mm':
                ref = f'backbone_3d.{rest[1]}.{NR[rest[2]]}'
            else:
                mod = rest[1] if rest[0] == 'lidar' else rest[0]
                ref = f'backbone_3d.{LIDAR[mod]}'
            if leaf == 'kernel':
                sd[f'{ref}.0.weight'] = spconv_ref(name, shape, rng)
            else:
                sd.update(bn_entries(f'{ref}.1', name, shape, rng))
        elif head == 'bev_backbone':
            mod = rest[0]
            i = int(mod[5]) if mod.startswith('block') else int(mod[7])
            if mod.endswith('_down'):
                j = 1 if rest[1] == 'Conv_0' else 2
            elif '_conv' in mod:
                k = int(mod.split('_conv')[1])
                j = 4 + 3 * k if rest[1] == 'Conv_0' else 5 + 3 * k
            else:
                j = 1 if mod.endswith('_bn') else 0
            seq = 'deblocks' if 'deblock' in mod else 'blocks'
            ref = f'backbone_2d.{seq}.{i}.{j}'
            if leaf == 'weight' and len(shape) == 4:
                if 'deblock' in mod and shape[2] == 1:   # 1x1 ConvTranspose
                    shape = (shape[1], shape[0], 1, 1)
                sd[f'{ref}.weight'] = rng.standard_normal(shape).astype(
                    np.float32)
            else:
                sd.update(bn_entries(ref, name, shape, rng))
        elif head == 'dense_head':
            ref = {'conv_dir': 'conv_dir_cls'}.get(rest[0], rest[0])
            sd[f'dense_head.{ref}.{leaf}'] = rng.standard_normal(
                shape).astype(np.float32)
        elif rest[0] in HEADS:
            base = f'roi_head.{HEADS[rest[0]]}.0'
            if rest[1] == 'out':
                sd[f'{base}.7.{leaf}'] = rng.standard_normal(shape).astype(
                    np.float32)
            elif rest[1].startswith('fc'):
                sd[f'{base}.{4 * int(rest[1][2:])}.weight'] = \
                    rng.standard_normal(shape).astype(np.float32)
            else:
                sd.update(bn_entries(f'{base}.{4 * int(rest[1][2:]) + 1}',
                                     name, shape, rng))
        elif rest[0].startswith('cross_attn'):
            fam = 'cross_attention_layers' + ('_mm' if rest[0].endswith('mm')
                                              else '')
            base = f'roi_head.{fam}.0'
            v = rng.standard_normal(shape).astype(np.float32)
            if rest[1] in ('q', 'k', 'v'):
                sd[f'{base}.{rest[1].upper()}_linear.weight'] = v
            elif rest[2] == 'out':
                sd[f'{base}.att.out_proj.{leaf}'] = v
            else:
                attn.setdefault((base, leaf), {})[rest[2]] = v
        elif rest[0].startswith('part_conv'):
            if rest[0] == 'part_conv2':
                ref = 'roi_head.conv_part.3'
            else:
                ref = 'roi_head.conv_part.' + ('0' if rest[1] == 'Conv_0'
                                               else '1')
            if rest[-2] in ('Conv_0', 'part_conv2'):
                sd[f'{ref}.weight'] = rng.standard_normal(shape).astype(
                    np.float32)
            else:
                sd.update(bn_entries(ref, name, shape, rng))
        elif rest[0].startswith('pool'):
            fam = 'roi_grid_pool_layers' + ('_mm' if 'pool_mm' in rest[0]
                                            else '')
            k = ['x_conv3', 'x_conv4'].index(rest[0][-7:])
            mlp = rest[1].rstrip('0123456789')
            g = int(rest[1][len(mlp):])
            is_bn = mlp.endswith('_bn')
            ref = f'roi_head.{fam}.{k}.{MLPS[mlp[:-3] if is_bn else mlp]}' \
                  f'.{g}.{1 if is_bn else 0}'
            if is_bn:
                sd.update(bn_entries(ref, name, shape, rng))
            elif mlp == 'mlp_pos':                  # Conv2d (mid, 3, 1, 1)
                sd[f'{ref}.weight'] = rng.standard_normal(
                    (shape[1], shape[0], 1, 1)).astype(np.float32)
            else:                                   # Conv1d (out, in, 1)
                sd[f'{ref}.weight'] = rng.standard_normal(
                    shape + (1,)).astype(np.float32)
        else:
            raise AssertionError(f'no reference name for {name}')
    for (base, leaf), qkv in attn.items():
        key = 'in_proj_weight' if leaf == 'weight' else 'in_proj_bias'
        sd[f'{base}.att.{key}'] = np.concatenate(
            [qkv['query'], qkv['key'], qkv['value']])
    return sd


def jax_readable(sd):
    """The 4-D 2D spconv kernels with a unit z axis, the only spconv rank
    the JAX importer reads."""
    return {k: v[None] if np.ndim(v) == 4 and '.d2_conv' in k else v
            for k, v in sd.items()}


@pytest.fixture(scope='module', params=['virconv_t', 'virconv_l'])
def imports(request):
    name = request.param
    cfg = CONFIGS[name]()
    model = VoxelRCNN(cfg.MODEL, cfg.DATA_CONFIG)
    ref = reference_state_dict(model, seed=1 if name == 'virconv_t' else 2)
    skipped = []
    got, unmapped = ri.import_reference_state_dict(ref, cfg, skipped=skipped)
    variables, junmapped = ti.import_state_dict(jax_readable(ref),
                                                report_unmapped=False)
    want = from_jax_variables(variables)
    return name, cfg, model, ref, got, unmapped, skipped, want, junmapped


def test_every_key_is_mapped_and_loads(imports):
    name, cfg, model, ref, got, unmapped, skipped, _, junmapped = imports
    counters = sorted(k for k in ref if k.endswith('num_batches_tracked'))
    assert unmapped == []
    assert sorted(skipped) == counters and counters
    assert sorted(junmapped) == counters     # the JAX map skips them too
    load_state_dict_checked(model, got)
    assert set(got) == {k for k in model.state_dict()
                        if not k.endswith('num_batches_tracked')}


def test_port_map_equals_jax_map(imports):
    name, _, _, _, got, _, _, want, _ = imports
    if name == 'virconv_l':
        # the JAX map's one divergence: conv_out under the LiDAR stack
        moved = {k: k.replace('backbone.lidar.conv_out',
                              'backbone.conv_out') for k in want}
        assert sum(k != v for k, v in moved.items()) == 5
        want = {moved[k]: v for k, v in want.items()}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v), k


def test_conv_out_follows_the_backbone(imports):
    name, _, model, ref, got, _, _, _, _ = imports
    w = ri.spconv_kernel_to_gathered(ref['backbone_3d.conv_out.0.weight'])
    where = 'backbone.lidar.conv_out' if name == 'virconv_t' \
        else 'backbone.conv_out'
    assert torch.equal(got[f'{where}.kernel'], torch.from_numpy(w))
    assert tuple(got[f'{where}.kernel'].shape) == (3, 64, 64)


def test_submanifold_conv_equals_dense_reference_conv(imports):
    """A fully occupied 5x5x5 grid: the port's submanifold conv with an
    imported kernel equals torch's dense conv3d with the reference weight
    (spconv's correlation, padding 1), for a 2.x and a 1.x kernel, and the
    JAX nmap conv with the JAX import's kernel; and a 2D image-plane
    kernel (4-D) against conv2d."""
    from virconv_tpu.ops import sparse as jsp
    from virconv_tpu_torch.ops import sparse as tsp
    name, _, _, ref, got, _, _, want, _ = imports
    rng = np.random.default_rng(3)
    g = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing='ij'),
                 -1).reshape(-1, 3)
    coords = np.concatenate([np.zeros((125, 1)), g], 1).astype(np.int32)
    for port_name, ref_key, layout in (
            ('backbone.mm.vir_conv1.d3_conv1.kernel',
             'backbone_3d.vir_conv1.d3_conv1.0.0.weight', 'v2'),
            ('backbone.mm.vir_conv2.down.kernel',
             'backbone_3d.vir_conv2.down_layer.0.0.weight', 'v1')):
        w_ref = ref[ref_key]
        c_in = got[port_name].shape[1]
        feats = rng.standard_normal((125, c_in)).astype(np.float32)
        dense_w = torch.from_numpy(
            np.moveaxis(w_ref, 4, 1) if layout == 'v2'
            else w_ref.transpose(4, 3, 0, 1, 2).copy())
        x = torch.from_numpy(feats.T.reshape(1, c_in, 5, 5, 5).copy())
        dense = torch.nn.functional.conv3d(x, dense_w, padding=1)[0]
        dense = dense.reshape(dense.shape[0], -1).T
        st = tsp.SparseTensor(feats=torch.from_numpy(feats),
                              coords=torch.from_numpy(coords),
                              mask=torch.ones(125, dtype=torch.bool),
                              spatial_shape=(5, 5, 5), batch_size=1)
        port = tsp.nmap_subm_conv_ctx(st, 3)(st.feats, got[port_name])
        torch.testing.assert_close(port, dense, atol=1e-4, rtol=1e-4)
        jst = jsp.SparseTensor(feats=jnp.asarray(feats),
                               coords=jnp.asarray(coords),
                               mask=jnp.ones(125, bool),
                               spatial_shape=(5, 5, 5), batch_size=1)
        jout = jsp.subm_conv_ctx(jst, 3, use_band=False).conv(
            jnp.asarray(feats), jnp.asarray(want[port_name].numpy()))
        np.testing.assert_allclose(np.asarray(jout), port.numpy(),
                                   atol=1e-4, rtol=1e-4)
    # the image-plane conv: a 4-D reference kernel (ky, kx, in, out)
    w2 = ref['backbone_3d.vir_conv1.d2_conv1.0.0.weight']
    assert w2.ndim == 4
    g2 = np.stack(np.meshgrid(np.arange(6), np.arange(7), indexing='ij'),
                  -1).reshape(-1, 2)
    c2 = np.concatenate([np.zeros((42, 1)), g2], 1).astype(np.int32)
    f2 = rng.standard_normal((42, w2.shape[2])).astype(np.float32)
    st2 = tsp.SparseTensor(feats=torch.from_numpy(f2),
                           coords=torch.from_numpy(c2),
                           mask=torch.ones(42, dtype=torch.bool),
                           spatial_shape=(6, 7), batch_size=1)
    port2 = tsp.nmap_subm_conv_ctx(st2, 3)(
        st2.feats, got['backbone.mm.vir_conv1.d2_conv1.kernel'])
    dense2 = torch.nn.functional.conv2d(
        torch.from_numpy(f2.T.reshape(1, -1, 6, 7).copy()),
        torch.from_numpy(w2.transpose(3, 2, 0, 1).copy()), padding=1)[0]
    torch.testing.assert_close(port2, dense2.reshape(dense2.shape[0], -1).T,
                               atol=1e-4, rtol=1e-4)


def test_first_bev_conv_sees_the_reference_channel_order(imports):
    """The reference's first BEV conv over its (C * D) height-compressed
    map equals the port's over ``height_compression``'s (D * C) order with
    the imported (permuted) kernel, and the JAX conv with the JAX
    import's."""
    from flax import linen as nn
    from virconv_tpu_torch.models.backbones_2d.bev import height_compression
    from virconv_tpu_torch.ops import sparse as tsp
    name, cfg, _, ref, got, _, _, want, _ = imports
    c = cfg.MODEL.BACKBONE_3D.OUT_FEATURES
    d = cfg.MODEL.MAP_TO_BEV.NUM_BEV_FEATURES // c
    h, w = 6, 5
    rng = np.random.default_rng(4)
    dense = rng.standard_normal((1, c, d, h, w)).astype(np.float32)
    w_ref = ref['backbone_2d.blocks.0.1.weight']
    want_out = torch.nn.functional.conv2d(
        torch.from_numpy(dense.reshape(1, c * d, h, w)),
        torch.from_numpy(w_ref), padding=1)
    g = np.stack(np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing='ij'), -1).reshape(-1, 3)
    st = tsp.SparseTensor(
        feats=torch.from_numpy(dense[0].reshape(c, -1).T.copy()),
        coords=torch.from_numpy(np.concatenate(
            [np.zeros((len(g), 1)), g], 1).astype(np.int32)),
        mask=torch.ones(len(g), dtype=torch.bool), spatial_shape=(d, h, w),
        batch_size=1)
    bev = height_compression(st)                       # (1, H, W, D * C)
    port_out = torch.nn.functional.conv2d(
        bev.permute(0, 3, 1, 2), got['bev_backbone.block0_down.Conv_0.weight'],
        padding=1)
    torch.testing.assert_close(port_out, want_out, atol=1e-4, rtol=1e-4)
    kernel = want['bev_backbone.block0_down.Conv_0.weight'].numpy()
    jconv = nn.Conv(kernel.shape[0], (3, 3), padding=1, use_bias=False)
    jout = jconv.apply({'params': {'kernel': jnp.asarray(
        kernel.transpose(2, 3, 1, 0))}}, jnp.asarray(bev.numpy()))
    np.testing.assert_allclose(np.asarray(jout).transpose(0, 3, 1, 2),
                               want_out.numpy(), atol=1e-4, rtol=1e-4)


def test_attention_equals_torch_multihead_attention(imports):
    """torch's ``nn.MultiheadAttention`` with the reference's packed
    projections equals the port's attention with the imported ones."""
    from virconv_tpu_torch.models.roi_heads.ted_head import \
        MultiHeadAttention
    name, _, _, ref, got, _, _, _, _ = imports
    base = 'roi_head.cross_attention_layers.0.att'
    e = ref[f'{base}.out_proj.weight'].shape[0]
    att = torch.nn.MultiheadAttention(e, 4)
    att.load_state_dict({
        'in_proj_weight': torch.from_numpy(ref[f'{base}.in_proj_weight']),
        'in_proj_bias': torch.from_numpy(ref[f'{base}.in_proj_bias']),
        'out_proj.weight': torch.from_numpy(ref[f'{base}.out_proj.weight']),
        'out_proj.bias': torch.from_numpy(ref[f'{base}.out_proj.bias'])})
    port = MultiHeadAttention(e, 4)
    port.load_state_dict({k[len('roi_head.cross_attn.mha.'):]: v
                          for k, v in got.items()
                          if k.startswith('roi_head.cross_attn.mha.')})
    rng = np.random.default_rng(5)
    # inputs at 1 / E: the unit-normal projections keep the logits O(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 4, e)).astype(
        np.float32) / e) for _ in range(3))          # (L, B, E)
    with torch.no_grad():
        want, _ = att(q, k, v)
        out = port(q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1))
    scale = float(want.abs().max())
    err = float((out.transpose(0, 1) - want).abs().max())
    assert err <= 1e-5 * scale, (err, scale)
