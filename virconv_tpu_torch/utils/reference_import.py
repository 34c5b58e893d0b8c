"""Load a reference VirConv (OpenPCDet) checkpoint into the port.

The port's counterpart of ``virconv_tpu/utils/torch_import.py``: the same
name map from the reference detector's ``state_dict`` keys
(``backbone_3d.conv_input/conv1..4/conv_out/vir_conv1..4``,
``backbone_2d.blocks/deblocks``, ``dense_head.conv_cls/conv_box/
conv_dir_cls``, ``roi_head.{shared_fc_layers, cross_attention_layers, cls/
reg_layers(_PI/_P), conv_part, roi_grid_pool_layers}`` and their ``_mm``
twins), sent straight to the port's parameter names (the flax module
paths, ``utils/jax_weights.py``) and layouts:

* spconv kernels: spconv 2.x (out, kz, ky, kx, in) or spconv 1.x
  (kz, ky, kx, in, out), and the image-plane 2D kernels' (out, ky, kx, in)
  or (ky, kx, in, out) -> the gathered (K, in, out), taps first-axis major;
  1.x wins where the shape fits both, as official checkpoints are 1.x;
* the first BEV conv's in-channels permuted from the reference's height
  compression (channel c * D + d) to the port's (d * C + c);
* the stride-1 ``deblocks`` (reference ``ConvTranspose2d`` (in, out, 1, 1))
  into the port's 1x1 ``Conv2d`` (out, in, 1, 1); the strided ones as is;
* ``nn.MultiheadAttention``'s packed ``in_proj_weight`` / ``in_proj_bias``
  split into the query, key and value projections;
* the pool MLPs' 1x1 convs into ``Linear`` weights (the position MLP into
  its bare (3, mid) kernel).

One divergence from the JAX map, by configuration: its ``translate_path``
sends ``backbone_3d.conv_out.*`` to the LiDAR stack's ``conv_out``, which
VirConv-L does not have; its ``conv_out`` is the backbone's own
(``backbone.conv_out``), and this map sends it there when
``BACKBONE_3D.NAME`` is ``VirConvL8x``.

    sd, unmapped = import_reference_state_dict(torch.load(path)['model_state'],
                                               cfg)
    load_state_dict_checked(model, sd)
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import CfgNode

BN_LEAVES = {'weight': 'weight', 'bias': 'bias',
             'running_mean': 'running_mean', 'running_var': 'running_var'}
SKIPPED_LEAF = 'num_batches_tracked'

_LIDAR_SEQ = {
    'conv_input': 'conv_input', 'conv1.0': 'conv1',
    'conv2.0': 'conv2_down', 'conv2.1': 'conv2_a', 'conv2.2': 'conv2_b',
    'conv3.0': 'conv3_down', 'conv3.1': 'conv3_a', 'conv3.2': 'conv3_b',
    'conv4.0': 'conv4_down', 'conv4.1': 'conv4_a', 'conv4.2': 'conv4_b',
    'conv_out': 'conv_out',
}
_NR_SUB = {'down_layer.0': 'down', 'd3_conv1.0': 'd3_conv1',
           'd3_conv2.0': 'd3_conv2', 'd2_conv1.0': 'd2_conv1',
           'd2_conv2.0': 'd2_conv2'}
_FC_HEADS = {'shared_fc_layers': 'shared_fc',
             'shared_fc_layers_mm': 'shared_fc_mm',
             'cls_layers': 'cls_head', 'reg_layers': 'reg_head',
             'cls_layers_PI': 'cls_head_pi', 'reg_layers_PI': 'reg_head_pi',
             'cls_layers_P': 'cls_head_p', 'reg_layers_P': 'reg_head_p'}
_POOL_MLPS = {'mlps_in': ('mlp_in', 'mlp_in_bn'),
              'mlps_pos': ('mlp_pos', 'mlp_pos_bn'),
              'mlps_out': ('mlp_out', 'mlp_out_bn')}


def _looks_spatial(dims) -> bool:
    """Kernel spatial dims in this net are always 1 or 3."""
    return all(d in (1, 3) for d in dims)


def spconv1_kernel_to_gathered(w: np.ndarray) -> np.ndarray:
    """spconv 1.x weight (*spatial, in, out) -> (K, in, out)."""
    *spatial, in_c, out_c = w.shape
    return np.ascontiguousarray(w.reshape(int(np.prod(spatial)), in_c,
                                          out_c))


def spconv_kernel_to_gathered(w: np.ndarray) -> np.ndarray:
    """A 3D (5-D) or 2D (4-D) spconv weight -> (K, in, out): spconv 2.x
    (out, *spatial, in) or 1.x (*spatial, in, out), told apart by which
    slots hold the spatial dims (all in {1, 3}); 1.x where both fit."""
    n_sp = w.ndim - 2
    if n_sp not in (2, 3):
        raise ValueError(f'unexpected spconv kernel shape {w.shape}')
    if _looks_spatial(w.shape[:n_sp]):
        return spconv1_kernel_to_gathered(w)
    if _looks_spatial(w.shape[1:1 + n_sp]):
        moved = np.moveaxis(w, 0, -1)               # (*spatial, in, out)
        return spconv1_kernel_to_gathered(moved)
    raise ValueError(f'unexpected spconv kernel shape {w.shape}')


def bev_input_perm(in_c: int, bev_channels: int = 64) -> np.ndarray:
    """``perm`` with port in-channel i = reference in-channel perm[i]: the
    reference flattens (N, C, D, H, W) to channel c * D + d, the port's
    ``height_compression`` to d * C + c."""
    d = in_c // bev_channels
    if d * bev_channels != in_c:
        raise ValueError(f'BEV input {in_c} not divisible by '
                         f'{bev_channels} channels')
    idx = np.arange(in_c)
    return (idx % bev_channels) * d + idx // bev_channels


def _backbone_3d(parts, leaf, single_stream):
    """(port name, kind) of a ``backbone_3d`` key, or None."""
    stem = '.'.join(parts[1:-1])
    for ref, ours in _LIDAR_SEQ.items():
        for suffix, is_bn in (('.0', False), ('.1', True)):
            if stem != ref + suffix:
                continue
            prefix = 'backbone.' if ours == 'conv_out' and single_stream \
                else 'backbone.lidar.'
            if is_bn:
                return (f'{prefix}{ours}.MaskedBatchNorm_0.{BN_LEAVES[leaf]}',
                        'as_is') if leaf in BN_LEAVES else None
            return (f'{prefix}{ours}.kernel', 'spconv') \
                if leaf == 'weight' else None
    if parts[1].startswith('vir_conv'):
        sub = '.'.join(parts[2:-2])
        ours = _NR_SUB.get(sub)
        if ours is None:
            return None
        base = f'backbone.mm.{parts[1]}.{ours}'
        if parts[-2] == '1':
            return (f'{base}.MaskedBatchNorm_0.{BN_LEAVES[leaf]}',
                    'as_is') if leaf in BN_LEAVES else None
        if parts[-2] == '0' and leaf == 'weight':
            return f'{base}.kernel', 'spconv'
    return None


def _backbone_2d(parts, leaf):
    if parts[1] == 'blocks' and len(parts) == 5:
        i, j = int(parts[2]), int(parts[3])
        if j == 1:
            mod = f'block{i}_down.Conv_0'
        elif j == 2:
            mod = f'block{i}_down.BatchNorm_0'
        elif (j - 4) % 3 == 0 and j >= 4:
            mod = f'block{i}_conv{(j - 4) // 3}.Conv_0'
        elif (j - 5) % 3 == 0 and j >= 5:
            mod = f'block{i}_conv{(j - 5) // 3}.BatchNorm_0'
        else:
            return None
        name = f'bev_backbone.{mod}'
        if mod.endswith('Conv_0'):
            if leaf != 'weight':
                return None
            return f'{name}.weight', ('bev_in' if mod == 'block0_down.Conv_0'
                                      else 'as_is')
        return (f'{name}.{BN_LEAVES[leaf]}', 'as_is') \
            if leaf in BN_LEAVES else None
    if parts[1] == 'deblocks' and len(parts) == 5:
        i, j = int(parts[2]), int(parts[3])
        if j == 0 and leaf == 'weight':
            return f'bev_backbone.deblock{i}.weight', 'deconv'
        if j == 1 and leaf in BN_LEAVES:
            return f'bev_backbone.deblock{i}_bn.{BN_LEAVES[leaf]}', 'as_is'
    return None


def _roi_head(parts, leaf, key, sources):
    fam = parts[1]
    if fam in _FC_HEADS and len(parts) >= 5:
        j = int(parts[3])
        ours = f'roi_head.{_FC_HEADS[fam]}'
        # [Linear, BN, ReLU, Dropout] x k, then an optional final Linear
        if j % 4 == 0 and j // 4 < 2 and leaf == 'weight' \
                and parts[-2] == str(j):
            return f'{ours}.fc{j // 4}.weight', 'as_is'
        if j % 4 == 1:
            return (f'{ours}.bn{j // 4}.{BN_LEAVES[leaf]}', 'as_is') \
                if leaf in BN_LEAVES else None
        if j >= 7 and leaf in ('weight', 'bias'):
            return f'{ours}.out.{leaf}', 'as_is'
        return None
    if fam in ('cross_attention_layers', 'cross_attention_layers_mm') \
            and len(parts) >= 5:
        ours = 'roi_head.' + ('cross_attn' if fam == 'cross_attention_layers'
                              else 'cross_attn_mm')
        lin = {'Q_linear': 'q', 'K_linear': 'k', 'V_linear': 'v'}.get(
            parts[3])
        if lin and leaf == 'weight':
            return f'{ours}.{lin}.weight', 'as_is'
        if parts[3] == 'att':
            if key.endswith('att.in_proj_weight'):
                return f'{ours}.mha', 'in_proj_weight'
            if key.endswith('att.in_proj_bias'):
                return f'{ours}.mha', 'in_proj_bias'
            if key.endswith('att.out_proj.weight'):
                return f'{ours}.mha.out.weight', 'as_is'
            if key.endswith('att.out_proj.bias'):
                return f'{ours}.mha.out.bias', 'as_is'
        return None
    if fam == 'conv_part' and len(parts) == 4:
        j = int(parts[2])
        if j == 0 and leaf == 'weight':
            return 'roi_head.part_conv1.Conv_0.weight', 'as_is'
        if j == 1 and leaf in BN_LEAVES:
            return (f'roi_head.part_conv1.BatchNorm_0.{BN_LEAVES[leaf]}',
                    'as_is')
        if j == 3 and leaf == 'weight':
            return 'roi_head.part_conv2.weight', 'as_is'
        return None
    if fam in ('roi_grid_pool_layers', 'roi_grid_pool_layers_mm') \
            and len(parts) == 7:
        prefix, srcs = (('pool', sources[0]) if fam == 'roi_grid_pool_layers'
                        else ('pool_mm', sources[1]))
        k = int(parts[2])
        names = _POOL_MLPS.get(parts[3])
        if names is None or k >= len(srcs):
            return None
        g, j = int(parts[4]), int(parts[5])
        ours = f'roi_head.{prefix}_{srcs[k]}'
        if j == 0 and leaf == 'weight':
            if names[0] == 'mlp_pos':
                return f'{ours}.mlp_pos{g}.kernel', 'conv1x1_kernel'
            return f'{ours}.{names[0]}{g}.weight', 'conv1x1_weight'
        if j == 1 and leaf in BN_LEAVES:
            return f'{ours}.{names[1]}{g}.{BN_LEAVES[leaf]}', 'as_is'
    return None


def translate_key(key: str, cfg) -> tuple | None:
    """(port name, layout kind) of one reference key under ``cfg`` (a full
    config or its MODEL), or None when the key has no port parameter."""
    mcfg = CfgNode(cfg).get('MODEL', cfg)
    parts = key.split('.')
    leaf = parts[-1]
    if parts[0] == 'backbone_3d' and len(parts) >= 3:
        return _backbone_3d(parts, leaf,
                            mcfg['BACKBONE_3D']['NAME'] == 'VirConvL8x')
    if parts[0] == 'backbone_2d' and len(parts) >= 4:
        return _backbone_2d(parts, leaf)
    if parts[0] == 'dense_head' and len(parts) == 3:
        ours = {'conv_cls': 'conv_cls', 'conv_box': 'conv_box',
                'conv_dir_cls': 'conv_dir'}.get(parts[1])
        if ours and leaf in ('weight', 'bias'):
            return f'dense_head.{ours}.{leaf}', 'as_is'
        return None
    if parts[0] == 'roi_head' and len(parts) >= 3:
        rh = mcfg['ROI_HEAD']
        sources = (list(rh['ROI_GRID_POOL']['FEATURES_SOURCE']),
                   list(rh['ROI_GRID_POOL_MM']['FEATURES_SOURCE']))
        return _roi_head(parts, leaf, key, sources)
    return None


def _tensor(a):
    return torch.from_numpy(np.array(a, np.float32))


def import_reference_state_dict(state_dict, cfg, skipped=None):
    """Map a reference VirConv ``state_dict`` (tensors or arrays) onto the
    port's ``VoxelRCNN`` of ``cfg``. Returns (port state_dict, unmapped
    reference keys). The BN step counters (``num_batches_tracked``) have no
    port parameter: they are appended to ``skipped`` when a list is given,
    and are not among the unmapped keys. Where several reference keys land
    on one port name (per-stage copies of a head layer), the last one wins,
    as in the JAX map."""
    mcfg = CfgNode(cfg).get('MODEL', cfg)
    bev_channels = mcfg['BACKBONE_3D']['OUT_FEATURES']
    out, unmapped = {}, []
    for key, value in state_dict.items():
        if key.endswith(SKIPPED_LEAF):
            if skipped is not None:
                skipped.append(key)
            continue
        hit = translate_key(key, mcfg)
        if hit is None:
            unmapped.append(key)
            continue
        name, kind = hit
        v = value.detach().cpu().numpy() if torch.is_tensor(value) \
            else np.asarray(value)
        if kind == 'spconv':
            out[name] = _tensor(spconv_kernel_to_gathered(v))
        elif kind == 'bev_in':
            out[name] = _tensor(v[:, bev_input_perm(v.shape[1],
                                                    bev_channels)])
        elif kind == 'deconv':
            # a 1x1 reference ConvTranspose2d is the port's 1x1 Conv2d
            out[name] = _tensor(v if v.shape[2] > 1 else
                                v.transpose(1, 0, 2, 3))
        elif kind == 'conv1x1_weight':
            out[name] = _tensor(v.reshape(v.shape[0], v.shape[1]))
        elif kind == 'conv1x1_kernel':
            out[name] = _tensor(v.reshape(v.shape[0], v.shape[1]).T)
        elif kind in ('in_proj_weight', 'in_proj_bias'):
            e = v.shape[0] // 3
            leaf = kind.rsplit('_', 1)[-1]
            for part, rows in zip(('query', 'key', 'value'),
                                  (v[:e], v[e:2 * e], v[2 * e:])):
                out[f'{name}.{part}.{leaf}'] = _tensor(rows)
        else:
            out[name] = _tensor(v)
    return out, unmapped
