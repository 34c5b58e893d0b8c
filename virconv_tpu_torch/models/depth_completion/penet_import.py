"""Reference PENet_C2 checkpoints -> the port's ``PENetC2`` names.

The port's copy of the name tables of
``virconv_tpu/models/depth_completion/torch_import.py``. The reference
(``tools/PENet/model.py`` PENet_C2, ``basic.py`` convbn / deconvbn /
BasicBlockGeo) and the port are both torch, so only names change: no
layout. The reference's ``encoder3/5/7`` buffers (the one-hot
``kernel_trans`` convs, which ``ops/cspn`` folds into its shifted sum) and
the BN step counters are dropped; any other key that does not map raises.
"""

from __future__ import annotations

# ENet submodule map: reference attribute -> (port module, kind)
_ENET = {'rgb_conv_init': ('rgb_init', 'conv'),
         'depth_conv_init': ('d_init', 'conv'),
         'rgb_decoder_output': ('rgb_out', 'deconv'),
         'decoder_layer6': ('dec6', 'conv')}
for _i in range(1, 11):
    _ENET[f'rgb_encoder_layer{_i}'] = (f'rgb_enc{_i}', 'basic')
    _ENET[f'depth_layer{_i}'] = (f'd_enc{_i}', 'basic')
for _i in (8, 6, 4, 2, 0):
    _ENET[f'rgb_decoder_layer{_i}'] = (f'rgb_dec{_i}', 'deconv')
for _i in range(1, 6):
    _ENET[f'decoder_layer{_i}'] = (f'dec{_i}', 'deconv')

# PENet_C2's convbn heads and CSPN guide generators
_HEAD = {'mask_layer': 'mask', 'kernel_conf_layer': 'kconf',
         'mask_layer_s2': 'mask_s2', 'kernel_conf_layer_s2': 'kconf_s2'}
for _k in (3, 5, 7):
    _HEAD[f'iter_guide_layer{_k}'] = f'guide{_k}'
    _HEAD[f'iter_guide_layer{_k}_s2'] = f'guide{_k}_s2'

_BN_LEAVES = ('weight', 'bias', 'running_mean', 'running_var')
# within BasicBlockGeo: reference attribute -> port attribute
_BASIC = {'conv1': 'conv1', 'conv2': 'conv2', 'downsample.0': 'down_conv',
          'bn1': 'bn1', 'bn2': 'bn2', 'downsample.1': 'down_bn'}
_DROPPED = ('encoder3', 'encoder5', 'encoder7')


def translate_penet_key(key: str):
    """The port's name of one reference state-dict key; '' for a key that
    is dropped, None for one that does not map."""
    parts = key.split('.')
    if parts[0] == 'module':           # DataParallel wrapper
        parts = parts[1:]
    leaf = parts[-1]
    if leaf == 'num_batches_tracked' or parts[0] in _DROPPED:
        return ''

    def seq(base, idx, deconv):        # nn.Sequential(conv, BN[, ReLU])
        if idx == '0' and leaf == 'weight':
            return f'{base}.{"ConvTranspose_0" if deconv else "Conv_0"}.' \
                   'weight'
        if idx == '1' and leaf in _BN_LEAVES:
            return f'{base}.BatchNorm_0.{leaf}'
        return None

    if parts[0] == 'backbone' and len(parts) > 2 and parts[1] in _ENET:
        ours, kind = _ENET[parts[1]]
        base = f'backbone.{ours}'
        if kind != 'basic':
            return seq(base, parts[2], kind == 'deconv') \
                if len(parts) == 4 else None
        sub = '.'.join(parts[2:-1])
        if sub not in _BASIC:
            return None
        name = _BASIC[sub]
        if name.startswith(('conv', 'down_conv')):
            return f'{base}.{name}.weight' if leaf == 'weight' else None
        return f'{base}.{name}.{leaf}' if leaf in _BN_LEAVES else None

    if parts[0] in _HEAD:
        ours = _HEAD[parts[0]]
        if parts[0].startswith('iter_guide'):
            if len(parts) != 4 or parts[1] != 'generate':
                return None
            return seq(f'{ours}.generate', parts[2], False)
        return seq(ours, parts[1], False) if len(parts) == 3 else None
    return None


def import_penet_state_dict(state_dict):
    """A reference PENet_C2 state dict -> the port's ``PENetC2`` state dict
    (the same tensors, renamed). Raises ``KeyError`` naming the keys that
    do not map."""
    out, unmapped = {}, []
    for key, val in state_dict.items():
        name = translate_penet_key(key)
        if name is None:
            unmapped.append(key)
        elif name:
            out[name] = val
    if unmapped:
        raise KeyError(f'{len(unmapped)} PENet keys do not map to the port: '
                       f'{unmapped[:8]}')
    return out


def load_penet_checkpoint(path):
    """The port's state dict from a reference ``.pth`` / ``.pth.tar`` (the
    reference trainer saves ``{'model': state_dict, ...}``; a bare state
    dict works too)."""
    import torch
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    sd = ckpt.get('model', ckpt) if isinstance(ckpt, dict) else ckpt
    if hasattr(sd, 'state_dict'):
        sd = sd.state_dict()
    return import_penet_state_dict(sd)
