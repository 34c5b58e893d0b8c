"""Carry weights across from the JAX package, and seeded random weights.

The port's parameter names are the flax module paths, so the converter is
a walk over the flax ``{'params', 'batch_stats'}`` tree (numpy arrays) with
one layout rule per leaf kind:

* sparse conv kernels (K, C, C') and the bare ``mlp_pos`` kernels: as is;
* ``nn.Dense`` (in, out) -> ``nn.Linear`` weight (out, in); the attention
  projections' (in, heads, hd) / (heads, hd, out) kernels flatten first;
* ``nn.Conv`` (kh, kw, in, out) -> (out, in, kh, kw);
* ``nn.ConvTranspose`` (kh, kw, in, out) -> (in, out, kh, kw), spatially
  flipped (torch's transposed-conv kernel is the flip of flax's);
* BN ``scale / bias / mean / var`` -> ``weight / bias / running_mean /
  running_var``.

Every rule is linear (reshape, transpose, flip), so ``from_jax_variables(
{'params': grads})`` carries a JAX gradient tree across too: it gives each
port parameter the ``.grad`` the port should compute.
"""

from __future__ import annotations

import numpy as np
import torch

_ATTN_IN = ('query', 'key', 'value')


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _convert_kernel(path, k):
    parent = path[-2]
    if k.ndim == 3 and parent in _ATTN_IN:          # (in, H, hd)
        return 'weight', k.reshape(k.shape[0], -1).T
    if k.ndim == 3 and parent == 'out' and path[-3] == 'mha':  # (H, hd, out)
        return 'weight', k.reshape(-1, k.shape[-1]).T
    if k.ndim == 3 or parent.startswith('mlp_pos'):
        return 'kernel', k
    if k.ndim == 2:
        return 'weight', k.T
    if parent.startswith('deblock') and k.shape[0] > 1:
        return "weight", k[::-1, ::-1].transpose(2, 3, 0, 1)
    return 'weight', k.transpose(3, 2, 0, 1)


def from_jax_variables(variables) -> dict:
    """Flax variables (or a gradient tree under 'params') -> a state_dict
    of the port's VoxelRCNN."""
    sd = {}
    for path, v in _walk(variables['params']):
        name = path[-1]
        if name == 'kernel':
            name, v = _convert_kernel(path, v)
        elif name == 'scale':
            name = 'weight'
        elif name == 'bias':
            v = v.reshape(-1)
        sd['.'.join(path[:-1] + (name,))] = torch.from_numpy(
            np.array(v, np.float32))
    stat_name = {'mean': 'running_mean', 'var': 'running_var'}
    for path, v in _walk(variables.get('batch_stats', {})):
        sd['.'.join(path[:-1] + (stat_name[path[-1]],))] = torch.from_numpy(
            np.array(v, np.float32))
    return sd


def load_state_dict_checked(model: torch.nn.Module, state_dict):
    """Load ``state_dict``; raises unless it covers every parameter and
    statistic of ``model`` (only BN step counters may be absent)."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.endswith('num_batches_tracked')]
    if missing or unexpected:
        raise KeyError(f'missing {missing}, unexpected {unexpected}')
    return model


def random_init_(model: torch.nn.Module, seed: int = 0):
    """Seeded random weights: fan-in-scaled normal kernels, zero biases,
    unit BN scales and statistics, and the RPN's prior-probability class
    bias. The values come from one CPU ``torch.Generator``, so every device
    gets the same model."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit('.', 1)[-1]
            if p.ndim == 1:        # 1-D weights are BN scales
                val = torch.ones(p.shape) if leaf == 'weight' \
                    else torch.zeros(p.shape)
            else:
                if leaf == 'kernel' and p.ndim == 3:
                    fan_in = p.shape[0] * p.shape[1]
                elif leaf == 'kernel':
                    fan_in = p.shape[0]
                else:
                    fan_in = int(np.prod(p.shape[1:]))
                val = torch.randn(p.shape, generator=gen) / np.sqrt(fan_in)
            p.copy_(val.to(p.dtype))
        head = getattr(model, 'dense_head', None)
        if head is not None:
            head.conv_cls.bias.fill_(-float(np.log((1 - 0.01) / 0.01)))
            head.conv_box.weight.mul_(1e-3 * np.sqrt(
                head.conv_box.weight[0].numel()))
    return model
